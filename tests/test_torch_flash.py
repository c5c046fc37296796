"""The port's flash-attention forward and attention dispatch against the JAX
package: the plain version (what FLASH runs on a CPU tensor) against the
Pallas kernel in interpret mode and the einsum oracle, lse against the
kernel's own, and the dispatch rules; the split route's plain versions (dkv,
dq) against the Pallas split route. Also the arithmetic of the f32 kernels'
3xTF32 split, emulated in torch, against the f32 plain versions. Inputs come
from numpy seeds.

The CUDA kernel itself runs only on the card: see
tests/test_torch_flash_cuda.py. What decides, on the host, which layouts the
bf16 forward's TMA loads take (`fwd_layout`) is tested here on CPU tensors.

Three sections of tests/test_torch_train.py follow, moved here whole (names,
bodies and tolerances unchanged) so that no file holds the tier-1 run's workers
back: its octree and UNETR section (the 3-D Gaussian, the octree, `Patchify3D`,
the labelled 3-D DataModule, UNETR's train steps against the JAX step, the MAE
encoder's transfer, the CLI from labelled NIfTI volumes), then its DiffusionVIT
and DDPM and its adaptive-patching sections. They share that file's helpers."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # xdist's workers share the cores: one torch
    torch.set_num_threads(1)  # thread each keeps them from oversubscribing the machine

import ucf_vit_tpu.ops.flash_attention as jax_fa

from ucf_vit_tpu.ops.attention import SHORT_SEQ_THRESHOLD as JAX_SHORT_SEQ_THRESHOLD
from ucf_vit_tpu.ops.attention import einsum_attention as jax_einsum_attention
from ucf_vit_tpu.ops.attention import multi_head_attention as jax_multi_head_attention
from ucf_vit_tpu.ops.flash_attention import _flash_fwd_len
from ucf_vit_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ucf_vit_tpu_torch.ops.attention import (
    SHORT_SEQ_THRESHOLD,
    AttnImpl,
    einsum_attention,
    multi_head_attention,
    resolve_impl,
)
from ucf_vit_tpu_torch.ops.flash_attention import (
    TMA_BOX,
    _padded,
    _tensor_map,
    _tokens_major,
    bwd_route,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_dkv_plain,
    flash_attention_dq_plain,
    flash_attention_plain,
    fwd_layout,
)

TOL = 1e-5  # f32: both sides sum the same products in another order

# (b, h, n_q, n_kv, dh)
SHAPES = [
    (2, 2, 197, 197, 32),
    (2, 2, 197, 197, 36),
    (2, 3, 1, 257, 32),
    (1, 2, 130, 300, 32),
]


def _qkv(b, h, n_q, n_kv, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, n_q, dh)).astype(np.float32)
    k = rng.normal(size=(b, h, n_kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, h, n_kv, dh)).astype(np.float32)
    return q, k, v


def _ceil_to(x, m):
    return -(-x // m) * m


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_plain_matches_pallas_and_einsum(shape):
    b, h, n_q, n_kv, dh = shape
    q, k, v = _qkv(*shape)
    scale = dh**-0.5
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert out.shape == (b, h, n_q, dh) and out.dtype == torch.float32
    ref_flash = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    interpret=True)
    ref_einsum = jax_einsum_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      sm_scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_flash), atol=TOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_einsum), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_plain_lse_matches_pallas_kernel(shape):
    b, h, n_q, n_kv, dh = shape
    q, k, v = _qkv(*shape, seed=1)
    scale = dh**-0.5
    _, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             return_lse=True)
    assert lse.shape == (b * h, n_q) and lse.dtype == torch.float32

    # call the Pallas forward as its wrapper does: pad to block multiples,
    # the true kv length baked in
    bq, bk = 128, 128
    nq_pad, nkv_pad = _ceil_to(n_q, bq), _ceil_to(n_kv, bk)
    pad = lambda a, n: np.pad(a.reshape(b * h, -1, dh), ((0, 0), (0, n - a.shape[2]), (0, 0)))
    _, ref_lse = _flash_fwd_len(
        jnp.asarray(pad(q, nq_pad)), jnp.asarray(pad(k, nkv_pad)), jnp.asarray(pad(v, nkv_pad)),
        jnp.zeros((3,), jnp.int32), n_kv, scale, bq, bk, 0.0, True,
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :n_q, 0], atol=TOL, rtol=0)


def test_flash_plain_bf16_returns_input_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 2, 65, 65, 64))
    out, lse = flash_attention(q, k, v, return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), 64**-0.5)
    # the only difference is the final rounding of o to bf16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2, rtol=0)
    np.testing.assert_array_equal(lse.numpy(), ref_lse.numpy())


def test_flash_f32_o_is_the_unrounded_output():
    """`f32_o` (the ring attention's chunk call): o in f32, the same sums that
    round to the default o, and no backward."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 2, 65, 65, 64))
    o32, lse32 = flash_attention(q, k, v, return_lse=True, f32_o=True)
    o, lse = flash_attention(q, k, v, return_lse=True)
    assert o32.dtype == torch.float32
    np.testing.assert_array_equal(o32.to(torch.bfloat16).float().numpy(), o.float().numpy())
    np.testing.assert_array_equal(lse32.numpy(), lse.numpy())
    ref, _ = flash_attention_plain(q.float(), k.float(), v.float(), 64**-0.5)
    np.testing.assert_array_equal(o32.numpy(), ref.numpy())
    with pytest.raises(ValueError, match="f32_o has no backward"):
        flash_attention(q.requires_grad_(), k, v, f32_o=True)


def test_flash_cpu_does_not_count_launches_and_rejects_other_devices():
    before = flash_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8, 16))
    flash_attention(q, k, v)
    assert flash_attention.launches == before
    with pytest.raises(RuntimeError, match="cpu or cuda"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :4], v)


@pytest.mark.parametrize("seg_len", [None, 8])
def test_einsum_attention_matches_jax(seg_len):
    q, k, v = _qkv(2, 2, 32, 32, 16, seed=2)
    out = einsum_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           sm_scale=0.25, seg_len=seg_len)
    ref = jax_einsum_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               sm_scale=0.25, seg_len=seg_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("impl", ["FLASH", "EINSUM", "AUTO", "CK", "NONE"])
def test_multi_head_attention_impls_agree(impl):
    q, k, v = _qkv(2, 2, 40, 40, 16, seed=3)
    out = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               impl=impl)
    ref = jax_einsum_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_dispatch_rules():
    assert resolve_impl("AUTO", torch.device("cpu")) == AttnImpl.EINSUM
    assert resolve_impl(AttnImpl.AUTO, torch.device("cuda")) == AttnImpl.FLASH
    assert resolve_impl("default", torch.device("cuda")) == AttnImpl.XLA
    assert resolve_impl("ck", torch.device("cpu")) == AttnImpl.FLASH
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        multi_head_attention(q, q, q, impl="XLA")
    with pytest.raises(ValueError, match="dropout_seed"):
        multi_head_attention(q, q, q, impl="FLASH", dropout_rate=0.1)


@pytest.mark.parametrize("n_kv", [SHORT_SEQ_THRESHOLD, SHORT_SEQ_THRESHOLD + 1])
def test_flash_seg_len_length_guard_matches_jax(n_kv):
    """FLASH with seg_len goes to EINSUM (the kernel has no segment mask) up
    to SHORT_SEQ_THRESHOLD keys and raises past it, as the JAX package does;
    EINSUM asked for by name takes any length."""
    assert SHORT_SEQ_THRESHOLD == JAX_SHORT_SEQ_THRESHOLD == 1024
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 16, n_kv, 8, seed=4))
    seg = 512
    ein = multi_head_attention(q, k, v, impl="EINSUM", seg_len=seg)
    ref = jax_einsum_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()), sm_scale=8**-0.5, seg_len=seg)
    np.testing.assert_allclose(ein.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    if n_kv <= SHORT_SEQ_THRESHOLD:
        out = multi_head_attention(q, k, v, impl="FLASH", seg_len=seg)
        np.testing.assert_array_equal(out.numpy(), ein.numpy())
        return
    with pytest.raises(AssertionError, match="segment-masked attention over 1025 tokens"):
        multi_head_attention(q, k, v, impl="FLASH", seg_len=seg)
    with pytest.raises(AssertionError, match="segment-masked attention over 1025 tokens"):
        jax_multi_head_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                 jnp.asarray(v.numpy()), impl="FLASH", seg_len=seg)


# ---------------------------------------------------------------- the split route

# bf16, relative to the largest |entry|: the Pallas kernels round p_v and ds to bf16
# before their products, the plain versions keep them f32 until the outputs are rounded
# (tests/test_torch_dropout.py, BF16_TOL)
BF16_TOL = 1e-2
# (b, h, n_q, n_kv, dh): whole 128-blocks, and a ragged Nkv with Nq != Nkv
SPLIT_SHAPES = [(1, 2, 256, 256, 32), (1, 2, 130, 200, 32)]


@pytest.fixture
def jax_split_route(monkeypatch):
    """The JAX package's backward on its split route (`_bwd_dkv_kernel` +
    `_bwd_dq_kernel`) at every length: no dq scratch fits the fused kernel."""
    monkeypatch.setattr(jax_fa, "FUSED_BWD_DQ_SCRATCH_BYTES", 0)
    jax_fa._flash_len_cache.cache_clear()
    yield
    jax_fa._flash_len_cache.cache_clear()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_plain_matches_pallas_split_route(jax_split_route, shape, dtype, rate):
    """`flash_attention_dkv_plain` and `flash_attention_dq_plain` (the split
    route's kernels on a CPU tensor) against the Pallas split route's dk, dv
    and dq (interpret mode, the vjp of one output gradient), with dropout at
    a nonzero offset."""
    b, h, n_q, n_kv, dh = shape
    q, k, v = _qkv(*shape, seed=9)
    do = np.random.default_rng(10).normal(size=(b, h, n_q, dh)).astype(np.float32)
    seed, row0, col0 = 99, 3, 5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jax_fwd(q, k, v):
        return jax_flash_attention(q, k, v, dropout_rate=rate, dropout_seed=seed,
                                   dropout_offset=(row0, col0), interpret=True)

    _, vjp = jax.vjp(jax_fwd, *(jnp.asarray(a, dtype=jdt) for a in (q, k, v)))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, dtype=jdt))]
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    scale = dh**-0.5
    drop = (rate, seed, row0, col0)
    o, lse = flash_attention_plain(tq, tk, tv, scale, *drop)
    dk, dv = flash_attention_dkv_plain(tq, tk, tv, o, lse, tdo, scale, *drop)
    dq = flash_attention_dq_plain(tq, tk, tv, o, lse, tdo, scale, *drop)
    for name, got, ref in zip("qkv", (dq, dk, dv), want):
        assert got.dtype == tdt and got.shape == ref.shape, name
        err = np.abs(got.float().numpy() - ref).max()
        if dtype == "float32":
            assert err <= TOL, (name, err)
        else:
            assert err <= BF16_TOL * np.abs(ref).max(), (name, err / np.abs(ref).max())


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_plain_composes_to_bwd_plain(rate):
    """dkv's plain version and dq's give, together, what the plain backward
    gives, bit for bit: the split route computes the fused route's function."""
    b, h, n_q, n_kv, dh = 2, 2, 70, 90, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, h, n_q, n_kv, dh, seed=11))
    do = torch.from_numpy(np.random.default_rng(12).normal(size=(b, h, n_q, dh))
                          .astype(np.float32))
    drop = (rate, 7, 2, 3)
    o, lse = flash_attention_plain(q, k, v, 0.25, *drop)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, 0.25, *drop)
    assert all(torch.equal(a, c) for a, c in zip(
        flash_attention_dkv_plain(q, k, v, o, lse, do, 0.25, *drop), (dk, dv)))
    assert torch.equal(flash_attention_dq_plain(q, k, v, o, lse, do, 0.25, *drop), dq)


# the backward's route at each model path's attention, as the card's times chose it
# (ops/flash_attention.py: SPLIT_MIN_QUERIES): (dtype, (Nq, Nkv, dh), route)
MODEL_ROUTES = {
    "vit_b_f32": ("float32", (257, 257, 64), "fused"),
    "vit_l_bf16": ("bfloat16", (257, 257, 64), "fused"),
    "mae_long_encoder": ("bfloat16", (8192, 8192, 64), "fused"),
    "mae_long_decoder": ("bfloat16", (32768, 32768, 96), "split"),
}


@pytest.mark.parametrize("path", MODEL_ROUTES)
def test_bwd_route_at_model_shapes(path):
    dtype, shape, route = MODEL_ROUTES[path]
    assert bwd_route(getattr(torch, dtype), *shape) == route


# ---------------------------------------------------------------- 3xTF32

# The card's f32 tolerances (tests/test_torch_flash_cuda.py, chip_smoke.py):
# o absolute, dq, dk and dv relative to their largest entry
FLASH_TOL, BWD_TOL = 5e-5, 1e-4


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (a 10-bit mantissa), ties away from zero: the
    rounding of cvt.rna.tf32.f32 and of the kernels' split (half a TF32 ulp
    added to the magnitude, the 13 low bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 truncated to TF32: what the tensor cores read of an f32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: each operand split as x = hi + lo with
    hi rounded to TF32 and lo = x - hi read truncated; lo.hi + hi.lo + hi.hi,
    each TF32 product exact and summed in f32."""
    a_hi, b_hi = _tf32_round(a), _tf32_round(b)
    a_lo, b_lo = _tf32_trunc(a - a_hi), _tf32_trunc(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass: what the tensor cores give an f32 product."""
    return _tf32_round(a) @ _tf32_round(b)


def _attention_by(mm, q, k, v, do, scale):
    """The forward and backward kernels' formulas with every product by `mm`:
    o, and dq, dk, dv from the plain forward's lse (rate 0)."""
    s = mm(q, k.transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    o = mm(p, v)
    di = (o * do).sum(-1, keepdim=True)
    dv = mm(p.transpose(-1, -2), do)
    ds = p * (mm(do, v.transpose(-1, -2)) - di) * scale
    return o, mm(ds, k), mm(ds.transpose(-1, -2), q), dv


def test_3xtf32_split_keeps_f32_accuracy():
    """Why the f32 kernels keep the card's f32 tolerances: at [2 heads, 257,
    64] the forward's and the backward's products by the 3-pass split land
    within a tenth of those tolerances of the f32 plain versions, while one
    TF32 pass misses by ten times as much."""
    b, h, n, dh = 1, 2, 257, 64
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, h, n, n, dh, seed=5))
    do = torch.from_numpy(np.random.default_rng(6).normal(size=(b, h, n, dh)).astype(np.float32))
    scale = dh**-0.5
    o_ref, lse = flash_attention_plain(q, k, v, scale)
    ref = flash_attention_bwd_plain(q, k, v, o_ref, lse, do, scale)
    errs = {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("tf32", _mm_tf32)):
        o, dq, dk, dv = _attention_by(mm, q, k, v, do, scale)
        errs[name] = ((o - o_ref).abs().max().item(),
                      max(((g - w).abs().max() / w.abs().max()).item()
                          for g, w in zip((dq, dk, dv), ref)))
    o3, d3 = errs["3xtf32"]
    o1, d1 = errs["tf32"]
    assert o3 <= FLASH_TOL / 10 and d3 <= BWD_TOL / 10, errs
    assert o1 >= 10 * o3 and d1 >= 10 * d3, errs
    # the emulated rounding is cvt.rna's: ties go away from zero
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 3.0], dtype=torch.float32)
    assert _tf32_round(x).tolist() == [1 + 2**-10, -(1 + 2**-10), 1.0, 3.0]


def _dq_by_tiles(mm, q, k, v, do, lse, di, scale, block=64):
    """dq as the f32 dq kernel (csrc/flash_bwd_tf32.cu) computes it: per key
    tile of `block`, s and dp by `mm`, ds = p (dp - di) scale, the tile's ds . k
    by `mm` summed from zero, then added to dq by an f32 add."""
    dq = torch.zeros_like(q)
    for k0 in range(0, k.shape[-2], block):
        kt, vt = k[..., k0:k0 + block, :], v[..., k0:k0 + block, :]
        p = torch.exp(mm(q, kt.transpose(-1, -2)) * scale - lse)
        ds = p * (mm(do, vt.transpose(-1, -2)) - di) * scale
        dq = dq + mm(ds, kt)
    return dq


@pytest.mark.parametrize("dh", [64, 128])
def test_3xtf32_split_dq_by_key_tiles_keeps_f32_accuracy(dh):
    """Why the f32 dq kernel keeps the card's 1e-4: over 4096 keys, each 64-key
    tile's three products by the 3-pass split and its part of dq added in f32
    land within a tenth of it of the f32 plain dq, while one TF32 pass misses
    it."""
    b, h, n_q, n_kv = 1, 1, 64, 4096
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, h, n_q, n_kv, dh, seed=13))
    do = torch.from_numpy(np.random.default_rng(14).normal(size=(b, h, n_q, dh))
                          .astype(np.float32))
    scale = dh**-0.5
    o, lse = flash_attention_plain(q, k, v, scale)
    want = flash_attention_dq_plain(q, k, v, o, lse, do, scale)
    lse, di = lse.view(b, h, n_q, 1), (o * do).sum(-1, keepdim=True)
    err = {name: ((_dq_by_tiles(mm, q, k, v, do, lse, di, scale) - want).abs().max()
                  / want.abs().max()).item()
           for name, mm in (("3xtf32", _mm_3xtf32), ("tf32", _mm_tf32))}
    assert err["3xtf32"] <= BWD_TOL / 10 and err["tf32"] > BWD_TOL, err


# ---------------------------------------------------------------- the forward's TMA layouts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _packed_views(b, n, h, dh):
    """q, k, v as the model hands them over: `[B, H, N, dh]` views of one
    `[B, N, 3, H, dh]` qkv projection output (`models/blocks.py`)."""
    qkv = torch.zeros(b, n, 3, h, dh, dtype=torch.bfloat16)
    return tuple(t.transpose(1, 2) for t in qkv.unbind(2))


def _o(q):
    b, h, n, dh = q.shape
    return _tokens_major(b, n, h, dh, q.dtype, q.device)


@pytest.mark.parametrize("h", [12, 3], ids=["even_h", "odd_h"])
@pytest.mark.parametrize("dh", [36, 64, 96, 128])
def test_fwd_layout_packed_qkv_views(dh, h):
    """Packed views take the TMA route as they are, but for dh 36 with an odd
    head count: its rows (3 * H * 72 bytes) and k's and v's offsets (H * 72)
    are then no multiple of 16 bytes. dh 36's 72-byte head stride merges the
    heads into dim 0 of the map."""
    q, k, v = _packed_views(2, 65, h, dh)
    route, maps = fwd_layout(q, k, v, _o(q))
    if dh == 36 and h % 2:
        assert route == "padded" and maps == (None, None, None)
        return
    assert route == "tma"
    row = 3 * h * dh * 2  # bytes between tokens
    if dh == 36:  # heads merged: dims (all heads' columns, rows, 1, batch), head step 36
        want = ((h - 1) * 36 + 36, 65, 1, 2, row, 16, 65 * row, 36)
    else:
        want = (dh, 65, h, 2, row, 2 * dh, 65 * row, 0)
    assert maps == (want, want, want)
    assert TMA_BOX == (64, 64, 1, 1)


def test_fwd_layout_contiguous_offset_and_copies():
    """Contiguous `[B, H, N, dh]` takes TMA when its rows are a multiple of 16
    bytes (dh 64) and not otherwise (dh 36, 72-byte rows); a base that is not
    16-byte aligned does not either. The padded copy the wrapper then makes
    (zeros past dh, rows of ceil8(dh)) is a layout TMA takes."""
    q = torch.zeros(2, 4, 65, 64, dtype=torch.bfloat16)
    assert fwd_layout(q, q, q, _o(q)) == ("tma", ((64, 65, 4, 2, 128, 8320, 33280, 0),) * 3)
    c36 = torch.zeros(2, 4, 65, 36, dtype=torch.bfloat16)
    assert fwd_layout(c36, c36, c36, _o(c36))[0] == "padded"
    shifted = torch.zeros(2, 4, 65, 72, dtype=torch.bfloat16)[..., 4:68]  # base + 8 bytes
    assert shifted.data_ptr() % 16 == 8
    route, maps = fwd_layout(q, shifted, q, _o(q))
    assert route == "padded" and maps[0] is not None and maps[1] is None
    for t in (c36, shifted):
        pad = _padded(t)
        assert pad.is_contiguous() and pad.shape[-1] % 8 == 0
        assert torch.equal(pad[..., :t.shape[-1]], t) and not pad[..., t.shape[-1]:].any()
        assert _tensor_map(pad) is not None


def test_fwd_layout_q_and_k_share_head_offsets():
    """q and k must place each head at the same column of their boxes: a
    merged (dh 36 packed) k beside a q that is copied for TMA (offset 0) is
    copied too; v may differ from both."""
    q, k, v = _packed_views(2, 65, 12, 36)
    c36 = q.contiguous()  # 72-byte rows: copied
    route, maps = fwd_layout(c36, k, v, _o(q))
    assert route == "padded" and maps[0] is None and maps[1] is None and maps[2][7] == 36
    # merged q and k with equal head steps stay as they are
    assert fwd_layout(q, k, v, _o(q))[0] == "tma"


def test_fwd_layout_needs_o_rows_contiguous():
    """o is written by the kernel's own stores: any strides with the last dim
    contiguous, as `_tokens_major` makes it; another o is refused."""
    q, k, v = _packed_views(1, 9, 2, 64)
    o = _o(q)
    assert o.stride(-1) == 1 and not o.is_contiguous()
    assert fwd_layout(q, k, v, o)[0] == "tma"
    with pytest.raises(ValueError, match="last dim contiguous"):
        fwd_layout(q, k, v, torch.zeros(1, 2, 64, 9, dtype=torch.bfloat16).transpose(2, 3))


def _bf16_attention_widths():
    """(config, embed dim, heads) of every attention in the shipped bf16
    configs: the encoder's and, where there is one, the decoder's."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "**", "base_config.yaml"),
                                 recursive=True)):
        with open(path) as f:
            raw = yaml.safe_load(f)
        if raw.get("trainer", {}).get("data_type") != "bfloat16":
            continue
        args = raw["model"]["net"]["init_args"]
        name = os.path.relpath(os.path.dirname(path), os.path.join(REPO, "configs"))
        out.append((name, args["embed_dim"], args["num_heads"]))
        if args.get("decoder_embed_dim"):
            out.append((name + " decoder", args["decoder_embed_dim"], args["decoder_num_heads"]))
    return out


BF16_WIDTHS = _bf16_attention_widths()


@pytest.mark.parametrize("name,embed,heads", BF16_WIDTHS, ids=[w[0] for w in BF16_WIDTHS])
def test_fwd_layout_every_bf16_config_takes_tma(name, embed, heads):
    """Every attention the bf16 configs run (ViT-L dh 64, mae_long dh 64 and
    96, sap_bf16's decoder dh 36 with 16 heads, ...) loads its packed qkv
    views by TMA, with q and k normalised (`qk_norm`, new contiguous tensors)
    as well."""
    dh = embed // heads
    q, k, v = _packed_views(2, 65, heads, dh)
    assert fwd_layout(q, k, v, _o(q))[0] == "tma", (name, dh, heads)
    qn, kn = (torch.zeros(2, 65, heads, dh, dtype=torch.bfloat16).transpose(1, 2)
              for _ in "qk")
    assert fwd_layout(qn, kn, v, _o(q))[0] == "tma", (name, dh, heads)


# ================================================================ moved from test_torch_train.py
# Its octree and UNETR section, moved whole (names, bodies and tolerances unchanged)
# to spread the tier-1 run's files over its workers.

import itertools

from flax.core import meta
from ucf_vit_tpu.config import Config as JConfig
from ucf_vit_tpu.data.datamodule import DataModule as JDataModule
from ucf_vit_tpu.models.mae import MAE as JMAE
from ucf_vit_tpu.ops.attention import AttnImpl as JAttnImpl
from ucf_vit_tpu.parallel.train_step import TrainState as JTrainState
from ucf_vit_tpu.parallel.train_step import make_train_step as jax_make_train_step
from ucf_vit_tpu.tasks import _seq_ps as jax_seq_ps
from ucf_vit_tpu.utils import optim as jax_optim
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.convert import jax_to_torch_state
from ucf_vit_tpu_torch.convert import load_jax_params
from ucf_vit_tpu_torch.data import nifti
from ucf_vit_tpu_torch.data.datamodule import DataModule
from ucf_vit_tpu_torch.parallel.train_step import create_train_state
from ucf_vit_tpu_torch.parallel.train_step import make_train_step
from ucf_vit_tpu_torch.tasks import build_task
from ucf_vit_tpu_torch.tasks import task_loss
from ucf_vit_tpu_torch.train import init_train
from ucf_vit_tpu_torch.train import main
from ucf_vit_tpu_torch.train import synthetic_batches
from ucf_vit_tpu_torch.train import to_device
from ucf_vit_tpu_torch.utils import optim
from test_torch_train import (  # shared with that file
    LOSS_TOL,
    _assert_batches_equal,
    _mae_noise,
    _mae_optimizer,
)

# ================================================================ the octree and UNETR
#
# 3-D adaptive patching and UNETR's training at a small size (tile 16^3, patch 2,
# fixed_length 64 = 1 + 7 * 9 leaves, so sqrt_len 4; embed 24, depth 4, 2 heads,
# feature size 4, 4 classes, batch 2): the native Gaussian against scipy's
# `gaussian_filter` (its weights from the port's copy of scipy's formula), the octree's
# native build against its numpy build and the JAX tree box for box, the native
# serialization against the per-leaf resample and the JAX one bit for bit, `Patchify3D`
# on one generator state against the JAX one array for array, the 3-D adaptive
# `DataModule` with labels (in line and with a spawn pool) against the JAX one, five f32
# train steps of the shrunk basic_ct/unetr with remat against the JAX step (1e-4 a step),
# `transfer_mae_encoder` against the JAX one key for key and value for value, and the
# trainer's CLI from labelled NIfTI volumes warm-started from an MAE checkpoint.

from scipy.ndimage import gaussian_filter
from scipy.ndimage._filters import _gaussian_kernel1d

from ucf_vit_tpu.checkpoint import transfer_mae_encoder as jax_transfer_mae_encoder
from ucf_vit_tpu.data.octree import FixedOctTree as JFixedOctTree
from ucf_vit_tpu.data.transform import Patchify3D as JPatchify3D
from ucf_vit_tpu.tasks import build_unetr as jax_build_unetr
from ucf_vit_tpu.tasks import reassemble_sqrt_len as jax_reassemble
from ucf_vit_tpu_torch import native
from ucf_vit_tpu_torch.checkpoint import transfer_mae_encoder
from ucf_vit_tpu_torch.data.octree import FixedOctTree, octree_boxes_plain, resize_3d
from ucf_vit_tpu_torch.data.transform import Patchify3D
from ucf_vit_tpu_torch.models import UNETR
from ucf_vit_tpu_torch.ops.pos_embed import interpolate_pos_embed_1d
from ucf_vit_tpu_torch.train import transfer_pretrained_mae

UNETR_STEPS = 5


@pytest.mark.parametrize("sigma", [1, 3, 5])
def test_gaussian3d_matches_scipy(sigma):
    radius = int(4.0 * sigma + 0.5)
    np.testing.assert_array_equal(native.gaussian_weights(float(sigma), radius),
                                  _gaussian_kernel1d(float(sigma), 0, radius))
    img = np.random.default_rng(sigma).random((12, 10, 9, 2)).astype(np.float32)
    got = native.gaussian3d(img, float(sigma))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, gaussian_filter(img, sigma=(sigma, sigma, sigma, 0)))


def _edge_volume(kind, n=16):
    rng = np.random.default_rng(4)
    if kind == "sparse":
        return ((rng.random((n, n, n)) > 0.8) * 255).astype(np.uint8)
    v = np.zeros((n, n, n), np.uint8)  # mass in two corners, ties elsewhere
    v[:n // 4, :n // 4, :n // 2] = 85
    v[n // 2:, n // 2 + 2:, 3:7] = 170
    return v


@pytest.mark.parametrize("fixed_length", [8, 64, 60])
@pytest.mark.parametrize("edges", ["sparse", "blocks"])
def test_octree_native_matches_numpy_and_jax(edges, fixed_length):
    """60 is not 1 + 7n: the splits overshoot it, the same way in all three."""
    dom = _edge_volume(edges)
    boxes, vals = native.octree_boxes(dom, fixed_length, 85)
    pboxes, pvals = octree_boxes_plain(dom, fixed_length, 85)
    ref = JFixedOctTree(dom, fixed_length, 85)
    np.testing.assert_array_equal(boxes, pboxes)
    np.testing.assert_array_equal(vals, pvals)
    np.testing.assert_array_equal(boxes, [c.get_coord() for c, _ in ref.nodes])
    np.testing.assert_array_equal(vals, [v for _, v in ref.nodes])
    assert boxes.shape[0] == (64 if fixed_length == 60 else fixed_length)
    tree = FixedOctTree(dom, fixed_length, 85)
    assert [c.get_coord() for c, _ in tree.nodes] == [c.get_coord() for c, _ in ref.nodes]


@pytest.mark.parametrize("nearest", [False, True], ids=["trilinear", "nearest"])
def test_octree_serialize_matches_the_per_leaf_resample_and_jax(nearest):
    rng = np.random.default_rng(5)
    img = rng.random((16, 16, 16, 2)).astype(np.float32)
    if nearest:
        img = rng.integers(0, 4, size=(16, 16, 16, 1)).astype(np.float32)
    dom = _edge_volume("sparse")
    tree, ref = FixedOctTree(dom, 57, 255), JFixedOctTree(dom, 57, 255)
    c = img.shape[-1]
    serialize = tree.serialize_labels if nearest else tree.serialize
    jserialize = ref.serialize_labels if nearest else ref.serialize
    seq, size, pos = serialize(img, (2, 2, 2, c))
    for g, w in zip((seq, size, pos), jserialize(img, (2, 2, 2, c))):
        np.testing.assert_array_equal(g, np.asarray(w))
    per_leaf = [resize_3d(cube.get_area(img), (2, 2, 2), nearest=nearest).astype(np.float32)
                for cube, _ in tree.nodes]
    n = len(per_leaf)
    np.testing.assert_array_equal(seq[:n], np.stack(per_leaf))
    np.testing.assert_array_equal(seq[n:], 0)  # the padding
    assert (size[n:] == 0).all() and (pos[n:] == -1).all()
    np.testing.assert_array_equal(native.resize3d(img[:4, :4, :4], 2, nearest),
                                  per_leaf[0] * 0 + resize_3d(img[:4, :4, :4], (2, 2, 2),
                                                              nearest).astype(np.float32))


def test_octree_deserialize_matches_jax():
    dom = _edge_volume("blocks")
    tree, ref = FixedOctTree(dom, 64, 85), JFixedOctTree(dom, 64, 85)
    seq = np.random.default_rng(6).random((64, 8)).astype(np.float32)
    np.testing.assert_array_equal(tree.deserialize(seq, 2, 1), ref.deserialize(seq, 2, 1))


@pytest.mark.parametrize("channels", [1, 2])
def test_patchify3d_matches_jax(channels):
    """Eight volumes from one seeded generator each side: every smoothing factor
    (0: no smoothing) and Canny threshold the draws give; with two channels the
    cross-channel rules."""
    rng = np.random.default_rng(8)
    vols = rng.random((8, 16, 16, 16, channels)).astype(np.float32)
    vols[:, 4:12, 4:12, 4:12] += 0.5  # an edge the octree sees
    ours = Patchify3D(fixed_length=64, patch_size=2, num_channels=channels,
                      rng=np.random.default_rng(9))
    ref = JPatchify3D(fixed_length=64, patch_size=2, num_channels=channels,
                      rng=np.random.default_rng(9))
    for vol in vols:
        got, want = ours(vol), ref(vol)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[3].boxes, [c.get_coord() for c, _ in want[3].nodes])
    assert got[0].shape == ((64, 8) if channels == 1 else (2, 64, 8))
    with pytest.raises(RuntimeError, match="explicit"):
        Patchify3D(fixed_length=64, patch_size=2)(vols[0])


def _labelled_volumes(root, n, side, seed=0):
    """`n` int16 CT-like volumes of `side`^3 under <root>/imagesTr and label
    volumes 1-4 under <root>/labelsTr: thresholds of a smoothed copy, so that
    the labels have edges."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "imagesTr"))
    os.makedirs(os.path.join(root, "labelsTr"))
    for i in range(n):
        smooth = gaussian_filter(rng.normal(size=(side,) * 3), 2.0)
        vol = (smooth * 3000 + 40 * rng.normal(size=smooth.shape)).astype(np.int16)
        lab = 1 + np.digitize(smooth, np.quantile(smooth, [0.4, 0.7, 0.9])).astype(np.int16)
        nifti.save(os.path.join(root, "imagesTr", f"image{i}.nii"), vol)
        nifti.save(os.path.join(root, "labelsTr", f"label{i}.nii"), lab)
    return str(root)


@pytest.mark.parametrize("workers", [0, 3], ids=["in_line", "pool"])
def test_adaptive_3d_datamodule_with_labels_matches_jax(tmp_path, workers):
    """The 3-D adaptive chain that 3-D refused before this slice: `x`, `seq`,
    `seq_size`, `seq_pos`, `label` and `seq_label` array for array with the JAX
    DataModule, in line and in a spawn pool of 2, over two epochs."""
    keys = ["ct"]
    kw = dict(dict_root_dirs={"ct": _labelled_volumes(tmp_path / "ct", 2, 32)},
              tile_size_x=16, tile_size_y=16, tile_size_z=16, twoD=False, single_channel=True,
              dataset="basic_ct", batch_size=2, seed=3, adaptive_patching=True, patch_size=2,
              fixed_length=64, return_label=True, num_classes=4,
              dict_buffer_sizes={k: 4 for k in keys}, dict_in_variables={k: ["ct"] for k in keys},
              num_channels_used={k: 1 for k in keys}, dict_start_idx={k: 0.0 for k in keys},
              dict_end_idx={k: 1.0 for k in keys})
    port = DataModule(**kw, num_workers=workers, prefetch=2)
    jdm = JDataModule(**kw, prefetch=0)
    port.setup()
    jdm.setup()
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jdm.set_epoch(epoch)
        got = list(itertools.islice(port.train_dataloader(loop=True), 3))
        want = list(itertools.islice(jdm.train_dataloader(loop=True), 3))
        _assert_batches_equal(got, want)
    b = got[0]
    assert b["seq"].shape == (2, 1, 64, 8) and b["seq_pos"].shape == (2, 1, 64, 3)
    assert b["seq_label"].shape == (2, 64, 2, 2, 2) and b["label"].shape == (2, 1, 16, 16, 16)
    assert set(np.unique(b["label"])) <= {0, 1, 2, 3}


def _unetr_raw(**trainer):
    """basic_ct/unetr as shipped, shrunk (its task, f32, remat, adaptive octree input,
    the position MLP and the skip decoder kept)."""
    with open(os.path.join(REPO, "configs", "basic_ct", "unetr", "base_config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["net"]["init_args"].update(tile_size=[16, 16, 16], patch_size=2,
                                            fixed_length=64, embed_dim=24, depth=4,
                                            num_heads=2, feature_size=4)
    raw["model"].update(lr=1e-3, warmup_steps=2, max_steps=20, weight_decay=1e-5,
                        warmup_start_lr=1e-8, eta_min=1e-8)  # YAML reads 1e-5 as a string
    raw["trainer"].update(attn_impl="EINSUM", max_epochs=1, **trainer)
    raw["parallelism"] = {}
    raw["data"]["batch_size"] = 2
    return raw


def test_unetr_train_steps_match_jax():
    """Five f32 steps with remat from one JAX init on the synthetic stream
    (`seq`, `seq_size`, `seq_pos` and 4-class label volumes), the port's attention
    FLASH: the losses within LOSS_TOL a step. (The parameters are not compared:
    AdamW's first updates are lr x the gradient's sign, and some patch-embed
    gradients are 7e-7 with f32 convolution noise of 1.5e-7 on either side.)"""
    raw = _unetr_raw()
    jcfg, cfg = JConfig(raw=raw, task="unetr"), Config(raw=raw, task="unetr")
    stream = synthetic_batches(cfg, 2)
    batches = [{k: v for k, v in b.items() if k != "variables"}
               for _, b in zip(range(UNETR_STEPS), stream)]
    jmod, jloss = jax_build_unetr(jcfg)
    assert jmod.remat
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    seq = jax_reassemble(first["seq"], 4, 2, False)
    params = meta.unbox(jmod.init(jax.random.key(0), first["x"], None, jax_seq_ps(first),
                                  seq)["params"])
    params = jax.tree.map(jnp.asarray, params)
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=None, ema_params=None)
    jstep = jax_make_train_step(jloss, tx, donate=False)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    raw["trainer"]["attn_impl"] = "FLASH"
    cfg = Config(raw=raw, task="unetr")
    model = load_jax_params(build_task(cfg), jax.device_get(params))
    assert isinstance(model, UNETR) and model.remat and model.num_patches == 64
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt)
    step = make_train_step(task_loss(cfg), opt)
    losses = [step(state, to_device(b, torch.device("cpu")))[1].item() for b in batches]
    np.testing.assert_allclose(losses, jax_losses, atol=LOSS_TOL, rtol=0)
    assert state.step == UNETR_STEPS and losses[-1] < losses[0]


def _mae_for_unetr():
    """A JAX MAE (tile 16^3, patch 2: 512 tokens) with the shrunk UNETR's encoder
    width and depth, and that UNETR, each flax-initialised."""
    raw = _unetr_raw()
    jcfg = JConfig(raw=raw, task="unetr")
    junetr, _ = jax_build_unetr(jcfg)
    b = {k: jnp.asarray(v) for k, v in next(synthetic_batches(Config(raw=raw, task="unetr"),
                                                              2)).items() if k != "variables"}
    uparams = meta.unbox(junetr.init(jax.random.key(1), b["x"], None, jax_seq_ps(b),
                                     jax_reassemble(b["seq"], 4, 2, False))["params"])
    jmae = JMAE(attn_impl=JAttnImpl.EINSUM, class_token=False, img_size=(16, 16, 16),
                patch_size=2, in_chans=1, twoD=False, embed_dim=24, depth=4, num_heads=2,
                decoder_embed_dim=18, decoder_depth=1, decoder_num_heads=3)
    mparams = meta.unbox(jmae.init(jax.random.key(2), b["x"],
                                   mask_noise=jnp.asarray(_mae_noise(2, 512)))["params"])
    return jax.device_get(mparams), jax.device_get(uparams), raw


def test_transfer_mae_encoder_matches_jax():
    mparams, uparams, _ = _mae_for_unetr()
    want = jax_to_torch_state(jax_transfer_mae_encoder(mparams, uparams, new_pos_embed_len=64))
    mae_sd = {k: torch.from_numpy(v.copy()) for k, v in jax_to_torch_state(mparams).items()}
    target = {k: torch.from_numpy(v) for k, v in jax_to_torch_state(uparams).items()}
    got = transfer_mae_encoder(mae_sd, target, new_pos_embed_len=64)
    assert sorted(got) == sorted(want) == sorted(target)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the blocks and patch embed from the MAE, the table resampled, the decoder the UNETR's own
    assert torch.equal(got["blocks.3.mlp.fc2.weight"], mae_sd["blocks.3.mlp.fc2.weight"])
    np.testing.assert_array_equal(got["pos_embed"].numpy(),
                                  interpolate_pos_embed_1d(mae_sd["pos_embed"].numpy(), 64))
    assert torch.equal(got["decoder5.transp_conv.weight"], target["decoder5.transp_conv.weight"])
    assert torch.equal(got["adaptive_pos_dep_emb.0.weight"],
                       target["adaptive_pos_dep_emb.0.weight"])


def test_cli_trains_unetr_from_labelled_nifti_warm_started_from_an_mae(tmp_path, capsys):
    """`trainer.pretrained_mae_checkpoint` (refused before this slice) reads an MAE
    checkpoint: the encoder equals the MAE's tensor for tensor, the position table is
    resampled, the decoder keeps its init; then the shrunk basic_ct/unetr trains
    from labelled NIfTI volumes through the CLI and saves."""
    mparams, _, raw = _mae_for_unetr()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jax_to_torch_state(mparams).items()}
    mae_dir = tmp_path / "mae"
    os.makedirs(mae_dir)
    torch.save({"epoch": 3, "model_state_dict": sd, "loss_list": [], "head_meta": [2, 3]},
               str(mae_dir / "mae_odd.ckpt"))
    raw["trainer"].update(pretrained_mae_checkpoint=str(mae_dir),
                          checkpoint_path=str(tmp_path / "ck"))
    raw["data"].update(dict_root_dirs={"ct1": _labelled_volumes(tmp_path / "ct", 2, 32)},
                       num_workers=1)
    cfg = Config(raw=raw, task="unetr")
    state, _ = init_train(cfg, "cpu")
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    transfer_pretrained_mae(cfg, state.model, str(mae_dir))
    got = state.model.state_dict()
    assert torch.equal(got["blocks.2.attn.qkv.weight"], sd["blocks.2.attn.qkv.weight"])
    assert torch.equal(got["token_embeds.proj.weight"], sd["token_embeds.proj.weight"])
    np.testing.assert_array_equal(got["pos_embed"].numpy(),
                                  interpolate_pos_embed_1d(sd["pos_embed"].numpy(), 64))
    for k in ("decoder2.conv_block.conv1.weight", "encoder1.layer.conv1.weight", "out.conv.weight"):
        assert torch.equal(got[k], init[k])
    path = tmp_path / "unetr.yaml"
    path.write_text(yaml.safe_dump(raw))
    out = main([str(path), "--single-device", "--max-steps", "3", "--device", "cpu"])
    log = capsys.readouterr().out
    assert "initialized encoder from MAE checkpoint" in log
    assert len(out["loss_list"]) == 1 and np.isfinite(out["loss_list"][0])
    assert os.path.isfile(tmp_path / "ck" / "multi_last_even.ckpt")


# ================================================================ moved from test_torch_train.py
# Its DiffusionVIT and adaptive-patching sections, moved whole (names, bodies and tolerances unchanged) to spread the tier-1
# run's files over its workers.

from ucf_vit_tpu_torch.models import MAE
from ucf_vit_tpu_torch.tasks import build_mae
from ucf_vit_tpu_torch import checkpoint as ckpt
import copy
from ucf_vit_tpu.tools.convert_checkpoint import export_torch_state
from ucf_vit_tpu.tasks import build_classification as jax_build_classification
from ucf_vit_tpu.tasks import build_mae as jax_build_mae
from ucf_vit_tpu.data import catsdogs as jax_catsdogs
from ucf_vit_tpu.utils import metrics as jax_metrics
import json
from ucf_vit_tpu.ops.patchify import unpatchify as junpatchify
from ucf_vit_tpu_torch.utils import metrics
import multiprocessing
from ucf_vit_tpu_torch.data import catsdogs as port_catsdogs
import re
from ucf_vit_tpu_torch.inference import reconstruct
import subprocess
import sys
import threading
import time
from ucf_vit_tpu_torch.train import train
from ucf_vit_tpu_torch.ops.patchify import unpatchify
from test_torch_train import (  # shared with that file
    CATSDOGS,
    MAE_PRED_TOL,
    MAE_STEPS,
    PARAM_TOL,
    _jpegs,
    _mae_x,
    _volumes,
)

# ================================================================ DiffusionVIT + DDPM
#
# DiffusionVIT and the DDPM functions against the JAX package's, at depth 2, embed 24,
# decoder 16 (2-D) or 18 (3-D). Weights are the flax init plus numpy noise, moved across
# with `load_jax_params`; inputs, steps t and noise e come from numpy seeds and are
# injected into both sides; the time embedding's dropout is off on both (JAX
# `deterministic=True`, the port's module in eval mode). Tolerances: the time table
# exact (numpy on both sides); the schedule within 1e-6 relative (f32 cumprod in another
# order); `q_sample` and the loss within 1e-6; `pred` within 1e-5; per-step losses of
# 5 f32 train steps within 1e-4; the reverse chain at T = 10 within 1e-4.

from ucf_vit_tpu.models.ddpm import ddpm_sample as jax_ddpm_sample
from ucf_vit_tpu.models.ddpm import ddpm_schedule as jax_ddpm_schedule
from ucf_vit_tpu.models.ddpm import q_sample as jax_q_sample
from ucf_vit_tpu.models.diffusion import DiffusionVIT as JDiffusionVIT
from ucf_vit_tpu.ops.pos_embed import (
    sinusoidal_time_embedding_table as jax_time_table,
)
from ucf_vit_tpu.tasks import build_diffusion as jax_build_diffusion
from ucf_vit_tpu_torch.models import DiffusionVIT, ddpm_sample, ddpm_schedule, q_sample
from ucf_vit_tpu_torch.ops.pos_embed import sinusoidal_time_embedding_table
from ucf_vit_tpu_torch.tasks import build_diffusion

DIFF_PRED_TOL = 1e-5  # pred, f32
DIFF_SAMPLE_TOL = 1e-4  # the reverse chain, T = 10
DIFF_STEPS = 5
DIFF_T = 50  # time steps of the models below
DIFF_TILES = {
    "2d": dict(img_size=(16, 16), patch_size=4, in_chans=3, twoD=True, decoder_embed_dim=16),
    "3d": dict(img_size=(16, 16, 16), patch_size=4, in_chans=1, twoD=False),
}
DIFF_KW = dict(embed_dim=24, depth=2, num_heads=2, decoder_embed_dim=18, decoder_depth=2,
               decoder_num_heads=2, mlp_ratio_decoder=2.0, mlp_ratio=2.0, time_steps=DIFF_T)


def _diff_shape(tile, b=2):
    kw = DIFF_TILES[tile]
    return (b, kw["in_chans"]) + tuple(kw["img_size"])


def _diff_t(b, steps=DIFF_T, seed=3):
    return np.random.default_rng(seed).integers(0, steps, size=b).astype(np.int64)


def _diff_pair(tile, impl="FLASH", **kw):
    """(JAX DiffusionVIT, its params (flax init plus N(0, 0.05) noise), the port's
    model with them in eval mode, input x, steps t)."""
    kw = dict(DIFF_KW, **DIFF_TILES[tile], **kw)
    x = _mae_x(*_diff_shape(tile))
    t = _diff_t(2, steps=kw["time_steps"])
    jmod = JDiffusionVIT(attn_impl=JAttnImpl.EINSUM, class_token=False, **kw)
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t))["params"])
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    ours = load_jax_params(DiffusionVIT(attn_impl=impl, **kw), params).eval()
    return jmod, params, ours, x, t


@pytest.mark.parametrize("steps,dim", [(1000, 768), (DIFF_T, 24), (7, 10)])
def test_time_table_equals_jax(steps, dim):
    want = jax_time_table(steps, dim)
    got = sinusoidal_time_embedding_table(steps, dim)
    assert got.dtype == np.float64 and got.shape == (steps, dim)
    np.testing.assert_array_equal(got, want)
    # interleaved: even dims sin, odd dims cos of the same angle (step 1, frequency 1 first)
    assert got[1, 0] == np.sin(1.0) and got[1, 1] == np.cos(1.0)
    assert np.all(got[0, 1::2] == 1.0) and np.all(got[0, 0::2] == 0.0)


@pytest.mark.parametrize("steps", [10, 1000])
def test_ddpm_schedule_matches_jax(steps):
    ours, ref = ddpm_schedule(steps), jax_ddpm_schedule(steps)
    assert ours.num_time_steps == ref.num_time_steps == steps
    for got, want in ((ours.beta, ref.beta), (ours.alpha_bar, ref.alpha_bar)):
        assert got.dtype == torch.float32 and got.shape == (steps,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("tile", sorted(DIFF_TILES))
def test_q_sample_matches_jax(tile):
    x0 = _mae_x(*_diff_shape(tile, b=3), seed=4)
    e = _mae_x(*_diff_shape(tile, b=3), seed=5)
    t = np.array([0, 499, 999])
    got = q_sample(ddpm_schedule(1000), torch.from_numpy(x0), torch.from_numpy(t),
                   torch.from_numpy(e))
    want = jax_q_sample(jax_ddpm_schedule(1000), jnp.asarray(x0), jnp.asarray(t), jnp.asarray(e))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["2d", "3d", "2d_linear_decoder"])
def test_diffusion_vit_matches_jax(case):
    """`pred` within DIFF_PRED_TOL, through `load_jax_params`; the port's state_dict
    agrees key for key with the JAX package's `export_torch_state` (the time table is
    in neither)."""
    tile, _, linear = case.partition("_")
    jmod, params, ours, x, t = _diff_pair(tile, linear_decoder=bool(linear))
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    pred = ours(torch.from_numpy(x), torch.from_numpy(t))
    assert pred.shape == want.shape == (2, ours.num_patches, ours.decoder_pred.out_features)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want), atol=DIFF_PRED_TOL,
                               rtol=0)
    theirs = export_torch_state(params)
    assert set(ours.state_dict()) == set(theirs) == set(jax_to_torch_state(params))
    assert "timeEmbeddingMap.linear1.weight" in theirs and "time_table" not in theirs
    assert (ours.decoder_blocks is None) == bool(linear)


def test_diffusion_vit_refuses_what_it_cannot_run():
    kw = dict(DIFF_KW, **DIFF_TILES["2d"])
    with pytest.raises(ValueError, match="class_token=False"):
        DiffusionVIT(class_token=True, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, modules to port: pipeline"):
        DiffusionVIT(pipe_par_size=2, scan_layers=True, **kw)


def _diff_raw(tile="2d", **trainer):
    kw = DIFF_TILES[tile]
    ia = {"default_vars": ["r", "g", "b"][:kw["in_chans"]], "tile_size": list(kw["img_size"]),
          "patch_size": kw["patch_size"], "twoD": kw["twoD"], "adaptive_patching": False,
          "use_varemb": False, **{k: v for k, v in DIFF_KW.items() if k != "time_steps"},
          "decoder_embed_dim": kw.get("decoder_embed_dim", DIFF_KW["decoder_embed_dim"]),
          "num_time_steps": DIFF_T}
    m = {"lr": 1e-3, "beta_1": 0.9, "beta_2": 0.95, "weight_decay": 1e-2, "warmup_steps": 2,
         "max_steps": 20, "warmup_start_lr": 1e-8, "eta_min": 1e-8, "loss_fn": "MSE",
         "net": {"init_args": ia}}
    return {"trainer": {"task": "diffusion", "attn_impl": "EINSUM", **trainer},
            "parallelism": {}, "model": m,
            "data": {"batch_size": 4, "num_channels_used": {"d": kw["in_chans"]}}}


def _diff_batch(cfg, b, i=0):
    x = next(synthetic_batches(cfg, b, seed=i))["x"]
    e = np.random.default_rng(20 + i).normal(size=x.shape).astype(np.float32)
    return {"x": x, "t": _diff_t(b, seed=10 + i), "e": e}


@pytest.mark.parametrize("tile", sorted(DIFF_TILES))
def test_diffusion_loss_matches_build_diffusion(monkeypatch, tile):
    """The port's `task_loss` with `(t, e)` in the batch against `build_diffusion`'s
    own loss_fn with its draws of t and e replaced by the same arrays."""
    raw = _diff_raw(tile)
    cfg = Config(raw=raw, task="diffusion")
    jmod, jloss = jax_build_diffusion(JConfig(raw=raw, task="diffusion"))
    batch = _diff_batch(cfg, 4)
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(batch["x"]),
                                  jnp.zeros(4, jnp.int32))["params"])
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(batch["t"]))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(batch["e"]))
    want, _ = jloss(params, {"x": jnp.asarray(batch["x"])}, jax.random.key(0),
                    deterministic=True)
    model = load_jax_params(build_diffusion(cfg), params).eval()
    got, aux = task_loss(cfg)(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert aux == {} and got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6


def _jax_diff_loss(jmod, patch, twoD):
    """`build_diffusion`'s loss with t and e taken from the batch and the time
    embedding's dropout off: the JAX step is jitted, so they must enter as data."""
    def loss_fn(params, batch, rng):
        x0 = batch["x"]
        xt = jax_q_sample(jax_ddpm_schedule(DIFF_T), x0, batch["t"], batch["e"])
        pred = jmod.apply({"params": params}, xt, batch["t"], deterministic=True)
        return jax_metrics.mse(junpatchify(pred, x0.shape, patch, twoD), batch["e"]), {}
    return loss_fn


def _port_diff_loss(cfg):
    """The port's diffusion loss on the batch's t and e with the time embedding's
    dropout off (the train step puts every module in training mode first)."""
    loss = task_loss(cfg)

    def loss_fn(model, batch):
        model.timeEmbeddingMap.eval()
        return loss(model, batch)
    return loss_fn


@pytest.mark.parametrize("case", ["f32", "f32_flash_accum2"])
def test_diffusion_train_steps_match_jax(case):
    """Five f32 steps from one init on the same batches, steps and noise (split with
    the batch under accumulation): per-step losses within LOSS_TOL, parameters after
    them within PARAM_TOL."""
    impl, accum = ("FLASH", 2) if "flash" in case else ("EINSUM", 1)
    raw = _diff_raw("2d", accum_steps=accum)
    cfg = Config(raw=raw, task="diffusion")
    jmod, _ = jax_build_diffusion(JConfig(raw=raw, task="diffusion"))
    stream = synthetic_batches(cfg, 4)
    batches = []
    for i, b in zip(range(DIFF_STEPS), stream):
        assert set(b) == {"x", "variables"}  # diffusion's synthetic batches hold x only
        batches.append({"x": b["x"], "t": _diff_t(4, seed=10 + i),
                        "e": _mae_x(*b["x"].shape, seed=20 + i)})
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(batches[0]["x"]),
                                  jnp.zeros(4, jnp.int32))["params"])
    params = jax.tree.map(jnp.asarray, params)
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=None, ema_params=None)
    jstep = jax_make_train_step(_jax_diff_loss(jmod, 4, True), tx, donate=False,
                                accum_steps=accum)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    raw["trainer"]["attn_impl"] = impl
    cfg = Config(raw=raw, task="diffusion")
    model = load_jax_params(build_diffusion(cfg), jax.device_get(params))
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt)
    step = make_train_step(_port_diff_loss(cfg), opt, accum_steps=accum)
    losses = []
    for b in batches:
        state, loss, aux = step(state, to_device(b, torch.device("cpu")))
        losses.append(loss.item())
    assert aux == {} and state.step == DIFF_STEPS
    np.testing.assert_allclose(losses, jax_losses, atol=LOSS_TOL, rtol=0)
    final = jax_to_torch_state(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name], atol=PARAM_TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("tile", sorted(DIFF_TILES))
def test_ddpm_sample_matches_jax(tile):
    """The reverse chain at T = 10 on one model: the JAX sampler under its own key,
    the port's on the arrays of that key chain (a split for x_T, then one split and
    one normal a step, the last step's included)."""
    steps = 10
    jmod, params, ours, x, _ = _diff_pair(tile, time_steps=steps)
    kw = DIFF_TILES[tile]
    shape = x.shape

    def jdenoise(x_t, t):
        return junpatchify(jmod.apply({"params": params}, x_t, t), shape, kw["patch_size"],
                           kw["twoD"])

    key = jax.random.key(5)
    want = np.asarray(jax.jit(lambda k: jax_ddpm_sample(jax_ddpm_schedule(steps), jdenoise, k,
                                                        shape))(key))
    key, init_key = jax.random.split(key)
    x_T = np.array(jax.random.normal(init_key, shape))
    noises = []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noises.append(torch.from_numpy(np.array(jax.random.normal(nkey, shape))))

    def denoise(x_t, t):
        return unpatchify(ours(x_t, t), shape, kw["patch_size"], kw["twoD"])

    state = torch.random.get_rng_state()
    got = ddpm_sample(ddpm_schedule(steps), denoise, None, shape, "cpu",
                      x_T=torch.from_numpy(x_T), noises=noises)
    assert torch.equal(state, torch.random.get_rng_state())
    assert got.shape == shape and np.all(np.isfinite(want))
    np.testing.assert_allclose(got.numpy(), want, atol=DIFF_SAMPLE_TOL, rtol=0)
    with pytest.raises(ValueError, match="explicit generator"):
        ddpm_sample(ddpm_schedule(steps), denoise, None, shape, "cpu")


def test_time_embedding_dropout_draws_from_the_model_generator():
    """At rate 0.5 the time MLP's dropout draws from the model's generator: a train
    step without one raises; two steps from one seed are equal bit for bit; torch's
    global generator is never touched; about half of the entries are kept, each
    scaled by 2."""
    from ucf_vit_tpu_torch.train import init_train

    cfg = Config(raw=_diff_raw("2d"), task="diffusion")
    batch = to_device(next(synthetic_batches(cfg, 4)), torch.device("cpu"))
    bare = build_diffusion(cfg).train()
    with pytest.raises(RuntimeError, match="set_generator"):
        task_loss(cfg)(bare, batch)
    seen = []

    def hook(module, inputs, output):
        seen.append((inputs[0].detach().clone(), output.detach().clone()))

    runs = []
    for _ in range(2):
        state, step = init_train(cfg, "cpu")  # building modules draws from torch's generator
        drop = state.model.timeEmbeddingMap.dropout
        assert drop.rate == 0.5 and drop.generator is state.model.generator
        handle = drop.register_forward_hook(hook)
        global_state = torch.random.get_rng_state()
        state, loss, _ = step(state, batch)
        assert torch.equal(global_state, torch.random.get_rng_state())  # the step does not
        handle.remove()
        runs.append((loss.item(), {n: p.detach().clone()
                                   for n, p in state.model.named_parameters()}))
    (la, pa), (lb, pb) = runs
    assert la == lb and all(torch.equal(pa[n], pb[n]) for n in pa)
    x_in, x_out = seen[0]
    assert torch.equal(seen[0][1], seen[1][1])
    kept = x_out != 0
    assert torch.equal(x_out[kept], 2 * x_in[kept])
    live = x_in != 0  # ReLU's zeros stay zero either way
    share = (kept & live).sum().item() / live.sum().item()
    assert 0.3 < share < 0.7, share


DIFF_CONFIGS = {"imagenet": ("configs/imagenet/diffusion/base_config.yaml", [16, 16], 3),
                "basic_ct": ("configs/basic_ct/diffusion/base_config.yaml", [16, 16, 16], 1)}


@pytest.mark.parametrize("name", sorted(DIFF_CONFIGS))
def test_cli_trains_diffusion_config_shrunk(tmp_path, capsys, name):
    """A shipped diffusion config (f32, 2 microbatches, loss scaling, a simple_ddp 8
    mesh) through the CLI with `--single-device`, shrunk in a copy to a 16^2 tile at
    patch 4, depth 2, embed 24 and a decoder of 16 (the rest as shipped): two epochs of
    two steps, each saved to its slot; then a run resumed from the newer slot to a
    third epoch keeps the first two epochs' losses."""
    rel, tile, chans = DIFF_CONFIGS[name]
    raw = yaml.safe_load(open(os.path.join(REPO, rel)))
    assert raw["trainer"]["task"] == "diffusion" and raw["trainer"]["accum_steps"] == 2
    assert raw["parallelism"]["simple_ddp_size"] == 8 and raw["model"]["use_grad_scaler"]
    raw["model"]["net"]["init_args"].update(
        tile_size=tile, patch_size=4, embed_dim=24, depth=2, num_heads=2, decoder_embed_dim=16,
        decoder_depth=2, decoder_num_heads=2)
    ck = tmp_path / "ck"
    raw["trainer"].update(checkpoint_path=str(ck), max_epochs=2,
                          checkpoint_filename_for_loading="multi_last_latest",
                          metrics_path=str(tmp_path / "metrics.jsonl"))
    raw["data"]["batch_size"] = 4
    raw["load_balancing"]["batches_per_rank_epoch"] = {
        k: 2 for k in raw["load_balancing"]["batches_per_rank_epoch"]}
    small = tmp_path / f"{name}_small.yaml"
    small.write_text(yaml.safe_dump(raw))
    with pytest.raises(RuntimeError, match="single-device"):  # 8 processes, 1 launched
        main([str(small), "--synthetic", "--device", "cpu"])
    out = main([str(small), "--single-device", "--device", "cpu", "--synthetic"])
    log = capsys.readouterr().out
    assert "epoch 1 it 2 loss" in log and "epoch 1 done" in log
    model = out["state"].model
    assert isinstance(model, DiffusionVIT) and model.num_patches == 16
    assert model.token_embeds.proj.in_channels == chans and model.time_steps == 1000
    assert len(out["loss_list"]) == 2 and all(np.isfinite(out["loss_list"]))
    assert sorted(os.listdir(ck)) == ["multi_last_even.ckpt", "multi_last_odd.ckpt"]
    assert ckpt.restore_checkpoint(str(ck), "multi_last_latest")["head_meta"] == [2, 2]

    raw["trainer"].update(max_epochs=3, resume_from_checkpoint=True)
    small.write_text(yaml.safe_dump(raw))
    resumed = main([str(small), "--single-device", "--device", "cpu", "--synthetic"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert resumed["loss_list"][:2] == out["loss_list"] and len(resumed["loss_list"]) == 3
    assert resumed["state"].optimizer.count == 6 and np.isfinite(resumed["loss_list"][2])


@pytest.mark.parametrize("source", ["flash_fwd_tf32", "flash_bwd_tf32", "flash_fwd_sm90",
                                    "flash_bwd_sm90"])
def test_kernel_instance_mirrors_the_sources_dispatch(source):
    """`kernel_instance` (the key of the launch counts by head-dim instance) picks
    the instance each source's `dispatch_dh` launches: the diffusion decoders' dh
    128 and 96 go to `DH = 128` and, in f32, `DH = 96`."""
    import re

    from ucf_vit_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        kernel_instance,
        reset_launch_counts,
    )

    text = open(os.path.join(REPO, "ucf_vit_tpu_torch", "csrc", f"{source}.cu")).read()
    dispatch = text[text.index("dispatch_dh("):]
    dispatch = dispatch[:dispatch.index("return cudaErrorInvalidValue")]
    bounds = [int(n) for n in re.findall(r"p\.dh <= (\d+)\) return launch<(?:\1)", dispatch)]
    assert bounds and bounds == sorted(bounds)
    for dh in range(1, bounds[-1] + 1):
        assert kernel_instance(source, dh) == f"{source}<{min(b for b in bounds if dh <= b)}>"
    with pytest.raises(ValueError, match="head dims up to"):
        kernel_instance(source, bounds[-1] + 1)
    assert kernel_instance("flash_fwd_tf32", 96) == "flash_fwd_tf32<96>"
    reset_launch_counts()
    q = torch.zeros(1, 1, 4, 8)
    flash_attention(q, q, q)  # a CPU call takes the plain version and counts nothing
    counts = flash_attention_bwd.by_instance if "bwd" in source else flash_attention.by_instance
    assert {k for k in counts if k.startswith(source)} == {f"{source}<{b}>" for b in bounds}
    assert not any(counts.values())


# ---------------------------------------------------------------- adaptive patching
#
# The three adaptive configs (imagenet/classification, imagenet/mae with seq_pack 2,
# basic_ct/mae single-channel) shrunk to a 32x32 tile at patch 4, 16 patches, depth 2,
# embed 32: MAE `pred` with the mask noise injected (1e-5), the adaptive MAE loss
# against `build_mae`'s, and 5 f32 train steps on the synthetic stream from one JAX
# init (1e-4 a step; the MAE's mask noise taken from the batch on both sides, the
# config's loss scaling on both). Then the data: `DataModule` on seeded JPEGs and NIfTI
# slices against the JAX one, in line and with a spawn pool, array for array; a
# fast-forward that patchifies no skipped sample; the pool's children importing the
# data modules alone; the adaptive catsdogs loader.

from ucf_vit_tpu.tasks import _seq_ps as jax_seq_ps
from ucf_vit_tpu_torch.data import transform as port_transform
from ucf_vit_tpu_torch.tasks import build_task
from ucf_vit_tpu_torch.tasks import seq_ps as port_seq_ps

ADAPTIVE_CONFIGS = ("imagenet/classification", "imagenet/mae", "basic_ct/mae")


def _adaptive_raw(name):
    """A shipped adaptive config, shrunk (its task, loss scaling, seq_pack and
    channels kept)."""
    with open(os.path.join(REPO, "configs", name, "base_config.yaml")) as f:
        raw = yaml.safe_load(f)
    ia = raw["model"]["net"]["init_args"]
    ia.update(tile_size=[32, 32, 2][:len(ia["tile_size"])], patch_size=4, embed_dim=32, depth=2, num_heads=2, fixed_length=16)
    if raw["trainer"]["task"] == "mae":
        ia.update(decoder_embed_dim=24, decoder_depth=2, decoder_num_heads=2)
    raw["model"].update(lr=1e-3, warmup_steps=2, max_steps=20, weight_decay=1e-5,
                        warmup_start_lr=1e-8, eta_min=1e-8)  # YAML reads 1e-5 as a string
    raw["trainer"].update(attn_impl="EINSUM", max_epochs=2)
    raw["parallelism"] = {}
    raw["data"].update(batch_size=4, num_classes=4)
    return raw


def _adaptive_batches(cfg, n, seed=20):
    stream = synthetic_batches(cfg, 4)
    out = []
    for i, b in zip(range(n), stream):
        b = {k: v for k, v in b.items() if k != "x" and k != "variables"}
        if cfg.task == "mae":
            b["mask_noise"] = _mae_noise(4, 16, seed=seed + i)
        out.append(b)
    return out


@pytest.mark.parametrize("seq_pack", [1, 2])
def test_adaptive_mae_matches_jax(seq_pack):
    kw = dict(img_size=(32, 32), patch_size=4, in_chans=1, embed_dim=24, depth=2,
              num_heads=2, decoder_embed_dim=18, decoder_depth=2, decoder_num_heads=3,
              adaptive_patching=True, fixed_length=16, use_adaptive_pos_emb=True,
              seq_pack=seq_pack)
    b = _adaptive_batches(Config(raw=_adaptive_raw("basic_ct/mae"), task="mae"), 1)[0]
    seq, noise = b["seq"][:2], b["mask_noise"][:2]
    ps = np.asarray(jax_seq_ps({k: jnp.asarray(v[:2]) for k, v in b.items()}))
    jmod = JMAE(attn_impl=JAttnImpl.EINSUM, class_token=False, **kw)
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(seq), None, jnp.asarray(ps),
                                  mask_noise=jnp.asarray(noise))["params"])
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    assert sorted(jax_to_torch_state(params)) == sorted(export_torch_state(params))
    ours = load_jax_params(MAE(attn_impl="FLASH", **kw), params).eval()
    want, wmask = jmod.apply({"params": params}, jnp.asarray(seq), None, jnp.asarray(ps),
                             mask_noise=jnp.asarray(noise))
    np.testing.assert_array_equal(
        port_seq_ps({k: torch.from_numpy(v[:2]) for k, v in b.items()}).numpy(), ps)
    with torch.inference_mode():
        got, mask = ours(torch.from_numpy(seq), mask_noise=torch.from_numpy(noise),
                         seq_ps=torch.from_numpy(ps))
        alone = reconstruct(ours, torch.from_numpy(seq), seed=3, seq_ps=torch.from_numpy(ps))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MAE_PRED_TOL, rtol=0)
    assert alone.shape == got.shape == (2, 16, 16)  # tokens [B, L, p^2 * C]


def test_adaptive_mae_loss_matches_build_mae(monkeypatch):
    raw = _adaptive_raw("imagenet/mae")
    jmod, jloss = jax_build_mae(JConfig(raw=raw, task="mae"))
    cfg = Config(raw=raw, task="mae")
    b = _adaptive_batches(cfg, 1)[0]
    noise = torch.rand(4, 16, generator=torch.Generator().manual_seed(5)).numpy()
    jb = {k: jnp.asarray(v) for k, v in b.items() if k != "mask_noise"}
    params = meta.unbox(jmod.init(jax.random.key(0), jb["seq"], None, jax_seq_ps(jb),
                                  mask_noise=jnp.asarray(noise))["params"])
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(noise))
    want, _ = jloss(params, jb, jax.random.key(0))
    model = load_jax_params(build_mae(cfg), jax.device_get(params)).train()
    model.set_generator(torch.Generator().manual_seed(5), torch.Generator().manual_seed(6))
    got, aux = task_loss(cfg)(model, {k: torch.from_numpy(v) for k, v in b.items()})
    assert aux == {} and abs(got.item() - float(want)) <= 1e-6


def _adaptive_jax_loss(jmod, cfg, jloss):
    if cfg.task != "mae":
        return jloss

    def loss_fn(params, batch, rng):  # build_mae's adaptive loss, the noise from the batch
        seq = batch["seq"]
        pred, _ = jmod.apply({"params": params}, seq, None, jax_seq_ps(batch),
                             deterministic=False, mask_noise=batch["mask_noise"],
                             rngs={"dropout": rng})
        b, c, l, p = seq.shape
        return jax_metrics.mse(pred, seq.transpose(0, 2, 3, 1).reshape(b, l, p * c)), {}
    return loss_fn


def _adaptive_port_loss(cfg):
    if cfg.task != "mae":
        return task_loss(cfg)

    def loss_fn(model, batch):
        seq = batch["seq"]
        pred, _ = model(seq, mask_noise=batch["mask_noise"], seq_ps=port_seq_ps(batch))
        b, c, l, p = seq.shape
        return metrics.mse(pred, seq.permute(0, 2, 3, 1).reshape(b, l, p * c)), {}
    return loss_fn


@pytest.mark.parametrize("name", ADAPTIVE_CONFIGS)
def test_adaptive_train_steps_match_jax(name):
    raw = _adaptive_raw(name)
    task = raw["trainer"]["task"]
    jcfg, cfg = JConfig(raw=raw, task=task), Config(raw=raw, task=task)
    batches = _adaptive_batches(cfg, MAE_STEPS)
    jmod, jloss = (jax_build_mae if task == "mae" else jax_build_classification)(jcfg)
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    extra = {"mask_noise": first["mask_noise"]} if task == "mae" else {}
    params = meta.unbox(jmod.init(jax.random.key(0), first["seq"], None, jax_seq_ps(first),
                                  **extra)["params"])
    params = jax.tree.map(jnp.asarray, params)
    scaler = bool(raw["model"].get("use_grad_scaler", False))
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=jax_optim.init_loss_scale() if scaler else None,
                         ema_params=None)
    jstep = jax_make_train_step(_adaptive_jax_loss(jmod, jcfg, jloss), tx, donate=False)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    raw["trainer"]["attn_impl"] = "FLASH"
    cfg = Config(raw=raw, task=task)
    model = load_jax_params(build_task(cfg), jax.device_get(params))
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt, use_grad_scaler=scaler)
    step = make_train_step(_adaptive_port_loss(cfg), opt)
    losses = [step(state, to_device(b, torch.device("cpu")))[1].item() for b in batches]
    np.testing.assert_allclose(losses, jax_losses, atol=LOSS_TOL, rtol=0)
    final = jax_to_torch_state(jax.device_get(jstate.params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[n], atol=PARAM_TOL, rtol=0,
                                   err_msg=n)


def _imagenet_jpegs(root, per_class=3):
    for i, cls in enumerate(("n01", "n02")):
        _jpegs(os.path.join(root, cls), [f"img{j}.JPEG" for j in range(per_class)],
               size=(48, 40), seed=i)
    return str(root)


def _adaptive_dm_case(tmp_path, case):
    kw = dict(tile_size_x=32, tile_size_y=32, twoD=True, adaptive_patching=True,
              patch_size=4, fixed_length=16, batch_size=2, seed=3)
    if case == "imagenet":
        keys, names = ["imagenet"], ["red", "green", "blue"]
        kw.update(dict_root_dirs={"imagenet": _imagenet_jpegs(tmp_path / "in")},
                  dataset="imagenet", return_label=True, num_classes=2,
                  imagenet_resize={"imagenet": (32, 32)})
    else:
        keys, names = ["ct"], ["ct"]
        kw.update(dict_root_dirs={"ct": _volumes(tmp_path / "ct", 3, (32, 32, 2),
                                                 labels=3 if case == "basic_ct_labels" else 0)},
                  dataset="basic_ct", tile_size_z=2, single_channel=True)
        if case == "basic_ct_labels":
            kw.update(return_label=True, num_classes=3)
    kw.update(dict_buffer_sizes={k: 4 for k in keys}, dict_in_variables={k: names for k in keys},
              num_channels_used={k: len(names) for k in keys},
              dict_start_idx={k: 0.0 for k in keys}, dict_end_idx={k: 1.0 for k in keys})
    return kw


@pytest.mark.parametrize("case,workers", [("imagenet", 0), ("imagenet", 3), ("basic_ct", 0),
                                          ("basic_ct", 3), ("basic_ct_labels", 0)])
def test_adaptive_datamodule_matches_jax(tmp_path, case, workers):
    """Two epochs (past each chain's end) and a fast-forward, against the JAX
    DataModule in line: `num_workers` 3 patchifies in a spawn pool of 2."""
    kw = _adaptive_dm_case(tmp_path, case)
    port = DataModule(**kw, num_workers=workers, prefetch=2)
    jdm = JDataModule(**kw, prefetch=0)
    port.setup()
    jdm.setup()
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jdm.set_epoch(epoch)
        got = list(itertools.islice(port.train_dataloader(loop=True), 4))
        want = list(itertools.islice(jdm.train_dataloader(loop=True), 4))
        _assert_batches_equal(got, want)
        assert got[0]["seq"].shape == (2, 1 if case != "imagenet" else 3, 16, 16)
    port.set_epoch(2)  # fresh chains (the prefetch thread read ahead on the old ones)
    jdm.set_epoch(2)
    _assert_batches_equal(list(port.train_dataloader(skip_batches=1)),
                          list(jdm.train_dataloader(skip_batches=1)))


def test_adaptive_batches_carry_the_trees_with_return_qdt(tmp_path):
    kw = _adaptive_dm_case(tmp_path, "basic_ct")
    port = DataModule(**kw, return_qdt=True, prefetch=0)
    jdm = JDataModule(**kw, return_qdt=True, prefetch=0)
    port.setup()
    jdm.setup()
    got, want = next(port.train_dataloader()), next(jdm.train_dataloader())
    # every array reaches the device, the trees and the variable names stay on the host
    assert sorted(to_device(got, torch.device("cpu"))) == ["seq", "seq_pos", "seq_size", "x"]
    assert [q.encode_nodes() for q in got.pop("qdt")] == [
        q.encode_nodes() for q in want.pop("qdt")]
    _assert_batches_equal([got], [want])


def test_adaptive_fast_forward_patchifies_no_skipped_sample(tmp_path, monkeypatch):
    calls = []
    call = port_transform.Patchify.__call__
    monkeypatch.setattr(port_transform.Patchify, "__call__",
                        lambda self, img, rng=None: calls.append(1) or call(self, img, rng))
    kw = _adaptive_dm_case(tmp_path, "basic_ct")
    dm = DataModule(**kw, prefetch=0)
    dm.setup()
    whole = list(itertools.islice(dm.train_dataloader(), 3))
    dm.set_epoch(1)
    dm.set_epoch(0)
    calls.clear()
    rest = list(itertools.islice(dm.train_dataloader(skip_batches=2), 1))
    assert len(calls) == 2  # one batch of 2 made; the 4 skipped samples never patchified
    _assert_batches_equal(rest, whole[2:])


def test_pool_children_import_the_data_modules_alone(tmp_path):
    """A trainer's main module imports torch; the spawn pool's children do not
    run it again: a child holds numpy and the port's data modules, no torch, no
    JAX, nothing of the JAX package."""
    script = tmp_path / "main.py"
    script.write_text(
        "import json, sys, torch\n"
        "from ucf_vit_tpu_torch.data.pipeline import make_pool\n"
        "spec = dict(num_channels=1, single_channel=True, return_label=False,\n"
        "            dataset='basic_ct', adaptive_patching=True, patch_size=4,\n"
        "            fixed_length=16, aug_seed=0)\n"
        "if __name__ == '__main__':\n"
        "    with make_pool(spec, 1) as pool:\n"
        "        assert pool._mp_context.get_start_method() == 'spawn'\n"
        "        print(json.dumps(pool.submit(eval, 'sorted(__import__(\"sys\").modules)')\n"
        "                         .result(timeout=120)))\n")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "ucf_vit_tpu_torch.data.transform" in mods and "numpy" in mods
    assert not [m for m in mods if re.match(r"(torch|jax|flax|ucf_vit_tpu(?!_torch))(\.|$)", m)]
    assert {m for m in mods if m.startswith("ucf_vit_tpu_torch")} <= {
        "ucf_vit_tpu_torch", "ucf_vit_tpu_torch.data", "ucf_vit_tpu_torch.data.pipeline",
        "ucf_vit_tpu_torch.data.nifti", "ucf_vit_tpu_torch.data.transform",
        "ucf_vit_tpu_torch.data.quadtree", "ucf_vit_tpu_torch.data.octree",
        "ucf_vit_tpu_torch.native"}


def test_pools_started_from_three_threads_leave_the_main_module_whole():
    """Three loaders' pools started at once, from three threads: `make_pool` starts
    every worker before it returns, the main module's `__spec__` and `__file__`
    come back as they were, and an ordinary spawn afterwards still runs."""
    from ucf_vit_tpu_torch.data.pipeline import make_pool

    main = sys.modules["__main__"]
    before = {k: main.__dict__.get(k, "absent") for k in ("__spec__", "__file__")}
    spec = dict(num_channels=1, single_channel=True, return_label=False, dataset="basic_ct",
                adaptive_patching=True, patch_size=4, fixed_length=16, aug_seed=0)
    start, pools = threading.Barrier(3), []

    def build():
        start.wait()
        pool = make_pool(spec, 2)
        pools.append((len(pool._processes), pool))

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    try:
        assert [n for n, _ in pools] == [2, 2, 2]
        assert {k: main.__dict__.get(k, "absent") for k in before} == before
        child = multiprocessing.get_context("spawn").Process(target=time.sleep, args=(0,))
        child.start()
        child.join(timeout=120)
        assert child.exitcode == 0
        assert [p.submit(abs, -3).result(timeout=120) for _, p in pools] == [3, 3, 3]
    finally:
        for _, p in pools:
            p.shutdown(wait=True)


def test_adaptive_catsdogs_matches_jax(tmp_path):
    root = _jpegs(tmp_path / "cd", CATSDOGS, size=(40, 36))
    files = port_catsdogs.list_file_split(root, 0.0, 1.0)
    kw = dict(adaptive_patching=True, fixed_length=16, patch_size=4)
    ds = port_catsdogs.CatsDogsDataset(files, ("r", "g", "b"), (32, 32),
                                       rng=np.random.default_rng(8), **kw)
    jds = jax_catsdogs.CatsDogsDataset(files, ("r", "g", "b"), (32, 32),
                                       rng=np.random.default_rng(8), **kw)
    got = list(port_catsdogs.catsdogs_loader(ds, 2, seed=1))
    _assert_batches_equal(got, list(jax_catsdogs.catsdogs_loader(jds, 2, seed=1)))
    assert got[0]["seq"].shape == (2, 3, 16, 16) and got[0]["seq_size"].shape == (2, 1, 16)


