"""The port's flash-attention forward and attention dispatch against the JAX
package: the plain version (what FLASH runs on a CPU tensor) against the
Pallas kernel in interpret mode and the einsum oracle, lse against the
kernel's own, and the dispatch rules; the split route's plain versions (dkv,
dq) against the Pallas split route. Also the arithmetic of the f32 kernels'
3xTF32 split, emulated in torch, against the f32 plain versions. Inputs come
from numpy seeds.

The CUDA kernel itself runs only on the card: see
tests/test_torch_flash_cuda.py. What decides, on the host, which layouts the
bf16 forward's TMA loads take (`fwd_layout`) is tested here on CPU tensors."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

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
