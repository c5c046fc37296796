"""The port's CUDA kernels (flash attention forward, both backward routes and
dropout: f32 by the 3xTF32 split and bf16 by wgmma on the tensor cores; the
fused MLP; the W8A8 int8 GEMM) against their plain versions, on the card.
Marked `cuda`; skips without a card. This file imports neither JAX nor the
JAX package, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_flash_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from ucf_vit_tpu_torch.models.blocks import Block
from ucf_vit_tpu_torch.ops.attn_dropout import keep_mask
from ucf_vit_tpu_torch.ops.flash_attention import (
    _tokens_major,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
    fwd_layout,
    reset_launch_counts,
)
from ucf_vit_tpu_torch.ops.fused_mlp import (
    fused_mlp,
    fused_mlp_plain,
    mlp_plan,
)
from ucf_vit_tpu_torch.ops.fused_mlp import reset_launch_counts as reset_mlp_counts
from ucf_vit_tpu_torch.ops.int8_gemm import (
    int8_matmul,
    int8_matmul_plain,
    quantize_rows,
    quantize_rows_plain,
    quantize_weight,
)

# (b, h, n_q, n_kv, dh): the training shape at batch 2, dh 36, Nq = 1, a
# trailing partial key tile with Nq > Nkv, dh 128 with Nq < Nkv, and dh 33,
# whose rows are only 4-byte aligned (the kernels' narrow copy path)
SHAPES = [(2, 12, 257, 257, 64), (2, 3, 197, 197, 36), (2, 3, 1, 257, 96),
          (1, 2, 300, 130, 128), (1, 2, 130, 300, 48), (1, 2, 65, 70, 33)]
FWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# bf16 o with 4096 keys or more: randn inputs give entries of about sqrt(e / Nkv) (0.015
# at 8192 keys), under FWD_TOL's 2e-2, so a wrong tile would pass it; 2e-3 is about four
# times the error measured at mae_long's encoder shape on an H100 (4.7e-4)
LONG_FWD_TOL, LONG_KEYS = 2e-3, 4096
# backward, relative to max |ref|: f32 sums in other orders (and dq's atomics
# in a run-dependent order); bf16 rounds the outputs
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _inputs(b, h, n_q, n_kv, dh, dt, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(b, h, n, dh, device="cuda", generator=g).to(dt)
                 for n in (n_q, n_kv, n_kv, n_q))


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_card(dtype):
    _card()
    dt = getattr(torch, dtype)
    for b, h, n_q, n_kv, dh in SHAPES:
        q, k, v, _ = _inputs(b, h, n_q, n_kv, dh, dt)
        before = flash_attention.launches
        out, lse = flash_attention(q, k, v, return_lse=True)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), dh**-0.5)
        assert (out.float() - ref).abs().max().item() <= FWD_TOL[dt]
        assert (lse - ref_lse).abs().max().item() <= 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_match_plain_on_card(dtype, route, rate):
    _card()
    dt = getattr(torch, dtype)
    seed, row0, col0 = 1234, 3, 5
    for b, h, n_q, n_kv, dh in SHAPES:
        q, k, v, do = _inputs(b, h, n_q, n_kv, dh, dt, seed=1)
        sm = dh**-0.5
        o, lse = flash_attention(q, k, v, return_lse=True, dropout_rate=rate, dropout_seed=seed,
                                 dropout_offset=(row0, col0))
        ref_o, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), sm, rate, seed,
                                               row0, col0)
        assert (o.float() - ref_o).abs().max().item() <= FWD_TOL[dt]
        assert (lse - ref_lse).abs().max().item() <= 5e-5
        before = dict(flash_attention_bwd.by_kernel)
        got = flash_attention_bwd(q, k, v, o, lse, do, sm, rate, seed, row0, col0, route=route)
        torch.cuda.synchronize()
        kernels = ["fused"] if route == "fused" else ["dkv", "dq"]
        assert all(flash_attention_bwd.by_kernel[n] == before[n] + 1 for n in kernels)
        want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                         do.float(), sm, rate, seed, row0, col0)
        for name, g, w in zip("qkv", got, want):
            assert g.dtype == dt and g.shape == w.shape
            assert _rel_err(g, w) <= BWD_TOL[dt], (name, (b, h, n_q, n_kv, dh))


@pytest.mark.cuda
def test_flash_bwd_rejects_bad_inputs_on_card():
    _card()
    q, k, v, do = _inputs(1, 2, 70, 90, 64, torch.float32)
    o, lse = flash_attention(q, k, v, return_lse=True)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse[:, :-1], do, 0.125)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bwd(q, k, v, o, lse, do[:, :, :-1], 0.125)
    with pytest.raises(ValueError, match="route"):
        flash_attention_bwd(q, k, v, o, lse, do, 0.125, route="tiled")
    assert flash_attention_bwd.launches == before


@pytest.mark.cuda
def test_keep_mask_counts_dropout_launches_on_card():
    _card()
    q, k, v, do = _inputs(1, 2, 70, 70, 64, torch.float32)
    before = keep_mask.launches
    flash_attention(q, k, v)
    assert keep_mask.launches == before
    o, lse = flash_attention(q, k, v, return_lse=True, dropout_rate=0.5, dropout_seed=7)
    flash_attention_bwd(q, k, v, o, lse, do, 0.125, 0.5, 7, route="split")
    assert keep_mask.launches == before + 3


@pytest.mark.cuda
def test_block_qkv_grad_flash_matches_einsum_on_card():
    """FLASH on a tensor that needs grad goes through FlashAttentionFn, whose
    backward is the kernel: the qkv weight gets the EINSUM gradient."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 65, 64, device="cuda", generator=g)
    grads = {}
    for impl in ("FLASH", "EINSUM"):
        torch.manual_seed(0)
        blk = Block(64, 4, attn_impl=impl, qkv_bias=True).cuda()
        before = flash_attention_bwd.launches
        blk(x).square().sum().backward()
        if impl == "FLASH":
            assert flash_attention_bwd.launches == before + 1
        grads[impl] = blk.attn.qkv.weight.grad
    assert grads["FLASH"] is not None and grads["FLASH"].abs().max().item() > 0
    assert _rel_err(grads["FLASH"], grads["EINSUM"]) <= 1e-4


# The bf16 tensor-core kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu) at what they
# must take: (b, h, n_q, n_kv, dh, packed). dh 64, 36 (8-byte rows copies), 96 and
# 128 (padded to 128) as views of one packed qkv; dh 36 with 16 heads (sap_bf16's
# decoder: the forward's tensor maps merge the heads into dim 0); Nq = 1; Nq 8448 x
# Nkv 640 (the MAE decoder's long queries); dh 33, whose rows are only 2-byte aligned
SM90_SHAPES = [(2, 4, 257, 257, 64, True), (2, 3, 197, 197, 36, True),
               (2, 2, 197, 197, 96, True), (1, 2, 197, 197, 128, True),
               (1, 16, 197, 197, 36, True), (4, 3, 1, 257, 64, False),
               (1, 2, 8448, 640, 96, False), (1, 2, 65, 33, 33, False)]


def _sm90_inputs(b, h, n_q, n_kv, dh, packed, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    do = torch.randn(b, n_q, h, dh, device="cuda", generator=g).to(torch.bfloat16)
    if packed:
        qkv = torch.randn(b, n_q, 3, h, dh, device="cuda", generator=g).to(torch.bfloat16)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    else:
        q, k, v = (torch.randn(b, h, n, dh, device="cuda", generator=g).to(torch.bfloat16)
                   for n in (n_q, n_kv, n_kv))
    return q, k, v, do.transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("route", ["fused", "split"])
def test_sm90_kernels_match_plain_on_card(route, rate):
    """The bf16 forward and backward (fused, or dkv + dq) against the f32
    plain versions from the same bf16 inputs, with dropout at a nonzero offset."""
    _card()
    seed, row0, col0 = 77, 3, 5
    for b, h, n_q, n_kv, dh, packed in SM90_SHAPES:
        q, k, v, do = _sm90_inputs(b, h, n_q, n_kv, dh, packed, seed=n_q + dh)
        sm = dh**-0.5
        reset_launch_counts()
        o, lse = flash_attention(q, k, v, return_lse=True, dropout_rate=rate, dropout_seed=seed,
                                 dropout_offset=(row0, col0))
        got = flash_attention_bwd(q, k, v, o, lse, do, sm, rate, seed, row0, col0, route=route)
        torch.cuda.synchronize()
        assert flash_attention.by_source == {"flash_fwd_tf32": 0, "flash_fwd_sm90": 1}
        assert flash_attention_bwd.by_source == {
            "flash_bwd_tf32": 0, "flash_bwd_sm90": 1 if route == "fused" else 2}
        ref_o, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), sm, rate, seed,
                                               row0, col0)
        shape = (b, h, n_q, n_kv, dh, packed)
        assert o.dtype == torch.bfloat16 and o.shape == q.shape
        assert (o.float() - ref_o).abs().max().item() <= FWD_TOL[torch.bfloat16], shape
        assert (lse - ref_lse).abs().max().item() <= 5e-5, shape
        want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                         do.float(), sm, rate, seed, row0, col0)
        for name, g, w in zip("qkv", got, want):
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            assert _rel_err(g, w) <= BWD_TOL[torch.bfloat16], (name, shape)


# The bf16 forward's route into its kernel by layout (`fwd_layout`): (b, h, n_q, n_kv,
# dh, packed, route). Packed views at dh 64 and at dh 36 with 16 heads load as they
# are; dh 36 with 3 heads (rows of 648 bytes) and contiguous dh 36 and 33 (rows of 72
# and 66 bytes) are first copied to rows of ceil8(dh)
ROUTE_CASES = [(2, 4, 257, 257, 64, True, "tma"), (1, 16, 197, 197, 36, True, "tma"),
               (2, 3, 197, 197, 36, True, "padded"), (4, 16, 197, 197, 36, False, "padded"),
               (1, 2, 65, 70, 33, False, "padded")]
# mae_long's encoder attention on one device, held against the plain version a head
# at a time
LONG_FWD = (2, 12, 8192, 8192, 64)


def _held_forward(q, k, v, heads=None, rel_tol=None, **drop):
    """o of the forward, its o and lse held against the f32 plain version: of
    the listed heads one at a time (at rate 0: a head's slice numbers its
    batch-heads from 0, so its dropout mask would differ), else of all. With
    `rel_tol`, o is held as max |o - plain| over max |plain|."""
    dh = q.shape[-1]
    o, lse = flash_attention(q, k, v, return_lse=True, **drop)
    torch.cuda.synchronize()
    b, h, n_q, _ = q.shape
    args = (drop.get("dropout_rate", 0.0), drop.get("dropout_seed") or 0,
            *drop.get("dropout_offset", (0, 0)))
    assert heads is None or args[0] == 0.0
    for hs in [slice(None)] if heads is None else [slice(i, i + 1) for i in heads]:
        ref_o, ref_lse = flash_attention_plain(q[:, hs].float(), k[:, hs].float(),
                                               v[:, hs].float(), dh**-0.5, *args)
        if rel_tol is not None:
            assert _rel_err(o[:, hs], ref_o) <= rel_tol
        else:
            tol = LONG_FWD_TOL if k.shape[2] >= LONG_KEYS else FWD_TOL[torch.bfloat16]
            assert (o[:, hs].float() - ref_o).abs().max().item() <= tol
        got_lse = lse.view(b, h, n_q)[:, hs].reshape(-1, n_q)
        assert (got_lse - ref_lse).abs().max().item() <= 5e-5
    return o


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: "x".join(map(str, c[:5])) + c[6])
def test_sm90_forward_routes_on_card(case):
    """Each layout takes the route `fwd_layout` gives it, counted in
    `flash_attention.by_layout`, and either route agrees with the plain version,
    also with dropout at a nonzero (row0, col0)."""
    _card()
    b, h, n_q, n_kv, dh, packed, route = case
    q, k, v, _ = _sm90_inputs(b, h, n_q, n_kv, dh, packed, seed=dh)
    assert fwd_layout(q, k, v, _tokens_major(b, n_q, h, dh, q.dtype, q.device))[0] == route
    for drop in ({}, {"dropout_rate": 0.1, "dropout_seed": 9, "dropout_offset": (3, 5)}):
        reset_launch_counts()
        _held_forward(q, k, v, **drop)
        assert flash_attention.by_layout == {"tma": route == "tma", "padded": route == "padded"}
        assert flash_attention.by_source == {"flash_fwd_tf32": 0, "flash_fwd_sm90": 1}


@pytest.mark.cuda
def test_sm90_forward_takes_offset_bases_by_copy_on_card():
    """A base 8 bytes past a 16-byte boundary is no TMA address: that tensor is
    copied, the others load as they are, and o is the same."""
    _card()
    q, k, v, _ = _sm90_inputs(2, 4, 130, 130, 64, False, seed=5)
    wide = torch.zeros(2, 4, 130, 72, device="cuda", dtype=torch.bfloat16)
    wide[..., 4:68] = k
    shifted = wide[..., 4:68]
    assert shifted.data_ptr() % 16 == 8
    reset_launch_counts()
    o = _held_forward(q, shifted, v)
    assert flash_attention.by_layout == {"tma": 0, "padded": 1}
    assert torch.equal(o, flash_attention(q, k, v))
    assert flash_attention.by_layout == {"tma": 1, "padded": 1}


@pytest.mark.cuda
def test_sm90_forward_matches_plain_at_card_shapes_and_long_on_card():
    """The bf16 forward at every card shape (contiguous inputs: each on the route
    its layout gives) and at mae_long's encoder shape (packed, on the TMA
    route; the first and last heads held against the plain version)."""
    _card()
    for b, h, n_q, n_kv, dh in SHAPES:
        q, k, v, _ = _inputs(b, h, n_q, n_kv, dh, torch.bfloat16, seed=3)
        route = fwd_layout(q, k, v, _tokens_major(b, n_q, h, dh, q.dtype, q.device))[0]
        reset_launch_counts()
        _held_forward(q, k, v)
        assert flash_attention.by_layout[route] == 1, (b, h, n_q, n_kv, dh)
    b, h, n, _, dh = LONG_FWD
    q, k, v, _ = _sm90_inputs(b, h, n, n, dh, True, seed=11)
    reset_launch_counts()
    _held_forward(q, k, v, heads=[0, h - 1])
    assert flash_attention.by_layout == {"tma": 1, "padded": 0}


# mae_long's attention: the decoder's packed views at dh 96 (a 192-byte head stride; the
# DH = 128 instance must take columns 96-127 from TMA's zero fill, never from the next
# head) and, for the fused backward, one head at each of its two shapes
MAE_DEC_FWD = (1, 6, 32768, 32768, 96)
MAE_BWD = [(1, 1, 32768, 32768, 96), (1, 1, 8192, 8192, 64)]
# the fused backward at MAE_BWD, max |d - plain| over max |plain|: chip_smoke.py's
# LONG_BWD_TOL, about three times the largest reading on an H100 at mae_long's shapes
# (3.6e-3; BWD_TOL's 2e-2 was set at 257 keys)
MAE_BWD_TOL = 1e-2
# the forward at MAE_DEC_FWD, max |o - plain| over max |plain|: chip_smoke.py's
# MAE_DEC_FWD_TOL, about four times its reading on an H100 (2.6e-3)
MAE_DEC_FWD_TOL = 1e-2


@pytest.mark.cuda
def test_sm90_forward_at_mae_decoder_packed_on_card():
    """The bf16 forward on the decoder's packed dh-96 view at 32768^2: on the
    TMA route, the first and last heads held to MAE_DEC_FWD_TOL."""
    _card()
    b, h, n, _, dh = MAE_DEC_FWD
    q, k, v, _ = _sm90_inputs(b, h, n, n, dh, True, seed=13)
    assert q.stride(1) == dh  # the heads lie 192 bytes apart
    reset_launch_counts()
    _held_forward(q, k, v, heads=[0, h - 1], rel_tol=MAE_DEC_FWD_TOL)
    assert flash_attention.by_layout == {"tma": 1, "padded": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MAE_BWD, ids=lambda s: f"{s[2]}x{s[4]}")
def test_sm90_fused_bwd_at_mae_shapes_on_card(shape):
    """The bf16 fused backward at mae_long's long shapes (512 and 128 key
    tiles of dq atomics per query tile) against the plain backward."""
    _card()
    b, h, n_q, n_kv, dh = shape
    q, k, v, do = _sm90_inputs(b, h, n_q, n_kv, dh, True, seed=dh)
    sm = dh**-0.5
    o, lse = flash_attention(q, k, v, return_lse=True)
    reset_launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, sm, route="fused")
    torch.cuda.synchronize()
    assert flash_attention_bwd.by_source == {"flash_bwd_tf32": 0, "flash_bwd_sm90": 1}
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), sm)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rel_err(g, w) <= MAE_BWD_TOL, name


def _launch_sources(dt, route):
    """One forward and one backward of `route` on the card from zeroed counts:
    (forward launches by source, backward launches by source, by kernel)."""
    q, k, v, do = _inputs(1, 2, 70, 70, 64, dt)
    reset_launch_counts()
    o, lse = flash_attention(q, k, v, return_lse=True)
    flash_attention_bwd(q, k, v, o, lse, do, 0.125, route=route)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    assert flash_attention_bwd.launches == (1 if route == "fused" else 2)
    return (dict(flash_attention.by_source), dict(flash_attention_bwd.by_source),
            dict(flash_attention_bwd.by_kernel))


@pytest.mark.cuda
def test_bf16_launches_go_to_sm90_kernels_on_card():
    """bf16 counts under the wgmma sources; the totals and the split by kernel
    keep their meaning."""
    _card()
    fwd, bwd, kernels = _launch_sources(torch.bfloat16, "fused")
    assert fwd == {"flash_fwd_tf32": 0, "flash_fwd_sm90": 1}
    assert bwd == {"flash_bwd_tf32": 0, "flash_bwd_sm90": 1}
    assert kernels == {"fused": 1, "dkv": 0, "dq": 0}
    fwd, bwd, kernels = _launch_sources(torch.bfloat16, "split")
    assert fwd == {"flash_fwd_tf32": 0, "flash_fwd_sm90": 1}
    assert bwd == {"flash_bwd_tf32": 0, "flash_bwd_sm90": 2}
    assert kernels == {"fused": 0, "dkv": 1, "dq": 1}


@pytest.mark.cuda
def test_f32_launches_go_to_tf32_kernels_on_card():
    """f32 counts under the 3xTF32 sources: the forward and both backward
    routes (fused; dkv and dq)."""
    _card()
    fwd, bwd, kernels = _launch_sources(torch.float32, "fused")
    assert fwd == {"flash_fwd_tf32": 1, "flash_fwd_sm90": 0}
    assert bwd == {"flash_bwd_tf32": 1, "flash_bwd_sm90": 0}
    assert kernels == {"fused": 1, "dkv": 0, "dq": 0}
    fwd, bwd, kernels = _launch_sources(torch.float32, "split")
    assert fwd == {"flash_fwd_tf32": 1, "flash_fwd_sm90": 0}
    assert bwd == {"flash_bwd_tf32": 2, "flash_bwd_sm90": 0}
    assert kernels == {"fused": 0, "dkv": 1, "dq": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_route_is_deterministic_on_card(dtype, rate):
    """The split route adds nothing by atomics: two calls give the same dq, dk
    and dv bit for bit (packed views, several query and key tiles, a ragged
    last tile of each)."""
    _card()
    b, h, n, dh = 2, 3, 300, 64
    q, k, v, do = _sm90_inputs(b, h, n, n, dh, True, seed=21)
    q, k, v, do = (t.to(getattr(torch, dtype)) for t in (q, k, v, do))
    drop = (rate, 5, 3, 5)  # rate, seed, row0, col0
    o, lse = flash_attention(q, k, v, return_lse=True, dropout_rate=rate, dropout_seed=5,
                             dropout_offset=(3, 5))
    first = flash_attention_bwd(q, k, v, o, lse, do, dh**-0.5, *drop, route="split")
    second = flash_attention_bwd(q, k, v, o, lse, do, dh**-0.5, *drop, route="split")
    torch.cuda.synchronize()
    for name, a, c in zip("qkv", first, second):
        assert torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_key_on_card(dtype, route):
    """Nkv = 1: each row's softmax is 1 on its one key, so o = v and dv is the
    sum of do over the rows, while dq and dk are 0 but for rounding. They are
    held in absolute terms: relative to their own size both sides are noise."""
    _card()
    dt = getattr(torch, dtype)
    for dh in (36, 64, 128):
        q, k, v, do = _inputs(1, 2, 65, 1, dh, dt, seed=dh)
        o, lse = flash_attention(q, k, v, return_lse=True)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, dh**-0.5, route=route)
        torch.cuda.synchronize()
        assert (o.float() - v.float()).abs().max().item() <= FWD_TOL[dt], dh
        assert _rel_err(dv, do.float().sum(2, keepdim=True)) <= BWD_TOL[dt], dh
        assert dq.float().abs().max().item() <= 1e-3 and dk.float().abs().max().item() <= 1e-3


# (leading dims, D, H, offset): the JAX tests' ragged shape and leading dims, ViT-B and
# ViT-L widths with a ragged M, a D and H that are multiples of nothing, M below one
# 64-row tile, a small M whose bf16 plan splits H 22 ways, and an x that is a view one
# element into its storage (a base TMA cannot address: the padded route). For the f32
# plan: ViT-L's width at M = 514 (clusters of three, S = 4), a D that is no multiple of
# 4 with an odd H (4-byte weight copies, scalar stores; S = 8), ViT-B's width at M = 515
# (S = 7), and D = 1024 with the offset-1 x
MLP_SHAPES = [((300,), 128, 512, 0), ((2, 70), 128, 512, 0), ((515,), 768, 3072, 0),
              ((2, 257), 1024, 4096, 0), ((100,), 200, 300, 0), ((50,), 768, 3072, 0),
              ((130,), 1024, 4096, 0), ((300,), 768, 3072, 1), ((514,), 1024, 4096, 0),
              ((300,), 201, 509, 0), ((130,), 1024, 4096, 1)]
MLP_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _mlp_inputs(lead, d, h, dt, seed=0, offset=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, std=1.0):
        return (std * torch.randn(*shape, device="cuda", generator=g)).to(dt)

    x = randn(*lead, d)
    if offset:  # the same values in a view `offset` elements into a larger storage
        x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
    return (x, randn(d, h, std=0.02), randn(h, std=0.01), randn(h, d, std=0.02),
            randn(d, std=0.01))


@pytest.mark.cuda
@pytest.mark.parametrize("approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_kernel_matches_plain_on_card(dtype, approx):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for lead, d, h, offset in MLP_SHAPES:
        args = _mlp_inputs(lead, d, h, dt, offset=offset)
        reset_mlp_counts()
        got = fused_mlp(*args, approx=approx)
        torch.cuda.synchronize()
        # bf16 by wgmma (fused_mlp_sm90.cu) on its plan's route; f32 by 3xTF32 on
        # fused_mlp_tf32.cu, which has no route (every shape and alignment as it is)
        source = "fused_mlp_sm90" if dt == torch.bfloat16 else "fused_mlp_tf32"
        route = mlp_plan(args[0].numel() // d, d, h, sms, offset == 0).route
        assert fused_mlp.launches == 1
        assert fused_mlp.by_source == {s: int(s == source) for s in fused_mlp.by_source}
        assert fused_mlp.by_layout == {
            r: int(r == route and dt == torch.bfloat16) for r in fused_mlp.by_layout}
        want = fused_mlp_plain(*args, approx=approx)
        assert got.dtype == dt and got.shape == args[0].shape
        assert (got.float() - want.float()).abs().max().item() <= MLP_TOL[dt], (lead, d, h)


# (M, K, N): the JAX tests' shape with a ragged M, the qkv and fc2 projections of
# ViT-B with a ragged M, a K that is no multiple of 4 with N = 132 (no multiple of 16 or
# 256: 4-byte weight loads, and bf16 rows of y that TMA cannot store), one row, ViT-B's fc1
# at batch 16 (396 tiles: three waves of the persistent grid), its proj (99 tiles) and
# fc2's K = 3072 at M = 4112, and K = 6144 (48 K slices) with an N of the same kind over
# two column tiles
INT8_SHAPES = [(50, 256, 256), (300, 768, 2304), (130, 3072, 768), (33, 250, 132),
               (1, 768, 2304), (4112, 768, 3072), (4112, 768, 768), (4112, 3072, 768),
               (200, 6144, 260)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_kernel_equals_plain_on_card(dtype, out_dtype):
    """Integer accumulation is exact and every float step is one IEEE
    operation in both versions, so the two agree bit for bit."""
    _card()
    dt, odt = getattr(torch, dtype), getattr(torch, out_dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    for m, k, n in INT8_SHAPES:
        x = torch.randn(m, k, device="cuda", generator=g).to(dt)
        w_i8, ws = quantize_weight(0.02 * torch.randn(k, n, device="cuda", generator=g))
        before = int8_matmul.launches
        got = int8_matmul(x, w_i8, ws, out_dtype=odt)
        torch.cuda.synchronize()
        assert int8_matmul.launches == before + 1
        want = int8_matmul_plain(x, w_i8, ws, odt)
        assert got.dtype == odt and got.shape == (m, n)
        assert torch.equal(got, want), ((m, k, n), (got.float() - want.float()).abs().max())
        # every row is quantized alone: the first 33 rows do not depend on M
        assert torch.equal(int8_matmul(x[:33], w_i8, ws, out_dtype=odt), got[:33])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantization_equals_plain_on_card(dtype):
    """The quantization alone (`int8_prepare` without weights): xq's first K columns and
    the scales equal `quantize_rows_plain`'s bit for bit (round half to even of the IEEE
    quotient on both sides), xq is zero past K, and a zero row gives zeros at 1e-8 / 127;
    rows of 16-byte loads (K = 768, 3072) and of element loads (K = 250, 6143), one warp
    a row and several, held in registers between the max and the quantization (every K
    in bf16, K <= 4096 in f32) and read again (f32 at K = 6143)."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(5)
    for m, k in [(1, 768), (33, 250), (4112, 768), (130, 3072), (7, 6143)]:
        x = torch.randn(m, k, device="cuda", generator=g).to(getattr(torch, dtype))
        x[m // 2] = 0
        before = quantize_rows.launches
        xq, scale = quantize_rows(x)
        torch.cuda.synchronize()
        assert quantize_rows.launches == before + 1
        want_q, want_scale = quantize_rows_plain(x)
        kp = -(-k // 128) * 128
        assert xq.shape == (m, kp) and xq.dtype == torch.int8 and scale.shape == (m,)
        assert torch.equal(xq[:, :k], want_q), (m, k)
        assert not xq[:, k:].any() and not xq[m // 2].any()
        assert torch.equal(scale, want_scale), (m, k)


@pytest.mark.cuda
def test_ops_raise_outside_their_limits_on_card():
    """A CUDA tensor outside a kernel's limits raises; the plain version is
    never taken for it."""
    _card()
    before = fused_mlp.launches, int8_matmul.launches
    with pytest.raises(ValueError, match="D <= 1024"):
        fused_mlp(*_mlp_inputs((8,), 1152, 256, torch.float32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_mlp(*_mlp_inputs((8,), 64, 256, torch.float16))
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mlp(*(t.requires_grad_() for t in _mlp_inputs((8,), 64, 256, torch.float32)))
    x = torch.randn(8, 64, device="cuda")
    w_i8, ws = quantize_weight(torch.randn(64, 30, device="cuda"))
    with pytest.raises(ValueError, match="multiple of 4"):
        int8_matmul(x, w_i8, ws)
    w_i8, ws = quantize_weight(torch.randn(8192, 32, device="cuda"))
    with pytest.raises(ValueError, match="K <= 6144"):
        int8_matmul(torch.randn(8, 8192, device="cuda"), w_i8, ws)
    assert (fused_mlp.launches, int8_matmul.launches) == before


# ---------------------------------------------------------------- from disk, checkpoints


def _mae_disk_config(tmp_path, epochs, resume=False):
    """A tiny bf16 MAE (remat, FLASH) reading two NIfTI volumes of 32 x 16 x 16 from
    `tmp_path`: two 16^3 tiles each, two batches of 2 an epoch."""
    import numpy as np

    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.data import nifti

    root = tmp_path / "ct"
    if not root.exists():
        (root / "imagesTr").mkdir(parents=True)
        rng = np.random.default_rng(0)
        for i in range(2):
            nifti.save(str(root / "imagesTr" / f"image{i}.nii"),
                       (rng.normal(size=(32, 16, 16)) * 300).astype(np.int16))
    ia = {"default_vars": ["ct"], "tile_size": [16, 16, 16], "patch_size": 4, "twoD": False,
          "embed_dim": 48, "depth": 1, "num_heads": 2, "decoder_embed_dim": 36,
          "decoder_depth": 1, "decoder_num_heads": 3, "mlp_ratio": 2, "mask_ratio": 0.75,
          "adaptive_patching": False}
    raw = {"trainer": {"task": "mae", "data_type": "bfloat16", "remat": True,
                       "attn_impl": "FLASH", "max_epochs": epochs,
                       "checkpoint_path": str(tmp_path / "ck"), "checkpoint_filename": "last",
                       "checkpoint_filename_for_loading": "last_latest",
                       "resume_from_checkpoint": resume},
           "parallelism": {},
           "model": {"lr": 1e-3, "warmup_steps": 0, "loss_fn": "maskMSE",
                     "net": {"init_args": ia}},
           "data": {"dataset": "basic_ct", "dict_root_dirs": {"ct": str(root)},
                    "dict_start_idx": {"ct": 0}, "dict_end_idx": {"ct": 1},
                    "dict_buffer_sizes": {"ct": 4}, "num_channels_used": {"ct": 1},
                    "dict_in_variables": {"ct": ["ct"]}, "batch_size": 2,
                    "single_channel": True, "tile_overlap": 0.0, "use_all_data": False},
           "load_balancing": {"auto_load_balancing": True}}
    return Config(raw=raw, task="mae")


@pytest.mark.cuda
def test_train_from_disk_save_and_resume_on_card(tmp_path):
    """A tiny bf16 MAE from NIfTI files on the card: the sm90 kernels run every step,
    both checkpoint slots are written, and a run resumed from the odd slot continues
    the loss list and trains on."""
    _card()
    from ucf_vit_tpu_torch.checkpoint import resolve_slot, stored_epoch
    from ucf_vit_tpu_torch.train import train

    reset_launch_counts()
    out = train(_mae_disk_config(tmp_path, 2), device="cuda")
    steps = 4  # 2 epochs of 2 batches
    assert flash_attention.by_source["flash_fwd_sm90"] == 2 * 2 * steps  # remat: twice a block
    assert flash_attention_bwd.by_source["flash_bwd_sm90"] == 2 * steps
    assert len(out["loss_list"]) == 2 and all(torch.isfinite(torch.tensor(out["loss_list"])))
    ck = str(tmp_path / "ck")
    latest = resolve_slot(ck, "last_latest")
    assert latest.endswith("last_odd.ckpt") and stored_epoch(latest) == 1
    resumed = train(_mae_disk_config(tmp_path, 3, resume=True), device="cuda")
    assert resumed["loss_list"][:2] == out["loss_list"] and len(resumed["loss_list"]) == 3
    assert stored_epoch(resolve_slot(ck, "last_latest")) == 2
    assert resumed["state"].optimizer.count == 6


@pytest.mark.cuda
def test_serve_from_checkpoint_on_card(tmp_path):
    """A tiny f32 ViT trained on the card for two epochs; the server started on the
    checkpoint answers as the direct EINSUM forward on those weights, and /v1/reload
    to the other slot changes the answers to that slot's."""
    _card()
    import copy
    import io
    import json
    import threading
    import urllib.request

    import numpy as np

    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.inference import init_eval_model, load_weights
    from ucf_vit_tpu_torch.serve import make_server
    from ucf_vit_tpu_torch.train import train

    ia = {"default_vars": ["v"], "tile_size": [32, 32], "patch_size": 8, "embed_dim": 64,
          "depth": 2, "num_heads": 2, "mlp_ratio": 2, "twoD": True, "adaptive_patching": False,
          "num_classes": 3}
    raw = {"trainer": {"task": "classification", "attn_impl": "FLASH", "max_epochs": 2,
                       "checkpoint_path": str(tmp_path / "ck"), "checkpoint_filename": "last",
                       "checkpoint_filename_for_loading": "last_odd"},
           "parallelism": {}, "model": {"lr": 1e-3, "warmup_steps": 0, "net": {"init_args": ia}},
           "data": {"batch_size": 4, "num_classes": 3, "single_channel": True},
           "load_balancing": {"batches_per_rank_epoch": {"d": 3}}}
    cfg = Config(raw=raw, task="classification")
    train(cfg, synthetic=True, device="cuda")
    einsum = copy.deepcopy(raw)
    einsum["trainer"]["attn_impl"] = "EINSUM"
    oracle = init_eval_model(Config(raw=einsum, task="classification"), device="cuda")
    x = np.random.default_rng(1).normal(size=(1, 32, 32)).astype(np.float32)

    def want(path):
        load_weights(oracle, cfg, path)
        with torch.no_grad():
            return oracle(torch.from_numpy(np.stack([x] * 4)).cuda())[0].cpu().numpy()

    def post(url, body):
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    server = make_server(cfg, str(tmp_path / "ck"), host="127.0.0.1", port=0, max_batch=4,
                         max_wait_ms=1.0, device="cuda")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    buf = io.BytesIO()
    np.save(buf, x)
    try:
        odd = np.load(io.BytesIO(post(f"{base}/v1/predict", buf.getvalue())))
        even_path = str(tmp_path / "ck" / "last_even.ckpt")
        assert json.loads(post(f"{base}/v1/reload", json.dumps(
            {"checkpoint": even_path}).encode()))["epoch"] == 0
        even = np.load(io.BytesIO(post(f"{base}/v1/predict", buf.getvalue())))
    finally:
        server.shutdown()
        server.server_close()
        server.RequestHandlerClass.batcher.close()
    w_odd, w_even = want(str(tmp_path / "ck")), want(even_path)
    np.testing.assert_allclose(odd, w_odd, atol=1e-4, rtol=0)
    np.testing.assert_allclose(even, w_even, atol=1e-4, rtol=0)
    assert np.abs(w_odd - w_even).max() > 1e-3


# The f32 paths of adaptive patching (b, h, n_q, n_kv, dh): basic_ct/mae's encoder on 49
# kept tokens (one partial tile on both axes), imagenet/classification's 196 patches and
# the class token, imagenet/mae's decoder (the DH = 128 instance) and basic_ct/mae's
# (dh 96)
ADAPTIVE_SHAPES = [(4, 12, 49, 49, 64), (4, 12, 197, 197, 64), (4, 4, 196, 196, 128),
                   (4, 6, 196, 196, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "split"])
def test_f32_kernels_at_the_adaptive_shapes_on_card(route):
    _card()
    for b, h, n_q, n_kv, dh in ADAPTIVE_SHAPES:
        q, k, v, do = _inputs(b, h, n_q, n_kv, dh, torch.float32, seed=3)
        sm = dh**-0.5
        reset_launch_counts()
        o, lse = flash_attention(q, k, v, return_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, sm, route=route)
        torch.cuda.synchronize()
        assert flash_attention.by_instance[f"flash_fwd_tf32<{dh}>"] == 1
        assert flash_attention_bwd.by_instance[f"flash_bwd_tf32<{dh}>"] == (
            1 if route == "fused" else 2)
        ref_o, ref_lse = flash_attention_plain(q, k, v, sm)
        assert (o - ref_o).abs().max().item() <= FWD_TOL[torch.float32], (b, h, n_q, dh)
        assert (lse - ref_lse).abs().max().item() <= 5e-5
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, sm)
        for name, g, w in zip("qkv", got, want):
            assert _rel_err(g, w) <= BWD_TOL[torch.float32], (name, (b, h, n_q, dh), route)


@pytest.mark.cuda
def test_adaptive_vit_step_launches_on_card():
    """One train step of a depth-2 adaptive ViT (196 patches, the class token,
    dh 64) launches the f32 forward and the fused backward `<64>` twice each."""
    _card()
    import numpy as np

    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.train import init_train, synthetic_batches, to_device

    ia = {"default_vars": ["r", "g", "b"], "tile_size": [256, 256], "patch_size": 16,
          "embed_dim": 128, "depth": 2, "num_heads": 2, "mlp_ratio": 2, "twoD": True,
          "adaptive_patching": True, "fixed_length": 196, "use_adaptive_pos_emb": True}
    raw = {"trainer": {"task": "classification", "attn_impl": "FLASH"}, "parallelism": {},
           "model": {"lr": 1e-3, "net": {"init_args": ia}},
           "data": {"batch_size": 2, "num_classes": 4}}
    cfg = Config(raw=raw, task="classification")
    state, step = init_train(cfg, device="cuda")
    batch = to_device(next(synthetic_batches(cfg, 2)), torch.device("cuda"))
    reset_launch_counts()
    state, loss, _ = step(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(loss.item())
    assert {k: v for k, v in flash_attention.by_instance.items() if v} == {
        "flash_fwd_tf32<64>": 2}
    assert {k: v for k, v in flash_attention_bwd.by_instance.items() if v} == {
        "flash_bwd_tf32<64>": 2}


# basic_ct/unetr's attention: batch 8 x 12 heads over 729 octree tokens (12 query tiles,
# the last holding 25 rows), dh 64; the path takes the fused route (729 f32 queries)
UNETR_SHAPE = (8, 12, 729, 729, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "split"])
def test_f32_kernels_at_the_unetr_shape_on_card(route):
    _card()
    b, h, n_q, n_kv, dh = UNETR_SHAPE
    q, k, v, do = _inputs(b, h, n_q, n_kv, dh, torch.float32, seed=5)
    sm = dh**-0.5
    reset_launch_counts()
    o, lse = flash_attention(q, k, v, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, sm, route=route)
    torch.cuda.synchronize()
    assert flash_attention.by_instance["flash_fwd_tf32<64>"] == 1
    assert flash_attention_bwd.by_instance["flash_bwd_tf32<64>"] == (1 if route == "fused" else 2)
    ref_o, ref_lse = flash_attention_plain(q, k, v, sm)
    assert (o - ref_o).abs().max().item() <= FWD_TOL[torch.float32]
    assert (lse - ref_lse).abs().max().item() <= 5e-5
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, sm)
    for name, g, w in zip("qkv", got, want):
        assert _rel_err(g, w) <= BWD_TOL[torch.float32], (name, route)


@pytest.mark.cuda
def test_unetr_step_launches_on_card():
    """One f32 train step of a depth-4 adaptive 3-D UNETR with remat (729 octree
    tokens at patch 4, reassembled into 36^3; a 32^3 tile, so the decoder resizes)
    launches the forward `<64>` twice a block (remat runs it again) and the fused
    backward once a block, and the f32 policy holds on the card."""
    _card()
    import numpy as np

    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.train import init_train, synthetic_batches, to_device

    ia = {"default_vars": ["ct"], "tile_size": [32, 32, 32], "patch_size": 4, "embed_dim": 192,
          "depth": 4, "num_heads": 3, "mlp_ratio": 2, "twoD": False, "adaptive_patching": True,
          "fixed_length": 729, "use_adaptive_pos_emb": True, "feature_size": 4}
    raw = {"trainer": {"task": "unetr", "attn_impl": "FLASH", "remat": True}, "parallelism": {},
           "model": {"lr": 1e-3, "net": {"init_args": ia}},
           "data": {"batch_size": 2, "num_classes": 4}}
    cfg = Config(raw=raw, task="unetr")
    state, step = init_train(cfg, device="cuda")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    batch = to_device(next(synthetic_batches(cfg, 2)), torch.device("cuda"))
    reset_launch_counts()
    state, loss, _ = step(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(loss.item())
    assert {k: v for k, v in flash_attention.by_instance.items() if v} == {
        "flash_fwd_tf32<64>": 8}
    assert {k: v for k, v in flash_attention_bwd.by_instance.items() if v} == {
        "flash_bwd_tf32<64>": 4}


# SAP's attention: basic_ct/sap at batch 2 and sap_bf16 at batch 16, 12 heads over the
# 512 tokens of the reassembled 8^3 grid, dh 64; both paths take the fused route
SAP_SHAPES = {"float32": (2, 12, 512, 512, 64), "bfloat16": (16, 12, 512, 512, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_at_the_sap_shapes_on_card(dtype, route):
    _card()
    dt = getattr(torch, dtype)
    b, h, n_q, n_kv, dh = SAP_SHAPES[dtype]
    q, k, v, do = _inputs(b, h, n_q, n_kv, dh, dt, seed=6)
    sm = dh**-0.5
    src = "tf32" if dtype == "float32" else "sm90"
    reset_launch_counts()
    o, lse = flash_attention(q, k, v, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, sm, route=route)
    torch.cuda.synchronize()
    assert flash_attention.by_instance[f"flash_fwd_{src}<64>"] == 1
    ref_o, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), sm)
    assert (o.float() - ref_o).abs().max().item() <= FWD_TOL[dt]
    assert (lse - ref_lse).abs().max().item() <= 5e-5
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), sm)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dt and _rel_err(g, w) <= BWD_TOL[dt], (name, route)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sap", "sap_bf16"])
def test_sap_step_launches_on_card(name):
    """One train step of a depth-2 SAP at full token count (512 octree tokens of 4^3
    reassembled into 32^3, a 64^3 tile) in f32 and in bf16: each block launches the
    forward and the fused backward of its dtype's source once, the neck and the head
    compute in f32, and the loss is finite."""
    _card()
    import numpy as np

    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.train import init_train, synthetic_batches, to_device

    ia = {"default_vars": ["ct"], "tile_size": [64, 64, 64], "patch_size": 4, "embed_dim": 192,
          "depth": 2, "num_heads": 3, "mlp_ratio": 2, "twoD": False, "adaptive_patching": True,
          "fixed_length": 512, "use_adaptive_pos_emb": True}
    raw = {"trainer": {"task": "sap", "attn_impl": "FLASH",
                       "data_type": "bfloat16" if name == "sap_bf16" else "float32"},
           "parallelism": {}, "model": {"lr": 1e-3, "net": {"init_args": ia}},
           "data": {"batch_size": 2, "num_classes": 4, "single_channel": True}}
    cfg = Config(raw=raw, task="sap")
    state, step = init_train(cfg, device="cuda")
    batch = to_device(next(synthetic_batches(cfg, 2)), torch.device("cuda"))
    reset_launch_counts()
    state, loss, _ = step(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(loss.item())
    src = "sm90" if name == "sap_bf16" else "tf32"
    assert {k: v for k, v in flash_attention.by_instance.items() if v} == {
        f"flash_fwd_{src}<64>": 2}
    assert {k: v for k, v in flash_attention_bwd.by_instance.items() if v} == {
        f"flash_bwd_{src}<64>": 2}
    assert state.model.neck[0].weight.grad.dtype == torch.float32


@pytest.mark.cuda
def test_varemb_vit_step_launches_on_card():
    """One f32 train step of a depth-2 ViT with the variable embedding (three
    variables merged by EINSUM attention, one query over three keys): the blocks
    launch the flash kernels, the merge none."""
    _card()
    import numpy as np

    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.train import init_train, synthetic_batches, to_device

    ia = {"default_vars": ["red", "green", "blue"], "tile_size": [64, 64], "patch_size": 16,
          "embed_dim": 192, "depth": 2, "num_heads": 3, "mlp_ratio": 2, "twoD": True,
          "adaptive_patching": False, "use_varemb": True}
    raw = {"trainer": {"task": "classification", "attn_impl": "FLASH"}, "parallelism": {},
           "model": {"lr": 1e-3, "net": {"init_args": ia}},
           "data": {"batch_size": 4, "num_classes": 4, "num_channels_used": {"d": 3}}}
    cfg = Config(raw=raw, task="classification")
    state, step = init_train(cfg, device="cuda")
    batch = to_device(next(synthetic_batches(cfg, 4)), torch.device("cuda"))
    reset_launch_counts()
    state, loss, _ = step(state, batch, (0, 1, 2))
    torch.cuda.synchronize()
    assert np.isfinite(loss.item())
    assert flash_attention.launches == 2 and flash_attention_bwd.launches == 2
    assert state.model.var_agg.kv.weight.grad is not None


# ---------------------------------------------------------------- tensor parallel on the card

TP_LOSS_TOL = 1e-4  # f32 (3xTF32 kernels, TF32 off elsewhere) on both sides: each step's loss
TP_STEPS = 3


def _tp_raw(tp: int) -> dict:
    ia = {"default_vars": ["red", "green", "blue"], "tile_size": [32, 32], "patch_size": 8,
          "embed_dim": 256, "depth": 2, "num_heads": 4, "mlp_ratio": 2, "twoD": True,
          "adaptive_patching": False}
    return {"trainer": {"task": "classification", "attn_impl": "FLASH", "seed": 0},
            "parallelism": {"tensor_par_size": tp},
            "model": {"lr": 1e-3, "warmup_steps": 1, "max_steps": 10, "net": {"init_args": ia}},
            "data": {"batch_size": 4, "num_classes": 4, "num_channels_used": {"d": 3}}}


def _tp_steps(raw: dict) -> dict:
    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.parallel.mesh import shard_batch
    from ucf_vit_tpu_torch.train import init_train, synthetic_batches, to_device

    cfg = Config(raw=raw, task="classification")
    state, step = init_train(cfg, "cuda")
    reset_launch_counts()
    losses = []
    for _, b in zip(range(TP_STEPS), synthetic_batches(cfg, 4)):
        state, loss, _ = step(state, to_device(shard_batch(b, state.mesh), torch.device("cuda")))
        losses.append(loss.item())
    return {"losses": losses, "src": {**flash_attention.by_source,
                                      **flash_attention_bwd.by_source},
            "heads": state.model.blocks[0].attn.qkv.weight.shape[0] // (3 * 64)}


def _tp_rank(rank: int, store: str, queue) -> None:
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    try:
        queue.put((rank, _tp_steps(_tp_raw(2))))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_tensor_parallel_step_on_two_ranks_matches_one_device_on_card(tmp_path):
    """Two ranks sharing the card over gloo (NCCL refuses two ranks on one device),
    tp 2: each rank runs the tf32 flash kernels on its 2 of the 4 heads, and every
    step's loss equals the single-device step's within TP_LOSS_TOL."""
    _card()
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_tp_rank, args=(r, str(tmp_path / "store"), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        ranks = dict(queue.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    one = _tp_steps(_tp_raw(1))
    assert one["heads"] == 4
    for r in range(2):
        assert ranks[r]["heads"] == 2
        assert ranks[r]["src"]["flash_fwd_tf32"] == 2 * TP_STEPS  # 2 blocks a step
        assert ranks[r]["src"]["flash_bwd_tf32"] == 2 * TP_STEPS
        assert max(abs(a - b) for a, b in zip(ranks[r]["losses"], one["losses"])) <= TP_LOSS_TOL
