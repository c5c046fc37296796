"""The port's CUDA flash-attention kernels (forward, both backward routes,
dropout) against their plain versions, on the card. Marked `cuda`; skips
without a card. This file imports neither JAX nor the JAX package, so it runs
on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_flash_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from ucf_vit_tpu_torch.models.blocks import Block
from ucf_vit_tpu_torch.ops.attn_dropout import keep_mask
from ucf_vit_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

# (b, h, n_q, n_kv, dh): the training shape at batch 2, dh 36, Nq = 1, a
# trailing partial key tile with Nq > Nkv, dh 128 with Nq < Nkv
SHAPES = [(2, 12, 257, 257, 64), (2, 3, 197, 197, 36), (2, 3, 1, 257, 96),
          (1, 2, 300, 130, 128), (1, 2, 130, 300, 48)]
FWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
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
