"""The port's attention-dropout hash, its flash forward with dropout and the
gradients of `FlashAttentionFn` against the JAX package, on the CPU at small
sizes: the hash bit for bit, the forward and the gradients against the
Pallas kernels in interpret mode. Inputs come from numpy seeds.

The CUDA kernels run only on the card: see tests/test_torch_flash_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ucf_vit_tpu.ops import attn_dropout as jax_dropout
from ucf_vit_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ucf_vit_tpu_torch.models.blocks import Block, Dropout, DropPath
from ucf_vit_tpu_torch.ops import attn_dropout
from ucf_vit_tpu_torch.ops.attention import einsum_attention, multi_head_attention
from ucf_vit_tpu_torch.ops.flash_attention import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

TOL = 1e-5  # f32: the same products summed in another order
# bf16, relative to the largest |entry|: the Pallas kernels round p, p_v and ds to bf16
# before their products, the port's plain versions keep them f32 until the outputs are
# rounded, so the two sit a few bf16 half-ulps (2^-9 = 2e-3 relative) apart. Measured at
# [1, 2, 65, 64]: forward 2.6e-3, gradients 3.0e-3 to 6.1e-3. The card's check of the
# bf16 kernels against the plain versions (2e-2) is held to the same band.
BF16_TOL = 1e-2

# (b, h, n_q, n_kv, dh): dh 36, Nq != Nkv with a partial last key block, Nq = 1
SHAPES = [(1, 2, 100, 100, 36), (2, 1, 70, 150, 32), (1, 3, 1, 130, 32)]


def _qkv(b, h, n_q, n_kv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, n, dh)).astype(np.float32) for n in (n_q, n_kv, n_kv))


# ---------------------------------------------------------------- the hash


@pytest.mark.parametrize("seed", [0, 7, -5, 2**31 - 1, -(2**31)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("offset", [(0, 0), (17, 129)], ids=["origin", "offset"])
def test_dense_keep_mask_bit_identical_to_jax(seed, rate, offset):
    row0, col0 = offset
    want = np.asarray(jax_dropout.dense_keep_mask(seed, 5, 37, 45, rate, row0=row0, col0=col0))
    got = attn_dropout.dense_keep_mask(seed, 5, 37, 45, rate, row0=row0, col0=col0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bh", [0, 2**31 - 10, 2**32 // 0x27D4EB2F + 3])
def test_keep_mask_bit_identical_for_large_bh(bh):
    """(bh + 1) * _BH_MUL wraps past 2^32 for all but the first."""
    want = np.asarray(jax_dropout.keep_mask(-3, bh, 5, 9, (16, 24), 0.3))
    got = attn_dropout.keep_mask(-3, bh, 5, 9, (16, 24), 0.3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("indices", [(), (1,), (3, 2**20), (7, 0, 5)])
@pytest.mark.parametrize("seed", [0, -9, 2**31 - 1])
def test_fold_seed_and_threshold_equal_jax(seed, indices):
    assert attn_dropout.fold_seed(seed, *indices) == int(jax_dropout.fold_seed(seed, *indices))
    for rate in (0.0, 0.1, 0.5, 0.999999999):
        assert attn_dropout.keep_threshold(rate) == jax_dropout.keep_threshold(rate)


def test_keep_fraction_and_seed_draw():
    mask = attn_dropout.dense_keep_mask(11, 4, 128, 128, 0.25)
    assert abs(mask.float().mean().item() - 0.75) < 0.01
    g = torch.Generator().manual_seed(3)
    seeds = [attn_dropout.draw_seed(g) for _ in range(3)]
    g.manual_seed(3)
    assert seeds == [attn_dropout.draw_seed(g) for _ in range(3)]
    assert all(0 <= s < 2**31 - 1 for s in seeds)
    with pytest.raises(RuntimeError, match="Generator"):
        attn_dropout.draw_seed(None)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_plain_with_dropout_matches_pallas(shape):
    q, k, v = _qkv(*shape)
    seed = 1234
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          dropout_rate=0.1, dropout_seed=seed)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              dropout_rate=0.1, dropout_seed=seed, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_einsum_and_flash_share_the_dropout_mask():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 40, 40, 16, seed=2))
    a = multi_head_attention(q, k, v, impl="FLASH", dropout_rate=0.2, dropout_seed=5)
    b = einsum_attention(q, k, v, sm_scale=0.25, dropout_rate=0.2, dropout_seed=5)
    c = multi_head_attention(q, k, v, impl="EINSUM", dropout_rate=0.2, dropout_seed=6)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)
    assert np.abs(a.numpy() - c.numpy()).max() > 1e-2  # another seed, another mask
    with pytest.raises(ValueError, match="seed"):
        multi_head_attention(q, k, v, impl="FLASH", dropout_rate=0.1)


# ---------------------------------------------------------------- gradients


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_fn_grads_match_jax_grad(shape, rate):
    """Gradients of sum(o^2) through FlashAttentionFn (the plain backward on
    the CPU) against jax.grad through the Pallas custom VJP."""
    q, k, v = _qkv(*shape, seed=4)
    seed = 99

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, dropout_rate=rate, dropout_seed=seed, interpret=True)
        return jnp.sum(o * o)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention(tq, tk, tv, dropout_rate=rate, dropout_seed=seed if rate else None)
    assert o.grad_fn is not None and "FlashAttentionFn" in type(o.grad_fn).__name__
    o.square().sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_bf16_fwd_and_grads_match_pallas_bf16(rate):
    """bf16 in both packages: the port's FLASH forward and the gradients of
    sum(o^2) through FlashAttentionFn against the Pallas kernels in bf16
    interpret mode, with attention dropout at `rate`."""
    q, k, v = _qkv(1, 2, 65, 65, 64, seed=8)
    seed = 99

    def jax_fwd(q, k, v):
        return jax_flash_attention(q, k, v, dropout_rate=rate, dropout_seed=seed, interpret=True)

    def jax_loss(q, k, v):
        o = jax_fwd(q, k, v).astype(jnp.float32)
        return jnp.sum(o * o)

    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    want_o = np.asarray(jax_fwd(jq, jk, jv).astype(jnp.float32))
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v))
    o = flash_attention(tq, tk, tv, dropout_rate=rate, dropout_seed=seed if rate else None)
    assert o.dtype == torch.bfloat16
    o_err = np.abs(o.detach().float().numpy() - want_o).max() / np.abs(want_o).max()
    assert o_err <= BF16_TOL, o_err
    o.float().square().sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == torch.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= BF16_TOL, (name, err)


def test_bwd_plain_is_what_the_cpu_backward_runs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 33, 47, 16, seed=5))
    do = torch.from_numpy(_qkv(1, 2, 33, 47, 16, seed=6)[0])
    o, lse = flash_attention_plain(q, k, v, 0.25, 0.3, 8, 2, 3)
    got = flash_attention_bwd(q, k, v, o, lse, do, 0.25, 0.3, 8, 2, 3)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, 0.25, 0.3, 8, 2, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    before = dict(flash_attention_bwd.by_kernel)
    with pytest.raises(RuntimeError, match="cpu or cuda"):
        flash_attention_bwd(q.to("meta"), k.to("meta"), v.to("meta"), o, lse, do, 0.25)
    assert flash_attention_bwd.by_kernel == before  # the CPU never counts


def test_block_qkv_grad_flash_equals_einsum():
    """FLASH on a tensor that needs grad goes through FlashAttentionFn: the qkv
    weight gets the gradient EINSUM's autograd gives it."""
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 17, 32)).astype(np.float32))
    grads = {}
    for impl in ("FLASH", "EINSUM"):
        torch.manual_seed(0)
        blk = Block(32, 4, attn_impl=impl, qkv_bias=True)
        blk(x).square().sum().backward()
        grads[impl] = blk.attn.qkv.weight.grad
    assert grads["FLASH"] is not None and grads["FLASH"].abs().max().item() > 0
    np.testing.assert_allclose(grads["FLASH"].numpy(), grads["EINSUM"].numpy(), atol=TOL, rtol=0)


def test_flash_fn_saves_no_graph_without_grad():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8, 16))
    assert flash_attention(q, k, v).grad_fn is None
    o, lse = FlashAttentionFn.apply(q.requires_grad_(), k, v, 0.25, 0.0, 0, 0, 0)
    assert o.requires_grad and not lse.requires_grad


# ---------------------------------------------------------------- generators


def test_dropout_modules_draw_from_their_generator_only():
    x = torch.ones(4, 8, 16)
    for module in (Dropout(0.5), DropPath(0.5)):
        module.train()
        with pytest.raises(RuntimeError, match="Generator"):
            module(x)
        state = torch.get_rng_state()
        module.generator = torch.Generator().manual_seed(1)
        a = module(x)
        module.generator = torch.Generator().manual_seed(1)
        assert torch.equal(a, module(x))
        assert torch.equal(torch.get_rng_state(), state)  # the global generator is untouched
        assert set(a.unique().tolist()) == {0.0, 2.0}
        assert torch.equal(module.eval()(x), x)
