"""The port's flash-attention forward and attention dispatch against the JAX
package: the plain version (what FLASH runs on a CPU tensor) against the
Pallas kernel in interpret mode and the einsum oracle, lse against the
kernel's own, and the dispatch rules. Inputs come from numpy seeds.

The CUDA kernel itself runs only on the card: see
tests/test_torch_flash_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ucf_vit_tpu.ops.attention import einsum_attention as jax_einsum_attention
from ucf_vit_tpu.ops.flash_attention import _flash_fwd_len
from ucf_vit_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ucf_vit_tpu_torch.ops.attention import (
    AttnImpl,
    einsum_attention,
    multi_head_attention,
    resolve_impl,
)
from ucf_vit_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

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
