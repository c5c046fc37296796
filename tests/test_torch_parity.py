"""Cross-framework numerics parity: our flax blocks vs a hand-built torch
mirror of the reference's math (the reference itself needs timm/monai which
are not installed; its Block math is LN(eps 1e-6) -> qkv -> SDPA -> proj ->
residual -> LN -> fc1 -> exact GELU -> fc2 -> residual,
`simple/building_blocks.py:94-239`).

This is the north-star numerics check ("matching reference outputs to 1e-3",
BASELINE.json): identical weights produce matching outputs across torch f32
and jax f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ucf_vit_tpu.models.blocks import Block, PatchEmbed
from ucf_vit_tpu.ops.attention import AttnImpl

DIM, HEADS, N, B = 32, 4, 9, 2


class TorchBlock(torch.nn.Module):
    """Reference Block math in plain torch (f32, no dropout)."""

    def __init__(self, dim, heads):
        super().__init__()
        self.ln1 = torch.nn.LayerNorm(dim, eps=1e-6)
        self.qkv = torch.nn.Linear(dim, 3 * dim, bias=True)
        self.proj = torch.nn.Linear(dim, dim, bias=True)
        self.ln2 = torch.nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = torch.nn.Linear(dim, 4 * dim)
        self.fc2 = torch.nn.Linear(4 * dim, dim)
        self.heads = heads
        self.dim = dim

    def forward(self, x):
        b, n, c = x.shape
        h = self.ln1(x)
        qkv = self.qkv(h).reshape(b, n, 3, self.heads, c // self.heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        o = o.transpose(1, 2).reshape(b, n, c)
        x = x + self.proj(o)
        h = self.ln2(x)
        x = x + self.fc2(torch.nn.functional.gelu(self.fc1(h)))
        return x


def _unbox(t):
    return np.asarray(t.unbox() if hasattr(t, "unbox") else t)


def test_block_matches_torch_reference_math():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, N, DIM)).astype(np.float32)

    blk = Block(dim=DIM, num_heads=HEADS, qkv_bias=True, gelu_approx=False,
                attn_impl=AttnImpl.EINSUM)
    params = blk.init(jax.random.key(0), jnp.asarray(x))["params"]

    tb = TorchBlock(DIM, HEADS)
    with torch.no_grad():
        tb.ln1.weight.copy_(torch.from_numpy(_unbox(params["norm1"]["scale"])))
        tb.ln1.bias.copy_(torch.from_numpy(_unbox(params["norm1"]["bias"])))
        tb.qkv.weight.copy_(torch.from_numpy(_unbox(params["attn"]["qkv"]["kernel"]).T))
        tb.qkv.bias.copy_(torch.from_numpy(_unbox(params["attn"]["qkv"]["bias"])))
        tb.proj.weight.copy_(torch.from_numpy(_unbox(params["attn"]["proj"]["kernel"]).T))
        tb.proj.bias.copy_(torch.from_numpy(_unbox(params["attn"]["proj"]["bias"])))
        tb.ln2.weight.copy_(torch.from_numpy(_unbox(params["norm2"]["scale"])))
        tb.ln2.bias.copy_(torch.from_numpy(_unbox(params["norm2"]["bias"])))
        tb.fc1.weight.copy_(torch.from_numpy(_unbox(params["mlp"]["fc1"]["kernel"]).T))
        tb.fc1.bias.copy_(torch.from_numpy(_unbox(params["mlp"]["fc1"]["bias"])))
        tb.fc2.weight.copy_(torch.from_numpy(_unbox(params["mlp"]["fc2"]["kernel"]).T))
        tb.fc2.bias.copy_(torch.from_numpy(_unbox(params["mlp"]["fc2"]["bias"])))

        want = tb(torch.from_numpy(x)).numpy()

    got = np.asarray(blk.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_patch_embed_matches_torch_conv():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)

    pe = PatchEmbed(patch_size=8, embed_dim=12, twoD=True)
    params = pe.init(jax.random.key(0), jnp.asarray(x))["params"]

    conv = torch.nn.Conv2d(3, 12, kernel_size=8, stride=8)
    with torch.no_grad():
        # flax HWIO -> torch OIHW
        k = _unbox(params["proj"]["kernel"]).transpose(3, 2, 0, 1)
        conv.weight.copy_(torch.from_numpy(k))
        conv.bias.copy_(torch.from_numpy(_unbox(params["proj"]["bias"])))
        want = conv(torch.from_numpy(x))  # [B, 12, 2, 2]
        want = want.flatten(2).transpose(1, 2).numpy()  # [B, 4, 12]

    got = np.asarray(pe.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-5)
