"""The port's config loader, sincos tables, blocks, VIT and weight conversion
against the JAX package, on the CPU at small sizes. Weights are the flax
init plus numpy noise (so biases and norms are not trivial), moved across
with `load_jax_params`; inputs come from numpy seeds."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.core import meta

torch = pytest.importorskip("torch")

from ucf_vit_tpu.config import load_config as jax_load_config
from ucf_vit_tpu.models.blocks import Attention as JAttention
from ucf_vit_tpu.models.blocks import Block as JBlock
from ucf_vit_tpu.models.blocks import Mlp as JMlp
from ucf_vit_tpu.models.blocks import PatchEmbed as JPatchEmbed
from ucf_vit_tpu.models.vit import VIT as JVIT
from ucf_vit_tpu.ops import pos_embed as jax_pos_embed
from ucf_vit_tpu.ops.attention import AttnImpl as JAttnImpl
from ucf_vit_tpu.tasks import build_classification as jax_build_classification
from ucf_vit_tpu.tools.convert_checkpoint import export_torch_state
from ucf_vit_tpu.train import synthetic_batches as jax_synthetic_batches
from ucf_vit_tpu_torch.config import Config, load_config
from ucf_vit_tpu_torch.convert import jax_to_torch_state, load_jax_params
from ucf_vit_tpu_torch.models.blocks import Attention, Block, Mlp, PatchEmbed
from ucf_vit_tpu_torch.models.vit import VIT
from ucf_vit_tpu_torch.ops import pos_embed
from ucf_vit_tpu_torch.tasks import build_classification
from ucf_vit_tpu_torch.train import synthetic_batches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
MODULE_TOL = 1e-5
LOGITS_TOL = 5e-5


def _params(module, *args, seed=0):
    """flax init, unboxed to numpy, plus N(0, 0.05) noise on every leaf."""
    params = meta.unbox(module.init(jax.random.key(0), *args)["params"])
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params
    )


def _x(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(out, ref, tol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=tol, rtol=0)


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_load_config_matches_jax(path):
    ours, ref = load_config(path), jax_load_config(path)
    assert ours.task == ref.task
    assert ours.raw == ref.raw
    assert (ours.twoD, ours.tile_size, ours.max_channels, ours.world_size) == (
        ref.twoD, ref.tile_size, ref.max_channels, ref.world_size)


def test_synthetic_batches_match_jax_stream():
    for rel in ("configs/catsdogs/classification/base_config.yaml",
                "configs/basic_ct/unetr/base_config.yaml"):
        path = os.path.join(REPO, rel)
        ours = synthetic_batches(load_config(path), 2, seed=3)
        ref = jax_synthetic_batches(jax_load_config(path), 2, seed=3)
        for _ in range(2):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


# ---------------------------------------------------------------- pos embed


def test_sincos_tables_match_jax():
    np.testing.assert_array_equal(
        pos_embed.get_2d_sincos_pos_embed(32, 4, 6, cls_token=True),
        jax_pos_embed.get_2d_sincos_pos_embed(32, 4, 6, cls_token=True))
    np.testing.assert_array_equal(
        pos_embed.get_3d_sincos_pos_embed(24, 2, 3, 4),
        jax_pos_embed.get_3d_sincos_pos_embed(24, 2, 3, 4))
    np.testing.assert_array_equal(
        pos_embed.get_1d_sincos_pos_embed_from_grid(16, np.arange(5)),
        jax_pos_embed.get_1d_sincos_pos_embed_from_grid(16, np.arange(5)))


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("twoD", [True, False], ids=["2d", "3d"])
def test_patch_embed_matches_flax(twoD):
    shape = (2, 3, 16, 16) if twoD else (2, 1, 16, 8, 8)
    x = _x(*shape)
    jmod = JPatchEmbed(patch_size=4, embed_dim=24, twoD=twoD)
    params = _params(jmod, jnp.asarray(x))
    ours = load_jax_params(PatchEmbed(4, 24, shape[1], twoD=twoD), params)
    _close(ours(torch.from_numpy(x)), jmod.apply({"params": params}, jnp.asarray(x)),
           MODULE_TOL)


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
def test_mlp_matches_flax(gelu_approx):
    x = _x(2, 9, 32)
    jmod = JMlp(hidden_features=64, out_features=32, gelu_approx=gelu_approx)
    params = _params(jmod, jnp.asarray(x))
    ours = load_jax_params(Mlp(32, 64, 32, gelu_approx=gelu_approx), params).eval()
    _close(ours(torch.from_numpy(x)), jmod.apply({"params": params}, jnp.asarray(x)),
           MODULE_TOL)


@pytest.mark.parametrize("impl", ["FLASH", "EINSUM"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_attention_matches_flax(impl, qk_norm):
    x = _x(2, 17, 32)
    jmod = JAttention(dim=32, num_heads=4, qkv_bias=True, qk_norm=qk_norm,
                      attn_impl=JAttnImpl.EINSUM)
    params = _params(jmod, jnp.asarray(x))
    ours = load_jax_params(
        Attention(32, 4, attn_impl=impl, qkv_bias=True, qk_norm=qk_norm), params).eval()
    _close(ours(torch.from_numpy(x)), jmod.apply({"params": params}, jnp.asarray(x)),
           MODULE_TOL)


@pytest.mark.parametrize("init_values", [None, 0.5], ids=["no_ls", "layer_scale"])
def test_block_matches_flax(init_values):
    x = _x(2, 17, 32)
    jmod = JBlock(dim=32, num_heads=4, qkv_bias=True, init_values=init_values,
                  attn_impl=JAttnImpl.EINSUM)
    params = _params(jmod, jnp.asarray(x))
    ours = load_jax_params(
        Block(32, 4, qkv_bias=True, init_values=init_values), params).eval()
    _close(ours(torch.from_numpy(x)), jmod.apply({"params": params}, jnp.asarray(x)),
           MODULE_TOL)


# ---------------------------------------------------------------- VIT


VIT_CASES = {
    "2d": dict(img_size=(32, 32), patch_size=8, in_chans=3, num_classes=5, embed_dim=32,
               depth=2, num_heads=4),
    "3d": dict(img_size=(16, 16, 16), patch_size=8, in_chans=1, num_classes=3,
               embed_dim=24, depth=1, num_heads=4, twoD=False),
}


@pytest.mark.parametrize("case", sorted(VIT_CASES))
@pytest.mark.parametrize("impl", ["FLASH", "AUTO"])
def test_vit_logits_match_flax(case, impl):
    kw = VIT_CASES[case]
    x = _x(2, kw["in_chans"], *kw["img_size"])
    jmod = JVIT(attn_impl=JAttnImpl.EINSUM, **kw)
    params = _params(jmod, jnp.asarray(x))
    ours = load_jax_params(VIT(attn_impl=impl, **kw), params).eval()
    with torch.inference_mode():
        out = ours(torch.from_numpy(x))
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    assert out.shape == ref.shape
    _close(out, ref, LOGITS_TOL)


def test_conversion_matches_export_torch_state():
    kw = dict(VIT_CASES["2d"], init_values=0.1)
    x = _x(1, 3, 32, 32)
    params = _params(JVIT(**kw), jnp.asarray(x))
    ours = jax_to_torch_state(params)
    ref = export_torch_state(params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    model = load_jax_params(VIT(**kw), params)
    state = model.state_dict()
    assert sorted(state) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(state[k].numpy(), ref[k], err_msg=k)


def _small_cfg(parallelism=None, **init):
    ia = {"default_vars": ["red", "green", "blue"], "tile_size": [32, 32],
          "patch_size": 8, "embed_dim": 32, "depth": 2, "num_heads": 4, "mlp_ratio": 2,
          "twoD": True, "adaptive_patching": False}
    ia.update(init)
    raw = {"trainer": {"task": "classification"},
           "parallelism": dict(parallelism or {}),
           "model": {"net": {"init_args": ia}},
           "data": {"batch_size": 2, "num_channels_used": {"d": 3}, "num_classes": 4}}
    return Config(raw=raw, task="classification")


def test_build_classification_matches_jax():
    cfg = _small_cfg()
    jmod, _ = jax_build_classification(cfg)
    x = _x(2, 3, 32, 32)
    params = _params(jmod, jnp.asarray(x))
    ours = load_jax_params(build_classification(cfg), params).eval()
    with torch.inference_mode():
        out = ours(torch.from_numpy(x))
    _close(out, jmod.apply({"params": params}, jnp.asarray(x)), LOGITS_TOL)


def test_seeded_init_is_deterministic_and_uses_sincos_table():
    cfg = _small_cfg()
    gen = lambda s: build_classification(cfg).init_weights(torch.Generator().manual_seed(s))
    a, b, c = gen(0).state_dict(), gen(0).state_dict(), gen(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"], c["blocks.0.attn.qkv.weight"])
    table = jax_pos_embed.get_2d_sincos_pos_embed(32, 4, 4, cls_token=True)
    np.testing.assert_allclose(a["pos_embed"][0].numpy(), table, atol=1e-7)
    w = a["blocks.1.mlp.fc1.weight"]
    assert abs(w.std().item() - 0.02) < 0.003 and w.abs().max().item() <= 0.0455
    assert torch.count_nonzero(a["blocks.0.attn.qkv.bias"]) == 0


@pytest.mark.parametrize("init, parallelism", [
    ({"adaptive_patching": True, "fixed_length": 16}, None),
    ({"use_varemb": True}, None),
    ({"moe_num_experts": 4}, None),
    # scan_layers alone is accepted now; the scanned stack under a pipeline is not
    ({"scan_layers": True}, {"pipe_par_size": 2}),
], ids=["adaptive", "varemb", "moe", "scan"])
def test_unported_features_raise(init, parallelism):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_classification(_small_cfg(parallelism=parallelism, **init))
