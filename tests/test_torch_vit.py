"""The port's config loader, sincos tables, blocks, VIT and weight conversion
against the JAX package, on the CPU at small sizes. Weights are the flax
init plus numpy noise (so biases and norms are not trivial), moved across
with `load_jax_params`; inputs come from numpy seeds."""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.core import meta

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # xdist's workers share the cores: one torch
    torch.set_num_threads(1)  # thread each keeps them from oversubscribing the machine

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
    # MoE blocks build now (tests/test_torch_mlp_int8.py); MoE under a pipeline does not
    ({"moe_num_experts": 4, "moe_every": 1}, {"pipe_par_size": 2}),
    # scan_layers alone is accepted now; the scanned stack under a pipeline is not
    ({"scan_layers": True}, {"pipe_par_size": 2}),
], ids=["moe", "scan"])
def test_unported_features_raise(init, parallelism):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_classification(_small_cfg(parallelism=parallelism, **init))


# ---------------------------------------------------------------- adaptive patching
#
# The 2-D adaptive path at a small size: LinearTokenEmbed and AdaptivePosMLP within
# 1e-6 of flax (one LayerNorm-Linear-LayerNorm or Linear-GELU on the same weights), the
# adaptive ViT's logits through `load_jax_params` within 1e-5 (two blocks), its
# conversion key for key with `export_torch_state`; the quadtree's native build against
# its numpy build and the JAX tree, and `Patchify` against the JAX one on the same
# generator state, array for array; concurrent first builds of the native library.

from ucf_vit_tpu.data.quadtree import FixedQuadTree as JFixedQuadTree
from ucf_vit_tpu.data.transform import Patchify as JPatchify
from ucf_vit_tpu.models.blocks import AdaptivePosMLP as JAdaptivePosMLP
from ucf_vit_tpu.models.blocks import LinearTokenEmbed as JLinearTokenEmbed
from ucf_vit_tpu_torch import native
from ucf_vit_tpu_torch.data.quadtree import FixedQuadTree, quadtree_boxes_plain
from ucf_vit_tpu_torch.data.transform import Patchify
from ucf_vit_tpu_torch.models.blocks import AdaptivePosMLP, LinearTokenEmbed

ADAPTIVE_MODULE_TOL = 1e-6
ADAPTIVE_LOGITS_TOL = 1e-5


@pytest.mark.parametrize("module", ["token_embed", "pos_mlp"])
def test_adaptive_embeds_match_flax(module):
    # each under the name the models give it (the conversion reads the names)
    holder = torch.nn.Module()
    if module == "token_embed":
        x = _x(2, 16, 48)
        jmod, holder.token_embeds, name = JLinearTokenEmbed(32), LinearTokenEmbed(48, 32), \
            "token_embed"
        ours = holder.token_embeds
    else:
        x = np.abs(_x(2, 16, 3)) * 8
        jmod, holder.adaptive_pos_dep_emb, name = JAdaptivePosMLP(32), AdaptivePosMLP(3, 32), \
            "adaptive_pos_dep_emb"
        ours = holder.adaptive_pos_dep_emb
    params = _params(jmod, jnp.asarray(x))
    load_jax_params(holder, {name: params})
    _close(ours(torch.from_numpy(x)), jmod.apply({"params": params}, jnp.asarray(x)),
           ADAPTIVE_MODULE_TOL)


def _adaptive_inputs(b, c, length, p, seed=1):
    rng = np.random.default_rng(seed)
    seq = rng.normal(size=(b, c, length, p * p)).astype(np.float32)
    ps = np.concatenate([rng.integers(1, 9, size=(b, length, 1)),
                         rng.uniform(0, 32, size=(b, length, 2))], -1).astype(np.float32)
    return seq, ps


@pytest.mark.parametrize("pos", ["mlp", "table"])
def test_adaptive_vit_logits_match_flax(pos):
    kw = dict(img_size=(32, 32), patch_size=4, in_chans=3, num_classes=5, embed_dim=32,
              depth=2, num_heads=4, adaptive_patching=True, fixed_length=16,
              use_adaptive_pos_emb=pos == "mlp")
    seq, ps = _adaptive_inputs(2, 3, 16, 4)
    jmod = JVIT(attn_impl=JAttnImpl.EINSUM, **kw)
    params = _params(jmod, jnp.asarray(seq), None, jnp.asarray(ps))
    assert sorted(jax_to_torch_state(params)) == sorted(export_torch_state(params))
    ours = load_jax_params(VIT(attn_impl="FLASH", **kw), params).eval()
    assert sorted(ours.state_dict()) == sorted(export_torch_state(params))
    with torch.inference_mode():
        out = ours(torch.from_numpy(seq), seq_ps=torch.from_numpy(ps))
    _close(out, jmod.apply({"params": params}, jnp.asarray(seq), None, jnp.asarray(ps)),
           ADAPTIVE_LOGITS_TOL)


def test_adaptive_init_draws_the_position_tables_and_refuses_the_sqrt_len_method():
    """The adaptive init draws its position table; the sqrt-len method, once
    refused, now builds (UNETR's input): a conv patch embed over the
    reassembled image and the sincos table of the `(sqrt_len,)^nd` grid."""
    cfg = _small_cfg(adaptive_patching=True, fixed_length=16, use_adaptive_pos_emb=True)
    model = build_classification(cfg).init_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert sd["pos_embed"].shape == (1, 17, 32)  # kept beside the MLP, as in the JAX tree
    assert abs(sd["pos_embed"].std().item() - 0.02) < 0.004
    assert sd["token_embeds.1.weight"].shape == (32, 8 * 8 * 3)
    assert sd["adaptive_pos_dep_emb.0.weight"].shape == (32, 3)
    sq = VIT(img_size=(16, 16, 16), patch_size=2, in_chans=1, embed_dim=24, depth=1,
             num_heads=2, twoD=False, class_token=False, adaptive_patching=True,
             fixed_length=64, sqrt_len_method=True, use_adaptive_pos_emb=True)
    sd = sq.init_weights(torch.Generator().manual_seed(0)).state_dict()
    assert sq.sqrt_len == 4 and sq.num_patches == 64
    assert sd["token_embeds.proj.weight"].shape == (24, 1, 2, 2, 2)
    assert sd["adaptive_pos_dep_emb.0.weight"].shape == (24, 4)
    np.testing.assert_allclose(sd["pos_embed"][0].numpy(),
                               jax_pos_embed.get_3d_sincos_pos_embed(24, 4, 4, 4), atol=1e-7)


def _edge_maps():
    rng = np.random.default_rng(4)
    canny = np.zeros((64, 64), np.uint8)
    canny[rng.integers(0, 64, 300), rng.integers(0, 64, 300)] = 255
    return {"canny": canny, "uniform": rng.uniform(size=(32, 32)),
            "ramp": (np.arange(64 * 64).reshape(64, 64) % 256).astype(np.uint8)}


@pytest.mark.parametrize("edges", sorted(_edge_maps()))
@pytest.mark.parametrize("fixed_length", [16, 52])
def test_quadtree_native_matches_numpy_and_jax(edges, fixed_length):
    domain = _edge_maps()[edges]
    boxes, vals = native.quadtree_boxes(domain, fixed_length)
    plain_boxes, plain_vals = quadtree_boxes_plain(domain, fixed_length)
    np.testing.assert_array_equal(boxes, plain_boxes)
    np.testing.assert_array_equal(vals, plain_vals)
    ref = JFixedQuadTree(domain, fixed_length)
    ours = FixedQuadTree(domain, fixed_length)
    assert ours.encode_nodes() == ref.encode_nodes() == boxes.tolist()
    assert [v for _, v in ours.nodes] == [v for _, v in ref.nodes] == vals.tolist()
    img = np.random.default_rng(5).random((*domain.shape, 3)).astype(np.float32)
    for got, want in zip(ours.serialize(img, (4, 4, 3)), ref.serialize(img, (4, 4, 3))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    seq = np.asarray(ours.serialize(img, (4, 4, 3))[0])
    np.testing.assert_array_equal(ours.deserialize(seq, 4, 3), ref.deserialize(seq, 4, 3))


@pytest.mark.parametrize("dataset", ["imagenet", "basic_ct"])
def test_patchify_matches_jax(dataset):
    """Eight samples from one seeded generator each side: every smoothing factor
    (0 draws a random edge map) and Canny threshold the draws give."""
    rng = np.random.default_rng(6)
    if dataset == "imagenet":
        imgs, c = rng.integers(0, 256, size=(8, 32, 32, 3)).astype(np.uint8), 3
    else:
        imgs, c = rng.random((8, 32, 32, 1)).astype(np.float32), 1
    ours = Patchify(fixed_length=16, patch_size=4, num_channels=c, dataset=dataset,
                    rng=np.random.default_rng(7))
    ref = JPatchify(fixed_length=16, patch_size=4, num_channels=c, dataset=dataset,
                    rng=np.random.default_rng(7))
    for img in imgs:
        got, want = ours(img), ref(img)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[3].encode_nodes() == want[3].encode_nodes()
    with pytest.raises(RuntimeError, match="explicit"):
        Patchify(fixed_length=16, patch_size=4)(imgs[0])


def test_native_first_build_from_several_processes_loads_a_whole_library(tmp_path):
    """Four processes build the library into an empty directory at once: each loads
    a whole library (its tree equals the numpy build's) and no partial file stays."""
    code = (
        "import sys, pathlib, numpy as np\n"
        "from ucf_vit_tpu_torch import native\n"
        "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "d = np.random.default_rng(0).integers(0, 256, (64, 64)).astype(np.uint8)\n"
        "b, v = native.quadtree_boxes(d, 40)\n"
        "print(int(b.sum()), int(v.sum()))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    d = np.random.default_rng(0).integers(0, 256, (64, 64)).astype(np.uint8)
    b, v = quadtree_boxes_plain(d, 40)
    assert {o for o, _ in outs} == {f"{int(b.sum())} {int(v.sum())}\n"}
    assert [f.name for f in tmp_path.iterdir()] == [native.library_path().name]


# ---------------------------------------------------------------- UNETR
#
# UNETR's modules against the JAX package at a small size: each conv decoder block
# (2-D and 3-D; the ConvTranspose kernels mirrored by `load_jax_params`) within 1e-5
# and the resize within 1e-6 (the shipped 72^3 -> 64^3 too), the
# UNETR forward in skip, no-skip and linear-decoder modes and by the sqrt-len method
# (tile 16^3, patch 2, 64 octree tokens: sqrt_len 4, so the decoder resizes 32^3 to
# 16^3; embed 24, depth 4, the least depth with three distinct skip taps, feature
# size 4, 4 classes) within 1e-5 on `load_jax_params` weights, its conversion key for
# key and value for value with `export_torch_state`. The blocks and the UNETR are held
# against the JAX function evaluated in f64 (`jax.enable_x64`): XLA's CPU convolutions in
# f32 sit up to 1.1e-5 from the exact result at these sizes (instance norm over maps of
# 2^3 to 8^3 amplifies rounding), the port's f32 up to 5e-6; each block in f64 agrees
# with the JAX one within 1e-10 (`EXACT_TOL`).
# Then gradients with remat equal to
# those without, the losses and Dice within 1e-6, the sqrt-len reassembly exactly,
# and the f32 policy that `resolve_device` pins on a card.

from ucf_vit_tpu.models import unet_blocks as jub
from ucf_vit_tpu.models.unetr import UNETR as JUNETR
from ucf_vit_tpu.ops.pos_embed import interpolate_pos_embed_1d as jax_interpolate_1d
from ucf_vit_tpu.tasks import disassemble_sqrt_len as jax_disassemble
from ucf_vit_tpu.tasks import reassemble_sqrt_len as jax_reassemble
from ucf_vit_tpu.utils import metrics as jax_metrics
from ucf_vit_tpu_torch.inference import resolve_device
from ucf_vit_tpu_torch.models import UNETR
from ucf_vit_tpu_torch.models import unet_blocks as ub
from ucf_vit_tpu_torch.tasks import disassemble_sqrt_len, reassemble_sqrt_len
from ucf_vit_tpu_torch.utils import metrics

UNET_TOL = 1e-5
EXACT_TOL = 1e-10  # the port in f64 against the JAX function in f64
RESIZE_TOL = 1e-6
UNETR_TOL = 1e-5
DICE_TOL = 1e-6
REMAT_GRAD_TOL = 1e-6

# name -> (flax module, port module, input channels, spatial, takes a skip)
UNET_BLOCKS = {
    "res_block_3d": (lambda: jub.UnetResBlock(out_channels=6, ndim=3),
                     lambda: ub.UnetResBlock(6, 6, ndim=3), 6, (4, 4, 4), False),
    "res_block_project_2d": (lambda: jub.UnetResBlock(out_channels=6, ndim=2),
                             lambda: ub.UnetResBlock(4, 6, ndim=2), 4, (8, 8), False),
    "basic_block_3d": (lambda: jub.UnetrBasicBlock(out_channels=4, ndim=3),
                       lambda: ub.UnetrBasicBlock(1, 4, ndim=3), 1, (6, 6, 6), False),
    "pr_up_block_3d": (lambda: jub.UnetrPrUpBlock(out_channels=4, num_layer=2, ndim=3),
                       lambda: ub.UnetrPrUpBlock(8, 4, num_layer=2, ndim=3), 8, (2, 2, 2),
                       False),
    "pr_up_block_2d": (lambda: jub.UnetrPrUpBlock(out_channels=4, num_layer=1, ndim=2),
                       lambda: ub.UnetrPrUpBlock(8, 4, num_layer=1, ndim=2), 8, (4, 4), False),
    "up_block_3d": (lambda: jub.UnetrUpBlock(out_channels=4, ndim=3),
                    lambda: ub.UnetrUpBlock(8, 4, ndim=3), 8, (3, 3, 3), True),
    "up_block_upsample_1_2d": (lambda: jub.UnetrUpBlock(out_channels=4, upsample=1, ndim=2),
                               lambda: ub.UnetrUpBlock(8, 4, upsample=1, ndim=2), 8, (6, 6),
                               True),
    "my_unet_block_3d": (lambda: jub.MyUnetBlock(out_channels=3, ndim=3),
                         lambda: ub.MyUnetBlock(5, 3, ndim=3), 5, (3, 3, 3), False),
    "out_block_2d": (lambda: jub.UnetOutBlock(num_classes=4, ndim=2),
                     lambda: ub.UnetOutBlock(5, 4, ndim=2), 5, (6, 6), False),
}


def _cl(x):
    """channels-first numpy -> channels-last jnp (the JAX blocks' layout)."""
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _jax_f64(fn, params, *args):
    """`fn(params, *args)` with every array in f64, under `jax.enable_x64`."""
    with jax.enable_x64(True):
        f64 = lambda a: None if a is None else jnp.asarray(np.asarray(a, np.float64))
        return np.asarray(fn(jax.tree.map(f64, params), *[f64(a) for a in args]))


def _port_f64(module, *args):
    """`module` run in f64 (the port's side of the exact comparison)."""
    with torch.no_grad():
        return module.double()(*[torch.from_numpy(np.asarray(a, np.float64))
                                 for a in args]).numpy()


@pytest.mark.parametrize("name", sorted(UNET_BLOCKS))
def test_unet_blocks_match_flax(name):
    jfn, pfn, cin, spatial, skip = UNET_BLOCKS[name]
    x = _x(2, cin, *spatial)
    args = [_cl(x)]
    if skip:
        s = _x(2, 4, *(d * (2 if "upsample_1" not in name else 1) for d in spatial), seed=2)
        args.append(_cl(s))
    jmod = jfn()
    params = _params(jmod, *args)
    holder = torch.nn.Module()
    holder.blk = pfn()
    load_jax_params(holder, {"blk": params})
    assert not [k for k in holder.state_dict() if "norm" in k]  # no affine norm parameters
    want = np.moveaxis(_jax_f64(lambda p, *a: jmod.apply({"params": p}, *a), params, *args),
                       -1, 1)
    ins = [x] + ([s] if skip else [])
    with torch.no_grad():
        got = holder.blk(*[torch.from_numpy(a) for a in ins])
    _close(got, want, UNET_TOL)
    np.testing.assert_allclose(_port_f64(holder.blk, *ins), want, atol=EXACT_TOL, rtol=0)


@pytest.mark.parametrize("shape,out", [((2, 3, 5, 7), (9, 4)), ((1, 2, 4, 6, 3), (8, 3, 5)),
                                       ((1, 2, 72, 72, 72), (64, 64, 64))],
                         ids=["2d", "3d", "72_to_64"])
def test_resize_linear_align_corners_matches_flax(shape, out):
    x = _x(*shape)
    want = np.moveaxis(np.asarray(jub.resize_linear_align_corners(_cl(x), out)), -1, 1)
    _close(ub.resize_linear_align_corners(torch.from_numpy(x), out), want, RESIZE_TOL)


def _unetr_case(case):
    """(JAX model, port model, x, seq_ps, x_seq) of a shrunk UNETR case."""
    twoD = case.startswith("2d")
    nd = 2 if twoD else 3
    kw = dict(img_size=(16,) * nd, patch_size=2, in_chans=1, embed_dim=24, depth=4,
              num_heads=2, mlp_ratio=2.0, twoD=twoD)
    ukw = dict(num_classes=4, feature_size=4, skip_connection="noskip" not in case,
               linear_decoder="linear" in case)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1) + (16,) * nd).astype(np.float32)
    ps = x_seq = None
    if "adaptive" in case:  # 64 tokens of 2^3: a 4^3 grid reassembled into 8^3
        kw.update(adaptive_patching=True, fixed_length=64, use_adaptive_pos_emb=True,
                  sqrt_len_method=True)
        x_seq = rng.normal(size=(2, 1, 8, 8, 8)).astype(np.float32)
        ps = np.concatenate([rng.integers(2, 9, size=(2, 64, 1)),
                             rng.uniform(0, 16, size=(2, 64, 3))], -1).astype(np.float32)
    return (JUNETR(attn_impl=JAttnImpl.EINSUM, class_token=False, **kw, **ukw),
            UNETR(attn_impl="FLASH", **kw, **ukw), x, ps, x_seq)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", ["3d_adaptive", "3d_adaptive_noskip", "3d", "3d_noskip",
                                  "2d", "2d_noskip", "2d_linear"])
def test_unetr_matches_flax(case):
    jmod, ours, x, ps, x_seq = _unetr_case(case)
    params = _params(jmod, jnp.asarray(x), None, _j(ps), _j(x_seq))
    exported, converted = export_torch_state(params), jax_to_torch_state(params)
    assert sorted(converted) == sorted(exported) == sorted(ours.state_dict())
    for k in exported:  # value for value: the ConvTranspose kernels mirrored on both sides
        np.testing.assert_array_equal(converted[k], exported[k], err_msg=k)
    load_jax_params(ours, params).eval()
    want = _jax_f64(lambda p, *a: jmod.apply({"params": p}, a[0], None, *a[1:]), params, x,
                    ps, x_seq)
    with torch.inference_mode():
        got = ours(torch.from_numpy(x), seq_ps=_t(ps), x_seq=_t(x_seq))
    assert got.shape == (2, 4) + x.shape[2:]
    _close(got, want, UNETR_TOL)


def test_unetr_conversion_mirrors_the_transposed_kernels():
    """A ConvTranspose kernel taken over unmirrored (its [*k, in, out] only
    transposed) moves the forward past the tolerance: the value test above
    sees a missing flip."""
    jmod, ours, x, ps, x_seq = _unetr_case("3d")
    params = _params(jmod, jnp.asarray(x), None, None, None)
    load_jax_params(ours, params).eval()
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), None, None, None))
    k = np.asarray(params["decoder3"]["transp_conv"]["kernel"])
    with torch.no_grad():
        ours.decoder3.transp_conv.weight.copy_(torch.from_numpy(k.transpose(3, 4, 0, 1, 2)))
        got = ours(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() > 100 * UNETR_TOL


def test_unetr_remat_gradients_equal_those_without():
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        _, model, x, ps, x_seq = _unetr_case("3d_adaptive")
        model.remat = remat
        model.init_weights(torch.Generator().manual_seed(4)).train()
        out = model(torch.from_numpy(x), seq_ps=_t(ps), x_seq=_t(x_seq))
        (out.square().mean()).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert sorted(grads[0]) == sorted(grads[1]) and len(grads[0]) > 50
    for n in grads[0]:
        np.testing.assert_allclose(grads[1][n].numpy(), grads[0][n].numpy(),
                                   atol=REMAT_GRAD_TOL, rtol=0, err_msg=n)


def test_unetr_refuses_a_class_token_patch_dropout_and_adaptive_without_sqrt_len():
    kw = dict(img_size=(16, 16), patch_size=2, in_chans=1, embed_dim=24, depth=4, num_heads=2)
    with pytest.raises(ValueError, match="class_token"):
        UNETR(class_token=True, **kw)
    with pytest.raises(ValueError, match="patch_drop_rate"):
        UNETR(patch_drop_rate=0.5, **kw)
    with pytest.raises(ValueError, match="sqrt-len"):
        UNETR(adaptive_patching=True, fixed_length=64, **kw)


@pytest.mark.parametrize("nd", [2, 3], ids=["2d", "3d"])
def test_sqrt_len_reassembly_matches_jax(nd):
    tokens = _x(2, 1, 4 ** nd, 3 ** nd)
    want = np.asarray(jax_reassemble(jnp.asarray(tokens), 4, 3, nd == 2))
    got = reassemble_sqrt_len(torch.from_numpy(tokens), 4, 3, nd == 2)
    assert got.shape == (2, 1) + (12,) * nd
    np.testing.assert_array_equal(got.numpy(), want)
    back = disassemble_sqrt_len(got, 4, 3, nd == 2)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jax_disassemble(jnp.asarray(want), 4, 3, nd == 2)))
    np.testing.assert_array_equal(back.numpy(), tokens)


@pytest.mark.parametrize("nd,background", [(3, True), (2, True), (3, False)],
                         ids=["3d", "2d", "3d_no_background"])
def test_dice_ce_loss_and_dice_metric_match_jax(nd, background):
    rng = np.random.default_rng(nd)
    spatial = (6,) * nd
    logits = (3 * rng.normal(size=(2, 4) + spatial)).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 1) + spatial)
    labels[1][labels[1] == 2] = 0  # a class absent from one sample
    want = jax_metrics.dice_ce_loss(jnp.asarray(logits), jnp.asarray(labels), 4,
                                    include_background=background)
    got = metrics.dice_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), 4,
                               include_background=background)
    assert abs(got.item() - float(want)) <= DICE_TOL
    pred = logits.argmax(1)
    pred[0][pred[0] == 3] = 1
    for p in (pred, labels[:, 0]):  # a prediction, and the labels themselves (Dice 1)
        want = jax_metrics.dice_metric(jnp.asarray(p), jnp.asarray(labels[:, 0]), 4,
                                       include_background=not background)
        got = metrics.dice_metric(torch.from_numpy(p), torch.from_numpy(labels[:, 0]), 4,
                                  include_background=not background)
        assert abs(got.item() - float(want)) <= DICE_TOL


@pytest.mark.parametrize("shape,new_len", [((1, 32768, 24), 729), ((16, 8), 40)],
                         ids=["mae_long_to_unetr", "2d_up"])
def test_interpolate_pos_embed_1d_matches_jax(shape, new_len):
    table = _x(*shape)
    got = pos_embed.interpolate_pos_embed_1d(table, new_len)
    np.testing.assert_array_equal(got, jax_interpolate_1d(table, new_len))
    assert got.shape == shape[:-2] + (new_len, shape[-1]) and got.dtype == np.float32


def test_resolve_device_pins_tf32_off_on_a_card(monkeypatch):
    """The f32 policy holds wherever a CLI picks the card: TF32 off for cuBLAS
    and for cuDNN (whose flag is on by default)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        assert resolve_device().type == "cuda"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        assert resolve_device("cpu").type == "cpu"  # the CPU leaves the flags alone
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# ---------------------------------------------------------------- SAP and varemb
#
# SAP (a shrunk ViT, the neck and the mask head) on `load_jax_params` weights against
# the JAX model in f64, 3-D and 2-D, adaptive by the sqrt-len method or not, its
# conversion value for value with `export_torch_state` (the neck mirrored on both
# sides); `dice_b_loss` and its gradient; the variable embedding:
# `VariableMappingAttention` against flax, the ViT with `use_varemb` (several
# variables merged, out of order, adaptive, single-channel, one variable) through
# `load_jax_params`, and its build from the config that the port refused before.

from ucf_vit_tpu.models.blocks import VariableMappingAttention as JVariableMappingAttention
from ucf_vit_tpu.models.sap import SAP as JSAP
from ucf_vit_tpu_torch.models import SAP
from ucf_vit_tpu_torch.models.blocks import VariableMappingAttention

SAP_TOL = 1e-5
DICE_B_TOL = 1e-6
VARMAP_TOL = 1e-6
VAREMB_TOL = 1e-5


def _sap_case(case):
    """(JAX SAP, port SAP, input image, seq_ps) of a shrunk SAP case: adaptive
    cases take the sqrt-len image (64 tokens of 2^3 reassembled into 8^3; 16
    tokens of 2^2 into 8^2), the others the tile."""
    twoD = case.startswith("2d")
    nd = 2 if twoD else 3
    kw = dict(patch_size=2, in_chans=1, embed_dim=24, depth=2, num_heads=2, mlp_ratio=2.0,
              twoD=twoD, num_classes=4)
    rng = np.random.default_rng(5)
    ps = None
    if "adaptive" in case:
        length = 64 if nd == 3 else 16
        kw.update(img_size=(16,) * nd, adaptive_patching=True, fixed_length=length,
                  use_adaptive_pos_emb=True, sqrt_len_method=True)
        x = rng.normal(size=(2, 1) + (8,) * nd).astype(np.float32)
        ps = np.concatenate([rng.integers(2, 9, size=(2, length, 1)),
                             rng.uniform(0, 16, size=(2, length, nd))], -1).astype(np.float32)
    else:
        kw.update(img_size=(8,) * nd if nd == 3 else (12, 16), patch_size=4 if twoD else 2)
        x = rng.normal(size=(2, 1) + tuple(kw["img_size"])).astype(np.float32)
    return (JSAP(attn_impl=JAttnImpl.EINSUM, class_token=False, **kw),
            SAP(attn_impl="FLASH", **kw), x, ps)


@pytest.mark.parametrize("case", ["3d_adaptive", "2d_adaptive", "3d", "2d"])
def test_sap_matches_flax(case):
    jmod, ours, x, ps = _sap_case(case)
    params = _params(jmod, jnp.asarray(x), None, _j(ps))
    exported, converted = export_torch_state(params), jax_to_torch_state(params)
    assert sorted(converted) == sorted(exported) == sorted(ours.state_dict())
    for k in exported:  # value for value: the neck's kernel mirrored on both sides
        np.testing.assert_array_equal(converted[k], exported[k], err_msg=k)
    assert "neck.0.weight" in exported and "mask_header.0.bias" in exported
    load_jax_params(ours, params).eval()
    want = _jax_f64(lambda p, *a: jmod.apply({"params": p}, a[0], None, *a[1:]), params, x, ps)
    with torch.inference_mode():
        got = ours(torch.from_numpy(x), seq_ps=_t(ps))
    assert got.shape == want.shape == (2, 4) + x.shape[2:]
    _close(got, want, SAP_TOL)


def test_sap_conversion_mirrors_the_neck():
    """The neck's kernel taken over unmirrored moves the logits far past the
    tolerance: with kernel = stride = p the blocks do not overlap, so the
    missing flip permutes each p^3 block of the output, which only a value
    comparison sees."""
    jmod, ours, x, ps = _sap_case("3d_adaptive")
    params = _params(jmod, jnp.asarray(x), None, jnp.asarray(ps))
    load_jax_params(ours, params).eval()
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), None, jnp.asarray(ps)))
    k = np.asarray(params["neck"]["kernel"])
    with torch.no_grad():
        ours.neck[0].weight.copy_(torch.from_numpy(k.transpose(3, 4, 0, 1, 2)))
        got = ours(torch.from_numpy(x), seq_ps=torch.from_numpy(ps)).numpy()
    assert np.abs(got - want).max() > 100 * SAP_TOL


@pytest.mark.parametrize("bad, match", [
    ({"class_token": True}, "class_token=False"),
    ({"patch_drop_rate": 0.5}, "set patch_drop_rate: 0"),
], ids=["class_token", "patch_drop"])
def test_sap_refuses_what_the_jax_model_asserts(bad, match):
    kw = dict(img_size=(16, 16), patch_size=4, in_chans=1, embed_dim=24, depth=1, num_heads=2)
    with pytest.raises(AssertionError, match=match):
        SAP(**kw, **bad)
    with pytest.raises(ValueError, match="sqrt-len"):
        SAP(adaptive_patching=True, fixed_length=16, **kw)


@pytest.mark.parametrize("nd", [3, 2], ids=["3d", "2d"])
@pytest.mark.parametrize("apply_sigmoid", [True, False], ids=["logits", "probabilities"])
def test_dice_b_loss_matches_jax(nd, apply_sigmoid):
    """At batch 2 with a class absent from the whole batch and another from one
    sample, so that a per-sample or per-class Dice would differ: the loss and
    its gradient within DICE_B_TOL."""
    rng = np.random.default_rng(nd)
    spatial = (5,) * nd
    logits = (2 * rng.normal(size=(2, 4) + spatial)).astype(np.float32)
    if not apply_sigmoid:  # probabilities, some at the clip's edges
        logits = np.clip(rng.uniform(-0.05, 1.05, size=logits.shape), 0, 1).astype(np.float32)
    labels = rng.integers(0, 3, size=(2,) + spatial)  # class 3 absent
    labels[1][labels[1] == 2] = 0  # class 2 absent from sample 1
    onehot = np.moveaxis(np.eye(4, dtype=np.float32)[labels], -1, 1)

    def jloss(z):
        return jax_metrics.dice_b_loss(z, jnp.asarray(onehot), apply_sigmoid=apply_sigmoid)

    want, wgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got = metrics.dice_b_loss(z, torch.from_numpy(onehot), apply_sigmoid=apply_sigmoid)
    got.backward()
    assert got.dtype == torch.float32 and abs(got.item() - float(want)) <= DICE_B_TOL
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(wgrad), atol=DICE_B_TOL, rtol=0)
    # a per-sample Dice would be another number here
    per = metrics.dice_b_loss(z[:1], torch.from_numpy(onehot[:1]), apply_sigmoid=apply_sigmoid)
    assert abs(per.item() - got.item()) > 10 * DICE_B_TOL


@pytest.mark.parametrize("n_a, n_i, heads", [(1, 3, 4), (2, 5, 2)], ids=["1x3", "2x5"])
def test_variable_mapping_attention_matches_flax(n_a, n_i, heads):
    q, x = _x(6, n_a, 32), _x(6, n_i, 32, seed=2)
    jmod = JVariableMappingAttention(dim=32, num_heads=heads)
    params = _params(jmod, jnp.asarray(q), jnp.asarray(x))
    holder = torch.nn.Module()
    holder.var_agg = VariableMappingAttention(32, heads)
    load_jax_params(holder, {"var_agg": params})
    assert sorted(holder.state_dict()) == ["var_agg.kv.weight", "var_agg.proj.bias",
                                           "var_agg.proj.weight", "var_agg.q.weight"]
    with torch.no_grad():
        got = holder.var_agg(torch.from_numpy(q), torch.from_numpy(x))
    _close(got, jmod.apply({"params": params}, jnp.asarray(q), jnp.asarray(x)), VARMAP_TOL)


VAREMB_CASES = {  # VIT keywords, input channels, var_ids
    "multi": (dict(), 3, (0, 1, 2)),
    "multi_out_of_order": (dict(), 2, (2, 0)),
    "adaptive_multi": (dict(adaptive_patching=True, fixed_length=16,
                            use_adaptive_pos_emb=True), 3, (0, 1, 2)),
    "single_channel": (dict(single_channel=True), 1, (1,)),
    "single_channel_adaptive": (dict(single_channel=True, adaptive_patching=True,
                                     fixed_length=16), 1, (2,)),
    "one_variable": (dict(default_vars=("ct",)), 1, (0,)),
}


def _varemb_inputs(kw, channels, seed=1):
    """(x, seq_ps): the image `[2, C, 32, 32]`, or adaptive the sequence `[2, C,
    16, 64]` and its descriptors."""
    rng = np.random.default_rng(seed)
    if not kw.get("adaptive_patching"):
        return rng.normal(size=(2, channels, 32, 32)).astype(np.float32), None
    x = rng.normal(size=(2, channels, 16, 64)).astype(np.float32)
    ps = np.concatenate([rng.integers(2, 9, size=(2, 16, 1)),
                         rng.uniform(0, 32, size=(2, 16, 2))], -1).astype(np.float32)
    return x, (ps if kw.get("use_adaptive_pos_emb") else None)


def _merge(a, b):
    """The union of two flax trees, `a`'s leaf where both hold one."""
    out = dict(b)
    for k, v in a.items():
        out[k] = _merge(v, b[k]) if isinstance(v, dict) and k in b else v
    return out


def _varemb_params(jmod, kw, ps):
    """The flax tree of every variable's embed: flax creates a submodule's
    parameters only where init calls it, so init runs on every variable (at
    once, or one at a time for a single-channel model) and the trees merge."""
    n = len(kw["default_vars"])
    sets = [(v,) for v in range(n)] if kw.get("single_channel") else [tuple(range(n))]
    params = {}
    for ids in sets:
        x, _ = _varemb_inputs(kw, len(ids))
        params = _merge(params, _params(jmod, jnp.asarray(x), ids, _j(ps)))
    return params


@pytest.mark.parametrize("case", sorted(VAREMB_CASES))
def test_varemb_vit_logits_match_flax(case):
    extra, channels, var_ids = VAREMB_CASES[case]
    kw = dict(img_size=(32, 32), patch_size=8, in_chans=channels, num_classes=5, embed_dim=32,
              depth=2, num_heads=4, use_varemb=True, default_vars=("red", "green", "blue"))
    kw.update(extra)
    x, ps = _varemb_inputs(kw, channels)
    jmod = JVIT(attn_impl=JAttnImpl.EINSUM, **kw)
    params = _varemb_params(jmod, kw, ps)
    ours = VIT(attn_impl="FLASH", **kw)
    exported, converted = export_torch_state(params), jax_to_torch_state(params)
    assert sorted(converted) == sorted(exported) == sorted(ours.state_dict())
    for k in exported:
        np.testing.assert_array_equal(converted[k], exported[k], err_msg=k)
    merged = len(kw["default_vars"]) > 1 and not kw.get("single_channel")
    assert ("var_agg.kv.weight" in exported) == merged == ("var_query" in exported)
    load_jax_params(ours, params).eval()
    with torch.inference_mode():
        got = ours(torch.from_numpy(x), seq_ps=_t(ps), var_ids=var_ids)
    _close(got, jmod.apply({"params": params}, jnp.asarray(x), var_ids, _j(ps)), VAREMB_TOL)


def _jax_example_variables(cfg):
    """The variables of the JAX package's example batch for `cfg`."""
    return next(jax_synthetic_batches(cfg, 1))["variables"]


@pytest.mark.parametrize("init", [
    {"adaptive_patching": True, "fixed_length": 16, "use_varemb": True, "single_channel": True},
    {"use_varemb": True},
], ids=["adaptive_single_channel", "multi"])
def test_build_classification_with_varemb_matches_jax(init):
    """The configs the port refused before: built from the config, their
    state names the JAX model's and their logits the JAX ones on the example
    batch's variables, `var_embed` initialised from the 1-D sincos table."""
    cfg = _small_cfg(**init)
    if init.get("single_channel"):
        cfg.raw["data"].update(single_channel=True, num_channels_used={"d": 1})
    jmod, _ = jax_build_classification(cfg)
    model = build_classification(cfg)
    var_ids = model.get_var_ids(_jax_example_variables(cfg))
    x, ps = _varemb_inputs(init, cfg.max_channels)
    params = _varemb_params(jmod, dict(init, default_vars=cfg.default_vars), ps)
    load_jax_params(model, params).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x), seq_ps=_t(ps), var_ids=var_ids)
    _close(got, jmod.apply({"params": params}, jnp.asarray(x), var_ids, _j(ps)), VAREMB_TOL)
    fresh = build_classification(cfg).init_weights(torch.Generator().manual_seed(0))
    table = jax_pos_embed.get_1d_sincos_pos_embed_from_grid(32, np.arange(3))
    np.testing.assert_allclose(fresh.var_embed[0].detach().numpy(), table, atol=1e-7)


# ---------------------------------------------------------------- adaptive DiffusionVIT
#
# The JAX DiffusionVIT with adaptive patching (the model alone: no config or JAX task
# runs it), in both forms: the serialized sequence through LinearTokenEmbed with the
# decoder's position table drawn, and the sqrt-len method's reassembled image with the
# decoder's sincos table; the noise prediction through `load_jax_params` within 1e-5 of
# flax, and the conversion key for key and value for value with `export_torch_state`.

from ucf_vit_tpu.models.diffusion import DiffusionVIT as JDiffusionVIT
from ucf_vit_tpu_torch.models.diffusion import DiffusionVIT

ADAPTIVE_DIFF_TOL = 1e-5
ADAPTIVE_DIFF_KW = dict(in_chans=3, patch_size=4, fixed_length=16, embed_dim=24, depth=2,
                        num_heads=2, decoder_embed_dim=16, decoder_depth=2,
                        decoder_num_heads=2, mlp_ratio_decoder=2.0, mlp_ratio=2.0,
                        time_steps=20, class_token=False, adaptive_patching=True,
                        use_adaptive_pos_emb=True)


@pytest.mark.parametrize("form", ["tokens", "sqrt_len"])
def test_adaptive_diffusion_vit_matches_flax(form):
    """The prediction `[B, L, p^2 * C]` of 16 adaptive tokens at two time steps
    against flax; the port's own init: the decoder's table drawn 0.02 * N(0, 1)
    for tokens, the sincos table of the 4 x 4 patch grid for the sqrt-len image."""
    seq, ps = _adaptive_inputs(2, 3, 16, 4)
    if form == "tokens":
        kw, x = dict(img_size=(32, 32)), seq
    else:  # 16 tokens of 4^2 reassembled into a 16^2 image: a 4 x 4 grid, as sqrt_len 4
        kw, x = dict(img_size=(16, 16), sqrt_len_method=True), _x(2, 3, 16, 16)
    t = np.array([3, 17], np.int32)
    jmod = JDiffusionVIT(attn_impl=JAttnImpl.EINSUM, **ADAPTIVE_DIFF_KW, **kw)
    params = _params(jmod, jnp.asarray(x), jnp.asarray(t), None, jnp.asarray(ps))
    want = export_torch_state(params)
    assert sorted(jax_to_torch_state(params)) == sorted(want)
    ours = load_jax_params(DiffusionVIT(attn_impl="FLASH", **ADAPTIVE_DIFF_KW, **kw),
                           params).eval()
    got = ours.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    with torch.inference_mode():
        out = ours(torch.from_numpy(x), torch.from_numpy(t).long(), seq_ps=torch.from_numpy(ps))
    assert out.shape == (2, 16, 4 * 4 * 3)
    _close(out, jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), None,
                           jnp.asarray(ps)), ADAPTIVE_DIFF_TOL)

    fresh = DiffusionVIT(**ADAPTIVE_DIFF_KW, **kw).init_weights(torch.Generator().manual_seed(0))
    table = fresh.decoder_pos_embed[0].detach().numpy()
    if form == "tokens":
        assert table.shape == (16, 16) and abs(table.std() - 0.02) < 0.005
    else:
        np.testing.assert_allclose(table, jax_pos_embed.get_2d_sincos_pos_embed(16, 4, 4),
                                   atol=1e-7)
