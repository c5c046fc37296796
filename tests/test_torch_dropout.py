"""The port's attention-dropout hash, its flash forward with dropout and the
gradients of `FlashAttentionFn` against the JAX package, on the CPU at small
sizes: the hash bit for bit, the forward and the gradients against the
Pallas kernels in interpret mode. Inputs come from numpy seeds.

Then, in a section of its own, the port's data and tensor parallelism on the
CPU over gloo, and its sharded evaluation, generation and serving (see the
section's comment).

The CUDA kernels run only on the card: see tests/test_torch_flash_cuda.py."""

import copy
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # xdist's workers share the cores: one torch
    torch.set_num_threads(1)  # thread each keeps them from oversubscribing the machine

import _torch_sharded
from ucf_vit_tpu.config import Config as JConfig
from ucf_vit_tpu.models.ddpm import ddpm_schedule as jax_ddpm_schedule
from ucf_vit_tpu.models.ddpm import q_sample as jax_q_sample
from ucf_vit_tpu.ops import attn_dropout as jax_dropout
from ucf_vit_tpu.ops.attention import multi_head_attention as jax_mha
from ucf_vit_tpu.ops.attn_dropout import seed_from_key
from ucf_vit_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ucf_vit_tpu.ops.patchify import patchify as jpatchify
from ucf_vit_tpu.ops.patchify import unpatchify as junpatchify
from ucf_vit_tpu.parallel import make_mesh as jax_make_mesh
from ucf_vit_tpu.parallel.mesh import mesh_context as jax_mesh_context
from ucf_vit_tpu.parallel.mesh import shard_batch as jax_shard_batch
from ucf_vit_tpu.parallel.train_step import create_sharded_train_state
from ucf_vit_tpu.parallel.train_step import make_train_step as jax_make_train_step
from ucf_vit_tpu.tasks import _seq_ps as jax_seq_ps
from ucf_vit_tpu.tasks import build_task as jax_build_task
from ucf_vit_tpu.tasks import reassemble_sqrt_len as jax_reassemble
from ucf_vit_tpu.tools.convert_checkpoint import export_torch_state
from ucf_vit_tpu.tools.convert_checkpoint import main as convert_main
from ucf_vit_tpu.utils import metrics as jax_metrics
from ucf_vit_tpu.utils import optim as jax_optim
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.convert import jax_to_torch_state
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
from ucf_vit_tpu_torch.train import main as train_main
from ucf_vit_tpu_torch.train import synthetic_batches

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


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_dropout_under_a_sequence_split_keeps_its_slice_of_the_whole_draw(rank):
    """Inside a block stack split over sp ranks (`sequence_context`), Dropout
    draws the mask of the whole sequence from its generator and keeps this
    rank's tokens: what one device drops there, from the same generator state."""
    from ucf_vit_tpu_torch.parallel.mesh import SeqShard, sequence_context

    x = torch.randn(2, 12, 5, generator=torch.Generator().manual_seed(0))
    drop = Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(3)
    whole = drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    with sequence_context(SeqShard(group=None, size=3, rank=rank)):
        part = drop(x[:, 4 * rank:4 * (rank + 1)])
    assert torch.equal(part, whole[:, 4 * rank:4 * (rank + 1)])


# ================================================================ sharding
#
# The port's data and tensor parallelism on the CPU over gloo: the sharded
# train step against the JAX package's on the 8-virtual-CPU mesh at the same
# mesh shape, from the same weights and on the same global batches, and the
# port's gathered parameters against its own single-device run. The port's
# ranks are processes (`tests/_torch_sharded.py`): one group of 4 and one of
# 2, each started once for this module through a FileStore, each running
# every case of its world size in order.

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARD_STEPS = 3
SHARD_LOSS_TOL = 1e-4  # per-step loss against the JAX package's sharded step (f32)
SHARD_PARAM_TOL = 1e-5  # gathered parameters against the port's single-device run,
# times each leaf's largest entry. A key bias (the k third of qkv.bias) has a gradient
# that is zero in exact arithmetic (softmax does not see it): AdamW turns the rounding
# noise of its sums into steps of lr * |g| / eps, so it is held apart, within
KEY_BIAS_TOL = 1e-6  # absolute, about lr / 1000 over the three steps
ATTN_DROP_TOL = 1e-6  # the attention's output under dropout against JAX's sharded flash
LAYOUT_LOSS_TOL = 1e-4  # a resumed epoch on another layout against the same layout's


def _shard_model_raw(task, ddp=1, fsdp=1, tp=1):
    """A tiny config of `task` on the mesh (ddp, fsdp, tp): depth 2 (UNETR 4),
    embed 32 (24 where a 3-D table wants a multiple of 6)."""
    par = {"simple_ddp_size": ddp, "fsdp_size": fsdp, "tensor_par_size": tp,
           "seq_par_size": 1}
    m = {"lr": 1e-3, "beta_1": 0.9, "beta_2": 0.95, "weight_decay": 1e-2, "warmup_steps": 2,
         "max_steps": 20, "warmup_start_lr": 1e-8, "eta_min": 1e-8}
    if task == "classification":
        ia = {"default_vars": ["red", "green", "blue"], "tile_size": [32, 32],
              "patch_size": 8, "embed_dim": 32, "depth": 2, "num_heads": 4, "mlp_ratio": 2,
              "twoD": True, "adaptive_patching": False}
        m.update(max_grad_norm=0.05)
        trainer, data = {"accum_steps": 2}, {"batch_size": 8, "num_classes": 4,
                                             "num_channels_used": {"d": 3}}
    elif task == "mae":
        ia = {"default_vars": ["ct"], "tile_size": [16, 16, 16], "patch_size": 4,
              "twoD": False, "adaptive_patching": False, "embed_dim": 24, "depth": 2,
              "num_heads": 2, "decoder_embed_dim": 18, "decoder_depth": 2,
              "decoder_num_heads": 3, "mlp_ratio_decoder": 2.0, "mlp_ratio": 2.0,
              "mask_ratio": 0.75}
        m.update(loss_fn="maskMSE")
        trainer, data = {}, {"batch_size": 4, "num_channels_used": {"ct": 1}}
    elif task == "diffusion":
        ia = {"default_vars": ["r", "g", "b"], "tile_size": [16, 16], "patch_size": 4,
              "twoD": True, "adaptive_patching": False, "embed_dim": 24, "depth": 2,
              "num_heads": 2, "decoder_embed_dim": 16, "decoder_depth": 1,
              "decoder_num_heads": 2, "mlp_ratio": 2.0, "num_time_steps": 50}
        m.update(loss_fn="MSE")
        trainer, data = {}, {"batch_size": 4, "num_channels_used": {"d": 3}}
    else:  # unetr, sap: the shipped basic_ct config, shrunk
        with open(os.path.join(REPO, "configs", "basic_ct", task, "base_config.yaml")) as f:
            raw = yaml.safe_load(f)
        raw["model"]["net"]["init_args"].update(
            tile_size=[16, 16, 16], patch_size=2, fixed_length=64, embed_dim=24,
            depth=4 if task == "unetr" else 2, num_heads=2, feature_size=4)
        raw["model"].update({k: v for k, v in m.items()})
        raw["trainer"].update(attn_impl="EINSUM", max_epochs=1)
        raw["parallelism"] = par
        raw["data"]["batch_size"] = 2 // (ddp * fsdp)
        return raw
    m["net"] = {"init_args": ia}
    data["batch_size"] //= ddp * fsdp  # per data rank
    return {"trainer": {"task": task, "attn_impl": "EINSUM", **trainer}, "parallelism": par,
            "model": m, "data": data}


SHARD_CASES = {  # name: (task, (ddp, fsdp, tp))
    "classification_4_1_1": ("classification", (4, 1, 1)),
    "classification_2_2_1": ("classification", (2, 2, 1)),
    "classification_1_2_2": ("classification", (1, 2, 2)),
    "classification_1_1_4": ("classification", (1, 1, 4)),
    "mae_1_2_2": ("mae", (1, 2, 2)),
    "diffusion_1_2_2": ("diffusion", (1, 2, 2)),
    "unetr_1_2_2": ("unetr", (1, 2, 2)),
    "sap_1_2_2": ("sap", (1, 2, 2)),
    "sap_2_1_1": ("sap", (2, 1, 1)),
}
_PORT_LOSS = {"mae": "mae_noise", "diffusion": "diffusion_te"}


def _shard_batches(task, raw, steps=SHARD_STEPS):
    """The global batches (numpy), with MAE's mask noise and diffusion's (t, e)."""
    cfg = Config(raw=raw, task=task)
    b = raw["data"]["batch_size"] * cfg.data_par_size
    out = []
    for i, batch in zip(range(steps), synthetic_batches(cfg, b)):
        batch = {k: v for k, v in batch.items() if k != "variables"}
        if task == "mae":
            batch["mask_noise"] = np.random.default_rng(10 + i).uniform(
                size=(b, 64)).astype(np.float32)
        elif task == "diffusion":
            batch["t"] = np.random.default_rng(10 + i).integers(0, 50, size=(b,))
            batch["e"] = np.random.default_rng(20 + i).normal(
                size=batch["x"].shape).astype(np.float32)
        out.append(batch)
    return out


def _jax_init_fn(task, jmod, batch, sqrt_len=4):
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(0)
    if task == "classification":
        return lambda: jmod.init(key, b["x"])
    if task == "mae":
        return lambda: jmod.init(key, b["x"], mask_noise=b["mask_noise"])
    if task == "diffusion":
        return lambda: jmod.init(key, b["x"], jnp.zeros(b["x"].shape[0], jnp.int32))
    if task == "unetr" and "seq" not in b:
        return lambda: jmod.init(key, b["x"])
    img = jax_reassemble(b["seq"], sqrt_len, 2, False)
    if task == "unetr":
        return lambda: jmod.init(key, b["x"], None, jax_seq_ps(b), img)
    return lambda: jmod.init(key, img, None, jax_seq_ps(b))


def _jax_loss(task, jmod, jloss, raw):
    """The JAX loss, taking MAE's noise and diffusion's (t, e) from the batch."""
    ia = raw["model"]["net"]["init_args"]
    if task == "mae":
        def mae_loss(params, batch, rng):
            pred, mask = jmod.apply({"params": params}, batch["x"], deterministic=False,
                                    mask_noise=batch["mask_noise"], rngs={"dropout": rng})
            return jax_metrics.masked_mse(pred, jpatchify(batch["x"], 4, False), mask), {}
        return mae_loss
    if task == "diffusion":
        def diff_loss(params, batch, rng):
            x0 = batch["x"]
            xt = jax_q_sample(jax_ddpm_schedule(ia["num_time_steps"]), x0, batch["t"],
                              batch["e"])
            pred = jmod.apply({"params": params}, xt, batch["t"], deterministic=True)
            return jax_metrics.mse(junpatchify(pred, x0.shape, 4, True), batch["e"]), {}
        return diff_loss
    return jloss


def _jax_tx(raw, params):
    m = raw["model"]
    return jax_optim.configure_optimizer(
        params, lr=m["lr"], beta_1=m["beta_1"], beta_2=m["beta_2"],
        weight_decay=m["weight_decay"], warmup_steps=m["warmup_steps"],
        max_steps=m["max_steps"], warmup_start_lr=m["warmup_start_lr"], eta_min=m["eta_min"],
        max_grad_norm=m.get("max_grad_norm"))


def _jax_sharded_run(name):
    """The JAX package's three steps on the case's mesh: (its init as whole
    torch-layout weights, the per-step losses, the config, the batches)."""
    task, (ddp, fsdp, tp) = SHARD_CASES[name]
    raw = _shard_model_raw(task, ddp, fsdp, tp)
    init, losses, batches = _jax_steps(task, raw, (ddp, fsdp, 1, tp))
    return init, losses, raw, batches


def _jax_steps(task, raw, shape, steps=SHARD_STEPS):
    """The JAX package's `steps` steps of `raw` on the mesh (ddp, fsdp, sp, tp):
    (its init as whole torch-layout weights, the per-step losses, the
    batches)."""
    batches = _shard_batches(task, raw, steps)
    jmod, jloss = jax_build_task(JConfig(raw=raw, task=task))
    mesh = jax_make_mesh(*shape)
    init_fn = _jax_init_fn(task, jmod, batches[0], Config(raw=raw, task=task).sqrt_len)
    tx = _jax_tx(raw, jax.eval_shape(init_fn)["params"])
    with jax_mesh_context(mesh):
        state, _ = create_sharded_train_state(init_fn, tx, mesh)
        init = jax_to_torch_state(jax.device_get(state.params))
        step = jax_make_train_step(_jax_loss(task, jmod, jloss, raw), tx, donate=False,
                                   accum_steps=raw["trainer"].get("accum_steps", 1))
        losses = []
        for b in batches:
            state, loss, _ = step(state, jax_shard_batch(mesh, {k: jnp.asarray(v)
                                                                for k, v in b.items()}),
                                  jax.random.key(0))
            losses.append(float(loss))
    return init, losses, batches


def _single_raw(raw):
    raw = copy.deepcopy(raw)
    n = raw["parallelism"]["simple_ddp_size"] * raw["parallelism"]["fsdp_size"]
    raw["data"]["batch_size"] *= n
    raw["parallelism"] = {}
    return raw


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """Every sharded case's JAX run (on the virtual mesh), port run (on its group)
    and port single-device run (here), and the other cases of the two groups."""
    tmp = tmp_path_factory.mktemp("sharded")
    jobs, single = {4: [], 2: []}, {}
    for name, (task, shape) in SHARD_CASES.items():
        init, jax_losses, raw, batches = _jax_sharded_run(name)
        job = {"kind": "train", "name": name, "raw": raw, "batches": batches, "init": init,
               "loss": _PORT_LOSS.get(task, "task")}
        jobs[int(np.prod(shape))].append(job)
        single[name] = _torch_sharded.train_job({**job, "raw": _single_raw(raw)})
        single[name]["jax_losses"] = jax_losses
    varemb, overflow = _varemb_job(), _overflow_job()
    jobs[2] += [varemb, overflow]
    single[overflow["name"]] = _torch_sharded.train_job({**overflow,
                                                         "raw": _single_raw(overflow["raw"])})
    single[varemb["name"]] = _torch_sharded.train_job({**varemb,
                                                       "raw": _single_raw(varemb["raw"])})
    jobs[4] += [_attn_dropout_job(), _collectives_job()] + _sync_check_jobs()
    cli_jobs, single_runs = _cli_jobs(tmp)
    jobs[2] += cli_jobs
    eval_jobs, eval_single = _eval_jobs(tmp)
    sp_jobs, sp_single = _sp_jobs(tmp)
    for world in (4, 2):
        jobs[world] += eval_jobs[world] + sp_jobs[world]
    single.update(eval_single)
    single.update(sp_single)
    out = {}
    for world in (4, 2):
        out.update(_torch_sharded.run_group(world, jobs[world], tmp))
    out.update(single_runs(out))
    return out, single, tmp


@pytest.mark.parametrize("name", sorted(SHARD_CASES))
def test_sharded_train_step_matches_jax_and_single_device(sharded_runs, name):
    """Three steps of the port on its mesh against the JAX package's sharded step
    on the same mesh shape (per-step losses within SHARD_LOSS_TOL), and the
    port's parameters gathered after them against its single-device run."""
    runs, single, _ = sharded_runs
    task, (ddp, fsdp, tp) = SHARD_CASES[name]
    got = runs[name]
    np.testing.assert_allclose(got["losses"], single[name]["jax_losses"], atol=SHARD_LOSS_TOL,
                               rtol=0)
    np.testing.assert_allclose(got["losses"], single[name]["losses"], atol=SHARD_LOSS_TOL,
                               rtol=0)
    if tp > 1:  # the tensor-parallel split reached the blocks
        assert any(n.endswith("attn.qkv.weight") for n in got["sharded"])
    if task == "unetr":
        # not for UNETR: its convolutions' biases ahead of instance norms have zero
        # gradients and others noise-level ones; AdamW's first steps take their signs,
        # and plain DDP (2, 1, 1) moves the parameters as far from the single-device
        # run as this layout does
        return
    _assert_params_match(got["params"], single[name]["params"], name)


def _assert_params_match(got, want, key):
    """Each leaf within SHARD_PARAM_TOL of its largest entry; the key third of
    a qkv bias (no gradient in exact arithmetic) within KEY_BIAS_TOL."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k.endswith("attn.qkv.bias"):
            d = w.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], w[d:2 * d], atol=KEY_BIAS_TOL, rtol=0,
                                       err_msg=f"{key}: {k}")
            g, w = np.concatenate([g[:d], g[2 * d:]]), np.concatenate([w[:d], w[2 * d:]])
        np.testing.assert_allclose(g, w, atol=SHARD_PARAM_TOL * np.abs(w).max(), rtol=0,
                                   err_msg=f"{key}: {k}")


def _varemb_job():
    """classification with `use_varemb` (three variables merged by
    VariableMappingAttention, 4 heads) in tp 2, from the port's seeded init."""
    from ucf_vit_tpu_torch.tasks import build_task as port_build_task

    raw = _shard_model_raw("classification", 1, 1, 2)
    raw["model"]["net"]["init_args"]["use_varemb"] = True
    model = port_build_task(Config(raw=_single_raw(raw), task="classification"))
    model.init_weights(torch.Generator().manual_seed(0))
    init = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return {"kind": "train", "name": "varemb_1_1_2", "raw": raw, "init": init,
            "batches": _shard_batches("classification", raw), "loss": "task"}


def test_variable_mapping_attention_splits_over_tp(sharded_runs):
    """A varemb ViT in tp 2 (the merge's q, kv and proj split by heads as the
    blocks' are) against the port's single-device run: the losses within
    SHARD_LOSS_TOL, the gathered parameters as in the sharded cases."""
    runs, single, _ = sharded_runs
    got, want = runs["varemb_1_1_2"], single["varemb_1_1_2"]
    assert {"var_agg.q.weight", "var_agg.kv.weight", "var_agg.proj.weight"} <= set(
        got["sharded"])
    np.testing.assert_allclose(got["losses"], want["losses"], atol=SHARD_LOSS_TOL, rtol=0)
    _assert_params_match(got["params"], want["params"], "varemb_1_1_2")


def _overflow_job():
    """classification in ddp 2 under loss scaling, an inf in the second data
    rank's half of the second batch."""
    from ucf_vit_tpu_torch.tasks import build_task as port_build_task

    raw = _shard_model_raw("classification", 2, 1, 1)
    raw["model"]["use_grad_scaler"] = True
    model = port_build_task(Config(raw=_single_raw(raw), task="classification"))
    model.init_weights(torch.Generator().manual_seed(0))
    batches = _shard_batches("classification", raw)
    batches[1]["x"] = batches[1]["x"].copy()
    batches[1]["x"][-1, 0, 0, 0] = np.inf
    return {"kind": "train", "name": "overflow_2_1_1", "raw": raw, "batches": batches,
            "init": {k: v.detach().numpy() for k, v in model.state_dict().items()},
            "loss": "task"}


def test_overflow_on_one_rank_skips_the_step_on_every_rank(sharded_runs):
    """Loss scaling in ddp 2 with an inf in rank 1's slice of step 2: every rank
    skips that update and halves its scale, as the single-device step does on
    the whole batch, and the run goes on as that run does."""
    runs, single, _ = sharded_runs
    got, want = runs["overflow_2_1_1"], single["overflow_2_1_1"]
    assert not np.isfinite(got["losses"][1]) and not np.isfinite(want["losses"][1])
    assert got["updates"] == want["updates"] == SHARD_STEPS - 1
    assert got["scale"] == want["scale"] == 8192.0 / 2
    np.testing.assert_allclose(got["losses"], want["losses"], atol=SHARD_LOSS_TOL, rtol=0)
    _assert_params_match(got["params"], want["params"], "overflow_2_1_1")


# ---------------------------------------------------------------- attention dropout

ATTN_SHAPE = (4, 2, 16, 8)  # [B, H, N, dh]: embed 16 in 2 heads, 16 tokens
ATTN_MESH = (2, 1, 2)  # (ddp, fsdp, tp)
ATTN_RATE = 0.25


def _attn_inputs():
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=ATTN_SHAPE).astype(np.float32) for _ in range(3))
    return q, k, v, int(seed_from_key(jax.random.key(3)))


def _attn_dropout_job():
    q, k, v, seed = _attn_inputs()
    return {"kind": "attn_dropout", "name": "attn_dropout", "q": q, "k": k, "v": v,
            "seed": seed, "rate": ATTN_RATE, "shape": ATTN_MESH}


def test_attention_dropout_under_sharding_matches_jax_sharded_flash(sharded_runs):
    """The port's EINSUM with the hash mask, its seed folded by each rank's
    (ddp, fsdp, tp) indices, on 2 x 2 ranks, against the JAX package's FLASH in
    interpret mode under `_sharded_flash` on the same mesh."""
    runs, _, _ = sharded_runs
    q, k, v, _ = _attn_inputs()
    ddp, fsdp, tp = ATTN_MESH
    mesh = jax_make_mesh(ddp, fsdp, 1, tp)
    with jax_mesh_context(mesh):
        want, kept = (np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         impl="FLASH", dropout_rate=rate,
                                         dropout_rng=jax.random.key(3)))
                      for rate in (ATTN_RATE, 0.0))
    got = np.zeros_like(want)
    b, h = ATTN_SHAPE[0] // (ddp * fsdp), ATTN_SHAPE[1] // tp
    for out, (r, t) in zip(runs["attn_dropout"]["outs"], runs["attn_dropout"]["coords"]):
        got[r * b:(r + 1) * b, t * h:(t + 1) * h] = out
    assert np.abs(want - kept).max() > 0.1  # it dropped
    np.testing.assert_allclose(got, want, atol=ATTN_DROP_TOL, rtol=0)


# ---------------------------------------------------------------- collectives

COLL_PAIRS = ("f_broadcast_b_identity", "f_identity_b_allreduce", "f_allreduce_b_identity",
              "f_identity_b_broadcast", "all_reduce", "all_gather", "reduce_scatter",
              "all_to_all")


def _coll_inputs():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 4, 3)).astype(np.float32)  # rank r's input: x[r], [4, 3]
    out_shape = {"all_gather": (16, 3), "reduce_scatter": (1, 3), "all_to_all": (1, 12)}
    w = {p: rng.normal(size=(4,) + out_shape.get(p, (4, 3))).astype(np.float32)
         for p in COLL_PAIRS}
    q = rng.normal(size=(4, 2, 4, 8, 3)).astype(np.float32)  # [B, H/sp, N, dh] a rank
    return x, w, q


def _collectives_job():
    x, w, q = _coll_inputs()
    return {"kind": "collectives", "name": "collectives", "x": x, "w": w, "q": q}


def _coll_want(pair, x, w):
    """Each rank's (output, input gradient) by the pair's definition (src 1)."""
    n = x.shape[0]
    if pair == "f_broadcast_b_identity":
        return [x[1]] * n, list(w)
    if pair == "f_identity_b_allreduce":
        return list(x), [w.sum(0)] * n
    if pair == "f_allreduce_b_identity":
        return [x.sum(0)] * n, list(w)
    if pair == "f_identity_b_broadcast":
        return list(x), [w[1]] * n
    if pair == "all_reduce":
        return [x.sum(0)] * n, [w.sum(0)] * n
    if pair == "all_gather":
        return [np.concatenate(list(x))] * n, list(np.split(w.sum(0), n))
    if pair == "reduce_scatter":
        return list(np.split(x.sum(0), n)), [np.concatenate(list(w))] * n
    # all_to_all: piece r of dim 0 from every rank, joined on dim 1
    outs = [np.concatenate([x[j][r:r + 1] for j in range(n)], axis=1) for r in range(n)]
    grads = [np.concatenate([w[j][:, 3 * r:3 * (r + 1)] for j in range(n)], axis=0)
             for r in range(n)]
    return outs, grads


@pytest.mark.parametrize("pair", COLL_PAIRS)
def test_collective_pair_forward_and_backward(sharded_runs, pair):
    """Each conjugate pair on 4 ranks, forward and backward, against its
    definition (the counterpart of `tests/test_collectives.py`)."""
    runs, _, _ = sharded_runs
    x, w, _ = _coll_inputs()
    outs, grads = runs["collectives"][pair]
    want_o, want_g = _coll_want(pair, x, w[pair])
    for r in range(4):
        np.testing.assert_allclose(outs[r], want_o[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(grads[r], want_g[r], rtol=1e-6, atol=1e-6)


def test_ulysses_swap_round_trips(sharded_runs):
    runs, _, _ = sharded_runs
    _, _, q = _coll_inputs()
    mid, back = runs["collectives"]["ulysses"]
    full = np.concatenate(list(q), axis=1)  # [B, H, N, dh]
    for r in range(4):
        np.testing.assert_array_equal(back[r], q[r])
        np.testing.assert_array_equal(mid[r], full[:, :, 2 * r:2 * (r + 1)])


# ---------------------------------------------------------------- sync check


def _sync_check_jobs():
    hybrid = _shard_model_raw("classification", 2, 1, 2)
    fsdp = _shard_model_raw("classification", 1, 4, 1)
    return [{"kind": "sync_check", "name": "sync_healthy", "raw": hybrid},
            {"kind": "sync_check", "name": "sync_corrupt", "raw": hybrid, "corrupt": 3},
            {"kind": "sync_check", "name": "sync_fsdp", "raw": fsdp}]


def test_sync_check_passes_healthy_replicas(sharded_runs):
    r = sharded_runs[0]["sync_healthy"]
    # ddp 2 x tp 2: the tp-split blocks make tp a shard axis, ddp holds the replicas
    assert r["ok"] and r["redundancy"] == ("ddp",) and r["groups"] == 2
    assert "OK" in r["describe"]


def test_sync_check_catches_and_names_a_corrupted_replica(sharded_runs):
    r = sharded_runs[0]["sync_corrupt"]
    # rank 3 (ddp 1, tp 1) changed its copy of the replicated final-norm bias
    assert r["caught"] is not None and "rank 3" in r["caught"]
    assert r["mismatches"] == [[1, 3]]


def test_sync_check_fsdp_only_has_no_redundancy(sharded_runs):
    r = sharded_runs[0]["sync_fsdp"]
    assert r["ok"] and r["redundancy"] == () and r["groups"] == 4


# ---------------------------------------------------------------- the trainer on two ranks

CLI_ITS = 3  # synthetic steps an epoch
CATSDOGS_FILES = [f"{k}.{i}.jpg" for i, k in enumerate(["cat", "dog"] * 8)]


def _cli_yaml(tmp, name, par, **trainer):
    raw = _shard_model_raw("classification")
    raw["model"].update(use_grad_scaler=True)  # every rank agrees on the overflow flag
    raw["trainer"] = {"task": "classification", "attn_impl": "EINSUM", "seed": 0,
                      "ema_decay": 0.99, "max_epochs": 1, "checkpoint_path": str(tmp / "ck"),
                      "checkpoint_filename": name, "metrics_path": str(tmp / f"{name}.jsonl"),
                      **trainer}
    raw["parallelism"] = par
    raw["data"]["batch_size"] = 8 // max(par.get("simple_ddp_size", 1) *
                                         par.get("fsdp_size", 1), 1)
    raw["load_balancing"] = {"batches_per_rank_epoch": {"d": CLI_ITS}}
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _catsdogs_yaml(tmp, name, **trainer):
    from PIL import Image

    root = tmp / "catsdogs"
    if not root.exists():
        os.makedirs(root)
        rng = np.random.default_rng(0)
        for f in CATSDOGS_FILES:
            Image.fromarray(rng.integers(0, 255, size=(20, 18, 3)).astype(np.uint8)).save(
                root / f)
    ia = {"default_vars": ["red", "green", "blue"], "tile_size": [16, 16], "patch_size": 8,
          "embed_dim": 32, "depth": 2, "num_heads": 2, "mlp_ratio": 2, "twoD": True,
          "adaptive_patching": False, "num_classes": 2}
    raw = {"trainer": {"task": "classification", "attn_impl": "EINSUM", "max_epochs": 2,
                       "seed": 0, "checkpoint_path": str(tmp / "ck"),
                       "checkpoint_filename": name, "preempt_sync_every": 1,
                       "metrics_path": str(tmp / f"{name}.jsonl"), **trainer},
           "parallelism": {"fsdp_size": 2},
           "model": {"lr": 1e-3, "beta_1": 0.9, "beta_2": 0.95, "weight_decay": 1e-2,
                     "warmup_steps": 2, "max_steps": 20, "warmup_start_lr": 1e-5,
                     "eta_min": 1e-6, "net": {"init_args": ia}},
           "data": {"dataset": "catsdogs", "dict_root_dirs": {"catsdogs": str(root)},
                    "dict_start_idx": {"catsdogs": 0}, "dict_end_idx": {"catsdogs": 1},
                    "dict_buffer_sizes": {"catsdogs": 4}, "num_channels_used": {"catsdogs": 3},
                    "dict_in_variables": {"catsdogs": ["red", "green", "blue"]},
                    "batch_size": 2, "num_classes": 2, "single_channel": False},
           "load_balancing": {"auto_load_balancing": False}}
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _f6_yaml(tmp, name, par, **trainer):
    """A NIfTI MAE (depth 2, embed 24, DropPath 0.1) on `par`, four volumes of four
    16^3 tiles each (two files a data rank in fsdp 2), a global batch of 4: four
    steps an epoch; the sync check and the preemption agreement every step."""
    from ucf_vit_tpu_torch.data import nifti

    root = tmp / "ct_f6"
    if not root.exists():
        os.makedirs(root / "imagesTr")
        rng = np.random.default_rng(0)
        for i in range(4):
            nifti.save(str(root / "imagesTr" / f"image{i}.nii"),
                       (rng.normal(size=(64, 16, 16)) * 300).astype(np.int16))
    ia = {"default_vars": ["ct"], "tile_size": [16, 16, 16], "patch_size": 4, "twoD": False,
          "adaptive_patching": False, "embed_dim": 24, "depth": 2, "num_heads": 2,
          "decoder_embed_dim": 18, "decoder_depth": 1, "decoder_num_heads": 3,
          "mlp_ratio_decoder": 2.0, "mlp_ratio": 2.0, "mask_ratio": 0.75, "drop_path": 0.1}
    data_ranks = par.get("simple_ddp_size", 1) * par.get("fsdp_size", 1)
    raw = {"trainer": {"task": "mae", "attn_impl": "EINSUM", "seed": 1, "max_epochs": 1,
                       "sync_check_every": 1, "preempt_sync_every": 1,
                       "checkpoint_path": str(tmp / "ck"),
                       "checkpoint_filename": name, "metrics_path": str(tmp / f"{name}.jsonl"),
                       **trainer},
           "parallelism": par,
           "model": {"lr": 1e-3, "warmup_steps": 1, "max_steps": 20, "loss_fn": "maskMSE",
                     "net": {"init_args": ia}},
           "data": {"dataset": "basic_ct", "dict_root_dirs": {"ct": str(root)},
                    "dict_start_idx": {"ct": 0}, "dict_end_idx": {"ct": 1},
                    "dict_buffer_sizes": {"ct": 3}, "num_channels_used": {"ct": 1},
                    "dict_in_variables": {"ct": ["ct"]}, "batch_size": 4 // data_ranks,
                    "single_channel": True, "num_workers": 1, "tile_overlap": 0.0,
                    "use_all_data": False},
           "load_balancing": {"auto_load_balancing": True}}
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _cli(name, path, *extra):
    return {"kind": "cli", "name": name, "argv": [path, "--device", "cpu", *extra]}


def _cli_jobs(tmp):
    """The two-rank trainer runs, and a function that runs the one-rank runs
    that need them (and one that they need, run first, here)."""
    fsdp2, tp2 = {"fsdp_size": 2}, {"tensor_par_size": 2}
    # 1 -> 2: one epoch on one rank, resumed on two (tp 2) and on one
    train_main([_cli_yaml(tmp, "r", {}), "--synthetic", "--device", "cpu"])
    resume = dict(resume_from_checkpoint=True, max_epochs=2)
    jobs = [
        # the CLI loop with a sharded save (fsdp 2), the sync check every step
        _cli("p", _cli_yaml(tmp, "p", fsdp2, sync_check_every=1), "--synthetic"),
        # 2 -> 2 and 1 -> 2 resumes of one more epoch
        _cli("q2", _cli_yaml(tmp, "q2", fsdp2, checkpoint_filename_for_loading="p_even",
                             **resume), "--synthetic"),
        _cli("s2", _cli_yaml(tmp, "s2", tp2, checkpoint_filename_for_loading="r_even",
                             **resume), "--synthetic"),
        # mid-epoch: uninterrupted; preempted after step 2; resumed in place
        _cli("u", _catsdogs_yaml(tmp, "u")),
        _cli("v", _catsdogs_yaml(tmp, "v", preempt_after_steps=2)),
        _cli("w", _catsdogs_yaml(tmp, "w", checkpoint_filename="v", resume_from_checkpoint=True,
                                 checkpoint_filename_for_loading="v_latest")),
        # mid-epoch in fsdp 2 (two data ranks), resumed in tp 2 (one)
        _cli("f6_fsdp", _f6_yaml(tmp, "f6_fsdp", fsdp2, preempt_after_steps=2)),
        {**_cli("f6_tp", _f6_yaml(tmp, "f6_tp", tp2, resume_from_checkpoint=True,
                                  checkpoint_filename_for_loading="f6_fsdp_latest")),
         "kind": "cli_ranks", "leaves": ["norm.weight", "blocks.1.norm1.weight"]},
    ]

    def single_runs(runs):
        out = {}
        for name, slot in (("q1", "p_even"), ("s1", "r_even")):
            out[name] = train_main([_cli_yaml(tmp, name, {}, checkpoint_filename_for_loading=slot,
                                              **resume), "--synthetic", "--device", "cpu"])
        return out

    return jobs, single_runs


def _step_losses(path):
    recs = [json.loads(line) for line in open(path)]
    return {r["step"]: r["loss"] for r in recs if "loss" in r and "step" in r}


def test_cli_trains_two_ranks_with_a_sharded_save_and_the_sync_check(sharded_runs):
    runs, _, tmp = sharded_runs
    assert runs["p"]["step"] == CLI_ITS and len(runs["p"]["loss_list"]) == 1
    recs = [json.loads(line) for line in open(tmp / "p.jsonl")]
    assert recs[0]["run_start"] and recs[0]["num_procs"] == 2
    checks = [r for r in recs if "sync_check" in r]
    assert [r["step"] for r in checks] == [1, 2, 3]
    assert all("OK" in r["sync_check"] for r in checks)
    payload = torch.load(tmp / "ck" / "p_even.ckpt", weights_only=True)
    assert payload["num_procs"] == 2 and len(payload["generators"]["device_by_rank"]) == 2


@pytest.mark.parametrize("way", ["2_to_1", "1_to_2"])
def test_resume_on_another_layout_matches_the_same_layout(sharded_runs, way):
    """An epoch resumed from a two-rank (fsdp 2) checkpoint on one rank, and from a
    one-rank checkpoint on two (tp 2), against the same epoch resumed on the
    layout that wrote it: the per-step losses within LAYOUT_LOSS_TOL."""
    _, _, tmp = sharded_runs
    other, same = ("q1", "q2") if way == "2_to_1" else ("s2", "s1")
    a, b = _step_losses(tmp / f"{other}.jsonl"), _step_losses(tmp / f"{same}.jsonl")
    assert sorted(a) == sorted(b) == [CLI_ITS + 1, CLI_ITS + 2, CLI_ITS + 3]
    np.testing.assert_allclose([a[k] for k in sorted(a)], [b[k] for k in sorted(b)],
                               atol=LAYOUT_LOSS_TOL, rtol=0)


def test_midepoch_resume_on_two_ranks_is_bit_for_bit(sharded_runs):
    """Two ranks (fsdp 2) on catsdogs files: preempted after step 2 of epoch 0
    (every rank agrees on the step) and resumed in place, against the run that
    was not interrupted: every step's loss equal."""
    runs, _, tmp = sharded_runs
    full, resumed = _step_losses(tmp / "u.jsonl"), _step_losses(tmp / "w.jsonl")
    first = _step_losses(tmp / "v.jsonl")
    assert sorted(first) == [1, 2] and len(full) == 8  # 16 files, a global batch of 4
    assert sorted(resumed) == list(range(3, 9))
    assert {**first, **resumed} == full


def test_midepoch_resume_on_another_data_layout_reruns_the_epoch(sharded_runs):
    """A NIfTI MAE with DropPath preempted mid-epoch in fsdp 2 (two data ranks)
    and resumed in tp 2 (one data rank, both ranks on the same files): the
    resume re-runs the epoch from its start rather than fast-forwarding through
    another data layout's stream, and the two tp ranks take data rank 0's
    device generator, so they draw the same masks and their replicated
    parameters stay equal, as the sync check every step finds."""
    runs, _, tmp = sharded_runs
    first = _step_losses(tmp / "f6_fsdp.jsonl")
    payload = torch.load(tmp / "ck" / "f6_fsdp_even.ckpt", weights_only=True)
    assert sorted(first) == [1, 2] and payload["data_it"] == 2 and payload["data_size"] == 2
    assert len(payload["generators"]["device_by_data_rank"]) == 2
    recs = [json.loads(line) for line in open(tmp / "f6_tp.jsonl")]
    assert recs[0]["run_start"] and recs[0]["resume_it"] == 0 and recs[0]["num_procs"] == 2
    steps = [r for r in recs if "loss" in r and "step" in r]
    assert [(r["epoch"], r["it"], r["step"]) for r in steps] == [(0, i, 2 + i)
                                                                 for i in range(1, 5)]
    checks = [r for r in recs if "sync_check" in r]
    assert len(checks) == len(steps) and all("OK" in r["sync_check"] for r in checks)
    ranks = runs["f6_tp"]["ranks"]
    for k in ("generator", "norm.weight", "blocks.1.norm1.weight"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_sharded_checkpoint_converts_with_to_jax_key_for_key(sharded_runs, tmp_path):
    """The fsdp-2 run's checkpoint through `convert_checkpoint to-jax`: the
    JAX tree exported back (`export_torch_state`) equals the file's
    `model_state_dict` key for key."""
    _, _, tmp = sharded_runs
    src = tmp / "ck" / "p_even.ckpt"
    assert convert_main(["to-jax", str(src), str(tmp / "p.yaml"), str(tmp_path / "jax"),
                         "--filename", "conv"]) == 0
    from ucf_vit_tpu import checkpoint as jax_ckpt

    payload = jax_ckpt.restore_checkpoint(str(tmp_path / "jax"), "conv_latest")
    back = export_torch_state(payload["state"]["params"])
    sd = torch.load(src, weights_only=True)["model_state_dict"]
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v.numpy(), err_msg=k)


def test_sigterm_to_one_rank_saves_once_and_both_exit_0(tmp_path):
    """SIGTERM to rank 0 alone of a two-rank run, on a step's log line: the ranks
    agree at the next step, save one checkpoint together and exit 0."""
    path = _cli_yaml(tmp_path, "sig", {"fsdp_size": 2}, preempt_sync_every=1, max_epochs=1)
    raw = yaml.safe_load(open(path))
    raw["load_balancing"] = {"batches_per_rank_epoch": {"d": 10000}}  # a long epoch
    open(path, "w").write(yaml.safe_dump(raw))
    store = str(tmp_path / "store")
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_sharded.py"), store, str(r), "2",
         path, "--synthetic", "--device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        lines, deadline = [], time.time() + 300
        for line in procs[0].stdout:
            lines.append(line)
            if "epoch 0 it 2 loss" in line:
                procs[0].send_signal(signal.SIGTERM)
                break
            assert time.time() < deadline, "".join(lines)
        rest0 = procs[0].communicate(timeout=300)[0]
        rest1 = procs[1].communicate(timeout=300)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out0 = "".join(lines) + rest0
    assert procs[0].returncode == 0 and procs[1].returncode == 0, out0 + rest1
    assert out0.count("preempted in epoch 0 after") == 1, out0
    assert sorted(os.listdir(tmp_path / "ck")) == ["sig_even.ckpt"]
    payload = torch.load(tmp_path / "ck" / "sig_even.ckpt", weights_only=True)
    assert payload["num_procs"] == 2 and 2 <= payload["data_it"] < 10000


# ---------------------------------------------------------------- sharded evaluation and serving
#
# The port's counterparts of tests/test_eval_mesh.py's six cases, each against the
# port's own single-device run at that file's tolerance: classification top-1 in
# (fsdp 2, tp 2), SAP Dice in ddp 2, the reverse chain in ddp 4, the generator in
# (ddp 2, fsdp 2), `build_predictor` in (ddp 2, tp 2), the fallback of one process;
# the sharded top-1 against the JAX package's sharded `evaluate_classification` on the
# same checkpoint and mesh shape; a two-rank server driven over HTTP. The ranks run as
# jobs of the module's two groups (`tests/_torch_sharded.py`).

EVAL_TOP1_TOL = 1e-6
EVAL_DICE_TOL = 1e-5
EVAL_CHAIN_TOL = 1e-5
EVAL_SERVE_TOL = 2e-5
EVAL_MESHES = {  # name: (task, (ddp, fsdp, tp))
    "eval_top1": ("classification", (1, 2, 2)),
    "eval_dice": ("sap", (2, 1, 1)),
    "eval_chain": ("diffusion", (4, 1, 1)),
    "eval_generator": ("diffusion", (2, 2, 1)),
    "eval_predictor": ("classification", (2, 1, 2)),
    "eval_jax_top1": ("classification", (1, 2, 2)),
    "eval_http": ("classification", (1, 1, 2)),
}


def _eval_raw(task, ddp=1, fsdp=1, tp=1):
    """A tiny config of `task` for evaluation: depth 2, embed 32 (24 for SAP and
    diffusion), `data.batch_size` the global batch (4), a diffusion chain of 3
    steps, on the mesh (ddp, fsdp, tp) (no `parallelism:` for one device)."""
    raw = copy.deepcopy(_shard_model_raw(task, ddp, fsdp, tp))
    if task == "classification":
        raw["data"].update(batch_size=4, num_classes=3)
    elif task == "diffusion":
        raw["data"]["batch_size"] = 4
        raw["model"]["net"]["init_args"]["num_time_steps"] = 3
    if ddp * fsdp * tp == 1:
        raw["parallelism"] = {}
    return raw


def _eval_checkpoint(tmp):
    """The classification model's seeded init plus N(0, 0.05) noise (so that no
    logits tie), as a weights-only checkpoint file, and its `to-jax` conversion."""
    from ucf_vit_tpu_torch.tasks import build_task as port_build_task

    raw = _eval_raw("classification")
    model = port_build_task(Config(raw=raw, task="classification"))
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    sd = {k: v + torch.from_numpy(0.05 * rng.normal(size=tuple(v.shape)).astype(np.float32))
          for k, v in model.state_dict().items()}
    path = tmp / "eval_noisy.ckpt"
    torch.save({"epoch": 3, "model_state_dict": sd, "loss_list": []}, path)
    cfg_path = tmp / "eval_cls.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    assert convert_main(["to-jax", str(path), str(cfg_path), str(tmp / "eval_jax"), "--filename",
                         "conv"]) == 0
    return str(path)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


HTTP_INPUTS = 8


def _eval_jobs(tmp):
    """The evaluation jobs of the two groups, and the single-device runs they are
    held against (run here)."""
    from ucf_vit_tpu_torch.inference import evaluate, evaluate_classification
    from ucf_vit_tpu_torch.inference import generate_diffusion

    ck = _eval_checkpoint(tmp)
    raws = {n: _eval_raw(task, *shape) for n, (task, shape) in EVAL_MESHES.items()}
    cls_batch = {k: v for k, v in synthetic_batches(
        Config(raw=raws["eval_predictor"], task="classification"), 4).__next__().items()
        if k == "x"}
    http_raw = raws["eval_http"]
    http_path = tmp / "eval_http.yaml"
    http_path.write_text(yaml.safe_dump(http_raw))
    inputs = np.random.default_rng(9).normal(size=(HTTP_INPUTS, 3, 32, 32)).astype(np.float32)
    phases = [("lone", [0, 1]), ("concurrent", [2, 3, 4, 5, 6]), ("reload", ck),
              ("lone", [7])]
    jobs = {
        4: [{"kind": "eval", "name": "eval_top1", "raw": raws["eval_top1"],
             "fn": "evaluate_classification", "args": (None, True, 8)},
            {"kind": "eval", "name": "eval_jax_top1", "raw": raws["eval_jax_top1"],
             "fn": "evaluate_classification", "args": (ck, True, 12)},
            {"kind": "eval", "name": "eval_chain", "raw": raws["eval_chain"],
             "fn": "generate_diffusion", "args": (None, 4),
             "kwargs": {"return_images": True}},
            {"kind": "generator", "name": "eval_generator", "raw": raws["eval_generator"],
             "num_samples": 4, "seed": 3},
            {"kind": "predictor", "name": "eval_predictor", "raw": raws["eval_predictor"],
             "max_batch": 4, "batch": cls_batch}],
        2: [{"kind": "eval", "name": "eval_dice", "raw": raws["eval_dice"], "fn": "evaluate",
             "args": (None, None, True, 2), "kwargs": {"batch_size": 2}},
            {"kind": "serve", "name": "eval_http", "path": str(http_path), "port": _free_port(),
             "max_batch": 4, "inputs": inputs, "phases": phases}],
    }

    def one(name):
        task = EVAL_MESHES[name][0]
        return Config(raw=_eval_raw(task), task=task)

    from ucf_vit_tpu_torch.inference import init_eval_model
    from ucf_vit_tpu_torch.serve import build_generator, build_predictor

    run_batch, _, _, (_, _, reload) = build_predictor(one("eval_http"), max_batch=4,
                                                      device="cpu")
    lone = []
    for i in range(HTTP_INPUTS):
        if i == 7:
            reload(ck)
        lone.append(run_batch({"x": np.repeat(inputs[i:i + 1], 4, 0)}).numpy()[0])
    single = {
        "eval_top1": evaluate_classification(one("eval_top1"), None, True, 8, device="cpu"),
        "eval_jax_top1": evaluate_classification(one("eval_jax_top1"), ck, True, 12,
                                                 device="cpu"),
        "eval_dice": evaluate(one("eval_dice"), None, None, True, 2, batch_size=2,
                              device="cpu"),
        "eval_chain": generate_diffusion(one("eval_chain"), None, 4, return_images=True,
                                         device="cpu")[1],
        "eval_generator": build_generator(one("eval_generator"), init_eval_model(
            one("eval_generator"), device="cpu"), 4)(3),
        "eval_predictor": build_predictor(one("eval_predictor"), max_batch=4,
                                          device="cpu")[0](cls_batch).numpy(),
        "eval_http": np.stack(lone),
    }
    return jobs, single


def test_sharded_classification_eval_matches_single_device(sharded_runs):
    """`evaluate_classification` in (fsdp 2, tp 2) against one device: the same
    top-1 over the same 8 synthetic samples (`test_eval_mesh.py`'s first case)."""
    runs, single, _ = sharded_runs
    got, want = runs["eval_top1"], single["eval_top1"]
    assert np.isfinite(got) and np.isfinite(want)
    assert abs(got - want) <= EVAL_TOP1_TOL, (got, want)


def test_sharded_sap_dice_matches_single_device(sharded_runs):
    """SAP's Dice (`evaluate`, 2 batches of 2) in ddp 2 against one device."""
    runs, single, _ = sharded_runs
    got, want = runs["eval_dice"], single["eval_dice"]
    assert np.isfinite(got) and np.isfinite(want)
    assert abs(got - want) <= EVAL_DICE_TOL, (got, want)


def test_sharded_reverse_chain_matches_single_device(sharded_runs):
    """`generate_diffusion` in ddp 4 (one row a rank) against one device at the
    same seed: the draws are of the whole batch on every rank, so the images
    agree."""
    runs, single, _ = sharded_runs
    got, want = runs["eval_chain"], single["eval_chain"]
    assert got.shape == want.shape == (4, 3, 16, 16)
    np.testing.assert_allclose(got, want, atol=EVAL_CHAIN_TOL, rtol=0)


def test_sharded_generator_matches_single_device(sharded_runs):
    """`serve.build_generator` of a model in (ddp 2, fsdp 2), rank 0 generating
    while the others follow, against one device for the same seed."""
    runs, single, _ = sharded_runs
    got, want = runs["eval_generator"], single["eval_generator"]
    assert got.shape == want.shape == (4, 3, 16, 16)
    np.testing.assert_allclose(got, want, atol=EVAL_CHAIN_TOL, rtol=0)


def test_sharded_predictor_matches_single_device(sharded_runs):
    """`serve.build_predictor` in (ddp 2, tp 2): rank 0's `run_batch` hands the
    batch to the others and returns the whole batch's logits, those of one
    device."""
    runs, single, _ = sharded_runs
    got, want = runs["eval_predictor"], single["eval_predictor"]
    assert got.shape == want.shape == (4, 3)
    np.testing.assert_allclose(got, want, atol=EVAL_SERVE_TOL, rtol=0)


def test_eval_mesh_falls_back_to_one_process(capsys):
    """A config asking for more devices than the launch has processes evaluates
    on one device, with the JAX package's line."""
    from ucf_vit_tpu_torch.inference import evaluate_classification
    from ucf_vit_tpu_torch.parallel.mesh import eval_mesh

    raw = _eval_raw("classification")
    raw["parallelism"] = {"simple_ddp_size": 64, "fsdp_size": 1, "tensor_par_size": 1,
                          "seq_par_size": 1}
    cfg = Config(raw=raw, task="classification")
    assert eval_mesh(cfg, torch.device("cpu")) is None
    assert "eval: parallelism wants 64 devices, 1 available -> single-device eval" in \
        capsys.readouterr().out
    assert evaluate_classification(cfg, None, True, 4, device="cpu") == evaluate_classification(
        Config(raw=_eval_raw("classification"), task="classification"), None, True, 4,
        device="cpu")


def test_sharded_top1_matches_the_jax_packages_sharded_eval(sharded_runs):
    """The port's `evaluate_classification` in (fsdp 2, tp 2) on a checkpoint,
    against the JAX package's on its `to-jax` conversion, on the same mesh shape
    of the virtual CPU devices: the same top-1 over the same 12 synthetic
    samples."""
    from ucf_vit_tpu.inference import evaluate_classification as jax_evaluate_classification

    runs, _, tmp = sharded_runs
    jraw = copy.deepcopy(_eval_raw("classification", *EVAL_MESHES["eval_jax_top1"][1]))
    jraw["trainer"]["checkpoint_filename_for_loading"] = "conv_latest"
    want = jax_evaluate_classification(JConfig(raw=jraw, task="classification"),
                                       str(tmp / "eval_jax"), True, 12)
    assert runs["eval_jax_top1"] == want


def test_two_rank_server_answers_reloads_and_stops(sharded_runs):
    """`python -m ucf_vit_tpu_torch.serve` on two ranks (tp 2): rank 0 answers
    HTTP (two lone requests, five at once that share a full and a padded batch,
    a `/v1/reload`, one more) while rank 1 follows; the answers against
    `run_batch` on one device, before and after the reload, and SIGTERM to rank
    0 returns both ranks."""
    runs, single, _ = sharded_runs
    got = runs["eval_http"]
    assert "error" not in got, got.get("error")
    assert got["returned"] == ["returned", "returned"]
    assert got["reload"] == {"status": "reloaded", "epoch": 3}
    assert got["stats"]["errors"] == 0 and got["stats"]["requests"] == HTTP_INPUTS + 1
    assert got["stats"]["batches"] < HTTP_INPUTS + 1  # some requests shared a batch
    answers = np.stack([got["answers"][i] for i in range(HTTP_INPUTS)])
    np.testing.assert_allclose(answers, single["eval_http"], atol=EVAL_SERVE_TOL, rtol=0)


# ---------------------------------------------------------------- sequence parallelism
#
# seq_par_size > 1 on the CPU over gloo, in the groups of 4 and 2 above: the train
# step of MAE, DiffusionVIT and classification on meshes with an sp axis against the
# JAX package's sharded step on the same mesh shape (its EINSUM under GSPMD, which
# attends globally whatever `sp_mode` says) and against the port's single device;
# the ring, Ulysses and KV-gather attention with dropout against the JAX package's
# `ring_attention` under `shard_map` and its `_sharded_flash` (Pallas interpret); a
# sequence that sp does not divide; a mid-epoch resume from (fsdp 2, sp 2) onto
# (fsdp 2); evaluation, the chain and the predictor on an sp mesh against one device.

SP_CASES = {  # name: (task, (ddp, fsdp, sp, tp), sp_mode)
    "mae_fsdp2_sp2_ring": ("mae", (1, 2, 2, 1), "ring"),
    "mae_fsdp2_sp2_ulysses": ("mae", (1, 2, 2, 1), "ulysses"),
    "mae_fsdp2_sp2_gather": ("mae", (1, 2, 2, 1), "gather"),
    "mae_sp4_ring": ("mae", (1, 1, 4, 1), "ring"),
    "diffusion_ddp2_sp2_auto": ("diffusion", (2, 1, 2, 1), "auto"),
    "classification_tp2_sp2_ring": ("classification", (1, 1, 2, 2), "ring"),
}
SP_ATTN_SHAPE = (2, 4, 16, 8)  # [B, H, N, dh]
SP_ATTN_RATE = 0.1
SP_ATTN_TOL = 1e-5  # outputs and gradients against the JAX package's, f32
SP_ATTN_CASES = {  # name: ((ddp, fsdp, sp, tp), sp_mode or "ring_op", rate)
    # `ring_attention` alone at mae_long's sp 4
    "ring_op_nodrop": ((1, 1, 4, 1), "ring_op", 0.0),
    "ring_op_drop": ((1, 1, 4, 1), "ring_op", SP_ATTN_RATE),
    **{f"{mode}_{mesh}": (shape, mode, SP_ATTN_RATE)
       for mesh, shape in (("ddp2_sp2", (2, 1, 2, 1)), ("tp2_sp2", (1, 1, 2, 2)))
       for mode in ("ring", "ulysses", "gather")},
}


def _sp_raw(task, shape, mode, impl="FLASH"):
    """`_shard_model_raw` on a mesh with sp: MAE's decoder in 2 heads (so that
    Ulysses divides them), DiffusionVIT's decoder in 1 (so that `auto` gathers
    there), classification at a 24^2 tile (9 patches and the class token: 10
    tokens, which sp 2 divides)."""
    ddp, fsdp, sp, tp = shape
    raw = _shard_model_raw(task, ddp, fsdp, tp)
    raw["parallelism"].update(seq_par_size=sp, sp_mode=mode)
    ia = raw["model"]["net"]["init_args"]
    if task == "mae":
        ia["decoder_num_heads"] = 2
    elif task == "diffusion":
        ia["decoder_num_heads"] = 1
    else:
        ia["tile_size"] = [24, 24]
    raw["trainer"]["attn_impl"] = impl
    return raw


def _sp_attn_inputs():
    rng = np.random.default_rng(13)
    q, k, v, w = (rng.normal(size=SP_ATTN_SHAPE).astype(np.float32) for _ in range(4))
    return q, k, v, w, int(seed_from_key(jax.random.key(5)))


def _sp_eval_raw(task, sp, mode):
    raw = _eval_raw(task)
    raw["parallelism"] = {"seq_par_size": sp, "sp_mode": mode}
    raw["trainer"]["attn_impl"] = "FLASH"
    if task == "mae":
        raw["data"]["batch_size"] = 2
    elif task == "classification":
        raw["model"]["net"]["init_args"]["tile_size"] = [24, 24]
    return raw


def _sp_jobs(tmp):
    """The sequence-parallel jobs of the two groups, and what they are held
    against (run here)."""
    from ucf_vit_tpu_torch.inference import evaluate_classification, generate_diffusion
    from ucf_vit_tpu_torch.inference import init_eval_model, reconstruct
    from ucf_vit_tpu_torch.serve import build_predictor
    from ucf_vit_tpu_torch.tasks import build_task as port_build_task

    jobs, single, jax_runs = {4: [], 2: []}, {}, {}
    for name, (task, shape, mode) in SP_CASES.items():
        if (task, shape) not in jax_runs:
            # the JAX package's EINSUM attends globally whatever sp_mode says
            jax_runs[task, shape] = _jax_steps(task, _sp_raw(task, shape, "auto", "EINSUM"),
                                               shape)
        init, jax_losses, batches = jax_runs[task, shape]
        raw = _sp_raw(task, shape, mode)
        job = {"kind": "train", "name": name, "raw": raw, "batches": batches, "init": init,
               "loss": _PORT_LOSS.get(task, "task")}
        jobs[int(np.prod(shape))].append(job)
        single[name] = _torch_sharded.train_job({**job, "raw": _single_raw(raw)})
        single[name]["jax_losses"] = jax_losses
    q, k, v, w, seed = _sp_attn_inputs()
    jobs[4].append({"kind": "sp_attention", "name": "sp_attention", "q": q, "k": k, "v": v,
                    "w": w, "seed": seed, "cases": SP_ATTN_CASES})
    # 17 tokens on sp 2
    odd = _sp_raw("classification", (1, 1, 2, 1), "ring")
    odd["model"]["net"]["init_args"]["tile_size"] = [32, 32]
    model = port_build_task(Config(raw=_single_raw(odd), task="classification"))
    model.init_weights(torch.Generator().manual_seed(0))
    x = np.random.default_rng(3).normal(size=(2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        single["sp_odd"] = model.eval()(torch.from_numpy(x)).numpy()
    jobs[2].append({"kind": "sp_odd", "name": "sp_odd", "raw": odd, "x": x,
                    "init": {k: t.detach().numpy() for k, t in model.state_dict().items()}})
    # a mid-epoch resume from (fsdp 2, sp 2) onto (fsdp 2): the state it starts from,
    # and the rest of the epoch
    sp_par, fsdp2 = {"fsdp_size": 2, "seq_par_size": 2, "sp_mode": "ring"}, {"fsdp_size": 2}
    jobs[4].append(_cli("spa", _f6_yaml(tmp, "spa", sp_par, attn_impl="FLASH",
                                        preempt_after_steps=2)))
    resume = dict(attn_impl="FLASH", resume_from_checkpoint=True,
                  checkpoint_filename_for_loading="spa_latest")
    jobs[2] += [{**_cli("spb0", _f6_yaml(tmp, "spb0", fsdp2, **resume), "--max-steps", "2"),
                 "kind": "cli_state"},
                _cli("spb", _f6_yaml(tmp, "spb", fsdp2, **resume))]
    # evaluation on sp 2 against one device
    mae_ring, mae_auto = _sp_eval_raw("mae", 2, "ring"), _sp_eval_raw("mae", 2, "auto")
    vol = np.random.default_rng(4).normal(size=(2, 1, 16, 16, 16)).astype(np.float32)
    cls_sp, chain_sp = _sp_eval_raw("classification", 2, "ring"), _sp_eval_raw("diffusion", 2,
                                                                                "gather")
    jobs[2] += [
        {"kind": "reconstruct", "name": "sp_reconstruct", "raw": mae_ring, "x": vol, "seed": 4},
        {"kind": "predictor", "name": "sp_predictor", "raw": mae_auto, "max_batch": 2,
         "batch": {"x": vol}},
        {"kind": "eval", "name": "sp_top1", "raw": cls_sp, "fn": "evaluate_classification",
         "args": (None, True, 8)},
        {"kind": "eval", "name": "sp_chain", "raw": chain_sp, "fn": "generate_diffusion",
         "args": (None, 4), "kwargs": {"return_images": True}}]

    def one(raw):
        raw = copy.deepcopy(raw)
        raw["parallelism"] = {}
        return Config(raw=raw, task=raw["trainer"]["task"])

    single["sp_reconstruct"] = reconstruct(init_eval_model(one(mae_ring), seed=0, device="cpu"),
                                           torch.from_numpy(vol), seed=4).numpy()
    single["sp_predictor"] = build_predictor(one(mae_auto), max_batch=2,
                                             device="cpu")[0]({"x": vol}).numpy()
    single["sp_top1"] = evaluate_classification(one(cls_sp), None, True, 8, device="cpu")
    single["sp_chain"] = generate_diffusion(one(chain_sp), None, 4, return_images=True,
                                            device="cpu")[1]
    return jobs, single


@pytest.mark.parametrize("name", sorted(SP_CASES))
def test_sequence_parallel_train_step_matches_jax_and_single_device(sharded_runs, name):
    """Three steps of the port on a mesh with sp (FLASH in the case's `sp_mode`,
    the kernels' plain versions here) against the JAX package's sharded step on
    the same mesh shape and against the port's single device (the per-step
    losses within SHARD_LOSS_TOL), and the gathered parameters against the
    single device's (`_assert_params_match`)."""
    runs, single, _ = sharded_runs
    got = runs[name]
    np.testing.assert_allclose(got["losses"], single[name]["jax_losses"], atol=SHARD_LOSS_TOL,
                               rtol=0)
    np.testing.assert_allclose(got["losses"], single[name]["losses"], atol=SHARD_LOSS_TOL,
                               rtol=0)
    if SP_CASES[name][1][3] > 1:
        assert any(n.endswith("attn.qkv.weight") for n in got["sharded"])
    _assert_params_match(got["params"], single[name]["params"], name)


def _jax_sp_attention(name):
    """The JAX package's output and gradients of `sum(o * w)` for a case of
    SP_ATTN_CASES: its `ring_attention` under `shard_map` over sp, or
    `multi_head_attention` (FLASH, Pallas interpret) under the mesh."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ucf_vit_tpu.ops.ring_attention import ring_attention as jax_ring_attention

    shape, mode, rate = SP_ATTN_CASES[name]
    q, k, v, w, seed = _sp_attn_inputs()
    mesh = jax_make_mesh(*shape)
    if mode == "ring_op":
        spec = P(None, None, "sp", None)
        fn = shard_map(lambda q, k, v: jax_ring_attention(
            q, k, v, "sp", dropout_rate=rate, dropout_seed=seed if rate else None),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    else:
        def fn(q, k, v):
            return jax_mha(q, k, v, impl="FLASH", dropout_rate=rate,
                           dropout_rng=jax.random.key(5), sp_mode=mode)
    def fwd_bwd(q, k, v, w):
        o, vjp = jax.vjp(fn, q, k, v)
        return (o,) + vjp(w)

    with jax_mesh_context(mesh):
        out = jax.jit(fwd_bwd)(*(jnp.asarray(t) for t in (q, k, v, w)))
    return [np.asarray(t) for t in out]


@pytest.mark.parametrize("name", sorted(SP_ATTN_CASES))
def test_sequence_parallel_attention_matches_jax(sharded_runs, name):
    """The port's ring (`ring_attention` alone on sp 4, with and without dropout)
    and its three modes under `multi_head_attention` (dropout 0.1) on (ddp 2, sp 2) and
    (tp 2, sp 2), each rank on its slice, against the JAX package's ring under
    `shard_map` and its `_sharded_flash` in interpret mode on the same mesh: the
    output and the gradients of q, k and v within SP_ATTN_TOL."""
    runs, _, _ = sharded_runs
    (ddp, fsdp, sp, tp), _, _ = SP_ATTN_CASES[name]
    want = _jax_sp_attention(name)
    *parts, coords = runs["sp_attention"][name]
    b, h, n = (SP_ATTN_SHAPE[0] // (ddp * fsdp), SP_ATTN_SHAPE[1] // tp,
               SP_ATTN_SHAPE[2] // sp)
    for got_ranks, w in zip(parts, want):
        got = np.full_like(w, np.nan)
        for piece, (r, t, s) in zip(got_ranks, coords):
            got[r * b:(r + 1) * b, t * h:(t + 1) * h, s * n:(s + 1) * n] = piece
        np.testing.assert_allclose(got, w, atol=SP_ATTN_TOL, rtol=0)


def test_a_sequence_sp_does_not_divide_runs_whole_or_raises_as_jax(sharded_runs):
    """A ViT of 17 tokens on sp 2: the JAX package's flash attention refuses it
    (`shard_map` wants the dim to divide) and so does the port's, with a
    ValueError; under EINSUM the stream runs whole on both ranks and the logits
    equal one device's within SHARD_PARAM_TOL."""
    runs, single, _ = sharded_runs
    got = runs["sp_odd"]
    assert got["FLASH"].startswith("ValueError") and "17 tokens" in got["FLASH"]
    np.testing.assert_allclose(got["EINSUM"], single["sp_odd"], atol=SHARD_PARAM_TOL, rtol=0)
    x = jnp.zeros((2, 2, 17, 8))
    with jax_mesh_context(jax_make_mesh(1, 1, 2, 1)):
        with pytest.raises(ValueError, match="not evenly divisible"):
            jax_mha(x, x, x, impl="FLASH", sp_mode="ring")


def test_midepoch_resume_from_sequence_parallel_onto_fsdp_is_bit_for_bit(sharded_runs):
    """A NIfTI MAE with DropPath in (fsdp 2, sp 2 ring, FLASH) preempted after step
    2, the sync check every step (it compares the sp replicas); resumed onto
    (fsdp 2), which has as many data ranks: the resumed state equals what the
    sp run saved bit for bit (every parameter, each data rank's device
    generator), and the resume re-enters the epoch at its third batch."""
    runs, _, tmp = sharded_runs
    first = _step_losses(tmp / "spa.jsonl")
    payload = torch.load(tmp / "ck" / "spa_even.ckpt", weights_only=True)
    assert sorted(first) == [1, 2] and payload["data_it"] == 2 and payload["data_size"] == 2
    checks = [json.loads(line) for line in open(tmp / "spa.jsonl")]
    checks = [r for r in checks if "sync_check" in r]
    assert len(checks) == 2 and all("'sp'" in r["sync_check"] for r in checks)
    state = runs["spb0"]
    for k, v in payload["model_state_dict"].items():
        np.testing.assert_array_equal(state["params"][k], v.numpy(), err_msg=k)
    saved = payload["generators"]["device_by_data_rank"]
    for r in range(2):
        np.testing.assert_array_equal(state["generators"][r], saved[r].numpy())
    recs = [json.loads(line) for line in open(tmp / "spb.jsonl")]
    assert recs[0]["resume_it"] == 2
    assert [(r["epoch"], r["it"], r["step"]) for r in recs if "loss" in r and "step" in r] == [
        (0, 3, 3), (0, 4, 4)]


@pytest.mark.parametrize("name", ["sp_reconstruct", "sp_predictor", "sp_top1", "sp_chain"])
def test_sequence_parallel_evaluation_matches_single_device(sharded_runs, name):
    """On two ranks of sp 2 against one device: an MAE's `reconstruct` (ring)
    and the server's predictor (`auto`) within EVAL_CHAIN_TOL, the
    classification top-1 equal, the reverse chain (gather) within
    EVAL_CHAIN_TOL."""
    runs, single, _ = sharded_runs
    if name == "sp_top1":
        assert runs[name] == single[name]
        return
    np.testing.assert_allclose(runs[name], single[name], atol=EVAL_CHAIN_TOL, rtol=0)


@pytest.mark.parametrize("case", ["bad_mode", "ulysses_heads", "ulysses_decoder_heads"])
def test_sp_mode_config_errors_match_jax(case):
    """`parallelism.sp_mode` is checked as the JAX package checks it, with its
    messages: the mode's name, and under `ulysses` the heads (per tp rank) and,
    for MAE, the decoder's heads divisible by sp."""
    task = "classification" if case == "ulysses_heads" else "mae"
    raw = _shard_model_raw(task)
    raw["parallelism"] = {"seq_par_size": 2, "sp_mode": "ulysses"}
    ia = raw["model"]["net"]["init_args"]
    if case == "bad_mode":
        raw["parallelism"]["sp_mode"] = "spiral"
    elif case == "ulysses_heads":
        ia["num_heads"] = 1
    with pytest.raises(AssertionError) as want:
        JConfig(raw=copy.deepcopy(raw), task=task).validate()
    with pytest.raises(AssertionError) as got:
        Config(raw=raw, task=task).validate()
    assert str(got.value) == str(want.value)
