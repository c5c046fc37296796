"""Cross-framework numerics parity: our flax blocks vs a hand-built torch
mirror of the reference's math (the reference itself needs timm/monai which
are not installed; its Block math is LN(eps 1e-6) -> qkv -> SDPA -> proj ->
residual -> LN -> fc1 -> exact GELU -> fc2 -> residual,
`simple/building_blocks.py:94-239`).

This is the north-star numerics check ("matching reference outputs to 1e-3",
BASELINE.json): identical weights produce matching outputs across torch f32
and jax f32.

Then, in a section of its own, the PyTorch port's data and tensor
parallelism on the CPU over gloo (see the section's comment).
"""

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

import _torch_sharded
from ucf_vit_tpu.config import Config as JConfig
from ucf_vit_tpu.models.blocks import Block, PatchEmbed
from ucf_vit_tpu.models.ddpm import ddpm_schedule as jax_ddpm_schedule
from ucf_vit_tpu.models.ddpm import q_sample as jax_q_sample
from ucf_vit_tpu.ops.attention import AttnImpl
from ucf_vit_tpu.ops.attention import multi_head_attention as jax_mha
from ucf_vit_tpu.ops.attn_dropout import seed_from_key
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
from ucf_vit_tpu_torch.train import main as train_main
from ucf_vit_tpu_torch.train import synthetic_batches

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


def _shard_batches(task, raw):
    """The global batches (numpy), with MAE's mask noise and diffusion's (t, e)."""
    cfg = Config(raw=raw, task=task)
    b = raw["data"]["batch_size"] * cfg.data_par_size
    out = []
    for i, batch in zip(range(SHARD_STEPS), synthetic_batches(cfg, b)):
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


def _jax_init_fn(task, jmod, batch):
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(0)
    if task == "classification":
        return lambda: jmod.init(key, b["x"])
    if task == "mae":
        return lambda: jmod.init(key, b["x"], mask_noise=b["mask_noise"])
    if task == "diffusion":
        return lambda: jmod.init(key, b["x"], jnp.zeros(b["x"].shape[0], jnp.int32))
    img = jax_reassemble(b["seq"], 4, 2, False)
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
    batches = _shard_batches(task, raw)
    jmod, jloss = jax_build_task(JConfig(raw=raw, task=task))
    mesh = jax_make_mesh(ddp, fsdp, 1, tp)
    init_fn = _jax_init_fn(task, jmod, batches[0])
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
    return init, losses, raw, batches


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
