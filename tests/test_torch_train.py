"""The port's training slice against the JAX package, on the CPU at small
sizes: cross-entropy and accuracy, the warmup-cosine schedule, the no-decay
mask, the loss-scale update, and the train step over 20 steps from one JAX
init (moved across with `load_jax_params`) on the same synthetic batches,
with attention EINSUM and FLASH (`FlashAttentionFn` with its plain backward)
and with accumulation, clipping, EMA and loss scaling. Then the trainer's
CLI.

Then the MAE task, at depth 2, embed 24, decoder 18: `patchify`/`unpatchify`,
`mse` and `masked_mse`, the MAE model (3-D and 2-D tiles, the transformer and
the linear decoder, sequence packing), the conversion of an MAE tree with a
scan-stacked encoder, MAE's loss and train step in f32 and in bf16 with
remat, `reconstruct`, and the mae_long config shrunk through the CLI. Weights
are the flax init plus numpy noise, moved across with `load_jax_params`;
inputs and the mask noise come from numpy seeds and are injected into both
sides (`mask_noise`), so both keep the same tokens. Attention is EINSUM on
the JAX side; the port runs FLASH (on the CPU its wrapper takes the kernels'
plain versions) or EINSUM, as a case says. Tolerances: `pred` within 1e-5 in
f32 (the same sums in other orders, two blocks deep on either side of the
mask), the mask exact; per-step losses within 1e-4 in f32 and 5e-3 in bf16
(`tests/test_torch_bf16.py` says why the two frameworks' bf16 roundings
differ).

Then the data pipeline, checkpoints and resume, on files written from numpy
seeds (NIfTI, .npy, JPEG): the port's readers, tiling, shuffle buffer, load
balancing, DataModule and catsdogs loader against the JAX package's, batch for
batch; five train steps from JPEGs through both trainers; the checkpoint slots,
their resolution and the head-grouping guard; resume equal bit for bit to an
uninterrupted run; and checkpoints through the JAX package's `convert_checkpoint`
both ways.

Then DiffusionVIT and DDPM: the time table, the schedule, `q_sample`, the model, the
loss and 5 train steps with the steps t and the noise e injected into both sides, the
reverse chain on the JAX sampler's own draws, the time embedding's dropout drawing
from the model's generator, and both diffusion configs shrunk through the CLI with a
save and a resume."""

import ast
import copy
import json
import os
import re
import multiprocessing
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml
from flax.core import meta

torch = pytest.importorskip("torch")

from ucf_vit_tpu.config import Config as JConfig
from ucf_vit_tpu.models.mae import MAE as JMAE
from ucf_vit_tpu.ops.attention import AttnImpl as JAttnImpl
from ucf_vit_tpu.ops.patchify import patchify as jpatchify
from ucf_vit_tpu.ops.patchify import unpatchify as junpatchify
from ucf_vit_tpu.parallel.train_step import TrainState as JTrainState
from ucf_vit_tpu.parallel.train_step import make_train_step as jax_make_train_step
from ucf_vit_tpu.tasks import build_classification as jax_build_classification
from ucf_vit_tpu.tasks import build_mae as jax_build_mae
from ucf_vit_tpu.tools.convert_checkpoint import export_torch_state
from ucf_vit_tpu.utils import metrics as jax_metrics
from ucf_vit_tpu.utils import optim as jax_optim
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.convert import jax_to_torch_state, load_jax_params
from ucf_vit_tpu_torch.inference import init_eval_model, reconstruct
from ucf_vit_tpu_torch.models import MAE
from ucf_vit_tpu_torch.ops.patchify import patchify, unpatchify
from ucf_vit_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ucf_vit_tpu_torch.tasks import build_classification, build_mae, task_loss
from ucf_vit_tpu_torch.train import main, synthetic_batches, to_device
from ucf_vit_tpu_torch.utils import metrics, optim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 20
LOSS_TOL = 1e-4  # per-step loss: f32 on both sides, sums in other orders, 20 updates
GRAD_TOL = 1e-5  # first-step gradients
PARAM_TOL = 1e-4  # parameters after 20 updates


def _raw(**model):
    ia = {"default_vars": ["red", "green", "blue"], "tile_size": [32, 32], "patch_size": 8,
          "embed_dim": 32, "depth": 2, "num_heads": 2, "mlp_ratio": 2, "twoD": True,
          "adaptive_patching": False}
    m = {"lr": 1e-3, "beta_1": 0.9, "beta_2": 0.95, "weight_decay": 1e-2,
         "warmup_steps": 5, "max_steps": STEPS, "warmup_start_lr": 1e-8, "eta_min": 1e-8,
         "net": {"init_args": ia}}
    m.update(model)
    return {"trainer": {"task": "classification", "attn_impl": "EINSUM"},
            "parallelism": {}, "model": m,
            "data": {"batch_size": 4, "num_classes": 4, "num_channels_used": {"d": 3}}}


# ---------------------------------------------------------------- metrics, optimizer


def test_cross_entropy_and_accuracy_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, size=16)
    for ours, ref in ((metrics.cross_entropy, jax_metrics.cross_entropy),
                      (metrics.accuracy, jax_metrics.accuracy)):
        got = ours(torch.from_numpy(logits), torch.from_numpy(labels)).item()
        assert abs(got - float(ref(jnp.asarray(logits), jnp.asarray(labels)))) <= 1e-6


@pytest.mark.parametrize("warmup,max_steps", [(5, 20), (1000, 20000), (1, 10)])
def test_schedule_matches_jax(warmup, max_steps):
    ours = optim.warmup_cosine_schedule(1e-4, warmup, max_steps, 1e-8, 1e-8)
    ref = jax_optim.warmup_cosine_schedule(1e-4, warmup, max_steps, 1e-8, 1e-8)
    for step in (0, warmup - 1, warmup, (warmup + max_steps) // 2, max_steps, max_steps + 7):
        want = float(ref(step))
        assert abs(ours(step) - want) <= 1e-7 * abs(want), step


def test_no_decay_set_matches_jax():
    cfg = _raw()
    cfg["model"]["net"]["init_args"]["init_values"] = 0.1
    jmod, _ = jax_build_classification(JConfig(raw=cfg, task="classification"))
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.zeros((1, 3, 32, 32)))["params"])
    mask = jax.tree.map(lambda m, p: np.full(p.shape, m), jax_optim._no_decay_mask(params), params)
    want = {k: bool(v.all()) for k, v in jax_to_torch_state(mask).items()}
    model = build_classification(Config(raw=cfg, task="classification"))
    assert optim._no_decay_mask(model) == want
    assert not want["pos_embed"] and want["blocks.0.attn.qkv.weight"]


def test_loss_scale_update_matches_jax():
    finite = [True] * 5 + [False, True, True, False, False, True] + [True] * 4
    ours, ref = optim.init_loss_scale(256.0), jax_optim.init_loss_scale(256.0)
    for f in finite:
        ours = optim.update_loss_scale(ours, f, growth_interval=3, min_scale=128.0)
        ref = jax_optim.update_loss_scale(ref, jnp.asarray(f), growth_interval=3,
                                          min_scale=128.0)
        assert (ours.scale, ours.growth_counter) == (float(ref.scale), int(ref.growth_counter))
    grads = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert not bool(optim.all_finite(grads)) and bool(optim.all_finite(grads[:1]))


# ---------------------------------------------------------------- train step


CASES = {
    "plain": dict(),
    "accum2": dict(accum_steps=2),
    "clip": dict(max_grad_norm=0.05),
    "ema": dict(ema_decay=0.9),
    "scaler": dict(use_grad_scaler=True, overflow_at=3),
}


def _batches(raw, overflow_at=None):
    out = []
    for i, b in zip(range(STEPS), synthetic_batches(Config(raw=raw, task="classification"), 4)):
        b = {"x": b["x"], "label": b["label"]}
        if i == overflow_at:
            b["x"] = b["x"].copy()
            b["x"][0, 0, 0, 0] = np.inf
        out.append(b)
    return out


_JAX_RUNS = {}


def _jax_run(case):
    """Init params, first-step grads, per-step losses and final params of the
    JAX train step (cached: the EINSUM and FLASH port runs share it)."""
    if case in _JAX_RUNS:
        return _JAX_RUNS[case]
    opts = CASES[case]
    raw = _raw()
    jmod, loss_fn = jax_build_classification(JConfig(raw=raw, task="classification"))
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.zeros((1, 3, 32, 32)))["params"])
    params = jax.tree.map(jnp.asarray, params)
    m = raw["model"]
    tx = jax_optim.configure_optimizer(
        params, lr=m["lr"], beta_1=m["beta_1"], beta_2=m["beta_2"],
        weight_decay=m["weight_decay"], warmup_steps=m["warmup_steps"],
        max_steps=m["max_steps"], warmup_start_lr=m["warmup_start_lr"], eta_min=m["eta_min"],
        max_grad_norm=opts.get("max_grad_norm"))
    state = JTrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
        loss_scale=jax_optim.init_loss_scale() if opts.get("use_grad_scaler") else None,
        ema_params=jax.tree.map(jnp.copy, params) if opts.get("ema_decay") else None)
    step = jax_make_train_step(loss_fn, tx, donate=False, accum_steps=opts.get("accum_steps", 1),
                               ema_decay=opts.get("ema_decay"))
    batches = _batches(raw, opts.get("overflow_at"))
    rng = jax.random.key(0)
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    grads = jax.grad(lambda p: loss_fn(p, first, rng)[0])(params)
    losses = []
    for b in batches:
        state, loss, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()}, rng)
        losses.append(float(loss))
    run = (jax.device_get(params), jax_to_torch_state(jax.device_get(grads)), np.array(losses),
           jax_to_torch_state(jax.device_get(state.params)),
           None if state.ema_params is None else jax_to_torch_state(jax.device_get(state.ema_params)),
           None if state.loss_scale is None else float(state.loss_scale.scale))
    _JAX_RUNS[case] = run
    return run


@pytest.mark.parametrize("impl", ["EINSUM", "FLASH"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case, impl):
    opts = CASES[case]
    init, jax_grads, jax_losses, jax_final, jax_ema, jax_scale = _jax_run(case)
    raw = _raw()
    raw["trainer"]["attn_impl"] = impl
    cfg = Config(raw=raw, task="classification")
    model = load_jax_params(build_classification(cfg), init)
    m = raw["model"]
    opt = optim.configure_optimizer(
        model, lr=m["lr"], beta_1=m["beta_1"], beta_2=m["beta_2"],
        weight_decay=m["weight_decay"], warmup_steps=m["warmup_steps"],
        max_steps=m["max_steps"], warmup_start_lr=m["warmup_start_lr"], eta_min=m["eta_min"],
        max_grad_norm=opts.get("max_grad_norm"))
    state = create_train_state(model, opt, use_grad_scaler=opts.get("use_grad_scaler", False),
                               ema=opts.get("ema_decay") is not None)
    step = make_train_step(task_loss(cfg), opt, accum_steps=opts.get("accum_steps", 1),
                           ema_decay=opts.get("ema_decay"))
    losses = []
    for i, b in enumerate(_batches(raw, opts.get("overflow_at"))):
        state, loss, aux = step(state, to_device(b, torch.device("cpu")))
        losses.append(loss.item())
        if i == 0 and "max_grad_norm" not in opts:  # the clip rewrites .grad in place
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), jax_grads[name], atol=GRAD_TOL,
                                           rtol=0, err_msg=name)
    assert set(aux) == {"accuracy"} and state.step == STEPS
    np.testing.assert_allclose(losses, jax_losses, atol=LOSS_TOL, rtol=0)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jax_final[name], atol=PARAM_TOL, rtol=0,
                                   err_msg=name)
    if jax_ema is not None:
        for name, e in state.ema_params.items():
            np.testing.assert_allclose(e.numpy(), jax_ema[name], atol=PARAM_TOL, rtol=0)
    if "overflow_at" in opts:
        assert not np.isfinite(losses[opts["overflow_at"]])
        assert opt.count == STEPS - 1  # the overflow step was skipped
        assert state.loss_scale.scale == jax_scale


def test_train_step_rejects_indivisible_accumulation():
    raw = _raw()
    cfg = Config(raw=raw, task="classification")
    model = build_classification(cfg)
    opt = optim.configure_optimizer(model, lr=1e-3)
    step = make_train_step(task_loss(cfg), opt, accum_steps=3)
    batch = to_device(_batches(raw)[0], torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        step(create_train_state(model, opt), batch)


# ---------------------------------------------------------------- CLI


def _tiny_yaml(tmp_path, **trainer):
    raw = _raw()
    raw["trainer"].update(trainer)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_cli_trains_and_writes_metrics(tmp_path):
    metrics_path = tmp_path / "m" / "metrics.jsonl"
    cfg = _tiny_yaml(tmp_path, metrics_path=str(metrics_path))
    proc = subprocess.run(
        [sys.executable, "-m", "ucf_vit_tpu_torch.train", cfg, "--synthetic", "--max-steps", "3",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    recs = [json.loads(line) for line in metrics_path.read_text().splitlines()]
    assert recs[0]["run_start"] and [r["step"] for r in recs[1:]] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and "accuracy" in r for r in recs[1:])
    assert "epoch 0 it 3 loss" in proc.stdout


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    from ucf_vit_tpu_torch.config import load_config

    cfg = _tiny_yaml(tmp_path)
    # without --synthetic the trainer reads the files the config names: none here
    with pytest.raises(KeyError, match="dict_root_dirs"):
        main([cfg, "--max-steps", "1", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="last_even"):
        main([_tiny_yaml(tmp_path, resume_from_checkpoint=True,
                         checkpoint_path=str(tmp_path / "none"),
                         checkpoint_filename_for_loading="last_latest"),
              "--synthetic", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([cfg, "--synthetic", "--max-steps", "1"])
    for key, item in (("pipe_par_size", "item 12: pipeline"),
                      ("expert_par_size", "item 12: pipeline")):
        raw = _raw()
        raw["parallelism"] = {key: 2}
        if key == "expert_par_size":  # the config's own check wants experts to shard
            raw["model"]["net"]["init_args"]["moe_num_experts"] = 2
        path = tmp_path / f"{key}.yaml"
        path.write_text(yaml.safe_dump(raw))
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md, modules to port, {item}"):
            main([str(path), "--synthetic", "--device", "cpu"])
    # sequence parallelism passes the trainer's check for every task (one process launched,
    # so the world size is what stops them here); UNETR and SAP refuse it when built
    for task in ("classification", "mae", "diffusion", "unetr", "sap"):
        raw = _raw()
        raw["trainer"]["task"] = task
        raw["parallelism"] = {"seq_par_size": 2}
        path = tmp_path / f"sp_{task}.yaml"
        path.write_text(yaml.safe_dump(raw))
        with pytest.raises(RuntimeError, match="asks for 2 processes but 1 was launched"):
            main([str(path), "--synthetic", "--device", "cpu"])
        if task in ("unetr", "sap"):
            with pytest.raises(NotImplementedError, match="ROADMAP.md, modules to port: "
                               "item 11: the UNETR spatial partition"):
                build_task(load_config(str(path)))
    # a mesh of more processes than were launched
    raw = _raw()
    raw["parallelism"] = {"fsdp_size": 2}
    path = tmp_path / "fsdp2.yaml"
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(RuntimeError, match="asks for 2 processes but 1 was launched"):
        main([str(path), "--synthetic", "--device", "cpu"])


def test_chip_smoke_drives_the_trainer():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    imported = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "ucf_vit_tpu_torch.train" in imported


# ================================================================ MAE


MAE_PRED_TOL = 1e-5  # pred, f32
MAE_BF16_LOSS_TOL = 5e-3  # per-step loss, bf16 with remat
MAE_STEPS = 5
# a 3-D tile of 16^3 at patch 4 (64 tokens, 16 kept) and a 2-D one of 16^2 (16 tokens, 4
# kept), both with 2 encoder blocks of 24 wide and 2 decoder blocks, 18 wide in 3-D and
# 12 in 2-D (the 2-D sincos table takes a width divisible by 4)
MAE_TILES = {
    "3d": dict(img_size=(16, 16, 16), patch_size=4, in_chans=1, twoD=False),
    "2d": dict(img_size=(16, 16), patch_size=4, in_chans=3, twoD=True, decoder_embed_dim=12),
}
MAE_KW = dict(embed_dim=24, depth=2, num_heads=2, decoder_embed_dim=18, decoder_depth=2,
              decoder_num_heads=3, mlp_ratio_decoder=2.0, mlp_ratio=2.0, mask_ratio=0.75)


def _mae_x(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mae_noise(b, l, seed=2):
    return np.random.default_rng(seed).uniform(size=(b, l)).astype(np.float32)


def _mae_shape(tile, b=2):
    kw = MAE_TILES[tile]
    return (b, kw["in_chans"]) + tuple(kw["img_size"])


def _mae_params(module, x, noise, seed=0):
    """flax init, unboxed to numpy, plus N(0, 0.05) noise on every leaf (the
    mask token and the decoder's table would otherwise start at their
    special values)."""
    params = meta.unbox(module.init(jax.random.key(0), jnp.asarray(x),
                                    mask_noise=jnp.asarray(noise))["params"])
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)


def _mae_pair(tile, impl="FLASH", **kw):
    """(JAX MAE, its params, the port's MAE with them, input, mask noise)."""
    kw = dict(MAE_KW, **MAE_TILES[tile], **kw)
    x = _mae_x(*_mae_shape(tile))
    jmod = JMAE(attn_impl=JAttnImpl.EINSUM, class_token=False, **kw)
    noise = _mae_noise(2, int(np.prod([s // kw["patch_size"] for s in kw["img_size"]])))
    params = _mae_params(jmod, x, noise)
    ours = load_jax_params(MAE(attn_impl=impl, **kw), params).eval()
    return jmod, params, ours, x, noise


# ---------------------------------------------------------------- ops and losses


@pytest.mark.parametrize("tile", sorted(MAE_TILES))
def test_patchify_and_unpatchify_match_jax(tile):
    x = _mae_x(*_mae_shape(tile))
    twoD = MAE_TILES[tile]["twoD"]
    got = patchify(torch.from_numpy(x), 4, twoD)
    want = np.asarray(jpatchify(jnp.asarray(x), 4, twoD))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    tokens = _mae_x(*want.shape, seed=3)
    back = unpatchify(torch.from_numpy(tokens), x.shape, 4, twoD)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(junpatchify(jnp.asarray(tokens), x.shape, 4, twoD)))
    np.testing.assert_array_equal(unpatchify(got, x.shape, 4, twoD).numpy(), x)


@pytest.mark.parametrize("masked", [4, 0], ids=["mask", "empty_mask"])
def test_mse_and_masked_mse_match_jax(masked):
    pred, target = _mae_x(3, 8, 16, seed=4), _mae_x(3, 8, 16, seed=5)
    mask = np.zeros((3, 8), np.float32)
    mask[:, :masked] = 1.0
    got = metrics.masked_mse(torch.from_numpy(pred).to(torch.bfloat16),
                             torch.from_numpy(target), torch.from_numpy(mask))
    want = jax_metrics.masked_mse(jnp.asarray(pred, jnp.bfloat16), jnp.asarray(target),
                               jnp.asarray(mask))
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6
    if not masked:  # max(mask.sum(), 1): no division by zero
        assert got.item() == 0.0
    got = metrics.mse(torch.from_numpy(pred), torch.from_numpy(target))
    assert abs(got.item() - float(jax_metrics.mse(jnp.asarray(pred), jnp.asarray(target)))) <= 1e-6


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("linear_decoder", [False, True], ids=["decoder", "linear_decoder"])
@pytest.mark.parametrize("tile", sorted(MAE_TILES))
def test_mae_matches_jax(tile, linear_decoder):
    jmod, params, ours, x, noise = _mae_pair(tile, linear_decoder=linear_decoder)
    want_pred, want_mask = jmod.apply({"params": params}, jnp.asarray(x),
                                      mask_noise=jnp.asarray(noise))
    pred, mask = ours(torch.from_numpy(x), mask_noise=torch.from_numpy(noise))
    assert pred.shape == want_pred.shape == (2, ours.num_patches, ours.decoder_pred.out_features)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want_pred), atol=MAE_PRED_TOL,
                               rtol=0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert mask.sum().item() == 2 * (ours.num_patches - ours.len_keep)
    assert (ours.decoder_blocks is None) == linear_decoder


def test_seq_pack_matches_unpacked_and_jax():
    """Two samples' kept tokens in one encoder row with block-diagonal
    attention give what each gives alone, as in the JAX model."""
    kw = dict(MAE_KW, **MAE_TILES["3d"])
    x = _mae_x(4, 1, 16, 16, 16)
    noise = _mae_noise(4, 64)
    jpacked = JMAE(attn_impl=JAttnImpl.EINSUM, class_token=False, seq_pack=2, **kw)
    params = _mae_params(jpacked, x, noise)
    want, want_mask = jpacked.apply({"params": params}, jnp.asarray(x),
                                    mask_noise=jnp.asarray(noise))
    packed = load_jax_params(MAE(attn_impl="FLASH", seq_pack=2, **kw), params).eval()
    single = load_jax_params(MAE(attn_impl="FLASH", **kw), params).eval()
    assert packed.blocks[0].attn.seg_len == packed.len_keep == 16
    assert single.blocks[0].attn.seg_len is None
    got, mask = packed(torch.from_numpy(x), mask_noise=torch.from_numpy(noise))
    alone, _ = single(torch.from_numpy(x), mask_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.detach().numpy(), alone.detach().numpy(), atol=MAE_PRED_TOL,
                               rtol=0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MAE_PRED_TOL, rtol=0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    with pytest.raises(ValueError, match="divisible by seq_pack"):
        packed(torch.from_numpy(x[:3]), mask_noise=torch.from_numpy(noise[:3]))
    with pytest.raises(ValueError, match="segment-masked attention limit"):
        MAE(seq_pack=80, **kw)
    with pytest.raises(ValueError, match="DropPath"):
        MAE(seq_pack=2, drop_path_rate=0.1, **kw)


def test_masking_draws_from_the_model_generator():
    _, _, ours, x, _ = _mae_pair("3d")
    with pytest.raises(RuntimeError, match="set_generator"):
        ours(torch.from_numpy(x))
    state = torch.random.get_rng_state()
    masks = []
    for _ in range(2):
        ours.set_generator(torch.Generator().manual_seed(7), torch.Generator().manual_seed(7))
        masks.append(ours(torch.from_numpy(x))[1])
    assert torch.equal(masks[0], masks[1])  # the same seed keeps the same tokens
    assert torch.equal(state, torch.random.get_rng_state())  # the global generator is untouched
    assert not torch.equal(masks[0], ours(torch.from_numpy(x))[1])  # the next draw differs


@pytest.mark.parametrize("variant", ["pipe_par"])
def test_unported_variants_raise_with_their_roadmap_item(variant):
    kw = dict(MAE_KW, **MAE_TILES["3d"], pipe_par_size=2, scan_layers=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, modules to port: pipeline \\+ MoE"):
        MAE(**kw)


@pytest.mark.parametrize("case", ["2d", "adaptive_pos_mlp"])
def test_mae_pred_with_varemb_matches_jax(case):
    """MAE with the variable embedding (three variables merged), the mask noise
    injected on both sides: `pred` within MAE_PRED_TOL and the mask equal; with
    adaptive patching the sequence's per-variable LinearTokenEmbeds and the
    position MLPs of both the encoder and the decoder."""
    kw = dict(MAE_KW, **MAE_TILES["2d"], use_varemb=True, default_vars=("red", "green", "blue"))
    rng = np.random.default_rng(6)
    ps = None
    if case == "adaptive_pos_mlp":
        kw.update(adaptive_patching=True, fixed_length=16, use_adaptive_pos_emb=True)
        x = _mae_x(2, 3, 16, 16)
        ps = np.concatenate([rng.integers(2, 9, size=(2, 16, 1)),
                             rng.uniform(0, 16, size=(2, 16, 2))], -1).astype(np.float32)
    else:
        x = _mae_x(2, 3, 16, 16)
    noise = _mae_noise(2, 16)
    var_ids = (0, 1, 2)
    jmod = JMAE(attn_impl=JAttnImpl.EINSUM, class_token=False, **kw)
    jps = None if ps is None else jnp.asarray(ps)
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(x), var_ids, jps,
                                  mask_noise=jnp.asarray(noise))["params"])
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    assert sorted(jax_to_torch_state(params)) == sorted(export_torch_state(params))
    ours = load_jax_params(MAE(attn_impl="FLASH", **kw), params).eval()
    want, wmask = jmod.apply({"params": params}, jnp.asarray(x), var_ids, jps,
                             mask_noise=jnp.asarray(noise))
    with torch.inference_mode():
        got, mask = ours(torch.from_numpy(x), mask_noise=torch.from_numpy(noise),
                         seq_ps=None if ps is None else torch.from_numpy(ps), var_ids=var_ids)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MAE_PRED_TOL, rtol=0)


def test_remat_replays_the_decoder_exactly():
    """Under remat the decoder's blocks run their forward again in the
    backward on the same un-shuffled tokens (the mask is drawn once, before
    them) and, at rate 0.1, draw the same dropout again: the loss and every
    gradient equal those of the run that keeps its activations."""
    kw = dict(MAE_KW, **MAE_TILES["3d"], attn_impl="FLASH", proj_drop_rate=0.1,
              attn_drop_rate=0.1)
    x = torch.from_numpy(_mae_x(2, 1, 16, 16, 16))
    runs = []
    for remat in (False, True):
        model = MAE(remat=remat, **kw).init_weights(torch.Generator().manual_seed(0)).train()
        model.set_generator(torch.Generator().manual_seed(3), torch.Generator().manual_seed(3))
        pred, mask = model(x)
        loss = metrics.masked_mse(pred, patchify(x, 4, False), mask)
        loss.backward()
        runs.append((loss.item(), mask, {n: p.grad for n, p in model.named_parameters()}))
    (la, ma, ga), (lb, mb, gb) = runs
    assert la == lb and torch.equal(ma, mb)
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name
    assert all(ga[f"decoder_blocks.{i}.attn.qkv.weight"].abs().max() > 0 for i in range(2))


# ---------------------------------------------------------------- conversion


def test_conversion_of_a_scanned_encoder_matches_export_torch_state():
    """mae_long's layout: the encoder scan-stacked (`blocks/block`), the
    decoder per layer. Key for key and value for value as the JAX
    package's own export, and the port's MAE takes it."""
    kw = dict(MAE_KW, **MAE_TILES["3d"])
    x, noise = _mae_x(2, 1, 16, 16, 16), _mae_noise(2, 64)
    jmod = JMAE(attn_impl=JAttnImpl.EINSUM, class_token=False, scan_layers=True, **kw)
    params = _mae_params(jmod, x, noise)
    assert set(params["blocks"]) == {"block"}
    assert {"decoder_blocks_0", "decoder_blocks_1"} <= set(params)
    ours = jax_to_torch_state(params)
    theirs = export_torch_state(params)
    assert set(ours) == set(theirs)
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    model = load_jax_params(MAE(attn_impl="EINSUM", scan_layers=True, **kw), params).eval()
    assert set(model.state_dict()) == set(theirs)
    want, _ = jmod.apply({"params": params}, jnp.asarray(x), mask_noise=jnp.asarray(noise))
    got, _ = model(torch.from_numpy(x), mask_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MAE_PRED_TOL, rtol=0)


# ---------------------------------------------------------------- loss and train step


def _mae_raw(loss_fn="maskMSE", **trainer):
    ia = {"default_vars": ["ct"], "tile_size": [16, 16, 16], "patch_size": 4, "twoD": False,
          "adaptive_patching": False, "use_varemb": False, **MAE_KW}
    m = {"lr": 1e-3, "beta_1": 0.9, "beta_2": 0.95, "weight_decay": 1e-2, "warmup_steps": 2,
         "max_steps": 20, "warmup_start_lr": 1e-8, "eta_min": 1e-8, "loss_fn": loss_fn,
         "net": {"init_args": ia}}
    return {"trainer": {"task": "mae", "attn_impl": "EINSUM", **trainer}, "parallelism": {},
            "model": m, "data": {"batch_size": 4, "num_channels_used": {"ct": 1}}}


@pytest.mark.parametrize("loss_fn", ["maskMSE", "MSE"])
def test_mae_loss_matches_build_mae(monkeypatch, loss_fn):
    """The port's `task_loss` against `build_mae`'s own loss_fn: the port's
    model draws its mask noise from its seeded generator, and the JAX
    model's draw is replaced by the same noise."""
    raw = _mae_raw(loss_fn)
    jmod, jloss = jax_build_mae(JConfig(raw=raw, task="mae"))
    x = _mae_x(4, 1, 16, 16, 16)
    noise = torch.rand(4, 64, generator=torch.Generator().manual_seed(5)).numpy()
    params = _mae_params(jmod, x, noise)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(noise))
    want, _ = jloss(params, {"x": jnp.asarray(x)}, jax.random.key(0))
    cfg = Config(raw=raw, task="mae")
    model = load_jax_params(build_mae(cfg), params).train()
    model.set_generator(torch.Generator().manual_seed(5), torch.Generator().manual_seed(6))
    got, aux = task_loss(cfg)(model, {"x": torch.from_numpy(x)})
    assert aux == {} and got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6


def _jax_mae_loss(jmod, patch, twoD):
    """`build_mae`'s maskMSE loss with the mask noise taken from the batch:
    the JAX step is jitted, so the noise must enter as data."""
    def loss_fn(params, batch, rng):
        pred, mask = jmod.apply({"params": params}, batch["x"], deterministic=False,
                                mask_noise=batch["mask_noise"], rngs={"dropout": rng})
        return jax_metrics.masked_mse(pred, jpatchify(batch["x"], patch, twoD), mask), {}
    return loss_fn


def _port_mae_loss(patch, twoD):
    """The port's maskMSE loss with the mask noise taken from the batch, as
    `_jax_mae_loss` takes it on the JAX side."""
    def loss_fn(model, batch):
        pred, mask = model(batch["x"], mask_noise=batch["mask_noise"])
        return metrics.masked_mse(pred, patchify(batch["x"], patch, twoD), mask), {}
    return loss_fn


def _mae_optimizer(target, raw, configure):
    m = raw["model"]
    return configure(target, lr=m["lr"], beta_1=m["beta_1"], beta_2=m["beta_2"],
                     weight_decay=m["weight_decay"], warmup_steps=m["warmup_steps"],
                     max_steps=m["max_steps"], warmup_start_lr=m["warmup_start_lr"],
                     eta_min=m["eta_min"])


MAE_CASES = {  # trainer keys, the port's attention, the loss tolerance
    "f32": (dict(), "EINSUM", LOSS_TOL),
    "f32_flash_accum2": (dict(accum_steps=2), "FLASH", LOSS_TOL),
    "bf16_remat": (dict(data_type="bfloat16", remat=True), "FLASH", MAE_BF16_LOSS_TOL),
}


@pytest.mark.parametrize("case", sorted(MAE_CASES))
def test_mae_train_steps_match_jax(case):
    """Five steps from one init on the same batches and the same per-step
    mask noise (split with the batch under accumulation)."""
    trainer, impl, tol = MAE_CASES[case]
    raw = _mae_raw(**trainer)
    jcfg = JConfig(raw=raw, task="mae")
    jmod, _ = jax_build_mae(jcfg)
    assert jmod.remat == bool(trainer.get("remat"))
    stream = synthetic_batches(Config(raw=raw, task="mae"), 4)
    batches = [{"x": b["x"], "mask_noise": _mae_noise(4, 64, seed=10 + i)}
               for i, b in zip(range(MAE_STEPS), stream)]
    assert set(next(stream)) == {"x", "variables"}  # MAE's synthetic batches have no label
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(batches[0]["x"]),
                                  mask_noise=jnp.asarray(batches[0]["mask_noise"]))["params"])
    params = jax.tree.map(jnp.asarray, params)
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=None, ema_params=None)
    accum = trainer.get("accum_steps", 1)
    jstep = jax_make_train_step(_jax_mae_loss(jmod, 4, False), tx, donate=False,
                                accum_steps=accum)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    raw["trainer"]["attn_impl"] = impl
    cfg = Config(raw=raw, task="mae")
    model = load_jax_params(build_mae(cfg), jax.device_get(params))
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt)
    step = make_train_step(_port_mae_loss(4, False), opt, accum_steps=accum)
    losses = []
    for b in batches:
        state, loss, aux = step(state, to_device(b, torch.device("cpu")))
        losses.append(loss.item())
    assert aux == {} and state.step == MAE_STEPS
    np.testing.assert_allclose(losses, jax_losses, atol=tol, rtol=0)
    if tol == LOSS_TOL:
        final = jax_to_torch_state(jax.device_get(jstate.params))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), final[name], atol=PARAM_TOL,
                                       rtol=0, err_msg=name)


# ---------------------------------------------------------------- entry points


def test_reconstruct_is_the_unpatchified_prediction_under_a_fixed_mask():
    raw = _mae_raw()
    cfg = Config(raw=raw, task="mae")
    model = init_eval_model(cfg, seed=0, device="cpu")
    assert isinstance(model, MAE) and not model.training
    x = torch.from_numpy(_mae_x(2, 1, 16, 16, 16))
    img = reconstruct(model, x, seed=3)
    assert img.shape == x.shape and torch.isfinite(img).all()
    assert torch.equal(img, reconstruct(model, x, seed=3))  # the same request, the same answer
    assert not torch.equal(img, reconstruct(model, x, seed=4))
    noise = torch.rand(2, 64, generator=torch.Generator().manual_seed(3))
    pred, _ = model(x, mask_noise=noise)
    assert torch.equal(img, unpatchify(pred, x.shape, 4, False))
    with pytest.raises(TypeError, match="MAE"):
        reconstruct(torch.nn.Linear(2, 2), x)


def test_cli_runs_mae_long_config_shrunk(tmp_path, capsys):
    """`configs/basic_ct/mae_long` (bf16, remat, scan_layers, maskMSE, a
    fsdp 2 x sp 4 ring mesh) through the CLI with `--single-device`, shrunk
    in memory to depth 1 and a 16^3 tile at CPU widths; every other key is
    the shipped one. Without `--single-device` its mesh of 8 processes is
    refused in a launch of one."""
    path = os.path.join(REPO, "configs", "basic_ct", "mae_long", "base_config.yaml")
    raw = yaml.safe_load(open(path))
    assert raw["trainer"]["data_type"] == "bfloat16" and raw["trainer"]["remat"] is True
    assert raw["model"]["loss_fn"] == "maskMSE" and raw["parallelism"]["seq_par_size"] == 4
    raw["model"]["net"]["init_args"].update(
        tile_size=[16, 16, 16], embed_dim=24, depth=1, num_heads=2, decoder_embed_dim=18,
        decoder_depth=1, decoder_num_heads=3)
    metrics_path = tmp_path / "metrics.jsonl"
    raw["trainer"]["metrics_path"] = str(metrics_path)
    raw["trainer"]["nan_guard"] = 2
    small = tmp_path / "mae_long_small.yaml"
    small.write_text(yaml.safe_dump(raw))
    with pytest.raises(RuntimeError, match="asks for 8 processes but 1 was launched.*"
                       "single-device"):
        main([str(small), "--synthetic", "--device", "cpu", "--max-steps", "2"])
    out = main([str(small), "--single-device", "--device", "cpu", "--synthetic",
                "--max-steps", "3"])
    log = capsys.readouterr().out
    assert "epoch 0 it 3 loss" in log and "epoch 0 done" in log
    model = out["state"].model
    assert isinstance(model, MAE) and model.remat and model.dtype == torch.bfloat16
    assert model.num_patches == 64 and model.len_keep == 16
    recs = metrics_path.read_text().splitlines()
    assert len(recs) == 4 and all(np.isfinite(out["loss_list"]))


# ================================================================ data, checkpoints, resume
#
# The port's data pipeline (`ucf_vit_tpu_torch/data/`) against the JAX package's
# (`ucf_vit_tpu/data/`) on the same files, made here from numpy seeds: NIfTI, .npy and
# JPEG. Batches must be equal array for array; five train steps from disk within
# LOSS_TOL a step of `ucf_vit_tpu.train`'s; resume after 2 epochs equal bit for bit to 3
# uninterrupted epochs (f32 on the CPU); checkpoints through the JAX package's
# `convert_checkpoint` both ways, the forwards within INTEROP_TOL.

import itertools

from ucf_vit_tpu import checkpoint as jax_ckpt
from ucf_vit_tpu.data import catsdogs as jax_catsdogs
from ucf_vit_tpu.data import nifti as jax_nifti
from ucf_vit_tpu.data import pipeline as jax_pipeline
from ucf_vit_tpu.data.datamodule import DataModule as JDataModule
from ucf_vit_tpu.data.load_balance import (
    calculate_load_balancing_from_config as jax_load_balancing,
)
from ucf_vit_tpu.tools.convert_checkpoint import main as convert_main
from ucf_vit_tpu.train import _init_variables as jax_init_variables
from ucf_vit_tpu.train import example_batch as jax_example_batch
from ucf_vit_tpu.train import train as jax_train
from ucf_vit_tpu_torch import checkpoint as ckpt
from ucf_vit_tpu_torch.data import catsdogs as port_catsdogs
from ucf_vit_tpu_torch.data import nifti
from ucf_vit_tpu_torch.data import pipeline as port_pipeline
from ucf_vit_tpu_torch.data.datamodule import DataModule
from ucf_vit_tpu_torch.data.load_balance import calculate_load_balancing_from_config
from ucf_vit_tpu_torch.inference import load_weights
from ucf_vit_tpu_torch.train import build_dataloader, init_train, train

INTEROP_TOL = 1e-5  # a forward on converted weights: the same sums in other orders


def _volumes(root, n, shape, kind="nii", dtype=np.int16, seed=0, labels=0):
    """`n` volumes under <root>/imagesTr (and, with `labels` classes, 1-based
    label volumes under <root>/labelsTr, as CT label files are)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "imagesTr"))
    if labels:
        os.makedirs(os.path.join(root, "labelsTr"))
    for i in range(n):
        vol = (rng.normal(size=shape) * 300).astype(dtype)
        if kind == "nii":
            nifti.save(os.path.join(root, "imagesTr", f"image{i}.nii"), vol)
        else:
            np.save(os.path.join(root, "imagesTr", f"image{i}.npy"), vol)
        if labels:
            lab = rng.integers(1, labels + 1, size=shape[-3:]).astype(np.int16)
            if kind == "nii":
                nifti.save(os.path.join(root, "labelsTr", f"label{i}.nii"), lab)
            else:
                np.save(os.path.join(root, "labelsTr", f"image{i}.npy"), lab - 1)
    return str(root)


def _jpegs(root, names, size=(40, 36), seed=0):
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in names:
        Image.fromarray(rng.integers(0, 255, size=size + (3,)).astype(np.uint8)).save(
            os.path.join(root, name))
    return str(root)


CATSDOGS = [f"{k}.{i}.jpg" for i, k in enumerate(["cat", "dog"] * 3)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert tuple(g[k]) == tuple(w[k]) if isinstance(w[k], (list, tuple)) \
                    else g[k] == w[k], k


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_nifti_round_trip_and_matches_jax_load(tmp_path, dtype):
    vol = (np.random.default_rng(3).normal(size=(7, 5, 3)) * 100).astype(dtype)
    nifti.save(str(tmp_path / "a.nii"), vol)
    jax_nifti.save(str(tmp_path / "b.nii"), vol)
    assert (tmp_path / "a.nii").read_bytes() == (tmp_path / "b.nii").read_bytes()
    got = nifti.load(str(tmp_path / "a.nii"))
    assert got.dtype == vol.dtype
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(got, jax_nifti.load(str(tmp_path / "a.nii")))
    np.testing.assert_array_equal(port_pipeline.read_nifti_file(str(tmp_path / "a.nii")),
                                  jax_pipeline.read_nifti_file(str(tmp_path / "a.nii")))


def _tiling_items(mod, case):
    rng = np.random.default_rng(5)
    if case == "tile_starts":
        return [mod.tile_starts(length, tile, ov, all_data)
                for length in (7, 16, 20, 33) for tile in (4, 8) for ov in (0.0, 0.25, 0.5)
                for all_data in (False, True) if tile <= length]
    if case == "shuffle":
        return list(mod.ShuffleBuffer(iter(range(37)), 8, rng=np.random.default_rng(1)))
    if case == "tiles2d":
        src = [(rng.normal(size=(3, 20, 18)), int(i), ["r", "g", "b"]) for i in range(2)]
        return list(mod.TileIterator2D(src, 8, 8, return_label=True, tile_overlap=0.25,
                                       use_all_data=True, classification=True))
    src = [(rng.normal(size=(1, 20, 16, 9)), rng.integers(0, 3, size=(20, 16, 9)), ["ct"])
           for _ in range(2)]
    return list(mod.TileIterator3D(src, 8, 8, 4, twoD=case == "tiles3d_twoD", return_label=True,
                                   use_all_data=True))


@pytest.mark.parametrize("case", ["tile_starts", "shuffle", "tiles2d", "tiles3d",
                                  "tiles3d_twoD"])
def test_tiling_and_shuffle_match_jax(case):
    got, want = _tiling_items(port_pipeline, case), _tiling_items(jax_pipeline, case)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            assert g == w


def test_load_balancing_matches_jax(tmp_path):
    roots = {"big": _volumes(tmp_path / "big", 3, (16, 16, 8), seed=1),
             "small": _volumes(tmp_path / "small", 2, (16, 16, 8), kind="npy", seed=2)}
    ia = {"tile_size": [16, 8, 4], "twoD": False}
    conf = {"model": {"net": {"init_args": ia}},
            "data": {"dataset": "basic_ct", "dict_root_dirs": roots,
                     "dict_start_idx": {"big": 0, "small": 0},
                     "dict_end_idx": {"big": 1, "small": 1},
                     "num_channels_used": {"big": 1, "small": 1}, "single_channel": True,
                     "batch_size": 2, "tile_overlap": 0.0, "use_all_data": False}}
    for dp in (2, 3, 4):
        assert calculate_load_balancing_from_config(conf, dp) == jax_load_balancing(conf, dp)
    bpre, groups = calculate_load_balancing_from_config(conf, 3)
    assert groups == "2:1" and bpre == {"big": 2, "small": 4}


def _dm_case(tmp_path, case):
    """(DataModule kwargs both packages take, epochs' batch count)."""
    kw = dict(dict_buffer_sizes={}, tile_size_x=8, tile_size_y=8, tile_size_z=4, twoD=False,
              single_channel=True, dataset="basic_ct", batch_size=2, seed=3)
    if case == "ct3d_nii":
        roots = {"ct": _volumes(tmp_path / "ct", 3, (16, 16, 8))}
    elif case == "ct3d_labels":
        roots = {"ct": _volumes(tmp_path / "ct", 3, (16, 8, 8), labels=3)}
        kw.update(return_label=True, num_classes=3)
    elif case == "twoD_npy":
        roots = {"ct": _volumes(tmp_path / "ct", 2, (16, 16, 6), kind="npy", dtype=np.float32)}
        kw.update(twoD=True, tile_size_z=2)
    elif case == "single_channel_2ch":
        roots = {"ct": _volumes(tmp_path / "ct", 2, (2, 16, 8, 8), kind="npy",
                                dtype=np.float32)}
        kw.update(dict_in_variables={"ct": ["a", "b"]}, num_channels_used={"ct": 2})
    else:  # two datasets, scheduled by the group list over two ranks
        roots = {"a": _volumes(tmp_path / "a", 3, (16, 8, 8)),
                 "b": _volumes(tmp_path / "b", 2, (8, 8, 8), kind="npy", seed=4)}
        kw.update(dataset_group_list="1:1", data_par_size=2,
                  batches_per_rank_epoch={"a": 6, "b": 1})
    keys = list(roots)
    kw["dict_root_dirs"] = roots
    kw["dict_buffer_sizes"] = {k: 4 for k in keys}
    kw.setdefault("dict_in_variables", {k: ["ct"] for k in keys})
    kw.setdefault("num_channels_used", {k: 1 for k in keys})
    kw.update(dict_start_idx={k: 0.0 for k in keys}, dict_end_idx={k: 1.0 for k in keys})
    return kw


@pytest.mark.parametrize("case", ["ct3d_nii", "ct3d_labels", "twoD_npy", "single_channel_2ch",
                                  "two_datasets"])
def test_datamodule_batches_match_jax(tmp_path, case):
    """Two epochs pinned by `set_epoch`, as the trainer runs them (`loop=True`, past
    the end of each chain), and a `skip_batches` fast-forward; the port prefetches
    on its thread, the JAX side reads in line."""
    kw = _dm_case(tmp_path, case)
    port = DataModule(**kw, prefetch=2)
    jdm = JDataModule(**kw, prefetch=0)
    port.setup()
    jdm.setup()
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jdm.set_epoch(epoch)
        n = 7
        got = list(itertools.islice(port.train_dataloader(loop=True), n))
        want = list(itertools.islice(jdm.train_dataloader(loop=True), n))
        _assert_batches_equal(got, want)
        if case == "single_channel_2ch":  # every batch channel-pure
            assert {b["variables"] for b in got} == {("a",), ("b",)}
    # fresh chains (the prefetch thread read ahead of the JAX side on the old ones)
    port.set_epoch(2)
    jdm.set_epoch(2)
    _assert_batches_equal(list(port.train_dataloader(skip_batches=2)),
                          list(jdm.train_dataloader(skip_batches=2)))


def _catsdogs_raw(root, **trainer):
    ia = {"default_vars": ["red", "green", "blue"], "tile_size": [16, 16], "patch_size": 8,
          "embed_dim": 32, "depth": 2, "num_heads": 2, "mlp_ratio": 2, "twoD": True,
          "adaptive_patching": False, "num_classes": 2}
    return {"trainer": {"task": "classification", "attn_impl": "EINSUM", "max_epochs": 2,
                        "seed": 0, **trainer},
            "parallelism": {"fsdp_size": 1, "simple_ddp_size": 1, "tensor_par_size": 1,
                            "seq_par_size": 1},
            "model": {"lr": 1e-3, "beta_1": 0.9, "beta_2": 0.95, "weight_decay": 1e-2,
                      "warmup_steps": 2, "max_steps": 20, "warmup_start_lr": 1e-5,
                      "eta_min": 1e-6, "net": {"init_args": ia}},
            "data": {"dataset": "catsdogs", "dict_root_dirs": {"catsdogs": root},
                     "dict_start_idx": {"catsdogs": 0}, "dict_end_idx": {"catsdogs": 1},
                     "dict_buffer_sizes": {"catsdogs": 4},
                     "num_channels_used": {"catsdogs": 3},
                     "dict_in_variables": {"catsdogs": ["red", "green", "blue"]},
                     "batch_size": 2, "num_classes": 2, "single_channel": False},
            "load_balancing": {"auto_load_balancing": False}}


def test_catsdogs_batches_match_jax(tmp_path):
    root = _jpegs(tmp_path / "cd", CATSDOGS)
    files = port_catsdogs.list_file_split(root, 0.0, 1.0)
    assert files == jax_catsdogs.list_file_split(root, 0.0, 1.0) and len(files) == 6
    ds = port_catsdogs.CatsDogsDataset(files, ("red", "green", "blue"), (16, 16))
    jds = jax_catsdogs.CatsDogsDataset(files, ("red", "green", "blue"), (16, 16))
    for seed, skip in ((0, 0), (1, 1)):
        _assert_batches_equal(list(port_catsdogs.catsdogs_loader(ds, 2, seed=seed,
                                                                 skip_batches=skip)),
                              list(jax_catsdogs.catsdogs_loader(jds, 2, seed=seed,
                                                                skip_batches=skip)))
    # through the trainers' build_dataloader: the epochs chained, the second reshuffled
    raw = _catsdogs_raw(root)
    dm, _, bpre = build_dataloader(Config(raw=raw, task="classification"), 2, False)
    assert bpre == {"catsdogs": 3}
    from ucf_vit_tpu.train import build_dataloader as jax_build_dataloader

    jdm, _, jbpre = jax_build_dataloader(JConfig(raw=raw, task="classification"), 2, False)
    assert jbpre == bpre
    _assert_batches_equal(list(itertools.islice(dm.train_dataloader(loop=True), 5)),
                          list(itertools.islice(jdm.train_dataloader(loop=True), 5)))


def test_jpeg_reading_names_a_missing_module(tmp_path, monkeypatch):
    root = _jpegs(tmp_path / "cd", CATSDOGS[:2])
    files = sorted(os.path.join(root, f) for f in os.listdir(root))
    ds = port_catsdogs.CatsDogsDataset(files, ("r", "g", "b"), (16, 16))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        ds[0]
    with pytest.raises(ImportError, match="cv2"):
        port_pipeline.read_imagenet_file(ds.file_list[0])


def _jax_init_as_torch_file(raw, path):
    """The JAX trainer's own init (`ucf_vit_tpu/train.py:340-346`: keys 0, 1, 2) of
    `raw`, exported under torch names into a `to-torch`-style file."""
    jcfg = JConfig(raw=raw, task=raw["trainer"]["task"])
    jmod, _ = (jax_build_classification if jcfg.task == "classification" else jax_build_mae)(jcfg)
    rngs = {"params": jax.random.key(0), "mask": jax.random.key(1), "dropout": jax.random.key(2)}
    variables = jax_init_variables(jmod, rngs, jcfg, jax_example_batch(jcfg, jcfg.batch_size), None)
    params = jax.device_get(meta.unbox(variables["params"]))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in export_torch_state(params).items()}
    torch.save({"epoch": 0, "model_state_dict": sd, "loss_list": []}, path)
    return params


def _metrics_losses(path):
    return [json.loads(line)["loss"] for line in open(path) if '"loss"' in line]


def test_train_from_disk_matches_jax(tmp_path):
    """Five f32 steps of a tiny ViT on catsdogs JPEGs through both trainers: the port
    warm-started (`init_params_from`) from the JAX trainer's own init, both reading the
    same files; per-step losses within LOSS_TOL."""
    root = _jpegs(tmp_path / "cd", CATSDOGS)
    raw = _catsdogs_raw(root, metrics_path=str(tmp_path / "jax.jsonl"))
    jax_out = jax_train(JConfig(raw=raw, task="classification"), max_steps=5)
    init = tmp_path / "init.ckpt"
    _jax_init_as_torch_file(raw, str(init))
    raw["trainer"].update(metrics_path=str(tmp_path / "port.jsonl"), init_params_from=str(init))
    out = train(Config(raw=raw, task="classification"), max_steps=5, device="cpu")
    got, want = _metrics_losses(tmp_path / "port.jsonl"), _metrics_losses(tmp_path / "jax.jsonl")
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(out["loss_list"], jax_out["loss_list"], atol=LOSS_TOL, rtol=0)
    assert len(out["loss_list"]) == 2  # 3 batches an epoch, then 2 of the next


def _tiny_state(cfg_raw=None, ema=True):
    raw = cfg_raw or _raw()
    if ema:
        raw["trainer"]["ema_decay"] = 0.9
    raw["model"]["use_grad_scaler"] = True
    cfg = Config(raw=raw, task="classification")
    state, step = init_train(cfg, "cpu")
    for b in itertools.islice(synthetic_batches(cfg, 4), 2):
        state, _, _ = step(state, to_device(b, torch.device("cpu")))
    return cfg, state, step


def test_checkpoint_slots_rotate_and_resolve(tmp_path):
    cfg, state, _ = _tiny_state()
    d = str(tmp_path / "ck")
    paths = [ckpt.save_checkpoint(d, "last", e, state, [0.5] * (e + 1)) for e in range(3)]
    assert [os.path.basename(p) for p in paths] == ["last_even.ckpt", "last_odd.ckpt",
                                                    "last_even.ckpt"]
    assert sorted(os.listdir(d)) == ["last_even.ckpt", "last_odd.ckpt"]  # no temporary left
    assert ckpt.stored_epoch(paths[0]) == 2 and ckpt.stored_epoch(paths[1]) == 1
    even, odd = paths[0], paths[1]
    assert ckpt.resolve_slot(d, "last_latest") == even
    assert ckpt.resolve_slot(d, "") == even
    assert ckpt.resolve_slot(d, "last_odd") == odd == ckpt.resolve_slot(d, "last_odd.ckpt")
    assert ckpt.resolve_slot(odd, "last_even") == odd  # a file is itself
    ckpt.save_checkpoint(d, "last", 3, state)
    assert ckpt.resolve_slot(d, "last_latest") == odd == ckpt.resolve_slot(d, "")
    with pytest.raises(FileNotFoundError, match="last_even.ckpt"):
        ckpt.resolve_slot(d, "nothing")
    with pytest.raises(FileNotFoundError):
        ckpt.resolve_slot(str(tmp_path / "none"), "last_latest")
    orbax = tmp_path / "ck" / "jax_slot"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="to-torch"):
        ckpt.resolve_slot(d, "jax_slot")


def test_checkpoint_head_meta_guard(tmp_path):
    cfg, state, _ = _tiny_state()
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, "last", 0, state, head_meta=ckpt.head_meta_from_config(cfg))
    assert ckpt.head_meta_from_config(cfg) == (2, 0)
    assert jax_ckpt.head_meta_from_config(JConfig(raw=cfg.raw, task=cfg.task)) == (2, 0)
    ckpt.restore_checkpoint(d, "last_latest", expect_head_meta=(2, 0))
    ckpt.restore_checkpoint(d, "last_latest", expect_head_meta=(2, None))
    with pytest.raises(ValueError, match="regrouping"):
        ckpt.restore_checkpoint(d, "last_latest", expect_head_meta=(4, 0))
    # a trainer whose heads were regrouped refuses to resume from it
    raw = _raw(net={"init_args": {**_raw()["model"]["net"]["init_args"], "num_heads": 4}})
    raw["trainer"].update(checkpoint_path=d, checkpoint_filename_for_loading="last_latest",
                          resume_from_checkpoint=True)
    with pytest.raises(ValueError, match="regrouping"):
        train(Config(raw=raw, task="classification"), synthetic=True, device="cpu")


def test_checkpoint_round_trip_of_the_full_state(tmp_path):
    cfg, state, step = _tiny_state()
    state.model.host_generator.manual_seed(11)
    path = ckpt.save_checkpoint(str(tmp_path), "s", 4, state, [1.0, 0.5], head_meta=(2, 0),
                                total_steps=9)
    payload = ckpt.restore_checkpoint(path, "")
    assert payload["epoch"] == 4 and payload["loss_list"] == [1.0, 0.5]
    assert payload["total_steps"] == 9 and payload["head_meta"] == [2, 0]
    fresh, _ = init_train(Config(raw=cfg.raw, task=cfg.task), "cpu", init_seed=5)
    ckpt.restore_train_state(fresh, payload, ema_decay=0.9)
    for (n, p), (m, q) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert n == m and torch.equal(p, q)
    for n in state.ema_params:
        assert torch.equal(state.ema_params[n], fresh.ema_params[n])
    a, b = state.optimizer.adamw.state_dict(), fresh.optimizer.adamw.state_dict()
    for i in a["state"]:
        for k in a["state"][i]:
            assert torch.equal(a["state"][i][k], b["state"][i][k])
    assert fresh.optimizer.count == state.optimizer.count == 2 and fresh.step == state.step
    assert fresh.loss_scale == state.loss_scale
    assert torch.equal(fresh.model.host_generator.get_state(),
                       state.model.host_generator.get_state())
    assert torch.equal(fresh.model.generator.get_state(), state.model.generator.get_state())
    # EMA reconciled with the config: off now drops it, on without one on disk seeds it
    ckpt.restore_train_state(fresh, payload, ema_decay=None)
    assert fresh.ema_params is None
    del payload["ema_state_dict"]
    ckpt.restore_train_state(fresh, {**payload, "ema_state_dict": None}, ema_decay=0.9)
    assert all(torch.equal(fresh.ema_params[n], p)
               for n, p in fresh.model.named_parameters())
    with pytest.raises(ValueError, match="init_params_from"):
        ckpt.restore_train_state(fresh, {"model_state_dict": payload["model_state_dict"]}, 0.9)


def _resume_raw(tmp_path, kind):
    if kind == "vit":
        raw = _catsdogs_raw(_jpegs(tmp_path / "cd", CATSDOGS))
        raw["model"]["net"]["init_args"].update(drop_path=0.1, attn_drop_rate=0.1)
        raw["trainer"].update(ema_decay=0.9)
        raw["model"]["use_grad_scaler"] = True
        return raw, "classification"
    root = _volumes(tmp_path / "ct", 2, (32, 16, 16))
    ia = {"default_vars": ["ct"], "tile_size": [16, 16, 16], "twoD": False,
          "adaptive_patching": False, **MAE_KW, "patch_size": 4, "depth": 1, "decoder_depth": 1}
    raw = {"trainer": {"task": "mae", "attn_impl": "FLASH", "seed": 1},
           "parallelism": {},
           "model": {"lr": 1e-3, "warmup_steps": 1, "max_steps": 20, "loss_fn": "maskMSE",
                     "net": {"init_args": ia}},
           "data": {"dataset": "basic_ct", "dict_root_dirs": {"ct": root},
                    "dict_start_idx": {"ct": 0}, "dict_end_idx": {"ct": 1},
                    "dict_buffer_sizes": {"ct": 3}, "num_channels_used": {"ct": 1},
                    "dict_in_variables": {"ct": ["ct"]}, "batch_size": 2,
                    "single_channel": True, "num_workers": 4, "tile_overlap": 0.0,
                    "use_all_data": False},
           "load_balancing": {"auto_load_balancing": True}}
    return raw, "mae"


@pytest.mark.parametrize("kind", ["vit", "mae"])
def test_resume_equals_uninterrupted_bit_for_bit(tmp_path, kind):
    """3 epochs in one run against 2 epochs, then a run resumed to 3, from disk:
    parameters, AdamW's moments, EMA, the loss list and the generators equal bit
    for bit (the ViT draws dropout, DropPath and the loss scale; the MAE its
    masks)."""
    raw, task = _resume_raw(tmp_path, kind)

    def run(name, epochs, resume=False):
        r = copy.deepcopy(raw)
        r["trainer"].update(max_epochs=epochs, checkpoint_path=str(tmp_path / name),
                            checkpoint_filename="last",
                            checkpoint_filename_for_loading="last_latest",
                            resume_from_checkpoint=resume)
        return train(Config(raw=r, task=task), device="cpu")

    whole = run("whole", 3)
    run("part", 2)
    assert sorted(os.listdir(tmp_path / "part")) == ["last_even.ckpt", "last_odd.ckpt"]
    resumed = run("part", 3, resume=True)
    assert resumed["loss_list"] == whole["loss_list"] and len(whole["loss_list"]) == 3
    a, b = whole["state"], resumed["state"]
    for (n, p), (m, q) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert n == m and torch.equal(p, q), n
    sa, sb = a.optimizer.adamw.state_dict()["state"], b.optimizer.adamw.state_dict()["state"]
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    assert a.optimizer.count == b.optimizer.count and a.loss_scale == b.loss_scale
    assert torch.equal(a.model.generator.get_state(), b.model.generator.get_state())
    if kind == "vit":
        assert all(torch.equal(a.ema_params[n], b.ema_params[n]) for n in a.ema_params)
    # the two runs' last checkpoints are the same file contents
    pa = ckpt.restore_checkpoint(str(tmp_path / "whole"), "last_latest")
    pb = ckpt.restore_checkpoint(str(tmp_path / "part"), "last_latest")
    assert pa["epoch"] == pb["epoch"] == 2 and pa["total_steps"] == pb["total_steps"]


def _jax_forward(raw, params, x):
    jcfg = JConfig(raw=raw, task="classification")
    jmod, _ = jax_build_classification(jcfg)
    return np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))


def test_port_checkpoint_converts_with_to_jax(tmp_path):
    """A checkpoint the port's trainer wrote goes through `convert_checkpoint to-jax`
    unchanged; the JAX forward on the result equals the port's."""
    raw = _catsdogs_raw(_jpegs(tmp_path / "cd", CATSDOGS))
    raw["trainer"].update(checkpoint_path=str(tmp_path / "ck"), checkpoint_filename="last",
                          ema_decay=0.9)
    out = train(Config(raw=raw, task="classification"), max_steps=4, device="cpu")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    src = tmp_path / "ck" / "last_odd.ckpt"
    assert convert_main(["to-jax", str(src), str(cfg_path), str(tmp_path / "jax"),
                         "--filename", "conv"]) == 0
    payload = jax_ckpt.restore_checkpoint(str(tmp_path / "jax"), "conv_latest",
                                          expect_head_meta=(2, 0))
    assert int(payload["epoch"]) == 1
    assert jax_ckpt.loss_list_from_payload(payload) == out["loss_list"]
    x = np.random.default_rng(9).normal(size=(3, 3, 16, 16)).astype(np.float32)
    model = out["state"].model.eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_jax_forward(raw, payload["state"]["params"], x), ours,
                               atol=INTEROP_TOL, rtol=0)


def test_jax_checkpoint_loads_through_init_params_from_and_load_weights(tmp_path):
    """A JAX checkpoint (`save_checkpoint`, Orbax) exported by `convert_checkpoint
    to-torch` warm-starts the port's trainer and loads into a served model; both
    forwards equal the JAX one."""
    raw = _catsdogs_raw(_jpegs(tmp_path / "cd", CATSDOGS))
    jcfg = JConfig(raw=raw, task="classification")
    jmod, _ = jax_build_classification(jcfg)
    params = meta.unbox(jmod.init(jax.random.key(3), jnp.zeros((1, 3, 16, 16)))["params"])
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
                          .astype(np.float32), params)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), "run", 5, {"params": params},
                             loss_list=[0.7], head_meta=(2, 0))
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    exported = tmp_path / "exported.ckpt"
    assert convert_main(["to-torch", str(tmp_path / "jax"), "run_latest", str(cfg_path),
                         str(exported)]) == 0
    with pytest.raises(ValueError, match="to-torch"):  # the Orbax directory itself
        ckpt.resolve_slot(str(tmp_path / "jax"), "run_odd")
    x = np.random.default_rng(9).normal(size=(2, 3, 16, 16)).astype(np.float32)
    want = _jax_forward(raw, params, x)

    warm = copy.deepcopy(raw)
    warm["trainer"]["init_params_from"] = str(exported)
    warm["model"].update(lr=0.0, warmup_start_lr=0.0, eta_min=0.0, weight_decay=0.0)
    out = train(Config(raw=warm, task="classification"), max_steps=1, device="cpu")
    with torch.no_grad():
        got = out["state"].model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=INTEROP_TOL, rtol=0)

    served = init_eval_model(Config(raw=raw, task="classification"), seed=1, device="cpu")
    assert load_weights(served, Config(raw=raw, task="classification"), str(exported)) == 5
    with torch.no_grad():
        np.testing.assert_allclose(served(torch.from_numpy(x)).numpy(), want,
                                   atol=INTEROP_TOL, rtol=0)
    with pytest.raises(ValueError, match="no EMA"):
        load_weights(served, Config(raw=raw, task="classification"), str(exported),
                     use_ema=True)


# ================================================================ DiffusionVIT + DDPM
#
# DiffusionVIT and the DDPM functions against the JAX package's, at depth 2, embed 24,
# decoder 16 (2-D) or 18 (3-D). Weights are the flax init plus numpy noise, moved across
# with `load_jax_params`; inputs, steps t and noise e come from numpy seeds and are
# injected into both sides; the time embedding's dropout is off on both (JAX
# `deterministic=True`, the port's module in eval mode). Tolerances: the time table
# exact (numpy on both sides); the schedule within 1e-6 relative (f32 cumprod in another
# order); `q_sample` and the loss within 1e-6; `pred` within 1e-5; per-step losses of
# 5 f32 train steps within 1e-4; the reverse chain at T = 10 within 1e-4.

from ucf_vit_tpu.models.ddpm import ddpm_sample as jax_ddpm_sample
from ucf_vit_tpu.models.ddpm import ddpm_schedule as jax_ddpm_schedule
from ucf_vit_tpu.models.ddpm import q_sample as jax_q_sample
from ucf_vit_tpu.models.diffusion import DiffusionVIT as JDiffusionVIT
from ucf_vit_tpu.ops.pos_embed import (
    sinusoidal_time_embedding_table as jax_time_table,
)
from ucf_vit_tpu.tasks import build_diffusion as jax_build_diffusion
from ucf_vit_tpu_torch.models import DiffusionVIT, ddpm_sample, ddpm_schedule, q_sample
from ucf_vit_tpu_torch.ops.pos_embed import sinusoidal_time_embedding_table
from ucf_vit_tpu_torch.tasks import build_diffusion

DIFF_PRED_TOL = 1e-5  # pred, f32
DIFF_SAMPLE_TOL = 1e-4  # the reverse chain, T = 10
DIFF_STEPS = 5
DIFF_T = 50  # time steps of the models below
DIFF_TILES = {
    "2d": dict(img_size=(16, 16), patch_size=4, in_chans=3, twoD=True, decoder_embed_dim=16),
    "3d": dict(img_size=(16, 16, 16), patch_size=4, in_chans=1, twoD=False),
}
DIFF_KW = dict(embed_dim=24, depth=2, num_heads=2, decoder_embed_dim=18, decoder_depth=2,
               decoder_num_heads=2, mlp_ratio_decoder=2.0, mlp_ratio=2.0, time_steps=DIFF_T)


def _diff_shape(tile, b=2):
    kw = DIFF_TILES[tile]
    return (b, kw["in_chans"]) + tuple(kw["img_size"])


def _diff_t(b, steps=DIFF_T, seed=3):
    return np.random.default_rng(seed).integers(0, steps, size=b).astype(np.int64)


def _diff_pair(tile, impl="FLASH", **kw):
    """(JAX DiffusionVIT, its params (flax init plus N(0, 0.05) noise), the port's
    model with them in eval mode, input x, steps t)."""
    kw = dict(DIFF_KW, **DIFF_TILES[tile], **kw)
    x = _mae_x(*_diff_shape(tile))
    t = _diff_t(2, steps=kw["time_steps"])
    jmod = JDiffusionVIT(attn_impl=JAttnImpl.EINSUM, class_token=False, **kw)
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t))["params"])
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    ours = load_jax_params(DiffusionVIT(attn_impl=impl, **kw), params).eval()
    return jmod, params, ours, x, t


@pytest.mark.parametrize("steps,dim", [(1000, 768), (DIFF_T, 24), (7, 10)])
def test_time_table_equals_jax(steps, dim):
    want = jax_time_table(steps, dim)
    got = sinusoidal_time_embedding_table(steps, dim)
    assert got.dtype == np.float64 and got.shape == (steps, dim)
    np.testing.assert_array_equal(got, want)
    # interleaved: even dims sin, odd dims cos of the same angle (step 1, frequency 1 first)
    assert got[1, 0] == np.sin(1.0) and got[1, 1] == np.cos(1.0)
    assert np.all(got[0, 1::2] == 1.0) and np.all(got[0, 0::2] == 0.0)


@pytest.mark.parametrize("steps", [10, 1000])
def test_ddpm_schedule_matches_jax(steps):
    ours, ref = ddpm_schedule(steps), jax_ddpm_schedule(steps)
    assert ours.num_time_steps == ref.num_time_steps == steps
    for got, want in ((ours.beta, ref.beta), (ours.alpha_bar, ref.alpha_bar)):
        assert got.dtype == torch.float32 and got.shape == (steps,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("tile", sorted(DIFF_TILES))
def test_q_sample_matches_jax(tile):
    x0 = _mae_x(*_diff_shape(tile, b=3), seed=4)
    e = _mae_x(*_diff_shape(tile, b=3), seed=5)
    t = np.array([0, 499, 999])
    got = q_sample(ddpm_schedule(1000), torch.from_numpy(x0), torch.from_numpy(t),
                   torch.from_numpy(e))
    want = jax_q_sample(jax_ddpm_schedule(1000), jnp.asarray(x0), jnp.asarray(t), jnp.asarray(e))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["2d", "3d", "2d_linear_decoder"])
def test_diffusion_vit_matches_jax(case):
    """`pred` within DIFF_PRED_TOL, through `load_jax_params`; the port's state_dict
    agrees key for key with the JAX package's `export_torch_state` (the time table is
    in neither)."""
    tile, _, linear = case.partition("_")
    jmod, params, ours, x, t = _diff_pair(tile, linear_decoder=bool(linear))
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    pred = ours(torch.from_numpy(x), torch.from_numpy(t))
    assert pred.shape == want.shape == (2, ours.num_patches, ours.decoder_pred.out_features)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want), atol=DIFF_PRED_TOL,
                               rtol=0)
    theirs = export_torch_state(params)
    assert set(ours.state_dict()) == set(theirs) == set(jax_to_torch_state(params))
    assert "timeEmbeddingMap.linear1.weight" in theirs and "time_table" not in theirs
    assert (ours.decoder_blocks is None) == bool(linear)


def test_diffusion_vit_refuses_what_it_cannot_run():
    kw = dict(DIFF_KW, **DIFF_TILES["2d"])
    with pytest.raises(ValueError, match="class_token=False"):
        DiffusionVIT(class_token=True, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, modules to port: pipeline"):
        DiffusionVIT(pipe_par_size=2, scan_layers=True, **kw)


def _diff_raw(tile="2d", **trainer):
    kw = DIFF_TILES[tile]
    ia = {"default_vars": ["r", "g", "b"][:kw["in_chans"]], "tile_size": list(kw["img_size"]),
          "patch_size": kw["patch_size"], "twoD": kw["twoD"], "adaptive_patching": False,
          "use_varemb": False, **{k: v for k, v in DIFF_KW.items() if k != "time_steps"},
          "decoder_embed_dim": kw.get("decoder_embed_dim", DIFF_KW["decoder_embed_dim"]),
          "num_time_steps": DIFF_T}
    m = {"lr": 1e-3, "beta_1": 0.9, "beta_2": 0.95, "weight_decay": 1e-2, "warmup_steps": 2,
         "max_steps": 20, "warmup_start_lr": 1e-8, "eta_min": 1e-8, "loss_fn": "MSE",
         "net": {"init_args": ia}}
    return {"trainer": {"task": "diffusion", "attn_impl": "EINSUM", **trainer},
            "parallelism": {}, "model": m,
            "data": {"batch_size": 4, "num_channels_used": {"d": kw["in_chans"]}}}


def _diff_batch(cfg, b, i=0):
    x = next(synthetic_batches(cfg, b, seed=i))["x"]
    e = np.random.default_rng(20 + i).normal(size=x.shape).astype(np.float32)
    return {"x": x, "t": _diff_t(b, seed=10 + i), "e": e}


@pytest.mark.parametrize("tile", sorted(DIFF_TILES))
def test_diffusion_loss_matches_build_diffusion(monkeypatch, tile):
    """The port's `task_loss` with `(t, e)` in the batch against `build_diffusion`'s
    own loss_fn with its draws of t and e replaced by the same arrays."""
    raw = _diff_raw(tile)
    cfg = Config(raw=raw, task="diffusion")
    jmod, jloss = jax_build_diffusion(JConfig(raw=raw, task="diffusion"))
    batch = _diff_batch(cfg, 4)
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(batch["x"]),
                                  jnp.zeros(4, jnp.int32))["params"])
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(batch["t"]))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(batch["e"]))
    want, _ = jloss(params, {"x": jnp.asarray(batch["x"])}, jax.random.key(0),
                    deterministic=True)
    model = load_jax_params(build_diffusion(cfg), params).eval()
    got, aux = task_loss(cfg)(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert aux == {} and got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6


def _jax_diff_loss(jmod, patch, twoD):
    """`build_diffusion`'s loss with t and e taken from the batch and the time
    embedding's dropout off: the JAX step is jitted, so they must enter as data."""
    def loss_fn(params, batch, rng):
        x0 = batch["x"]
        xt = jax_q_sample(jax_ddpm_schedule(DIFF_T), x0, batch["t"], batch["e"])
        pred = jmod.apply({"params": params}, xt, batch["t"], deterministic=True)
        return jax_metrics.mse(junpatchify(pred, x0.shape, patch, twoD), batch["e"]), {}
    return loss_fn


def _port_diff_loss(cfg):
    """The port's diffusion loss on the batch's t and e with the time embedding's
    dropout off (the train step puts every module in training mode first)."""
    loss = task_loss(cfg)

    def loss_fn(model, batch):
        model.timeEmbeddingMap.eval()
        return loss(model, batch)
    return loss_fn


@pytest.mark.parametrize("case", ["f32", "f32_flash_accum2"])
def test_diffusion_train_steps_match_jax(case):
    """Five f32 steps from one init on the same batches, steps and noise (split with
    the batch under accumulation): per-step losses within LOSS_TOL, parameters after
    them within PARAM_TOL."""
    impl, accum = ("FLASH", 2) if "flash" in case else ("EINSUM", 1)
    raw = _diff_raw("2d", accum_steps=accum)
    cfg = Config(raw=raw, task="diffusion")
    jmod, _ = jax_build_diffusion(JConfig(raw=raw, task="diffusion"))
    stream = synthetic_batches(cfg, 4)
    batches = []
    for i, b in zip(range(DIFF_STEPS), stream):
        assert set(b) == {"x", "variables"}  # diffusion's synthetic batches hold x only
        batches.append({"x": b["x"], "t": _diff_t(4, seed=10 + i),
                        "e": _mae_x(*b["x"].shape, seed=20 + i)})
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(batches[0]["x"]),
                                  jnp.zeros(4, jnp.int32))["params"])
    params = jax.tree.map(jnp.asarray, params)
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=None, ema_params=None)
    jstep = jax_make_train_step(_jax_diff_loss(jmod, 4, True), tx, donate=False,
                                accum_steps=accum)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    raw["trainer"]["attn_impl"] = impl
    cfg = Config(raw=raw, task="diffusion")
    model = load_jax_params(build_diffusion(cfg), jax.device_get(params))
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt)
    step = make_train_step(_port_diff_loss(cfg), opt, accum_steps=accum)
    losses = []
    for b in batches:
        state, loss, aux = step(state, to_device(b, torch.device("cpu")))
        losses.append(loss.item())
    assert aux == {} and state.step == DIFF_STEPS
    np.testing.assert_allclose(losses, jax_losses, atol=LOSS_TOL, rtol=0)
    final = jax_to_torch_state(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name], atol=PARAM_TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("tile", sorted(DIFF_TILES))
def test_ddpm_sample_matches_jax(tile):
    """The reverse chain at T = 10 on one model: the JAX sampler under its own key,
    the port's on the arrays of that key chain (a split for x_T, then one split and
    one normal a step, the last step's included)."""
    steps = 10
    jmod, params, ours, x, _ = _diff_pair(tile, time_steps=steps)
    kw = DIFF_TILES[tile]
    shape = x.shape

    def jdenoise(x_t, t):
        return junpatchify(jmod.apply({"params": params}, x_t, t), shape, kw["patch_size"],
                           kw["twoD"])

    key = jax.random.key(5)
    want = np.asarray(jax.jit(lambda k: jax_ddpm_sample(jax_ddpm_schedule(steps), jdenoise, k,
                                                        shape))(key))
    key, init_key = jax.random.split(key)
    x_T = np.array(jax.random.normal(init_key, shape))
    noises = []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noises.append(torch.from_numpy(np.array(jax.random.normal(nkey, shape))))

    def denoise(x_t, t):
        return unpatchify(ours(x_t, t), shape, kw["patch_size"], kw["twoD"])

    state = torch.random.get_rng_state()
    got = ddpm_sample(ddpm_schedule(steps), denoise, None, shape, "cpu",
                      x_T=torch.from_numpy(x_T), noises=noises)
    assert torch.equal(state, torch.random.get_rng_state())
    assert got.shape == shape and np.all(np.isfinite(want))
    np.testing.assert_allclose(got.numpy(), want, atol=DIFF_SAMPLE_TOL, rtol=0)
    with pytest.raises(ValueError, match="explicit generator"):
        ddpm_sample(ddpm_schedule(steps), denoise, None, shape, "cpu")


def test_time_embedding_dropout_draws_from_the_model_generator():
    """At rate 0.5 the time MLP's dropout draws from the model's generator: a train
    step without one raises; two steps from one seed are equal bit for bit; torch's
    global generator is never touched; about half of the entries are kept, each
    scaled by 2."""
    from ucf_vit_tpu_torch.train import init_train

    cfg = Config(raw=_diff_raw("2d"), task="diffusion")
    batch = to_device(next(synthetic_batches(cfg, 4)), torch.device("cpu"))
    bare = build_diffusion(cfg).train()
    with pytest.raises(RuntimeError, match="set_generator"):
        task_loss(cfg)(bare, batch)
    seen = []

    def hook(module, inputs, output):
        seen.append((inputs[0].detach().clone(), output.detach().clone()))

    runs = []
    for _ in range(2):
        state, step = init_train(cfg, "cpu")  # building modules draws from torch's generator
        drop = state.model.timeEmbeddingMap.dropout
        assert drop.rate == 0.5 and drop.generator is state.model.generator
        handle = drop.register_forward_hook(hook)
        global_state = torch.random.get_rng_state()
        state, loss, _ = step(state, batch)
        assert torch.equal(global_state, torch.random.get_rng_state())  # the step does not
        handle.remove()
        runs.append((loss.item(), {n: p.detach().clone()
                                   for n, p in state.model.named_parameters()}))
    (la, pa), (lb, pb) = runs
    assert la == lb and all(torch.equal(pa[n], pb[n]) for n in pa)
    x_in, x_out = seen[0]
    assert torch.equal(seen[0][1], seen[1][1])
    kept = x_out != 0
    assert torch.equal(x_out[kept], 2 * x_in[kept])
    live = x_in != 0  # ReLU's zeros stay zero either way
    share = (kept & live).sum().item() / live.sum().item()
    assert 0.3 < share < 0.7, share


DIFF_CONFIGS = {"imagenet": ("configs/imagenet/diffusion/base_config.yaml", [16, 16], 3),
                "basic_ct": ("configs/basic_ct/diffusion/base_config.yaml", [16, 16, 16], 1)}


@pytest.mark.parametrize("name", sorted(DIFF_CONFIGS))
def test_cli_trains_diffusion_config_shrunk(tmp_path, capsys, name):
    """A shipped diffusion config (f32, 2 microbatches, loss scaling, a simple_ddp 8
    mesh) through the CLI with `--single-device`, shrunk in a copy to a 16^2 tile at
    patch 4, depth 2, embed 24 and a decoder of 16 (the rest as shipped): two epochs of
    two steps, each saved to its slot; then a run resumed from the newer slot to a
    third epoch keeps the first two epochs' losses."""
    rel, tile, chans = DIFF_CONFIGS[name]
    raw = yaml.safe_load(open(os.path.join(REPO, rel)))
    assert raw["trainer"]["task"] == "diffusion" and raw["trainer"]["accum_steps"] == 2
    assert raw["parallelism"]["simple_ddp_size"] == 8 and raw["model"]["use_grad_scaler"]
    raw["model"]["net"]["init_args"].update(
        tile_size=tile, patch_size=4, embed_dim=24, depth=2, num_heads=2, decoder_embed_dim=16,
        decoder_depth=2, decoder_num_heads=2)
    ck = tmp_path / "ck"
    raw["trainer"].update(checkpoint_path=str(ck), max_epochs=2,
                          checkpoint_filename_for_loading="multi_last_latest",
                          metrics_path=str(tmp_path / "metrics.jsonl"))
    raw["data"]["batch_size"] = 4
    raw["load_balancing"]["batches_per_rank_epoch"] = {
        k: 2 for k in raw["load_balancing"]["batches_per_rank_epoch"]}
    small = tmp_path / f"{name}_small.yaml"
    small.write_text(yaml.safe_dump(raw))
    with pytest.raises(RuntimeError, match="single-device"):  # 8 processes, 1 launched
        main([str(small), "--synthetic", "--device", "cpu"])
    out = main([str(small), "--single-device", "--device", "cpu", "--synthetic"])
    log = capsys.readouterr().out
    assert "epoch 1 it 2 loss" in log and "epoch 1 done" in log
    model = out["state"].model
    assert isinstance(model, DiffusionVIT) and model.num_patches == 16
    assert model.token_embeds.proj.in_channels == chans and model.time_steps == 1000
    assert len(out["loss_list"]) == 2 and all(np.isfinite(out["loss_list"]))
    assert sorted(os.listdir(ck)) == ["multi_last_even.ckpt", "multi_last_odd.ckpt"]
    assert ckpt.restore_checkpoint(str(ck), "multi_last_latest")["head_meta"] == [2, 2]

    raw["trainer"].update(max_epochs=3, resume_from_checkpoint=True)
    small.write_text(yaml.safe_dump(raw))
    resumed = main([str(small), "--single-device", "--device", "cpu", "--synthetic"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert resumed["loss_list"][:2] == out["loss_list"] and len(resumed["loss_list"]) == 3
    assert resumed["state"].optimizer.count == 6 and np.isfinite(resumed["loss_list"][2])


@pytest.mark.parametrize("source", ["flash_fwd_tf32", "flash_bwd_tf32", "flash_fwd_sm90",
                                    "flash_bwd_sm90"])
def test_kernel_instance_mirrors_the_sources_dispatch(source):
    """`kernel_instance` (the key of the launch counts by head-dim instance) picks
    the instance each source's `dispatch_dh` launches: the diffusion decoders' dh
    128 and 96 go to `DH = 128` and, in f32, `DH = 96`."""
    import re

    from ucf_vit_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        kernel_instance,
        reset_launch_counts,
    )

    text = open(os.path.join(REPO, "ucf_vit_tpu_torch", "csrc", f"{source}.cu")).read()
    dispatch = text[text.index("dispatch_dh("):]
    dispatch = dispatch[:dispatch.index("return cudaErrorInvalidValue")]
    bounds = [int(n) for n in re.findall(r"p\.dh <= (\d+)\) return launch<(?:\1)", dispatch)]
    assert bounds and bounds == sorted(bounds)
    for dh in range(1, bounds[-1] + 1):
        assert kernel_instance(source, dh) == f"{source}<{min(b for b in bounds if dh <= b)}>"
    with pytest.raises(ValueError, match="head dims up to"):
        kernel_instance(source, bounds[-1] + 1)
    assert kernel_instance("flash_fwd_tf32", 96) == "flash_fwd_tf32<96>"
    reset_launch_counts()
    q = torch.zeros(1, 1, 4, 8)
    flash_attention(q, q, q)  # a CPU call takes the plain version and counts nothing
    counts = flash_attention_bwd.by_instance if "bwd" in source else flash_attention.by_instance
    assert {k for k in counts if k.startswith(source)} == {f"{source}<{b}>" for b in bounds}
    assert not any(counts.values())


# ================================================================ trainer parity
#
# Validation, preemption with mid-epoch resume, TensorBoard and profile_dir
# (`ucf_vit_tpu/train.py:95-200,360-420,550-990`). Validation losses against the JAX
# trainer's within LOSS_TOL: the port warm-started from the JAX trainer's own init,
# attention EINSUM on both, the same synthetic streams or JPEG files. A run preempted
# mid-epoch (or on an epoch's last step) and resumed against an uninterrupted one: the
# per-step losses, the validation losses, the parameters, AdamW's moments and the
# generators bit for bit.

from ucf_vit_tpu.train import build_dataloader as jax_build_dataloader
from ucf_vit_tpu_torch.train import _Validation

CATSDOGS_VAL = [f"{k}.{i}.jpg" for i, k in enumerate(["cat", "dog"] * 5)]


def _val_raw(tmp_path, source):
    """The tiny catsdogs ViT with validation every epoch over 3 batches of 2: from 10
    JPEGs (training on the first 6 of the split, 3 batches an epoch; validating on the
    other 4, 2 batches a pass, so a pass wraps into the next reshuffle), or from the
    synthetic streams (3 steps an epoch)."""
    if source == "catsdogs":
        raw = _catsdogs_raw(_jpegs(tmp_path / "cd", CATSDOGS_VAL))
        raw["data"].update(dict_end_idx={"catsdogs": 0.6}, val_dict_start_idx={"catsdogs": 0.6},
                           val_dict_end_idx={"catsdogs": 1.0})
    else:
        raw = _catsdogs_raw(str(tmp_path / "none"))
        raw["load_balancing"]["batches_per_rank_epoch"] = {"synthetic": 3}
    raw["trainer"].update(val_every=1, val_batches=3, max_epochs=2)
    return raw


def _records(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("source", ["synthetic", "catsdogs"])
def test_validation_matches_jax(tmp_path, source):
    """Two epochs, each followed by validation, through both trainers: the val_loss
    and val_accuracy records within LOSS_TOL of the JAX trainer's, 3 batches a pass,
    the train losses beside them."""
    raw = _val_raw(tmp_path, source)
    synthetic = source == "synthetic"
    raw["trainer"]["metrics_path"] = str(tmp_path / "jax.jsonl")
    jax_train(JConfig(raw=raw, task="classification"), synthetic=synthetic)
    init = tmp_path / "init.ckpt"
    _jax_init_as_torch_file(raw, str(init))
    raw["trainer"].update(metrics_path=str(tmp_path / "port.jsonl"), init_params_from=str(init))
    train(Config(raw=raw, task="classification"), synthetic=synthetic, device="cpu")
    got, want = _records(tmp_path / "port.jsonl"), _records(tmp_path / "jax.jsonl")
    vals = [[r for r in recs if "val_loss" in r] for recs in (got, want)]
    assert len(vals[0]) == len(vals[1]) == 2
    for g, w in zip(*vals):
        assert g["epoch"] == w["epoch"] and g["val_batches"] == w["val_batches"] == 3
        np.testing.assert_allclose([g["val_loss"], g["val_accuracy"]],
                                   [w["val_loss"], w["val_accuracy"]], atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(_metrics_losses(tmp_path / "port.jsonl"),
                               _metrics_losses(tmp_path / "jax.jsonl"), atol=LOSS_TOL, rtol=0)


def test_val_split_matches_jax_and_needs_its_range(tmp_path):
    """`build_dataloader(..., val_split=True)`: the synthetic held-out stream (seed
    12345) and the catsdogs held-out files batch for batch as the JAX package's; from
    files without `data.val_dict_*` the JAX assertion."""
    raw = _val_raw(tmp_path, "catsdogs")
    cfg, jcfg = Config(raw=raw, task="classification"), JConfig(raw=raw, task="classification")
    for synthetic in (True, False):
        dm, synth, _ = build_dataloader(cfg, 2, synthetic, val_split=True)
        jdm, jsynth, _ = jax_build_dataloader(jcfg, 2, synthetic, val_split=True)
        if synthetic:
            got, want = list(itertools.islice(synth, 2)), list(itertools.islice(jsynth, 2))
            assert not np.array_equal(got[0]["x"], next(synthetic_batches(cfg, 2))["x"])
        else:
            got = list(itertools.islice(dm.train_dataloader(loop=True), 3))
            want = list(itertools.islice(jdm.train_dataloader(loop=True), 3))
        _assert_batches_equal(got, want)
    del raw["data"]["val_dict_end_idx"]
    for build in (build_dataloader, jax_build_dataloader):
        with pytest.raises(AssertionError, match="val_dict_start_idx / val_dict_end_idx"):
            build((Config if build is build_dataloader else JConfig)(
                raw=raw, task="classification"), 2, False, val_split=True)


@pytest.mark.parametrize("task", ["classification", "mae"])
def test_validation_runs_in_eval_mode_on_its_own_generators(task):
    """A validation pass is deterministic where the task draws nothing in eval mode
    (a ViT with dropout 0.3 and DropPath 0.2: two seeds, one loss), draws MAE's mask
    from its own seed (two seeds, two losses), and leaves the trainer's generators,
    and the training mode, as it found them."""
    if task == "classification":
        raw = _raw()
        raw["model"]["net"]["init_args"].update(drop_rate=0.3, drop_path=0.2)
    else:
        raw = _mae_raw()
    cfg = Config(raw=raw, task=task)
    state, _ = init_train(cfg, "cpu")
    model = state.model.train()
    before = (model.generator.get_state(), model.host_generator.get_state())
    gens = (model.generator, model.host_generator)
    losses = [_Validation(cfg, 2, True, torch.device("cpu")).run(model, seed)
              for seed in (2, 2, 3)]
    assert all(n == 8 for _, _, n in losses)
    assert losses[0] == losses[1]
    assert (losses[0][0] == losses[2][0]) == (task == "classification")
    assert model.training and (model.generator, model.host_generator) == gens
    assert torch.equal(before[0], model.generator.get_state())
    assert torch.equal(before[1], model.host_generator.get_state())


def _midepoch_raw(tmp_path, kind):
    """3 steps an epoch from files: the catsdogs ViT of `_resume_raw` (dropout,
    DropPath, EMA, loss scaling: 6 JPEGs), the NIfTI MAE of `_resume_raw` on 3 volumes,
    or a 3-D DiffusionVIT on NIfTI volumes with validation every epoch (3 volumes to
    train on, 1 held out)."""
    if kind == "catsdogs":
        return _resume_raw(tmp_path, "vit")
    if kind == "mae":
        raw, task = _resume_raw(tmp_path, "mae")
        _volumes(tmp_path / "ct3", 3, (32, 16, 16))
        raw["data"]["dict_root_dirs"] = {"ct": str(tmp_path / "ct3")}
        return raw, task
    if kind == "adaptive_mae":  # basic_ct/mae shrunk: 2-D slices patchified in a pool
        raw = _adaptive_raw("basic_ct/mae")
        raw["trainer"].update(attn_impl="FLASH", seed=1)
        raw["data"].update(dict_root_dirs={"ct1": _volumes(tmp_path / "ct2d", 3, (32, 32, 2))},
                           batch_size=2, num_workers=2)
        raw["load_balancing"] = {"auto_load_balancing": True}
        return raw, "mae"
    root = _volumes(tmp_path / "ct4", 4, (32, 16, 16))
    ia = {"default_vars": ["ct"], "tile_size": [16, 16, 16], "twoD": False, "patch_size": 4,
          "adaptive_patching": False, "num_time_steps": DIFF_T,
          **{k: v for k, v in DIFF_KW.items() if k != "time_steps"}}
    raw = {"trainer": {"task": "diffusion", "attn_impl": "FLASH", "seed": 2, "val_every": 1,
                       "val_batches": 2},
           "parallelism": {},
           "model": {"lr": 1e-3, "warmup_steps": 1, "max_steps": 20, "use_grad_scaler": True,
                     "net": {"init_args": ia}},
           "data": {"dataset": "basic_ct", "dict_root_dirs": {"ct": root},
                    "dict_start_idx": {"ct": 0}, "dict_end_idx": {"ct": 0.75},
                    "val_dict_start_idx": {"ct": 0.75}, "val_dict_end_idx": {"ct": 1.0},
                    "dict_buffer_sizes": {"ct": 3}, "num_channels_used": {"ct": 1},
                    "dict_in_variables": {"ct": ["ct"]}, "batch_size": 2,
                    "single_channel": True, "num_workers": 2, "tile_overlap": 0.0,
                    "use_all_data": False},
           "load_balancing": {"auto_load_balancing": True}}
    return raw, "diffusion"


@pytest.mark.parametrize("kind,drill", [("catsdogs", 2), ("catsdogs", 3), ("mae", 2),
                                        ("mae", 3), ("diffusion", 2), ("adaptive_mae", 2)])
def test_midepoch_resume_equals_uninterrupted_bit_for_bit(tmp_path, capsys, kind, drill):
    """Two epochs of 3 steps in one run against a run preempted by the drill
    (`preempt_after_steps`) after step 2 (mid-epoch) or 3 (the epoch's last step) and
    then resumed (the adaptive MAE's loader patchifies in a spawn pool) (`tests/test_midepoch_resume.py:209-285`): the (epoch, it) records,
    every per-step loss and validation loss, the parameters, AdamW's moments and the
    generators equal bit for bit; the preemption checkpoint holds the interrupted
    epoch's position in the interrupted epoch's slot."""
    raw, task = _midepoch_raw(tmp_path, kind)

    def run(name, **trainer):
        r = copy.deepcopy(raw)
        r["trainer"].update(max_epochs=2, checkpoint_path=str(tmp_path / f"ck_{name}"),
                            checkpoint_filename="last",
                            checkpoint_filename_for_loading="last_latest",
                            metrics_path=str(tmp_path / f"{name}.jsonl"), **trainer)
        return train(Config(raw=r, task=task), device="cpu")

    whole = run("whole")
    part = run("part", preempt_after_steps=drill)
    mid = drill < 3
    assert f"preempted in epoch 0 after {drill} its: saved" in capsys.readouterr().out
    assert len(part["loss_list"]) == (0 if mid else 1)
    payload = ckpt.restore_checkpoint(str(tmp_path / "ck_part"), "last_latest")
    assert sorted(os.listdir(tmp_path / "ck_part")) == ["last_even.ckpt"]
    assert (payload["epoch"], payload["data_it"], payload["total_steps"],
            payload["num_procs"]) == (0, drill if mid else 0, drill, 1)
    resumed = run("part", resume_from_checkpoint=True)
    out = capsys.readouterr().out
    assert ("resumed mid-epoch: epoch 0, fast-forwarding 2 batches" if mid
            else "resumed from epoch 0") in out

    a, b = _records(tmp_path / "whole.jsonl"), _records(tmp_path / "part.jsonl")
    steps = [(r["epoch"], r["it"]) for r in a if "loss" in r]
    assert steps == [(e, i) for e in (0, 1) for i in (1, 2, 3)]
    assert [(r["epoch"], r["it"]) for r in b if "loss" in r] == steps
    assert [r["loss"] for r in b if "loss" in r] == [r["loss"] for r in a if "loss" in r]
    vals = [[(r["epoch"], r["val_loss"]) for r in recs if "val_loss" in r] for recs in (a, b)]
    assert vals[0] == vals[1] and len(vals[0]) == (2 if kind == "diffusion" else 0)
    starts = [r for r in b if r.get("run_start")]
    assert [(r["resume_epoch"], r["resume_step"], r["resume_it"]) for r in starts] == [
        (0, 0, 0), (0 if mid else 1, drill, drill if mid else 0)]
    if not mid:  # the completed epoch's loss, as the uninterrupted run's
        assert resumed["loss_list"] == whole["loss_list"]
    sa, sb = whole["state"], resumed["state"]
    for (n, p), (m, q) in zip(sa.model.state_dict().items(), sb.model.state_dict().items()):
        assert n == m and torch.equal(p, q), n
    oa, ob = sa.optimizer.adamw.state_dict()["state"], sb.optimizer.adamw.state_dict()["state"]
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])
    assert sa.optimizer.count == sb.optimizer.count == 6 and sa.loss_scale == sb.loss_scale
    assert torch.equal(sa.model.generator.get_state(), sb.model.generator.get_state())
    assert torch.equal(sa.model.host_generator.get_state(), sb.model.host_generator.get_state())


def _sigterm_yaml(tmp_path, **trainer):
    """The tiny synthetic classifier with epochs long enough that a signal lands in
    epoch 0, a checkpoint directory and a metrics file."""
    raw = _raw()
    raw["trainer"].update(checkpoint_path=str(tmp_path / "ck"), checkpoint_filename="last",
                          checkpoint_filename_for_loading="last_latest",
                          metrics_path=str(tmp_path / "m.jsonl"), max_epochs=1, **trainer)
    raw["load_balancing"] = {"batches_per_rank_epoch": {"synthetic": 100000}}
    path = tmp_path / "sigterm.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path), raw


def test_sigterm_checkpoints_exits_and_resumes_in_place(tmp_path):
    """SIGTERM to the trainer's CLI (a subprocess on the CPU) after its third logged
    step: exit code 0, the `preempted in epoch 0` line, a checkpoint at the step the
    signal stopped it (`data_it`); a run resumed from it continues that epoch at the
    next step, its `run_start` record carrying the position. The JAX counterpart
    (`tests/test_trainer.py:110-158`) sends its signal 2 s after the first step and
    asserts epoch 0, while its epochs of 100 steps take well under a second here: it
    checkpoints in a later epoch and fails. This one signals on a step's line, in an
    epoch of 100,000 steps, with deadlines of its own."""
    import queue
    import signal
    import threading
    import time as _time

    cfg, raw = _sigterm_yaml(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ucf_vit_tpu_torch.train", cfg, "--synthetic", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    lines: "queue.Queue" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout] + [lines.put(None)],
                              daemon=True)
    reader.start()
    seen, deadline = [], _time.monotonic() + 240
    try:
        while True:
            line = lines.get(timeout=max(deadline - _time.monotonic(), 0.01))
            if line is None:
                pytest.fail("the trainer exited before its third step:\n" + "".join(seen))
            seen.append(line)
            if line.startswith("epoch 0 it 3 "):
                break
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    except (queue.Empty, subprocess.TimeoutExpired):
        pytest.fail("no third step, or no exit after SIGTERM, within the deadline:\n"
                    + "".join(seen))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=30)
    while (line := lines.get_nowait() if not lines.empty() else None) is not None:
        seen.append(line)
    text = "".join(seen)
    assert proc.returncode == 0, text[-2000:]
    stopped = re.search(r"preempted in epoch 0 after (\d+) its: saved (\S+)", text)
    assert stopped, text[-2000:]
    n = int(stopped.group(1))
    assert n >= 3 and stopped.group(2).endswith("last_even.ckpt")
    payload = ckpt.restore_checkpoint(str(tmp_path / "ck"), "last_latest")
    assert (payload["epoch"], payload["data_it"], payload["total_steps"]) == (0, n, n)

    raw["trainer"]["resume_from_checkpoint"] = True
    out = train(Config(raw=raw, task="classification"), synthetic=True, max_steps=n + 2,
                device="cpu")
    assert out["state"].optimizer.count == n + 2
    recs = _records(tmp_path / "m.jsonl")
    start = max(i for i, r in enumerate(recs) if r.get("run_start"))
    assert (recs[start]["resume_epoch"], recs[start]["resume_it"],
            recs[start]["resume_step"]) == (0, n, n)
    assert [(r["epoch"], r["it"], r["step"]) for r in recs[start + 1:]] == [
        (0, n + 1, n + 1), (0, n + 2, n + 2)]


def test_tensorboard_dir_writes_the_scalars(tmp_path):
    """`trainer.tensorboard_dir`: event files holding the train and val scalars of
    `ucf_vit_tpu/train.py:720-745,972-976`, beside the JSONL."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    raw = _raw()
    raw["trainer"].update(tensorboard_dir=str(tmp_path / "tb"), val_every=1, val_batches=1)
    raw["load_balancing"] = {"batches_per_rank_epoch": {"synthetic": 2}}
    train(Config(raw=raw, task="classification"), synthetic=True, device="cpu")
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert tags == {"train/loss", "train/ms_per_it", "train/samples_per_s", "train/accuracy",
                    "val/loss", "val/accuracy"}
    assert [e.step for e in acc.Scalars("train/loss")] == [1, 2]
    assert [e.step for e in acc.Scalars("val/loss")] == [2]


def test_tensorboard_dir_names_why_it_is_ignored(tmp_path, capsys):
    """Neither writer opens on a path under a file: training goes on, and the line
    names both writers' real errors."""
    (tmp_path / "file").write_text("")
    raw = _raw()
    raw["trainer"]["tensorboard_dir"] = str(tmp_path / "file" / "tb")
    out = train(Config(raw=raw, task="classification"), synthetic=True, max_steps=1,
                device="cpu")
    assert out["state"].optimizer.count == 1
    line = next(x for x in capsys.readouterr().out.splitlines()
                if x.startswith("tensorboard_dir ignored ("))
    assert "tensorboardX: " in line and "torch.utils.tensorboard: " in line


def test_profile_dir_writes_a_trace_of_steps_11_to_15(tmp_path, capsys):
    """`trainer.profile_dir`: a Chrome trace file of the profiler's CPU activity over
    steps 11-15 (`ucf_vit_tpu/train.py:853-879`), the train step's ops in it."""
    raw = _raw()
    raw["trainer"]["profile_dir"] = str(tmp_path / "prof")
    train(Config(raw=raw, task="classification"), synthetic=True, max_steps=16, device="cpu")
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    assert f"profile of steps 11-15 written to {tmp_path / 'prof' / files[0]}" in (
        capsys.readouterr().out)
    trace = json.load(open(tmp_path / "prof" / files[0]))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert {"aten::addmm", "aten::softmax"} & names and any("backward" in n.lower()
                                                             for n in names)


# ---------------------------------------------------------------- adaptive patching
#
# The three adaptive configs (imagenet/classification, imagenet/mae with seq_pack 2,
# basic_ct/mae single-channel) shrunk to a 32x32 tile at patch 4, 16 patches, depth 2,
# embed 32: MAE `pred` with the mask noise injected (1e-5), the adaptive MAE loss
# against `build_mae`'s, and 5 f32 train steps on the synthetic stream from one JAX
# init (1e-4 a step; the MAE's mask noise taken from the batch on both sides, the
# config's loss scaling on both). Then the data: `DataModule` on seeded JPEGs and NIfTI
# slices against the JAX one, in line and with a spawn pool, array for array; a
# fast-forward that patchifies no skipped sample; the pool's children importing the
# data modules alone; the adaptive catsdogs loader.

from ucf_vit_tpu.tasks import _seq_ps as jax_seq_ps
from ucf_vit_tpu_torch.data import transform as port_transform
from ucf_vit_tpu_torch.tasks import build_task
from ucf_vit_tpu_torch.tasks import seq_ps as port_seq_ps

ADAPTIVE_CONFIGS = ("imagenet/classification", "imagenet/mae", "basic_ct/mae")


def _adaptive_raw(name):
    """A shipped adaptive config, shrunk (its task, loss scaling, seq_pack and
    channels kept)."""
    with open(os.path.join(REPO, "configs", name, "base_config.yaml")) as f:
        raw = yaml.safe_load(f)
    ia = raw["model"]["net"]["init_args"]
    ia.update(tile_size=[32, 32, 2][:len(ia["tile_size"])], patch_size=4, embed_dim=32, depth=2, num_heads=2, fixed_length=16)
    if raw["trainer"]["task"] == "mae":
        ia.update(decoder_embed_dim=24, decoder_depth=2, decoder_num_heads=2)
    raw["model"].update(lr=1e-3, warmup_steps=2, max_steps=20, weight_decay=1e-5,
                        warmup_start_lr=1e-8, eta_min=1e-8)  # YAML reads 1e-5 as a string
    raw["trainer"].update(attn_impl="EINSUM", max_epochs=2)
    raw["parallelism"] = {}
    raw["data"].update(batch_size=4, num_classes=4)
    return raw


def _adaptive_batches(cfg, n, seed=20):
    stream = synthetic_batches(cfg, 4)
    out = []
    for i, b in zip(range(n), stream):
        b = {k: v for k, v in b.items() if k != "x" and k != "variables"}
        if cfg.task == "mae":
            b["mask_noise"] = _mae_noise(4, 16, seed=seed + i)
        out.append(b)
    return out


@pytest.mark.parametrize("seq_pack", [1, 2])
def test_adaptive_mae_matches_jax(seq_pack):
    kw = dict(img_size=(32, 32), patch_size=4, in_chans=1, embed_dim=24, depth=2,
              num_heads=2, decoder_embed_dim=18, decoder_depth=2, decoder_num_heads=3,
              adaptive_patching=True, fixed_length=16, use_adaptive_pos_emb=True,
              seq_pack=seq_pack)
    b = _adaptive_batches(Config(raw=_adaptive_raw("basic_ct/mae"), task="mae"), 1)[0]
    seq, noise = b["seq"][:2], b["mask_noise"][:2]
    ps = np.asarray(jax_seq_ps({k: jnp.asarray(v[:2]) for k, v in b.items()}))
    jmod = JMAE(attn_impl=JAttnImpl.EINSUM, class_token=False, **kw)
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.asarray(seq), None, jnp.asarray(ps),
                                  mask_noise=jnp.asarray(noise))["params"])
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    assert sorted(jax_to_torch_state(params)) == sorted(export_torch_state(params))
    ours = load_jax_params(MAE(attn_impl="FLASH", **kw), params).eval()
    want, wmask = jmod.apply({"params": params}, jnp.asarray(seq), None, jnp.asarray(ps),
                             mask_noise=jnp.asarray(noise))
    np.testing.assert_array_equal(
        port_seq_ps({k: torch.from_numpy(v[:2]) for k, v in b.items()}).numpy(), ps)
    with torch.inference_mode():
        got, mask = ours(torch.from_numpy(seq), mask_noise=torch.from_numpy(noise),
                         seq_ps=torch.from_numpy(ps))
        alone = reconstruct(ours, torch.from_numpy(seq), seed=3, seq_ps=torch.from_numpy(ps))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MAE_PRED_TOL, rtol=0)
    assert alone.shape == got.shape == (2, 16, 16)  # tokens [B, L, p^2 * C]


def test_adaptive_mae_loss_matches_build_mae(monkeypatch):
    raw = _adaptive_raw("imagenet/mae")
    jmod, jloss = jax_build_mae(JConfig(raw=raw, task="mae"))
    cfg = Config(raw=raw, task="mae")
    b = _adaptive_batches(cfg, 1)[0]
    noise = torch.rand(4, 16, generator=torch.Generator().manual_seed(5)).numpy()
    jb = {k: jnp.asarray(v) for k, v in b.items() if k != "mask_noise"}
    params = meta.unbox(jmod.init(jax.random.key(0), jb["seq"], None, jax_seq_ps(jb),
                                  mask_noise=jnp.asarray(noise))["params"])
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(noise))
    want, _ = jloss(params, jb, jax.random.key(0))
    model = load_jax_params(build_mae(cfg), jax.device_get(params)).train()
    model.set_generator(torch.Generator().manual_seed(5), torch.Generator().manual_seed(6))
    got, aux = task_loss(cfg)(model, {k: torch.from_numpy(v) for k, v in b.items()})
    assert aux == {} and abs(got.item() - float(want)) <= 1e-6


def _adaptive_jax_loss(jmod, cfg, jloss):
    if cfg.task != "mae":
        return jloss

    def loss_fn(params, batch, rng):  # build_mae's adaptive loss, the noise from the batch
        seq = batch["seq"]
        pred, _ = jmod.apply({"params": params}, seq, None, jax_seq_ps(batch),
                             deterministic=False, mask_noise=batch["mask_noise"],
                             rngs={"dropout": rng})
        b, c, l, p = seq.shape
        return jax_metrics.mse(pred, seq.transpose(0, 2, 3, 1).reshape(b, l, p * c)), {}
    return loss_fn


def _adaptive_port_loss(cfg):
    if cfg.task != "mae":
        return task_loss(cfg)

    def loss_fn(model, batch):
        seq = batch["seq"]
        pred, _ = model(seq, mask_noise=batch["mask_noise"], seq_ps=port_seq_ps(batch))
        b, c, l, p = seq.shape
        return metrics.mse(pred, seq.permute(0, 2, 3, 1).reshape(b, l, p * c)), {}
    return loss_fn


@pytest.mark.parametrize("name", ADAPTIVE_CONFIGS)
def test_adaptive_train_steps_match_jax(name):
    raw = _adaptive_raw(name)
    task = raw["trainer"]["task"]
    jcfg, cfg = JConfig(raw=raw, task=task), Config(raw=raw, task=task)
    batches = _adaptive_batches(cfg, MAE_STEPS)
    jmod, jloss = (jax_build_mae if task == "mae" else jax_build_classification)(jcfg)
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    extra = {"mask_noise": first["mask_noise"]} if task == "mae" else {}
    params = meta.unbox(jmod.init(jax.random.key(0), first["seq"], None, jax_seq_ps(first),
                                  **extra)["params"])
    params = jax.tree.map(jnp.asarray, params)
    scaler = bool(raw["model"].get("use_grad_scaler", False))
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=jax_optim.init_loss_scale() if scaler else None,
                         ema_params=None)
    jstep = jax_make_train_step(_adaptive_jax_loss(jmod, jcfg, jloss), tx, donate=False)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    raw["trainer"]["attn_impl"] = "FLASH"
    cfg = Config(raw=raw, task=task)
    model = load_jax_params(build_task(cfg), jax.device_get(params))
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt, use_grad_scaler=scaler)
    step = make_train_step(_adaptive_port_loss(cfg), opt)
    losses = [step(state, to_device(b, torch.device("cpu")))[1].item() for b in batches]
    np.testing.assert_allclose(losses, jax_losses, atol=LOSS_TOL, rtol=0)
    final = jax_to_torch_state(jax.device_get(jstate.params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[n], atol=PARAM_TOL, rtol=0,
                                   err_msg=n)


def _imagenet_jpegs(root, per_class=3):
    for i, cls in enumerate(("n01", "n02")):
        _jpegs(os.path.join(root, cls), [f"img{j}.JPEG" for j in range(per_class)],
               size=(48, 40), seed=i)
    return str(root)


def _adaptive_dm_case(tmp_path, case):
    kw = dict(tile_size_x=32, tile_size_y=32, twoD=True, adaptive_patching=True,
              patch_size=4, fixed_length=16, batch_size=2, seed=3)
    if case == "imagenet":
        keys, names = ["imagenet"], ["red", "green", "blue"]
        kw.update(dict_root_dirs={"imagenet": _imagenet_jpegs(tmp_path / "in")},
                  dataset="imagenet", return_label=True, num_classes=2,
                  imagenet_resize={"imagenet": (32, 32)})
    else:
        keys, names = ["ct"], ["ct"]
        kw.update(dict_root_dirs={"ct": _volumes(tmp_path / "ct", 3, (32, 32, 2),
                                                 labels=3 if case == "basic_ct_labels" else 0)},
                  dataset="basic_ct", tile_size_z=2, single_channel=True)
        if case == "basic_ct_labels":
            kw.update(return_label=True, num_classes=3)
    kw.update(dict_buffer_sizes={k: 4 for k in keys}, dict_in_variables={k: names for k in keys},
              num_channels_used={k: len(names) for k in keys},
              dict_start_idx={k: 0.0 for k in keys}, dict_end_idx={k: 1.0 for k in keys})
    return kw


@pytest.mark.parametrize("case,workers", [("imagenet", 0), ("imagenet", 3), ("basic_ct", 0),
                                          ("basic_ct", 3), ("basic_ct_labels", 0)])
def test_adaptive_datamodule_matches_jax(tmp_path, case, workers):
    """Two epochs (past each chain's end) and a fast-forward, against the JAX
    DataModule in line: `num_workers` 3 patchifies in a spawn pool of 2."""
    kw = _adaptive_dm_case(tmp_path, case)
    port = DataModule(**kw, num_workers=workers, prefetch=2)
    jdm = JDataModule(**kw, prefetch=0)
    port.setup()
    jdm.setup()
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jdm.set_epoch(epoch)
        got = list(itertools.islice(port.train_dataloader(loop=True), 4))
        want = list(itertools.islice(jdm.train_dataloader(loop=True), 4))
        _assert_batches_equal(got, want)
        assert got[0]["seq"].shape == (2, 1 if case != "imagenet" else 3, 16, 16)
    port.set_epoch(2)  # fresh chains (the prefetch thread read ahead on the old ones)
    jdm.set_epoch(2)
    _assert_batches_equal(list(port.train_dataloader(skip_batches=1)),
                          list(jdm.train_dataloader(skip_batches=1)))


def test_adaptive_batches_carry_the_trees_with_return_qdt(tmp_path):
    kw = _adaptive_dm_case(tmp_path, "basic_ct")
    port = DataModule(**kw, return_qdt=True, prefetch=0)
    jdm = JDataModule(**kw, return_qdt=True, prefetch=0)
    port.setup()
    jdm.setup()
    got, want = next(port.train_dataloader()), next(jdm.train_dataloader())
    # every array reaches the device, the trees and the variable names stay on the host
    assert sorted(to_device(got, torch.device("cpu"))) == ["seq", "seq_pos", "seq_size", "x"]
    assert [q.encode_nodes() for q in got.pop("qdt")] == [
        q.encode_nodes() for q in want.pop("qdt")]
    _assert_batches_equal([got], [want])


def test_adaptive_fast_forward_patchifies_no_skipped_sample(tmp_path, monkeypatch):
    calls = []
    call = port_transform.Patchify.__call__
    monkeypatch.setattr(port_transform.Patchify, "__call__",
                        lambda self, img, rng=None: calls.append(1) or call(self, img, rng))
    kw = _adaptive_dm_case(tmp_path, "basic_ct")
    dm = DataModule(**kw, prefetch=0)
    dm.setup()
    whole = list(itertools.islice(dm.train_dataloader(), 3))
    dm.set_epoch(1)
    dm.set_epoch(0)
    calls.clear()
    rest = list(itertools.islice(dm.train_dataloader(skip_batches=2), 1))
    assert len(calls) == 2  # one batch of 2 made; the 4 skipped samples never patchified
    _assert_batches_equal(rest, whole[2:])


def test_pool_children_import_the_data_modules_alone(tmp_path):
    """A trainer's main module imports torch; the spawn pool's children do not
    run it again: a child holds numpy and the port's data modules, no torch, no
    JAX, nothing of the JAX package."""
    script = tmp_path / "main.py"
    script.write_text(
        "import json, sys, torch\n"
        "from ucf_vit_tpu_torch.data.pipeline import make_pool\n"
        "spec = dict(num_channels=1, single_channel=True, return_label=False,\n"
        "            dataset='basic_ct', adaptive_patching=True, patch_size=4,\n"
        "            fixed_length=16, aug_seed=0)\n"
        "if __name__ == '__main__':\n"
        "    with make_pool(spec, 1) as pool:\n"
        "        assert pool._mp_context.get_start_method() == 'spawn'\n"
        "        print(json.dumps(pool.submit(eval, 'sorted(__import__(\"sys\").modules)')\n"
        "                         .result(timeout=120)))\n")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "ucf_vit_tpu_torch.data.transform" in mods and "numpy" in mods
    assert not [m for m in mods if re.match(r"(torch|jax|flax|ucf_vit_tpu(?!_torch))(\.|$)", m)]
    assert {m for m in mods if m.startswith("ucf_vit_tpu_torch")} <= {
        "ucf_vit_tpu_torch", "ucf_vit_tpu_torch.data", "ucf_vit_tpu_torch.data.pipeline",
        "ucf_vit_tpu_torch.data.nifti", "ucf_vit_tpu_torch.data.transform",
        "ucf_vit_tpu_torch.data.quadtree", "ucf_vit_tpu_torch.data.octree",
        "ucf_vit_tpu_torch.native"}


def test_pools_started_from_three_threads_leave_the_main_module_whole():
    """Three loaders' pools started at once, from three threads: `make_pool` starts
    every worker before it returns, the main module's `__spec__` and `__file__`
    come back as they were, and an ordinary spawn afterwards still runs."""
    from ucf_vit_tpu_torch.data.pipeline import make_pool

    main = sys.modules["__main__"]
    before = {k: main.__dict__.get(k, "absent") for k in ("__spec__", "__file__")}
    spec = dict(num_channels=1, single_channel=True, return_label=False, dataset="basic_ct",
                adaptive_patching=True, patch_size=4, fixed_length=16, aug_seed=0)
    start, pools = threading.Barrier(3), []

    def build():
        start.wait()
        pool = make_pool(spec, 2)
        pools.append((len(pool._processes), pool))

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    try:
        assert [n for n, _ in pools] == [2, 2, 2]
        assert {k: main.__dict__.get(k, "absent") for k in before} == before
        child = multiprocessing.get_context("spawn").Process(target=time.sleep, args=(0,))
        child.start()
        child.join(timeout=120)
        assert child.exitcode == 0
        assert [p.submit(abs, -3).result(timeout=120) for _, p in pools] == [3, 3, 3]
    finally:
        for _, p in pools:
            p.shutdown(wait=True)


def test_adaptive_catsdogs_matches_jax(tmp_path):
    root = _jpegs(tmp_path / "cd", CATSDOGS, size=(40, 36))
    files = port_catsdogs.list_file_split(root, 0.0, 1.0)
    kw = dict(adaptive_patching=True, fixed_length=16, patch_size=4)
    ds = port_catsdogs.CatsDogsDataset(files, ("r", "g", "b"), (32, 32),
                                       rng=np.random.default_rng(8), **kw)
    jds = jax_catsdogs.CatsDogsDataset(files, ("r", "g", "b"), (32, 32),
                                       rng=np.random.default_rng(8), **kw)
    got = list(port_catsdogs.catsdogs_loader(ds, 2, seed=1))
    _assert_batches_equal(got, list(jax_catsdogs.catsdogs_loader(jds, 2, seed=1)))
    assert got[0]["seq"].shape == (2, 3, 16, 16) and got[0]["seq_size"].shape == (2, 1, 16)


# ================================================================ the octree and UNETR
#
# 3-D adaptive patching and UNETR's training at a small size (tile 16^3, patch 2,
# fixed_length 64 = 1 + 7 * 9 leaves, so sqrt_len 4; embed 24, depth 4, 2 heads,
# feature size 4, 4 classes, batch 2): the native Gaussian against scipy's
# `gaussian_filter` (its weights from the port's copy of scipy's formula), the octree's
# native build against its numpy build and the JAX tree box for box, the native
# serialization against the per-leaf resample and the JAX one bit for bit, `Patchify3D`
# on one generator state against the JAX one array for array, the 3-D adaptive
# `DataModule` with labels (in line and with a spawn pool) against the JAX one, five f32
# train steps of the shrunk basic_ct/unetr with remat against the JAX step (1e-4 a step),
# `transfer_mae_encoder` against the JAX one key for key and value for value, and the
# trainer's CLI from labelled NIfTI volumes warm-started from an MAE checkpoint.

from scipy.ndimage import gaussian_filter
from scipy.ndimage._filters import _gaussian_kernel1d

from ucf_vit_tpu.checkpoint import transfer_mae_encoder as jax_transfer_mae_encoder
from ucf_vit_tpu.data.octree import FixedOctTree as JFixedOctTree
from ucf_vit_tpu.data.transform import Patchify3D as JPatchify3D
from ucf_vit_tpu.tasks import build_unetr as jax_build_unetr
from ucf_vit_tpu.tasks import reassemble_sqrt_len as jax_reassemble
from ucf_vit_tpu_torch import native
from ucf_vit_tpu_torch.checkpoint import transfer_mae_encoder
from ucf_vit_tpu_torch.data.octree import FixedOctTree, octree_boxes_plain, resize_3d
from ucf_vit_tpu_torch.data.transform import Patchify3D
from ucf_vit_tpu_torch.models import UNETR
from ucf_vit_tpu_torch.ops.pos_embed import interpolate_pos_embed_1d
from ucf_vit_tpu_torch.train import transfer_pretrained_mae

UNETR_STEPS = 5


@pytest.mark.parametrize("sigma", [1, 3, 5])
def test_gaussian3d_matches_scipy(sigma):
    radius = int(4.0 * sigma + 0.5)
    np.testing.assert_array_equal(native.gaussian_weights(float(sigma), radius),
                                  _gaussian_kernel1d(float(sigma), 0, radius))
    img = np.random.default_rng(sigma).random((12, 10, 9, 2)).astype(np.float32)
    got = native.gaussian3d(img, float(sigma))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, gaussian_filter(img, sigma=(sigma, sigma, sigma, 0)))


def _edge_volume(kind, n=16):
    rng = np.random.default_rng(4)
    if kind == "sparse":
        return ((rng.random((n, n, n)) > 0.8) * 255).astype(np.uint8)
    v = np.zeros((n, n, n), np.uint8)  # mass in two corners, ties elsewhere
    v[:n // 4, :n // 4, :n // 2] = 85
    v[n // 2:, n // 2 + 2:, 3:7] = 170
    return v


@pytest.mark.parametrize("fixed_length", [8, 64, 60])
@pytest.mark.parametrize("edges", ["sparse", "blocks"])
def test_octree_native_matches_numpy_and_jax(edges, fixed_length):
    """60 is not 1 + 7n: the splits overshoot it, the same way in all three."""
    dom = _edge_volume(edges)
    boxes, vals = native.octree_boxes(dom, fixed_length, 85)
    pboxes, pvals = octree_boxes_plain(dom, fixed_length, 85)
    ref = JFixedOctTree(dom, fixed_length, 85)
    np.testing.assert_array_equal(boxes, pboxes)
    np.testing.assert_array_equal(vals, pvals)
    np.testing.assert_array_equal(boxes, [c.get_coord() for c, _ in ref.nodes])
    np.testing.assert_array_equal(vals, [v for _, v in ref.nodes])
    assert boxes.shape[0] == (64 if fixed_length == 60 else fixed_length)
    tree = FixedOctTree(dom, fixed_length, 85)
    assert [c.get_coord() for c, _ in tree.nodes] == [c.get_coord() for c, _ in ref.nodes]


@pytest.mark.parametrize("nearest", [False, True], ids=["trilinear", "nearest"])
def test_octree_serialize_matches_the_per_leaf_resample_and_jax(nearest):
    rng = np.random.default_rng(5)
    img = rng.random((16, 16, 16, 2)).astype(np.float32)
    if nearest:
        img = rng.integers(0, 4, size=(16, 16, 16, 1)).astype(np.float32)
    dom = _edge_volume("sparse")
    tree, ref = FixedOctTree(dom, 57, 255), JFixedOctTree(dom, 57, 255)
    c = img.shape[-1]
    serialize = tree.serialize_labels if nearest else tree.serialize
    jserialize = ref.serialize_labels if nearest else ref.serialize
    seq, size, pos = serialize(img, (2, 2, 2, c))
    for g, w in zip((seq, size, pos), jserialize(img, (2, 2, 2, c))):
        np.testing.assert_array_equal(g, np.asarray(w))
    per_leaf = [resize_3d(cube.get_area(img), (2, 2, 2), nearest=nearest).astype(np.float32)
                for cube, _ in tree.nodes]
    n = len(per_leaf)
    np.testing.assert_array_equal(seq[:n], np.stack(per_leaf))
    np.testing.assert_array_equal(seq[n:], 0)  # the padding
    assert (size[n:] == 0).all() and (pos[n:] == -1).all()
    np.testing.assert_array_equal(native.resize3d(img[:4, :4, :4], 2, nearest),
                                  per_leaf[0] * 0 + resize_3d(img[:4, :4, :4], (2, 2, 2),
                                                              nearest).astype(np.float32))


def test_octree_deserialize_matches_jax():
    dom = _edge_volume("blocks")
    tree, ref = FixedOctTree(dom, 64, 85), JFixedOctTree(dom, 64, 85)
    seq = np.random.default_rng(6).random((64, 8)).astype(np.float32)
    np.testing.assert_array_equal(tree.deserialize(seq, 2, 1), ref.deserialize(seq, 2, 1))


@pytest.mark.parametrize("channels", [1, 2])
def test_patchify3d_matches_jax(channels):
    """Eight volumes from one seeded generator each side: every smoothing factor
    (0: no smoothing) and Canny threshold the draws give; with two channels the
    cross-channel rules."""
    rng = np.random.default_rng(8)
    vols = rng.random((8, 16, 16, 16, channels)).astype(np.float32)
    vols[:, 4:12, 4:12, 4:12] += 0.5  # an edge the octree sees
    ours = Patchify3D(fixed_length=64, patch_size=2, num_channels=channels,
                      rng=np.random.default_rng(9))
    ref = JPatchify3D(fixed_length=64, patch_size=2, num_channels=channels,
                      rng=np.random.default_rng(9))
    for vol in vols:
        got, want = ours(vol), ref(vol)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[3].boxes, [c.get_coord() for c, _ in want[3].nodes])
    assert got[0].shape == ((64, 8) if channels == 1 else (2, 64, 8))
    with pytest.raises(RuntimeError, match="explicit"):
        Patchify3D(fixed_length=64, patch_size=2)(vols[0])


def _labelled_volumes(root, n, side, seed=0):
    """`n` int16 CT-like volumes of `side`^3 under <root>/imagesTr and label
    volumes 1-4 under <root>/labelsTr: thresholds of a smoothed copy, so that
    the labels have edges."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "imagesTr"))
    os.makedirs(os.path.join(root, "labelsTr"))
    for i in range(n):
        smooth = gaussian_filter(rng.normal(size=(side,) * 3), 2.0)
        vol = (smooth * 3000 + 40 * rng.normal(size=smooth.shape)).astype(np.int16)
        lab = 1 + np.digitize(smooth, np.quantile(smooth, [0.4, 0.7, 0.9])).astype(np.int16)
        nifti.save(os.path.join(root, "imagesTr", f"image{i}.nii"), vol)
        nifti.save(os.path.join(root, "labelsTr", f"label{i}.nii"), lab)
    return str(root)


@pytest.mark.parametrize("workers", [0, 3], ids=["in_line", "pool"])
def test_adaptive_3d_datamodule_with_labels_matches_jax(tmp_path, workers):
    """The 3-D adaptive chain that 3-D refused before this slice: `x`, `seq`,
    `seq_size`, `seq_pos`, `label` and `seq_label` array for array with the JAX
    DataModule, in line and in a spawn pool of 2, over two epochs."""
    keys = ["ct"]
    kw = dict(dict_root_dirs={"ct": _labelled_volumes(tmp_path / "ct", 2, 32)},
              tile_size_x=16, tile_size_y=16, tile_size_z=16, twoD=False, single_channel=True,
              dataset="basic_ct", batch_size=2, seed=3, adaptive_patching=True, patch_size=2,
              fixed_length=64, return_label=True, num_classes=4,
              dict_buffer_sizes={k: 4 for k in keys}, dict_in_variables={k: ["ct"] for k in keys},
              num_channels_used={k: 1 for k in keys}, dict_start_idx={k: 0.0 for k in keys},
              dict_end_idx={k: 1.0 for k in keys})
    port = DataModule(**kw, num_workers=workers, prefetch=2)
    jdm = JDataModule(**kw, prefetch=0)
    port.setup()
    jdm.setup()
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jdm.set_epoch(epoch)
        got = list(itertools.islice(port.train_dataloader(loop=True), 3))
        want = list(itertools.islice(jdm.train_dataloader(loop=True), 3))
        _assert_batches_equal(got, want)
    b = got[0]
    assert b["seq"].shape == (2, 1, 64, 8) and b["seq_pos"].shape == (2, 1, 64, 3)
    assert b["seq_label"].shape == (2, 64, 2, 2, 2) and b["label"].shape == (2, 1, 16, 16, 16)
    assert set(np.unique(b["label"])) <= {0, 1, 2, 3}


def _unetr_raw(**trainer):
    """basic_ct/unetr as shipped, shrunk (its task, f32, remat, adaptive octree input,
    the position MLP and the skip decoder kept)."""
    with open(os.path.join(REPO, "configs", "basic_ct", "unetr", "base_config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["net"]["init_args"].update(tile_size=[16, 16, 16], patch_size=2,
                                            fixed_length=64, embed_dim=24, depth=4,
                                            num_heads=2, feature_size=4)
    raw["model"].update(lr=1e-3, warmup_steps=2, max_steps=20, weight_decay=1e-5,
                        warmup_start_lr=1e-8, eta_min=1e-8)  # YAML reads 1e-5 as a string
    raw["trainer"].update(attn_impl="EINSUM", max_epochs=1, **trainer)
    raw["parallelism"] = {}
    raw["data"]["batch_size"] = 2
    return raw


def test_unetr_train_steps_match_jax():
    """Five f32 steps with remat from one JAX init on the synthetic stream
    (`seq`, `seq_size`, `seq_pos` and 4-class label volumes), the port's attention
    FLASH: the losses within LOSS_TOL a step. (The parameters are not compared:
    AdamW's first updates are lr x the gradient's sign, and some patch-embed
    gradients are 7e-7 with f32 convolution noise of 1.5e-7 on either side.)"""
    raw = _unetr_raw()
    jcfg, cfg = JConfig(raw=raw, task="unetr"), Config(raw=raw, task="unetr")
    stream = synthetic_batches(cfg, 2)
    batches = [{k: v for k, v in b.items() if k != "variables"}
               for _, b in zip(range(UNETR_STEPS), stream)]
    jmod, jloss = jax_build_unetr(jcfg)
    assert jmod.remat
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    seq = jax_reassemble(first["seq"], 4, 2, False)
    params = meta.unbox(jmod.init(jax.random.key(0), first["x"], None, jax_seq_ps(first),
                                  seq)["params"])
    params = jax.tree.map(jnp.asarray, params)
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=None, ema_params=None)
    jstep = jax_make_train_step(jloss, tx, donate=False)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    raw["trainer"]["attn_impl"] = "FLASH"
    cfg = Config(raw=raw, task="unetr")
    model = load_jax_params(build_task(cfg), jax.device_get(params))
    assert isinstance(model, UNETR) and model.remat and model.num_patches == 64
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt)
    step = make_train_step(task_loss(cfg), opt)
    losses = [step(state, to_device(b, torch.device("cpu")))[1].item() for b in batches]
    np.testing.assert_allclose(losses, jax_losses, atol=LOSS_TOL, rtol=0)
    assert state.step == UNETR_STEPS and losses[-1] < losses[0]


def _mae_for_unetr():
    """A JAX MAE (tile 16^3, patch 2: 512 tokens) with the shrunk UNETR's encoder
    width and depth, and that UNETR, each flax-initialised."""
    raw = _unetr_raw()
    jcfg = JConfig(raw=raw, task="unetr")
    junetr, _ = jax_build_unetr(jcfg)
    b = {k: jnp.asarray(v) for k, v in next(synthetic_batches(Config(raw=raw, task="unetr"),
                                                              2)).items() if k != "variables"}
    uparams = meta.unbox(junetr.init(jax.random.key(1), b["x"], None, jax_seq_ps(b),
                                     jax_reassemble(b["seq"], 4, 2, False))["params"])
    jmae = JMAE(attn_impl=JAttnImpl.EINSUM, class_token=False, img_size=(16, 16, 16),
                patch_size=2, in_chans=1, twoD=False, embed_dim=24, depth=4, num_heads=2,
                decoder_embed_dim=18, decoder_depth=1, decoder_num_heads=3)
    mparams = meta.unbox(jmae.init(jax.random.key(2), b["x"],
                                   mask_noise=jnp.asarray(_mae_noise(2, 512)))["params"])
    return jax.device_get(mparams), jax.device_get(uparams), raw


def test_transfer_mae_encoder_matches_jax():
    mparams, uparams, _ = _mae_for_unetr()
    want = jax_to_torch_state(jax_transfer_mae_encoder(mparams, uparams, new_pos_embed_len=64))
    mae_sd = {k: torch.from_numpy(v.copy()) for k, v in jax_to_torch_state(mparams).items()}
    target = {k: torch.from_numpy(v) for k, v in jax_to_torch_state(uparams).items()}
    got = transfer_mae_encoder(mae_sd, target, new_pos_embed_len=64)
    assert sorted(got) == sorted(want) == sorted(target)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the blocks and patch embed from the MAE, the table resampled, the decoder the UNETR's own
    assert torch.equal(got["blocks.3.mlp.fc2.weight"], mae_sd["blocks.3.mlp.fc2.weight"])
    np.testing.assert_array_equal(got["pos_embed"].numpy(),
                                  interpolate_pos_embed_1d(mae_sd["pos_embed"].numpy(), 64))
    assert torch.equal(got["decoder5.transp_conv.weight"], target["decoder5.transp_conv.weight"])
    assert torch.equal(got["adaptive_pos_dep_emb.0.weight"],
                       target["adaptive_pos_dep_emb.0.weight"])


def test_cli_trains_unetr_from_labelled_nifti_warm_started_from_an_mae(tmp_path, capsys):
    """`trainer.pretrained_mae_checkpoint` (refused before this slice) reads an MAE
    checkpoint: the encoder equals the MAE's tensor for tensor, the position table is
    resampled, the decoder keeps its init; then the shrunk basic_ct/unetr trains
    from labelled NIfTI volumes through the CLI and saves."""
    mparams, _, raw = _mae_for_unetr()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jax_to_torch_state(mparams).items()}
    mae_dir = tmp_path / "mae"
    os.makedirs(mae_dir)
    torch.save({"epoch": 3, "model_state_dict": sd, "loss_list": [], "head_meta": [2, 3]},
               str(mae_dir / "mae_odd.ckpt"))
    raw["trainer"].update(pretrained_mae_checkpoint=str(mae_dir),
                          checkpoint_path=str(tmp_path / "ck"))
    raw["data"].update(dict_root_dirs={"ct1": _labelled_volumes(tmp_path / "ct", 2, 32)},
                       num_workers=1)
    cfg = Config(raw=raw, task="unetr")
    state, _ = init_train(cfg, "cpu")
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    transfer_pretrained_mae(cfg, state.model, str(mae_dir))
    got = state.model.state_dict()
    assert torch.equal(got["blocks.2.attn.qkv.weight"], sd["blocks.2.attn.qkv.weight"])
    assert torch.equal(got["token_embeds.proj.weight"], sd["token_embeds.proj.weight"])
    np.testing.assert_array_equal(got["pos_embed"].numpy(),
                                  interpolate_pos_embed_1d(sd["pos_embed"].numpy(), 64))
    for k in ("decoder2.conv_block.conv1.weight", "encoder1.layer.conv1.weight", "out.conv.weight"):
        assert torch.equal(got[k], init[k])
    path = tmp_path / "unetr.yaml"
    path.write_text(yaml.safe_dump(raw))
    out = main([str(path), "--single-device", "--max-steps", "3", "--device", "cpu"])
    log = capsys.readouterr().out
    assert "initialized encoder from MAE checkpoint" in log
    assert len(out["loss_list"]) == 1 and np.isfinite(out["loss_list"][0])
    assert os.path.isfile(tmp_path / "ck" / "multi_last_even.ckpt")


# ---------------------------------------------------------------- SAP
#
# basic_ct/sap and sap_bf16 shrunk (tile 16^3 at patch 2, 64 octree tokens reassembled
# into an 8^3 image, two blocks of 24 wide, batch 2): the loss on injected batches
# within 1e-6 of the JAX one, five train steps within 1e-4 (f32) and 5e-3 (bf16) a
# step, sap_bf16's dtypes from the token embed to the loss against `jax.eval_shape` of
# the JAX model, the MAE-encoder transfer into SAP, and the CLI: synthetic, and from
# labelled NIfTI volumes warm-started from an MAE checkpoint.

from ucf_vit_tpu.tasks import build_sap as jax_build_sap
from ucf_vit_tpu_torch.models import SAP

SAP_STEPS = 5
SAP_LOSS_TOL = 1e-6  # one loss on the same weights, f32
SAP_BF16_LOSS_TOL = 5e-3  # per-step loss, bf16


def _sap_raw(name="sap", twoD=False, **trainer):
    """basic_ct/<name> as shipped, shrunk (its task, dtype, adaptive octree input and the
    position MLP kept); `twoD` a 2-D copy (16 quadtree tokens of 2^2 into an 8^2 image)."""
    with open(os.path.join(REPO, "configs", "basic_ct", name, "base_config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["net"]["init_args"].update(
        tile_size=[16, 16] if twoD else [16, 16, 16], patch_size=2,
        fixed_length=16 if twoD else 64, embed_dim=24, depth=2, num_heads=2, twoD=twoD)
    raw["model"].update(lr=1e-3, warmup_steps=2, max_steps=20, weight_decay=1e-5,
                        warmup_start_lr=1e-8, eta_min=1e-8)  # YAML reads 1e-5 as a string
    raw["trainer"].update(attn_impl="EINSUM", max_epochs=1, **trainer)
    raw["parallelism"] = {}
    raw["data"]["batch_size"] = 2
    return raw


def _sap_jax(raw, batch, seed=0):
    """The JAX SAP of `raw`, its loss and its params initialised on `batch`."""
    jmod, jloss = jax_build_sap(JConfig(raw=raw, task="sap"))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    twoD = raw["model"]["net"]["init_args"]["twoD"]
    img = jax_reassemble(b["seq"], 4, 2, twoD)
    params = meta.unbox(jmod.init(jax.random.key(seed), img, None, jax_seq_ps(b))["params"])
    return jmod, jloss, jax.tree.map(jnp.asarray, params)


def _sap_batches(cfg, n):
    return [{k: v for k, v in b.items() if k != "variables"}
            for _, b in zip(range(n), synthetic_batches(cfg, 2))]


@pytest.mark.parametrize("twoD", [False, True], ids=["3d", "2d"])
def test_sap_loss_matches_jax(twoD):
    """`dice_b_loss` of the logits of the reassembled image against the reassembled,
    one-hot serialized labels, on the same weights and batch."""
    raw = _sap_raw(twoD=twoD)
    cfg = Config(raw=raw, task="sap")
    b = _sap_batches(cfg, 1)[0]
    assert b["seq_label"].shape == (2, 16 if twoD else 64) + (2,) * (2 if twoD else 3)
    jmod, jloss, params = _sap_jax(raw, b)
    want, _ = jloss(params, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(0),
                    deterministic=True)
    model = load_jax_params(build_task(cfg), jax.device_get(params)).eval()
    assert isinstance(model, SAP) and model.token_grid == (4,) * (2 if twoD else 3)
    got, aux = task_loss(cfg)(model, to_device(b, torch.device("cpu")))
    assert aux == {} and got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= SAP_LOSS_TOL


@pytest.mark.parametrize("name, tol", [("sap", LOSS_TOL), ("sap_bf16", SAP_BF16_LOSS_TOL)])
def test_sap_train_steps_match_jax(name, tol):
    """Five steps from one JAX init on the synthetic stream (`seq`, `seq_size`,
    `seq_pos`, `seq_label`), the port's attention FLASH: the losses within `tol` a
    step, and falling."""
    raw = _sap_raw(name)
    cfg = Config(raw=raw, task="sap")
    batches = _sap_batches(cfg, SAP_STEPS)
    jmod, jloss, params = _sap_jax(raw, batches[0])
    assert jmod.dtype == (jnp.bfloat16 if name == "sap_bf16" else None)
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=None, ema_params=None)
    jstep = jax_make_train_step(jloss, tx, donate=False)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    raw["trainer"]["attn_impl"] = "FLASH"
    cfg = Config(raw=raw, task="sap")
    model = load_jax_params(build_task(cfg), jax.device_get(params))
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt)
    step = make_train_step(task_loss(cfg), opt)
    losses = [step(state, to_device(b, torch.device("cpu")))[1].item() for b in batches]
    np.testing.assert_allclose(losses, jax_losses, atol=tol, rtol=0)
    assert state.step == SAP_STEPS and losses[-1] < losses[0]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_sap_bf16_dtypes_match_jax_eval_shape():
    """Under the bf16 policy, the output type of each stage from the token embed to
    the loss against `jax.eval_shape` of the JAX model's captured intermediates: the
    embed and the blocks bf16, the position MLP f32 (cast to the stream after it), and
    from the final norm on f32, since the norm, the neck and the head take no dtype."""
    raw = _sap_raw("sap_bf16")
    cfg = Config(raw=raw, task="sap")
    b = _sap_batches(cfg, 1)[0]
    jmod, jloss, params = _sap_jax(raw, b)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    img = jax_reassemble(jb["seq"], 4, 2, False)

    def fwd(p):
        return jmod.apply({"params": p}, img, None, jax_seq_ps(jb), capture_intermediates=True,
                          mutable=["intermediates"])

    logits, inter = jax.eval_shape(fwd, params)
    inter = inter["intermediates"]
    stages = {"token_embed": "token_embeds", "adaptive_pos_dep_emb": "adaptive_pos_dep_emb",
              "blocks_1": "blocks.1", "norm": "norm", "neck": "neck",
              "mask_header": "mask_header"}
    want = {n: _dtype_name(inter[j]["__call__"][0].dtype) for j, n in stages.items()}
    want["logits"] = _dtype_name(logits.dtype)
    want["loss"] = _dtype_name(jax.eval_shape(
        lambda p: jloss(p, jb, jax.random.key(0))[0], params).dtype)

    model = load_jax_params(build_task(cfg), jax.device_get(params))
    got = {}
    for name in stages.values():
        model.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: got.__setitem__(name, _dtype_name(o.dtype)))
    tb = to_device(b, torch.device("cpu"))
    loss, _ = task_loss(cfg)(model, tb)
    got["loss"] = _dtype_name(loss.dtype)
    from ucf_vit_tpu_torch.tasks import sap_inputs

    got["logits"] = _dtype_name(model(*sap_inputs(cfg, tb)).dtype)
    assert got == want
    assert want["blocks.1"] == "bfloat16" and want["neck"] == "float32"


def _mae_for_sap():
    """A JAX MAE (tile 16^3, patch 2: 512 tokens) with the shrunk SAP's encoder width
    and depth, and that SAP, each flax-initialised."""
    raw = _sap_raw()
    b = _sap_batches(Config(raw=raw, task="sap"), 1)[0]
    _, _, sparams = _sap_jax(raw, b, seed=1)
    jmae = JMAE(attn_impl=JAttnImpl.EINSUM, class_token=False, img_size=(16, 16, 16),
                patch_size=2, in_chans=1, twoD=False, embed_dim=24, depth=2, num_heads=2,
                decoder_embed_dim=18, decoder_depth=1, decoder_num_heads=3)
    mparams = meta.unbox(jmae.init(jax.random.key(2), jnp.asarray(b["x"]),
                                   mask_noise=jnp.asarray(_mae_noise(2, 512)))["params"])
    return jax.device_get(mparams), jax.device_get(sparams), raw


def test_transfer_mae_encoder_into_sap_matches_jax():
    """The encoder's entries from the MAE (the position table resampled from 512 rows
    to SAP's 64), the neck, the head and the position MLP SAP's own."""
    mparams, sparams, _ = _mae_for_sap()
    want = jax_to_torch_state(jax_transfer_mae_encoder(mparams, sparams, new_pos_embed_len=64))
    mae_sd = {k: torch.from_numpy(v.copy()) for k, v in jax_to_torch_state(mparams).items()}
    target = {k: torch.from_numpy(v) for k, v in jax_to_torch_state(sparams).items()}
    got = transfer_mae_encoder(mae_sd, target, new_pos_embed_len=64)
    assert sorted(got) == sorted(want) == sorted(target)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert torch.equal(got["blocks.1.mlp.fc2.weight"], mae_sd["blocks.1.mlp.fc2.weight"])
    np.testing.assert_array_equal(got["pos_embed"].numpy(),
                                  interpolate_pos_embed_1d(mae_sd["pos_embed"].numpy(), 64))
    for k in ("neck.0.weight", "mask_header.0.weight", "adaptive_pos_dep_emb.0.weight"):
        assert torch.equal(got[k], target[k])


@pytest.mark.parametrize("name", ["sap", "sap_bf16"])
def test_cli_trains_sap_synthetic(tmp_path, monkeypatch, name):
    """`python -m ucf_vit_tpu_torch.train configs/basic_ct/<name>/base_config.yaml
    --single-device --synthetic --max-steps 2 --device cpu` on the config shrunk;
    without `--device cpu` and with no CUDA it raises."""
    raw = _sap_raw(name, checkpoint_path=str(tmp_path / "ck"))
    raw["parallelism"] = {"fsdp_size": 1, "simple_ddp_size": 8, "tensor_par_size": 1,
                          "seq_par_size": 1}
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    out = main([str(path), "--single-device", "--synthetic", "--max-steps", "2", "--device",
                "cpu"])
    model = out["state"].model
    assert isinstance(model, SAP) and model.dtype == (torch.bfloat16 if name == "sap_bf16"
                                                      else None)
    assert len(out["loss_list"]) == 1 and np.isfinite(out["loss_list"][0])
    assert os.path.isfile(tmp_path / "ck" / "multi_last_even.ckpt")
    assert ckpt.restore_checkpoint(str(tmp_path / "ck"), "")["head_meta"] == [2, 0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(path), "--single-device", "--synthetic", "--max-steps", "2"])


def test_cli_trains_sap_from_labelled_nifti_warm_started_from_an_mae(tmp_path, capsys):
    """`trainer.pretrained_mae_checkpoint` into SAP: the encoder equals the MAE's, the
    neck and head keep their init; then the shrunk basic_ct/sap trains from labelled
    NIfTI volumes through the CLI, in line and with a pool of 2, and saves."""
    mparams, _, raw = _mae_for_sap()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jax_to_torch_state(mparams).items()}
    mae_dir = tmp_path / "mae"
    os.makedirs(mae_dir)
    torch.save({"epoch": 3, "model_state_dict": sd, "loss_list": [], "head_meta": [2, 3]},
               str(mae_dir / "mae_odd.ckpt"))
    raw["trainer"].update(pretrained_mae_checkpoint=str(mae_dir),
                          checkpoint_path=str(tmp_path / "ck"))
    raw["data"].update(dict_root_dirs={"ct1": _labelled_volumes(tmp_path / "ct", 2, 32)},
                       num_workers=1)
    cfg = Config(raw=raw, task="sap")
    state, _ = init_train(cfg, "cpu")
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    transfer_pretrained_mae(cfg, state.model, str(mae_dir))
    got = state.model.state_dict()
    assert torch.equal(got["blocks.1.attn.qkv.weight"], sd["blocks.1.attn.qkv.weight"])
    assert torch.equal(got["token_embeds.proj.weight"], sd["token_embeds.proj.weight"])
    for k in ("neck.0.weight", "mask_header.0.weight", "mask_header.0.bias"):
        assert torch.equal(got[k], init[k])
    for workers in (1, 3):
        raw["data"]["num_workers"] = workers
        path = tmp_path / f"sap_{workers}.yaml"
        path.write_text(yaml.safe_dump(raw))
        out = main([str(path), "--single-device", "--max-steps", "2", "--device", "cpu"])
        assert "initialized encoder from MAE checkpoint" in capsys.readouterr().out
        assert len(out["loss_list"]) == 1 and np.isfinite(out["loss_list"][0])
    assert os.path.isfile(tmp_path / "ck" / "multi_last_even.ckpt")


# ---------------------------------------------------------------- varemb in training
#
# imagenet/classification with `use_varemb` (three variables merged by the variable
# attention over the quadtree's tokens) shrunk: five f32 steps within LOSS_TOL of the
# JAX trainer's step; a single-channel run whose batches alternate variables hands
# each batch's var_ids to its step, as the JAX trainer keys its step by them.

VAREMB_STEPS = 5


def _varemb_raw(**data):
    raw = _adaptive_raw("imagenet/classification")
    raw["model"]["net"]["init_args"].update(use_varemb=True, num_heads=4)
    raw["data"].update(data)
    return raw


def test_varemb_train_steps_match_jax():
    raw = _varemb_raw()
    cfg = Config(raw=raw, task="classification")
    batches = _adaptive_batches(cfg, VAREMB_STEPS)
    jmod, jloss = jax_build_classification(JConfig(raw=raw, task="classification"))
    var_ids = jmod.get_var_ids(("red", "green", "blue"))
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    params = meta.unbox(jmod.init(jax.random.key(0), b0["seq"], var_ids,
                                  jax_seq_ps(b0))["params"])
    params = jax.tree.map(jnp.asarray, params)
    assert "var_agg" in params and "token_embed_2" in params
    tx = _mae_optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=None, ema_params=None)
    jstep = jax_make_train_step(lambda p, b, r: jloss(p, b, r, var_ids=var_ids), tx,
                                donate=False)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    raw["trainer"]["attn_impl"] = "FLASH"
    cfg = Config(raw=raw, task="classification")
    model = load_jax_params(build_task(cfg), jax.device_get(params))
    assert model.get_var_ids(("red", "green", "blue")) == var_ids
    opt = _mae_optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt)
    step = make_train_step(task_loss(cfg), opt)
    losses = [step(state, to_device(b, torch.device("cpu")), var_ids)[1].item()
              for b in batches]
    np.testing.assert_allclose(losses, jax_losses, atol=LOSS_TOL, rtol=0)


def test_trainer_hands_alternating_variables_their_var_ids(monkeypatch):
    """Single-channel batches whose `variables` alternate (as two datasets of other
    variables give them): each step and each validation batch gets the var_ids the
    JAX model's `get_var_ids` gives for its batch, and the two variables' embeds
    both train."""
    from ucf_vit_tpu_torch import train as port_train

    raw = _varemb_raw(single_channel=True, num_channels_used={"d": 1})
    raw["trainer"].update(val_every=1, val_batches=2)
    cfg = Config(raw=raw, task="classification")
    jmod, _ = jax_build_classification(JConfig(raw=raw, task="classification"))
    order = [("green",), ("red",), ("blue",), ("green",)]

    def alternating(cfg, global_batch, seed=0):
        for i, b in enumerate(synthetic_batches(cfg, global_batch, seed)):
            b["variables"] = order[i % len(order)]
            yield b

    seen = []
    loss_of = port_train.task_loss

    def spying(cfg):
        inner = loss_of(cfg)

        def loss_fn(model, batch, var_ids=None):
            seen.append(var_ids)
            return inner(model, batch, var_ids=var_ids)

        return loss_fn

    monkeypatch.setattr(port_train, "synthetic_batches", alternating)
    monkeypatch.setattr(port_train, "task_loss", spying)
    out = train(cfg, max_steps=4, synthetic=True, device="cpu")
    want = [jmod.get_var_ids(v) for v in order]
    assert seen == want + want[:2]  # four steps, then the two validation batches
    init = init_train(cfg, "cpu")[0].model
    trained = out["state"].model
    assert all(not torch.equal(trained.token_embeds[i][1].weight, init.token_embeds[i][1].weight)
               for i in range(3))
