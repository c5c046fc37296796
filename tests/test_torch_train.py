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

Sections moved out whole, to spread the tier-1 run's workers: the octree and UNETR,
DiffusionVIT and DDPM, and adaptive patching to tests/test_torch_flash.py; SAP,
varemb in training and trainer parity to tests/test_torch_mlp_int8.py."""

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
if os.environ.get("PYTEST_XDIST_WORKER"):  # xdist's workers share the cores: one torch
    torch.set_num_threads(1)  # thread each keeps them from oversubscribing the machine

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
from ucf_vit_tpu.train import build_dataloader as jax_build_dataloader
from ucf_vit_tpu.utils import metrics as jax_metrics
from ucf_vit_tpu.utils import optim as jax_optim
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.convert import jax_to_torch_state, load_jax_params
from ucf_vit_tpu_torch.inference import init_eval_model, reconstruct
from ucf_vit_tpu_torch.models import MAE
from ucf_vit_tpu_torch.ops.patchify import patchify, unpatchify
from ucf_vit_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ucf_vit_tpu_torch.tasks import build_classification, build_mae, build_task, task_loss
from ucf_vit_tpu_torch.train import main, synthetic_batches, to_device
from ucf_vit_tpu_torch.utils import metrics, optim


from ucf_vit_tpu.train import build_dataloader as jax_build_dataloader


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
                      ("expert_par_size", None)):
        raw = _raw()
        raw["parallelism"] = {key: 2}
        if key == "expert_par_size":  # the config's own check wants experts to shard
            raw["model"]["net"]["init_args"]["moe_num_experts"] = 2
        path = tmp_path / f"{key}.yaml"
        path.write_text(yaml.safe_dump(raw))
        if item is None:  # expert parallelism passes the check: the world size stops it
            with pytest.raises(RuntimeError, match="asks for 2 processes but 1 was launched"):
                main([str(path), "--synthetic", "--device", "cpu"])
            continue
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md, modules to port, {item}"):
            main([str(path), "--synthetic", "--device", "cpu"])
    # sequence parallelism passes the trainer's check for every task (one process launched,
    # so the world size is what stops them here); UNETR and SAP build under it (the spatial
    # partition) and run a forward
    for task in ("classification", "mae", "diffusion", "unetr", "sap"):
        raw = _raw()
        raw["trainer"]["task"] = task
        raw["parallelism"] = {"seq_par_size": 2}
        path = tmp_path / f"sp_{task}.yaml"
        path.write_text(yaml.safe_dump(raw))
        with pytest.raises(RuntimeError, match="asks for 2 processes but 1 was launched"):
            main([str(path), "--synthetic", "--device", "cpu"])
        if task in ("unetr", "sap"):
            raw["model"]["net"]["init_args"]["depth"] = 4  # UNETR's three distinct taps
            path.write_text(yaml.safe_dump(raw))
            model = build_task(load_config(str(path)))
            model.init_weights(torch.Generator().manual_seed(0))
            with torch.no_grad():
                logits = model.eval()(torch.randn(2, 3, 32, 32))
            assert logits.shape[:2] == (2, 4) and torch.isfinite(logits).all()
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
    with pytest.raises(NotImplementedError, match="ROADMAP.md, modules to port: pipeline, item 12"):
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


