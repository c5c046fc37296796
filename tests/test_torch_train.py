"""The port's training slice against the JAX package, on the CPU at small
sizes: cross-entropy and accuracy, the warmup-cosine schedule, the no-decay
mask, the loss-scale update, and the train step over 20 steps from one JAX
init (moved across with `load_jax_params`) on the same synthetic batches,
with attention EINSUM and FLASH (`FlashAttentionFn` with its plain backward)
and with accumulation, clipping, EMA and loss scaling. Then the trainer's
CLI."""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml
from flax.core import meta

torch = pytest.importorskip("torch")

from ucf_vit_tpu.config import Config as JConfig
from ucf_vit_tpu.parallel.train_step import TrainState as JTrainState
from ucf_vit_tpu.parallel.train_step import make_train_step as jax_make_train_step
from ucf_vit_tpu.tasks import build_classification as jax_build_classification
from ucf_vit_tpu.utils import metrics as jax_metrics
from ucf_vit_tpu.utils import optim as jax_optim
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.convert import jax_to_torch_state, load_jax_params
from ucf_vit_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ucf_vit_tpu_torch.tasks import build_classification, task_loss
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
    cfg = _tiny_yaml(tmp_path)
    with pytest.raises(NotImplementedError, match="data pipeline"):
        main([cfg, "--max-steps", "1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([cfg, "--synthetic", "--max-steps", "1"])
    for key, value in (("resume_from_checkpoint", True), ("val_every", 1),
                       ("tensorboard_dir", "tb")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main([_tiny_yaml(tmp_path, **{key: value}), "--synthetic", "--device", "cpu"])


def test_chip_smoke_drives_the_trainer():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    imported = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "ucf_vit_tpu_torch.train" in imported
