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
differ)."""

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


@pytest.mark.parametrize("variant", ["adaptive_pos_mlp", "pipe_par", "varemb"])
def test_unported_variants_raise_with_their_roadmap_item(variant):
    kw = dict(MAE_KW, **MAE_TILES["3d"])
    item = {"adaptive_pos_mlp": "VIT input variants", "pipe_par": "pipeline \\+ MoE",
            "varemb": "VIT input variants"}[variant]
    kw.update({"adaptive_pos_mlp": dict(use_adaptive_pos_emb=True),
               "pipe_par": dict(pipe_par_size=2, scan_layers=True),
               "varemb": dict(use_varemb=True)}[variant])
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, modules to port: {item}"):
        MAE(**kw)


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
    the shipped one."""
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
    with pytest.raises(NotImplementedError, match="single-device"):
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
