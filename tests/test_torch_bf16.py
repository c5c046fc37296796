"""The port's training remainder against the JAX package, on the CPU at small
sizes (depth 2, embed 32): the bf16 compute / f32 parameter policy module by
module and through the train step, `remat`, patch dropout, the scan-layers
parameter layout, and the CLI on the ViT-L config shrunk in memory. Weights
are the flax init plus numpy noise, moved across with `load_jax_params`;
inputs and noise come from numpy seeds.

Tolerances of the bf16 comparisons are counted in bf16 ulps of the largest
entry of the reference (`_ulp`). Both sides hold f32 parameters, cast them to
bf16 per call and round every Dense and LayerNorm output to bf16, but XLA on
the CPU and torch round at different places inside a module (the bias add
inside or after the product's rounding, GELU and softmax intermediates in
f32 or bf16), so an output can land on the neighbouring bf16 value: one ulp
was the largest difference seen for a module and for a Block, and the
tolerance is 2 ulps for both. The logits are f32 on both sides but computed
from a bf16 residual stream two blocks deep; they agree within 2 bf16 ulps
of 1.0, the scale of the normed stream (seen: half an ulp).

The last section is UNETR's spatial partition over gloo ranks against the JAX
package's sharded step, with its own module fixture and the config helpers of
tests/test_torch_dropout.py's sharded section.
"""

import os

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
from ucf_vit_tpu.models.blocks import Attention as JAttention
from ucf_vit_tpu.models.blocks import Block as JBlock
from ucf_vit_tpu.models.blocks import Mlp as JMlp
from ucf_vit_tpu.models.vit import VIT as JVIT
from ucf_vit_tpu.ops.attention import AttnImpl as JAttnImpl
from ucf_vit_tpu.parallel.train_step import TrainState as JTrainState
from ucf_vit_tpu.parallel.train_step import make_train_step as jax_make_train_step
from ucf_vit_tpu.tasks import build_classification as jax_build_classification
from ucf_vit_tpu.utils import optim as jax_optim
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.convert import jax_to_torch_state, load_jax_params
from ucf_vit_tpu_torch.models.blocks import Attention, Block, Mlp
from ucf_vit_tpu_torch.models.vit import VIT
from ucf_vit_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ucf_vit_tpu_torch.tasks import build_classification, task_loss
from ucf_vit_tpu_torch.train import main, synthetic_batches, to_device
from ucf_vit_tpu_torch.utils import optim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
VIT_KW = dict(img_size=(32, 32), patch_size=8, in_chans=3, num_classes=5, embed_dim=32,
              depth=2, num_heads=4)


def _params(module, *args, seed=0, **kwargs):
    """flax init, unboxed to numpy, plus N(0, 0.05) noise on every leaf."""
    params = meta.unbox(module.init(jax.random.key(0), *args, **kwargs)["params"])
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params
    )


def _x(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ulp(ref: np.ndarray) -> float:
    """One bf16 ulp (8 significant bits) at the largest entry of `ref`."""
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


def _within_ulps(out, ref, ulps):
    ref = np.asarray(ref, np.float32)
    got = out.detach().float().numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= ulps * _ulp(ref), f"{err / _ulp(ref):.2f} ulps (allowed {ulps})"


# ---------------------------------------------------------------- modules in bf16


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
def test_mlp_bf16_matches_flax(gelu_approx):
    x = _x(2, 9, 32)
    jmod = JMlp(hidden_features=64, out_features=32, gelu_approx=gelu_approx, dtype=jnp.bfloat16)
    params = _params(jmod, jnp.asarray(x))
    ours = load_jax_params(Mlp(32, 64, 32, gelu_approx=gelu_approx, dtype=BF16), params).eval()
    out = ours(torch.from_numpy(x))
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    _within_ulps(out, ref, 2)


@pytest.mark.parametrize("impl", ["FLASH", "EINSUM"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_attention_bf16_matches_flax(impl, qk_norm):
    """EINSUM keeps the JAX EINSUM's dtype rules (bf16 scores lifted to f32);
    FLASH keeps f32 scores from the bf16 inputs, as the JAX flash kernel
    does, so against the JAX EINSUM it is off by the scores' rounding too."""
    x = _x(2, 17, 32)
    jmod = JAttention(dim=32, num_heads=4, qkv_bias=True, qk_norm=qk_norm,
                      attn_impl=JAttnImpl.EINSUM, dtype=jnp.bfloat16)
    params = _params(jmod, jnp.asarray(x))
    ours = load_jax_params(
        Attention(32, 4, attn_impl=impl, qkv_bias=True, qk_norm=qk_norm, dtype=BF16),
        params).eval()
    out = ours(torch.from_numpy(x))
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    _within_ulps(out, ref, 2)


@pytest.mark.parametrize("init_values", [None, 0.5], ids=["no_ls", "layer_scale"])
def test_block_bf16_matches_flax(init_values):
    x = _x(2, 17, 32).astype(jnp.bfloat16)  # the residual stream a block meets is bf16
    jmod = JBlock(dim=32, num_heads=4, qkv_bias=True, init_values=init_values,
                  attn_impl=JAttnImpl.EINSUM, dtype=jnp.bfloat16)
    params = _params(jmod, jnp.asarray(x))
    ours = load_jax_params(
        Block(32, 4, qkv_bias=True, init_values=init_values, attn_impl="EINSUM", dtype=BF16),
        params).eval()
    out = ours(torch.from_numpy(np.asarray(x, np.float32)).to(BF16))
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    # LayerScale multiplies a bf16 tensor by an f32 parameter: f32 on both sides
    assert str(ref.dtype) == str(out.dtype).removeprefix("torch.")
    _within_ulps(out, ref, 2)


@pytest.mark.parametrize("impl", ["FLASH", "EINSUM"])
def test_vit_bf16_logits_match_flax(impl):
    x = _x(2, 3, 32, 32)
    jmod = JVIT(attn_impl=JAttnImpl.EINSUM, dtype=jnp.bfloat16, **VIT_KW)
    params = _params(jmod, jnp.asarray(x))
    ours = load_jax_params(VIT(attn_impl=impl, dtype=BF16, **VIT_KW), params).eval()
    with torch.inference_mode():
        out = ours(torch.from_numpy(x))
        stream = ours.forward_features(torch.from_numpy(x))
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    # the final norm and the head take no dtype: f32 logits on both sides
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    assert stream.dtype == torch.float32
    err = np.abs(out.numpy() - np.asarray(ref)).max()
    # the normed stream is O(1) and the head's gain below 1 here: 2 bf16 ulps of 1.0
    assert np.abs(np.asarray(ref)).max() < 1.0
    assert err <= 2 * 2.0**-7, err


def test_bf16_keeps_f32_params_and_grads():
    x = torch.from_numpy(_x(4, 3, 32, 32))
    model = VIT(attn_impl="FLASH", dtype=BF16, **VIT_KW)
    model.init_weights(torch.Generator().manual_seed(0)).train()
    model(x).square().mean().backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name
    # the residual stream between the blocks is bf16
    seen = []
    hook = model.blocks[1].register_forward_hook(lambda m, a, out: seen.append((a[0].dtype,
                                                                                out.dtype)))
    model(x)
    hook.remove()
    assert seen == [(BF16, BF16)]


# ---------------------------------------------------------------- remat


def _loss_and_grads(model, x, seed):
    model.set_generator(torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed))
    for p in model.parameters():
        p.grad = None
    loss = model(x).square().mean()
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rates0", "rates0.1"])
@pytest.mark.parametrize("impl", ["FLASH", "EINSUM"])
def test_remat_equals_no_remat_exactly(impl, rate):
    """The recompute of a block runs the same ops on the same inputs and, at
    rate 0.1, must draw the same dropout masks, DropPath masks and attention
    seeds again from the explicit generators: loss and every gradient are
    bit-equal to the run that keeps its activations."""
    kw = dict(VIT_KW, attn_impl=impl, proj_drop_rate=rate, attn_drop_rate=rate,
              drop_path_rate=rate, pos_drop_rate=rate)
    x = torch.from_numpy(_x(4, 3, 32, 32))
    plain = VIT(remat=False, **kw).init_weights(torch.Generator().manual_seed(0)).train()
    remat = VIT(remat=True, **kw).init_weights(torch.Generator().manual_seed(0)).train()
    for step_seed in (3, 4):  # two steps: the generators end a step where no-remat leaves them
        loss_a, grads_a = _loss_and_grads(plain, x, step_seed)
        loss_b, grads_b = _loss_and_grads(remat, x, step_seed)
        assert loss_a == loss_b
        for name in grads_a:
            assert torch.equal(grads_a[name], grads_b[name]), name
    if rate > 0:
        again, _ = _loss_and_grads(plain, x, 5)
        assert again != loss_a  # the draws do matter
        # after a remat step the generators stand where a plain step leaves them
        _loss_and_grads(plain, x, 6), _loss_and_grads(remat, x, 6)
        assert torch.equal(plain.generator.get_state(), remat.generator.get_state())
        assert torch.equal(plain.host_generator.get_state(), remat.host_generator.get_state())


def test_remat_is_off_outside_training():
    model = VIT(remat=True, **VIT_KW).init_weights(torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(_x(2, 3, 32, 32))
    with torch.inference_mode():
        out = model(x)
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------- patch dropout


@pytest.mark.parametrize("class_token", [True, False], ids=["cls", "no_cls"])
def test_patch_drop_matches_jax_with_injected_noise(monkeypatch, class_token):
    kw = dict(VIT_KW, patch_drop_rate=0.4, class_token=class_token)
    x = _x(3, 3, 32, 32)
    noise = np.random.default_rng(7).uniform(size=(3, 16)).astype(np.float32)
    jmod = JVIT(attn_impl=JAttnImpl.EINSUM, **kw)
    params = _params(jmod, jnp.asarray(x))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(noise))
    ref_tokens = jmod.apply({"params": params}, jnp.asarray(x), deterministic=False,
                            rngs={"dropout": jax.random.key(0)},
                            method=JVIT.forward_features)
    ref = jmod.apply({"params": params}, jnp.asarray(x), deterministic=False,
                     rngs={"dropout": jax.random.key(0)})
    ours = load_jax_params(VIT(attn_impl="EINSUM", **kw), params).train()
    got_tokens = ours.forward_features(torch.from_numpy(x), torch.from_numpy(noise))
    got = ours(torch.from_numpy(x), patch_drop_noise=torch.from_numpy(noise))
    keep = max(1, int(16 * 0.6))
    assert got_tokens.shape == ref_tokens.shape == (3, keep + int(class_token), 32)
    np.testing.assert_allclose(got_tokens.detach().numpy(), np.asarray(ref_tokens), atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=5e-5)
    # eval keeps every token; training without a generator raises by name
    assert ours.eval().forward_features(torch.from_numpy(x)).shape[1] == 16 + int(class_token)
    with pytest.raises(RuntimeError, match="set_generator"):
        ours.train()(torch.from_numpy(x))
    ours.set_generator(torch.Generator().manual_seed(0), torch.Generator().manual_seed(0))
    assert ours(torch.from_numpy(x)).shape == ((3, 5) if class_token else (3, keep, 5))


# ---------------------------------------------------------------- scan layers


def test_scan_layers_tree_loads_and_gives_the_unscanned_logits():
    x = _x(2, 3, 32, 32)
    scanned = JVIT(attn_impl=JAttnImpl.EINSUM, scan_layers=True, **VIT_KW)
    params = _params(scanned, jnp.asarray(x))
    assert set(params["blocks"]) == {"block"}
    assert params["blocks"]["block"]["attn"]["qkv"]["kernel"].shape == (2, 32, 96)
    ref = scanned.apply({"params": params}, jnp.asarray(x))
    ours = load_jax_params(VIT(attn_impl="EINSUM", scan_layers=True, **VIT_KW), params).eval()
    with torch.inference_mode():
        out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=0)
    # the same numbers as layer i of an unscanned tree
    state = jax_to_torch_state(params)
    for i in range(2):
        np.testing.assert_array_equal(
            state[f"blocks.{i}.attn.qkv.weight"],
            params["blocks"]["block"]["attn"]["qkv"]["kernel"][i].T)
    unscanned = {k: v for k, v in params.items() if k != "blocks"}
    for i in range(2):
        unscanned[f"blocks_{i}"] = jax.tree.map(lambda a: a[i], params["blocks"]["block"])
    plain = load_jax_params(VIT(attn_impl="EINSUM", **VIT_KW), unscanned).eval()
    with torch.inference_mode():
        assert torch.equal(plain(torch.from_numpy(x)), out)
    with pytest.raises(ValueError, match="drop_path_rate == 0"):
        VIT(scan_layers=True, drop_path_rate=0.1, **VIT_KW)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VIT(scan_layers=True, pipe_par_size=2, **VIT_KW)


# ---------------------------------------------------------------- train step in bf16


STEPS = 5
# per-step loss in bf16 against JAX: the two frameworks round inside a module at
# different places (module docstring), which moves a logit by up to 2 bf16 ulps
# of 1.0 (1.6e-2) and the loss, a mean over 8 samples, by a fraction of that
# (seen: 6.4e-4). The parameters are f32 and 5 updates at lr 1e-3 move them far
# less than a bf16 ulp, so the tolerance does not grow with the step.
BF16_LOSS_TOL = 5e-3


def _raw(**trainer):
    ia = {"default_vars": ["red", "green", "blue"], "tile_size": [32, 32], "patch_size": 8,
          "embed_dim": 32, "depth": 2, "num_heads": 2, "mlp_ratio": 2, "twoD": True,
          "adaptive_patching": False}
    m = {"lr": 1e-3, "beta_1": 0.9, "beta_2": 0.95, "weight_decay": 1e-2,
         "warmup_steps": 5, "max_steps": 20, "warmup_start_lr": 1e-8, "eta_min": 1e-8,
         "net": {"init_args": ia}}
    return {"trainer": {"task": "classification", "attn_impl": "EINSUM",
                        "data_type": "bfloat16", **trainer},
            "parallelism": {}, "model": m,
            "data": {"batch_size": 8, "num_classes": 4, "num_channels_used": {"d": 3}}}


def _optimizer(target, raw, configure):
    m = raw["model"]
    return configure(target, lr=m["lr"], beta_1=m["beta_1"], beta_2=m["beta_2"],
                     weight_decay=m["weight_decay"], warmup_steps=m["warmup_steps"],
                     max_steps=m["max_steps"], warmup_start_lr=m["warmup_start_lr"],
                     eta_min=m["eta_min"])


def _batches(raw, n=STEPS):
    stream = synthetic_batches(Config(raw=raw, task="classification"), 8)
    return [{"x": b["x"], "label": b["label"]} for _, b in zip(range(n), stream)]


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_train_step_bf16_matches_jax(remat):
    raw = _raw(remat=remat, accum_steps=2)
    jmod, loss_fn = jax_build_classification(JConfig(raw=raw, task="classification"))
    assert jmod.dtype == jnp.bfloat16 and jmod.remat == remat
    params = meta.unbox(jmod.init(jax.random.key(0), jnp.zeros((1, 3, 32, 32)))["params"])
    params = jax.tree.map(jnp.asarray, params)
    tx = _optimizer(params, raw, jax_optim.configure_optimizer)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                         loss_scale=None, ema_params=None)
    jstep = jax_make_train_step(loss_fn, tx, donate=False, accum_steps=2)
    batches = _batches(raw)
    jax_losses = []
    for b in batches:
        jstate, loss, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.key(0))
        jax_losses.append(float(loss))

    cfg = Config(raw=raw, task="classification")
    model = load_jax_params(build_classification(cfg), jax.device_get(params))
    assert model.dtype == BF16 and model.remat == remat
    opt = _optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt)
    step = make_train_step(task_loss(cfg), opt, accum_steps=2)
    losses = []
    for b in batches:
        state, loss, _ = step(state, to_device(b, torch.device("cpu")))
        assert loss.dtype == torch.float32
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jax_losses, atol=BF16_LOSS_TOL, rtol=0)
    final = jax_to_torch_state(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        # an AdamW update has size lr whatever the gradient's size, so where
        # bf16 rounding moves a tiny gradient across zero the two sides part by
        # up to 2 lr in that step; seen over 5 steps: 3.4e-3
        np.testing.assert_allclose(p.detach().numpy(), final[name], atol=5 * 1e-3, rtol=0,
                                   err_msg=name)


def test_bf16_accumulation_ema_and_loss_scale_stay_f32():
    """Gradients arrive in f32 on f32 parameters and the 4 microbatches' f32
    gradients are summed and averaged; the EMA and the loss-scale state do
    not depend on the compute dtype."""
    raw = _raw(accum_steps=4)
    cfg = Config(raw=raw, task="classification")
    batch = to_device(_batches(raw, 1)[0], torch.device("cpu"))
    model = build_classification(cfg).init_weights(torch.Generator().manual_seed(0))
    loss_fn = task_loss(cfg)
    model.train()
    want = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    for i in range(4):
        for p in model.parameters():
            p.grad = None
        loss_fn(model, {k: v.chunk(4)[i] for k, v in batch.items()})[0].backward()
        for n, p in model.named_parameters():
            assert p.grad.dtype == torch.float32
            want[n] += p.grad
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = _optimizer(model, raw, optim.configure_optimizer)
    state = create_train_state(model, opt, use_grad_scaler=True, ema=True)
    step = make_train_step(loss_fn, opt, accum_steps=4, ema_decay=0.9)
    state, loss, _ = step(state, batch)
    assert torch.isfinite(loss) and opt.count == 1
    for n, p in model.named_parameters():
        assert p.grad.dtype == torch.float32
        # the step scales the loss by 8192 and unscales the f32 sum: the same
        # gradients up to bf16 rounding of the scaled backward signal
        scale = want[n].abs().max().item() / 4
        assert (p.grad - want[n] / 4).abs().max().item() <= 2.0**-6 * max(scale, 1e-6), n
        ema = state.ema_params[n]
        assert ema.dtype == torch.float32
        torch.testing.assert_close(ema, 0.9 * before[n] + 0.1 * p.detach(), atol=1e-7, rtol=0)
    assert state.loss_scale == optim.LossScaleState(scale=8192.0, growth_counter=1)


# ---------------------------------------------------------------- serving in bf16


def test_bf16_config_serves_f32_answers_like_jax():
    from ucf_vit_tpu.serve import build_predictor as jax_build_predictor
    from ucf_vit_tpu_torch.serve import build_predictor

    raw = _raw()
    cfg = Config(raw=raw, task="classification")
    jrun, _, _, (_, jholder, _) = jax_build_predictor(JConfig(raw=raw, task="classification"),
                                                      max_batch=4)
    run, _, _, (model, _, _) = build_predictor(cfg, max_batch=4, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jholder["params"]))
    batch = {"x": _batches(raw, 1)[0]["x"][:4]}
    out, ref = run(batch), np.asarray(jrun(batch))
    assert out.dtype == torch.float32 and ref.dtype == np.float32 and out.shape == ref.shape
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(out.numpy(), ref, atol=2 * 2.0**-7, rtol=0)  # as the logits above


# ---------------------------------------------------------------- the ViT-L config


def test_cli_runs_vit_l_config_shrunk(tmp_path, capsys):
    """`configs/imagenet/classification_vit_l` (bf16, remat, scan_layers,
    accum_steps 4) through the CLI with `--single-device`, shrunk in memory
    to CPU size; every other key is the shipped one."""
    path = os.path.join(REPO, "configs", "imagenet", "classification_vit_l", "base_config.yaml")
    raw = yaml.safe_load(open(path))
    assert raw["trainer"]["data_type"] == "bfloat16" and raw["trainer"]["remat"] is True
    assert raw["trainer"]["scan_layers"] is True and raw["trainer"]["accum_steps"] == 4
    raw["model"]["net"]["init_args"].update(tile_size=[32, 32], patch_size=8, embed_dim=32,
                                            depth=2, num_heads=4)
    raw["data"].update(batch_size=8, num_classes=10)
    raw["dataset_options"]["imagenet_resize"] = {"imagenet": [32, 32]}
    small = tmp_path / "vit_l_small.yaml"
    small.write_text(yaml.safe_dump(raw))
    with pytest.raises(RuntimeError, match="single-device"):  # 32 processes, 1 launched
        main([str(small), "--synthetic", "--device", "cpu", "--max-steps", "2"])
    main([str(small), "--single-device", "--device", "cpu", "--synthetic", "--max-steps", "2"])
    out = capsys.readouterr().out
    assert "epoch 0 it 2 loss" in out and "epoch 0 done" in out
    cfg = Config(raw=raw, task="classification")
    model = build_classification(cfg)
    assert model.dtype == BF16 and model.remat and model.scan_layers


# ================================================================ UNETR's spatial partition
# sp > 1 splits dim 2 of the conv decoder's maps over sp (`parallel.mesh.spatial`), with
# halos (`collectives.halo_exchange`) and cross-shard instance norms. A module fixture
# builds every reference here (the JAX package's sharded steps on the virtual mesh, the
# single-device runs), then starts one gloo group of 4 and one of 2
# (`tests/_torch_sharded.py`) that run every job in turn; the tests only compare: against
# the definition, the blocks whole, the JAX package's sharded step (the five cases of
# tests/test_parallel_unetr_sp.py, and SAP) and one device. The config helpers are the
# sharded section's of tests/test_torch_dropout.py.

import copy

import _torch_sharded
import yaml
from test_torch_dropout import (
    SHARD_LOSS_TOL,
    SHARD_STEPS,
    _cli,
    _eval_raw,
    _jax_steps,
    _shard_model_raw,
    _single_raw,
)
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.train import main as train_main
from ucf_vit_tpu_torch.train import synthetic_batches

HALO_SHAPE = (2, 3, 16, 5, 4)  # dim 2 cut into 8 (2 ranks) or 4 (4 ranks)
HALO_WIDTHS = (1, 2)
# a split block against the same block whole, of the largest entry, both in f64: in f32
# the bias gradients (sums over every position, which the norms behind them nearly
# cancel) differ by their summation order alone up to 3.3e-6 of the largest entry
SPATIAL_TOL = 1e-6
LOGITS_TOL = 1e-5  # a sharded UNETR's or SAP's logits against one device's
DICE_TOL = 1e-6  # the mean Dice on sp 2 against one device's
UNETR_SP_STEPS = 2
SPATIAL_CASES = {  # name: (input shapes, the output's first side, a resize's target)
    "res_block": ([(2, 4, 8, 6, 5)], 8, None),
    "res_block_2d": ([(2, 4, 8, 6)], 8, None),
    "up_block": ([(2, 6, 4, 3, 3), (2, 4, 8, 6, 6)], 8, None),
    "up_block_whole_in": ([(2, 6, 3, 3, 3), (2, 4, 6, 6, 6)], 6, None),
    "pr_up_block_whole_in": ([(2, 6, 3, 3, 3)], 12, None),
    "instance_norm": ([(2, 3, 8, 5, 4)], 8, None),
    "resize_local": ([(1, 2, 36, 3, 4)], 32, (32, 5, 3)),  # the rows it reads lie on the rank
    "resize_gathered": ([(1, 2, 8, 3, 3)], 12, (12, 4, 4)),  # they do not
}
UNETR_SP_CASES = {  # name: (task, (ddp, fsdp, sp, tp), init_args changed)
    "unetr3d_ddp2_sp2": ("unetr", (2, 1, 2, 1), {}),
    "unetr3d_sp2_tp2": ("unetr", (1, 1, 2, 2), {}),
    "unetr2d_ddp2_sp2": ("unetr", (2, 1, 2, 1), {"twoD": True, "tile_size": [16, 16]}),
    "unetr3d_noskip_ddp2_sp2": ("unetr", (2, 1, 2, 1), {"skip_connection": False}),
    # the sqrt-len grid of 3: its 3^3 and 6^3 levels stay whole at sp 4
    "unetr3d_adaptive_sp4": ("unetr", (1, 1, 4, 1), {"patch_size": 2, "adaptive_patching": True,
                                                     "fixed_length": 27}),
    "sap_ddp2_sp2": ("sap", (2, 1, 2, 1), None),
}


def _spatial_inputs(world):
    """{case: {"inputs", "out_side", "target", "w"}}: f64 inputs from a numpy
    seed (instance norm's off centre), the cotangent of the whole output."""
    from _torch_sharded import spatial_case

    rng = np.random.default_rng(21)
    cases = {}
    for name, (shapes, side, target) in SPATIAL_CASES.items():
        xs = [rng.normal(size=s) for s in shapes]
        if name == "instance_norm":
            xs[0] = xs[0] * 2.0 + 3.0
        case = {"inputs": xs, "out_side": side, "target": target}
        y, _, _ = spatial_case(name, case)
        case["w"] = rng.normal(size=y.shape)
        cases[name] = case
    return cases


def _unetr_sp_raw(name):
    """`_shard_model_raw`'s UNETR (the JAX file's sizes: tile 16, patch 4, embed 24,
    depth 4, feature size 4, not adaptive, EINSUM) or SAP on the case's mesh."""
    task, (ddp, fsdp, sp, tp), ia = UNETR_SP_CASES[name]
    raw = _shard_model_raw(task, ddp, fsdp, tp)
    raw["parallelism"]["seq_par_size"] = sp
    if task == "unetr":
        raw["model"]["net"]["init_args"].update(
            {"patch_size": 4, "adaptive_patching": False, **ia})
    return raw


def _unetr_sp_eval_raw(task):
    raw = _eval_raw(task)
    raw["parallelism"] = {"seq_par_size": 2}
    return raw


def _unetr_sp_jobs(tmp):
    """The spatial-partition jobs of the two groups, and what they are held
    against (run here)."""
    from ucf_vit_tpu_torch.inference import evaluate
    from ucf_vit_tpu_torch.serve import build_predictor

    jobs, single = {4: [], 2: []}, {}
    for world in (4, 2):
        rng = np.random.default_rng(world)
        x = rng.normal(size=HALO_SHAPE).astype(np.float32)
        w = {h: rng.normal(size=(world,) + HALO_SHAPE[:2] + (HALO_SHAPE[2] // world + 2 * h,)
                           + HALO_SHAPE[3:]).astype(np.float32) for h in HALO_WIDTHS}
        single[f"halo_{world}"] = (x, w)
        jobs[world].append({"kind": "halo", "name": f"halo_{world}", "x": x, "w": w})
        jobs[world].append({"kind": "spatial_blocks", "name": f"spatial_{world}",
                            "cases": _spatial_inputs(world)})
    for name, (task, shape, _) in UNETR_SP_CASES.items():
        raw = _unetr_sp_raw(name)
        steps = SHARD_STEPS if task == "sap" else UNETR_SP_STEPS
        init, jax_losses, batches = _jax_steps(task, raw, shape, steps)
        job = {"kind": "train", "name": name, "raw": raw, "batches": batches, "init": init,
               "forward": batches[0]}
        jobs[int(np.prod(shape))].append(job)
        single[name] = _torch_sharded.train_job({**job, "raw": _single_raw(raw)})
        single[name]["jax_losses"] = jax_losses
    # evaluation and serving on sp 2
    dice = {t: _unetr_sp_eval_raw(t) for t in ("unetr", "sap")}
    serve_raw = _unetr_sp_eval_raw("unetr")
    vol = {k: v for k, v in next(synthetic_batches(Config(raw=serve_raw, task="unetr"),
                                                   2)).items() if k != "variables"}
    jobs[2] += [{"kind": "eval", "name": f"sp_dice_{t}", "raw": r, "fn": "evaluate",
                 "args": (None, None, True, 2), "kwargs": {"batch_size": 2}}
                for t, r in dice.items()]
    jobs[2].append({"kind": "predictor", "name": "sp_unetr_predictor", "raw": serve_raw,
                    "max_batch": 2, "batch": vol})

    def one(raw):
        raw = copy.deepcopy(raw)
        raw["parallelism"] = {}
        return Config(raw=raw, task=raw["trainer"]["task"])

    for t, r in dice.items():
        single[f"sp_dice_{t}"] = evaluate(one(r), None, None, True, 2, batch_size=2,
                                          device="cpu")
    single["sp_unetr_predictor"] = build_predictor(one(serve_raw), max_batch=2,
                                                   device="cpu")[0](vol).numpy()
    # a UNETR trained 2 steps on (ddp 1, sp 2) and preempted; resumed on one device
    jobs[2].append(_cli("unetr_spa", _unetr_sp_cli_yaml(tmp, "unetr_spa", {"seq_par_size": 2},
                                                        preempt_after_steps=2), "--synthetic"))
    return jobs, single


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """Every spatial-partition job's result (rank 0's), the references it is held
    against, and the fixture's tmp dir."""
    tmp = tmp_path_factory.mktemp("spatial")
    jobs, single = _unetr_sp_jobs(tmp)
    out = {}
    for world in (4, 2):
        out.update(_torch_sharded.run_group(world, jobs[world], tmp))
    return out, single, tmp


def _unetr_sp_cli_yaml(tmp, name, par, **trainer):
    raw = _shard_model_raw("unetr")
    raw["trainer"].update(seed=0, checkpoint_path=str(tmp / "ck"), checkpoint_filename=name,
                          metrics_path=str(tmp / f"{name}.jsonl"), preempt_sync_every=1,
                          **trainer)
    raw["parallelism"] = par
    raw["data"]["batch_size"] = 2
    raw["load_balancing"] = {"batches_per_rank_epoch": {"ct1": 4}}
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_exchange_matches_its_definition(spatial_runs, world):
    """`halo_exchange` along dim 2 on 2 and 4 ranks, widths 1 and 2: each rank's
    slab with its neighbours' edge slices (zeros past the ends), and its
    gradient the sum of every rank's cotangent over the slices it gave, exactly."""
    runs, single, _ = spatial_runs
    x, w = single[f"halo_{world}"]
    k = x.shape[2] // world
    for h in HALO_WIDTHS:
        ys, grads = runs[f"halo_{world}"][h]
        pad = [(0, 0)] * x.ndim
        pad[2] = (h, h)
        padded = np.pad(x, pad)
        acc = np.zeros_like(padded)
        for r in range(world):
            np.testing.assert_array_equal(ys[r], padded[:, :, r * k:r * k + k + 2 * h])
            acc[:, :, r * k:r * k + k + 2 * h] += w[h][r]
        np.testing.assert_array_equal(np.concatenate(grads, 2), acc[:, :, h:-h])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(SPATIAL_CASES))
def test_a_decoder_block_on_a_split_map_matches_it_whole(spatial_runs, name, world):
    """UNETR's decoder blocks, instance norm and the resize with dim 2 split over
    2 and 4 ranks where the side divides (whole where it does not, split after an
    upsample that divides), against the same module on one device: the output,
    the inputs' and the parameters' gradients within SPATIAL_TOL of their largest
    entry, in f64."""
    from _torch_sharded import spatial_case

    runs, _, _ = spatial_runs
    case = _spatial_inputs(world)[name]
    y, leaves, mod = spatial_case(name, case)
    (y * torch.from_numpy(case["w"])).sum().backward()
    got_y, got_in, got_p = runs[f"spatial_{world}"][name]

    def close(got, want, what):
        np.testing.assert_allclose(got, want, atol=SPATIAL_TOL * np.abs(want).max(), rtol=0,
                                   err_msg=what)
    close(got_y, y.detach().numpy(), "output")
    for i, t in enumerate(leaves):
        close(got_in[i], t.grad.numpy(), f"input {i}")
    want_p = {} if mod is None else {k: p.grad.numpy() for k, p in mod.named_parameters()}
    assert set(got_p) == set(want_p)
    scale = max([np.abs(g).max() for g in want_p.values()], default=0.0)
    for k, g in want_p.items():
        if k.endswith("bias") and k.split(".")[-2] in ("conv1", "conv2", "conv3"):
            # ahead of an instance norm: no gradient in exact arithmetic, noise here
            np.testing.assert_allclose(got_p[k], g, atol=SPATIAL_TOL * scale, rtol=0,
                                       err_msg=k)
        else:
            close(got_p[k], g, k)


@pytest.mark.parametrize("name", sorted(UNETR_SP_CASES))
def test_spatially_partitioned_train_step_matches_jax_and_single_device(spatial_runs, name):
    """tests/test_parallel_unetr_sp.py's five cases on the port's ranks (3-D at
    (ddp 2, sp 2) and (sp 2, tp 2), 2-D, no-skip, the adaptive grid of 3 at sp
    4), two steps each, and SAP at (ddp 2, sp 2), three: the per-step losses within
    SHARD_LOSS_TOL of the JAX package's sharded step on the same mesh shape and
    weights and of the port's single device; the logits of the first batch
    before the first step within LOGITS_TOL of the single device's."""
    runs, single, _ = spatial_runs
    got, want = runs[name], single[name]
    np.testing.assert_allclose(got["losses"], want["jax_losses"], atol=SHARD_LOSS_TOL, rtol=0)
    np.testing.assert_allclose(got["losses"], want["losses"], atol=SHARD_LOSS_TOL, rtol=0)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=LOGITS_TOL, rtol=0)
    assert np.isfinite(got["logits"]).all()


@pytest.mark.parametrize("task", ["unetr", "sap"])
def test_segmentation_dice_on_sp2_matches_single_device(spatial_runs, task):
    """`evaluate` (the mean Dice of `evaluate_segmentation`, 2 batches of 2) of
    UNETR and SAP on the sp-2 eval mesh against one device."""
    runs, single, _ = spatial_runs
    got, want = runs[f"sp_dice_{task}"], single[f"sp_dice_{task}"]
    assert np.isfinite(got) and abs(got - want) <= DICE_TOL, (got, want)


def test_served_unetr_class_map_on_sp2_equals_single_device(spatial_runs):
    """The UNETR predictor of `serve.build_predictor` on sp 2 (rank 0 runs the
    batch, rank 1 follows): the int32 class map equal to one device's."""
    runs, single, _ = spatial_runs
    got, want = runs["sp_unetr_predictor"], single["sp_unetr_predictor"]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_unetr_resume_from_sp2_onto_one_device_is_bit_for_bit(spatial_runs):
    """A UNETR trained on (ddp 1, sp 2) through the CLI and preempted after step
    2, resumed on one device: every parameter and the step equal what the sp run
    saved, bit for bit."""
    runs, _, tmp = spatial_runs
    assert runs["unetr_spa"]["step"] == 2
    payload = torch.load(tmp / "ck" / "unetr_spa_even.ckpt", weights_only=True)
    out = train_main([_unetr_sp_cli_yaml(
        tmp, "unetr_spb", {}, resume_from_checkpoint=True,
        checkpoint_filename_for_loading="unetr_spa_latest"), "--synthetic", "--device", "cpu",
        "--max-steps", "2"])
    from ucf_vit_tpu_torch.checkpoint import full_state_dict

    got = full_state_dict(out["state"].model)
    assert out["state"].step == 2 and set(got) == set(payload["model_state_dict"])
    for k, v in payload["model_state_dict"].items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
