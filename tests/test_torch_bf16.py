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
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml
from flax.core import meta

torch = pytest.importorskip("torch")

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
