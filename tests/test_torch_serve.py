"""The port's serving and evaluation paths on the CPU: the predictor against
the JAX package's on the same weights, the micro-batcher's coalesce/pad/pipeline
semantics (as tests/test_serve.py pins them for the JAX server), an HTTP
round trip against the direct forward, a diffusion deployment's
`/v1/generate` against the direct DDPM chain, an MAE deployment's
`/v1/predict` against the JAX server's under the same mask noise,
`generate_diffusion` and its PNGs against the JAX function's, top-1
evaluation against the JAX package's on the same checkpoint, the inference
CLI, and the import guard."""

import ast
import io
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # xdist's workers share the cores: one torch
    torch.set_num_threads(1)  # thread each keeps them from oversubscribing the machine

from ucf_vit_tpu.serve import build_predictor as jax_build_predictor
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.convert import load_jax_params
from ucf_vit_tpu_torch.inference import (
    diffusion_sampler,
    generate_diffusion,
    init_eval_model,
    load_weights,
)
from ucf_vit_tpu_torch.serve import MicroBatcher, build_predictor, make_server, main
from ucf_vit_tpu_torch.train import example_batch, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^(jax|flax|optax|orbax|ucf_vit_tpu(?!_torch))(\.|$)")


def _cfg(**extra_trainer):
    init = {"default_vars": ["v"], "tile_size": [16, 16], "patch_size": 8,
            "embed_dim": 16, "depth": 2, "num_heads": 2, "mlp_ratio": 2,
            "twoD": True, "adaptive_patching": False}
    data = {"dataset": "basic_ct", "num_channels_used": {"d": 1}, "batch_size": 4,
            "single_channel": True, "num_classes": 3}
    raw = {"trainer": {"task": "classification", "max_epochs": 1, **extra_trainer},
           "parallelism": {"fsdp_size": 1, "simple_ddp_size": 1,
                           "tensor_par_size": 1, "seq_par_size": 1},
           "model": {"lr": 1e-3, "net": {"init_args": init}},
           "data": data}
    return Config(raw=raw, task="classification")


# ---------------------------------------------------------------- predictor


def test_predictor_matches_jax_predictor():
    cfg = _cfg()
    jrun, jpre, jmb, (_, jholder, _) = jax_build_predictor(cfg, max_batch=4)
    run, pre, mb, (model, _, _) = build_predictor(cfg, max_batch=4, device="cpu")
    assert mb == jmb == 4
    params = jax.tree.map(np.asarray, jholder["params"])
    load_jax_params(model, params)
    batch = {"x": example_batch(cfg, 4)["x"]}
    out = run(batch)
    ref = np.asarray(jrun(batch))
    assert out.shape == ref.shape == (4, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5, rtol=0)
    np.testing.assert_array_equal(pre(batch["x"][0])["x"], jpre(batch["x"][0])["x"])


def test_predictor_seeded_weights_and_input_checks():
    cfg = _cfg()
    run_a, pre, _, _ = build_predictor(cfg, seed=0, device="cpu")
    run_b, _, _, _ = build_predictor(cfg, seed=0, device="cpu")
    run_c, _, _, _ = build_predictor(cfg, seed=1, device="cpu")
    batch = {"x": example_batch(cfg, 4)["x"]}
    assert torch.equal(run_a(batch), run_b(batch))
    assert not torch.equal(run_a(batch), run_c(batch))
    with pytest.raises(ValueError, match="expected input shape"):
        pre(np.zeros((2, 16, 16), np.float32))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        build_predictor(cfg, checkpoint_dir="/nonexistent", device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_predictor(_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_server(_cfg(), host="127.0.0.1", port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([os.path.join(REPO, "configs/catsdogs/classification/base_config.yaml"),
              "--port", "0"])


# ---------------------------------------------------------------- micro-batcher


def test_microbatcher_coalesces_and_pads():
    calls = []

    def run_batch(batch):
        assert batch["x"].shape[0] == 4, "batch must be padded to the fixed shape"
        calls.append(1)
        return torch.from_numpy(batch["x"] * 2.0)

    mb = MicroBatcher(run_batch, max_batch=4, max_wait_ms=200.0)
    try:
        samples = [np.full((3,), float(i)) for i in range(3)]
        outs = [None] * 3

        def worker(i):
            outs[i] = mb.submit({"x": samples[i]})

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for i in range(3):
            np.testing.assert_allclose(outs[i], samples[i] * 2.0)
        # 3 concurrent requests within a 200 ms window -> one padded batch
        assert mb.stats["batches"] == 1 and len(calls) == 1
        assert mb.stats["batch_fill_sum"] == 3
        assert mb.stats["requests"] == 3
        # a lone request departs after the window, padded to 4
        np.testing.assert_allclose(mb.submit({"x": np.ones((3,))}), 2.0 * np.ones((3,)))
        assert mb.stats["batches"] == 2
    finally:
        mb.close()


def test_microbatcher_propagates_errors():
    def run_batch(batch):
        raise ValueError("boom")

    mb = MicroBatcher(run_batch, max_batch=2, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="boom"):
            mb.submit({"x": np.ones((2,))})
        assert mb.stats["errors"] == 1
    finally:
        mb.close()


def test_microbatcher_pipeline_depth_1():
    mb = MicroBatcher(lambda batch: torch.from_numpy(batch["x"] * 2.0), max_batch=4,
                      max_wait_ms=20.0, pipeline_depth=1)
    try:
        # sequential lone requests: each must return without a successor
        for i in range(3):
            np.testing.assert_allclose(mb.submit({"x": np.full((3,), float(i))}),
                                       2.0 * np.full((3,), float(i)))
        outs = [None] * 6

        def worker(i):
            outs[i] = mb.submit({"x": np.full((3,), float(i))})

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for i in range(6):
            np.testing.assert_allclose(outs[i], 2.0 * np.full((3,), float(i)))
        assert mb.stats["requests"] == 9

        # a failure at read-back surfaces to that group's waiters
        class Late:
            def cpu(self):
                raise ValueError("late")

        mb.run_batch = lambda batch: Late()
        with pytest.raises(ValueError, match="late"):
            mb.submit({"x": np.ones((3,))})
    finally:
        mb.close()


# ---------------------------------------------------------------- HTTP


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body, method="POST", headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_serve_http_roundtrip_equals_direct_forward():
    cfg = _cfg()
    server = make_server(cfg, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=1.0,
                         device="cpu")
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        assert _get_json(f"{base}/healthz") == {"status": "ok", "task": "classification"}
        # the same seed outside the server gives the same weights: the oracle
        run_batch, preprocess, mb, _ = build_predictor(cfg, max_batch=4, device="cpu")
        rng = np.random.default_rng(7)
        for _ in range(3):
            x = rng.normal(size=(1, 16, 16)).astype(np.float32)
            buf = io.BytesIO()
            np.save(buf, x)
            out = np.load(io.BytesIO(_post(f"{base}/v1/predict", buf.getvalue(),
                                           "application/x-npy")))
            # a lone request is padded by repeating it: the same batch here
            direct = run_batch({k: np.stack([v] * mb) for k, v in preprocess(x).items()})[0]
            assert out.shape == (3,)
            np.testing.assert_array_equal(out, direct.numpy())

        stats = _get_json(f"{base}/v1/stats")
        # the warm-up batch goes through the batcher and counts
        assert stats["requests"] == 4 and stats["batches"] == 4 and stats["errors"] == 0
        assert stats["max_batch"] == 4 and stats["checkpoint_epoch"] is None

        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/predict", b"not npy", "application/x-npy")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/reload", json.dumps({"checkpoint": "/ckpt"}).encode(),
                  "application/json")
        assert e.value.code == 400 and "no checkpoint" in json.loads(e.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get_json(f"{base}/v1/nothing")
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        server.RequestHandlerClass.batcher.close()


# ---------------------------------------------------------------- checkpoints


def _checkpoints(tmp_path, ema: bool):
    """Two epochs of two steps of the port's trainer: the even slot holds epoch 0,
    the odd slot epoch 1 (with `ema`, each with the EMA of the parameters)."""
    d = str(tmp_path / "ck")
    cfg = _cfg(checkpoint_path=d, checkpoint_filename="last", max_epochs=2,
               checkpoint_filename_for_loading="last_latest",
               **({"ema_decay": 0.5} if ema else {}))
    cfg.raw["model"]["warmup_steps"] = 1
    cfg.raw["load_balancing"] = {"batches_per_rank_epoch": {"d": 2}}
    assert len(train(cfg, synthetic=True, device="cpu")["loss_list"]) == 2
    return cfg, d


def _serving(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server):
    server.shutdown()
    server.server_close()
    server.RequestHandlerClass.batcher.close()


def _predict(base, x):
    buf = io.BytesIO()
    np.save(buf, x)
    return np.load(io.BytesIO(_post(f"{base}/v1/predict", buf.getvalue(), "application/x-npy")))


def _reload(base, **body):
    return json.loads(_post(f"{base}/v1/reload", json.dumps(body).encode(), "application/json"))


def test_serve_from_checkpoint_reload_and_ema(tmp_path):
    """`--checkpoint DIR --ema` serves the newest slot's EMA weights; `/v1/reload` swaps
    in another slot (EMA by default, as the server started), or its raw parameters;
    each answer equals the direct forward of a model loaded with those weights."""
    cfg, d = _checkpoints(tmp_path, ema=True)
    x = np.random.default_rng(7).normal(size=(1, 16, 16)).astype(np.float32)

    def direct(path, ema):
        model = init_eval_model(cfg, seed=9, device="cpu")
        epoch = load_weights(model, cfg, path, use_ema=ema)
        with torch.no_grad():
            return epoch, model(torch.from_numpy(np.stack([x] * 4)))[0].numpy()

    even, odd = os.path.join(d, "last_even.ckpt"), os.path.join(d, "last_odd.ckpt")
    server = make_server(cfg, d, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=1.0,
                         use_ema=True, device="cpu")
    try:
        base = _serving(server)
        answers = {}
        answers["odd_ema"] = _predict(base, x)
        assert _get_json(f"{base}/v1/stats")["checkpoint_epoch"] == 1
        assert _reload(base, checkpoint=even) == {"status": "reloaded", "epoch": 0}
        answers["even_ema"] = _predict(base, x)
        assert _reload(base, checkpoint=d, ema=False)["epoch"] == 1
        answers["odd"] = _predict(base, x)
        assert _get_json(f"{base}/v1/stats")["checkpoint_epoch"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _reload(base, checkpoint=str(tmp_path / "nothing"))
        assert e.value.code == 400
        np.testing.assert_array_equal(_predict(base, x), answers["odd"])  # still served
    finally:
        _stop(server)
    for name, (path, ema, epoch) in {"odd_ema": (odd, True, 1), "even_ema": (even, True, 0),
                                     "odd": (odd, False, 1)}.items():
        got_epoch, want = direct(path, ema)
        assert got_epoch == epoch
        np.testing.assert_array_equal(answers[name], want, err_msg=name)
    assert not np.array_equal(answers["odd_ema"], answers["even_ema"])
    assert not np.array_equal(answers["odd_ema"], answers["odd"])


def test_serve_ema_needs_a_checkpoint_with_ema(tmp_path):
    cfg, d = _checkpoints(tmp_path, ema=False)
    with pytest.raises(ValueError, match="no EMA state"):
        make_server(cfg, d, host="127.0.0.1", port=0, max_batch=4, use_ema=True, device="cpu")
    server = make_server(cfg, d, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=1.0,
                         device="cpu")
    try:
        base = _serving(server)
        with pytest.raises(urllib.error.HTTPError) as e:
            _reload(base, checkpoint=d, ema=True)
        assert e.value.code == 400 and "no EMA state" in json.loads(e.value.read())["error"]
        # the head grouping is checked too
        other = Config(raw=json.loads(json.dumps(cfg.raw)), task=cfg.task)
        other.raw["model"]["net"]["init_args"]["num_heads"] = 4
        with pytest.raises(ValueError, match="regrouping"):
            load_weights(init_eval_model(other, device="cpu"), other, d)
    finally:
        _stop(server)


# ---------------------------------------------------------------- diffusion


def _diffusion_cfg(steps=5, **extra_trainer):
    """imagenet/diffusion's model keys at a 16^2 tile, patch 4, depth 2, embed 16,
    a decoder of 16 and `steps` DDPM steps."""
    init = {"default_vars": ["red", "green", "blue"], "tile_size": [16, 16], "patch_size": 4,
            "embed_dim": 16, "depth": 2, "num_heads": 2, "mlp_ratio": 2,
            "decoder_embed_dim": 16, "decoder_depth": 2, "decoder_num_heads": 2,
            "mlp_ratio_decoder": 2, "linear_decoder": False, "twoD": True,
            "adaptive_patching": False, "num_time_steps": steps}
    raw = {"trainer": {"task": "diffusion", "max_epochs": 1, **extra_trainer},
           "parallelism": {"fsdp_size": 1, "simple_ddp_size": 1,
                           "tensor_par_size": 1, "seq_par_size": 1},
           "model": {"lr": 1e-3, "net": {"init_args": init}},
           "data": {"dataset": "imagenet", "num_channels_used": {"d": 3}, "batch_size": 4}}
    return Config(raw=raw, task="diffusion")


def _generate(base, **body):
    return np.load(io.BytesIO(_post(f"{base}/v1/generate", json.dumps(body).encode(),
                                    "application/json")))


def test_serve_generates_by_the_reverse_chain():
    """A diffusion deployment answers `/v1/generate` with `[num, C, H, W]` images, the
    same for one seed and the direct chain's on the same seeded weights; other seeds
    give other images; `/v1/predict` and `/v1/reload` answer 400."""
    cfg = _diffusion_cfg()
    server = make_server(cfg, host="127.0.0.1", port=0, device="cpu", num_generate=3, seed=2)
    assert server.RequestHandlerClass.batcher is None
    try:
        base = _serving(server)
        assert _get_json(f"{base}/healthz") == {"status": "ok", "task": "diffusion"}
        a = _generate(base, seed=7)
        assert a.shape == (3, 3, 16, 16) and a.dtype == np.float32 and np.all(np.isfinite(a))
        two = _generate(base, seed=7, num=2)
        assert two.shape == (2, 3, 16, 16)
        np.testing.assert_array_equal(two, a[:2])
        np.testing.assert_array_equal(_generate(base, seed=7), a)
        assert not np.array_equal(_generate(base, seed=8), a)
        assert _generate(base).shape == (3, 3, 16, 16)  # seed 0
        x = np.zeros((3, 16, 16), np.float32)
        for path, body in (("/v1/predict", _npy_body(x)),
                           ("/v1/reload", json.dumps({"checkpoint": "/ckpt"}).encode())):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}{path}", body, "application/octet-stream")
            assert e.value.code == 400, path
        assert _get_json(f"{base}/v1/stats") == {"task": "diffusion", "requests": 0}
    finally:
        server.shutdown()
        server.server_close()
    model = init_eval_model(cfg, seed=2, device="cpu")
    np.testing.assert_array_equal(diffusion_sampler(cfg, model, 3)(7).numpy(), a)


def _npy_body(x):
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def test_classification_server_answers_generate_with_400():
    server = make_server(_cfg(), host="127.0.0.1", port=0, max_batch=4, device="cpu")
    try:
        base = _serving(server)
        with pytest.raises(urllib.error.HTTPError) as e:
            _generate(base, seed=0)
        assert e.value.code == 400 and "only served for diffusion" in json.loads(
            e.value.read())["error"]
    finally:
        _stop(server)


def test_generate_diffusion_on_the_cpu(tmp_path):
    """`generate_diffusion` runs the whole chain at T = 5 from the seeded init or a
    checkpoint of the port's trainer (its EMA too), the same images for one seed."""
    cfg = _diffusion_cfg(checkpoint_path=str(tmp_path / "ck"), checkpoint_filename="last",
                         checkpoint_filename_for_loading="last_latest", ema_decay=0.5)
    sps, imgs = generate_diffusion(cfg, num_samples=2, return_images=True, device="cpu",
                                   seed=1)
    assert sps > 0 and imgs.shape == (2, 3, 16, 16) and np.all(np.isfinite(imgs))
    np.testing.assert_array_equal(generate_diffusion(cfg, num_samples=2, return_images=True,
                                                     device="cpu", seed=1)[1], imgs)
    cfg.raw["load_balancing"] = {"batches_per_rank_epoch": {"d": 2}}
    assert len(train(cfg, synthetic=True, device="cpu")["loss_list"]) == 1
    d = str(tmp_path / "ck")
    _, trained = generate_diffusion(cfg, d, num_samples=2, return_images=True, device="cpu",
                                    seed=1)
    _, ema = generate_diffusion(cfg, d, num_samples=2, use_ema=True, return_images=True,
                                device="cpu", seed=1)
    assert not np.array_equal(trained, imgs) and not np.array_equal(ema, trained)
    model = init_eval_model(cfg, device="cpu")
    load_weights(model, cfg, d)
    np.testing.assert_array_equal(diffusion_sampler(cfg, model, 2)(1).numpy(), trained)
    with pytest.raises(TypeError, match="DiffusionVIT"):
        diffusion_sampler(_cfg(), init_eval_model(_cfg(), device="cpu"), 2)


def test_serve_main_takes_num_generate(monkeypatch):
    """`--num-generate` reaches the diffusion server; without CUDA the default
    device raises."""
    seen = {}

    def fake_make_server(cfg, *args, **kwargs):
        seen.update(kwargs, task=cfg.task)
        raise SystemExit(0)

    monkeypatch.setattr(sys.modules["ucf_vit_tpu_torch.serve"], "make_server", fake_make_server)
    with pytest.raises(SystemExit):
        main([os.path.join(REPO, "configs/imagenet/diffusion/base_config.yaml"),
              "--num-generate", "4", "--port", "0"])
    assert seen["task"] == "diffusion" and seen["num_generate"] == 4
    assert seen["device"] == "cuda"
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_server(_diffusion_cfg(), host="127.0.0.1", port=0)


# ---------------------------------------------------------------- import guard


def _port_modules():
    pkg = os.path.join(REPO, "ucf_vit_tpu_torch")
    out = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                out.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(out)


def test_port_imports_nothing_of_jax():
    """Import every port module in a fresh interpreter (tests/conftest.py has
    already imported jax into this one) and check what got loaded; read
    chip_smoke.py's imports from its source."""
    mods = _port_modules()
    assert "ucf_vit_tpu_torch.serve" in mods and "ucf_vit_tpu_torch.ops.flash_attention" in mods
    assert {"ucf_vit_tpu_torch.ops.fused_mlp", "ucf_vit_tpu_torch.ops.int8_gemm",
            "ucf_vit_tpu_torch.ops.build"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    assert [m for m in loaded if FORBIDDEN.match(m)] == []
    # importing the port imports no kernel compiler either, nor the JPEG decoders
    # (the data pipeline imports them when it reads its first JPEG)
    assert "triton" not in loaded
    assert {"ucf_vit_tpu_torch.checkpoint", "ucf_vit_tpu_torch.data.pipeline",
            "ucf_vit_tpu_torch.data.datamodule", "ucf_vit_tpu_torch.data.catsdogs"} <= set(mods)
    assert not {"cv2", "PIL"} & set(loaded)

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    imported += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "ucf_vit_tpu_torch.serve" in imported
    assert [m for m in imported if FORBIDDEN.match(m)] == []


# ---------------------------------------------------------------- MAE /v1/predict
#
# A tiny MAE (a 16^3 tile at patch 4: 64 tokens, 16 kept; depth 2, embed 24, a decoder
# of 18) served at max_batch 2. Every row of a served batch is masked by the noise row
# that `reconstruct` draws for a lone sample from the server's seed; the JAX server's
# draw (`jax.random.uniform` in its MAE's `random_masking`) is replaced by that row,
# tiled over the batch. Tolerances: 1e-5 of f32 images (the same sums in other orders,
# as MAE_PRED_TOL in tests/test_torch_train.py).

from ucf_vit_tpu_torch.inference import mask_noise, reconstruct

MAE_SERVE_TOL = 1e-5


def _mae_cfg(**extra_trainer):
    init = {"default_vars": ["ct"], "tile_size": [16, 16, 16], "patch_size": 4,
            "embed_dim": 24, "depth": 2, "num_heads": 2, "mlp_ratio": 2, "decoder_embed_dim": 18,
            "decoder_depth": 2, "decoder_num_heads": 3, "mlp_ratio_decoder": 2, "twoD": False,
            "adaptive_patching": False, "mask_ratio": 0.75}
    raw = {"trainer": {"task": "mae", "max_epochs": 1, "attn_impl": "EINSUM", **extra_trainer},
           "parallelism": {"fsdp_size": 1, "simple_ddp_size": 1,
                           "tensor_par_size": 1, "seq_par_size": 1},
           "model": {"lr": 1e-3, "net": {"init_args": init}},
           "data": {"dataset": "basic_ct", "num_channels_used": {"d": 1}, "batch_size": 2,
                    "single_channel": True}}
    return Config(raw=raw, task="mae")


def test_mae_predict_matches_the_jax_server(monkeypatch):
    cfg = _mae_cfg()
    jrun, _, jmb, (_, jholder, _) = jax_build_predictor(cfg, max_batch=2, seed=3)
    run, pre, mb, (model, _, _) = build_predictor(cfg, max_batch=2, seed=3, device="cpu")
    assert mb == jmb == 2
    load_jax_params(model, jax.tree.map(np.asarray, jholder["params"]))
    row = mask_noise(model, 1, 3, "cpu")
    import jax.numpy as jnp

    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(np.tile(row.numpy(), (2, 1))))
    x = np.random.default_rng(5).normal(size=(2, 1, 16, 16, 16)).astype(np.float32)
    want = np.asarray(jrun({"x": x}))
    got = run({"x": np.stack([pre(s)["x"] for s in x])})
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=MAE_SERVE_TOL, rtol=0)
    # each row is the sample's lone reconstruction under the seed's mask
    for i in range(2):
        np.testing.assert_allclose(got[i].numpy(), reconstruct(model, torch.from_numpy(
            x[i:i + 1]), seed=3)[0].numpy(), atol=MAE_SERVE_TOL, rtol=0)


def test_mae_server_answers_a_request_alike_alone_and_in_a_batch():
    """Over HTTP at max_batch 2: a lone request (its batch padded by repeating it)
    and the same request coalesced with another get the same answer, which is
    `reconstruct`'s for the sample alone; another seed masks other tokens."""
    cfg = _mae_cfg()
    server = make_server(cfg, host="127.0.0.1", port=0, max_batch=2, max_wait_ms=500.0,
                         seed=4, device="cpu")
    x, y = np.random.default_rng(6).normal(size=(2, 1, 16, 16, 16)).astype(np.float32)
    try:
        base = _serving(server)
        alone = _predict(base, x)
        outs = [None, None]

        def ask(i, sample):
            outs[i] = _predict(base, sample)

        threads = [threading.Thread(target=ask, args=(i, s)) for i, s in enumerate((x, y))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stats = _get_json(f"{base}/v1/stats")
    finally:
        _stop(server)
    assert stats["batches"] == 3 and stats["batch_fill_sum"] == 4  # warm-up, alone, pair
    assert alone.shape == x.shape and alone.dtype == np.float32
    np.testing.assert_allclose(outs[0], alone, atol=MAE_SERVE_TOL, rtol=0)
    model = init_eval_model(cfg, seed=4, device="cpu")
    for sample, got in ((x, alone), (y, outs[1])):
        want = reconstruct(model, torch.from_numpy(sample[None]), seed=4)[0].numpy()
        np.testing.assert_allclose(got, want, atol=MAE_SERVE_TOL, rtol=0)
    other = reconstruct(model, torch.from_numpy(x[None]), seed=5)[0].numpy()
    assert np.abs(other - alone).max() > 1e-3


# ---------------------------------------------------------------- generate_diffusion
#
# `generate_diffusion` against the JAX function with the same positional arguments
# `(cfg, None, 2, png_dir)`; the port's chain on the JAX chain's weights and draws at
# T = 10 within 1e-4 (DIFF_SAMPLE_TOL in tests/test_torch_train.py).

from ucf_vit_tpu.config import Config as JConfig
from ucf_vit_tpu.inference import _init_eval_params as jax_init_eval_params
from ucf_vit_tpu.inference import evaluate_classification as jax_evaluate_classification
from ucf_vit_tpu.inference import generate_diffusion as jax_generate_diffusion
from ucf_vit_tpu.tasks import build_task as jax_build_task
from ucf_vit_tpu.tools.convert_checkpoint import export_torch_state
from ucf_vit_tpu.tools.convert_checkpoint import main as convert_main
from ucf_vit_tpu.train import example_batch as jax_example_batch
from ucf_vit_tpu_torch import inference as port_inference
from ucf_vit_tpu_torch.inference import evaluate, evaluate_classification
from ucf_vit_tpu_torch.inference import main as inference_main

GENERATE_TOL = 1e-4


def _png_diffusion_cfg(tile):
    cfg = _diffusion_cfg(steps=10)
    if tile == "3d":
        cfg.raw["model"]["net"]["init_args"].update(default_vars=["ct"], tile_size=[16, 16, 16],
                                                    twoD=False, embed_dim=24, decoder_embed_dim=18)
        cfg.raw["data"]["num_channels_used"] = {"d": 1}
    return cfg


@pytest.mark.parametrize("tile", ["2d", "3d"])
def test_generate_diffusion_takes_the_jax_arguments_and_writes_pngs(tmp_path, monkeypatch, tile):
    """Both functions called with `(cfg, None, 2, png_dir)` write generated_0.png and
    generated_1.png (a volume's middle slice); the port returns samples/s alone, and
    `(samples/s, images)` with `return_images`, which on the JAX init's weights and the
    JAX chain's draws (key 0: a split for x_T, one a step) equal the JAX images."""
    cfg = _png_diffusion_cfg(tile)
    jcfg = JConfig(raw=cfg.raw, task="diffusion")
    jsps, jimgs = jax_generate_diffusion(jcfg, None, 2, str(tmp_path / "jax"), False, True)
    sps = generate_diffusion(cfg, None, 2, str(tmp_path / "port"), device="cpu")
    assert isinstance(sps, float) and sps > 0 and jsps > 0
    for side in ("jax", "port"):
        pngs = sorted(os.listdir(tmp_path / side))
        assert pngs == ["generated_0.png", "generated_1.png"], side
        assert all(open(tmp_path / side / p, "rb").read(8) == b"\x89PNG\r\n\x1a\n" for p in pngs)

    jmod, _ = jax_build_task(jcfg)
    params, _ = jax_init_eval_params(jmod, jcfg, jax_example_batch(jcfg, 2), None, None)
    init = tmp_path / "jax_init.ckpt"
    torch.save({"epoch": 0, "loss_list": [], "model_state_dict": {
        k: torch.from_numpy(np.array(v)) for k, v in export_torch_state(params).items()}}, init)
    key = jax.random.key(0)
    key, init_key = jax.random.split(key)
    x_T = torch.from_numpy(np.array(jax.random.normal(init_key, jimgs.shape)))
    noises = []
    for _ in range(10):
        key, nkey = jax.random.split(key)
        noises.append(torch.from_numpy(np.array(jax.random.normal(nkey, jimgs.shape))))
    real = port_inference.ddpm_sample
    monkeypatch.setattr(port_inference, "ddpm_sample", lambda schedule, denoise, gen, shape,
                        dev: real(schedule, denoise, None, shape, dev, x_T=x_T, noises=noises))
    got_sps, imgs = generate_diffusion(cfg, str(init), 2, None, False, True, device="cpu")
    assert got_sps > 0 and imgs.shape == jimgs.shape
    np.testing.assert_allclose(imgs, jimgs, atol=GENERATE_TOL, rtol=0)


def test_png_writer_names_matplotlib_where_it_is_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ModuleNotFoundError, match="matplotlib") as e:
        generate_diffusion(_diffusion_cfg(), None, 2, str(tmp_path / "png"), device="cpu")
    assert e.value.name == "matplotlib" and not os.path.exists(tmp_path / "png")
    # without png_dir nothing imports it
    assert generate_diffusion(_diffusion_cfg(), None, 1, device="cpu") > 0


# ---------------------------------------------------------------- evaluation, the CLI


def _catsdogs_checkpoint(tmp_path):
    """A catsdogs ViT (16^2 JPEGs, depth 2, embed 32) trained 4 steps by the port's
    trainer, its yaml and the newest checkpoint file."""
    from PIL import Image

    root = tmp_path / "cd"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i, k in enumerate(["cat", "dog"] * 3):
        Image.fromarray(rng.integers(0, 255, size=(40, 36, 3)).astype(np.uint8)).save(
            root / f"{k}.{i}.jpg")
    ia = {"default_vars": ["red", "green", "blue"], "tile_size": [16, 16], "patch_size": 8,
          "embed_dim": 32, "depth": 2, "num_heads": 2, "mlp_ratio": 2, "twoD": True,
          "adaptive_patching": False, "num_classes": 2}
    raw = {"trainer": {"task": "classification", "attn_impl": "EINSUM", "max_epochs": 2,
                       "seed": 0, "checkpoint_path": str(tmp_path / "ck"),
                       "checkpoint_filename": "last"},
           "parallelism": {"fsdp_size": 1, "simple_ddp_size": 1, "tensor_par_size": 1,
                           "seq_par_size": 1},
           "model": {"lr": 1e-3, "warmup_steps": 2, "max_steps": 20,
                     "net": {"init_args": ia}},
           "data": {"dataset": "catsdogs", "dict_root_dirs": {"catsdogs": str(root)},
                    "dict_start_idx": {"catsdogs": 0}, "dict_end_idx": {"catsdogs": 1},
                    "dict_buffer_sizes": {"catsdogs": 4}, "num_channels_used": {"catsdogs": 3},
                    "dict_in_variables": {"catsdogs": ["red", "green", "blue"]},
                    "batch_size": 2, "num_classes": 2, "single_channel": False},
           "load_balancing": {"auto_load_balancing": False}}
    train(Config(raw=raw, task="classification"), max_steps=4, device="cpu")
    path = tmp_path / "catsdogs.yaml"
    path.write_text(__import__("yaml").safe_dump(raw))
    return raw, str(path), str(tmp_path / "ck" / "last_odd.ckpt")


@pytest.mark.parametrize("synthetic", [False, True], ids=["files", "synthetic"])
def test_evaluate_classification_matches_jax_on_one_checkpoint(tmp_path, synthetic):
    """Top-1 of the port's checkpoint against the JAX package's
    `evaluate_classification` on it after `convert_checkpoint to-jax`: the same, over
    the same 6 samples (the JPEG files' first epoch, or the synthetic stream)."""
    raw, cfg_path, ck = _catsdogs_checkpoint(tmp_path)
    assert convert_main(["to-jax", ck, cfg_path, str(tmp_path / "jax"), "--filename",
                         "conv"]) == 0
    jraw = json.loads(json.dumps(raw))
    jraw["trainer"]["checkpoint_filename_for_loading"] = "conv_latest"
    want = jax_evaluate_classification(JConfig(raw=jraw, task="classification"),
                                       str(tmp_path / "jax"), synthetic, 6)
    cfg = Config(raw=raw, task="classification")
    got = evaluate_classification(cfg, ck, synthetic, 6, device="cpu")
    assert got == want
    # the seeded init scores otherwise on the synthetic stream's random labels, or
    # on the files; either way the number is a share of 6
    assert round(got * 6, 6) == int(round(got * 6))


def test_inference_cli_evaluates_and_generates(tmp_path, capsys):
    """`python -m ucf_vit_tpu_torch.inference`: top-1 from a checkpoint, equal to
    `evaluate_classification`'s, with `--checkpoint` and `--ema` (the trainer's EMA);
    a diffusion config generates through `evaluate`."""
    raw, cfg_path, ck = _catsdogs_checkpoint(tmp_path)
    cfg = Config(raw=raw, task="classification")
    top1 = inference_main([cfg_path, "--checkpoint", ck, "--num-samples", "6", "--device",
                           "cpu"])
    assert top1 == evaluate_classification(cfg, ck, False, 6, device="cpu")
    assert "top-1 accuracy over 6 samples" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no EMA state"):
        inference_main([cfg_path, "--checkpoint", ck, "--ema", "--device", "cpu"])
    assert evaluate(_diffusion_cfg(steps=3), None, None, False, 2, device="cpu") > 0


@pytest.mark.parametrize("case", ["no_cuda"])
def test_inference_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, case):
    cfg_path = os.path.join(REPO, "configs/catsdogs/classification/base_config.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference_main([cfg_path, "--synthetic"])


# ---------------------------------------------------------------- adaptive patching
#
# Serving the adaptive configs shrunk (a 32x32 tile at patch 4, 16 patches, depth 2):
# the preprocessor (the training pipeline's patchify at the fixed index) against the
# JAX one, byte for byte, in the request's thread and in a spawn pool; the predictor's
# logits and an adaptive MAE's tokens against the JAX server's (MAE: the JAX draw
# replaced by the port's noise row, as above), 1e-5; an HTTP round trip through the
# pool against the in-process forward; the inference CLI's top-1 on an adaptive config.

import random
import time
from concurrent.futures import ThreadPoolExecutor

import yaml

from ucf_vit_tpu.serve import make_preprocessor as jax_make_preprocessor
from ucf_vit_tpu_torch.serve import make_preprocessor
from ucf_vit_tpu_torch.tasks import seq_ps

ADAPTIVE_SERVE_TOL = 1e-5


def _adaptive_cfg(name, **data):
    with open(os.path.join(REPO, "configs", name, "base_config.yaml")) as f:
        raw = yaml.safe_load(f)
    ia = raw["model"]["net"]["init_args"]
    ia.update(tile_size=[32, 32, 2][:len(ia["tile_size"])], patch_size=4, embed_dim=32,
              depth=2, num_heads=2, fixed_length=16)
    if raw["trainer"]["task"] == "mae":
        ia.update(decoder_embed_dim=24, decoder_depth=2, decoder_num_heads=2)
    raw["trainer"]["attn_impl"] = "EINSUM"
    raw["parallelism"] = {}
    raw["data"].update(batch_size=2, num_classes=4, **data)
    return Config(raw=raw, task=raw["trainer"]["task"])


def _raw_samples(cfg, n, seed=9):
    rng = np.random.default_rng(seed)
    shape = (n, cfg.max_channels, 32, 32)
    if cfg.dataset == "imagenet":  # 8-bit pixels, as the JPEG reader gives them
        return rng.integers(0, 256, size=shape).astype(np.float32)
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("name", ["imagenet/classification", "basic_ct/mae"])
def test_adaptive_preprocessor_matches_jax(name, workers):
    cfg = _adaptive_cfg(name, seed=4)
    jpre = jax_make_preprocessor(cfg)
    pre = make_preprocessor(cfg, workers)
    try:
        for arr in _raw_samples(cfg, 3):
            got, want = pre(arr), jpre(arr)
            assert sorted(got) == ["seq", "seq_pos", "seq_size"]
            for k in got:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
            again = pre(arr.copy())  # the same request, the same tree
            assert all(again[k].tobytes() == got[k].tobytes() for k in got)
        with pytest.raises(ValueError, match="expected input shape"):
            pre(np.zeros((1, 8, 8), np.float32))
    finally:
        pre.close()


class _YieldingGenerator:
    """A generator that lets other threads run for a random while around each
    draw, so that draws from one generator shared between threads would
    interleave."""

    pauses = random.Random(0)

    def __init__(self, gen):
        self.gen = gen

    def _draw(self, name, args, kwargs):
        time.sleep(self.pauses.uniform(0.0, 0.002))
        out = getattr(self.gen, name)(*args, **kwargs)
        time.sleep(self.pauses.uniform(0.0, 0.002))
        return out

    def choice(self, *args, **kwargs):
        return self._draw("choice", args, kwargs)

    def uniform(self, *args, **kwargs):
        return self._draw("uniform", args, kwargs)


def test_adaptive_preprocessor_in_line_gives_every_thread_the_same_tree(monkeypatch):
    """The server's handler threads share one in-line preprocessor: identical
    requests made at once still give byte-identical trees (each call draws
    from a generator of its own). 31 patches of a 32 x 32 tile: a tree that
    the Canny threshold drawn shapes (16 would split the tile evenly whatever
    the draws)."""
    cfg = _adaptive_cfg("imagenet/classification", seed=4)
    cfg.raw["model"]["net"]["init_args"]["fixed_length"] = 31
    pre = make_preprocessor(cfg)
    arr = _raw_samples(cfg, 1)[0]
    want = pre(arr)
    make = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a, **k: _YieldingGenerator(make(*a, **k)))
    start = threading.Barrier(8)

    def client(_):
        start.wait()
        return [pre(arr) for _ in range(6)]

    with ThreadPoolExecutor(8) as ex:
        got = [a for answers in ex.map(client, range(8)) for a in answers]
    assert len(got) == 48
    assert all(a[k].tobytes() == want[k].tobytes() for a in got for k in want)


def _adaptive_batch(pre, samples):
    out = [pre(s) for s in samples]
    return {k: np.stack([o[k] for o in out]) for k in out[0]}


@pytest.mark.parametrize("name", ["imagenet/classification", "imagenet/mae", "basic_ct/mae"])
def test_adaptive_predictor_matches_the_jax_server(monkeypatch, name):
    cfg = _adaptive_cfg(name)
    jrun, jpre, _, (_, jholder, _) = jax_build_predictor(cfg, max_batch=2, seed=3)
    run, pre, mb, (model, _, _) = build_predictor(cfg, max_batch=2, seed=3, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jholder["params"]))
    batch = _adaptive_batch(pre, _raw_samples(cfg, 2))
    if cfg.task == "mae":
        import jax.numpy as jnp

        row = mask_noise(model, 1, 3, "cpu")
        monkeypatch.setattr(jax.random, "uniform",
                            lambda *a, **k: jnp.asarray(np.tile(row.numpy(), (2, 1))))
    want = np.asarray(jrun(batch))
    got = run(batch)
    width = {"classification": 4, "mae": 16 * cfg.max_channels}[cfg.task]
    assert got.shape == want.shape == ((2, width) if cfg.task == "classification"
                                       else (2, 16, width))
    np.testing.assert_allclose(got.numpy(), want, atol=ADAPTIVE_SERVE_TOL, rtol=0)
    if cfg.task == "mae" and model.seq_pack == 1:
        # each row is the sample's lone reconstruction under the seed's mask (a packed
        # encoder takes samples seq_pack at a time)
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        alone = reconstruct(model, b["seq"][:1], seed=3, seq_ps=seq_ps(b)[:1])
        np.testing.assert_allclose(got[:1].numpy(), alone.numpy(), atol=ADAPTIVE_SERVE_TOL,
                                   rtol=0)


def test_adaptive_server_patchifies_in_its_pool():
    """Over HTTP with a pool of 2 preprocessing processes: each answer equals the
    in-process forward of the sample's patchified request, a repeated request the
    same bytes; closing the batcher stops the pool."""
    cfg = _adaptive_cfg("imagenet/classification")
    server = make_server(cfg, host="127.0.0.1", port=0, max_batch=2, max_wait_ms=20.0,
                         seed=5, device="cpu", preprocess_workers=2)
    samples = _raw_samples(cfg, 2, seed=11)
    try:
        base = _serving(server)
        answers = [_predict(base, s) for s in samples] + [_predict(base, samples[0])]
        pool = server.RequestHandlerClass.preprocess
    finally:
        _stop(server)
    assert answers[0].tobytes() == answers[2].tobytes()
    model = init_eval_model(cfg, seed=5, device="cpu")
    pre = make_preprocessor(cfg)
    for s, got in zip(samples, answers):
        b = {k: torch.from_numpy(v[None]) for k, v in pre(s).items()}
        with torch.inference_mode():
            want = model(b["seq"], seq_ps=seq_ps(b))[0].numpy()
        np.testing.assert_allclose(got, want, atol=ADAPTIVE_SERVE_TOL, rtol=0)
    with pytest.raises(RuntimeError, match="shutdown"):
        pool(samples[0])


def test_inference_cli_evaluates_an_adaptive_config(tmp_path):
    cfg = _adaptive_cfg("imagenet/classification")
    path = tmp_path / "adaptive.yaml"
    path.write_text(yaml.safe_dump(cfg.raw))
    top1 = inference_main([str(path), "--synthetic", "--num-samples", "4", "--device", "cpu"])
    assert top1 == evaluate_classification(cfg, None, True, 4, device="cpu")
    assert 0.0 <= top1 <= 1.0



# ---------------------------------------------------------------- UNETR
#
# UNETR's evaluation and serving on the shrunk basic_ct/unetr (tile 16^3, patch 2, 64
# octree tokens, embed 24, depth 4, feature size 4, 4 classes): the preprocessor (the
# octree at the fixed index, and the tile `x`) against the JAX one byte for byte, in
# line and in a spawn pool; the predictor's int32 class map against the JAX server's on
# the same weights; an HTTP round trip through the pool; `evaluate`'s Dice on a port
# checkpoint against the JAX `evaluate` on it after `to-jax` (1e-6); `VolumePredictor`
# on a 24^3 volume against the JAX one (the class map equal); and the inference CLI's
# Dice, `--mae-checkpoint` and `--volume`.

from ucf_vit_tpu.inference import evaluate as jax_evaluate
from ucf_vit_tpu.inference import predict_volume as jax_predict_volume
from ucf_vit_tpu_torch.inference import VolumePredictor, predict_volume

DICE_TOL = 1e-6


def _unetr_cfg(adaptive=True, **trainer):
    with open(os.path.join(REPO, "configs", "basic_ct", "unetr", "base_config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["net"]["init_args"].update(tile_size=[16, 16, 16], patch_size=2,
                                            fixed_length=64, embed_dim=24, depth=4,
                                            num_heads=2, feature_size=4,
                                            adaptive_patching=adaptive)
    raw["model"].update(lr=1e-3, warmup_steps=2, max_steps=20, weight_decay=1e-5,
                        warmup_start_lr=1e-8, eta_min=1e-8)
    raw["trainer"].update(attn_impl="EINSUM", max_epochs=1, **trainer)
    raw["parallelism"] = {}
    raw["data"]["batch_size"] = 2
    return Config(raw=raw, task="unetr")


def _volumes_f32(n, side=16, seed=9):
    """CT-like volumes `[n, 1, side^3]` in [0, 1], with a block the octree sees."""
    rng = np.random.default_rng(seed)
    v = 0.3 * rng.random((n, 1) + (side,) * 3)
    v[:, :, side // 4: 3 * side // 4, side // 4:, : side // 2] += 0.6
    return v.astype(np.float32)


@pytest.mark.parametrize("workers", [0, 2], ids=["in_line", "pool"])
def test_unetr_preprocessor_matches_jax(workers):
    cfg = _unetr_cfg()
    cfg.raw["data"]["seed"] = 4
    jpre, pre = jax_make_preprocessor(cfg), make_preprocessor(cfg, workers)
    try:
        for arr in _volumes_f32(2):
            got, want = pre(arr), jpre(arr)
            assert sorted(got) == sorted(want) == ["seq", "seq_pos", "seq_size", "x"]
            for k in got:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
        assert got["seq"].shape == (1, 64, 8) and got["seq_pos"].shape == (1, 64, 3)
    finally:
        pre.close()


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "plain"])
def test_unetr_predictor_matches_the_jax_server(adaptive):
    """The class maps `int32 [B, *tile]` equal the JAX server's, which serving
    UNETR was refused before this slice."""
    cfg = _unetr_cfg(adaptive)
    jrun, jpre, _, (_, jholder, _) = jax_build_predictor(cfg, max_batch=2, seed=3)
    run, pre, mb, (model, _, _) = build_predictor(cfg, max_batch=2, seed=3, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jholder["params"]))
    batch = _adaptive_batch(pre, _volumes_f32(2))
    want = np.asarray(jrun(_adaptive_batch(jpre, _volumes_f32(2))))
    got = run(batch)
    assert got.dtype == torch.int32 and got.shape == want.shape == (2, 16, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1


def test_unetr_server_answers_class_maps_through_its_pool():
    """Over HTTP with a preprocessing pool of 2: each answer is the int32 class map
    of the in-process forward of the sample's preprocessed request."""
    from ucf_vit_tpu_torch.tasks import unetr_inputs

    cfg = _unetr_cfg()
    server = make_server(cfg, host="127.0.0.1", port=0, max_batch=2, max_wait_ms=20.0,
                         seed=5, device="cpu", preprocess_workers=2)
    samples = _volumes_f32(2, seed=12)
    try:
        base = _serving(server)
        answers = [_predict(base, s) for s in samples]
    finally:
        _stop(server)
    model = init_eval_model(cfg, seed=5, device="cpu")
    pre = make_preprocessor(cfg)
    for s, got in zip(samples, answers):
        b = {k: torch.from_numpy(v[None]) for k, v in pre(s).items()}
        x, ps, x_seq = unetr_inputs(cfg, b)
        with torch.inference_mode():
            want = model(x, seq_ps=ps, x_seq=x_seq).argmax(1)[0].numpy()
        assert got.dtype == np.int32 and got.shape == (16, 16, 16)
        np.testing.assert_array_equal(got, want)


def _unetr_checkpoint(tmp_path):
    cfg = _unetr_cfg(checkpoint_path=str(tmp_path / "ck"))
    train(cfg, synthetic=True, max_steps=2, device="cpu")
    path = tmp_path / "unetr.yaml"
    path.write_text(yaml.safe_dump(cfg.raw))
    return cfg, str(path), str(tmp_path / "ck" / "multi_last_even.ckpt")


def test_evaluate_unetr_dice_matches_jax_on_one_checkpoint(tmp_path, capsys):
    """The Dice of each sample and the mean: the port's `evaluate` on its
    checkpoint against the JAX `evaluate` on it after `to-jax`, the same 3
    synthetic batches, within DICE_TOL."""
    cfg, cfg_path, ck = _unetr_checkpoint(tmp_path)
    assert convert_main(["to-jax", ck, cfg_path, str(tmp_path / "jax"), "--filename",
                         "conv"]) == 0
    jraw = json.loads(json.dumps(cfg.raw))
    jraw["trainer"]["checkpoint_filename_for_loading"] = "conv_latest"
    want = jax_evaluate(JConfig(raw=jraw, task="unetr"), str(tmp_path / "jax"), None, True, 3)
    wlines = re.findall(r"sample \d+: dice ([0-9.]+)", capsys.readouterr().out)
    got = evaluate(cfg, ck, None, True, 3, device="cpu")
    glines = re.findall(r"sample \d+: dice ([0-9.]+)", capsys.readouterr().out)
    assert len(glines) == len(wlines) == 3 and glines == wlines
    assert abs(got - want) <= DICE_TOL and 0.0 < got < 1.0


def test_volume_predictor_matches_jax():
    """A 24^3 volume in 16^3 windows at overlap 0.5 (8 windows, the last ones flush
    with the far edge; sw_batch 3 pads the last chunk): the class map equal to the
    JAX `predict_volume`'s on the same weights; a volume shorter than the tile is
    reflect-padded and cropped back."""
    cfg = _unetr_cfg()
    _, _, _, (_, jholder, _) = jax_build_predictor(cfg, max_batch=3, seed=3)
    params = jax.tree.map(np.asarray, jholder["params"])
    vol = _volumes_f32(1, side=24, seed=13)[0]
    want = np.asarray(jax_predict_volume(cfg, vol, params=params, sw_batch=3))
    model = load_jax_params(init_eval_model(cfg, device="cpu"), params)
    predictor = VolumePredictor(cfg, model=model, sw_batch=3)
    got = predictor(vol, overlap=0.5)
    assert got.dtype == np.int32 and got.shape == (24, 24, 24)
    np.testing.assert_array_equal(got, want)
    assert predictor.last_stats["windows"] == 8 and len(np.unique(got)) > 1
    small = vol[:, :12]
    np.testing.assert_array_equal(
        predictor(small), np.asarray(jax_predict_volume(cfg, small, params=params, sw_batch=3)))


def test_inference_cli_evaluates_unetr_with_pngs(tmp_path, capsys):
    """`evaluate` of a UNETR, refused before this slice: the CLI's mean Dice equals
    `evaluate`'s, one PNG a sample."""
    cfg, cfg_path, ck = _unetr_checkpoint(tmp_path)
    dice = inference_main([cfg_path, "--checkpoint", ck, "--synthetic", "--num-samples", "2",
                           "--png-dir", str(tmp_path / "png"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mean dice over 2 samples" in out and "loaded checkpoint from epoch 0" in out
    assert dice == evaluate(cfg, ck, None, True, 2, device="cpu")
    assert sorted(os.listdir(tmp_path / "png")) == ["sample_0.png", "sample_1.png"]


def test_inference_cli_warm_starts_the_encoder_from_an_mae(tmp_path, capsys):
    """`--mae-checkpoint`, refused before this slice: the encoder's entries come
    from the MAE checkpoint (the position table resampled), and the Dice equals
    that of the model so built by hand."""
    from ucf_vit_tpu_torch.checkpoint import transfer_mae_encoder
    from ucf_vit_tpu_torch.models import MAE

    cfg, cfg_path, _ = _unetr_checkpoint(tmp_path)
    mae = MAE(img_size=(16, 16, 16), patch_size=2, in_chans=1, twoD=False, embed_dim=24,
              depth=4, num_heads=2, decoder_embed_dim=18, decoder_depth=1,
              decoder_num_heads=3).init_weights(torch.Generator().manual_seed(7))
    os.makedirs(tmp_path / "mae")
    torch.save({"epoch": 1, "model_state_dict": mae.state_dict(), "loss_list": [],
                "head_meta": [2, 3]}, str(tmp_path / "mae" / "multi_last_odd.ckpt"))
    dice = inference_main([cfg_path, "--mae-checkpoint", str(tmp_path / "mae"), "--synthetic",
                           "--num-samples", "2", "--device", "cpu"])
    assert "initialized encoder from MAE checkpoint" in capsys.readouterr().out
    model = init_eval_model(cfg, device="cpu")
    sd = transfer_mae_encoder(mae.state_dict(), model.state_dict(), 64)
    assert torch.equal(sd["blocks.1.attn.qkv.weight"], mae.state_dict()["blocks.1.attn.qkv.weight"])
    model.load_state_dict(sd)
    from ucf_vit_tpu_torch.tasks import unetr_inputs
    from ucf_vit_tpu_torch.train import synthetic_batches as port_synthetic
    from ucf_vit_tpu_torch.utils.metrics import dice_metric

    dices = []
    for _, b in zip(range(2), port_synthetic(cfg, 1)):
        t = {k: torch.from_numpy(v) for k, v in b.items() if isinstance(v, np.ndarray)}
        x, ps, x_seq = unetr_inputs(cfg, t)
        with torch.inference_mode():
            dices.append(float(dice_metric(model(x, seq_ps=ps, x_seq=x_seq).argmax(1),
                                           t["label"][:, 0], 4)))
    assert abs(dice - float(np.mean(dices))) <= DICE_TOL


def test_inference_cli_stitches_a_volume(tmp_path, capsys):
    """`--volume`, refused before this slice: the class map the CLI saves equals
    `predict_volume`'s, and the CLI names the windows and the host's share."""
    cfg, cfg_path, ck = _unetr_checkpoint(tmp_path)
    np.save(tmp_path / "vol.npy", _volumes_f32(1, side=20, seed=14)[0])
    pred = inference_main([cfg_path, "--checkpoint", ck, "--volume", str(tmp_path / "vol.npy"),
                           "--volume-out", str(tmp_path / "pred.npy"), "--sw-batch", "2",
                           "--device", "cpu"])
    saved = np.load(tmp_path / "pred.npy")
    np.testing.assert_array_equal(saved, pred)
    np.testing.assert_array_equal(
        saved, predict_volume(cfg, np.load(tmp_path / "vol.npy"), ck, sw_batch=2, device="cpu"))
    assert saved.shape == (20, 20, 20) and saved.dtype == np.int32
    assert "8 windows" in capsys.readouterr().out


# ---------------------------------------------------------------- SAP
#
# basic_ct/sap shrunk (tile 16^3 at patch 2, 64 octree tokens in an 8^3 pseudo-image,
# two blocks of 24 wide, batch 2): the served class maps `int32 [B, 8^3]` against the
# JAX server's, equal; an HTTP round trip through a preprocessing pool against the
# in-process forward; `evaluate`'s Dice on a `to-jax` checkpoint against the JAX one;
# `_deserialize_pred` against the JAX function on the same trees; the CLI from labelled
# files with PNGs; `--volume` refused as the JAX assertion refuses it.

import jax.numpy as jnp

from ucf_vit_tpu.data.transform import Patchify as JPatchify
from ucf_vit_tpu.data.transform import Patchify3D as JPatchify3D
from ucf_vit_tpu.inference import _deserialize_pred as jax_deserialize_pred
from ucf_vit_tpu_torch.data.transform import Patchify, Patchify3D
from ucf_vit_tpu_torch.inference import _deserialize_pred
from ucf_vit_tpu_torch.tasks import sap_inputs


def _sap_cfg(name="sap", **trainer):
    with open(os.path.join(REPO, "configs", "basic_ct", name, "base_config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["net"]["init_args"].update(tile_size=[16, 16, 16], patch_size=2,
                                            fixed_length=64, embed_dim=24, depth=2,
                                            num_heads=2)
    raw["model"].update(lr=1e-3, warmup_steps=2, max_steps=20, weight_decay=1e-5,
                        warmup_start_lr=1e-8, eta_min=1e-8)
    raw["trainer"].update(attn_impl="EINSUM", max_epochs=1, **trainer)
    raw["parallelism"] = {}
    raw["data"]["batch_size"] = 2
    return Config(raw=raw, task="sap")


def test_sap_predictor_matches_the_jax_server():
    """The class maps `int32 [B, (sqrt_len * p)^3]` equal the JAX server's, which
    serving SAP was refused before this slice; only `seq`, `seq_size` and `seq_pos`
    are consumed, and the batch defaults to the config's."""
    cfg = _sap_cfg()
    jrun, jpre, _, (_, jholder, _) = jax_build_predictor(cfg, max_batch=2, seed=3)
    run, pre, mb, (model, _, _) = build_predictor(cfg, seed=3, device="cpu")
    assert mb == cfg.batch_size == 2
    load_jax_params(model, jax.tree.map(np.asarray, jholder["params"]))
    batch = _adaptive_batch(pre, _volumes_f32(2))
    assert sorted(batch) == ["seq", "seq_pos", "seq_size"]
    want = np.asarray(jrun(_adaptive_batch(jpre, _volumes_f32(2))))
    got = run(batch)
    assert got.dtype == torch.int32 and got.shape == want.shape == (2, 8, 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1


def test_sap_bf16_predictor_serves_its_config_batch():
    """sap_bf16 serves batches of its config's 16 by default: the class maps are
    the argmax of the in-process forward's f32 logits (the bf16 encoder, the f32
    neck and head) of the same batch."""
    cfg = _sap_cfg("sap_bf16")
    cfg.raw["data"]["batch_size"] = 16
    run, pre, mb, (model, _, _) = build_predictor(cfg, seed=3, device="cpu")
    assert mb == 16 and model.dtype == torch.bfloat16
    batch = _adaptive_batch(pre, _volumes_f32(16, seed=21))
    got = run(batch)
    assert got.dtype == torch.int32 and got.shape == (16, 8, 8, 8)
    with torch.inference_mode():
        logits = model(*sap_inputs(cfg, {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert logits.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), logits.argmax(1).numpy())


def test_sap_server_answers_class_maps_through_its_pool():
    """Over HTTP with a preprocessing pool of 2: each answer is the int32 class map of
    the in-process forward of the sample's preprocessed request; `/v1/reload` swaps
    in a checkpoint of the port's trainer."""
    cfg = _sap_cfg()
    server = make_server(cfg, host="127.0.0.1", port=0, max_wait_ms=20.0, seed=5,
                         device="cpu", preprocess_workers=2)
    samples = _volumes_f32(3, seed=12)
    try:
        base = _serving(server)
        answers = [_predict(base, s) for s in samples]
    finally:
        _stop(server)
    model = init_eval_model(cfg, seed=5, device="cpu")
    pre = make_preprocessor(cfg)
    for s, got in zip(samples, answers):
        b = {k: torch.from_numpy(v[None]) for k, v in pre(s).items()}
        with torch.inference_mode():
            want = model(*sap_inputs(cfg, b)).argmax(1)[0].numpy()
        assert got.dtype == np.int32 and got.shape == (8, 8, 8)
        np.testing.assert_array_equal(got, want)


def _sap_checkpoint(tmp_path, **data):
    cfg = _sap_cfg(checkpoint_path=str(tmp_path / "ck"))
    cfg.raw["data"].update(data)
    train(cfg, synthetic=not data, max_steps=2, device="cpu")
    path = tmp_path / "sap.yaml"
    path.write_text(yaml.safe_dump(cfg.raw))
    return cfg, str(path), str(tmp_path / "ck" / "multi_last_even.ckpt")


def test_evaluate_sap_dice_matches_jax_on_one_checkpoint(tmp_path, capsys):
    """The Dice of each batch (argmax against the reassembled serialized labels, in
    the pseudo-image space) and the mean: the port's `evaluate` on its checkpoint
    against the JAX `evaluate` on it after `to-jax`, the same 3 synthetic batches,
    within DICE_TOL."""
    cfg, cfg_path, ck = _sap_checkpoint(tmp_path)
    assert convert_main(["to-jax", ck, cfg_path, str(tmp_path / "jax"), "--filename",
                         "conv"]) == 0
    jraw = json.loads(json.dumps(cfg.raw))
    jraw["trainer"]["checkpoint_filename_for_loading"] = "conv_latest"
    want = jax_evaluate(JConfig(raw=jraw, task="sap"), str(tmp_path / "jax"), None, True, 3)
    wlines = re.findall(r"sample \d+: dice ([0-9.]+)", capsys.readouterr().out)
    got = evaluate(cfg, ck, None, True, 3, device="cpu")
    glines = re.findall(r"sample \d+: dice ([0-9.]+)", capsys.readouterr().out)
    assert len(glines) == len(wlines) == 3 and glines == wlines
    assert abs(got - want) <= DICE_TOL and 0.0 < got < 1.0


@pytest.mark.parametrize("nd", [3, 2], ids=["octree", "quadtree"])
def test_deserialize_pred_matches_jax(nd):
    """A pseudo-image class map written back to image space through the sample's
    tree, array for array with the JAX function on the same tile's tree (a list of
    trees takes the first)."""
    rng = np.random.default_rng(nd)
    if nd == 3:
        tile = rng.random((16, 16, 16, 1)).astype(np.float32)
        tile[4:12, 4:12, :8] += 0.6
        ours, ref = (cls(fixed_length=64, patch_size=2, num_channels=1,
                         rng=np.random.default_rng(2)) for cls in (Patchify3D, JPatchify3D))
        side = 8
    else:
        tile = rng.random((32, 32, 1)).astype(np.float32)
        tile[8:24, 4:20] += 0.6
        ours, ref = (cls(fixed_length=16, patch_size=2, num_channels=1, dataset="basic_ct",
                         rng=np.random.default_rng(2)) for cls in (Patchify, JPatchify))
        side = 8
    tree, jtree = ours(tile)[3], ref(tile)[3]
    pred = rng.integers(0, 4, size=(side,) * nd)
    got = _deserialize_pred(torch.from_numpy(pred), [tree], 4, 2, nd == 2)
    want = jax_deserialize_pred(jnp.asarray(pred), [jtree], 4, 2, nd == 2)
    assert got.dtype == want.dtype == np.int64 and got.shape == tile.shape[:-1]
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def _labelled_nifti(root, n, side, seed=0):
    """`n` int16 volumes of `side`^3 under <root>/imagesTr and label volumes 1-4 under
    <root>/labelsTr (thresholds of the volume, so that the labels have edges)."""
    from ucf_vit_tpu_torch.data import nifti

    rng = np.random.default_rng(seed)
    for d in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(root, d))
    for i in range(n):
        vol = _volumes_f32(1, side=side, seed=seed + i)[0, 0]
        nifti.save(os.path.join(root, "imagesTr", f"image{i}.nii"),
                   (vol * 3000 + 40 * rng.normal(size=vol.shape)).astype(np.int16))
        lab = 1 + np.digitize(vol, np.quantile(vol, [0.4, 0.7, 0.9]))
        nifti.save(os.path.join(root, "labelsTr", f"label{i}.nii"), lab.astype(np.int16))
    return str(root)


def test_inference_cli_evaluates_sap_from_files_with_pngs(tmp_path, capsys):
    """From labelled NIfTI volumes, batch size 1 (the default): the CLI's mean Dice
    equals `evaluate`'s; with `--png-dir` the loader keeps the trees and each PNG
    holds the prediction written back to image space beside the image-space label."""
    pytest.importorskip("matplotlib")
    root = _labelled_nifti(tmp_path / "ct", 2, 32)
    cfg, cfg_path, ck = _sap_checkpoint(tmp_path, dict_root_dirs={"ct1": root})
    seen = []
    real = port_inference._dump_png
    port_inference._dump_png = lambda d, i, p, l: (seen.append((p, l)), real(d, i, p, l))
    try:
        dice = inference_main([cfg_path, "--checkpoint", ck, "--num-samples", "2",
                               "--png-dir", str(tmp_path / "png"), "--device", "cpu"])
    finally:
        port_inference._dump_png = real
    out = capsys.readouterr().out
    assert "mean dice over 2 samples" in out and "loaded checkpoint from epoch 0" in out
    assert dice == evaluate(cfg, ck, None, False, 2, device="cpu")
    assert sorted(os.listdir(tmp_path / "png")) == ["sample_0.png", "sample_1.png"]
    for pred, label in seen:  # image space: the 16^3 tile, not the 8^3 pseudo-image
        assert pred.shape == label.shape == (16, 16, 16) and pred.dtype == np.int64


def test_volume_stitching_refuses_sap(tmp_path):
    """`--volume` takes a UNETR's image-space logits; on a SAP config it raises the
    JAX assertion."""
    cfg = _sap_cfg()
    with pytest.raises(AssertionError, match="SAP predicts in the sqrt-len pseudo-image"):
        VolumePredictor(cfg, device="cpu")
    path = tmp_path / "sap.yaml"
    path.write_text(yaml.safe_dump(cfg.raw))
    np.save(tmp_path / "vol.npy", _volumes_f32(1, side=20)[0])
    with pytest.raises(AssertionError, match="use evaluate"):
        inference_main([str(path), "--volume", str(tmp_path / "vol.npy"), "--device", "cpu"])
