"""The port's serving path on the CPU: the predictor against the JAX
package's on the same weights, the micro-batcher's coalesce/pad/pipeline
semantics (as tests/test_serve.py pins them for the JAX server), an HTTP
round trip against the direct forward, a diffusion deployment's
`/v1/generate` against the direct DDPM chain, and the import guard."""

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
    sps, imgs = generate_diffusion(cfg, num_samples=2, device="cpu", seed=1)
    assert sps > 0 and imgs.shape == (2, 3, 16, 16) and np.all(np.isfinite(imgs))
    np.testing.assert_array_equal(generate_diffusion(cfg, num_samples=2, device="cpu",
                                                     seed=1)[1], imgs)
    cfg.raw["load_balancing"] = {"batches_per_rank_epoch": {"d": 2}}
    assert len(train(cfg, synthetic=True, device="cpu")["loss_list"]) == 1
    d = str(tmp_path / "ck")
    _, trained = generate_diffusion(cfg, d, num_samples=2, device="cpu", seed=1)
    _, ema = generate_diffusion(cfg, d, num_samples=2, device="cpu", seed=1, use_ema=True)
    assert not np.array_equal(trained, imgs) and not np.array_equal(ema, trained)
    model = init_eval_model(cfg, device="cpu")
    load_weights(model, cfg, d)
    np.testing.assert_array_equal(diffusion_sampler(cfg, model, 2)(1).numpy(), trained)
    with pytest.raises(TypeError, match="DiffusionVIT"):
        diffusion_sampler(_cfg(), init_eval_model(_cfg(), device="cpu"), 2)


@pytest.mark.parametrize("task,item", [("mae", "item 5: MAE predict"),
                                       ("unetr", "item 7: UNETR"), ("sap", "item 8: SAP")])
def test_predictor_refuses_the_tasks_still_to_port(task, item):
    cfg = _cfg()
    with pytest.raises(NotImplementedError, match=f"modules to port, {item}"):
        build_predictor(Config(raw=cfg.raw, task=task), device="cpu")


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
