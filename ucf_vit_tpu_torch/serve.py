"""Batched online inference serving (port of `ucf_vit_tpu/serve.py`).

    python -m ucf_vit_tpu_torch.serve <config.yaml> --device cuda
    torchrun --nproc_per_node N -m ucf_vit_tpu_torch.serve <config.yaml>

- **Fixed batch.** The micro-batcher pads every departing batch to
  ``max_batch`` rows, so every forward has one shape.
- **Dynamic micro-batching.** Requests arriving within ``max_wait_ms`` of
  each other share one forward; a lone request departs after the window.
- **One device thread.** All forward passes run on the batcher's worker
  thread under ``torch.inference_mode()``; HTTP handler threads only
  decode, preprocess and wait.
- **stdlib front end.** ``ThreadingHTTPServer`` with raw ``.npy`` bodies:
  ``POST /v1/predict``, ``GET /healthz``, ``GET /v1/stats`` (with the
  served checkpoint's epoch), and ``POST /v1/reload {"checkpoint": DIR,
  "ema": bool}``, which swaps in a checkpoint's weights between batches
  (``ema`` defaults to the server's ``--ema``).
- **Weights.** Seeded (``--seed``), or a checkpoint of the port's trainer
  (``--checkpoint``: a checkpoint file, or a directory whose slot
  ``trainer.checkpoint_filename_for_loading`` names), or that checkpoint's
  EMA weights (``--ema``); a file that the JAX package's ``convert_checkpoint
  to-torch`` wrote serves too.
- **MAE.** An MAE deployment's ``/v1/predict`` answers the reconstruction
  ``[C, *tile]`` of every token, unpatchified, under a mask that the
  server's ``--seed`` fixes (the JAX server's MAE branch,
  ``ucf_vit_tpu/serve.py:277-296``); an adaptive one its predicted tokens
  ``[L, p^nd * C]``.
- **UNETR.** A segmentation deployment's ``/v1/predict`` answers the int32
  class map ``[*tile]`` of a ``[C, *tile]`` volume: the argmax of the logits
  (the JAX server's UNETR branch, ``ucf_vit_tpu/serve.py:255-267``).
- **SAP.** A SAP deployment answers the int32 class map ``[(sqrt_len *
  p)^nd]`` in the sqrt-len pseudo-image space its logits live in: the argmax
  of the logits of the reassembled sequence (``ucf_vit_tpu/serve.py:268-276``).
- **Adaptive patching.** A request is the raw ``[C, *tile]`` sample; the
  server patchifies it as training does (``make_preprocessor``, the same
  tree for the same request; the octree for a volume), in the handler's
  thread or in a spawn pool of ``--preprocess-workers`` processes, and ships
  only ``seq``, ``seq_size`` and ``seq_pos`` to the device (and ``x``, which
  UNETR's skips read).
- **Variables.** A model with ``use_varemb`` takes the ``var_ids`` of the
  example batch's ``variables`` (``ucf_vit_tpu/serve.py:184-188``).
- **Diffusion.** A DiffusionVIT deployment answers ``POST /v1/generate
  {"seed": s, "num": n}`` with ``[n, C, *tile]`` f32 images as ``.npy``
  (``n`` at most ``--num-generate``): each answer runs the whole DDPM reverse
  chain at a batch of ``--num-generate`` on the device, one chain at a time,
  the same images for the same seed. ``/v1/predict`` and ``/v1/reload``
  answer 400 there, as in the JAX server.

It serves classification, MAE, UNETR and SAP, adaptive or not, and
diffusion.

- **Sharded.** Launched by torchrun or srun with the processes the config's
  ``parallelism:`` asks for, the model serves on its mesh
  (``parallel.mesh.eval_mesh``; ``ucf_vit_tpu/serve.py:189-210, 316-376,
  646-667``): the weights by ``shard_model``, each batch split over the data
  ranks (``max_batch`` must divide over them) and the result gathered, the
  reverse chain split by rows; under sequence parallelism the sp ranks of a
  data rank run its rows together, the blocks split over their tokens. Rank
  0 alone binds the port and runs the
  micro-batcher; the other ranks wait in ``serve_follower`` and run each
  operation rank 0 broadcasts to them (``Replicas``: predict, generate,
  reload, stop). SIGTERM (or Ctrl-C) to rank 0 stops the server and sends
  the stop, and every rank returns; an error on any rank is raised there.
  One process serves the whole model, whatever the config asks for.
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.inference import (
    Device,
    checkpoint_weights,
    diffusion_sampler,
    init_eval_model,
    load_weights,
    mask_noise,
    resolve_device,
)
from ucf_vit_tpu_torch.ops.patchify import unpatchify
from ucf_vit_tpu_torch.parallel.mesh import (
    Mesh,
    eval_mesh,
    gather_data,
    is_main,
    launched,
    mesh_context,
    shard_batch,
)
from ucf_vit_tpu_torch.tasks import model_inputs, sap_inputs, unetr_inputs, var_ids_of


# ---------------------------------------------------------------------------
# preprocessing: one raw sample -> the model's batch-dict layout
# ---------------------------------------------------------------------------


def make_preprocessor(cfg: Config, workers: int = 0
                      ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
    """Returns ``pre(sample) -> {key: array}`` (no batch dim) for a raw
    ``[C, *tile]`` sample. A non-adaptive config takes it as the model's
    input ``x``. An adaptive config runs the training pipeline's patchify
    (``ProcessChannels._make_sample``), so the served token layout is
    training's, and keeps ``seq``, ``seq_size`` and ``seq_pos``
    (`ucf_vit_tpu/serve.py:59-153`), and for UNETR the tile ``x`` too. Its
    draws come from the per-sample
    generator at the fixed index 0 of the seed ``data.seed`` (default 0), so
    identical requests give identical trees. ``workers > 0`` patchifies in a
    spawn pool of that many processes (the same bytes: the fixed index makes
    the workers interchangeable); ``pre.close()`` shuts it down (a no-op
    without a pool)."""
    nd = 2 if cfg.twoD else 3
    expect = (cfg.max_channels,) + tuple(cfg.tile_size[:nd])

    def check(arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr, dtype=np.float32)
        if arr.shape != expect:
            raise ValueError(f"expected input shape {expect} [C, *tile], got {arr.shape}")
        return arr

    if not cfg.adaptive_patching:
        def pre(arr: np.ndarray) -> Dict[str, np.ndarray]:
            return {"x": check(arr)}

        pre.close = lambda: None
        return pre

    from ucf_vit_tpu_torch.data.pipeline import (
        ProcessChannels,
        _pool_make_sample,
        make_pool,
    )

    seed = int(cfg.data.get("seed", 0))
    pc = ProcessChannels(
        source=None, num_channels=cfg.max_channels, single_channel=cfg.single_channel,
        return_label=False, dataset=cfg.dataset, adaptive_patching=True,
        separate_channels=bool(cfg.data.get("separate_channels", False)),
        patch_size=cfg.patch_size, fixed_length=cfg.fixed_length, twoD=cfg.twoD,
        num_classes=cfg.data.get("num_classes"), aug_seed=seed)
    variables = tuple(cfg.default_vars[: cfg.max_channels] or ("v",))
    keep = consumed_keys(cfg)

    if workers <= 0:
        def pre(arr: np.ndarray) -> Dict[str, np.ndarray]:
            sample = pc._make_sample(check(arr), variables, None, 0)
            return {k: sample[k] for k in keep}

        pre.close = lambda: None
        return pre

    pool = make_pool(pc._spec(), int(workers))

    def pre_pooled(arr: np.ndarray) -> Dict[str, np.ndarray]:
        sample = pool.submit(_pool_make_sample, (check(arr), variables, None, 0)).result()
        return {k: sample[k] for k in keep}

    pre_pooled.close = lambda: pool.shutdown(wait=True, cancel_futures=True)
    return pre_pooled


def consumed_keys(cfg: Config) -> tuple:
    """The keys of a preprocessed sample that the task's forward reads (and
    that alone go to the device, `ucf_vit_tpu/serve.py:306-316`)."""
    if not cfg.adaptive_patching:
        return ("x",)
    return (("x",) if cfg.task == "unetr" else ()) + ("seq", "seq_size", "seq_pos")


# ---------------------------------------------------------------------------
# the ranks of a sharded server
# ---------------------------------------------------------------------------


class Replicas:
    """The operations that every rank of a sharded server runs together.

    Rank 0 calls ``run(op, arrays, **args)``: it broadcasts a header (the
    operation, its arguments and its arrays' shapes), then the f32 arrays on
    the model's device (NCCL carries no CPU tensors), then runs
    ``ops[op](arrays, **args)`` itself. Every other rank waits in ``follow``
    and runs the same operation on what it received, so that all issue the
    same forwards, all-reduces and gathers in the same order. One lock keeps
    rank 0's threads (the batcher's, a reload's, a generate's) from
    interleaving their broadcasts. ``stop`` ends the others' ``follow``.
    Without a mesh ``run`` only runs the operation."""

    def __init__(self, mesh: Optional[Mesh], device: torch.device):
        self.mesh, self.device = mesh, device
        self.ops: Dict[str, Callable] = {}
        self._lock = threading.Lock()
        self._stopped = False

    def run(self, op: str, arrays: Optional[Dict[str, torch.Tensor]] = None, **args):
        arrays = arrays or {}
        with self._lock:
            if self.mesh is not None:
                if self._stopped:
                    raise RuntimeError("the other ranks of this server have stopped")
                header = [(op, args, {k: tuple(v.shape) for k, v in arrays.items()})]
                dist.broadcast_object_list(header, src=0, device=self.device)
                for k in sorted(arrays):
                    dist.broadcast(arrays[k], src=0)
            return self.ops[op](arrays, **args)

    def follow(self) -> None:
        """Every rank but 0: run what rank 0 broadcasts until its stop. An
        operation that raises ends the loop with its exception."""
        while True:
            header = [None]
            dist.broadcast_object_list(header, src=0, device=self.device)
            op, args, shapes = header[0]
            if op == "stop":
                return
            arrays = {}
            for k in sorted(shapes):
                arrays[k] = torch.empty(shapes[k], dtype=torch.float32, device=self.device)
                dist.broadcast(arrays[k], src=0)
            self.ops[op](arrays, **args)

    def stop(self) -> None:
        """Rank 0: end the other ranks' `follow` (once; nothing without a mesh)."""
        with self._lock:
            if self.mesh is None or self._stopped:
                return
            self._stopped = True
            dist.broadcast_object_list([("stop", {}, {})], src=0, device=self.device)


# ---------------------------------------------------------------------------
# the fixed-shape forward
# ---------------------------------------------------------------------------


def build_predictor(
    cfg: Config,
    checkpoint_dir: Optional[str] = None,
    use_ema: bool = False,
    max_batch: Optional[int] = None,
    seed: int = 0,
    device: Device = None,
    preprocess_workers: int = 0,
):
    """Build ``(run_batch, preprocess, max_batch, (model, holder, load_weights))``.

    ``run_batch({"x": [max_batch, C, *tile]})`` (adaptive: ``seq``,
    ``seq_size``, ``seq_pos``, the keys the preprocessor keeps, and only
    those go to the device) returns, as a tensor on ``device`` and without
    waiting for the device, the logits ``[max_batch, num_classes]`` of a
    classifier, a UNETR's int32 class map ``[max_batch, *tile]``, a SAP's
    ``[max_batch, (sqrt_len * p)^nd]``, or an
    MAE's reconstruction ``[max_batch, C, *tile]`` (an
    adaptive MAE: its predicted tokens ``[max_batch, L, p^nd * C]``, token
    space being its native output); f32 under ``trainer.data_type: bfloat16`` too,
    since a classifier's final norm and head and MAE's decoder compute in
    f32. ``device`` defaults to CUDA and raises when CUDA is absent; tests
    pass ``device="cpu"``.

    An MAE's mask is fixed by ``seed``: every row of a batch takes the noise
    row that ``inference.reconstruct`` draws for a lone sample. Noise drawn
    per row would tie a request's mask to its place in the batch, and a
    request padded to ``max_batch`` (or coalesced with others) would get
    another mask than it gets alone; with one row for all, a request's
    answer does not depend on its batch.

    ``load_weights(ckpt_dir, ema=False) -> epoch`` loads a checkpoint into a
    copy of the served model and swaps the copy in: the batcher's thread,
    the only one that runs forwards, picks it up at its next batch, and a
    batch in flight finishes on the old weights.

    On the config's mesh (``eval_mesh``; every rank builds the predictor):
    the model is sharded, ``run_batch`` on rank 0 hands the batch to the
    other ranks (``run_batch.replicas``, a ``Replicas``; they wait in its
    ``follow``), each rank runs its data rank's rows and rank 0 returns the
    whole batch's result; ``load_weights`` loads on every rank, in place,
    between batches. ``max_batch`` must divide over the data ranks."""
    dev = resolve_device(device)
    if cfg.task == "diffusion":
        raise ValueError("a diffusion deployment serves /v1/generate (build_generator), "
                         "not a predictor")
    if cfg.task not in ("classification", "mae", "unetr", "sap"):
        raise ValueError(f"serving supports classification/unetr/sap/mae predict and "
                         f"diffusion generate; got task={cfg.task!r}")
    max_batch = int(max_batch or cfg.batch_size)
    mesh = eval_mesh(cfg, dev)
    if mesh is not None and max_batch % mesh.data_size:
        # the JAX assertion (`ucf_vit_tpu/serve.py:200-209`), raised so that it holds
        # under -O
        raise AssertionError(
            f"--max-batch {max_batch} must be divisible by the mesh's data-parallel extent "
            f"{mesh.data_size} (ddp x ep x fsdp) for sharded serving")
    model = init_eval_model(cfg, seed=seed, device=dev, mesh=mesh)
    holder = {"model": model, "epoch": None}
    replicas = Replicas(mesh, dev)

    def swap_weights(ckpt_dir: str, ema: bool = False) -> int:
        if mesh is None:  # loaded beside the batches, swapped in between two
            new = copy.deepcopy(holder["model"])
            epoch = load_weights(new, cfg, ckpt_dir, use_ema=ema)
            holder["model"], holder["epoch"] = new, epoch
            return epoch
        checkpoint_weights(holder["model"], cfg, ckpt_dir, use_ema=ema)  # fails on rank 0 alone
        return replicas.run("reload", ckpt_dir=str(ckpt_dir), ema=bool(ema))

    def reload(_, ckpt_dir: str, ema: bool) -> int:
        # every rank, in place: the lock keeps every batch out meanwhile
        holder["epoch"] = load_weights(holder["model"], cfg, ckpt_dir, use_ema=ema)
        return holder["epoch"]

    if checkpoint_dir:
        holder["epoch"] = load_weights(model, cfg, checkpoint_dir, use_ema=use_ema)
        if is_main(mesh):
            print(f"serving checkpoint from epoch {holder['epoch']}", flush=True)

    noise = mask_noise(model, 1, seed, dev) if cfg.task == "mae" else None

    consumed = consumed_keys(cfg)
    var_ids = var_ids_of(cfg, model)

    def forward(b: Dict[str, torch.Tensor]) -> torch.Tensor:
        if cfg.task == "unetr":
            x, ps, x_seq = unetr_inputs(cfg, b)
            logits = holder["model"](x, seq_ps=ps, x_seq=x_seq, var_ids=var_ids)
            return logits.argmax(dim=1).to(torch.int32)
        if cfg.task == "sap":
            img, ps = sap_inputs(cfg, b)
            logits = holder["model"](img, seq_ps=ps, var_ids=var_ids)
            return logits.argmax(dim=1).to(torch.int32)
        x, ps = model_inputs(cfg, b)
        if noise is None:
            return holder["model"](x, seq_ps=ps, var_ids=var_ids)
        pred, _ = holder["model"](x, mask_noise=noise.expand(x.shape[0], -1), seq_ps=ps,
                                  var_ids=var_ids)
        if cfg.adaptive_patching:
            return pred
        return unpatchify(pred, tuple(x.shape), model.patch_size, model.twoD)

    def predict(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode(), mesh_context(mesh):
            return gather_data(forward(shard_batch(batch, mesh)), mesh)

    replicas.ops.update(predict=predict, reload=reload)

    def run_batch(batch: Dict[str, np.ndarray]) -> torch.Tensor:
        b = {k: torch.from_numpy(np.ascontiguousarray(batch[k], dtype=np.float32)).to(
            dev, non_blocking=True) for k in consumed}
        return replicas.run("predict", b)

    run_batch.replicas = replicas
    # the pool starts last: a failure above leaves no processes behind
    preprocess = make_preprocessor(cfg, preprocess_workers)
    return run_batch, preprocess, max_batch, (model, holder, swap_weights)


def build_generator(cfg: Config, model: torch.nn.Module, num_samples: int):
    """``generate(seed) -> np.ndarray [num_samples, C, *tile]``: the DDPM
    reverse chain of a DiffusionVIT at a fixed batch (diffusion serving;
    `inference.diffusion_sampler`), one call at a time, since a chain keeps
    the device busy. ``generate.denoise(x_t, t)`` is one step of it. A
    model on a mesh (``shard_model``) runs the chain split by rows
    (``ucf_vit_tpu/serve.py:341-376``) on every rank: rank 0 calls
    ``generate``, the others wait in ``generate.replicas.follow()``; the
    ``warm`` operation runs one denoising step on every rank."""
    sample = diffusion_sampler(cfg, model, num_samples)
    dev = next(model.parameters()).device
    replicas = Replicas(getattr(model, "mesh", None), dev)

    def warm(_) -> None:
        with torch.inference_mode():
            x = torch.zeros(sample.shape, device=dev)
            sample.denoise(x, torch.zeros(x.shape[0], dtype=torch.long, device=dev)).cpu()

    replicas.ops.update(generate=lambda _, seed: sample(seed).cpu().numpy(), warm=warm)

    def generate(seed: int) -> np.ndarray:
        return replicas.run("generate", seed=int(seed))

    generate.denoise = sample.denoise
    generate.shape = sample.shape
    generate.replicas = replicas
    return generate


def _diffusion_generator(cfg: Config, checkpoint_dir: Optional[str], use_ema: bool, seed: int,
                         device: Device, num_generate: int):
    """A diffusion deployment's `build_generator`, on the config's mesh: the
    seeded weights, or a checkpoint's."""
    dev = resolve_device(device)
    mesh = eval_mesh(cfg, dev)
    model = init_eval_model(cfg, seed=seed, device=dev, mesh=mesh)
    if checkpoint_dir:
        epoch = load_weights(model, cfg, checkpoint_dir, use_ema=use_ema)
        if is_main(mesh):
            print(f"serving checkpoint from epoch {epoch}", flush=True)
    return build_generator(cfg, model, num_generate)


def serve_follower(cfg: Config, checkpoint_dir: Optional[str] = None, use_ema: bool = False,
                   max_batch: Optional[int] = None, seed: int = 0, device: Device = None,
                   num_generate: int = 8) -> None:
    """A rank other than 0 of a sharded server: build what `make_server` builds
    on rank 0 (with the same arguments), then run each operation rank 0
    broadcasts until its stop (`Replicas.follow`). Raises what an operation
    raises."""
    if cfg.task == "diffusion":
        replicas = _diffusion_generator(cfg, checkpoint_dir, use_ema, seed, device,
                                        num_generate).replicas
    else:
        run_batch, _, _, _ = build_predictor(cfg, checkpoint_dir, use_ema=use_ema,
                                             max_batch=max_batch, seed=seed, device=device)
        replicas = run_batch.replicas
    replicas.follow()


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------

_STOP = object()


class MicroBatcher:
    """Coalesce concurrent single-sample requests into fixed-shape batches.

    One worker thread drains a queue: the first request opens a batch window
    of ``max_wait_ms``; anything arriving before the window closes (up to
    ``max_batch``) shares the forward. The batch is padded to exactly
    ``max_batch`` rows by repeating the last sample; padded rows are computed
    and discarded. ``run_batch(batch)`` returns a tensor, which may still be
    being computed; ``.cpu()`` reads it back.

    ``pipeline_depth=1`` keeps one dispatched batch in flight: its result is
    read back one batch later (or at once when the queue is idle, so a lone
    request pays no extra latency), letting batch N+1's upload and launch
    overlap batch N's compute. Default 0 (serialise)."""

    def __init__(self, run_batch, max_batch: int, max_wait_ms: float = 5.0,
                 pipeline_depth: int = 0, on_close: Optional[Callable[[], None]] = None):
        self.run_batch = run_batch
        self.on_close = on_close
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.pipeline_depth = int(pipeline_depth)
        self.queue: Queue = Queue()
        self.stats = {
            "requests": 0, "batches": 0, "errors": 0,
            "batch_fill_sum": 0, "latency_sum_s": 0.0, "latency_max_s": 0.0,
        }
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, sample: Dict[str, np.ndarray],
               timeout: Optional[float] = 120.0) -> np.ndarray:
        t0 = time.perf_counter()
        ev = threading.Event()
        slot: dict = {}
        self.queue.put((sample, ev, slot))
        if not ev.wait(timeout=timeout):
            raise TimeoutError("inference request timed out")
        if "err" in slot:
            raise slot["err"]
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats["requests"] += 1
            self.stats["latency_sum_s"] += dt
            self.stats["latency_max_s"] = max(self.stats["latency_max_s"], dt)
        return slot["out"]

    def close(self):
        self.queue.put(_STOP)
        self._thread.join(timeout=5.0)
        if self.on_close is not None:
            self.on_close()

    def _flush(self, pending):
        """Read back a dispatched batch and wake its waiters. Device-side
        failures surface here (dispatch is asynchronous), scoped to this
        group."""
        out_async, group = pending
        try:
            out = out_async.cpu().numpy()
            # count before waking: a waiter that then reads the stats sees
            # its own batch
            with self._lock:
                self.stats["batches"] += 1
                self.stats["batch_fill_sum"] += len(group)
            for i, (_, ev, slot) in enumerate(group):
                slot["out"] = out[i]
                ev.set()
        except Exception as e:  # surface to every waiter in the group
            with self._lock:
                self.stats["errors"] += 1
            for _, ev, slot in group:
                slot["err"] = e
                ev.set()

    def _loop(self):
        pending = None  # the one in-flight (dispatched, not read back) batch
        while True:
            if pending is not None and self.queue.empty():
                # idle queue: drain the pipeline now so a lone request does
                # not wait for a successor that may never come
                self._flush(pending)
                pending = None
            item = self.queue.get()
            if item is _STOP:
                if pending is not None:
                    self._flush(pending)
                return
            group = [item]
            deadline = time.perf_counter() + self.max_wait
            while len(group) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self.queue.get(timeout=remaining)
                except Empty:
                    break
                if nxt is _STOP:
                    self.queue.put(_STOP)  # re-post for the outer loop
                    break
                group.append(nxt)
            try:
                batch = {}
                for k in group[0][0].keys():
                    rows = [g[0][k] for g in group]
                    rows += [rows[-1]] * (self.max_batch - len(rows))
                    batch[k] = np.stack(rows)
                out_async = self.run_batch(batch)
            except Exception as e:  # host-side or launch failure
                with self._lock:
                    self.stats["errors"] += 1
                for _, ev, slot in group:
                    slot["err"] = e
                    ev.set()
                continue
            if pending is not None:
                self._flush(pending)  # overlaps with the batch just dispatched
            if self.pipeline_depth > 0:
                pending = (out_async, group)
            else:
                self._flush((out_async, group))


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    # set by make_server():
    batcher: Optional[MicroBatcher] = None
    preprocess = None
    generate = None  # generate(seed) -> images, on a diffusion deployment
    reload_weights = None  # load_weights(ckpt_dir, ema) -> epoch
    replicas: Optional[Replicas] = None  # the operations every rank runs (close_server)
    weights_holder: Optional[dict] = None
    serve_ema = False  # the server's --ema setting, the reload's default
    task = ""

    def log_message(self, fmt, *args):  # quiet access log
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: dict):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path == "/healthz":
            self._send_json(200, {"status": "ok", "task": self.task})
        elif self.path == "/v1/stats":
            b = self.batcher
            if b is None:
                self._send_json(200, {"task": self.task, "requests": 0})
                return
            with b._lock:
                s = dict(b.stats)
            s["task"] = self.task
            s["max_batch"] = b.max_batch
            s["checkpoint_epoch"] = self.weights_holder.get("epoch")
            if s["batches"]:
                s["mean_batch_fill"] = s["batch_fill_sum"] / s["batches"]
            if s["requests"]:
                s["latency_mean_s"] = s["latency_sum_s"] / s["requests"]
            self._send_json(200, s)
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        try:
            if self.path == "/v1/predict":
                if self.batcher is None:
                    raise ValueError("this deployment serves /v1/generate (diffusion)")
                arr = np.load(io.BytesIO(body), allow_pickle=False)
                out = self.batcher.submit(self.preprocess(arr))
                self._send(200, _npy_bytes(out), "application/x-npy")
            elif self.path == "/v1/generate":
                if self.generate is None:
                    raise ValueError("generate is only served for diffusion")
                req = json.loads(body or b"{}")
                imgs = self.generate(int(req.get("seed", 0)))
                num = int(req.get("num", imgs.shape[0]))
                self._send(200, _npy_bytes(imgs[:num]), "application/x-npy")
            elif self.path == "/v1/reload":
                if self.reload_weights is None:
                    raise ValueError("reload is not available for this task")
                req = json.loads(body or b"{}")
                if "checkpoint" not in req:
                    raise KeyError("body must be {'checkpoint': <dir>, ...}")
                epoch = self.reload_weights(str(req["checkpoint"]),
                                            bool(req.get("ema", self.serve_ema)))
                self._send_json(200, {"status": "reloaded", "epoch": epoch})
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})
        except (ValueError, KeyError, json.JSONDecodeError, FileNotFoundError) as e:
            self._send_json(400, {"error": str(e)})
        except TimeoutError as e:
            self._send_json(503, {"error": str(e)})


def make_server(
    cfg: Config,
    checkpoint_dir: Optional[str] = None,
    host: str = "0.0.0.0",
    port: int = 8000,
    max_batch: Optional[int] = None,
    max_wait_ms: float = 5.0,
    use_ema: bool = False,
    pipeline_depth: int = 0,
    seed: int = 0,
    device: Device = None,
    num_generate: int = 8,
    preprocess_workers: int = 0,
) -> ThreadingHTTPServer:
    """Build the HTTP server (not yet serving: call ``serve_forever()``).

    One warm-up batch goes through the micro-batcher before the server is
    returned, so it shows in ``/v1/stats`` as a request and a batch, and
    readiness (``/healthz`` reachable) means ready to serve. Close the
    batcher (``server.RequestHandlerClass.batcher.close()``, None on a
    diffusion deployment) after ``server_close()``: that also stops the
    preprocessing pool of an adaptive config (``preprocess_workers``).

    A diffusion config serves ``/v1/generate`` at a batch of
    ``num_generate``: the warm-up is one denoising step at that batch, which
    loads the kernels; the chain itself runs on requests.

    On the config's mesh this is rank 0's part: the other ranks run
    ``serve_follower`` with the same arguments, and ``close_server`` stops
    them."""

    class Handler(_Handler):
        task = cfg.task

    if cfg.task == "diffusion":
        generate = _diffusion_generator(cfg, checkpoint_dir, use_ema, seed, device,
                                        num_generate)
        Handler.generate = staticmethod(generate)
        Handler.replicas = generate.replicas
        try:
            generate.replicas.run("warm")
        except BaseException:
            generate.replicas.stop()
            raise
    else:
        run_batch, preprocess, mb, (_, holder, load_weights_into) = build_predictor(
            cfg, checkpoint_dir, use_ema=use_ema, max_batch=max_batch, seed=seed,
            device=device, preprocess_workers=preprocess_workers,
        )
        Handler.batcher = MicroBatcher(run_batch, mb, max_wait_ms, pipeline_depth=pipeline_depth,
                                       on_close=preprocess.close)
        Handler.replicas = run_batch.replicas
        Handler.weights_holder = holder
        Handler.serve_ema = use_ema
        Handler.reload_weights = staticmethod(load_weights_into)
        Handler.preprocess = staticmethod(preprocess)
        nd = 2 if cfg.twoD else 3
        warm_in = np.random.default_rng(0).random(
            (cfg.max_channels,) + tuple(cfg.tile_size[:nd])
        ).astype(np.float32)
        try:
            Handler.batcher.submit(preprocess(warm_in), timeout=None)
        except BaseException:
            Handler.batcher.close()
            Handler.replicas.stop()
            raise

    class Server(ThreadingHTTPServer):
        # the default backlog (5) drops connections under many concurrent
        # clients; the micro-batcher is the real admission control
        request_queue_size = 128
        daemon_threads = True

    return Server((host, port), Handler)


def close_server(server: ThreadingHTTPServer) -> None:
    """Stop what `make_server` built: the socket, the micro-batcher (and its
    preprocessing pool), and on a mesh the other ranks (the stop operation)."""
    server.server_close()
    handler = server.RequestHandlerClass
    if handler.batcher is not None:
        handler.batcher.close()
    handler.replicas.stop()


def main(argv=None):
    parser = argparse.ArgumentParser(description="ucf_vit_tpu_torch model server")
    parser.add_argument("config")
    parser.add_argument("--checkpoint", default=None,
                        help="a checkpoint file, or a directory whose slot "
                             "trainer.checkpoint_filename_for_loading names")
    parser.add_argument("--ema", action="store_true",
                        help="serve the checkpoint's EMA weights")
    parser.add_argument("--task", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=None,
                        help="serving batch (default: config batch_size)")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="micro-batch window; bounds added latency")
    parser.add_argument("--pipeline-depth", type=int, default=0,
                        help="in-flight batches: 1 overlaps batch N+1's upload "
                             "with batch N's compute; 0 serialises")
    parser.add_argument("--seed", type=int, default=0,
                        help="weight init seed (without --checkpoint)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; cuda (default) or cpu")
    parser.add_argument("--num-generate", type=int, default=8,
                        help="diffusion: samples per /v1/generate call")
    parser.add_argument("--preprocess-workers", type=int, default=0,
                        help="adaptive configs: the patchify's spawn pool size (0: in "
                             "the request's thread)")
    args = parser.parse_args(argv)

    from ucf_vit_tpu_torch.config import load_config

    cfg = load_config(args.config, task=args.task)
    rank, world, _ = launched()
    if cfg.world_size > 1 and world > 1 and rank != 0:
        serve_follower(cfg, args.checkpoint, use_ema=args.ema, max_batch=args.max_batch,
                       seed=args.seed, device=args.device, num_generate=args.num_generate)
        return
    server = make_server(
        cfg, args.checkpoint, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms, use_ema=args.ema,
        pipeline_depth=args.pipeline_depth, seed=args.seed, device=args.device,
        num_generate=args.num_generate, preprocess_workers=args.preprocess_workers,
    )
    batching = (f"num_generate={args.num_generate}" if cfg.task == "diffusion" else
                f"max_batch={args.max_batch or cfg.batch_size}, window={args.max_wait_ms}ms")
    print(f"serving task={cfg.task} on {args.host}:{server.server_address[1]} "
          f"(device={args.device}, {batching})", flush=True)
    if threading.current_thread() is threading.main_thread():
        # SIGTERM stops the server as Ctrl-C does (serve_forever returns); shutdown
        # waits for serve_forever, so it runs in a thread of its own
        signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
            target=server.shutdown, daemon=True).start())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        close_server(server)


if __name__ == "__main__":
    main()
