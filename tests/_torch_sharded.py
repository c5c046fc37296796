"""The rank side of the port's sharded CPU tests (`tests/test_torch_dropout.py`,
its sharded section): `run_group` starts a gloo group of `world` processes
through a FileStore (no TCP port, so parallel test workers cannot collide),
and every rank runs the same list of jobs in order; rank 0 hands back each
job's result. The jobs import torch and the port only, never JAX.

Run as a script, one process is one rank of a trainer launched by hand:

    python tests/_torch_sharded.py <store file> <rank> <world> <trainer argv...>
"""

from __future__ import annotations

import os
import queue as queue_mod
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def join_group(store_path: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)


def _worker(rank: int, world: int, store_path: str, jobs: list, queue) -> None:
    join_group(store_path, rank, world)
    try:
        for job in jobs:
            out = JOBS[job["kind"]](job)
            if rank == 0:
                queue.put((job["name"], out))
    except BaseException:
        queue.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        dist.destroy_process_group()


def run_group(world: int, jobs: list, tmp_dir: str, timeout: float = 900.0) -> dict:
    """{job name: rank 0's result} of `jobs` run on a gloo group of `world`
    processes; raises with the failing rank's traceback."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(str(tmp_dir), f"store_{world}_{os.getpid()}")
    procs = [ctx.Process(target=_worker, args=(r, world, store, jobs, queue), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < len(jobs):
            try:
                name, out = queue.get(timeout=1.0)
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    raise RuntimeError(f"the group of {world} stopped after {sorted(results)}: "
                                       f"exit codes {[p.exitcode for p in procs]}")
                continue
            if name == "error":
                raise RuntimeError(out)
            results[name] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return results


# ---------------------------------------------------------------- jobs


def _losses(kind: str, cfg):
    """The train step's loss: the task's, or one that takes injected draws."""
    from ucf_vit_tpu_torch.ops.patchify import patchify
    from ucf_vit_tpu_torch.tasks import task_loss
    from ucf_vit_tpu_torch.utils import metrics

    if kind == "mae_noise":
        def loss_fn(model, batch):
            pred, mask = model(batch["x"], mask_noise=batch["mask_noise"])
            return metrics.masked_mse(pred, patchify(batch["x"], cfg.patch_size, cfg.twoD),
                                      mask), {}
        return loss_fn
    loss = task_loss(cfg)
    if kind == "diffusion_te":  # t and e from the batch, the time embedding's dropout off
        def diff_loss(model, batch):
            model.timeEmbeddingMap.eval()
            return loss(model, batch)
        return diff_loss
    return loss


def _segment(cfg, model, batch: dict) -> torch.Tensor:
    """A UNETR's or SAP's logits of a numpy batch, through the task's inputs."""
    from ucf_vit_tpu_torch.tasks import sap_inputs, unetr_inputs

    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    if cfg.task == "sap":
        img, ps = sap_inputs(cfg, b)
        return model(img, seq_ps=ps)
    x, ps, x_seq = unetr_inputs(cfg, b)
    return model(x, seq_ps=ps, x_seq=x_seq)


def train_job(job: dict) -> dict:
    """Train `job["raw"]` on the group's mesh from the whole weights
    `job["init"]` on the global batches `job["batches"]`; the per-step losses
    and the parameters gathered whole. With `job["forward"]` (a segmentation
    batch), the model's logits of it before the first step."""
    from ucf_vit_tpu_torch import checkpoint as ckpt
    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.parallel.mesh import shard_batch
    from ucf_vit_tpu_torch.parallel.train_step import make_train_step
    from ucf_vit_tpu_torch.tasks import var_ids_of
    from ucf_vit_tpu_torch.train import _ema_decay, init_train, to_device

    raw = job["raw"]
    cfg = Config(raw=raw, task=raw["trainer"]["task"])
    state, step = init_train(cfg, "cpu")
    ckpt.load_params(state.model, {k: torch.from_numpy(v) for k, v in job["init"].items()},
                     "init")
    if state.ema_params is not None:
        state.ema_params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    if job.get("loss", "task") != "task":
        step = make_train_step(_losses(job["loss"], cfg), state.optimizer,
                               accum_steps=int(cfg.trainer.get("accum_steps", 1)),
                               ema_decay=_ema_decay(cfg))
    var_ids = var_ids_of(cfg, state.model)  # None without use_varemb
    logits = None
    if "forward" in job:  # the logits of the whole batch `job["forward"]` first
        with torch.no_grad():
            logits = _segment(cfg, state.model.eval(), job["forward"]).numpy()
    losses = []
    for b in job["batches"]:
        state, loss, _ = step(state, to_device(shard_batch(b, state.mesh), torch.device("cpu")),
                              var_ids)
        losses.append(loss.item())
    params = {k: v.numpy() for k, v in ckpt.full_state_dict(state.model).items()}
    named = dict(state.model.named_parameters())
    return {"losses": losses, "params": params, "logits": logits,
            "sharded": sorted(getattr(state.model, "tp_layout", {})),
            # each expert leaf's experts on this rank (a DTensor's whole dim 0)
            "experts": {n: int(named[n].shape[0])
                        for n in sorted(getattr(state.model, "ep_layout", set()))},
            "updates": state.optimizer.count,
            "scale": None if state.loss_scale is None else state.loss_scale.scale}


def _gather_world(t: torch.Tensor) -> list:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return [p.numpy() for p in parts]


def attn_dropout_job(job: dict) -> dict:
    """EINSUM attention with dropout on each rank's batch and head slice of
    the global q, k, v under a (ddp, fsdp, tp) mesh; every rank's output."""
    from ucf_vit_tpu_torch.ops.attention import multi_head_attention
    from ucf_vit_tpu_torch.parallel.mesh import make_mesh, mesh_context

    ddp, fsdp, tp = job["shape"]
    mesh = make_mesh(simple_ddp_size=ddp, fsdp_size=fsdp, tensor_par_size=tp)
    q, k, v = (torch.from_numpy(job[n]) for n in "qkv")
    b, h = q.shape[0] // mesh.data_size, q.shape[1] // tp
    r, t = mesh.data_rank, mesh.index("tp")
    ql, kl, vl = (x[r * b:(r + 1) * b, t * h:(t + 1) * h] for x in (q, k, v))
    with mesh_context(mesh):
        o = multi_head_attention(ql, kl, vl, impl="EINSUM", dropout_rate=job["rate"],
                                 dropout_seed=job["seed"])
    return {"outs": _gather_world(o), "coords": _gather_world(
        torch.tensor([r, t]))}


def collectives_job(job: dict) -> dict:
    """Each conjugate pair on the world group: every rank's forward output
    and its input's gradient for the cotangent `w_r`."""
    from ucf_vit_tpu_torch.parallel import collectives as C

    g, r = dist.group.WORLD, dist.get_rank()
    x = torch.from_numpy(job["x"][r]).clone().requires_grad_(True)
    pairs = {
        "f_broadcast_b_identity": lambda t: C.f_broadcast_b_identity(t, g, 1),
        "f_identity_b_allreduce": lambda t: C.f_identity_b_allreduce(t, g),
        "f_allreduce_b_identity": lambda t: C.f_allreduce_b_identity(t, g),
        "f_identity_b_broadcast": lambda t: C.f_identity_b_broadcast(t, g, 1),
        "all_reduce": lambda t: C.all_reduce(t, g),
        "all_gather": lambda t: C.all_gather(t, g, axis=0),
        "reduce_scatter": lambda t: C.reduce_scatter(t, g, axis=0),
        "all_to_all": lambda t: C.all_to_all(t, g, split_axis=0, concat_axis=1),
    }
    out = {}
    for name, fn in pairs.items():
        x.grad = None
        y = fn(x)
        w = torch.from_numpy(job["w"][name][r])
        (y * w).sum().backward()
        out[name] = (_gather_world(y.detach()), _gather_world(x.grad))
    # the Ulysses pair is its own inverse
    q = torch.from_numpy(job["q"][r])
    mid = C.ulysses_heads_to_seq(q, g)
    out["ulysses"] = (_gather_world(mid), _gather_world(C.ulysses_seq_to_heads(mid, g)))
    return out


def sync_check_job(job: dict) -> dict:
    """The replica check on a small sharded ViT: healthy, then with one rank's
    copy of a replicated parameter changed."""
    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.parallel.sync_check import ReplicaDesyncError, check_replica_consistency
    from ucf_vit_tpu_torch.train import init_train

    raw = job["raw"]
    state, _ = init_train(Config(raw=raw, task="classification"), "cpu")
    model, mesh = state.model, state.mesh
    report = check_replica_consistency(model, mesh)
    out = {"ok": report.ok, "redundancy": report.redundancy_axes, "groups": report.n_groups,
           "describe": report.describe()}
    if job.get("corrupt") is not None:
        if dist.get_rank() == job["corrupt"]:
            with torch.no_grad():
                p = dict(model.named_parameters())[job.get("leaf", "norm.bias")]
                (p.to_local() if hasattr(p, "to_local") else p)[...] += 1e-3
        try:
            check_replica_consistency(model, mesh)
            out["caught"] = None
        except ReplicaDesyncError as e:
            out["caught"] = str(e)
        bad = check_replica_consistency(model, mesh, raise_on_mismatch=False)
        out["mismatches"] = [[rk for rk, _ in ranks] for _, ranks in bad.mismatches]
    return out


def cli_job(job: dict) -> dict:
    """`python -m ucf_vit_tpu_torch.train <argv>` on this rank."""
    from ucf_vit_tpu_torch.train import main

    out = main(job["argv"])
    return {"loss_list": out["loss_list"], "step": out["state"].step}


def cli_ranks_job(job: dict) -> dict:
    """`cli_job`, and every rank's device generator state and the parameters
    `job["leaves"]` (this rank's local tensors) after the run."""
    from ucf_vit_tpu_torch.train import main

    out = main(job["argv"])
    model = out["state"].model
    sd = model.state_dict()
    mine = {"generator": model.generator.get_state().numpy(),
            **{k: sd[k].detach().numpy().copy() for k in job["leaves"]}}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {"loss_list": out["loss_list"], "step": out["state"].step, "ranks": ranks}


def sp_attention_job(job: dict) -> dict:
    """Sequence-parallel attention on each case's mesh `(ddp, fsdp, sp, tp)`:
    each rank's slice of the global q, k, v (batch by data rank, heads by tp,
    tokens by sp) through `ops.ring_attention.ring_attention` (`"ring_op"`)
    or `multi_head_attention` under FLASH in the case's `sp_mode`, and the
    gradient of `sum(o * w)`; {case: (every rank's o, dq, dk, dv, its
    coordinates)}."""
    from ucf_vit_tpu_torch.ops.attention import multi_head_attention
    from ucf_vit_tpu_torch.ops.ring_attention import ring_attention
    from ucf_vit_tpu_torch.parallel.mesh import (make_mesh, mesh_context, seq_shard_of,
                                                 sequence_context)

    out = {}
    for name, (shape, mode, rate) in job["cases"].items():
        ddp, fsdp, sp, tp = shape
        mesh = make_mesh(simple_ddp_size=ddp, fsdp_size=fsdp, seq_par_size=sp,
                         tensor_par_size=tp)
        b = job["q"].shape[0] // mesh.data_size
        h = job["q"].shape[1] // tp
        n = job["q"].shape[2] // sp
        r, t, s = mesh.data_rank, mesh.index("tp"), mesh.index("sp")
        sl = (slice(r * b, (r + 1) * b), slice(t * h, (t + 1) * h), slice(s * n, (s + 1) * n))
        q, k, v = (torch.from_numpy(job[x][sl]).clone().requires_grad_(True) for x in "qkv")
        seed = job["seed"] if rate > 0.0 else None
        with mesh_context(mesh), sequence_context(seq_shard_of(mesh)):
            if mode == "ring_op":
                o = ring_attention(q, k, v, mesh.group("sp"), dropout_rate=rate,
                                   dropout_seed=seed)
            else:
                o = multi_head_attention(q, k, v, impl="FLASH", dropout_rate=rate,
                                         dropout_seed=seed, sp_mode=mode)
        (o * torch.from_numpy(job["w"][sl])).sum().backward()
        out[name] = tuple(_gather_world(x) for x in (o.detach(), q.grad, k.grad, v.grad)) + (
            _gather_world(torch.tensor([r, t, s])),)
    return out


def sp_odd_job(job: dict) -> dict:
    """A ViT whose 17 tokens sp 2 does not divide, on a (sp 2) mesh: EINSUM's
    logits (the stream runs whole on both ranks), and what FLASH raises."""
    from ucf_vit_tpu_torch import checkpoint as ckpt
    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.train import init_train

    out = {}
    for impl in ("EINSUM", "FLASH"):
        raw = {**job["raw"], "trainer": {**job["raw"]["trainer"], "attn_impl": impl}}
        state, _ = init_train(Config(raw=raw, task="classification"), "cpu")
        ckpt.load_params(state.model, {k: torch.from_numpy(v) for k, v in job["init"].items()},
                         "init")
        try:
            with torch.no_grad():
                out[impl] = state.model.eval()(torch.from_numpy(job["x"])).numpy()
        except ValueError as e:
            out[impl] = f"ValueError: {e}"
    return out


def reconstruct_job(job: dict) -> dict:
    """`inference.reconstruct` of an MAE on the config's eval mesh."""
    from ucf_vit_tpu_torch.inference import init_eval_model, reconstruct
    from ucf_vit_tpu_torch.parallel.mesh import eval_mesh

    cfg = _cfg(job)
    model = init_eval_model(cfg, seed=0, device="cpu", mesh=eval_mesh(cfg, torch.device("cpu")))
    return reconstruct(model, torch.from_numpy(job["x"]), seed=job["seed"]).numpy()


def cli_state_job(job: dict) -> dict:
    """`cli_job`, and after it the parameters gathered whole and every rank's
    device generator state."""
    from ucf_vit_tpu_torch.checkpoint import full_state_dict
    from ucf_vit_tpu_torch.train import main

    out = main(job["argv"])
    model = out["state"].model
    gens = [None] * dist.get_world_size()
    dist.all_gather_object(gens, model.generator.get_state().numpy())
    params = {k: v.numpy() for k, v in full_state_dict(model).items()}
    return {"step": out["state"].step, "params": params, "generators": gens}


def halo_job(job: dict) -> dict:
    """`collectives.halo_exchange` on the world group along dim 2 of each rank's
    slab of the global `x`, for each width: every rank's output and its slab's
    gradient for the cotangent `w[width][rank]`."""
    from ucf_vit_tpu_torch.parallel.collectives import halo_exchange

    n, r = dist.get_world_size(), dist.get_rank()
    out = {}
    for width, w in job["w"].items():
        x = torch.from_numpy(np.split(job["x"], n, axis=2)[r]).requires_grad_(True)
        y = halo_exchange(x, dist.group.WORLD, 2, width)
        (y * torch.from_numpy(w[r])).sum().backward()
        out[width] = (_gather_world(y.detach()), _gather_world(x.grad))
    return out


SPATIAL_MODULES = {  # the cases of `spatial_blocks_job` that run a module
    "res_block": lambda ub: ub.UnetResBlock(4, 6, ndim=3),
    "res_block_2d": lambda ub: ub.UnetResBlock(4, 6, ndim=2),
    "up_block": lambda ub: ub.UnetrUpBlock(6, 4, ndim=3),
    "up_block_whole_in": lambda ub: ub.UnetrUpBlock(6, 4, ndim=3),
    "pr_up_block_whole_in": lambda ub: ub.UnetrPrUpBlock(6, 4, num_layer=1, ndim=3),
    "instance_norm": lambda ub: ub.InstanceNorm(),
}


def spatial_module(name: str):
    """The module of a spatial-partition case (`spatial_blocks_job`), its
    weights from a seed, in f64: the same on every rank and in the test; None
    for a resize."""
    from ucf_vit_tpu_torch.models import unet_blocks

    if name not in SPATIAL_MODULES:
        return None
    torch.manual_seed(3)
    return SPATIAL_MODULES[name](unet_blocks).double()


def spatial_case(name: str, case: dict, shard=None):
    """`(output whole, whole inputs as leaves, module)` of one case of
    `spatial_blocks_job` on `shard` (None: one device). Under a shard every
    input is split on dim 2 where sp divides its side, the module runs inside
    `spatial_context`, and the output is gathered whole."""
    from ucf_vit_tpu_torch.models.unet_blocks import resize_linear_align_corners
    from ucf_vit_tpu_torch.parallel.mesh import spatial, spatial_context, spatial_gather

    leaves = [torch.from_numpy(a).clone().requires_grad_(True) for a in case["inputs"]]
    xs = [spatial(t, False, shard) for t in leaves]
    mod = spatial_module(name)
    with spatial_context(shard):
        if mod is None:
            y = resize_linear_align_corners(xs[0][0], case["target"], split=xs[0][1])
        else:
            y = mod(*(x for x, _ in xs), split=xs[0][1])
    y_split = shard is not None and case["out_side"] % shard.size == 0
    return spatial_gather(y, y_split, shard), leaves, mod


def spatial_blocks_job(job: dict) -> dict:
    """Each case of `job["cases"]` ({name: {"inputs": [arrays], "out_side": the
    output's first side, "target": a resize's size or None}}) on the world
    group as sp (`spatial_case`); each rank backpropagates `sum(y * w) / sp`
    (partial sums, as the train step's `loss / sp`), and the gradients of the
    inputs and the parameters are summed over the group. {name: (output,
    input gradients, parameter gradients)}."""
    from ucf_vit_tpu_torch.parallel.mesh import SeqShard

    n = dist.get_world_size()
    shard = SeqShard(dist.group.WORLD, n, dist.get_rank())
    out = {}
    for name, case in job["cases"].items():
        y, leaves, mod = spatial_case(name, case, shard)
        ((y * torch.from_numpy(case["w"])).sum() / n).backward()
        params = [] if mod is None else list(mod.named_parameters())
        grads = [t.grad for t in leaves] + [p.grad for _, p in params]
        for g in grads:
            dist.all_reduce(g)
        out[name] = (y.detach().numpy(), [g.numpy() for g in grads[:len(leaves)]],
                     {k: p.grad.numpy() for k, p in params})
    return out


JOBS = {"train": train_job, "attn_dropout": attn_dropout_job, "collectives": collectives_job,
        "sync_check": sync_check_job, "cli": cli_job, "cli_ranks": cli_ranks_job,
        "sp_attention": sp_attention_job, "sp_odd": sp_odd_job, "cli_state": cli_state_job,
        "halo": halo_job, "spatial_blocks": spatial_blocks_job}


if __name__ == "__main__":
    store_path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    join_group(store_path, rank, world)
    from ucf_vit_tpu_torch.train import main

    try:
        main(sys.argv[4:])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- evaluation and serving


def _cfg(job: dict):
    from ucf_vit_tpu_torch.config import Config

    return Config(raw=job["raw"], task=job["raw"]["trainer"]["task"])


def eval_job(job: dict):
    """`ucf_vit_tpu_torch.inference.<fn>(cfg, *args, device="cpu", **kwargs)` on
    every rank (the function joins the config's mesh); rank 0's result, with
    `return_images` the images."""
    from ucf_vit_tpu_torch import inference

    out = getattr(inference, job["fn"])(_cfg(job), *job.get("args", ()), device="cpu",
                                        **job.get("kwargs", {}))
    return out[1] if job.get("kwargs", {}).get("return_images") else out


def predictor_job(job: dict):
    """`serve.build_predictor` on the config's mesh: rank 0 runs `job["batch"]`
    and stops the others, which follow."""
    from ucf_vit_tpu_torch.serve import build_predictor

    run_batch, _, _, _ = build_predictor(_cfg(job), max_batch=job["max_batch"], device="cpu")
    if dist.get_rank() != 0:
        return run_batch.replicas.follow()
    try:
        return run_batch(job["batch"]).numpy()
    finally:
        run_batch.replicas.stop()


def generator_job(job: dict):
    """`serve.build_generator` of a model on the config's mesh: rank 0 generates
    for `job["seed"]` and stops the others, which follow."""
    from ucf_vit_tpu_torch.inference import init_eval_model
    from ucf_vit_tpu_torch.parallel.mesh import eval_mesh
    from ucf_vit_tpu_torch.serve import build_generator

    cfg = _cfg(job)
    model = init_eval_model(cfg, device="cpu", mesh=eval_mesh(cfg, torch.device("cpu")))
    generate = build_generator(cfg, model, job["num_samples"])
    if dist.get_rank() != 0:
        return generate.replicas.follow()
    try:
        return generate(job["seed"])
    finally:
        generate.replicas.stop()


def _http(port: int, path: str, body: bytes = b"", timeout: float = 60.0) -> bytes:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body or None,
                                 method="POST" if body else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _client(port: int, job: dict, out: dict) -> None:
    """Rank 0's HTTP client: the requests of `job["phases"]` in turn (a list of
    lone requests, or of concurrent ones, or a reload), then SIGTERM to this
    process, which stops the server."""
    import io
    import json
    import signal
    import threading

    import numpy as np

    def npy(a):
        buf = io.BytesIO()
        np.save(buf, a)
        return buf.getvalue()

    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                _http(port, "/healthz")
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        answers = {}

        def ask(i):
            answers[i] = np.load(io.BytesIO(_http(port, "/v1/predict", npy(job["inputs"][i]))))

        for kind, what in job["phases"]:
            if kind == "reload":
                out["reload"] = json.loads(_http(port, "/v1/reload", json.dumps(
                    {"checkpoint": what}).encode()))
            elif kind == "lone":
                for i in what:
                    ask(i)
            else:  # concurrent: they share batches
                threads = [threading.Thread(target=ask, args=(i,)) for i in what]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
        out["stats"] = json.loads(_http(port, "/v1/stats"))
        out["answers"] = answers
    except BaseException as e:  # reported by the job
        out["error"] = repr(e)
    finally:
        os.kill(os.getpid(), signal.SIGTERM)


def serve_job(job: dict) -> dict:
    """`python -m ucf_vit_tpu_torch.serve <config> --port P --device cpu` on every
    rank; rank 0 also runs the HTTP client (`_client`) in a thread. Every rank's
    `main` must return; each rank's outcome is gathered."""
    import threading

    from ucf_vit_tpu_torch.serve import main

    out: dict = {}
    client = None
    if dist.get_rank() == 0:
        client = threading.Thread(target=_client, args=(job["port"], job, out), daemon=True)
        client.start()
    main([job["path"], "--port", str(job["port"]), "--host", "127.0.0.1", "--device", "cpu",
          "--max-batch", str(job["max_batch"]), "--max-wait-ms", "200"])
    if client is not None:
        client.join(timeout=60)
    returned = [None] * dist.get_world_size()
    dist.all_gather_object(returned, "returned")
    return {**out, "returned": returned}


JOBS.update(eval=eval_job, predictor=predictor_job, generator=generator_job, serve=serve_job,
            reconstruct=reconstruct_job)
