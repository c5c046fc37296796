"""Which collectives gloo carries on CUDA tensors, with two ranks on one card:

    python -m ucf_vit_tpu_torch.tools.gloo_probe [--only NAME ...]

NCCL refuses two ranks on one device, so a sharded run of the port on one
card goes over gloo; this finds out, once, what gloo's CUDA path does in the
installed torch. For each test a fresh pair of spawned ranks joins a gloo
group through a FileStore: `all_reduce`, `broadcast`, `all_gather` (list),
`all_gather_into_tensor`, `reduce_scatter_tensor` and `all_to_all_single` on
CUDA tensors (each result checked), one FSDP step (`fully_shard` on a 1 x 2
CUDA mesh, a small MLP), the same with `DTensor.full_tensor` of a gradient
after it, and two train steps of a small ViT through the port's trainer in
each mode (ddp 2, tp 2, fsdp 2; f32, EINSUM attention, so that nothing is
built), then their parameters gathered whole as the checkpoint gathers them,
beside the same steps on one rank. The point-to-point tests (`P2P`) carry
the sequence-parallel ring's hop: `dist.send`/`recv` and
`dist.batch_isend_irecv` of a pair of `P2POp`s, and the same hop as an
`all_to_all_single` whose split sizes send the whole chunk to the next rank,
each at the ring's chunk sizes (`P2P_BYTES`: mae_long's K/V chunk of the
encoder and of the decoder at sp 2 in bf16, and the f32 dk/dv beside them),
checked and timed (the median of `P2P_REPS` hops, ms on the host clock).
A test whose ranks have not both answered within PER_TEST_S hung (a rank waits in a collective the other
left) and its pair is killed. Prints a line a test as it ends and a summary
line.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _check(fn):
    try:
        return "ok" if fn() else "wrong result"
    except Exception as e:  # a probe: every failure is the finding
        return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def _collectives(rank: int, world: int, only=None) -> dict:
    """{name: "ok" or what went wrong} of each collective (`only`: these
    names) on CUDA tensors over the default group."""
    dev = torch.device("cuda")

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return bool((x == world * (world + 1) / 2).all())

    def broadcast():
        x = torch.full((4,), float(rank), device=dev)
        dist.broadcast(x, src=1)
        return bool((x == 1).all())

    def all_gather():
        parts = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((4,), float(rank), device=dev))
        return all(bool((p == i).all()) for i, p in enumerate(parts))

    def all_gather_into_tensor():
        out = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(out, torch.full((4,), float(rank), device=dev))
        return bool((out == torch.arange(world, device=dev).repeat_interleave(4)).all())

    def reduce_scatter_tensor():
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, torch.arange(4.0 * world, device=dev))
        return bool((out == world * torch.arange(4.0 * rank, 4.0 * rank + 4, device=dev)).all())

    def all_to_all_single():
        out = torch.empty(world, device=dev)
        dist.all_to_all_single(out, torch.arange(world, device=dev).float() + 10 * rank)
        return bool((out == torch.arange(world, device=dev) * 10 + rank).all())

    def fsdp(full: bool):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("ddp", "fsdp"))
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.GELU(),
                                torch.nn.Linear(16, 4)).to(dev)
        fully_shard(m[0], mesh=mesh)
        fully_shard(m, mesh=mesh)
        m(torch.randn(2, 8, device=dev)).square().mean().backward()
        g = m[0].weight.grad
        g = g.full_tensor() if full else g.to_local()
        return g.shape == ((16, 8) if full else (8, 8)) and bool(torch.isfinite(g).all())

    tests = {"all_reduce": all_reduce, "broadcast": broadcast, "all_gather": all_gather,
             "all_gather_into_tensor": all_gather_into_tensor,
             "reduce_scatter_tensor": reduce_scatter_tensor,
             "all_to_all_single": all_to_all_single, "fsdp_step": lambda: fsdp(False),
             "full_tensor": lambda: fsdp(True)}
    return {name: _check(fn) for name, fn in tests.items() if only is None or name in only}


# the ring's chunks at mae_long's sp 2 shapes: a rank's K (or V) of the encoder,
# [2, 12, 4096, 64], and of the decoder, [2, 6, 16384, 96], in bf16; the f32 dk/dv
# that ride with them are twice as large
P2P_BYTES = (2 * 12 * 4096 * 64 * 2, 2 * 6 * 16384 * 96 * 2, 2 * 12 * 4096 * 64 * 4,
             2 * 6 * 16384 * 96 * 4)
P2P_REPS = 5


def _hop(kind: str, x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """One ring hop: `x` to rank + 1, the result from rank - 1."""
    got = torch.empty_like(x)
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    if kind == "send_recv":  # blocking: the even ranks send first
        if rank % 2 == 0:
            dist.send(x, nxt)
            dist.recv(got, prv)
        else:
            dist.recv(got, prv)
            dist.send(x, nxt)
    elif kind == "batch_isend_irecv":
        ops = [dist.P2POp(dist.isend, x, nxt), dist.P2POp(dist.irecv, got, prv)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    else:  # all_to_all_single: every split empty but the one to rank + 1
        n = x.numel()
        out_splits = [n if r == nxt else 0 for r in range(world)]
        in_splits = [n if r == prv else 0 for r in range(world)]
        dist.all_to_all_single(got.view(-1), x.reshape(-1), in_splits, out_splits)
    return got


def _p2p(kind: str, rank: int, world: int) -> str:
    """"ok (ms a hop at each of P2P_BYTES)" or what went wrong, for `kind` on
    CUDA tensors."""
    def run():
        times = []
        for nbytes in P2P_BYTES:
            x = torch.arange(nbytes // 4, device="cuda", dtype=torch.float32) + 1e6 * rank
            want = torch.arange(nbytes // 4, device="cuda", dtype=torch.float32) + 1e6 * (
                (rank - 1) % world)
            hops = []
            for _ in range(P2P_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = _hop(kind, x, rank, world)
                torch.cuda.synchronize()
                hops.append((time.perf_counter() - t0) * 1e3)
                if not torch.equal(got, want):
                    return None
            times.append(sorted(hops)[len(hops) // 2])
        return times

    try:
        times = run()
    except Exception as e:  # a probe: every failure is the finding
        return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    if times is None:
        return "wrong result"
    return "ok (" + ", ".join(f"{b / 1e6:.1f} MB {t:.1f} ms" for b, t in
                              zip(P2P_BYTES, times)) + ")"


P2P = ("send_recv", "batch_isend_irecv", "a2a_hop")
COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "fsdp_step", "full_tensor")


def _vit_raw(par: dict) -> dict:
    ia = {"default_vars": ["red", "green", "blue"], "tile_size": [32, 32], "patch_size": 8,
          "embed_dim": 64, "depth": 2, "num_heads": 4, "mlp_ratio": 2, "twoD": True,
          "adaptive_patching": False}
    n = par.get("simple_ddp_size", 1) * par.get("fsdp_size", 1)
    return {"trainer": {"task": "classification", "seed": 0, "attn_impl": "EINSUM"},
            "parallelism": par,
            "model": {"lr": 1e-3, "warmup_steps": 1, "max_steps": 10,
                      "net": {"init_args": ia}},
            "data": {"batch_size": 8 // n, "num_classes": 4, "num_channels_used": {"d": 3}}}


def _train(raw: dict, steps: int = 2) -> dict:
    """The per-step losses, and the parameters' elements once gathered whole
    as the checkpoint gathers them."""
    from ucf_vit_tpu_torch.checkpoint import full_state_dict
    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.parallel.mesh import shard_batch
    from ucf_vit_tpu_torch.train import init_train, synthetic_batches, to_device

    cfg = Config(raw=raw, task="classification")
    state, step = init_train(cfg)
    losses = []
    for _, b in zip(range(steps), synthetic_batches(cfg, 8)):
        state, loss, _ = step(state, to_device(shard_batch(b, state.mesh), torch.device("cuda")))
        losses.append(loss.item())
    gathered = sum(v.numel() for v in full_state_dict(state.model).values())
    return {"losses": losses, "gathered": gathered}


MODES = {"ddp2": {"simple_ddp_size": 2}, "tp2": {"tensor_par_size": 2},
         "fsdp2": {"fsdp_size": 2}}
PER_TEST_S = 45  # a test the two ranks do not finish by then hung (a collective waits)


def _rank(rank: int, store: str, name: str, queue) -> None:
    sys.path.insert(0, REPO)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    if name in P2P:
        out = _p2p(name, rank, 2)
    elif name in MODES:
        try:
            out = _train(_vit_raw(MODES[name]))
        except Exception as e:  # a probe: every failure is the finding
            out = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    else:
        out = _collectives(rank, 2, only=(name,))[name]
    queue.put((rank, out))
    dist.destroy_process_group()


def _probe(name: str) -> list:
    """Each rank's result of test `name` on a fresh pair of ranks, or "hung"."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(), "store")
    procs = [ctx.Process(target=_rank, args=(r, store, name, queue), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    out = ["hung", "hung"]
    deadline = time.monotonic() + PER_TEST_S
    for _ in procs:
        try:
            rank, res = queue.get(timeout=max(deadline - time.monotonic(), 0.1))
        except Exception:
            break
        out[rank] = res
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    if not torch.cuda.is_available():
        print("no CUDA card", flush=True)
        return 1
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}", flush=True)
    names = COLLECTIVES + P2P + tuple(MODES)
    if "--only" in sys.argv:
        names = tuple(sys.argv[sys.argv.index("--only") + 1:])
    results = {}
    for name in names:
        t0 = time.perf_counter()
        results[name] = _probe(name)
        print(f"{name}: {json.dumps(results[name])} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if set(MODES) & set(names):
        print(f"one rank: {json.dumps(_train(_vit_raw({})))}", flush=True)
    carried = [k for k in COLLECTIVES + P2P
               if k in results and all(r.startswith("ok") for r in results[k])]
    print(f"gloo on CUDA tensors carries: {', '.join(carried) or 'nothing'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
