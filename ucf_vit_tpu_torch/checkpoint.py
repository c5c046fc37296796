"""Checkpoint save and restore (the port's counterpart of
`ucf_vit_tpu/checkpoint.py`), with the same even/odd rotation: a save goes
to `<checkpoint_path>/<filename>_{even,odd}.ckpt` by the parity of its
epoch, so a crash while saving loses at most the slot being written.

A checkpoint is one `torch.save` dict, written to a temporary name and
moved into place with `os.replace`:

    epoch                 int, the epoch that ended
    model_state_dict      {name: f32 tensor}, the reference's names
    loss_list             [float], each epoch's mean loss
    optimizer_state_dict  AdamW's state (`torch.optim.AdamW.state_dict`)
    optimizer_count       the update count the schedule reads
    step                  the train step's call count
    loss_scale            {"scale", "growth_counter"} or None
    ema_state_dict        {name: tensor} or None (trainer.ema_decay)
    total_steps           int
    head_meta             [num_heads, decoder_num_heads]
    generators            {"device", "host"}: the states of the train
                          step's torch.Generators (the port's rng_key);
                          "device_by_data_rank": each data rank's device
                          generator; a sharded run's "device_by_rank":
                          each process's
    data_it               batches of `epoch` already trained on: 0 after
                          an epoch's end; a preemption save mid-epoch
                          records its position, and resume re-enters the
                          epoch there when the data layout is the same
    num_procs             the processes that wrote it (the world size)
    data_size             the data ranks that wrote it (`Mesh.data_size`):
                          each reads its own share of the files and draws
                          from its own device generator

The first three keys are what `python -m
ucf_vit_tpu.tools.convert_checkpoint to-jax` reads, so a port checkpoint
converts unchanged; the file that its `to-torch` writes (those three keys)
loads here as weights. Orbax directories are not read: convert them with
`to-torch` first.

`transfer_mae_encoder` starts a UNETR (or SAP) from an MAE checkpoint's
encoder (`ucf_vit_tpu/checkpoint.py:358`).

A model sharded on a mesh (`parallel.train_step.shard_model`) saves the same
file: every rank takes part in gathering each tensor whole (FSDP's shards by
`all_gather_into_tensor`, `_join_shards`, the tensor-parallel pieces put back
in the reference's layout by `models.blocks.tp_merge`), and rank 0 writes it.
AdamW's moments and the EMA are gathered like their parameters. The device
generators follow the data layout, as the data does: the tp ranks of one data
rank draw the same masks, so the file keeps one state a data rank
(`generators["device_by_data_rank"]`), and a run with the same number of data
ranks takes its data rank's (`restore_train_state`); a run with another keeps
its own seeded ones. A load takes each rank's part of the whole tensors, onto
whatever layout the loading run has (`load_params`, `restore_train_state`).
Under sequence parallelism the parameters are whole on every sp rank and the
sp ranks of one data rank share its generators, so the file is the same,
written once, and loads with or without sp. Under expert parallelism an
expert leaf (`model.ep_layout`) holds its rank's `E/ep` experts: the save
joins the ep ranks' pieces on dim 0 (after FSDP's shards and the tp pieces),
and a load slices them again, so an ep checkpoint loads onto one device or
any other layout and converts with `to-jax` as any other.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

SUFFIX = ".ckpt"


def _mesh(model: torch.nn.Module):
    return getattr(model, "mesh", None)


def _layout(model: torch.nn.Module) -> dict:
    return getattr(model, "tp_layout", None) or {}


def _ep(model: torch.nn.Module) -> set:
    return getattr(model, "ep_layout", None) or set()


def gather_full(t: torch.Tensor, kind: Optional[str], mesh, ep: bool = False) -> torch.Tensor:
    """The whole tensor, on every rank (all must call): a DTensor's shards
    joined, a tensor-parallel parameter's pieces (split `kind`) merged over
    tp, each rank's piece placed among zeros and summed, which is exact, and
    with `ep` (an expert leaf) the ep ranks' experts joined on dim 0."""
    if hasattr(t, "to_local"):
        t = _join_shards(t)
    if kind is not None and mesh is not None and mesh.size("tp") > 1:
        from ucf_vit_tpu_torch.models.blocks import tp_merge

        r = mesh.index("tp")
        t = tp_merge([t if i == r else torch.zeros_like(t) for i in range(mesh.size("tp"))],
                     kind)
        dist.all_reduce(t, group=mesh.group("tp"))
    if ep and mesh is not None and mesh.size("ep") > 1:
        parts = [torch.empty_like(t) for _ in range(mesh.size("ep"))]
        dist.all_gather(parts, t.contiguous(), group=mesh.group("ep"))
        t = torch.cat(parts)
    return t


def _join_shards(t) -> torch.Tensor:
    """A DTensor whole: along each mesh dim it is `Shard(d)` on, the ranks'
    pieces of torch.chunk's split (FSDP's layout: equal pieces but the last,
    some maybe empty), padded to one size, joined by `all_gather_into_tensor`
    and cut back; replicated dims as they are."""
    from torch.distributed.tensor import Shard

    dm, out = t.device_mesh, t.to_local()
    for mdim, pl in enumerate(t.placements):
        if not isinstance(pl, Shard):
            continue
        n, d, size = dm.size(mdim), pl.dim, t.shape[pl.dim]
        piece = -(-size // n)  # torch.chunk's piece
        padded = out.new_zeros((piece,) + tuple(out.shape[:d]) + tuple(out.shape[d + 1:]))
        padded[:out.shape[d]] = out.movedim(d, 0)
        joined = out.new_empty((n * piece,) + tuple(padded.shape[1:]))
        dist.all_gather_into_tensor(joined, padded.contiguous(), group=dm.get_group(mdim))
        out = joined[:size].movedim(0, d)
    return out.contiguous()


def local_piece(full: torch.Tensor, like: torch.Tensor, kind: Optional[str], mesh,
                ep: bool = False):
    """This rank's part of the whole tensor `full`, laid out as `like` (a
    parameter of the sharded model, or one of its DTensors): with `ep` this
    ep rank's experts, the tp slice, then a DTensor's shard, returned as a
    DTensor like `like`."""
    t = full
    if ep and mesh is not None and mesh.size("ep") > 1:
        t = t.chunk(mesh.size("ep"))[mesh.index("ep")]
    if kind is not None and mesh is not None and mesh.size("tp") > 1:
        from ucf_vit_tpu_torch.models.blocks import tp_slice

        t = tp_slice(t, kind, mesh.index("tp"), mesh.size("tp"))
    t = t.to(like.device, like.dtype)
    if not hasattr(like, "to_local"):
        return t.clone()
    from torch.distributed.tensor import DTensor, Shard

    dm, coord = like.device_mesh, like.device_mesh.get_coordinate()
    for dim, pl in enumerate(like.placements):
        if isinstance(pl, Shard):  # torch.chunk's split, as FSDP shards
            chunks = t.chunk(dm.size(dim), dim=pl.dim)
            t = chunks[coord[dim]] if coord[dim] < len(chunks) else t.narrow(pl.dim, 0, 0)
    return DTensor.from_local(t.contiguous().clone(), dm, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def data_layout(mesh) -> Tuple[int, int]:
    """(data rank, data size) of this process: (0, 1) on one device."""
    return (0, 1) if mesh is None else (mesh.data_rank, mesh.data_size)


def saved_data_size(payload: dict) -> Optional[int]:
    """The number of data ranks that wrote a checkpoint; None for a sharded file
    written before the data layout was recorded (its `num_procs` counts the
    tp ranks too)."""
    if "data_size" in payload:
        return int(payload["data_size"])
    return 1 if int(payload.get("num_procs", 1)) == 1 else None


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every tensor whole, on every rank (a sharded
    model's ranks must all call it)."""
    mesh, layout, ep = _mesh(model), _layout(model), _ep(model)
    return {k: gather_full(v, layout.get(k), mesh, k in ep)
            for k, v in model.state_dict().items()}


def _full_shapes(model: torch.nn.Module) -> Dict[str, tuple]:
    """The whole shape of each `state_dict` entry of a (sharded) model."""
    from ucf_vit_tpu_torch.models.blocks import TP_DIM

    mesh, layout, ep = _mesh(model), _layout(model), _ep(model)
    out = {}
    for k, v in model.state_dict().items():
        shape = list(v.shape)  # a DTensor's is the whole one over the data axes
        kind = layout.get(k)
        if kind is not None and mesh is not None:
            shape[TP_DIM.get(kind, 0)] *= mesh.size("tp")
        if k in ep and mesh is not None:
            shape[0] *= mesh.size("ep")
        out[k] = tuple(shape)
    return out


def _ckpt_file(checkpoint_path: str, filename: str, epoch: int) -> str:
    parity = "even" if epoch % 2 == 0 else "odd"
    return os.path.abspath(os.path.join(checkpoint_path, f"{filename}_{parity}{SUFFIX}"))


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _optimizer_state_cpu(sd: dict) -> dict:
    state = {i: {k: (v.detach().to("cpu", copy=True) if torch.is_tensor(v) else v)
                 for k, v in s.items()} for i, s in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def save_checkpoint(
    checkpoint_path: str,
    filename: str,
    epoch: int,
    state,
    loss_list: Iterable[float] = (),
    head_meta: Optional[Tuple[int, int]] = None,
    total_steps: int = 0,
    data_it: int = 0,
    slot_epoch: Optional[int] = None,
) -> str:
    """Write `state` (a `parallel.train_step.TrainState`) to the even/odd slot
    of `epoch`, or of `slot_epoch` when given, while `epoch` stays what resume
    reads. The preemption save passes the interrupted epoch as both, so that
    it overwrites the older slot and never the last committed epoch's
    (`ucf_vit_tpu/checkpoint.py:67-100`). Returns the file's path."""
    path = _ckpt_file(checkpoint_path, filename, epoch if slot_epoch is None else slot_epoch)
    model, mesh = state.model, _mesh(state.model)
    gens = None
    if getattr(model, "generator", None) is not None:
        gens = {"device": model.generator.get_state(),
                "host": model.host_generator.get_state(),
                "device_by_data_rank": [model.generator.get_state()]}
        if mesh is not None:
            by_rank = [None] * mesh.world
            dist.all_gather_object(by_rank, (mesh.data_rank, gens["device"]))
            gens["device_by_rank"] = [g for _, g in by_rank]
            by_data = [None] * mesh.data_size
            for data_rank, g in by_rank:  # a data rank's tp ranks hold the same
                if by_data[data_rank] is None:
                    by_data[data_rank] = g
            gens["device_by_data_rank"] = by_data
    if mesh is None:
        model_sd, opt_sd = model.state_dict(), state.optimizer.adamw.state_dict()
        ema = state.ema_params
    else:
        model_sd, opt_sd, ema = _gathered_state(state)
    if mesh is not None and dist.get_rank() != 0:
        dist.barrier()  # rank 0 writes; the others wait for the file
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "model_state_dict": _cpu(model_sd),
        "loss_list": [float(v) for v in loss_list],
        "optimizer_state_dict": _optimizer_state_cpu(opt_sd),
        "optimizer_count": int(state.optimizer.count),
        "step": int(state.step),
        "loss_scale": (None if state.loss_scale is None else
                       {"scale": float(state.loss_scale.scale),
                        "growth_counter": int(state.loss_scale.growth_counter)}),
        "ema_state_dict": None if ema is None else _cpu(ema),
        "total_steps": int(total_steps),
        "head_meta": None if head_meta is None else [int(v) for v in head_meta],
        "generators": gens,
        "data_it": int(data_it),
        "num_procs": 1 if mesh is None else mesh.world,
        "data_size": data_layout(mesh)[1],
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
        if mesh is not None:
            dist.barrier()
    return path


def _param_names(state) -> list:
    """The names of AdamW's parameters in its `state_dict` index order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.adamw.param_groups for p in g["params"]]


def _gathered_state(state):
    """(model, AdamW and EMA state dicts) of a sharded state, every tensor
    whole on every rank."""
    model, mesh, layout, ep = (state.model, _mesh(state.model), _layout(state.model),
                               _ep(state.model))
    model_sd = full_state_dict(model)
    sd = state.optimizer.adamw.state_dict()
    names = _param_names(state)
    opt_state = {}
    for i, st in sd["state"].items():
        kind = layout.get(names[i])
        opt_state[i] = {k: (gather_full(v, kind, mesh, names[i] in ep) if v.ndim
                            else gather_full(v, None, mesh)) if torch.is_tensor(v) else v
                        for k, v in st.items()}
    ema = None
    if state.ema_params is not None:
        ema = {n: gather_full(v, layout.get(n), mesh, n in ep)
               for n, v in state.ema_params.items()}
    return model_sd, {"state": opt_state, "param_groups": sd["param_groups"]}, ema


def _load(path: str) -> dict:
    """The payload, its tensors mapped from the file rather than read."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def stored_epoch(path: str) -> int:
    """The epoch recorded in a checkpoint file (the tensors are mapped, not
    read)."""
    return int(_load(path).get("epoch", 0))


def _is_orbax_dir(p: str) -> bool:
    return os.path.isdir(p) and os.path.exists(os.path.join(p, "_CHECKPOINT_METADATA"))


def _newest(cands) -> str:
    """The candidate with the larger stored epoch; mtime breaks ties."""
    return max(cands, key=lambda c: (stored_epoch(c), os.path.getmtime(c)))


def resolve_slot(checkpoint_path: str, filename_for_loading: str) -> str:
    """The checkpoint file that `filename_for_loading` names under
    `checkpoint_path`, or `checkpoint_path` itself when it is a file. A
    trailing `_latest` picks the even/odd slot with the larger stored epoch
    (mtime breaks ties). An empty name picks the checkpoint file with the
    largest stored epoch. A name without the `.ckpt` suffix finds the file
    with it."""
    base = os.path.abspath(checkpoint_path)
    if os.path.isfile(base):
        return base
    if not filename_for_loading:
        cands = [os.path.join(base, f) for f in (os.listdir(base) if os.path.isdir(base) else [])
                 if f.endswith(SUFFIX)]
        cands = [c for c in cands if os.path.isfile(c)]
        if not cands:
            raise FileNotFoundError(f"no checkpoint files (*{SUFFIX}) under {checkpoint_path}")
        return _newest(cands)
    if filename_for_loading.endswith("_latest"):
        stem = filename_for_loading[: -len("_latest")]
        cands = [os.path.join(base, f"{stem}_{p}{SUFFIX}") for p in ("even", "odd")]
        cands = [c for c in cands if os.path.isfile(c)]
        if not cands:
            raise FileNotFoundError(f"no {stem}_even/_odd checkpoint under {checkpoint_path}")
        return _newest(cands)
    resolved = os.path.join(base, filename_for_loading)
    for p in (resolved, resolved + SUFFIX):
        if os.path.isfile(p):
            return p
    if _is_orbax_dir(resolved):
        raise ValueError(
            f"{resolved} is an Orbax checkpoint directory of the JAX package, which the "
            "port does not read. Convert it first:\n  python -m "
            "ucf_vit_tpu.tools.convert_checkpoint to-torch <ckpt_path> <ckpt_filename> "
            "<config.yaml> <out.ckpt>\nand point the port at <out.ckpt>.")
    present = sorted(os.listdir(base)) if os.path.isdir(base) else "none (path missing)"
    raise FileNotFoundError(f"no checkpoint at {resolved}. Present under "
                            f"{checkpoint_path}: {present}")


def head_meta_from_config(cfg) -> Tuple[int, int]:
    """The [num_heads, decoder_num_heads] the built model runs with (the
    build defaults: 12 heads; 16 decoder heads for the two decoder-bearing
    tasks; decoder-less tasks stamp 0)."""
    dec = (int(cfg.init_args.get("decoder_num_heads", 16))
           if cfg.task in ("mae", "diffusion") else 0)
    return (int(cfg.init_args.get("num_heads", 12)), dec)


def check_head_meta(payload: dict, expect) -> None:
    """Refuse a checkpoint trained under another attention-head grouping.
    Head counts at one embed_dim give identical parameter shapes, so such a
    checkpoint would load and silently compute another function. A None
    entry in `expect` skips that position."""
    got = payload.get("head_meta")
    if expect is None or got is None:
        return
    got = [int(v) for v in got]
    want = [None if v is None else int(v) for v in expect]
    if any(w is not None and g != w for g, w in zip(got, want)):
        raise ValueError(
            f"checkpoint was trained with [num_heads, decoder_num_heads] = {got} but the "
            f"config now says {want}. Head regrouping keeps parameter shapes but changes "
            "the function, so loading it would silently corrupt the model. Restore with "
            "the original head counts, or start a fresh run.")


def restore_checkpoint(checkpoint_path: str, filename_for_loading: str,
                       expect_head_meta=None) -> dict:
    """The payload of the slot `resolve_slot` finds, its tensors on the CPU,
    after the head-grouping guard. A file that `to-torch` wrote has only
    `epoch`, `model_state_dict` and `loss_list`."""
    payload = _load(resolve_slot(checkpoint_path, filename_for_loading))
    if "model_state_dict" not in payload:
        raise ValueError(f"{checkpoint_path}/{filename_for_loading}: no model_state_dict")
    check_head_meta(payload, expect_head_meta)
    return payload


def check_state_dict(model: torch.nn.Module, sd: Dict[str, torch.Tensor], what: str) -> None:
    """Raise unless `sd` has exactly the model's names and (whole) shapes."""
    own = _full_shapes(model)
    missing, unused = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if missing or unused:
        raise ValueError(f"{what} does not match the model: missing {missing[:5]}, "
                         f"unused {unused[:5]}")
    for k, shape in own.items():
        if tuple(sd[k].shape) != shape:
            raise ValueError(f"{what}: {k} has shape {tuple(sd[k].shape)}, the model "
                             f"{shape}")


@torch.no_grad()
def load_params(model: torch.nn.Module, sd: Dict[str, torch.Tensor], what: str) -> None:
    """Copy the whole tensors `sd` into the model's parameters in place
    (checked first), cast to each parameter's dtype; a sharded model takes
    each rank's part."""
    check_state_dict(model, sd, what)
    mesh, layout, ep = _mesh(model), _layout(model), _ep(model)
    for k, v in model.state_dict().items():
        if mesh is None:
            v.copy_(sd[k])
        else:
            _local(v).copy_(_local(local_piece(sd[k], v, layout.get(k), mesh, k in ep)))


def restore_train_state(state, payload: dict, ema_decay: Optional[float]) -> None:
    """Put a full checkpoint's training state into `state` in place: the
    parameters, AdamW's moments and update count, the loss scale, the
    generators' states, and EMA reconciled with `ema_decay` (a checkpoint
    without EMA seeds it from its parameters; EMA on disk with EMA off now
    is dropped)."""
    if "optimizer_state_dict" not in payload:
        raise ValueError("the checkpoint holds weights only (no optimizer state): warm "
                         "start from it with trainer.init_params_from instead")
    model, mesh, layout, ep = (state.model, _mesh(state.model), _layout(state.model),
                               _ep(state.model))
    load_params(model, payload["model_state_dict"], "checkpoint")
    opt_sd = payload["optimizer_state_dict"]
    if mesh is not None:  # each moment as its parameter is sharded here
        params = dict(model.named_parameters())
        names = _param_names(state)
        opt_sd = {"param_groups": opt_sd["param_groups"], "state": {
            i: {k: (local_piece(v, params[names[int(i)]], layout.get(names[int(i)]), mesh,
                                names[int(i)] in ep)
                    if torch.is_tensor(v) and v.ndim else v) for k, v in st.items()}
            for i, st in opt_sd["state"].items()}}
    state.optimizer.adamw.load_state_dict(opt_sd)
    state.optimizer.count = int(payload["optimizer_count"])
    state.step = int(payload["step"])
    ls = payload["loss_scale"]
    if state.loss_scale is not None and ls is not None:
        state.loss_scale = type(state.loss_scale)(scale=float(ls["scale"]),
                                                  growth_counter=int(ls["growth_counter"]))
    gens = payload.get("generators")
    if gens is not None and getattr(model, "generator", None) is not None:
        data_rank, data_size = data_layout(mesh)
        saved = saved_data_size(payload)
        if saved == data_size:
            by_data = gens.get("device_by_data_rank") or [gens["device"]]
            model.generator.set_state(by_data[data_rank])
        else:  # another data layout: the device generators stay as seeded for this one
            print(f"device generators written by {saved or 'an unrecorded number of'} data "
                  f"ranks, this run has {data_size}: kept as seeded", flush=True)
        model.host_generator.set_state(gens["host"])
    ema = payload.get("ema_state_dict")
    if ema_decay is None:
        if ema is not None:
            print("dropped checkpoint EMA state (ema_decay not set)", flush=True)
        state.ema_params = None
    elif ema is None:
        state.ema_params = {n: p.detach().clone() for n, p in model.named_parameters()}
        print("seeded EMA from restored params (checkpoint predates ema_decay)", flush=True)
    else:
        check_state_dict(model, ema, "checkpoint EMA state")
        state.ema_params = {n: local_piece(ema[n], p.detach(), layout.get(n), mesh, n in ep)
                            for n, p in model.named_parameters()}


# MAE entries that a transfer never copies: the decoder and the mask token
_MAE_ONLY = ("decoder_", "mask_token")


def transfer_mae_encoder(mae_state: Dict[str, torch.Tensor], target_state: Dict[str, torch.Tensor],
                         new_pos_embed_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A copy of `target_state` (a UNETR's or SAP's `state_dict`) with every
    entry of an MAE's `mae_state` that the target holds at the same shape, the
    MAE's decoder and mask token left out (`ucf_vit_tpu/checkpoint.py:358-392`).
    With `new_pos_embed_len`, a `[1, L, D]` position table of another length
    is first resampled linearly to the target's (`interpolate_pos_embed_1d`).
    Entries of the target that the MAE lacks keep their values."""
    from ucf_vit_tpu_torch.ops.pos_embed import interpolate_pos_embed_1d

    out = {k: v.detach().clone() for k, v in target_state.items()}
    for k, v in mae_state.items():
        if any(seg.startswith(_MAE_ONLY) for seg in k.split(".")) or k not in out:
            continue
        dst = out[k]
        if ("pos_embed" in k.split(".")[-1] and new_pos_embed_len is not None
                and v.ndim == 3 and v.shape[1] != dst.shape[1]):
            v = torch.from_numpy(np.ascontiguousarray(
                interpolate_pos_embed_1d(v.detach().cpu().numpy(), dst.shape[1])))
        if tuple(v.shape) == tuple(dst.shape):
            out[k] = v.detach().to(dst.device, dst.dtype).clone()
    return out
