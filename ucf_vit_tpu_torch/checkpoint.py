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
                          step's torch.Generators (the port's rng_key)
    data_it               batches of `epoch` already trained on: 0 after
                          an epoch's end; a preemption save mid-epoch
                          records its position, and resume re-enters the
                          epoch there
    num_procs             the processes that wrote it (1: the port runs one)

The first three keys are what `python -m
ucf_vit_tpu.tools.convert_checkpoint to-jax` reads, so a port checkpoint
converts unchanged; the file that its `to-torch` writes (those three keys)
loads here as weights. Orbax directories are not read: convert them with
`to-torch` first.

`transfer_mae_encoder` starts a UNETR (or SAP) from an MAE checkpoint's
encoder (`ucf_vit_tpu/checkpoint.py:358`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

SUFFIX = ".ckpt"


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
    os.makedirs(os.path.dirname(path), exist_ok=True)
    model = state.model
    gens = None
    if getattr(model, "generator", None) is not None:
        gens = {"device": model.generator.get_state(),
                "host": model.host_generator.get_state()}
    payload = {
        "epoch": int(epoch),
        "model_state_dict": _cpu(model.state_dict()),
        "loss_list": [float(v) for v in loss_list],
        "optimizer_state_dict": _optimizer_state_cpu(state.optimizer.adamw.state_dict()),
        "optimizer_count": int(state.optimizer.count),
        "step": int(state.step),
        "loss_scale": (None if state.loss_scale is None else
                       {"scale": float(state.loss_scale.scale),
                        "growth_counter": int(state.loss_scale.growth_counter)}),
        "ema_state_dict": None if state.ema_params is None else _cpu(state.ema_params),
        "total_steps": int(total_steps),
        "head_meta": None if head_meta is None else [int(v) for v in head_meta],
        "generators": gens,
        "data_it": int(data_it),
        "num_procs": 1,
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


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
    """Raise unless `sd` has exactly the model's names and shapes."""
    own = model.state_dict()
    missing, unused = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if missing or unused:
        raise ValueError(f"{what} does not match the model: missing {missing[:5]}, "
                         f"unused {unused[:5]}")
    for k, v in own.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(sd[k].shape)}, the model "
                             f"{tuple(v.shape)}")


@torch.no_grad()
def load_params(model: torch.nn.Module, sd: Dict[str, torch.Tensor], what: str) -> None:
    """Copy `sd` into the model's parameters in place (checked first), cast
    to each parameter's dtype."""
    check_state_dict(model, sd, what)
    for k, v in model.state_dict().items():
        v.copy_(sd[k])


def restore_train_state(state, payload: dict, ema_decay: Optional[float]) -> None:
    """Put a full checkpoint's training state into `state` in place: the
    parameters, AdamW's moments and update count, the loss scale, the
    generators' states, and EMA reconciled with `ema_decay` (a checkpoint
    without EMA seeds it from its parameters; EMA on disk with EMA off now
    is dropped)."""
    if "optimizer_state_dict" not in payload:
        raise ValueError("the checkpoint holds weights only (no optimizer state): warm "
                         "start from it with trainer.init_params_from instead")
    model = state.model
    load_params(model, payload["model_state_dict"], "checkpoint")
    state.optimizer.adamw.load_state_dict(payload["optimizer_state_dict"])
    state.optimizer.count = int(payload["optimizer_count"])
    state.step = int(payload["step"])
    ls = payload["loss_scale"]
    if state.loss_scale is not None and ls is not None:
        state.loss_scale = type(state.loss_scale)(scale=float(ls["scale"]),
                                                  growth_counter=int(ls["growth_counter"]))
    gens = payload.get("generators")
    if gens is not None and getattr(model, "generator", None) is not None:
        model.generator.set_state(gens["device"])
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
        state.ema_params = {n: ema[n].to(p.device, p.dtype).clone()
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
