"""AdamW with the warmup-cosine schedule, and dynamic loss scaling (port of
`ucf_vit_tpu/utils/optim.py`).

`configure_optimizer` builds what the JAX package's optax chain does
(`clip_by_global_norm` when `max_grad_norm` is set, then `adamw` with the
schedule and the no-decay mask): `torch.optim.AdamW` (eps 1e-8, weight decay
passed explicitly, since torch's default is 1e-2) over two parameter groups,
with the learning rate of update k (0-based) set to `schedule(k)` before it,
as optax's count gives it. The clip is optax's, written by hand: every
gradient times min(1, max_norm / global_norm) (`clip_grad_norm_` adds 1e-6
to the norm and would differ).

The loss-scale state (`:111-153`) is host-side Python: the train step reads
whether the gradients are finite once per step when it is on.

Under a mesh (`sharding`, set by `parallel.train_step.create_train_state`)
a gradient may be a piece: FSDP's shard of its parameter over fsdp (a
DTensor), a tensor-parallel parameter's slice over tp, an expert leaf's
experts over ep. The clip's norm then sums each rank's local squares over
fsdp, and those of the leaves split over tp or ep over that axis as well, so
that every element of the whole gradient counts once
(`clip_by_global_norm_`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

NO_DECAY_SUBSTRINGS = ("var_embed", "pos_embed", "time_pos_embed")

Schedule = Callable[[int], float]


def warmup_cosine_schedule(
    lr: float,
    warmup_steps: int,
    max_steps: int,
    warmup_start_lr: float = 0.0,
    eta_min: float = 0.0,
) -> Schedule:
    """Closed form of the reference LinearWarmupCosineAnnealingLR: linear
    from warmup_start_lr to lr over warmup_steps (slope (lr -
    warmup_start_lr) / (warmup_steps - 1)), then cosine to eta_min at
    max_steps. Computed in f32 in the JAX package's order of operations."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            if warmup_steps > 1:
                return float(f32(warmup_start_lr)
                             + step * f32(lr - warmup_start_lr) / f32(warmup_steps - 1))
            return float(f32(lr))
        denom = f32(max(max_steps - warmup_steps, 1))
        t = np.clip((step - f32(warmup_steps)) / denom, f32(0.0), f32(1.0))
        cos = f32(eta_min) + f32(0.5 * (lr - eta_min)) * (f32(1.0) + np.cos(f32(math.pi) * t))
        return float(cos)

    return schedule


def _no_decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """True where weight decay applies, by `state_dict` name (the reference's
    substring rule, inverted)."""
    return {name: not any(s in name for s in NO_DECAY_SUBSTRINGS)
            for name, _ in model.named_parameters()}


class Optimizer:
    """AdamW + warmup-cosine (+ global-norm clip): the port of the optax chain
    `configure_optimizer` returns. `step()` applies one update from the
    gradients in `.grad`; `count` is optax's update count, which the
    schedule reads and which a skipped (overflow) step does not advance."""

    def __init__(self, model: torch.nn.Module, beta_1: float, beta_2: float,
                 weight_decay: float, schedule: Schedule, max_grad_norm: Optional[float]):
        # (mesh, {id(parameter): the axes of tp and ep it is split over}), from
        # parallel.train_step
        self.sharding: Optional[Tuple] = None
        mask = _no_decay_mask(model)
        params = dict(model.named_parameters())
        groups = [
            {"params": [p for n, p in params.items() if mask[n]], "weight_decay": weight_decay},
            {"params": [p for n, p in params.items() if not mask[n]], "weight_decay": 0.0},
        ]
        self.adamw = torch.optim.AdamW([g for g in groups if g["params"]], lr=schedule(0),
                                       betas=(beta_1, beta_2), eps=1e-8,
                                       weight_decay=weight_decay)
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0

    def step(self) -> None:
        params = [p for g in self.adamw.param_groups for p in g["params"] if p.grad is not None]
        if self.max_grad_norm is not None:
            if self.sharding is None:
                clip_by_global_norm_([p.grad for p in params], self.max_grad_norm)
            else:
                mesh, axes = self.sharding
                clip_by_global_norm_([p.grad for p in params], self.max_grad_norm, mesh=mesh,
                                     split=[axes.get(id(p), ()) for p in params])
        lr = self.schedule(self.count)
        for g in self.adamw.param_groups:
            g["lr"] = lr
        self.adamw.step()
        self.count += 1


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of `t`: a DTensor's local shard, else `t` itself."""
    return t.to_local() if hasattr(t, "to_local") else t


# the splits a leaf's gradient can have over (tp, ep), in the order of the
# clip's partial sums
_SPLITS = ((), ("tp",), ("ep",), ("tp", "ep"))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float, mesh=None,
                         split: Optional[List[Tuple[str, ...]]] = None) -> None:
    """optax's clip_by_global_norm in place: g * min(1, max_norm / ||g||), with
    no host synchronisation. Under `mesh` the norm is that of the whole
    sharded gradient: the local squares summed over fsdp (FSDP's shards), and
    over tp and ep too for the leaves `split` marks so (each leaf's axes of
    the two); a leaf replicated over an axis counts once."""
    if not grads:
        return
    if mesh is None:
        norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
    else:
        import torch.distributed as dist

        split = [tuple(a for a in ("tp", "ep") if a in s) for s in (split or [()] * len(grads))]
        sq = [local(g).float().pow(2).sum() for g in grads]
        zero = sq[0].new_zeros(())
        parts = torch.stack([sum((q for q, s in zip(sq, split) if s == kind), zero)
                             for kind in _SPLITS])
        if mesh.size("fsdp") > 1 and any(hasattr(g, "to_local") for g in grads):
            dist.all_reduce(parts, group=mesh.group("fsdp"))
        for axis in ("tp", "ep"):
            if mesh.size(axis) > 1 and any(axis in s for s in split):
                rows = [i for i, kind in enumerate(_SPLITS) if axis in kind]
                part = parts[rows].clone()
                dist.all_reduce(part, group=mesh.group(axis))
                parts = parts.index_copy(0, torch.tensor(rows, device=parts.device), part)
        norm = torch.sqrt(parts.sum())
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        local(g).mul_(factor.to(g.dtype))


def configure_optimizer(
    model: torch.nn.Module,
    lr: float,
    beta_1: float = 0.9,
    beta_2: float = 0.95,
    weight_decay: float = 1e-5,
    warmup_steps: int = 1000,
    max_steps: int = 20000,
    warmup_start_lr: float = 1e-8,
    eta_min: float = 1e-8,
    max_grad_norm: Optional[float] = None,
) -> Optimizer:
    """AdamW + warmup-cosine with the reference's no-decay parameter grouping."""
    schedule = warmup_cosine_schedule(lr, warmup_steps, max_steps, warmup_start_lr, eta_min)
    return Optimizer(model, beta_1, beta_2, weight_decay, schedule, max_grad_norm)


class LossScaleState(NamedTuple):
    scale: float  # current loss scale
    growth_counter: int  # consecutive finite steps


def init_loss_scale(init_scale: float = 8192.0) -> LossScaleState:
    return LossScaleState(scale=float(init_scale), growth_counter=0)


def update_loss_scale(
    state: LossScaleState,
    grads_finite: bool,
    growth_interval: int = 100,
    growth_factor: float = 2.0,
    backoff_factor: float = 0.5,
    min_scale: float = 128.0,
    max_scale: float = 2.0**24,
) -> LossScaleState:
    """Grow after `growth_interval` finite steps, back off (floored at
    min_scale) on overflow (ShardedGradScaler(init_scale=8192,
    growth_interval=100) plus the reference's min_scale=128 floor)."""
    counter = state.growth_counter + 1 if grads_finite else 0
    grow = counter >= growth_interval
    if grads_finite:
        scale = min(state.scale * growth_factor, max_scale) if grow else state.scale
    else:
        scale = max(state.scale * backoff_factor, min_scale)
    return LossScaleState(scale=float(np.float32(scale)), growth_counter=0 if grow else counter)


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """A bool tensor: every element of every tensor (of a DTensor, its local
    shard: the train step agrees the flag over the ranks) is finite."""
    flags = [torch.isfinite(local(t)).all() for t in tensors]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()
