"""Train state and the generic train step (port of
`ucf_vit_tpu/parallel/train_step.py`, on one device).

`make_train_step` covers what the JAX step does (`:229-350`): gradient
accumulation over microbatches, dynamic loss scaling that skips the whole
update on overflow (the optimizer's update count, which the schedule reads,
does not advance either: JAX merges the old optax state back, `:312-338`),
and the EMA of the parameters. PyTorch runs eagerly, so the step is a plain
function; it updates the model and optimizer in place where JAX returns a
new state.

Sharded state creation (`create_sharded_train_state`,
`logical_state_sharding`) is single-device here: sharding is ROADMAP.md's
data/tensor-parallel item. `offload_opt` is not ported: the JAX package keeps
it as a measured-and-rejected study artifact that no config reaches
(`:125-137`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ucf_vit_tpu_torch.utils.optim import (
    LossScaleState,
    Optimizer,
    Schedule,
    all_finite,
    init_loss_scale,
    update_loss_scale,
)

LossFn = Callable[[torch.nn.Module, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict]]


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: Optimizer
    loss_scale: Optional[LossScaleState] = None
    # exponential moving average of the parameters by name (trainer.ema_decay)
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def schedule(self) -> Schedule:
        return self.optimizer.schedule


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       use_grad_scaler: bool = False, init_scale: float = 8192.0,
                       ema: bool = False) -> TrainState:
    """The state at step 0 (the single-device `create_sharded_train_state`)."""
    return TrainState(
        step=0,
        model=model,
        optimizer=optimizer,
        loss_scale=init_loss_scale(init_scale) if use_grad_scaler else None,
        ema_params=({n: p.detach().clone() for n, p in model.named_parameters()}
                    if ema else None),
    )


def _split(batch: Dict[str, torch.Tensor], n: int):
    for key, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} of {key!r} not divisible by accum_steps "
                             f"{n}: samples would be silently dropped")
    return [{k: x.chunk(n)[i] for k, x in batch.items()} for i in range(n)]


def make_train_step(loss_fn: LossFn, optimizer: Optimizer, accum_steps: int = 1,
                    ema_decay: Optional[float] = None):
    """Build `step(state, batch, var_ids=None) -> (state, loss, aux)` for a
    state made with this `optimizer`.

    `loss_fn(model, batch) -> (loss, aux)`; given `var_ids` (the batch's
    variables for a model with `use_varemb`), `loss_fn(model, batch,
    var_ids=var_ids)`. The step leaves this step's
    (unscaled, clipped) gradients in each parameter's `.grad` until the next
    step starts, and returns the loss and aux as device tensors, so the
    caller decides when to synchronise."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(state: TrainState, batch: Dict[str, torch.Tensor], var_ids=None):
        model = state.model
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        scale = state.loss_scale.scale if state.loss_scale is not None else None
        micro = _split(batch, accum_steps) if accum_steps > 1 else [batch]
        loss_sum, aux_sum = 0.0, None
        for mb in micro:
            loss, aux = (loss_fn(model, mb) if var_ids is None
                         else loss_fn(model, mb, var_ids=var_ids))
            (loss * scale if scale is not None else loss).backward()
            loss_sum = loss_sum + loss.detach()
            aux = {k: v.detach() for k, v in (aux or {}).items()}
            aux_sum = aux if aux_sum is None else {k: aux_sum[k] + aux[k] for k in aux}
        loss = loss_sum / accum_steps if accum_steps > 1 else loss_sum
        aux = {k: v / accum_steps for k, v in aux_sum.items()} if accum_steps > 1 else aux_sum

        with torch.no_grad():
            grads = [p.grad for p in params if p.grad is not None]
            if accum_steps > 1:
                for g in grads:
                    g.div_(accum_steps)
            apply = True
            if state.loss_scale is not None:
                for g in grads:
                    g.mul_(1.0 / scale)
                finite = bool(all_finite(grads))  # one host sync per step
                state.loss_scale = update_loss_scale(state.loss_scale, finite)
                apply = finite  # overflow: skip params, optimizer count and EMA
            if apply:
                optimizer.step()
                if ema_decay is not None and state.ema_params is not None:
                    for name, p in model.named_parameters():
                        state.ema_params[name].mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
        state.step += 1
        return state, loss, aux

    return step
