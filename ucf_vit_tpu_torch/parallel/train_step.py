"""Train state, sharding and the generic train step (port of
`ucf_vit_tpu/parallel/train_step.py`).

`make_train_step` covers what the JAX step does (`:229-350`): gradient
accumulation over microbatches, dynamic loss scaling that skips the whole
update on overflow (the optimizer's update count, which the schedule reads,
does not advance either: JAX merges the old optax state back, `:312-338`),
and the EMA of the parameters. PyTorch runs eagerly, so the step is a plain
function; it updates the model and optimizer in place where JAX returns a
new state.

Sharding (`shard_model`, the counterpart of `create_sharded_train_state` /
`logical_state_sharding`, `:62-228`) puts a model on a mesh
(`parallel/mesh.py`): tensor parallelism first (`models.blocks.
shard_tensor_parallel` over the tp group, by the JAX `kernel_axes`), then the
data axes. With fsdp > 1 every transformer block and then the model are
wrapped by `torch.distributed.fsdp.fully_shard` on the `(ddp, fsdp)` submesh:
ZeRO-3 over fsdp, replicated over ddp (HSDP), the parameters DTensors whose
local shard is all a rank keeps between steps; AdamW's moments and the EMA,
made from those parameters, are sharded alike (the JAX `_rebox_opt_state`,
`:94-123`). FSDP gathers a block's parameters before its forward, and again
before the recompute that `remat` runs in the backward, and frees them after;
the gradients are reduce-scattered, averaged over the data ranks. With fsdp 1
and ddp > 1 the parameters stay whole and the step averages the gradients
over the data group itself, one all-reduce per bucket after the last
microbatch: plain DDP, on nothing but all-reduce. Under FSDP the
microbatches but the last skip the gradient reduction
(`set_requires_gradient_sync`). The loss and aux the step returns are their
means over the data ranks, the global batch's; a loss scale's overflow flag
is agreed by every rank, so that no rank skips a step another takes.

Sequence parallelism (sp > 1): the parameters are replicated over sp, and
the sp ranks of one data rank run the same batch, each its own slice of
every block stack's tokens (`models/vit.py`). Each rank backpropagates
`loss / sp`, so that every gradient it holds is a partial sum over the sp
group (its tokens' share inside the split stream, `1/sp` of the rest,
`parallel/collectives.py`), and the step sums the gradients over sp
(`sum_over_sp`) before the clip and the update; the data-axis mean, the
clip's norm (over fsdp and tp) and the overflow agreement are unchanged.

Expert parallelism (ep > 1): `models.moe.shard_expert_parallel` keeps each
ep rank's `E/ep` experts (`model.ep_layout`, the names of the expert leaves)
before tensor parallelism splits their hidden dim. The batch is split over
ddp x ep x fsdp as before, so the dense leaves' gradients are averaged over
all the data ranks. An expert leaf's gradient already sums the tokens of
every ep rank (the all-to-all's backward brings them to the expert's rank),
so it is summed over the non-ep data ranks (ddp x fsdp, over which its rank's
experts are replicated) and divided by the whole data size: the extra `1/ep`
makes it a mean over the global batch, as the dense leaves'. Under FSDP the
Blocks are sharded on the (ddp, fsdp) submesh, whose reduction averages over
those ranks alone: the step then averages the dense leaves' shards over ep
and divides the expert leaves' by ep (`_reduce_over_ep`). The clip's norm
sums the expert leaves' squares over ep, and the sync check compares them
within an ep index.

With gradient accumulation the JAX step splits the global batch into
microbatches (`:260-291`); a data rank's local chunks make other microbatches
of the same rows, which is the same step wherever the loss is a mean over
samples. A model whose loss is not (`couples_samples`: the MoE aux is a
product of batch means) has the global batch gathered over the data group
first (`global_microbatches`), so that each rank's chunks are its shares of
the global microbatches, those of the JAX step and of one device.

`offload_opt` is not ported: the JAX package keeps it as a
measured-and-rejected study artifact that no config reaches (`:125-137`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ucf_vit_tpu_torch.parallel.mesh import Mesh, mesh_context
from ucf_vit_tpu_torch.utils.optim import (
    LossScaleState,
    Optimizer,
    Schedule,
    all_finite,
    init_loss_scale,
    local,
    update_loss_scale,
)

# gradients averaged over the data ranks in buckets of at most this many bytes
# (plain DDP): bounds the flat copy that one all-reduce takes
DDP_BUCKET_BYTES = 64 << 20

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

    @property
    def mesh(self) -> Optional[Mesh]:
        """The mesh the model is sharded on (`shard_model`); None on one device."""
        return getattr(self.model, "mesh", None)


def is_fsdp(model: torch.nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def shard_model(model: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Put `model` (whole, the same weights on every rank) on `mesh` in
    place: the experts over ep, tensor parallelism over tp, then FSDP over
    (ddp, fsdp) when fsdp > 1. Sets `model.mesh`, `model.ep_layout` (the
    names of the expert leaves split over ep; empty without ep) and
    `model.tp_layout` ({name: split} of the tensor-parallel parameters; empty
    without tp), which the checkpoint reads. Build the optimizer after
    this."""
    from ucf_vit_tpu_torch.models.blocks import Block, shard_tensor_parallel
    from ucf_vit_tpu_torch.models.moe import shard_expert_parallel

    model.mesh, model.tp_layout, model.ep_layout = mesh, {}, set()
    if mesh is None:
        return model
    if mesh.size("pp") > 1:
        raise NotImplementedError("pp > 1 is not ported yet (ROADMAP.md, modules to port, "
                                  "item 12: pipeline)")
    model.ep_layout = shard_expert_parallel(model, mesh)
    if mesh.size("tp") > 1:
        model.tp_layout = shard_tensor_parallel(model, mesh.group("tp"), mesh.index("tp"),
                                                mesh.size("tp"))
    if mesh.size("fsdp") > 1:
        from torch.distributed.fsdp import fully_shard

        dp = mesh.fsdp_mesh()
        for m in model.modules():
            if isinstance(m, Block):
                fully_shard(m, mesh=dp)
        fully_shard(model, mesh=dp)
    return model


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       use_grad_scaler: bool = False, init_scale: float = 8192.0,
                       ema: bool = False) -> TrainState:
    """The state at step 0 (`create_sharded_train_state`): for a model that
    `shard_model` put on a mesh, the optimizer learns which parameters are
    split over tp and over ep, for the clip's norm."""
    mesh = getattr(model, "mesh", None)
    if mesh is not None:
        optimizer.sharding = (mesh, split_axes(model))
    return TrainState(
        step=0,
        model=model,
        optimizer=optimizer,
        loss_scale=init_loss_scale(init_scale) if use_grad_scaler else None,
        ema_params=({n: p.detach().clone() for n, p in model.named_parameters()}
                    if ema else None),
    )


def split_axes(model: torch.nn.Module) -> Dict[int, Tuple[str, ...]]:
    """{id(parameter): the axes of tp and ep it is split over} of a sharded
    model's parameters that are split over either."""
    tp, ep = getattr(model, "tp_layout", {}), getattr(model, "ep_layout", set())
    out = {}
    for n, p in model.named_parameters():
        axes = tuple(a for a, names in (("tp", tp), ("ep", ep)) if n in names)
        if axes:
            out[id(p)] = axes
    return out


def _check_divides(batch: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    for key, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} of {key!r} not divisible by accum_steps "
                             f"{n}: samples would be silently dropped")
    return batch


def _split(batch: Dict[str, torch.Tensor], n: int):
    _check_divides(batch, n)
    return [{k: x.chunk(n)[i] for k, x in batch.items()} for i in range(n)]


def global_microbatches(batch: Dict[str, torch.Tensor], mesh: Mesh, a: int):
    """This data rank's slice of the global batch replaced by its shares of
    the global batch's `a` microbatches, in order (`_split` then gives
    microbatch i's share as chunk i): the microbatches of the JAX step
    (`ucf_vit_tpu/parallel/train_step.py:260-291`) and of one device. Every
    rank gathers the whole global batch, a copy of the inputs alone."""
    n, r = mesh.data_size, mesh.data_rank
    out = {}
    for k, x in _check_divides(batch, a).items():
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
        out[k] = _shares(torch.cat(parts), n, r, a)
    return out


def _shares(whole: torch.Tensor, n: int, r: int, a: int) -> torch.Tensor:
    """Data rank `r`'s shares, in order, of the `a` microbatches of `whole`
    (the global batch of `n` data ranks in rank order): global row
    `(i n + r) q + j` is row j of its share of microbatch i."""
    return whole.view(a, n, -1, *whole.shape[1:])[:, r].flatten(0, 1)


def average_gradients(params: List[torch.Tensor], group, n: int,
                      bucket_bytes: int = DDP_BUCKET_BYTES) -> None:
    """Each `.grad` replaced by its mean over `group` (of `n` ranks), in
    buckets of one dtype and at most `bucket_bytes`: plain DDP's reduction."""
    _reduce_in_buckets([p.grad for p in params if p.grad is not None], group, n,
                       bucket_bytes)


def _reduce_in_buckets(grads: List[torch.Tensor], group, n: int, bucket_bytes: int) -> None:
    """Each of `grads` replaced, in place, by its sum over `group` over `n`."""
    bucket: list = []

    def flush():
        if not bucket:
            return
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        bucket.clear()

    size = 0
    for g in grads:
        if bucket and (g.dtype != bucket[0].dtype
                       or size + g.numel() * g.element_size() > bucket_bytes):
            flush()
            size = 0
        bucket.append(g)
        size += g.numel() * g.element_size()
    flush()


def reduce_over_data(model: torch.nn.Module, params: List[torch.Tensor], mesh: Mesh,
                     fsdp: bool) -> None:
    """The gradients' mean over the global batch: plain DDP averages each
    dense leaf over the data group and sums each expert leaf over the non-ep
    data group, divided by the data size; FSDP has averaged over (ddp, fsdp)
    and `_reduce_over_ep` adds ep."""
    if fsdp:
        _reduce_over_ep(model, params, mesh)
        return
    ep = getattr(model, "ep_layout", set())
    names = {id(p): n for n, p in model.named_parameters()}
    expert = [p.grad for p in params if p.grad is not None and names[id(p)] in ep]
    dense = [p for p in params if p.grad is not None and names[id(p)] not in ep]
    average_gradients(dense, mesh.data_group, mesh.data_size)
    if mesh.expert_data_size > 1:
        _reduce_in_buckets(expert, mesh.expert_data_group, mesh.data_size, DDP_BUCKET_BYTES)
    else:  # the experts' ranks hold no replicas: the whole data size divides alone
        for g in expert:
            g.div_(mesh.data_size)


def _reduce_over_ep(model: torch.nn.Module, params: List[torch.Tensor], mesh: Mesh) -> None:
    """Under FSDP on the (ddp, fsdp) submesh, with ep > 1: each dense leaf's
    local shard averaged over ep, each expert leaf's divided by ep."""
    ep = getattr(model, "ep_layout", set())
    if not ep:
        return
    names = {id(p): n for n, p in model.named_parameters()}
    dense = [local(p.grad) for p in params if p.grad is not None and names[id(p)] not in ep]
    _reduce_in_buckets(dense, mesh.group("ep"), mesh.size("ep"), DDP_BUCKET_BYTES)
    for p in params:
        if p.grad is not None and names[id(p)] in ep:
            local(p.grad).div_(mesh.size("ep"))


def sum_over_sp(params: List[torch.Tensor], mesh: Mesh) -> None:
    """Each `.grad` (its local shard under FSDP) replaced by its sum over
    the sp group, in buckets as plain DDP's mean."""
    _reduce_in_buckets([local(p.grad) for p in params if p.grad is not None],
                       mesh.group("sp"), 1, DDP_BUCKET_BYTES)


def _data_mean(loss: torch.Tensor, aux: Dict[str, torch.Tensor], mesh: Mesh):
    """The loss and aux averaged over the data ranks, in one all-reduce."""
    keys = sorted(aux)
    v = torch.stack([loss.float()] + [aux[k].float() for k in keys])
    dist.all_reduce(v, group=mesh.data_group)
    v = v / mesh.data_size
    return v[0], {k: v[i + 1] for i, k in enumerate(keys)}


def make_train_step(loss_fn: LossFn, optimizer: Optimizer, accum_steps: int = 1,
                    ema_decay: Optional[float] = None):
    """Build `step(state, batch, var_ids=None) -> (state, loss, aux)` for a
    state made with this `optimizer`.

    `loss_fn(model, batch) -> (loss, aux)`; given `var_ids` (the batch's
    variables for a model with `use_varemb`), `loss_fn(model, batch,
    var_ids=var_ids)`. The step leaves this step's
    (unscaled, clipped) gradients in each parameter's `.grad` until the next
    step starts, and returns the loss and aux as device tensors, so the
    caller decides when to synchronise. On a sharded state (`state.mesh`)
    the batch is this rank's slice (`parallel.mesh.shard_batch`), and the
    loss and aux are the global batch's."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(state: TrainState, batch: Dict[str, torch.Tensor], var_ids=None):
        model, mesh = state.model, state.mesh
        fsdp = mesh is not None and is_fsdp(model)
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        scale = state.loss_scale.scale if state.loss_scale is not None else None
        sp = mesh.size("sp") if mesh is not None else 1
        if accum_steps > 1 and mesh is not None and mesh.data_size > 1 and \
                getattr(model, "couples_samples", False):
            batch = global_microbatches(batch, mesh, accum_steps)
        micro = _split(batch, accum_steps) if accum_steps > 1 else [batch]
        loss_sum, aux_sum = 0.0, None
        with mesh_context(mesh):
            for i, mb in enumerate(micro):
                if fsdp:  # one gradient reduction, after the last microbatch
                    model.set_requires_gradient_sync(i == len(micro) - 1)
                loss, aux = (loss_fn(model, mb) if var_ids is None
                             else loss_fn(model, mb, var_ids=var_ids))
                seed = loss * scale if scale is not None else loss
                (seed / sp if sp > 1 else seed).backward()
                loss_sum = loss_sum + loss.detach()
                aux = {k: v.detach() for k, v in (aux or {}).items()}
                aux_sum = aux if aux_sum is None else {k: aux_sum[k] + aux[k] for k in aux}
        loss = loss_sum / accum_steps if accum_steps > 1 else loss_sum
        aux = {k: v / accum_steps for k, v in aux_sum.items()} if accum_steps > 1 else aux_sum

        with torch.no_grad():
            if mesh is not None and mesh.data_size > 1:
                reduce_over_data(model, params, mesh, fsdp)
            if sp > 1:
                sum_over_sp(params, mesh)
            grads = [p.grad for p in params if p.grad is not None]
            if accum_steps > 1:
                for g in grads:
                    local(g).div_(accum_steps)
            apply = True
            if state.loss_scale is not None:
                for g in grads:
                    local(g).mul_(1.0 / scale)
                finite = all_finite(grads)
                if mesh is not None:  # every rank takes or skips the step together
                    bad = (~finite).float().reshape(1)
                    dist.all_reduce(bad)
                    finite = bad[0] == 0
                finite = bool(finite)  # one host sync per step
                state.loss_scale = update_loss_scale(state.loss_scale, finite)
                apply = finite  # overflow: skip params, optimizer count and EMA
            if apply:
                optimizer.step()
                if ema_decay is not None and state.ema_params is not None:
                    for name, p in model.named_parameters():
                        local(state.ema_params[name]).mul_(ema_decay).add_(
                            local(p), alpha=1.0 - ema_decay)
            if mesh is not None and mesh.data_size > 1:
                loss, aux = _data_mean(loss, aux, mesh)
        state.step += 1
        return state, loss, aux

    return step
