"""Collectives with a chosen forward and backward (port of
`ucf_vit_tpu/parallel/collectives.py`).

The conjugate pairs that Megatron-style tensor parallelism is built from
(the reference's `utils/dist_functions.py`). The JAX package runs them
inside `shard_map` on a named axis; here each is a `torch.autograd.Function`
over the process group of one mesh axis (`Mesh.group(axis)`), and a rank's
index is its rank in that group.

| here                       | forward        | backward       |
|----------------------------|----------------|----------------|
| f_broadcast_b_identity     | broadcast(src) | identity       |
| f_identity_b_allreduce     | identity       | all-reduce     |
| f_allreduce_b_identity     | all-reduce     | identity       |
| f_identity_b_broadcast     | identity       | broadcast(src) |
| all_reduce                 | all-reduce     | all-reduce     |
| all_gather                 | all-gather     | reduce-scatter |
| reduce_scatter             | reduce-scatter | all-gather     |
| all_to_all                 | all-to-all     | all-to-all     |
| split                      | this rank's chunk | zero-padded |
| halo_exchange              | neighbours' edges | edges' gradients home, added |

All reductions are sums. The forward and backward of one pair run the same
collectives on every rank of the group, so every rank must call them
together. With `tiled=False` the JAX package stacks the gathered pieces on a
new axis (and `reduce_scatter` drops it); the same here.

Sequence parallelism splits the token stream with `split` and joins it with
`all_gather` (`models/vit.py`). Between the two, each rank holds its chunk
of the sequence and that chunk's true gradient; outside them the stream is
whole on every sp rank and its gradient is held as partial sums over the
group: `split` hands back its chunk's gradient zero-padded, and the train
step backpropagates `loss / sp` on each rank (whose sum over the group is
the loss's gradient) and sums every parameter's gradient over sp
(`parallel/train_step.py`). So `all_gather`'s reduce-scatter backward is
the right one there: it sums the partials and keeps this rank's chunk.

`ring_hop` moves tensors one step round the sp ring, to rank + 1 from
rank - 1 (`ops/ring_attention.py`).

`halo_exchange` gives a slab of a map split over the group on one axis the
edge slices of its neighbours, which a 'same' convolution reads across the
cut (UNETR's spatial partition, `models/unet_blocks.py`); inside the split
region the gradients it sends home are true ones, added into the owner's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _broadcast(x: torch.Tensor, group, src: int) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.broadcast(x, group=group, group_src=src)
    return x


def _gather(x: torch.Tensor, group, axis: int, tiled: bool) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def _scatter(x: torch.Tensor, group, axis: int, tiled: bool) -> torch.Tensor:
    """Sum over the group, then this rank's part of `axis` (tiled: a chunk;
    else the index along it). An all-reduce and a slice: the same result as a
    reduce-scatter on every backend."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    total = _all_reduce(x, group)
    if not tiled:
        if total.shape[axis] != n:
            raise ValueError(f"untiled reduce_scatter needs dim {axis} of size {n}")
        return total.select(axis, r).contiguous()
    if total.shape[axis] % n:
        raise ValueError(f"dim {axis} of size {total.shape[axis]} does not split over {n}")
    return total.chunk(n, dim=axis)[r].contiguous()


def _a2a(x: torch.Tensor, group, split_axis: int, concat_axis: int, tiled: bool) -> torch.Tensor:
    n = dist.get_world_size(group)
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} does not split "
                             f"over {n}")
        pieces = [p.contiguous() for p in x.chunk(n, dim=split_axis)]
    else:
        pieces = [p.contiguous() for p in x.unbind(split_axis)]
    sent = torch.stack(pieces)  # piece i goes to rank i
    got = torch.empty_like(sent)
    dist.all_to_all_single(got, sent, group=group)
    outs = got.unbind(0)
    return torch.cat(outs, dim=concat_axis) if tiled else torch.stack(outs, dim=concat_axis)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        if x.shape[axis] % n:
            raise ValueError(f"dim {axis} of size {x.shape[axis]} does not split over {n}")
        ctx.args = (axis, r, x.shape)
        return x.chunk(n, dim=axis)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        axis, r, shape = ctx.args
        full = g.new_zeros(shape)
        m = g.shape[axis]
        full.narrow(axis, r * m, m).copy_(g)
        return full, None, None


class _BroadcastIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        return _broadcast(x, group, src)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _IdentityAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReduceIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdentityBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.group, ctx.src = group, src
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _broadcast(g, ctx.group, ctx.src), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, tiled):
        ctx.args = (group, axis, tiled)
        return _gather(x, group, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, tiled):
        ctx.args = (group, axis, tiled)
        return _scatter(x, group, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, tiled):
        ctx.args = (group, split_axis, concat_axis, tiled)
        return _a2a(x, group, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis, tiled = ctx.args
        return _a2a(g, group, concat_axis, split_axis, tiled), None, None, None, None


def f_broadcast_b_identity(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Every rank gets rank `src`'s value; the gradient passes unchanged."""
    return _BroadcastIdentity.apply(x, group, src)


def f_identity_b_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is summed over the group (the input of a
    column-parallel layer)."""
    return _IdentityAllReduce.apply(x, group)


def f_allreduce_b_identity(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the gradient passes unchanged (the output of a
    row-parallel layer)."""
    return _AllReduceIdentity.apply(x, group)


def f_identity_b_broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Identity; every rank gets rank `src`'s gradient."""
    return _IdentityBroadcast.apply(x, group, src)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, forward and backward."""
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group, axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """The group's pieces joined on `axis` in rank order; reduce-scatter
    backward."""
    return _AllGather.apply(x, group, axis, tiled)


def reduce_scatter(x: torch.Tensor, group, axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """The sum over the group, this rank's part of `axis`; all-gather
    backward."""
    return _ReduceScatter.apply(x, group, axis, tiled)


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int,
               tiled: bool = True) -> torch.Tensor:
    """Piece i of `split_axis` goes to rank i; the pieces received are joined
    on `concat_axis` in rank order. Its own transpose backward."""
    return _AllToAll.apply(x, group, split_axis, concat_axis, tiled)


def ulysses_heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, H/sp, N, dh] -> [B, H, N/sp, dh]: the Ulysses head <-> sequence
    swap."""
    return all_to_all(x, group, split_axis=2, concat_axis=1)


def ulysses_seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, H, N/sp, dh] -> [B, H/sp, N, dh]: the inverse of
    `ulysses_heads_to_seq`."""
    return all_to_all(x, group, split_axis=1, concat_axis=2)


def split(x: torch.Tensor, group, axis: int = 1) -> torch.Tensor:
    """This rank's chunk of `axis` (equal chunks in rank order); the
    gradient comes back zero-padded to `x`'s shape: this rank's share of a
    gradient held as partial sums over the group."""
    return _Split.apply(x, group, axis)


def _neighbour_swap(lo: torch.Tensor, hi: torch.Tensor, group):
    """Send `lo` to rank - 1 and `hi` to rank + 1 of `group` (none past either
    end): `(rank - 1's hi, rank + 1's lo)`, None where there is no neighbour.
    One `all_to_all_single`, as `ring_hop` (gloo carries no send/recv on CUDA
    tensors)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    m = lo.numel()
    sizes = [m if j in (r - 1, r + 1) else 0 for j in range(n)]
    sent = torch.cat([t.reshape(-1) for t, j in ((lo, r - 1), (hi, r + 1)) if 0 <= j < n])
    got = torch.empty_like(sent)
    dist.all_to_all_single(got, sent, sizes, sizes, group=group)
    pieces = iter(got.split(m))
    prev = next(pieces).view(lo.shape) if r > 0 else None
    nxt = next(pieces).view(hi.shape) if r < n - 1 else None
    return prev, nxt


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, width):
        k = x.shape[axis]
        if k < width:
            raise ValueError(f"a slab of {k} along dim {axis} has no halo of {width}")
        ctx.args = (group, axis, width)
        lo, hi = x.narrow(axis, 0, width), x.narrow(axis, k - width, width)
        prev, nxt = _neighbour_swap(lo.contiguous(), hi.contiguous(), group)
        zeros = x.new_zeros(lo.shape)
        return torch.cat([zeros if prev is None else prev, x,
                          zeros if nxt is None else nxt], dim=axis)

    @staticmethod
    def backward(ctx, g):
        group, axis, width = ctx.args
        k = g.shape[axis] - 2 * width
        g_prev, g_next = _neighbour_swap(g.narrow(axis, 0, width).contiguous(),
                                         g.narrow(axis, k + width, width).contiguous(), group)
        gx = g.narrow(axis, width, k).clone()
        if g_prev is not None:  # rank - 1's halo was my first slices
            gx.narrow(axis, 0, width).add_(g_prev)
        if g_next is not None:
            gx.narrow(axis, k - width, width).add_(g_next)
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, group, axis: int, width: int) -> torch.Tensor:
    """This rank's slab of a map split over `group` along `axis`, with `width`
    slices of rank - 1's slab before it and `width` of rank + 1's after it;
    zeros past the group's first and last rank (a 'same' convolution's zero
    padding). Backward: each halo's gradient goes back to its owner and is
    added into the edge slices it came from."""
    return _HaloExchange.apply(x, group, axis, width)


def ring_hop(tensors, group, async_op: bool = False):
    """Send `tensors` (of one dtype) to the next rank of `group` and receive
    the previous rank's in their place: the new tensors, or with `async_op`
    `(tensors, wait)` where `wait()` must run before they are read.

    The hop is one `all_to_all_single` whose split sizes send the tensors,
    as one flat buffer, to rank + 1 and take rank - 1's. Over gloo on CUDA
    tensors (two ranks sharing one card, where NCCL refuses), `send`/`recv`
    and `batch_isend_irecv` fail ("writev ... Bad address": gloo reads the
    device pointer as a host address) and `all_to_all_single` carries the
    hop (`tools/gloo_probe.py`, PERF.md); the same call runs over NCCL and
    over gloo on the CPU."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt, prv = (r + 1) % n, (r - 1) % n
    flat = torch.cat([t.reshape(-1) for t in tensors])
    got = torch.empty_like(flat)
    m = flat.numel()
    work = dist.all_to_all_single(got, flat, [m if j == prv else 0 for j in range(n)],
                                  [m if j == nxt else 0 for j in range(n)], group=group,
                                  async_op=True)
    out = [p.view(t.shape) for p, t in zip(got.split([t.numel() for t in tensors]), tensors)]

    def wait():
        nonlocal flat
        work.wait()
        flat = None  # the send buffer may go

    if async_op:
        return out, wait
    wait()
    return out
