"""Ring attention: sequence-parallel attention with K/V chunks passed round
the sp group (port of `ucf_vit_tpu/ops/ring_attention.py`).

Each of the sp ranks holds `Nq = N/sp` queries and `Nk = N/sp` keys and
values of `[B, H, N, dh]`. The forward runs sp hops: at hop t rank `my`
holds the chunk that started on rank `src = (my - t) mod sp` and runs the
port's flash forward kernel on it (`flash_attention(..., return_lse=True,
f32_o=True)`: the chunk's o in f32, unrounded) at the chunk's global
coordinates `(my * Nq, src * Nk)`, then merges the chunk's `(o_c, lse_c)`
into its running `(o, lse)` in f32, rounding to q's dtype once at the end:

    lse' = logaddexp(lse, lse_c),  o = o exp(lse - lse') + o_c exp(lse_c - lse')

which equals the JAX ring's accumulator (`:52-95`): both kernels drop after
the normaliser, so each chunk's `o_c` is its dropped sum over its own
normaliser, and the merge rescales it to the whole row's. The forward saves
`(q, k, v, o, lse)`, O(N/sp) a rank. The backward runs a second ring (`:111-
160`): for each chunk the flash backward kernel(s) given the merged `o` and
`lse` (so `p = exp(s - lse)` is the whole row's softmax) at the same
coordinates; dq is summed in f32 (the fused route's f32 workspace, the
split route's dq in q's dtype). A rank keeps its own chunk's share of dk
and dv; the shares of the other ranks' queries ride the ring in f32 with
their chunk from its first visit on, and come home after sp - 1 hops,
where the JAX ring's dk and dv ride from their home and back in sp hops:
the same sums, one hop of f32 dk and dv fewer.

One dropout seed serves every sp rank and each chunk is masked at its
global coordinates, so the union of the ranks' masks is the one global draw
of the single-device kernel at that seed. K/V move by `parallel.
collectives.ring_hop`, the next K/V hop posted before the chunk in hand is
computed; the last K/V hop of each ring is not made (sp - 1 a ring). A CPU
tensor runs the kernels' plain versions (that is the ring's plain version);
a CUDA tensor launches the kernels or raises. `ring_attention.hops` counts
the hops.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ucf_vit_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
from ucf_vit_tpu_torch.parallel.collectives import ring_hop


def _merge(o, lse, o_c, lse_c):
    """`(o, lse)` of two parts of a row's keys, o f32 `[B, H, Nq, dh]`, lse f32
    `[B*H, Nq]`."""
    b, h, n_q, _ = o_c.shape
    if o is None:
        return o_c, lse_c
    new = torch.logaddexp(lse, lse_c)
    a = torch.exp(lse - new).view(b, h, n_q, 1)
    c = torch.exp(lse_c - new).view(b, h, n_q, 1)
    return o * a + o_c * c, new


class RingAttentionFn(torch.autograd.Function):
    """Ring attention over the sp `group`, flash kernels on every chunk."""

    @staticmethod
    def forward(ctx, q, k, v, group, sm_scale, rate, seed):
        sp, my = dist.get_world_size(group), dist.get_rank(group)
        n_q, n_k = q.shape[2], k.shape[2]
        o = lse = None
        kc, vc = k, v
        for t in range(sp):
            src = (my - t) % sp
            wait = None
            if t < sp - 1:
                (kn, vn), wait = ring_hop([kc, vc], group, async_op=True)
                ring_attention.hops += 1
            o_c, lse_c = flash_attention(q, kc, vc, sm_scale=sm_scale, dropout_rate=rate,
                                         dropout_seed=seed if rate > 0.0 else None,
                                         dropout_offset=(my * n_q, src * n_k),
                                         return_lse=True, f32_o=True)
            o, lse = _merge(o, lse, o_c, lse_c)
            if wait is not None:
                wait()
                kc, vc = kn, vn
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = (group, sm_scale, rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, sm_scale, rate, seed = ctx.meta
        sp, my = dist.get_world_size(group), dist.get_rank(group)
        n_q, n_k = q.shape[2], k.shape[2]
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kc, vc, rider = k, v, None
        for t in range(sp):
            src = (my - t) % sp
            wait = None
            if t < sp - 1:  # the next chunk's K/V, on its way while this one is computed
                (kn, vn), wait = ring_hop([kc, vc], group, async_op=True)
                ring_attention.hops += 1
            dq_c, dk_c, dv_c = flash_attention_bwd(q, kc, vc, o, lse, do, sm_scale, rate, seed,
                                                   my * n_q, src * n_k, f32_dq=True)
            dq += dq_c
            if t == 0:  # this rank's own chunk: its share stays here
                dk, dv = dk_c.float(), dv_c.float()
            else:  # a visiting chunk's: added to what its rider carries, then on with it
                rider = ([dk_c.float(), dv_c.float()] if rider is None
                         else [rider[0] + dk_c, rider[1] + dv_c])
                rider = ring_hop(rider, group)
                ring_attention.hops += 1
            if wait is not None:
                wait()
                kc, vc = kn, vn
        if rider is not None:  # the rider of this rank's chunk, home from its last hop
            dk, dv = dk + rider[0], dv + rider[1]
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   sm_scale: Optional[float] = None, *, dropout_rate: float = 0.0,
                   dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Attention of this rank's queries `[B, H, N/sp, dh]` over the whole
    sequence, whose keys and values `[B, H, N/sp, dh]` the sp `group`'s ranks
    hold in rank order: `[B, H, N/sp, dh]` in q's dtype. Every rank of the
    group must call it together, with the same `dropout_seed`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    rate = float(dropout_rate)
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs dropout_seed")
    seed = int(dropout_seed) if rate > 0.0 else 0
    return RingAttentionFn.apply(q, k, v, group, float(sm_scale), rate, seed)


# K/V and dk/dv hops since the count was last set to 0
ring_attention.hops = 0


def reset_launch_counts() -> None:
    ring_attention.hops = 0
