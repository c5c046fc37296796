"""Mixture-of-Experts MLP with expert parallelism (port of
`ucf_vit_tpu/models/moe.py`).

The V-MoE recipe: in some blocks the dense MLP becomes E expert MLPs and a
learned top-k token router. Each sample's N tokens are routed on their own
(groups are samples), so routing never mixes the batch and a sample's
capacity is a constant, `expert_capacity` slots an expert.

The parameters keep the JAX names and layouts, so `convert.load_jax_params`
and `export_torch_state` (`ucf_vit_tpu/tools/convert_checkpoint.py:283`)
pass them through unchanged: `router_kernel [D, E]` (always f32), `wi [E, D,
H]`, `bi [E, H]`, `wo [E, H, D]`, `bo [E, D]`.

The routing is the JAX module's (`:87-132`), in f32 whatever the policy:
softmax of the router's logits, the top k experts (ties to the lower expert
index, as `lax.top_k` breaks them: a stable descending sort), their gates
renormalised by `max(sum, 1e-9)` when k > 1, then k priority rounds of
capacity, tokens in sequence order within a round, each round's queue
starting behind the slots the earlier rounds took. A token past its
expert's capacity is dropped from that expert. The JAX package moves tokens
by one-hot `[B, N, E, C]` einsums, the form its partitioner turns into an
all-to-all; the port computes each token's slot the same way and gathers
the tokens into a `[B, E, C, D]` buffer (an empty slot is zero), runs the
experts on it, and gathers each token's k results back, weighted by its
gates. Both moves and their gradients are gathers (`_MoveRows`): each slot
holds one token's choice and each choice one slot, so no gradient needs a
scatter-add. The experts are batched matmuls over the local experts with
tanh-GELU (`gelu_approx`), in `dtype` or the input's type.

The load-balance loss is the Switch form, `E * sum_e f_e * p_e` (`f_e` the
share of tokens whose top-1 choice is e, before capacity; `p_e` the mean
router probability), kept in `aux_loss` after each forward; the model takes
the mean over its MoE layers (`collect_moe_aux`).

On a mesh (`shard_expert_parallel`, from `parallel.train_step.shard_model`):
- expert parallelism: ep rank j keeps experts `[j E/ep, (j + 1) E/ep)` of
  `wi`, `bi`, `wo`, `bo`. The dispatch buffer goes to the experts' ranks
  (`collectives.all_to_all` over ep: expert dim out, batch dim in), each
  rank runs its experts on the `ep * B_local * C` rows it received, and the
  results go home by the inverse all-to-all, whose backward brings each
  expert the gradient of every ep rank's tokens;
- tensor parallelism: the experts' hidden dim splits over tp (`wi`'s last
  dim, `bi`'s and `wo`'s dim 1), the dispatched input passes through
  `f_identity_b_allreduce` and the partial outputs are summed over tp after
  `wo`, `bo` added once (the JAX logical axes `("expert", "embed", "mlp")`);
- the aux loss is the global batch's, as the JAX mean over the whole batch:
  `f_e` and `p_e` are summed over the data group (`collectives.all_reduce`,
  whose backward sums too, so that the step's mean over the data ranks
  gives `p_e` its true gradient) and divided by its size;
- sequence parallelism: a block stack split over sp hands the MoE this
  rank's `N/sp` tokens; the layer gathers the whole sequence (the routing
  queue runs over a sample's N tokens), routes and runs it on every sp rank,
  and keeps its slice of the output (`collectives.split`): the conventions
  of the split stream (`parallel/collectives.py`) hold for its gradients.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ucf_vit_tpu_torch.models.blocks import TensorParallel
from ucf_vit_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    all_to_all,
    f_allreduce_b_identity,
    f_identity_b_allreduce,
    split,
)
from ucf_vit_tpu_torch.parallel.mesh import seq_shard

# the expert leaves: their dim 0 is the expert dim, split over ep
EXPERT_LEAVES = ("wi", "bi", "wo", "bo")


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots an expert has for one sample's tokens: `ceil(k N cf / E)`, at
    least 1 (`:52-59`)."""
    return max(int(math.ceil(top_k * num_tokens * capacity_factor / num_experts)), 1)


def top_k_lower_first(probs: torch.Tensor, k: int):
    """`(values, indices)` of the k largest entries of the last dim, equal
    values in the order of their index, as `lax.top_k` gives them
    (`torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def assign_slots(expert_idx: torch.Tensor, num_experts: int, capacity: int):
    """The capacity rounds (`:105-123`): for each of the k choices `[B, N, k]`,
    the slot of each token in its expert's queue `[B, N, k]` and whether it
    got one. Round kk's queue starts behind the slots rounds < kk took, and
    within a round the tokens queue in sequence order."""
    b, n, k = expert_idx.shape
    counts = expert_idx.new_zeros(b, num_experts)
    slots, kept = [], []
    for kk in range(k):
        onehot = F.one_hot(expert_idx[..., kk], num_experts)  # [B, N, E]
        pos = onehot.cumsum(1) - onehot + counts[:, None, :]
        slot = (pos * onehot).sum(-1)  # [B, N]
        keep = slot < capacity
        counts = counts + (onehot * keep[..., None]).sum(1)
        slots.append(slot)
        kept.append(keep)
    return torch.stack(slots, -1), torch.stack(kept, -1)


def _take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows `index` of `x` `[R, D]`, a zero row where the index is R."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])])[index]


class _MoveRows(torch.autograd.Function):
    """`out[i] = x[rows[i]]` (a zero row where `rows[i]` is `len(x)`), with the
    gradient gathered back the same way, `grad_x[j] = sum_m grad_out[back[j,
    m]]` (`back` `[len(x), M]`: the rows of `out` that took row j, `len(out)`
    where none): both ways a gather, where indexing's own backward would
    scatter-add under a sort."""

    @staticmethod
    def forward(ctx, x, rows, back):
        ctx.save_for_backward(back)
        return _take(x, rows)

    @staticmethod
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        return _take(g, back.reshape(-1)).view(*back.shape, -1).sum(1), None, None


class MoeMlp(nn.Module, TensorParallel):
    """Top-k routed mixture of experts, a drop-in for `blocks.Mlp`: `[B, N, D]
    -> [B, N, D]` (see the module's docstring)."""

    def __init__(self, dim: int, hidden_features: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, gelu_approx: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        e = num_experts
        self.num_experts = e
        self.top_k = min(top_k, e)
        self.capacity_factor = float(capacity_factor)
        self.gelu = "tanh" if gelu_approx else "none"
        self.dtype = dtype
        self.router_kernel = nn.Parameter(torch.zeros(dim, e))
        self.wi = nn.Parameter(torch.zeros(e, dim, hidden_features))
        self.bi = nn.Parameter(torch.zeros(e, hidden_features))
        self.wo = nn.Parameter(torch.zeros(e, hidden_features, dim))
        self.bo = nn.Parameter(torch.zeros(e, dim))
        # set on a mesh (`shard_expert_parallel`, `shard_tensor_parallel`)
        self.ep_group = None
        self.tp_group = None
        self.data_group, self.data_size = None, 1
        self.aux_loss: Optional[torch.Tensor] = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float) -> None:
        """flax's truncated normal (std 0.02) for the router and expert kernels,
        zero expert biases (`:88-154`)."""
        for p in (self.router_kernel, self.wi, self.wo):
            nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=generator)
        self.bi.zero_()
        self.bo.zero_()

    # tensor parallelism: the experts' hidden dim, by `blocks.tp_slice`'s kinds
    def tp_layout(self) -> dict:
        return {"wi": "dim2", "bi": "cols", "wo": "cols"}

    def tp_divides(self, size: int) -> bool:
        return self.wi.shape[2] % size == 0

    def route(self, x: torch.Tensor):
        """`(probs [B, N, E], gates [B, N, k], experts [B, N, k], slots, kept)`
        of `x` in f32."""
        probs = torch.softmax(x.float() @ self.router_kernel.float(), dim=-1)
        gates, idx = top_k_lower_first(probs, self.top_k)
        if self.top_k > 1:
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        cap = expert_capacity(x.shape[1], self.num_experts, self.top_k, self.capacity_factor)
        slots, kept = assign_slots(idx, self.num_experts, cap)
        return probs, gates, idx, slots, kept

    def _aux(self, probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The Switch load-balance loss of the global batch."""
        e = self.num_experts
        f_e = F.one_hot(idx[..., 0], e).float().mean((0, 1))
        p_e = probs.mean((0, 1))
        if self.data_size > 1:  # the means over the data group's batch
            f_e, p_e = (all_reduce(torch.stack([f_e, p_e]), self.data_group)
                        / self.data_size).unbind(0)
        return e * (f_e * p_e).sum()

    def experts(self, xe: torch.Tensor) -> torch.Tensor:
        """The local experts on their rows: `[E_local, R, D] -> [E_local, R, D]`."""
        dt = xe.dtype
        tp = self.tp_group
        if tp is not None:
            xe = f_identity_b_allreduce(xe, tp)
        h = torch.bmm(xe, self.wi.to(dt)) + self.bi.to(dt)[:, None, :]
        h = F.gelu(h, approximate=self.gelu)
        y = torch.bmm(h, self.wo.to(dt))
        if tp is not None:
            y = f_allreduce_b_identity(y, tp)
        return y + self.bo.to(dt)[:, None, :]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = seq_shard()
        if shard is not None:  # route the whole sequence on every sp rank
            x = all_gather(x, shard.group, axis=1)
        b, n, d = x.shape
        e = self.num_experts
        probs, gates, idx, slots, kept = self.route(x)
        self.aux_loss = self._aux(probs, idx)
        cap = expert_capacity(n, e, self.top_k, self.capacity_factor)
        cdt = self.dtype or x.dtype
        # each kept choice's place in the flat [B, E, C] buffer (a dropped one the
        # row past its end), and each slot's token and choice (an empty one the row
        # past the tokens and the choices)
        slots_all, choices = b * e * cap, b * n * self.top_k
        bidx = torch.arange(b, device=x.device)[:, None, None]
        dest = torch.where(kept, (bidx * e + idx) * cap + slots, slots_all)  # [B, N, k]
        taker = torch.full((slots_all + 1,), choices, device=x.device, dtype=torch.long)
        taker[dest.reshape(-1)] = torch.arange(choices, device=x.device)
        taker = taker[:-1]
        token = torch.where(taker < choices, taker // self.top_k, b * n)
        xe = _MoveRows.apply(x.to(cdt).reshape(b * n, d), token,
                             dest.view(b * n, self.top_k)).view(b, e, cap, d)
        if self.ep_group is not None:  # [B, E, C, D] -> [ep B, E / ep, C, D]
            xe = all_to_all(xe, self.ep_group, split_axis=1, concat_axis=0)
        bb, el = xe.shape[:2]
        ye = self.experts(xe.transpose(0, 1).reshape(el, bb * cap, d))
        ye = ye.view(el, bb, cap, d).transpose(0, 1)
        if self.ep_group is not None:  # home again: [ep B, E / ep, C, D] -> [B, E, C, D]
            ye = all_to_all(ye, self.ep_group, split_axis=0, concat_axis=1)
        picked = _MoveRows.apply(ye.reshape(slots_all, d), dest.reshape(-1),
                                 taker[:, None]).view(b, n, self.top_k, d)  # dropped: zeros
        w = (gates * kept).to(cdt)
        y = (picked * w[..., None]).sum(2)
        if shard is not None:
            y = split(y, shard.group, axis=1)
        return y.to(x.dtype)


def collect_moe_aux(layers) -> torch.Tensor:
    """The mean of the load-balance losses of MoE layers that have just run
    (`:189-198`)."""
    return torch.stack([m.aux_loss.float() for m in layers]).mean()


@torch.no_grad()
def shard_expert_parallel(model: nn.Module, mesh) -> set:
    """Keep this ep rank's experts of every MoE layer of `model`, in place, and
    give each layer its ep group and the data group of its aux loss; returns
    the names of the expert leaves (the checkpoint's gather, the clip's norm,
    the gradient reduction and the sync check read them)."""
    ep, rank = mesh.size("ep"), mesh.index("ep")
    names = set()
    for prefix, m in model.named_modules():
        if not isinstance(m, MoeMlp):
            continue
        m.data_group, m.data_size = mesh.data_group, mesh.data_size
        if ep == 1:
            continue
        if m.num_experts % ep:
            raise ValueError(f"{m.num_experts} experts do not split over ep {ep}")
        for leaf in EXPERT_LEAVES:
            p = getattr(m, leaf)
            p.data = p.data.chunk(ep, dim=0)[rank].contiguous()
            names.add(f"{prefix}.{leaf}" if prefix else leaf)
        m.ep_group = mesh.group("ep")
    return names

