"""Attention implementation dispatch (port of `ucf_vit_tpu/ops/attention.py`).

    AttnImpl.FLASH   the port's flash attention: the Hopper kernels (forward
                     and, through autograd, backward) on a CUDA tensor, their
                     plain versions on a CPU tensor
    AttnImpl.EINSUM  plain einsum attention, the numerics oracle
    AttnImpl.XLA     not ported (it named an XLA-fused library call)
    AttnImpl.AUTO    FLASH on CUDA, EINSUM on the CPU

All impls take and return [B, H, N, dh]. The JAX package's AUTO picks EINSUM
below 1024 keys on a TPU; that threshold was measured on a TPU and does not
carry over. The same number bounds segment-masked attention under FLASH, as
in the JAX package: the kernel has no segment mask, so such a call goes to
EINSUM, which materialises the whole score matrix, and is refused past
`SHORT_SEQ_THRESHOLD` keys.

Attention dropout on EINSUM uses the same hash mask as the flash kernels
(`ops/attn_dropout.dense_keep_mask` of the same seed), so FLASH and EINSUM
drop the same elements inside the port. The JAX package's EINSUM draws
`jax.random.bernoulli` instead (`ucf_vit_tpu/ops/attention.py:129-134`): a
difference kept on purpose (ROADMAP.md, faults).

Under a mesh of more than one rank (`parallel.mesh.mesh_context`) each rank
runs its own batch slice and, under tensor parallelism, its own heads: the
local `[B_local, H_local, N, dh]` that the JAX package's `_sharded_flash`
hands each device (`ucf_vit_tpu/ops/attention.py:193-290`). With dropout the
seed is folded with the rank's (ddp, fsdp, tp) indices in that order, as
there (`:233-243`), so that the local coordinates of different shards do not
draw one mask; both impls fold it, so they still drop the same elements.

Under sequence parallelism (a block stack run inside
`parallel.mesh.sequence_context`) each rank holds `N/sp` tokens of q, k and
v, and FLASH runs the JAX package's `_sharded_flash` modes (`:181-289`,
`SP_MODES`, the model's `sp_mode`):
- `ring`: `ops.ring_attention`, the seed kept across sp, every chunk at its
  global coordinates;
- `ulysses`: an all-to-all swaps the sequence split for a head split, the
  flash kernel runs the whole sequence on `H/sp` of the rank's heads (the
  seed folded by the sp index too), and a second one swaps back;
- `gather`: K and V gathered over sp, the rank's queries at their global
  row `sp_index * N/sp` (`dropout_offset`);
- `auto`: `ulysses` where the rank's heads divide by sp, else `gather`.
EINSUM computes the same global attention: K and V gathered, the hash mask
at the queries' global rows. A stack whose tokens sp does not divide runs
whole on every sp rank, outside the context (`models/vit.py`), where EINSUM
attends as on one device and FLASH raises, as the JAX package's `shard_map`
does.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from ucf_vit_tpu_torch.ops.attn_dropout import dense_keep_mask, fold_seed
from ucf_vit_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE, flash_attention
from ucf_vit_tpu_torch.ops.ring_attention import ring_attention
from ucf_vit_tpu_torch.parallel.collectives import (
    all_gather,
    ulysses_heads_to_seq,
    ulysses_seq_to_heads,
)
from ucf_vit_tpu_torch.parallel.mesh import SeqShard, active_mesh, seq_shard

# The most keys that segment-masked attention under FLASH may take (routed to
# EINSUM, which holds the whole [Nq, Nkv] score matrix).
SHORT_SEQ_THRESHOLD = 1024
# sequence-parallel strategies (`parallelism.sp_mode`)
SP_MODES = ("auto", "ulysses", "ring", "gather")


class AttnImpl(str, enum.Enum):
    FLASH = "FLASH"
    XLA = "XLA"
    EINSUM = "EINSUM"
    AUTO = "AUTO"

    @classmethod
    def from_string(cls, s: str) -> "AttnImpl":
        s = s.upper()
        # the reference's FusedAttn spellings, as the JAX package accepts them
        aliases = {"CK": "FLASH", "DEFAULT": "XLA", "NONE": "EINSUM", "SHORT": "EINSUM"}
        return cls(aliases.get(s, s))


def resolve_impl(impl: AttnImpl | str, device: torch.device) -> AttnImpl:
    if isinstance(impl, str):
        impl = AttnImpl.from_string(impl)
    if impl == AttnImpl.AUTO:
        return AttnImpl.FLASH if torch.device(device).type == "cuda" else AttnImpl.EINSUM
    return impl


def einsum_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: float,
    seg_len: Optional[int] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    row0: int = 0,
) -> torch.Tensor:
    """Reference attention: full score matrix, f32 softmax. [B, H, N, dh].

    seg_len: block-diagonal masking for sequence-packed batches (tokens only
    attend within their own seg_len-sized segment).
    dropout_rate/dropout_seed: drop post-softmax probabilities where the hash
    mask of `dropout_seed` says so and rescale survivors by 1/(1 - rate);
    the queries are the mask's rows from `row0` on."""
    s = torch.einsum("bhqd,bhkd->bhqk", q * sm_scale, k).float()
    if seg_len is not None:
        n_q, n_kv = s.shape[-2], s.shape[-1]
        seg_q = torch.arange(n_q, device=s.device) // seg_len
        seg_k = torch.arange(n_kv, device=s.device) // seg_len
        same = seg_q[:, None] == seg_k[None, :]
        s = torch.where(same, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("attention dropout_rate > 0 needs a dropout_seed")
        b, h, n_q, n_kv = p.shape
        keep = dense_keep_mask(dropout_seed, b * h, n_q, n_kv, dropout_rate, row0=row0,
                               device=p.device).view(p.shape)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def sharded_seed(seed: int) -> int:
    """`seed` folded with the active mesh's (ddp, fsdp, tp) indices when the
    mesh has more than one rank (`ucf_vit_tpu/ops/attention.py:366-375`);
    `seed` itself on one device."""
    mesh = active_mesh()
    if mesh is None or mesh.world == 1:
        return seed
    return fold_seed(seed, mesh.index("ddp"), mesh.index("fsdp"), mesh.index("tp"))


def _sequence_parallel(q, k, v, shard: SeqShard, impl: AttnImpl, sm_scale: float,
                       sp_mode: str, rate: float, seed: Optional[int]) -> torch.Tensor:
    """Attention of this rank's `N/sp` queries over the whole sequence, whose
    keys and values the sp ranks hold in rank order (`_sharded_flash`'s
    sequence-parallel branches); `seed` already folded over (ddp, fsdp,
    tp)."""
    group, sp, idx = shard.group, shard.size, shard.rank
    if impl == AttnImpl.EINSUM:
        k, v = all_gather(k, group, axis=2), all_gather(v, group, axis=2)
        return einsum_attention(q, k, v, sm_scale=sm_scale, dropout_rate=rate,
                                dropout_seed=seed, row0=idx * q.shape[2])
    if sp_mode == "ring":
        return ring_attention(q, k, v, group, sm_scale, dropout_rate=rate, dropout_seed=seed)
    divisible = q.shape[1] % sp == 0
    if sp_mode == "ulysses" and not divisible:
        # the JAX package's assertion, raised explicitly so that it holds under -O
        raise AssertionError(
            f"sp_mode=ulysses needs local heads ({q.shape[1]}) divisible by seq_par_size "
            f"({sp}); use sp_mode=ring or auto")
    if divisible and sp_mode != "gather":  # ulysses, or auto
        if rate > 0.0:  # after the swap each sp rank holds its own heads
            seed = fold_seed(seed, idx)
        q, k, v = (ulysses_seq_to_heads(t, group) for t in (q, k, v))
        o = flash_attention(q, k, v, sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed)
        return ulysses_heads_to_seq(o, group)
    k, v = all_gather(k, group, axis=2), all_gather(v, group, axis=2)
    return flash_attention(q, k, v, sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed,
                           dropout_offset=(idx * q.shape[2] if rate > 0.0 else 0, 0))


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: AttnImpl | str = AttnImpl.AUTO,
    sm_scale: Optional[float] = None,
    seg_len: Optional[int] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    sp_mode: str = "auto",
) -> torch.Tensor:
    """Dispatch scaled-dot-product attention over [B, H, N, dh] inputs.

    seg_len routes FLASH to EINSUM (the kernel has no segment mask) and
    raises AssertionError past SHORT_SEQ_THRESHOLD keys there; EINSUM asked
    for by name takes any length.
    dropout_rate > 0 needs an int32 `dropout_seed`; FLASH drops inside the
    kernels and EINSUM with the same hash mask, both with the seed folded by
    the active mesh's coordinates (`sharded_seed`). Inside a sequence-split
    block stack (`parallel.mesh.sequence_context`) q, k and v are this
    rank's tokens and `sp_mode` picks the strategy (see the module's
    docstring). The XLA impl is not ported and raises NotImplementedError."""
    if sp_mode not in SP_MODES:
        raise AssertionError(f"sp_mode {sp_mode!r} not in {SP_MODES}")
    if dropout_rate > 0.0 and dropout_seed is not None:
        dropout_seed = sharded_seed(dropout_seed)
    impl = resolve_impl(impl, q.device)
    if impl == AttnImpl.XLA:
        raise NotImplementedError(
            "AttnImpl.XLA is not ported: a library attention call is no port "
            "of a kernel; use FLASH, EINSUM or AUTO (ROADMAP.md, port rules)"
        )
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    shard = seq_shard()
    if shard is not None:
        return _sequence_parallel(q, k, v, shard, impl, sm_scale, sp_mode, dropout_rate,
                                  dropout_seed)
    if impl == AttnImpl.FLASH and seg_len is None:
        return flash_attention(q, k, v, sm_scale=sm_scale, dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)
    if impl == AttnImpl.FLASH and k.shape[2] > SHORT_SEQ_THRESHOLD:
        # the JAX package's assertion, raised explicitly so that it holds under -O
        raise AssertionError(
            f"segment-masked attention over {k.shape[2]} tokens would "
            f"materialize the full score matrix; reduce seq_pack so the "
            f"packed length stays <= {SHORT_SEQ_THRESHOLD}"
        )
    return einsum_attention(q, k, v, sm_scale=sm_scale, seg_len=seg_len,
                            dropout_rate=dropout_rate, dropout_seed=dropout_seed)
