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
Sequence parallelism (sp > 1) is not ported and raises.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from ucf_vit_tpu_torch.ops.attn_dropout import dense_keep_mask, fold_seed
from ucf_vit_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE, flash_attention
from ucf_vit_tpu_torch.parallel.mesh import active_mesh

# The most keys that segment-masked attention under FLASH may take (routed to
# EINSUM, which holds the whole [Nq, Nkv] score matrix).
SHORT_SEQ_THRESHOLD = 1024


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
) -> torch.Tensor:
    """Reference attention: full score matrix, f32 softmax. [B, H, N, dh].

    seg_len: block-diagonal masking for sequence-packed batches (tokens only
    attend within their own seg_len-sized segment).
    dropout_rate/dropout_seed: drop post-softmax probabilities where the hash
    mask of `dropout_seed` says so and rescale survivors by 1/(1 - rate)."""
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
        keep = dense_keep_mask(dropout_seed, b * h, n_q, n_kv, dropout_rate,
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
) -> torch.Tensor:
    """Dispatch scaled-dot-product attention over [B, H, N, dh] inputs.

    seg_len routes FLASH to EINSUM (the kernel has no segment mask) and
    raises AssertionError past SHORT_SEQ_THRESHOLD keys there; EINSUM asked
    for by name takes any length.
    dropout_rate > 0 needs an int32 `dropout_seed`; FLASH drops inside the
    kernels and EINSUM with the same hash mask, both with the seed folded by
    the active mesh's coordinates (`sharded_seed`). The XLA impl and
    sequence parallelism are not ported and raise NotImplementedError."""
    mesh = active_mesh()
    if mesh is not None and mesh.size("sp") > 1:
        raise NotImplementedError(
            "sequence-parallel attention (seq_par_size > 1) is not ported yet "
            "(ROADMAP.md, modules to port, item 11: sequence parallelism)")
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
