"""ViT building blocks in PyTorch (port of `ucf_vit_tpu/models/blocks.py`).

Module and parameter names are the reference's torch `state_dict` names
(`ucf_vit_tpu/tools/convert_checkpoint.py:12-30`), so a flax param tree
maps onto them with `ucf_vit_tpu_torch.convert.load_jax_params`. Dropout and
stochastic depth follow `self.training` where the JAX modules take
`deterministic`, and draw their bits from explicit generators that the train
step hands to the model (`set_generator`), never from torch's global one:
`Dropout` and `DropPath` from a generator on the activations' device,
`Attention` its per-call dropout seed from a CPU generator.

Tensor parallelism (`shard_tensor_parallel`) follows the JAX `kernel_axes`
(`ucf_vit_tpu/models/blocks.py:157,166,203,240,386-406`), Megatron-style on
the port's own collectives over the mesh's tp group: `qkv` and `fc1` are
column-parallel (each tp rank keeps the output rows of its heads, or of its
slice of the hidden units), `proj` and `fc2` row-parallel (the matching input
columns; the partial products are summed over tp and the bias is added once,
after the sum). The fused `qkv` keeps q, k and v of a rank's heads, so its
output still views as `[B, N, 3, H/tp, dh]`; `VariableMappingAttention`'s `q`,
`kv` and `proj` split the same way. A column-parallel input passes through
`f_identity_b_allreduce`, so the gradient of the replicated activation is
summed over tp. A module whose heads (or hidden units) do not divide by tp
stays replicated, the JAX package's divisibility rule (`fit_spec_to_shape`),
and so does an `Attention` with `qk_norm`.
Everything else (norms, embeddings, heads, decoders, convolutions) is
replicated over tp.

Under sequence parallelism a block sees this rank's `N/sp` tokens
(`parallel.mesh.sequence_context`): `Attention` runs its `sp_mode`
(`ops/attention.py`), and `Dropout` draws its mask for the whole sequence
and keeps this rank's slice, so that the sp ranks, whose generators are
seeded alike, drop what one device would.

The bf16 compute policy is flax's `dtype=` argument, module by module
(`ucf_vit_tpu/models/blocks.py`): parameters stay f32; `Linear` and the
patch-embed conv cast their input, weight and bias to `dtype` and return it;
`LayerNorm` computes in f32 and returns `dtype`; GELU, dropout and the
residual adds run on the `dtype` tensors. With `dtype=None` every module
computes in the promoted type of its input and parameters, as flax does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ucf_vit_tpu_torch.ops.attention import AttnImpl, multi_head_attention
from ucf_vit_tpu_torch.ops.attn_dropout import draw_seed
from ucf_vit_tpu_torch.parallel.collectives import f_allreduce_b_identity, f_identity_b_allreduce
from ucf_vit_tpu_torch.parallel.mesh import seq_shard

# how a tensor-parallel parameter splits over tp, by the torch layout
# ([out, in] weights): "rows" the output rows of a column-parallel layer (and its
# bias), "cols" the input columns of a row-parallel one, "qkv" / "kv" the rows
# of a fused projection of 3 / 2 parts, each part split alike (by heads); the MoE
# experts' leaves (`models/moe.py`) split their hidden dim: "cols" (dim 1) and
# "dim2"
TP_PARTS = {"rows": 1, "qkv": 3, "kv": 2}
TP_DIM = {"cols": 1, "dim2": 2}  # the kinds that split one dim whole


def tp_slice(t: torch.Tensor, kind: str, rank: int, size: int) -> torch.Tensor:
    """Tensor-parallel rank `rank`'s piece of the full parameter `t`."""
    if kind in TP_DIM:
        return t.chunk(size, dim=TP_DIM[kind])[rank]
    parts = t.chunk(TP_PARTS[kind], dim=0)
    return torch.cat([p.chunk(size, dim=0)[rank] for p in parts], dim=0)


def tp_merge(pieces, kind: str) -> torch.Tensor:
    """The full parameter from the tp ranks' pieces, in rank order (the
    inverse of `tp_slice`)."""
    if kind in TP_DIM:
        return torch.cat(list(pieces), dim=TP_DIM[kind])
    n = TP_PARTS[kind]
    split = [p.chunk(n, dim=0) for p in pieces]
    return torch.cat([torch.cat([s[i] for s in split], dim=0) for i in range(n)], dim=0)


def _row_parallel(linear: "Linear", x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel Linear: the local product, summed over tp, then the
    bias once."""
    dt = linear.dtype or torch.promote_types(x.dtype, linear.weight.dtype)
    y = f_allreduce_b_identity(F.linear(x.to(dt), linear.weight.to(dt)), group)
    return y if linear.bias is None else y + linear.bias.to(dt)


class TensorParallel:
    """What a tensor-parallel module keeps: its parameters' split (`tp_layout`,
    by name under the module) and the tp group once split."""

    tp_group = None

    def tp_layout(self) -> dict:
        raise NotImplementedError

    def tp_divides(self, size: int) -> bool:
        raise NotImplementedError

    @torch.no_grad()
    def shard_tensor_parallel(self, group, rank: int, size: int) -> bool:
        """Keep rank `rank`'s piece of each split parameter, in place; returns
        False (and changes nothing) where the module stays replicated."""
        if size <= 1 or not self.tp_divides(size):
            return False
        params = dict(self.named_parameters())
        for name, kind in self.tp_layout().items():
            if name in params:
                p = params[name]
                p.data = tp_slice(p.data, kind, rank, size).contiguous()
        self.tp_group = group
        return True


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-6) that takes its statistics in f32 and returns
    `dtype`, or with `dtype=None` the promoted type of input and parameters
    (flax `nn.LayerNorm(dtype=...)`)."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=1e-6)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(out)


def layer_norm(dim: int, dtype: Optional[torch.dtype] = None) -> LayerNorm:
    return LayerNorm(dim, dtype=dtype)


class Linear(nn.Linear):
    """`nn.Linear` with flax's `Dense(dtype=...)` policy: the f32 parameters
    are cast to `dtype` with the input on every call, and the output has
    `dtype` (`dtype=None`: the promoted type of input and parameters). The
    cast is part of the graph, so the parameters' gradients arrive in f32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def shard_tensor_parallel(model: nn.Module, group, rank: int, size: int) -> dict:
    """Split every tensor-parallel module of `model` over the tp group, in
    place; returns `{parameter name: split kind}` of what was split (the
    checkpoint's gather and the sync check read it)."""
    names, layout = {n for n, _ in model.named_parameters()}, {}
    for prefix, m in model.named_modules():
        if isinstance(m, TensorParallel) and m.shard_tensor_parallel(group, rank, size):
            for name, kind in m.tp_layout().items():
                full = f"{prefix}.{name}" if prefix else name
                if full in names:
                    layout[full] = kind
    return layout


def set_generator(module: nn.Module, generator: torch.Generator,
                  host_generator: torch.Generator) -> None:
    """Hand the train step's generators to every submodule that draws:
    `generator` (on the activations' device) to `Dropout` and `DropPath`,
    `host_generator` (on the CPU) to `Attention` for its dropout seeds."""
    if host_generator.device.type != "cpu":
        raise ValueError("host_generator must be a CPU generator")
    for m in module.modules():
        if isinstance(m, (Dropout, DropPath)):
            m.generator = generator
        elif isinstance(m, Attention):
            m.host_generator = host_generator


def _bernoulli_keep(shape, keep: float, x: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        raise RuntimeError(
            "dropout needs an explicit torch.Generator: call model.set_generator(...) "
            "(the train step does) before training"
        )
    return torch.rand(shape, device=x.device, generator=generator) < keep


class Dropout(nn.Module):
    """Element dropout (flax `nn.Dropout` semantics) drawing from an explicit
    generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shard = seq_shard()
        if shard is not None:  # x: [B, N/sp, ...]
            n = x.shape[1]
            shape = (x.shape[0], n * shard.size) + tuple(x.shape[2:])
            mask = _bernoulli_keep(shape, keep, x, self.generator)[:, shard.rank * n:
                                                                     (shard.rank + 1) * n]
        else:
            mask = _bernoulli_keep(x.shape, keep, x, self.generator)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath semantics)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = _bernoulli_keep(shape, keep, x, self.generator)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.init_values = float(init_values)
        self.gamma = nn.Parameter(torch.full((dim,), self.init_values))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class PatchEmbed(nn.Module):
    """2D/3D image -> patch tokens via a conv with stride = patch size.

    Input is channels-first ([B, C, H, W] or [B, C, H, W, D]); output is
    [B, L, D] with tokens in h-major order, as the JAX module's reshape of
    its channels-last conv output gives them."""

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int,
                 twoD: bool = True, use_norm: bool = False, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        conv = nn.Conv2d if twoD else nn.Conv3d
        self.proj = conv(in_chans, embed_dim, patch_size, stride=patch_size, bias=bias)
        self.norm = layer_norm(embed_dim) if use_norm else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = self.proj
        dt = self.dtype or torch.promote_types(x.dtype, proj.weight.dtype)
        conv = F.conv2d if isinstance(proj, nn.Conv2d) else F.conv3d
        bias = None if proj.bias is None else proj.bias.to(dt)
        x = conv(x.to(dt), proj.weight.to(dt), bias, stride=proj.stride)
        x = x.flatten(2).transpose(1, 2)
        if self.norm is not None:
            x = self.norm(x)
        return x


class LinearTokenEmbed(nn.Sequential):
    """Token embed of adaptively pre-patched input (`ucf_vit_tpu/models/
    blocks.py:321`): LayerNorm -> Linear -> LayerNorm, `[B, L, F] -> [B, L,
    D]`, as the reference's `nn.Sequential` (state names `0`, `1`, `2`). It
    takes no `dtype`, as the JAX module does."""

    def __init__(self, in_features: int, embed_dim: int):
        super().__init__(layer_norm(in_features), Linear(in_features, embed_dim),
                         layer_norm(embed_dim))


class AdaptivePosMLP(nn.Sequential):
    """Position embedding from the adaptive patches' `(size, centre...)`
    descriptors (`ucf_vit_tpu/models/blocks.py:335`): Linear(1 + nd -> D),
    then the exact erf GELU whatever the blocks use; `[B, L, 1 + nd] -> [B,
    L, D]`. The Linear is state name `0`, as in the reference."""

    def __init__(self, in_features: int, embed_dim: int):
        super().__init__(Linear(in_features, embed_dim), nn.GELU(approximate="none"))


class Mlp(nn.Module, TensorParallel):
    """fc1 -> GELU (tanh approximation unless gelu_approx=False) -> fc2; under
    tensor parallelism fc1 column-parallel and fc2 row-parallel."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0, gelu_approx: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype)
        self.act = nn.GELU(approximate="tanh" if gelu_approx else "none")
        self.drop1 = Dropout(drop)
        self.fc2 = Linear(hidden_features, out_features, dtype=dtype)
        self.drop2 = Dropout(drop)

    def tp_layout(self) -> dict:
        return {"fc1.weight": "rows", "fc1.bias": "rows", "fc2.weight": "cols"}

    def tp_divides(self, size: int) -> bool:
        return self.fc1.out_features % size == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is None:
            return self.drop2(self.fc2(self.drop1(self.act(self.fc1(x)))))
        h = self.drop1(self.act(self.fc1(f_identity_b_allreduce(x, self.tp_group))))
        return self.drop2(_row_parallel(self.fc2, h, self.tp_group))


class EmbeddingDenseLayer(nn.Module):
    """DiffusionVIT's time-embedding MLP (`ucf_vit_tpu/models/blocks.py:347`):
    linear1 -> ReLU -> Dropout(dropout_prob) -> linear2, both linears in the
    promoted type of input and parameters (no `dtype`, as in the JAX layer)."""

    def __init__(self, c_in: int, c_out: int, dropout_prob: float = 0.5):
        super().__init__()
        self.linear1 = Linear(c_in, c_out)
        self.dropout = Dropout(dropout_prob)
        self.linear2 = Linear(c_out, c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.dropout(F.relu(self.linear1(x))))


class Attention(nn.Module, TensorParallel):
    """Multi-head self-attention with impl dispatch.

    The fused qkv output splits into q, k, v on its last dim, then into
    heads (under tensor parallelism the rank's own, as many as its qkv width
    holds); q, k and v go to the attention as strided views of it. In training
    with `attn_drop > 0` each call draws an int32 dropout seed from
    `host_generator` (the role of `seed_from_key` on the JAX side).
    `sp_mode` is the sequence-parallel strategy under sp > 1."""

    def __init__(self, dim: int, num_heads: int, attn_impl: AttnImpl = AttnImpl.AUTO,
                 qkv_bias: bool = False, qk_norm: bool = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, seg_len: Optional[int] = None,
                 sp_mode: str = "auto", dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} must divide by num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.attn_impl = attn_impl
        self.attn_drop = float(attn_drop)
        self.seg_len = seg_len
        self.sp_mode = sp_mode
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.q_norm = layer_norm(self.head_dim, dtype) if qk_norm else None
        self.k_norm = layer_norm(self.head_dim, dtype) if qk_norm else None
        self.proj = Linear(dim, dim, dtype=dtype)
        self.proj_drop = Dropout(proj_drop)
        self.host_generator: Optional[torch.Generator] = None

    def tp_layout(self) -> dict:
        return {"qkv.weight": "qkv", "qkv.bias": "qkv", "proj.weight": "cols"}

    def tp_divides(self, size: int) -> bool:
        # with qk_norm the norms' parameters, shared by every head, would see a
        # rank's heads only; no config sets it, so such a block stays replicated
        return self.num_heads % size == 0 and self.q_norm is None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        tp = self.tp_group
        if tp is not None:
            x = f_identity_b_allreduce(x, tp)
        qkv = self.qkv(x).view(b, n, 3, -1, self.head_dim)
        q, k, v = qkv.unbind(2)  # [B, N, H (local), dh] each
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        rate = self.attn_drop if self.training else 0.0
        out = multi_head_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            impl=self.attn_impl, sm_scale=self.head_dim**-0.5, seg_len=self.seg_len,
            dropout_rate=rate,
            dropout_seed=draw_seed(self.host_generator) if rate > 0.0 else None,
            sp_mode=self.sp_mode,
        )
        out = out.transpose(1, 2).reshape(b, n, -1)
        return self.proj_drop(self.proj(out) if tp is None else _row_parallel(self.proj, out, tp))


class VariableMappingAttention(nn.Module, TensorParallel):
    """Cross attention of a few queries over a few keys, the variable
    embedding's merge (`ucf_vit_tpu/models/blocks.py:362-409`): `q` of the
    queries and the fused `kv` of the inputs without bias, heads of `dim //
    num_heads`, then `proj` with a bias; `[B', Na, D]` queries over `[B', Ni,
    D]` inputs -> `[B', Na, D]`, each Linear in `dtype`. With one query over
    as many keys as variables it runs EINSUM attention, as the JAX module
    does on purpose: a flash kernel's tile would be almost all padding."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 proj_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q = Linear(dim, dim, bias=qkv_bias, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, bias=proj_bias, dtype=dtype)

    def tp_layout(self) -> dict:
        return {"q.weight": "rows", "q.bias": "rows", "kv.weight": "kv", "kv.bias": "kv",
                "proj.weight": "cols"}

    def tp_divides(self, size: int) -> bool:
        return self.num_heads % size == 0

    def forward(self, var_query: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        bq, n_a, c = var_query.shape
        n_i = x.shape[1]
        dh = self.head_dim
        tp = self.tp_group
        if tp is not None:
            var_query, x = f_identity_b_allreduce(var_query, tp), f_identity_b_allreduce(x, tp)
        q = self.q(var_query).view(bq, n_a, -1, dh).transpose(1, 2)
        k, v = self.kv(x).view(bq, n_i, 2, -1, dh).unbind(2)
        out = multi_head_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                   impl=AttnImpl.EINSUM, sm_scale=dh**-0.5)
        out = out.transpose(1, 2).reshape(bq, n_a, -1)
        return self.proj(out) if tp is None else _row_parallel(self.proj, out, tp)


class Block(nn.Module):
    """Pre-norm transformer block; with `moe_num_experts > 1` its MLP is a
    routed mixture of experts, `moe_mlp` in place of `mlp`
    (`ucf_vit_tpu/models/blocks.py:291-302`)."""

    def __init__(self, dim: int, num_heads: int, attn_impl: AttnImpl = AttnImpl.AUTO,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False, qk_norm: bool = False,
                 proj_drop: float = 0.0, attn_drop: float = 0.0,
                 init_values: Optional[float] = None, drop_path: float = 0.0,
                 gelu_approx: bool = True, seg_len: Optional[int] = None,
                 sp_mode: str = "auto", dtype: Optional[torch.dtype] = None,
                 moe_num_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        self.norm1 = layer_norm(dim, dtype)
        self.attn = Attention(dim, num_heads, attn_impl=attn_impl, qkv_bias=qkv_bias,
                              qk_norm=qk_norm, attn_drop=attn_drop, proj_drop=proj_drop,
                              seg_len=seg_len, sp_mode=sp_mode, dtype=dtype)
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = layer_norm(dim, dtype)
        self.is_moe = moe_num_experts > 1
        if self.is_moe:
            from ucf_vit_tpu_torch.models.moe import MoeMlp

            self.moe_mlp = MoeMlp(dim, int(dim * mlp_ratio), moe_num_experts, top_k=moe_top_k,
                                  capacity_factor=moe_capacity_factor,
                                  gelu_approx=gelu_approx, dtype=dtype)
        else:
            self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop=proj_drop,
                           gelu_approx=gelu_approx, dtype=dtype)
        self.ls2 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path1(self.ls1(self.attn(self.norm1(x))))
        mlp = self.moe_mlp if self.is_moe else self.mlp
        return x + self.drop_path2(self.ls2(mlp(self.norm2(x))))
