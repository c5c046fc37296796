"""VIT encoder + classification head (port of `ucf_vit_tpu/models/vit.py`).

The port has the model for serving and training: conv patch embed, class
token, learned position embedding initialised from the sincos table, patch
dropout, pre-norm blocks (each under activation checkpointing with
`remat`), final norm, class-token pool and head, in f32 or under the bf16
compute policy (`dtype`, see `models/blocks.py`).

Adaptive patching (the quadtree's tokens, `data/transform.py`): the input
is the serialized sequence `[B, C, L, p^nd]` of `fixed_length` patches,
embedded by `LinearTokenEmbed` over `[B, L, p^nd * C]` (the channel
fastest); the learned position table is drawn `0.02 * N(0, 1)`, and with
`use_adaptive_pos_emb` the patches' `(size, centre...)` descriptors `seq_ps`
`[B, L, 1 + nd]` go through `AdaptivePosMLP` instead (a zero row for the
class token). The table stays in the parameters either way, as in the JAX
model. With `sqrt_len_method` (UNETR's adaptive input) the caller reassembles
the sequence into an image of `(sqrt_len * p)^nd` pixels
(`tasks.reassemble_sqrt_len`), which the conv patch embed tokenizes into
`sqrt_len^nd` tokens with the sincos table of that grid. `forward_intermediates`
also returns the un-normed outputs of chosen blocks (UNETR's skips).

The variable embedding (`use_varemb`, `ucf_vit_tpu/models/vit.py:230-518`):
one token embed per variable of `default_vars` (a conv patch embed of one
channel, or a `LinearTokenEmbed` of `p^nd` features), each variable's tokens
plus its row of `var_embed` (the 1-D sincos table over the variables), and
the variables of a sample merged token by token by `VariableMappingAttention`
(one learned query, `var_query`, over the variables' tokens). `var_ids`, the
indices of the batch's `variables` in `default_vars` (`get_var_ids`), says
which embed each input channel takes; a `single_channel` batch is one
variable's and is not merged. Pipelined blocks raise NotImplementedError
until their slice (ROADMAP.md, item 12).

Mixture of experts (`moe_num_experts > 1`, `models/moe.py`): block i's MLP
is a `MoeMlp` where `i % moe_every == moe_every - 1` (the V-MoE placement,
`ucf_vit_tpu/models/vit.py:376-388,428-437`); under `scan_layers` every
block must be one (`moe_every: 1`). MAE's and DiffusionVIT's decoder blocks
stay dense, as in the JAX package. After each run of the encoder's blocks
(`forward_features`, `forward_intermediates`) `moe_aux` holds the mean of
their load-balance losses, which the task losses add (`tasks.moe_aux`); a
dense model's is None. A MoE model sets `couples_samples` (its loss is not a
mean over samples), which the train step reads under accumulation.

Sequence parallelism (a model on a mesh with sp > 1, `shard_model`): each
block stack (`_run_stack`: the encoder's blocks, and MAE's and
DiffusionVIT's decoder blocks) splits its token stream over the sp group
(`parallel.collectives.split`), runs its blocks on this rank's `N/sp`
tokens inside `parallel.mesh.sequence_context` (the attention's `sp_mode`,
the element dropout's slice) and joins the stream after them
(`all_gather`); embeddings, masking, norms and heads run on the whole
sequence on every sp rank. A stack whose blocks attend within segments
(`seq_pack`) runs whole; so does one whose tokens sp does not divide, under
EINSUM, and under FLASH it raises ValueError, as the JAX package's
`shard_map` does. `forward_intermediates` (UNETR's encoder) runs the same
split and gathers each tap; where sp does not divide its tokens it runs
whole under any attention, FLASH too (the JAX package leaves that dim
whole, where its f32 `AUTO` attends by EINSUM). Under `remat` the recompute runs the block inside the
same context, so it makes the same collectives in the same order on every
rank.

`scan_layers` names a parameter layout of the JAX package (block leaves
stacked `[depth, ...]` under `lax.scan`, which keeps XLA's compile time
constant in depth). PyTorch runs eagerly and has no compile time in depth,
so the port runs the same `nn.ModuleList` either way; the flag is accepted
under the JAX package's conditions, and `convert.load_jax_params` unstacks a
scanned tree.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ucf_vit_tpu_torch.models.blocks import (
    AdaptivePosMLP,
    Block,
    Dropout,
    LayerScale,
    Linear,
    LinearTokenEmbed,
    PatchEmbed,
    VariableMappingAttention,
    layer_norm,
    set_generator,
)
from ucf_vit_tpu_torch.models.moe import MoeMlp, collect_moe_aux
from ucf_vit_tpu_torch.ops.attention import AttnImpl, resolve_impl
from ucf_vit_tpu_torch.parallel.collectives import all_gather, split
from ucf_vit_tpu_torch.parallel.mesh import seq_shard_of, sequence_context
from ucf_vit_tpu_torch.ops.pos_embed import (
    get_1d_sincos_pos_embed_from_grid,
    get_2d_sincos_pos_embed,
    get_3d_sincos_pos_embed,
)

# flax's truncated_normal(stddev) draws from N(0, 1) cut at +-2 and rescales
# by this constant so that the result has the requested stddev
_TRUNC_STD_CORRECTION = 0.87962566103423978


def _to_tuple(img_size, twoD: bool) -> Tuple[int, ...]:
    n = 2 if twoD else 3
    if isinstance(img_size, int):
        return (img_size,) * n
    t = tuple(img_size)
    if len(t) != n:
        raise ValueError(f"img_size {img_size} does not match twoD={twoD}")
    return t


def _not_ported(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported yet (ROADMAP.md, modules to port: {item})"
    )


def _checkpoint(fn, *xs: torch.Tensor) -> torch.Tensor:
    return checkpoint(fn, *xs, use_reentrant=False, preserve_rng_state=False,
                      determinism_check="none")


class VIT(nn.Module):
    """ViT encoder (+ optional classification head)."""

    def __init__(
        self,
        img_size: Sequence[int] = (224, 224),
        patch_size: int = 16,
        in_chans: int = 3,
        num_classes: Optional[int] = None,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        qk_norm: bool = False,
        init_values: Optional[float] = None,
        class_token: bool = True,
        pos_embed: str = "learn",
        drop_rate: float = 0.0,
        pos_drop_rate: float = 0.0,
        patch_drop_rate: float = 0.0,
        proj_drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        twoD: bool = True,
        attn_impl: AttnImpl = AttnImpl.AUTO,
        gelu_approx: bool = True,
        adaptive_patching: bool = False,
        fixed_length: Optional[int] = None,
        use_adaptive_pos_emb: bool = False,
        sqrt_len_method: bool = False,
        use_varemb: bool = False,
        default_vars: Optional[Sequence[str]] = None,
        single_channel: bool = False,
        remat: bool = False,
        scan_layers: bool = False,
        pipe_par_size: int = 1,
        moe_num_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity_factor: float = 1.25,
        moe_every: int = 2,
        sp_mode: str = "auto",
        dtype: Optional[torch.dtype] = None,
        # the encoder blocks attend within segments of this length (MAE's seq_pack)
        block_seg_len: Optional[int] = None,
    ):
        super().__init__()
        if use_varemb and not default_vars:
            raise ValueError("use_varemb needs default_vars (the variables' names)")
        if adaptive_patching and not fixed_length:
            raise ValueError("adaptive_patching needs fixed_length")
        if pipe_par_size > 1:
            raise _not_ported("pipe_par_size > 1", "pipeline, item 12")
        moe_on = moe_num_experts > 1
        if moe_on and scan_layers and moe_every != 1:
            # the JAX model's assertion (`ucf_vit_tpu/models/vit.py:377-383`)
            raise AssertionError(
                "scan_layers stacks identical blocks; MoE under scan "
                "requires moe_every == 1 (or use scan_layers=False for "
                "the V-MoE every-2 placement)"
            )
        if scan_layers and drop_path_rate != 0.0:
            raise ValueError("scan_layers requires drop_path_rate == 0")
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be None, float32 or bfloat16, got {dtype}")
        if pos_embed not in ("", "none", "learn"):
            raise ValueError(f"pos_embed must be '', 'none' or 'learn', got {pos_embed!r}")

        self.twoD = twoD
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.grid_size = tuple(s // patch_size for s in _to_tuple(img_size, twoD))
        self.adaptive_patching = bool(adaptive_patching)
        self.use_adaptive_pos_emb = bool(use_adaptive_pos_emb)
        nd = len(self.grid_size)
        # the sqrt-len method: the side of the token grid of the reassembled image
        self.sqrt_len = (int(round(fixed_length ** (1.0 / nd)))
                         if adaptive_patching and sqrt_len_method else None)
        # adaptive tokens embedded by LinearTokenEmbed (else a conv on an image)
        self.adaptive_linear = self.adaptive_patching and self.sqrt_len is None
        # the grid the tokens lie on, for the sincos table
        self.token_grid = (self.grid_size if self.sqrt_len is None
                           else (self.sqrt_len,) * nd)
        self.num_patches = (int(fixed_length) if self.adaptive_linear
                            else int(np.prod(self.token_grid)))
        # a token's features: p^nd pixels of every channel
        self.patch_dim = in_chans * patch_size ** len(self.grid_size)
        self.num_prefix_tokens = 1 if class_token else 0
        self.patch_drop_rate = float(patch_drop_rate)
        self.remat = bool(remat)
        self.scan_layers = bool(scan_layers)
        self.dtype = dtype
        # the blocks draw (and a recompute under remat must draw again) only
        # when one of their rates is not 0
        self._blocks_draw = any(r > 0 for r in (proj_drop_rate, attn_drop_rate,
                                                drop_path_rate))
        self.generator: Optional[torch.Generator] = None
        self.host_generator: Optional[torch.Generator] = None

        self.use_varemb = bool(use_varemb)
        self.default_vars = tuple(default_vars or ())
        self.single_channel = bool(single_channel)
        if self.use_varemb:
            # one embed a variable, each of one channel
            p_nd = patch_size ** nd
            self.token_embeds = nn.ModuleList(
                LinearTokenEmbed(p_nd, embed_dim) if self.adaptive_linear
                else PatchEmbed(patch_size, embed_dim, 1, twoD=twoD, dtype=dtype)
                for _ in self.default_vars)
        else:
            self.token_embeds = (
                LinearTokenEmbed(self.patch_dim, embed_dim) if self.adaptive_linear
                else PatchEmbed(patch_size, embed_dim, in_chans, twoD=twoD, dtype=dtype))
        self.cls_token = (
            nn.Parameter(torch.zeros(1, 1, embed_dim)) if class_token else None
        )
        self.pos_embed = (
            nn.Parameter(torch.zeros(1, self.num_patches + self.num_prefix_tokens, embed_dim))
            if pos_embed == "learn" else None
        )
        self.adaptive_pos_dep_emb = (
            AdaptivePosMLP(1 + nd, embed_dim) if use_adaptive_pos_emb
            else None
        )
        n_vars = len(self.default_vars)
        self.var_embed = (nn.Parameter(torch.zeros(1, n_vars, embed_dim)) if self.use_varemb
                          else None)
        # the variables are merged only where a sample holds more than one
        merge = self.use_varemb and not self.single_channel and n_vars > 1
        self.var_query = nn.Parameter(torch.zeros(1, 1, embed_dim)) if merge else None
        self.var_agg = (VariableMappingAttention(embed_dim, num_heads, dtype=dtype) if merge
                        else None)
        self.pos_drop = Dropout(pos_drop_rate)
        self.drop_path_rate = float(drop_path_rate)
        # what every block of the model shares (MAE's decoder blocks too)
        self.block_kwargs = dict(attn_impl=attn_impl, qkv_bias=qkv_bias, qk_norm=qk_norm,
                                 proj_drop=proj_drop_rate, attn_drop=attn_drop_rate,
                                 init_values=init_values, gelu_approx=gelu_approx,
                                 sp_mode=sp_mode, dtype=dtype)
        dpr = np.linspace(0.0, drop_path_rate, depth)
        # the loss is no mean of per-sample terms where the MoE aux takes batch means:
        # the train step then splits the global batch into microbatches as one device
        self.couples_samples = moe_on
        moe = dict(moe_num_experts=moe_num_experts, moe_top_k=moe_top_k,
                   moe_capacity_factor=moe_capacity_factor)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio=mlp_ratio, drop_path=float(dpr[i]),
                  seg_len=block_seg_len, **self.block_kwargs,
                  **(moe if moe_on and i % moe_every == moe_every - 1 else {}))
            for i in range(depth)
        )
        self.moe_aux: Optional[torch.Tensor] = None
        # the final norm and the head take no dtype in the JAX model
        # (`ucf_vit_tpu/models/vit.py:441,454`): they compute in the promoted
        # type, so the logits are f32 under the bf16 policy too
        self.norm = layer_norm(embed_dim)
        self.head_drop = Dropout(drop_rate)
        self.head = (
            Linear(embed_dim, num_classes) if num_classes is not None and num_classes > 0
            else None
        )

    # ---------------------------------------------------------------- params

    def var_map(self) -> dict:
        return {v: i for i, v in enumerate(self.default_vars)}

    def get_var_ids(self, variables: Sequence[str]) -> Tuple[int, ...]:
        """The indices of `variables` in `default_vars`: which token embed
        and `var_embed` row each input channel takes."""
        m = self.var_map()
        return tuple(m[v] for v in variables)

    def sincos_table(self) -> np.ndarray:
        g = self.token_grid
        with_cls = self.cls_token is not None
        if self.twoD:
            return get_2d_sincos_pos_embed(self.embed_dim, g[0], g[1], cls_token=with_cls)
        return get_3d_sincos_pos_embed(self.embed_dim, g[0], g[1], g[2], cls_token=with_cls)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VIT":
        """The JAX package's initialisers, drawn from `generator`: truncated
        normal (std 0.02) kernels, zero biases, unit LayerNorm scales, class
        token N(0, 1e-6), position embedding from the sincos table (adaptive
        tokens embedded by LinearTokenEmbed: 0.02 * N(0, 1)), `var_embed` from
        the 1-D sincos table over the variables, `var_query` zero. The numbers
        differ from flax's for the same seed; the distributions agree."""
        std = 0.02 / _TRUNC_STD_CORRECTION
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                              nn.ConvTranspose3d)):
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(m.init_values)
            elif isinstance(m, MoeMlp):
                m.init_weights(generator, std)
        if self.cls_token is not None:
            nn.init.normal_(self.cls_token, std=1e-6, generator=generator)
        if self.pos_embed is not None and self.adaptive_linear:
            self.pos_embed.normal_(generator=generator).mul_(0.02)
        elif self.pos_embed is not None:
            table = torch.from_numpy(self.sincos_table()).to(self.pos_embed.dtype)
            self.pos_embed.copy_(table.reshape(self.pos_embed.shape))
        if self.var_embed is not None:
            table = get_1d_sincos_pos_embed_from_grid(self.embed_dim,
                                                      np.arange(len(self.default_vars)))
            self.var_embed.copy_(torch.from_numpy(table).reshape(self.var_embed.shape))
        if self.var_query is not None:
            self.var_query.zero_()
        return self

    def set_generator(self, generator: torch.Generator,
                      host_generator: torch.Generator) -> "VIT":
        """Hand the train step's generators to every module that draws
        (`models.blocks.set_generator`); the model keeps both for patch
        dropout and for replaying the blocks' draws under `remat`."""
        set_generator(self, generator, host_generator)
        self.generator, self.host_generator = generator, host_generator
        return self

    # --------------------------------------------------------------- forward

    def embed_tokens(self, x: torch.Tensor,
                     var_ids: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Tokenize the input image (with the sqrt-len method the reassembled
        one), or with adaptive patching the sequence `[B, C, L, p^nd]` as
        `[B, L, p^nd * C]` (the channel fastest): `[B, L, D]`. With
        `use_varemb`, channel i by the embed of variable `var_ids[i]`."""
        if self.use_varemb:
            return self._embed_variables(x, var_ids)
        if self.adaptive_linear:
            b, c, s, p = x.shape
            x = x.permute(0, 2, 3, 1).reshape(b, s, p * c)
        return self.token_embeds(x)

    def _embed_variables(self, x: torch.Tensor, var_ids: Optional[Sequence[int]]
                         ) -> torch.Tensor:
        """`embed_tokens` with `use_varemb` (`ucf_vit_tpu/models/vit.py:463-501`):
        a `single_channel` input is variable `var_ids[0]`'s tokens plus its
        `var_embed` row; otherwise each channel's tokens plus its variable's
        row, merged by `aggregate_variables` where there is more than one.
        The f32 rows promote a bf16 embedding to f32, as in the JAX model."""
        if var_ids is None:
            raise ValueError("use_varemb needs var_ids (model.get_var_ids(batch['variables']))")
        if self.single_channel:
            vid = var_ids[0]
            x = self.token_embeds[vid](x[:, 0] if self.adaptive_linear else x)
            return x + self.var_embed[:, vid:vid + 1]
        embeds = [self.token_embeds[vid](x[:, i] if self.adaptive_linear else x[:, i:i + 1])
                  for i, vid in enumerate(var_ids)]
        var_embed = self.var_embed[:, list(var_ids)]  # [1, V, D]
        if len(var_ids) > 1:
            x = torch.stack(embeds, dim=1) + var_embed[:, :, None, :]  # [B, V, L, D]
            return self.aggregate_variables(x)
        return embeds[0] + var_embed

    def aggregate_variables(self, x: torch.Tensor) -> torch.Tensor:
        """`[B, V, L, D]` -> `[B, L, D]`: at every token, `var_query` attends
        over the V variables' tokens (`ucf_vit_tpu/models/vit.py:503-518`)."""
        b, v, l, d = x.shape
        x = x.transpose(1, 2).reshape(b * l, v, d)
        out = self.var_agg(self.var_query.expand(b * l, -1, -1), x)  # [B * L, 1, D]
        return out.reshape(b, l, d)

    def apply_pos_embed(self, x: torch.Tensor,
                        seq_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prepend the class token and add the position embedding: the table,
        or with `use_adaptive_pos_emb` the MLP of the descriptors `seq_ps`
        `[B, L, 1 + nd]`, a zero row first for the class token; either in
        the stream's dtype. Without a position embedding the JAX model
        prepends no class token either."""
        if self.pos_embed is None:
            return x
        if self.adaptive_pos_dep_emb is not None:
            if seq_ps is None:
                raise ValueError("use_adaptive_pos_emb needs seq_ps")
            pos = self.adaptive_pos_dep_emb(seq_ps).to(x.dtype)
        else:
            pos = self.pos_embed.to(x.dtype)
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1).to(x.dtype), x], dim=1)
            if self.adaptive_pos_dep_emb is not None:
                pos = torch.cat([pos.new_zeros(pos.shape[0], 1, pos.shape[2]), pos], dim=1)
        return self.pos_drop(x + pos)

    def patch_drop(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """timm-semantics PatchDropout (`ucf_vit_tpu/models/vit.py:550`): in
        training keep a random `max(1, int(L * (1 - rate)))` subset of the
        non-prefix tokens, per sample, in the order of their noise; identity
        in eval. `noise` `[B, L]` replaces the draw from the model's
        generator (the tests inject the JAX side's noise)."""
        if self.patch_drop_rate <= 0 or not self.training:
            return x
        npt = self.num_prefix_tokens
        prefix, tokens = x[:, :npt], x[:, npt:]
        b, l, d = tokens.shape
        num_keep = max(1, int(l * (1.0 - self.patch_drop_rate)))
        if noise is None:
            if self.generator is None:
                raise RuntimeError(
                    "patch dropout needs an explicit torch.Generator: call "
                    "model.set_generator(...) (the train step does) before training"
                )
            noise = torch.rand(b, l, device=x.device, generator=self.generator)
        keep = torch.argsort(noise, dim=-1, stable=True)[:, :num_keep]
        tokens = torch.gather(tokens, 1, keep[:, :, None].expand(-1, -1, d))
        return torch.cat([prefix, tokens], dim=1) if npt else tokens

    def _remat_block(self, blk, x: torch.Tensor) -> torch.Tensor:
        """`blk(x)` under activation checkpointing (flax `nn.remat(Block)`,
        `ucf_vit_tpu/models/vit.py:359`): the backward runs the block's
        forward again instead of keeping its activations. `checkpoint`
        restores only torch's global generator, and the port draws from
        explicit ones, so when the blocks draw, the recompute puts the
        generators back to their state at the block's first run, draws the
        same dropout masks, DropPath masks and attention seeds again, and
        then returns the generators to where the step had left them. For the
        same reason `checkpoint` is told not to save and restore the global
        generators' state around every block (nothing here draws from them),
        nor to compare every recomputed tensor's metadata with the first
        run's: both are host work on every block of every microbatch."""
        if not self._blocks_draw:
            return _checkpoint(blk, x)
        gens = [g for g in (self.generator, self.host_generator) if g is not None]
        at_first_run = [g.get_state() for g in gens]
        first_run = [True]

        def run(x):
            if first_run[0]:
                first_run[0] = False
                return blk(x)
            now = [g.get_state() for g in gens]
            for g, state in zip(gens, at_first_run):
                g.set_state(state)
            try:
                return blk(x)
            finally:
                for g, state in zip(gens, now):
                    g.set_state(state)

        return _checkpoint(run, x)

    def _run_stack(self, blocks: nn.ModuleList, x: torch.Tensor,
                   taps: Optional[Sequence[int]] = None, whole_any_impl: bool = False):
        """`blocks` in order, each under `remat` in training; under sp > 1 on
        this rank's slice of the tokens (see the module's docstring). With
        `taps`, `(output, [the outputs of blocks taps, whole])`. Where sp does
        not divide the tokens, `whole_any_impl` runs the stack whole under any
        attention (UNETR's encoder) where FLASH would raise."""
        remat = self.remat and self.training and torch.is_grad_enabled()
        shard = seq_shard_of(getattr(self, "mesh", None))
        if shard is not None and any(b.attn.seg_len is not None for b in blocks):
            shard = None  # segments attend within themselves: the stack runs whole
        if shard is not None and x.shape[1] % shard.size:
            if not whole_any_impl and any(resolve_impl(b.attn.attn_impl, x.device)
                                          == AttnImpl.FLASH for b in blocks):
                # what the JAX package's shard_map says of a sequence sp does not divide
                raise ValueError(
                    f"flash attention under seq_par_size {shard.size} needs the sequence "
                    f"({x.shape[1]} tokens) to divide by it; use attn_impl EINSUM or a "
                    "sequence that divides")
            shard = None  # the attention runs over the whole stream, as on one device
        join = (lambda t: t) if shard is None else (
            lambda t: all_gather(t, shard.group, axis=1))
        if shard is not None:
            x = split(x, shard.group, axis=1)
        take, outs = set(taps or ()), []
        for i, blk in enumerate(blocks):
            def fn(x, blk=blk):
                with sequence_context(shard):
                    return blk(x)
            x = self._remat_block(fn, x) if remat else fn(x)
            if i in take:
                outs.append(join(x))
        moe = [b.moe_mlp for b in blocks if b.is_moe]
        if moe:  # the encoder's: the decoders' blocks are dense
            self.moe_aux = collect_moe_aux(moe)
        return join(x) if taps is None else (join(x), outs)

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder's blocks."""
        return self._run_stack(self.blocks, x)

    def forward_features(self, x: torch.Tensor,
                         patch_drop_noise: Optional[torch.Tensor] = None,
                         seq_ps: Optional[torch.Tensor] = None,
                         var_ids: Optional[Sequence[int]] = None) -> torch.Tensor:
        x = self.apply_pos_embed(self.embed_tokens(x, var_ids), seq_ps)
        x = self.patch_drop(x, patch_drop_noise)
        return self.norm(self.run_blocks(x))

    def forward_intermediates(self, x: torch.Tensor, indices: Sequence[int] = (),
                              seq_ps: Optional[torch.Tensor] = None,
                              patch_drop_noise: Optional[torch.Tensor] = None,
                              var_ids: Optional[Sequence[int]] = None):
        """`(normed output, [the un-normed outputs of blocks `indices`, prefix
        tokens stripped])` (`ucf_vit_tpu/models/vit.py:617-656`)."""
        x = self.apply_pos_embed(self.embed_tokens(x, var_ids), seq_ps)
        x = self.patch_drop(x, patch_drop_noise)
        x, taps = self._run_stack(self.blocks, x, taps=indices, whole_any_impl=True)
        return self.norm(x), [t[:, self.num_prefix_tokens:] for t in taps]

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        """Class-token pool (or strip the prefix)."""
        if self.num_prefix_tokens == 1:
            return x[:, 0]
        return x[:, self.num_prefix_tokens:]

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head_drop(self.pool(x))
        return x if self.head is None else self.head(x)

    def forward(self, x: torch.Tensor, patch_drop_noise: Optional[torch.Tensor] = None,
                seq_ps: Optional[torch.Tensor] = None,
                var_ids: Optional[Sequence[int]] = None) -> torch.Tensor:
        return self.forward_head(self.forward_features(x, patch_drop_noise, seq_ps, var_ids))
