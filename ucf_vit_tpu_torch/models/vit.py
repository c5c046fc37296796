"""VIT encoder + classification head (port of `ucf_vit_tpu/models/vit.py`).

The port has the non-adaptive model, for serving and training: conv patch
embed, class token, learned position embedding initialised from the sincos
table, pre-norm blocks, final norm, class-token pool and head. Adaptive
patching, variable embeddings, scanned or pipelined blocks, MoE, patch
dropout in training and the bf16 compute policy raise NotImplementedError
until their slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ucf_vit_tpu_torch.models.blocks import (
    Block,
    Dropout,
    LayerScale,
    PatchEmbed,
    layer_norm,
    set_generator,
)
from ucf_vit_tpu_torch.ops.attention import AttnImpl
from ucf_vit_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed, get_3d_sincos_pos_embed

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
        use_varemb: bool = False,
        scan_layers: bool = False,
        pipe_par_size: int = 1,
        moe_num_experts: int = 0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if adaptive_patching:
            raise _not_ported("adaptive patching", "VIT input variants")
        if use_varemb:
            raise _not_ported("use_varemb", "VIT input variants")
        if scan_layers or pipe_par_size > 1:
            raise _not_ported("scan_layers / pipe_par_size", "pipeline + MoE")
        if moe_num_experts > 1:
            raise _not_ported("MoE blocks", "pipeline + MoE")
        if dtype is not None:
            raise _not_ported("the bf16 compute policy", "training remainder")
        if pos_embed not in ("", "none", "learn"):
            raise ValueError(f"pos_embed must be '', 'none' or 'learn', got {pos_embed!r}")

        self.twoD = twoD
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.grid_size = tuple(s // patch_size for s in _to_tuple(img_size, twoD))
        self.num_patches = int(np.prod(self.grid_size))
        self.num_prefix_tokens = 1 if class_token else 0
        self.patch_drop_rate = float(patch_drop_rate)

        self.token_embeds = PatchEmbed(patch_size, embed_dim, in_chans, twoD=twoD)
        self.cls_token = (
            nn.Parameter(torch.zeros(1, 1, embed_dim)) if class_token else None
        )
        self.pos_embed = (
            nn.Parameter(torch.zeros(1, self.num_patches + self.num_prefix_tokens, embed_dim))
            if pos_embed == "learn" else None
        )
        self.pos_drop = Dropout(pos_drop_rate)
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, attn_impl=attn_impl, mlp_ratio=mlp_ratio,
                  qkv_bias=qkv_bias, qk_norm=qk_norm, proj_drop=proj_drop_rate,
                  attn_drop=attn_drop_rate, init_values=init_values,
                  drop_path=float(dpr[i]), gelu_approx=gelu_approx)
            for i in range(depth)
        )
        self.norm = layer_norm(embed_dim)
        self.head_drop = Dropout(drop_rate)
        self.head = (
            nn.Linear(embed_dim, num_classes) if num_classes is not None and num_classes > 0
            else None
        )

    # ---------------------------------------------------------------- params

    def sincos_table(self) -> np.ndarray:
        g = self.grid_size
        with_cls = self.cls_token is not None
        if self.twoD:
            return get_2d_sincos_pos_embed(self.embed_dim, g[0], g[1], cls_token=with_cls)
        return get_3d_sincos_pos_embed(self.embed_dim, g[0], g[1], g[2], cls_token=with_cls)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VIT":
        """The JAX package's initialisers, drawn from `generator`: truncated
        normal (std 0.02) kernels, zero biases, unit LayerNorm scales, class
        token N(0, 1e-6), position embedding from the sincos table. The
        numbers differ from flax's for the same seed; the distributions agree."""
        std = 0.02 / _TRUNC_STD_CORRECTION
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(m.init_values)
        if self.cls_token is not None:
            nn.init.normal_(self.cls_token, std=1e-6, generator=generator)
        if self.pos_embed is not None:
            table = torch.from_numpy(self.sincos_table()).to(self.pos_embed.dtype)
            self.pos_embed.copy_(table.reshape(self.pos_embed.shape))
        return self

    def set_generator(self, generator: torch.Generator,
                      host_generator: torch.Generator) -> "VIT":
        """Hand the train step's generators to every module that draws
        (`models.blocks.set_generator`)."""
        set_generator(self, generator, host_generator)
        return self

    # --------------------------------------------------------------- forward

    def apply_pos_embed(self, x: torch.Tensor) -> torch.Tensor:
        """Prepend the class token and add the position embedding. Without a
        position embedding the JAX model prepends no class token either."""
        if self.pos_embed is None:
            return x
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1).to(x.dtype), x], dim=1)
        return self.pos_drop(x + self.pos_embed.to(x.dtype))

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.apply_pos_embed(self.token_embeds(x))
        if self.training and self.patch_drop_rate > 0:
            raise _not_ported("patch dropout", "training remainder")
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        """Class-token pool (or strip the prefix)."""
        if self.num_prefix_tokens == 1:
            return x[:, 0]
        return x[:, self.num_prefix_tokens:]

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head_drop(self.pool(x))
        return x if self.head is None else self.head(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_head(self.forward_features(x))
