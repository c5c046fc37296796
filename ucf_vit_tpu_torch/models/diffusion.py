"""DiffusionVIT: the ViT denoiser of DDPM training (port of
`ucf_vit_tpu/models/diffusion.py:30`).

The encoder is the port's `VIT` without a class token or a head; after the
position embedding (and patch dropout) it adds to every token the time
embedding: a row of the sinusoidal table (`time_table`, a buffer kept out of
the `state_dict`, as the JAX model keeps it out of its params) through
`timeEmbeddingMap` (linear, ReLU, dropout 0.5, linear). The decoder embeds the
tokens, adds its sincos-initialised position embedding and runs its blocks
(under the encoder's `remat`), its norm and the prediction head; with
`linear_decoder` only the head. `forward(x_t, t)` returns the predicted noise
in patch space, `[B, L, p^ndim * C]`.

With adaptive patching (the JAX model's, no config or JAX task runs it) the
encoder takes what `VIT` takes: the serialized sequence `[B, C, L, p^nd]`
with its descriptors `seq_ps`, or with the sqrt-len method the reassembled
image; the decoder's position table is then drawn `0.02 * N(0, 1)`, and
with the sqrt-len method filled from the sincos table of the image's patch
grid, as in the JAX model (`ucf_vit_tpu/models/diffusion.py:43-54`, which
holds only where that grid has `sqrt_len^nd` patches).

As in the JAX model the time MLP, the decoder embedding, its norm and the head
take no dtype, so under the bf16 policy they compute in f32 and promote the
residual streams they join to f32.

Not ported, and refused with the ROADMAP.md item: the pipelined decoder stack
(`pipe_par_size > 1`, item 12, pipeline), refused by `VIT`. With MoE the
encoder's blocks route (`models/moe.py`); the decoder's stay dense.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ucf_vit_tpu_torch.models.blocks import Block, EmbeddingDenseLayer, Linear, layer_norm
from ucf_vit_tpu_torch.models.vit import VIT
from ucf_vit_tpu_torch.ops.pos_embed import (
    get_2d_sincos_pos_embed,
    get_3d_sincos_pos_embed,
    sinusoidal_time_embedding_table,
)


class DiffusionVIT(VIT):
    """`forward(x_t [B, C, *spatial], t [B] int) -> [B, L, p^ndim * C]`."""

    def __init__(
        self,
        linear_decoder: bool = False,
        decoder_depth: int = 8,
        decoder_embed_dim: int = 512,
        decoder_num_heads: int = 16,
        mlp_ratio_decoder: float = 4.0,
        time_steps: int = 1000,
        class_token: bool = False,
        num_classes=None,
        img_size: Sequence[int] = (224, 224),
        in_chans: int = 3,
        **vit_kwargs,
    ):
        if class_token:
            raise ValueError("DiffusionVIT runs with class_token=False")
        if num_classes is not None:
            raise ValueError("DiffusionVIT has no classification head")
        super().__init__(img_size=img_size, in_chans=in_chans, class_token=False,
                         num_classes=None, **vit_kwargs)
        self.linear_decoder = bool(linear_decoder)
        self.decoder_embed_dim = int(decoder_embed_dim)
        self.time_steps = int(time_steps)
        table = sinusoidal_time_embedding_table(self.time_steps, self.embed_dim)
        self.register_buffer("time_table", torch.from_numpy(table).float(), persistent=False)
        self.timeEmbeddingMap = EmbeddingDenseLayer(self.embed_dim, self.embed_dim,
                                                    dropout_prob=0.5)
        width = self.embed_dim if self.linear_decoder else self.decoder_embed_dim
        patch_dim = in_chans * self.patch_size ** len(self.grid_size)
        self.decoder_pred = Linear(width, patch_dim)
        self.decoder_blocks = None
        if self.linear_decoder:
            return
        self.decoder_embed = Linear(self.embed_dim, self.decoder_embed_dim)
        self.decoder_norm = layer_norm(self.decoder_embed_dim)
        self.decoder_pos_embed = nn.Parameter(
            torch.zeros(1, self.num_patches, self.decoder_embed_dim))
        dpr = np.linspace(0.0, self.drop_path_rate, decoder_depth)
        self.decoder_blocks = nn.ModuleList(
            Block(self.decoder_embed_dim, decoder_num_heads, mlp_ratio=mlp_ratio_decoder,
                  drop_path=float(dpr[i]), **self.block_kwargs)
            for i in range(decoder_depth)
        )

    def decoder_sincos_table(self) -> np.ndarray:
        g = self.grid_size
        if self.twoD:
            return get_2d_sincos_pos_embed(self.decoder_embed_dim, g[0], g[1])
        return get_3d_sincos_pos_embed(self.decoder_embed_dim, g[0], g[1], g[2])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DiffusionVIT":
        """VIT's initialisers (the time MLP's linears among them) and the
        decoder's position embedding (`_decoder_sincos_init`): its sincos
        table, or for adaptive tokens embedded by LinearTokenEmbed
        0.02 * N(0, 1)."""
        super().init_weights(generator)
        if self.decoder_blocks is None:
            return self
        if self.adaptive_linear:
            self.decoder_pos_embed.normal_(generator=generator).mul_(0.02)
        else:
            table = torch.from_numpy(self.decoder_sincos_table())
            self.decoder_pos_embed.copy_(table.reshape(self.decoder_pos_embed.shape))
        return self

    # --------------------------------------------------------------- forward

    def forward_features(self, x: torch.Tensor, t: torch.Tensor,
                         var_ids: Optional[Sequence[int]] = None,
                         seq_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Embed, position embedding (`seq_ps`: the adaptive descriptors),
        patch dropout, + the time embedding of each sample's step, blocks,
        norm (`:146`)."""
        x = self.patch_drop(self.apply_pos_embed(self.embed_tokens(x, var_ids), seq_ps))
        time_emb = self.timeEmbeddingMap(self.time_table[t.to(x.device)].to(x.dtype))
        x = x + time_emb[:, None, :]
        return self.norm(self.run_blocks(x))

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The decoder (`:167`): every token, no prefix to strip."""
        x = self.pool(x)
        if not self.linear_decoder:
            x = self.decoder_embed(x) + self.decoder_pos_embed
            x = self.decoder_norm(self._run_stack(self.decoder_blocks, x))
        return self.decoder_pred(x)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                var_ids: Optional[Sequence[int]] = None,
                seq_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward_head(self.forward_features(x, t, var_ids, seq_ps))
