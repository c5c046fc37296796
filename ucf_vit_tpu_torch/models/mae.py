"""MAE: masked-autoencoder pretraining on the ViT encoder (port of
`ucf_vit_tpu/models/mae.py:32-307`).

Random masking keeps a fixed `len_keep = int(L * (1 - mask_ratio))` tokens
per sample, so the encoder runs the short sequence; the decoder embeds the
kept tokens, appends the mask token for the rest, un-shuffles them by
`ids_restore`, adds its fixed-initialised sincos position embedding and runs
its own blocks (under the encoder's `remat`), its norm and the prediction
head; or, with `linear_decoder`, only the prediction head. With adaptive
patching the input is the quadtree's sequence `[B, C, L, p^nd]`, both
position tables are drawn `0.02 * N(0, 1)`, and with `use_adaptive_pos_emb`
the encoder and the decoder each embed the descriptors `seq_ps` by their own
`AdaptivePosMLP` in place of their table (the decoder then has no table, as
in the JAX model). The mask noise is
injected by the caller (`mask_noise`) or drawn from the model's generator
(`VIT.set_generator`), never from torch's global one. `seq_pack` folds
`seq_pack` samples' kept tokens into one encoder sequence with
block-diagonal attention (`seg_len = len_keep`).

As in the JAX model the decoder adds an f32 position table to the bf16
embedding, so under the bf16 policy the decoder's residual stream is f32;
the decoder norm and the prediction head take no dtype, so `pred` is f32.

With `use_varemb` the encoder embeds each variable by its own embed and
merges them (`VIT.embed_tokens`, `var_ids`). Not ported, and refused with the
ROADMAP.md item: `pipe_par_size > 1` (item 12, pipeline); the sqrt-len method is
UNETR's and SAP's input, not MAE's. With MoE the encoder's blocks route
(`models/moe.py`); the decoder's stay dense, as in the JAX model.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ucf_vit_tpu_torch.models.blocks import AdaptivePosMLP, Block, Linear, layer_norm
from ucf_vit_tpu_torch.models.vit import VIT, _to_tuple
from ucf_vit_tpu_torch.ops.attention import SHORT_SEQ_THRESHOLD
from ucf_vit_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed, get_3d_sincos_pos_embed


class MAE(VIT):
    """Masked autoencoder: `forward(x, mask_noise=None, seq_ps=None) ->
    (pred [B, L, p^ndim * C], mask [B, L])`, the mask 1 where a token was
    masked."""

    def __init__(
        self,
        mask_ratio: float = 0.75,
        linear_decoder: bool = False,
        decoder_depth: int = 8,
        decoder_embed_dim: int = 512,
        decoder_num_heads: int = 16,
        mlp_ratio_decoder: float = 4.0,
        seq_pack: int = 1,
        use_adaptive_pos_emb: bool = False,
        class_token: bool = False,
        num_classes: Optional[int] = None,
        img_size: Sequence[int] = (224, 224),
        patch_size: int = 16,
        twoD: bool = True,
        **vit_kwargs,
    ):
        if class_token:
            raise ValueError("MAE runs with class_token=False")
        if num_classes is not None:
            raise ValueError("MAE has no classification head")
        if vit_kwargs.get("sqrt_len_method"):
            raise ValueError("an adaptive MAE embeds the sequence itself; the sqrt-len method "
                             "is UNETR's and SAP's input")
        if vit_kwargs.get("adaptive_patching"):
            num_patches = int(vit_kwargs.get("fixed_length") or 0)
        else:
            num_patches = int(np.prod([s // patch_size for s in _to_tuple(img_size, twoD)]))
        len_keep = int(num_patches * (1 - float(mask_ratio)))
        super().__init__(img_size=img_size, patch_size=patch_size, twoD=twoD,
                         class_token=False, num_classes=None,
                         use_adaptive_pos_emb=use_adaptive_pos_emb,
                         block_seg_len=len_keep if seq_pack > 1 else None, **vit_kwargs)
        self.mask_ratio = float(mask_ratio)
        self.seq_pack = int(seq_pack)
        if self.seq_pack > 1:
            packed = self.seq_pack * self.len_keep
            if self.drop_path_rate != 0.0:
                raise ValueError("seq_pack > 1 with drop_path > 0 would share one DropPath "
                                 "decision across the samples packed into a row")
            if packed > SHORT_SEQ_THRESHOLD:
                raise ValueError(f"seq_pack {self.seq_pack} x len_keep {self.len_keep} = "
                                 f"{packed} tokens exceeds the segment-masked attention "
                                 f"limit ({SHORT_SEQ_THRESHOLD}); lower seq_pack")
            if self.patch_drop_rate != 0.0:
                raise ValueError("seq_pack > 1 with patch_drop_rate > 0 would let tokens of "
                                 "different samples attend to each other")
        self.linear_decoder = bool(linear_decoder)
        self.decoder_embed_dim = int(decoder_embed_dim)
        width = self.embed_dim if self.linear_decoder else self.decoder_embed_dim
        self.mask_token = nn.Parameter(torch.zeros(1, 1, width))
        # the prediction head and the decoder norm take no dtype in the JAX model
        self.decoder_pred = Linear(width, self.patch_dim)
        self.decoder_blocks = None
        self.decoder_pos_embed = self.decoder_adaptive_pos_dep_emb = None
        if self.linear_decoder:
            return
        self.decoder_embed = Linear(self.embed_dim, self.decoder_embed_dim, dtype=self.dtype)
        self.decoder_norm = layer_norm(self.decoder_embed_dim)
        if self.use_adaptive_pos_emb:
            self.decoder_adaptive_pos_dep_emb = AdaptivePosMLP(1 + len(self.grid_size),
                                                               self.decoder_embed_dim)
        else:
            self.decoder_pos_embed = nn.Parameter(
                torch.zeros(1, self.num_patches, self.decoder_embed_dim))
        dpr = np.linspace(0.0, self.drop_path_rate, decoder_depth)
        self.decoder_blocks = nn.ModuleList(
            Block(self.decoder_embed_dim, decoder_num_heads, mlp_ratio=mlp_ratio_decoder,
                  drop_path=float(dpr[i]), **self.block_kwargs)
            for i in range(decoder_depth)
        )

    @property
    def len_keep(self) -> int:
        return int(self.num_patches * (1 - self.mask_ratio))

    def decoder_sincos_table(self) -> np.ndarray:
        g = self.grid_size
        if self.twoD:
            return get_2d_sincos_pos_embed(self.decoder_embed_dim, g[0], g[1])
        return get_3d_sincos_pos_embed(self.decoder_embed_dim, g[0], g[1], g[2])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MAE":
        """VIT's initialisers, the mask token at zero and the decoder's position
        embedding from its sincos table (`_decoder_sincos_init`; adaptive:
        0.02 * N(0, 1))."""
        super().init_weights(generator)
        self.mask_token.zero_()
        if self.decoder_pos_embed is not None and self.adaptive_patching:
            self.decoder_pos_embed.normal_(generator=generator).mul_(0.02)
        elif self.decoder_pos_embed is not None:
            table = torch.from_numpy(self.decoder_sincos_table())
            self.decoder_pos_embed.copy_(table.reshape(self.decoder_pos_embed.shape))
        return self

    # ------------------------------------------------------------------ mask

    def random_masking(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Shuffle-based random masking (`ucf_vit_tpu/models/mae.py:191`):
        `(kept tokens [B, len_keep, D], mask [B, L] with 1 = masked,
        ids_restore [B, L])`. `noise` `[B, L]` replaces the draw from the
        model's generator."""
        b, l, d = x.shape
        if noise is None:
            if self.generator is None:
                raise RuntimeError(
                    "MAE masking needs an explicit torch.Generator: call "
                    "model.set_generator(...) (the train step does) or pass mask_noise"
                )
            noise = torch.rand(b, l, device=x.device, generator=self.generator)
        noise = noise.to(x.device)
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :self.len_keep]
        x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, d))
        mask = torch.ones(b, l, dtype=x.dtype, device=x.device)
        mask[:, :self.len_keep] = 0
        return x_masked, torch.gather(mask, 1, ids_restore), ids_restore

    # --------------------------------------------------------------- decoder

    def mask_head(self, x: torch.Tensor, ids_restore: torch.Tensor,
                  seq_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Append the mask tokens, un-shuffle, decode (`:213`); with
        `use_adaptive_pos_emb` the decoder's position embedding is its MLP of
        `seq_ps`."""
        if not self.linear_decoder:
            x = self.decoder_embed(x)
        b, n_keep, d = x.shape
        mask_tokens = self.mask_token.to(x.dtype).expand(b, ids_restore.shape[1] - n_keep, d)
        x = torch.cat([x, mask_tokens], dim=1)
        x = torch.gather(x, 1, ids_restore[:, :, None].expand(-1, -1, d))
        if self.linear_decoder:
            return self.decoder_pred(x)
        if self.decoder_adaptive_pos_dep_emb is not None:
            if seq_ps is None:
                raise ValueError("use_adaptive_pos_emb needs seq_ps")
            x = x + self.decoder_adaptive_pos_dep_emb(seq_ps)
        else:
            x = x + self.decoder_pos_embed
        x = self._run_stack(self.decoder_blocks, x)
        return self.decoder_pred(self.decoder_norm(x))

    # --------------------------------------------------------------- forward

    def forward_features(self, x: torch.Tensor, mask_noise: Optional[torch.Tensor] = None,
                         seq_ps: Optional[torch.Tensor] = None,
                         var_ids: Optional[Sequence[int]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.apply_pos_embed(self.embed_tokens(x, var_ids), seq_ps)
        x, mask, ids_restore = self.random_masking(x, mask_noise)
        # after masking, as in the JAX model (and the reference)
        x = self.patch_drop(x)
        b, n, d = x.shape
        if self.seq_pack > 1:
            if b % self.seq_pack:
                raise ValueError(f"batch {b} not divisible by seq_pack {self.seq_pack}")
            x = x.reshape(b // self.seq_pack, self.seq_pack * n, d)
        x = self.run_blocks(x)
        if self.seq_pack > 1:
            x = x.reshape(b, n, d)
        return self.norm(x), mask, ids_restore

    def forward(self, x: torch.Tensor, mask_noise: Optional[torch.Tensor] = None,
                seq_ps: Optional[torch.Tensor] = None,
                var_ids: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x, mask, ids_restore = self.forward_features(x, mask_noise, seq_ps, var_ids)
        return self.mask_head(x, ids_restore, seq_ps), mask
