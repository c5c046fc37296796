"""UNETR: the ViT encoder and a U-Net-style convolutional decoder for 2-D and
3-D segmentation (port of `ucf_vit_tpu/models/unetr.py:49-216`).

Three decoders, as in the JAX model: the skip-connection decoder (the
outputs of blocks `skip_indices` and the input image through conv encoders
into a chain of up-blocks), the no-skip one (a chain of transposed
convolutions) and the linear one (a dense head on the tokens, resized to the
image). Adaptive patching runs by the sqrt-len method: the caller passes the
sequence reassembled into an image, `x_seq` (`tasks.reassemble_sqrt_len`),
the encoder tokenizes that, and the decoder works on the `(sqrt_len,)^nd`
token grid; where `16 * sqrt_len` is not the tile's side, the decoder's last
map is resized to the tile before `decoder2`. Channels-first throughout.

Under `remat` each encoder block and each decoder block run under activation
checkpointing in training (the JAX model's `nn.remat` of both); the decoder
draws nothing, so its recompute needs no generator replay. The JAX model's
`_spatial` sharding constraints name a layout for a mesh and are nothing on
one device; `seq_par_size > 1`, which the JAX model spends on that spatial
partition, raises NotImplementedError until its slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ucf_vit_tpu_torch.models.blocks import Linear
from ucf_vit_tpu_torch.models.unet_blocks import (
    MyUnetBlock,
    UnetOutBlock,
    UnetrBasicBlock,
    UnetrPrUpBlock,
    UnetrUpBlock,
    resize_linear_align_corners,
)
from ucf_vit_tpu_torch.models.vit import (
    SP_PARTITION_ITEM,
    VIT,
    _checkpoint,
    _not_ported,
    _to_tuple,
)


class UNETR(VIT):
    """UNETR over a VIT encoder without a class token; `num_classes` is the
    number of segmentation classes."""

    def __init__(self, num_classes: int = 2, linear_decoder: bool = False,
                 feature_size: int = 16, skip_connection: bool = True,
                 img_size: Sequence[int] = (224, 224), in_chans: int = 3,
                 class_token: bool = False, seq_par_size: int = 1, **vit_kwargs) -> None:
        if seq_par_size > 1:
            raise _not_ported("seq_par_size > 1 for UNETR", SP_PARTITION_ITEM)
        if class_token:
            raise ValueError("UNETR runs with class_token=False")
        if float(vit_kwargs.get("patch_drop_rate", 0.0)) != 0.0:
            raise ValueError("UNETR consumes the whole token grid: set patch_drop_rate: 0")
        if vit_kwargs.get("adaptive_patching") and not vit_kwargs.get("sqrt_len_method"):
            raise ValueError("adaptive UNETR runs by the sqrt-len method (sqrt_len_method=True)")
        super().__init__(img_size=img_size, in_chans=in_chans, num_classes=None,
                         class_token=False, **vit_kwargs)
        self.num_classes = int(num_classes)
        self.linear_decoder = bool(linear_decoder)
        self.skip_connection = bool(skip_connection)
        self.spatial_size = _to_tuple(img_size, self.twoD)
        self.feat_size = self.token_grid
        nd, fs, d = len(self.spatial_size), int(feature_size), self.embed_dim
        self.skip_indices = [(i + 1) * (len(self.blocks) // 4) for i in range(3)]
        # 16 * the token grid's side reaches the tile, or the last map is resized to it
        self.resize = self.feat_size[0] * 16 != self.spatial_size[0]
        if self.linear_decoder:
            self.mlp_head = Linear(d, self.num_classes)
            return
        if self.skip_connection:
            self.encoder1 = UnetrBasicBlock(in_chans, fs, 3, 1, nd)
            self.encoder2 = UnetrPrUpBlock(d, fs * 2, num_layer=2, ndim=nd)
            self.encoder3 = UnetrPrUpBlock(d, fs * 4, num_layer=1, ndim=nd)
            self.encoder4 = UnetrPrUpBlock(d, fs * 8, num_layer=0, ndim=nd)
            self.decoder5 = UnetrUpBlock(d, fs * 8, ndim=nd)
            self.decoder4 = UnetrUpBlock(fs * 8, fs * 4, ndim=nd)
            self.decoder3 = UnetrUpBlock(fs * 4, fs * 2, ndim=nd)
            self.decoder2 = UnetrUpBlock(fs * 2, fs, upsample=1 if self.resize else 2, ndim=nd)
        else:
            self.decoder5 = MyUnetBlock(d, fs * 8, ndim=nd)
            self.decoder4 = MyUnetBlock(fs * 8, fs * 4, ndim=nd)
            self.decoder3 = MyUnetBlock(fs * 4, fs * 2, ndim=nd)
            self.decoder2 = MyUnetBlock(fs * 2, fs, ndim=nd)
        self.out = UnetOutBlock(fs, self.num_classes, nd)

    def _block(self, blk: nn.Module, *xs: torch.Tensor) -> torch.Tensor:
        """A decoder block, under activation checkpointing with `remat` in
        training."""
        if self.remat and self.training and torch.is_grad_enabled():
            return _checkpoint(blk, *xs)
        return blk(*xs)

    def proj_feat(self, x: torch.Tensor) -> torch.Tensor:
        """Tokens `[B, L, D]` -> the map `[B, D, *feat_size]`, in f32 (the JAX
        decoder's convolutions take no dtype, so they compute in f32 under
        the bf16 policy too)."""
        b = x.shape[0]
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return x.transpose(1, 2).reshape(b, self.embed_dim, *self.feat_size)

    def unetr_head(self, x: torch.Tensor, intermediates: Optional[List[torch.Tensor]],
                   enc1: Optional[torch.Tensor]) -> torch.Tensor:
        if self.linear_decoder:
            x = self.mlp_head(x)  # [B, L, classes], f32 (its weights' type)
            b = x.shape[0]
            x = x.transpose(1, 2).reshape(b, self.num_classes, *self.grid_size)
            return resize_linear_align_corners(
                x, tuple(s * self.patch_size for s in self.grid_size))
        blk = self._block
        if not self.skip_connection:
            x = self.proj_feat(x)
            for dec in (self.decoder5, self.decoder4, self.decoder3, self.decoder2):
                x = blk(dec, x)
            if self.resize:
                x = resize_linear_align_corners(x, self.spatial_size)
            return self.out(x)
        enc4 = blk(self.encoder4, self.proj_feat(intermediates[-1]))
        dec3 = blk(self.decoder5, self.proj_feat(x), enc4)
        enc3 = blk(self.encoder3, self.proj_feat(intermediates[-2]))
        dec2 = blk(self.decoder4, dec3, enc3)
        enc2 = blk(self.encoder2, self.proj_feat(intermediates[-3]))
        dec1 = blk(self.decoder3, dec2, enc2)
        if self.resize:
            dec1 = resize_linear_align_corners(dec1, self.spatial_size)
        return self.out(blk(self.decoder2, dec1, enc1))

    def forward(self, x: torch.Tensor, seq_ps: Optional[torch.Tensor] = None,
                x_seq: Optional[torch.Tensor] = None,
                var_ids: Optional[Sequence[int]] = None) -> torch.Tensor:
        """`x` `[B, C, *spatial]`; with adaptive patching `x_seq`, the sequence
        reassembled into the `[B, C, (sqrt_len * p)^nd]` image, and its
        descriptors `seq_ps`. Returns the logits `[B, num_classes, *spatial]`."""
        enc_input = x_seq if self.adaptive_patching else x
        if enc_input is None:
            raise ValueError("an adaptive UNETR takes the reassembled sequence as x_seq")
        if self.skip_connection and not self.linear_decoder:
            enc1 = self._block(self.encoder1, x)
            tokens, intermediates = self.forward_intermediates(
                enc_input, self.skip_indices, seq_ps=seq_ps, var_ids=var_ids)
        else:
            enc1, intermediates = None, None
            tokens = self.forward_features(enc_input, seq_ps=seq_ps, var_ids=var_ids)
        return self.unetr_head(self.pool(tokens), intermediates, enc1)
