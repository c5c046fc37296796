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
draws nothing, so its recompute needs no generator replay.

Under sp > 1 (a model on a mesh, `shard_model`) sp is a spatial partition,
as the JAX model's `_spatial` constraints make it: at each of their points
(the image into `encoder1`, each `proj_feat`, each encoder and decoder
output, the resize, `decoder2`) dim 2 of the map is split over sp where sp
divides its side and whole where it does not (`parallel.mesh.spatial`); the
blocks run inside `spatial_context` with halos and cross-shard norms
(`models/unet_blocks.py`), and the logits are gathered whole at the end. The
encoder splits its tokens where sp divides them and runs whole where it
does not (`VIT.forward_intermediates`). basic_ct/unetr_sp's 729 tokens stay
whole and its 9^3 level too; the 18^3 to 72^3 levels, the resize to 64^3
and `encoder1` are split.
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
from ucf_vit_tpu_torch.models.vit import VIT, _checkpoint, _to_tuple
from ucf_vit_tpu_torch.parallel.mesh import (
    seq_shard_of,
    spatial,
    spatial_context,
    spatial_gather,
)


class UNETR(VIT):
    """UNETR over a VIT encoder without a class token; `num_classes` is the
    number of segmentation classes."""

    def __init__(self, num_classes: int = 2, linear_decoder: bool = False,
                 feature_size: int = 16, skip_connection: bool = True,
                 img_size: Sequence[int] = (224, 224), in_chans: int = 3,
                 class_token: bool = False, **vit_kwargs) -> None:
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

    def _block(self, blk: nn.Module, *xs: torch.Tensor, split: bool = False) -> torch.Tensor:
        """A decoder block (inside the spatial context, told whether its input
        is split), under activation checkpointing with `remat` in training."""
        shard = self._shard

        def fn(*xs):
            with spatial_context(shard):
                return blk(*xs, split=split)
        if self.remat and self.training and torch.is_grad_enabled():
            return _checkpoint(fn, *xs)
        return fn(*xs)

    @property
    def _shard(self):
        return seq_shard_of(getattr(self, "mesh", None))

    def _split(self, side: int) -> bool:
        """Whether a decoder map of first side `side` lies split over sp."""
        shard = self._shard
        return shard is not None and side % shard.size == 0

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
        blk, shard, f = self._block, self._shard, self.feat_size[0]

        def feat(t):  # the token map, split where sp divides the grid
            return spatial(self.proj_feat(t), False, shard)[0]
        if not self.skip_connection:
            x = feat(x)
            for i, dec in enumerate((self.decoder5, self.decoder4, self.decoder3,
                                     self.decoder2)):
                x = blk(dec, x, split=self._split(f << i))
            side = f << 4
        else:
            enc4 = blk(self.encoder4, feat(intermediates[-1]), split=self._split(f))
            dec3 = blk(self.decoder5, feat(x), enc4, split=self._split(f))
            enc3 = blk(self.encoder3, feat(intermediates[-2]), split=self._split(f))
            dec2 = blk(self.decoder4, dec3, enc3, split=self._split(2 * f))
            enc2 = blk(self.encoder2, feat(intermediates[-3]), split=self._split(f))
            x = blk(self.decoder3, dec2, enc2, split=self._split(4 * f))
            side = 8 * f
        if self.resize:
            with spatial_context(shard):
                x = resize_linear_align_corners(x, self.spatial_size, split=self._split(side))
            side = self.spatial_size[0]
        if self.skip_connection:
            x = blk(self.decoder2, x, enc1, split=self._split(side))
        return spatial_gather(self.out(x), self._split(self.spatial_size[0]), shard)

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
            img, split = spatial(x, False, self._shard)
            enc1 = self._block(self.encoder1, img, split=split)
            tokens, intermediates = self.forward_intermediates(
                enc_input, self.skip_indices, seq_ps=seq_ps, var_ids=var_ids)
        else:
            enc1, intermediates = None, None
            tokens = self.forward_features(enc_input, seq_ps=seq_ps, var_ids=var_ids)
        return self.unetr_head(self.pool(tokens), intermediates, enc1)
