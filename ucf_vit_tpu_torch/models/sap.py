"""SAP: the ViT encoder, a transposed-convolution neck and a 1x1 mask head for
segmentation (port of `ucf_vit_tpu/models/sap.py:24-75`).

The tokens `[B, L, D]` lie on the `(sqrt_len,)^nd` grid of the reassembled
image (adaptive patching by the sqrt-len method: the caller passes the
sequence reassembled into the `[B, C, (sqrt_len * p)^nd]` image,
`tasks.reassemble_sqrt_len`), or on the tile's patch grid; the neck upsamples
them by the patch size into 256 channels (kernel = stride = p, no bias) and
the head maps those to the class logits `[B, num_classes, (side * p)^nd]`.
The neck and the head take no dtype, as in the JAX model: under the bf16
policy they compute in f32 on the final norm's f32 output.

Under sp > 1 the encoder splits its tokens over sp (`VIT._run_stack`), and
the neck and head run split on the first spatial dim where sp divides the
token grid's first side, whole where it does not (`parallel.mesh.spatial`:
both are local on a split map), the logits gathered whole after them. The
JAX model constrains neither and leaves their layout to GSPMD.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ucf_vit_tpu_torch.models.unet_blocks import conv, transp_conv
from ucf_vit_tpu_torch.models.vit import VIT
from ucf_vit_tpu_torch.parallel.mesh import seq_shard_of, spatial, spatial_gather

NECK_CHANNELS = 256  # the reference's, hard-coded


class SAP(VIT):
    """SAP over a VIT encoder without a class token; `num_classes` is the
    number of segmentation classes."""

    def __init__(self, num_classes: int = 2, class_token: bool = False,
                 patch_drop_rate: float = 0.0, **vit_kwargs) -> None:
        if class_token:
            raise AssertionError("SAP runs with class_token=False")
        if float(patch_drop_rate) != 0.0:
            raise AssertionError(
                "SAP consumes the full spatial token grid (intermediates are reshaped to "
                "the grid), so patch_drop_rate > 0 would crash with a bare reshape error "
                "at train time — set patch_drop_rate: 0 (the reference shares this "
                "constraint, simple/arch.py:1059)")
        if vit_kwargs.get("adaptive_patching") and not vit_kwargs.get("sqrt_len_method"):
            raise ValueError("adaptive SAP runs by the sqrt-len method (sqrt_len_method=True)")
        super().__init__(num_classes=None, class_token=False, **vit_kwargs)
        self.num_classes = int(num_classes)
        nd = len(self.token_grid)
        self.neck = nn.Sequential(transp_conv(self.embed_dim, NECK_CHANNELS, self.patch_size,
                                              nd, bias=False))
        self.mask_header = nn.Sequential(conv(NECK_CHANNELS, self.num_classes, 1, 1, nd))

    def mask_head(self, x: torch.Tensor) -> torch.Tensor:
        """Tokens `[B, L, D]` -> logits `[B, num_classes, *(side * p)]`, in the
        promoted type of the tokens and f32."""
        b = x.shape[0]
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        x = x.transpose(1, 2).reshape(b, self.embed_dim, *self.token_grid)
        shard = seq_shard_of(getattr(self, "mesh", None))
        x, split = spatial(x, False, shard)
        return spatial_gather(self.mask_header(self.neck(x)), split, shard)

    def forward(self, x: torch.Tensor, seq_ps: Optional[torch.Tensor] = None,
                var_ids: Optional[Sequence[int]] = None) -> torch.Tensor:
        """`x` `[B, C, *spatial]`: the reassembled sqrt-len image when adaptive,
        with its descriptors `seq_ps`. Returns the logits `[B, num_classes,
        *spatial]`."""
        tokens = self.forward_features(x, seq_ps=seq_ps, var_ids=var_ids)
        return self.mask_head(self.pool(tokens))
