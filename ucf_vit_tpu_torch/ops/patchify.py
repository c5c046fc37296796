"""Token <-> image space conversion, 2-D and 3-D (port of
`ucf_vit_tpu/ops/patchify.py`).

Layout (2-D): tokens h-major, then w; the feature dim is (patch_h, patch_w,
channel) flattened, channel fastest. Layout (3-D): tokens h, w, d; the
feature dim is (ph, pw, pd, channel). Reshapes and permutes only.
"""

from __future__ import annotations

from typing import Sequence

import torch


def patchify(data: torch.Tensor, patch_size: int, twoD: bool) -> torch.Tensor:
    """`[B, C, *spatial]` image -> `[B, L, p^ndim * C]` tokens."""
    p = patch_size
    if twoD:
        b, c, h, w = data.shape
        nh, nw = h // p, w // p
        x = data.reshape(b, c, nh, p, nw, p).permute(0, 2, 4, 3, 5, 1)
        return x.reshape(b, nh * nw, p * p * c)
    b, c, h, w, d = data.shape
    nh, nw, nd = h // p, w // p, d // p
    x = data.reshape(b, c, nh, p, nw, p, nd, p).permute(0, 2, 4, 6, 3, 5, 7, 1)
    return x.reshape(b, nh * nw * nd, p * p * p * c)


def unpatchify(tokens: torch.Tensor, image_shape: Sequence[int], patch_size: int,
               twoD: bool) -> torch.Tensor:
    """`[B, L, p^ndim * C]` tokens -> `[B, C, *spatial]` image of
    `image_shape` (the whole target shape, batch and channels included)."""
    p = patch_size
    if twoD:
        b, c, h, w = image_shape
        nh, nw = h // p, w // p
        x = tokens.reshape(b, nh, nw, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, c, nh * p, nw * p)
    b, c, h, w, d = image_shape
    nh, nw, nd = h // p, w // p, d // p
    x = tokens.reshape(b, nh, nw, nd, p, p, p, c).permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, c, nh * p, nw * p, nd * p)
