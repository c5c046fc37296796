"""UNETR's convolutional decoder blocks, 2-D and 3-D (port of
`ucf_vit_tpu/models/unet_blocks.py`), channels-first as torch's convolutions
take them.

The MONAI block semantics the reference imports: convolutions with `(k -
1) // 2` padding on each side, transposed convolutions with kernel = stride
= the upsampling factor (an exact upsample, no overlap), instance norm with
no affine parameters (biased variance, eps 1e-5), LeakyReLU(0.01), residual
blocks with a 1x1 projection where the channels or the stride change. The
modules and their children carry the names of the reference's state dict
(`encoder2.blocks.0.0.weight`, `decoder5.conv_block.conv1.weight`, ...), the
names `convert.load_jax_params` fills. The convolutions are cuDNN's, as they
are XLA's in the JAX package: no TPU kernel lies on this path.

Under sp > 1 (UNETR's spatial partition, `parallel.mesh.spatial`) the blocks
run inside `parallel.mesh.spatial_context(shard)`, and each takes `split`:
whether the map in hand is this rank's slab of dim 2 over sp. On a split map
a 3x3(x3) convolution first takes a halo of one row from each neighbour
(`collectives.halo_exchange`) and runs unpadded on dim 2; instance norm
takes its statistics over the whole map (local sums all-reduced over sp);
1x1 and transposed convolutions (kernel = stride) are local; the resize
reads the input rows its output rows need. A block whose input is whole
runs whole and splits its output where sp divides the new side (the
transposed convolutions out of a level sp does not divide), so every block
returns its map split exactly where sp divides its side. On a whole map
every block runs as on one device.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ucf_vit_tpu_torch.parallel.collectives import all_gather, all_reduce, halo_exchange
from ucf_vit_tpu_torch.parallel.mesh import spatial, spatial_shard


class _SplitConv:
    """A convolution that also runs on a map split over sp on dim 2: a halo of
    `padding` rows from each neighbour, then no padding on dim 2."""

    def forward(self, x: torch.Tensor, split: bool = False) -> torch.Tensor:
        pad = self.padding[0]
        if not split or pad == 0:
            return super().forward(x)
        x = halo_exchange(x, spatial_shard().group, 2, pad)
        return self._fn(x, self.weight, self.bias, self.stride, (0,) + tuple(self.padding[1:]),
                        self.dilation, self.groups)


class Conv2d(_SplitConv, nn.Conv2d):
    _fn = staticmethod(F.conv2d)


class Conv3d(_SplitConv, nn.Conv3d):
    _fn = staticmethod(F.conv3d)


def _conv_cls(ndim: int, transposed: bool = False):
    if ndim not in (2, 3):
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    if transposed:
        return nn.ConvTranspose2d if ndim == 2 else nn.ConvTranspose3d
    return Conv2d if ndim == 2 else Conv3d


def conv(in_channels: int, out_channels: int, kernel: int, stride: int, ndim: int,
         bias: bool = True) -> nn.Module:
    """A convolution with MONAI's 'same' padding, `(kernel - 1) // 2` a side."""
    return _conv_cls(ndim)(in_channels, out_channels, kernel, stride=stride,
                           padding=(kernel - 1) // 2, bias=bias)


def transp_conv(in_channels: int, out_channels: int, up: int, ndim: int,
                bias: bool = True) -> nn.Module:
    """A transposed convolution with kernel = stride = `up`: an exact x`up`
    upsample."""
    return _conv_cls(ndim, transposed=True)(in_channels, out_channels, up, stride=up,
                                            bias=bias)


class InstanceNorm(nn.Module):
    """Instance norm over the spatial axes of `[B, C, *spatial]`, without
    affine parameters (MONAI's "instance"): biased variance, eps 1e-5."""

    def __init__(self, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, split: bool = False) -> torch.Tensor:
        if not split:
            return F.instance_norm(x, eps=self.eps)
        # over the whole map: the mean, then the biased variance of the centred
        # values (as jnp.var; E[x^2] - E[x]^2 loses digits at 72^3)
        shard = spatial_shard()
        dims = tuple(range(2, x.ndim))
        n = x[0, 0].numel() * shard.size
        mean = all_reduce(x.sum(dims, keepdim=True), shard.group) / n
        xc = x - mean
        var = all_reduce((xc * xc).sum(dims, keepdim=True), shard.group) / n
        return xc * torch.rsqrt(var + self.eps)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


class UnetResBlock(nn.Module):
    """conv-norm-lrelu-conv-norm, plus (1x1 conv-norm) of the input where the
    channels or the stride change, then lrelu (MONAI's UnetResBlock)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, ndim: int = 2) -> None:
        super().__init__()
        self.conv1 = conv(in_channels, out_channels, kernel_size, stride, ndim)
        self.norm1 = InstanceNorm()
        self.conv2 = conv(out_channels, out_channels, kernel_size, 1, ndim)
        self.norm2 = InstanceNorm()
        self.downsample = in_channels != out_channels or stride != 1
        if self.downsample:
            self.conv3 = conv(in_channels, out_channels, 1, stride, ndim)
            self.norm3 = InstanceNorm()

    def forward(self, x: torch.Tensor, split: bool = False) -> torch.Tensor:
        y = lrelu(self.norm1(self.conv1(x, split), split))
        y = self.norm2(self.conv2(y, split), split)
        res = self.norm3(self.conv3(x), split) if self.downsample else x
        return lrelu(y + res)


class UnetrBasicBlock(nn.Module):
    """MONAI's UnetrBasicBlock with `res_block=True`: one UnetResBlock."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, ndim: int = 2) -> None:
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels, kernel_size, stride, ndim)

    def forward(self, x: torch.Tensor, split: bool = False) -> torch.Tensor:
        return self.layer(x, split)


class UnetrPrUpBlock(nn.Module):
    """A transposed convolution, then `num_layer` times (transposed
    convolution, UnetResBlock) (MONAI's UnetrPrUpBlock with `conv_block` and
    `res_block`)."""

    def __init__(self, in_channels: int, out_channels: int, num_layer: int,
                 kernel_size: int = 3, upsample: int = 2, ndim: int = 2) -> None:
        super().__init__()
        self.transp_conv_init = transp_conv(in_channels, out_channels, upsample, ndim)
        self.blocks = nn.ModuleList(
            nn.Sequential(transp_conv(out_channels, out_channels, upsample, ndim),
                          UnetResBlock(out_channels, out_channels, kernel_size, 1, ndim))
            for _ in range(num_layer))

    def forward(self, x: torch.Tensor, split: bool = False) -> torch.Tensor:
        shard = spatial_shard()
        x, split = spatial(self.transp_conv_init(x), split, shard)
        for up, res in self.blocks:
            x, split = spatial(up(x), split, shard)
            x = res(x, split)
        return x


class UnetrUpBlock(nn.Module):
    """Upsample, concatenate the skip on the channels, UnetResBlock (MONAI's
    UnetrUpBlock with `res_block`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 upsample: int = 2, ndim: int = 2) -> None:
        super().__init__()
        self.transp_conv = transp_conv(in_channels, out_channels, upsample, ndim)
        self.conv_block = UnetResBlock(2 * out_channels, out_channels, kernel_size, 1, ndim)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, split: bool = False) -> torch.Tensor:
        """`skip` lies as the upsampled `x` does: split where sp divides its side."""
        x, split = spatial(self.transp_conv(x), split, spatial_shard())
        return self.conv_block(torch.cat([x, skip], dim=1), split)


class MyUnetBlock(nn.Module):
    """A bare transposed-convolution upsample (the no-skip decoder)."""

    def __init__(self, in_channels: int, out_channels: int, upsample: int = 2,
                 ndim: int = 2) -> None:
        super().__init__()
        self.transp_conv = transp_conv(in_channels, out_channels, upsample, ndim)

    def forward(self, x: torch.Tensor, split: bool = False) -> torch.Tensor:
        return spatial(self.transp_conv(x), split, spatial_shard())[0]


class UnetOutBlock(nn.Module):
    """A 1x1 convolution to the class logits."""

    def __init__(self, in_channels: int, num_classes: int, ndim: int = 2) -> None:
        super().__init__()
        self.conv = conv(in_channels, num_classes, 1, 1, ndim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


@functools.lru_cache(maxsize=None)
def interp_matrix(in_len: int, out_len: int) -> np.ndarray:
    """`[out_len, in_len]` f32 linear interpolation matrix, align_corners=True
    (`ucf_vit_tpu/models/unet_blocks.py:214`: weights in f64, then f32)."""
    m = np.zeros((out_len, in_len), dtype=np.float32)
    if out_len == 1 or in_len == 1:
        m[:, 0] = 1.0
        return m
    coords = np.arange(out_len) * (in_len - 1) / (out_len - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_len - 1)
    frac = coords - lo
    m[np.arange(out_len), lo] += 1.0 - frac
    m[np.arange(out_len), hi] += frac
    return m


def _local_rows(in_len: int, out_len: int, sp: int, rank: int):
    """`(rows of the interpolation matrix, input columns)` of output slab
    `rank` of `sp` when every input row it reads lies in input slab `rank`;
    None where it does not or where sp does not divide `out_len`."""
    if out_len % sp:
        return None
    m, k = out_len // sp, in_len // sp
    rows = slice(rank * m, (rank + 1) * m)
    cols = np.flatnonzero(interp_matrix(in_len, out_len)[rows].any(axis=0))
    if cols.min() < rank * k or cols.max() >= (rank + 1) * k:
        return None
    return rows, slice(rank * k, (rank + 1) * k)


def resize_linear_align_corners(x: torch.Tensor, out_spatial: Sequence[int],
                                split: bool = False) -> torch.Tensor:
    """Bi- or trilinear resize of `[B, C, *spatial]` to `[B, C, *out_spatial]`
    with `align_corners=True`, axis by axis by the interpolation matrices of
    the JAX package (`ucf_vit_tpu/models/unet_blocks.py:233`): one GEMM an
    axis. (`F.interpolate` computes the same weights in f32 and lands up to
    2e-5 away at 72^3 -> 64^3.)

    With `split` (`x` this rank's slab of dim 2, inside `spatial_context`),
    dim 2's GEMM takes the block of the matrix that maps this rank's input
    rows to its output rows where those are all it reads (72 -> 64 over sp
    2: output rows 0-31 read 0-35, rows 32-63 read 36-71); otherwise the map
    is gathered whole first. Under a spatial context the result is split where
    sp divides its side, as every decoder block's."""
    out_spatial = tuple(int(s) for s in out_spatial)
    if x.ndim != len(out_spatial) + 2:
        raise ValueError(f"{x.shape} is not [B, C, *{len(out_spatial)}-d spatial]")
    shard = spatial_shard()
    for axis, out_len in enumerate(out_spatial, start=2):
        in_len, rows, cols = x.shape[axis], slice(None), slice(None)
        if axis == 2 and split:
            in_len *= shard.size
            local = _local_rows(in_len, out_len, shard.size, shard.rank)
            if local is None:
                x, split = all_gather(x, shard.group, axis=2), False
            else:
                rows, cols = local
        if in_len == out_len:
            continue
        w = np.ascontiguousarray(interp_matrix(in_len, out_len)[rows, cols])
        w = torch.from_numpy(w).to(x.device, x.dtype)
        x = torch.movedim(torch.tensordot(w, x, dims=([1], [axis])), 0, axis)
    return spatial(x, split, shard)[0]
