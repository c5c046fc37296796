"""Adaptive patching on the host (the port's own copy of `Patchify` and
`Patchify3D`, `ucf_vit_tpu/data/transform.py:33-201`): an edge map of the
image, a `FixedQuadTree` (2-D) or `FixedOctTree` (3-D) over it, and the
leaves serialized to `fixed_length` patches of `patch_size`^nd with their
sizes and centres.

The edge map is a random augmentation, drawn from the explicit
`np.random.Generator` the caller gives, in the JAX order: the Gaussian
smoothing factor from {0, 1, 3, 5}, then the Canny low threshold from [50,
100) (high = low + 50); a smoothing factor of 0 gives a uniformly random
edge map instead. The same generator state gives the same trees and arrays
as the JAX package. cv2 is imported at the first call.

`Patchify3D` draws the smoothing factor and the Canny threshold the same way,
smooths the volume with a 3-D Gaussian of that sigma (`native.gaussian3d`;
none at 0), and per slice takes Sobel gradients and Canny edges (with more
than one channel the JAX package's cross-channel max rules); the octree's
edge volume is the edge count where the normalised edge direction passes
0.5.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ucf_vit_tpu_torch.data.octree import FixedOctTree
from ucf_vit_tpu_torch.data.quadtree import FixedQuadTree, _cv2


class Patchify:
    """2-D edge-driven quadtree patchify of an image `[H, W, C]`:
    `(seq, seq_size [L], seq_pos [L, 2], qdt)`, `seq` `[C, L, p*p]` for more
    than one channel, else `[L, p*p]`."""

    def __init__(
        self,
        sths: Sequence[int] = (0, 1, 3, 5),
        fixed_length: int = 196,
        cannys: Sequence[int] = (50, 100),
        patch_size: int = 16,
        num_channels: int = 3,
        dataset: str = "imagenet",
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        self.sths = list(sths)
        self.fixed_length = fixed_length
        self.cannys = list(range(cannys[0], cannys[1]))
        self.patch_size = patch_size
        self.num_channels = num_channels
        self.dataset = dataset
        self.rng = rng

    def __call__(self, img: np.ndarray, rng: Optional[np.random.Generator] = None):
        """Draws from `rng` when given (nothing shared is touched, so calls
        from several threads are independent), else from `self.rng`."""
        rng = self.rng if rng is None else rng
        if rng is None:
            raise RuntimeError("Patchify draws its augmentation from an explicit "
                               "np.random.Generator: pass rng= or set .rng")
        cv2 = _cv2()
        smooth = int(rng.choice(self.sths))
        c = int(rng.choice(self.cannys))
        natural = self.dataset in ("imagenet", "catsdogs")
        if smooth == 0:
            lo, hi = (0.0, 1.0) if natural else (float(np.min(img)), float(np.max(img)))
            edges = rng.uniform(low=lo, high=hi, size=(img.shape[0], img.shape[1]))
        else:
            grey = cv2.GaussianBlur(img, (smooth, smooth), 0)
            if natural:
                edges = cv2.Canny(grey.astype(np.uint8), c, c + 50)
            else:
                edges = cv2.Canny((grey * 255).astype(np.uint8), c, c + 50)

        qdt = FixedQuadTree(domain=edges, fixed_length=self.fixed_length)
        p = self.patch_size
        seq_img, seq_size, seq_pos = qdt.serialize(img, size=(p, p, self.num_channels))
        seq_size = np.asarray(seq_size)
        seq_img = np.asarray(seq_img, dtype=np.float32)
        if self.num_channels > 1:  # [L, p, p, C] -> [C, L, p*p]
            seq_img = np.moveaxis(seq_img, -1, 0).reshape(self.num_channels, -1, p * p)
        else:
            seq_img = seq_img.reshape(-1, p * p)
        return seq_img, seq_size, np.asarray(seq_pos), qdt


class Patchify3D:
    """3-D edge-driven octree patchify of a float32 volume `[D, H, W, C]`:
    `(seq, seq_size [L], seq_pos [L, 3], octree)`, `seq` `[C, L, p^3]` for
    more than one channel, else `[L, p^3]`."""

    def __init__(
        self,
        sths: Sequence[int] = (0, 1, 3, 5),
        fixed_length: int = 196,
        cannys: Sequence[int] = (50, 100),
        patch_size: int = 16,
        num_channels: int = 3,
        dataset: str = "basic_ct",
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        self.sths = list(sths)
        self.fixed_length = fixed_length
        self.cannys = list(range(cannys[0], cannys[1]))
        self.patch_size = patch_size
        self.num_channels = num_channels
        self.dataset = dataset
        self.rng = rng

    def smooth(self, img: np.ndarray, sigma: int) -> np.ndarray:
        """The volume smoothed by a Gaussian of `sigma` over its spatial axes
        (a copy at 0)."""
        if img.dtype != np.float32:
            raise ValueError(f"Patchify3D takes a float32 volume, got {img.dtype}")
        if sigma == 0:
            return img.copy()
        from ucf_vit_tpu_torch import native

        return native.gaussian3d(img, float(sigma))

    def edge_volume(self, grey: np.ndarray, canny_lo: int):
        """`(edges [D, H, W] uint8, norm_factor)` of a smoothed volume: per
        slice Sobel (ksize 5) and Canny on `uint8(grey * 255)`; the edge
        direction `arctan2(sobel_y, sobel_x)` where an edge was found,
        normalised to [0, 1] over the volume; the edge count times
        `255 // C` where the direction passes 0.5."""
        cv2 = _cv2()
        nslices = grey.shape[0]
        edges_combined = np.zeros(grey.shape[:3], dtype=bool)
        edges_counter = np.zeros(grey.shape[:3], dtype=np.uint8)
        sobel = []
        grey_u8 = (grey * 255).astype(np.uint8)
        for i in range(nslices):
            sobelx = sobely = g_mag = None
            for j in range(self.num_channels):
                sx = cv2.Sobel(grey[i, :, :, j], cv2.CV_64F, 1, 0, ksize=5)
                sy = cv2.Sobel(grey[i, :, :, j], cv2.CV_64F, 0, 1, ksize=5)
                if j == 0:
                    sobelx, sobely = sx, sy
                    if self.num_channels > 1:
                        g_mag = np.sqrt(sx**2 + sy**2)
                else:  # the channel with the larger mean magnitude / mean y gradient
                    if np.mean(np.sqrt(sx**2 + sy**2)) > np.mean(g_mag):
                        sobelx = sx
                    if np.mean(sy) > np.mean(sobely):
                        sobely = sy
            sobel.append((sobelx, sobely))
            canny_edges = None
            for j in range(self.num_channels):
                canny = cv2.Canny(np.ascontiguousarray(grey_u8[i, :, :, j]), canny_lo,
                                  canny_lo + 50)
                canny_edges = canny if j == 0 else canny_edges + canny
                edges_counter[i] += (canny > 0).astype(np.uint8)
            edges_combined[i] = canny_edges > 0
        edge_dir = np.zeros(grey.shape[:3], dtype=grey.dtype)
        for i in range(nslices):
            m = edges_combined[i]
            if m.any():
                sobelx, sobely = sobel[i]
                edge_dir[i][m] = np.arctan2(sobely[m], sobelx[m])
        span = edge_dir.max() - edge_dir.min()
        normalized = (np.zeros_like(edge_dir) if span == 0
                      else (edge_dir - edge_dir.min()) / span)
        norm_factor = int(255 / self.num_channels)
        binary = (normalized > 0.5).astype(np.uint8) * (edges_counter * norm_factor)
        return binary, norm_factor

    def __call__(self, img: np.ndarray, rng: Optional[np.random.Generator] = None):
        """Draws from `rng` when given, else from `self.rng`."""
        rng = self.rng if rng is None else rng
        if rng is None:
            raise RuntimeError("Patchify3D draws its augmentation from an explicit "
                               "np.random.Generator: pass rng= or set .rng")
        smooth = int(rng.choice(self.sths))
        c = int(rng.choice(self.cannys))
        edges, norm_factor = self.edge_volume(self.smooth(img, smooth), c)
        octree = FixedOctTree(domain=edges, fixed_length=self.fixed_length,
                              norm_factor=norm_factor)
        return (*self.serialize(octree, img), octree)

    def serialize(self, octree: FixedOctTree, img: np.ndarray):
        """`(seq, seq_size [L], seq_pos [L, 3])` of `img`'s leaves."""
        p = self.patch_size
        seq_img, seq_size, seq_pos = octree.serialize(img, size=(p, p, p, self.num_channels))
        if self.num_channels > 1:  # [L, p, p, p, C] -> [C, L, p^3]
            seq_img = np.moveaxis(seq_img, -1, 0).reshape(self.num_channels, -1, p ** 3)
        else:
            seq_img = seq_img.reshape(-1, p ** 3)
        return seq_img, seq_size, seq_pos
