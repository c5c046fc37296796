"""Adaptive patching on the host (the port's own copy of the 2-D `Patchify`,
`ucf_vit_tpu/data/transform.py:33-87`): an edge map of the image, a
`FixedQuadTree` over it, and the leaves serialized to `fixed_length` patches
of `patch_size`² with their sizes and centres.

The edge map is a random augmentation, drawn from the explicit
`np.random.Generator` the caller gives, in the JAX order: the Gaussian
smoothing factor from {0, 1, 3, 5}, then the Canny low threshold from [50,
100) (high = low + 50); a smoothing factor of 0 gives a uniformly random
edge map instead. The same generator state gives the same trees and arrays
as the JAX package. cv2 is imported at the first call. `Patchify3D` (the
octree) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ucf_vit_tpu_torch.data.quadtree import FixedQuadTree, _cv2

ITEM_6 = "(ROADMAP.md, modules to port, item 6: VIT input variants)"


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
    """The octree patchify of volumes: not ported yet."""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            f"3-D adaptive patching (Patchify3D, the octree) is not ported yet {ITEM_6}")
