"""The fixed-length octree of 3-D adaptive patching (the port's own copy of
`ucf_vit_tpu/data/octree.py:25-291`): greedily split the leaf with the most
edge mass into 8 until `fixed_length` leaves exist (a leaf's side stops at 2
voxels), serialize the leaves to `p^3` patches (trilinear; labels nearest)
with their sizes and centres (padded to `fixed_length`), and write
predicted patches back into volume space.

A region's edge mass is `sum // norm_factor` from a summed-volume table; that
truncation decides which leaf splits, so it is kept exactly. The frontier is
a max-heap that breaks ties by insertion order, and children take their
parent's place in the serialization order. The resample reproduces the JAX
package's grid: source samples at `linspace(0, n, n)`, queries at
`linspace(0, n, m)`.

`FixedOctTree` builds and serializes through the C++ code
(`ucf_vit_tpu_torch.native`), which raises where it cannot build or load;
`octree_boxes_plain` (the numpy build) and `resize_3d` (the numpy resample)
are its plain versions, which the tests hold it against.
"""

from __future__ import annotations

import functools
import heapq
from typing import List, Tuple

import numpy as np


class Cube:
    __slots__ = ("x1", "x2", "y1", "y2", "z1", "z2")

    def __init__(self, x1: int, x2: int, y1: int, y2: int, z1: int, z2: int) -> None:
        if not (x1 <= x2 and y1 <= y2 and z1 <= z2):
            raise ValueError(f"wrong coordinates ({x1}, {x2}, {y1}, {y2}, {z1}, {z2})")
        self.x1, self.x2, self.y1, self.y2, self.z1, self.z2 = x1, x2, y1, y2, z1, z2

    def get_area(self, img: np.ndarray) -> np.ndarray:
        return img[self.z1:self.z2, self.y1:self.y2, self.x1:self.x2, :]

    def set_area(self, mask: np.ndarray, patch: np.ndarray) -> np.ndarray:
        patch = resize_3d(patch, tuple(int(s) for s in self.get_size()))
        mask[self.z1:self.z2, self.y1:self.y2, self.x1:self.x2, :] = patch
        return mask

    def get_coord(self):
        return self.x1, self.x2, self.y1, self.y2, self.z1, self.z2

    def get_size(self):
        return self.x2 - self.x1, self.y2 - self.y1, self.z2 - self.z1

    def get_center(self):
        return (self.x2 + self.x1) / 2, (self.y2 + self.y1) / 2, (self.z2 + self.z1) / 2


@functools.lru_cache(maxsize=None)
def _axis_weights(n_in: int, n_out: int, nearest: bool) -> np.ndarray:
    """`[n_out, n_in]` interpolation matrix on the JAX package's grid
    (nearest: ties to the lower cell)."""
    w = np.zeros((n_out, n_in), np.float64)
    if n_in == 1:
        w[:, 0] = 1.0
        return w
    src = np.linspace(0.0, n_in, n_in)
    q = np.linspace(0.0, n_in, n_out)
    step = src[1] - src[0]
    idx = np.clip((q / step).astype(np.int64), 0, n_in - 2)
    frac = (q - src[idx]) / step
    if nearest:
        w[np.arange(n_out), np.where(frac <= 0.5, idx, idx + 1)] = 1.0
    else:
        w[np.arange(n_out), idx] += 1.0 - frac
        w[np.arange(n_out), np.minimum(idx + 1, n_in - 1)] += frac
    return w


def resize_3d(vol: np.ndarray, out_size: Tuple[int, int, int], nearest: bool = False
              ) -> np.ndarray:
    """`[D1, H1, W1, C]` -> `[D2, H2, W2, C]` f64, axis by axis (linear or
    nearest): the plain version of `native.resize3d`."""
    d2, h2, w2 = out_size
    d1, h1, w1, _ = vol.shape
    out = vol.astype(np.float64)
    out = np.einsum("oi,ihwc->ohwc", _axis_weights(d1, d2, nearest), out)
    out = np.einsum("oi,diwc->dowc", _axis_weights(h1, h2, nearest), out)
    return np.einsum("oi,dhic->dhoc", _axis_weights(w1, w2, nearest), out)


def octree_boxes_plain(domain: np.ndarray, fixed_length: int, norm_factor: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy build: `(boxes [n, 6] int32 (x1, x2, y1, y2, z1, z2), values
    [n] int64)` of the leaves in serialization order, as `native.octree_boxes`
    gives them. `domain[z, y, x]`; x spans dim 0 of the root cube as in the
    JAX package (the volume is cubic, so the sides agree)."""
    h, w, d = domain.shape
    s = np.zeros((h + 1, w + 1, d + 1), np.int64)
    s[1:, 1:, 1:] = np.cumsum(np.cumsum(np.cumsum(domain.astype(np.int64), 0), 1), 2)

    def value(x1, x2, y1, y2, z1, z2) -> int:
        tot = (s[z2, y2, x2] - s[z1, y2, x2] - s[z2, y1, x2] - s[z2, y2, x1]
               + s[z1, y1, x2] + s[z1, y2, x1] + s[z2, y1, x1] - s[z1, y1, x1])
        return int(tot) // norm_factor

    # a node: [x1, x2, y1, y2, z1, z2, value, children]
    root = [0, h, 0, w, 0, d, value(0, h, 0, w, 0, d), None]
    heap: List[Tuple[int, int, list]] = [(-root[6], 0, root)]
    count, serial = 1, 1
    while count < fixed_length and heap:
        node = heapq.heappop(heap)[2]
        x1, x2, y1, y2, z1, z2 = node[:6]
        if x2 - x1 == 2:
            break  # the smallest leaf side
        xm, ym, zm = (x1 + x2) // 2, (y1 + y2) // 2, (z1 + z2) // 2
        node[7] = []
        for (a1, a2), (b1, b2), (c1, c2) in (
                ((x1, xm), (y1, ym), (z1, zm)), ((xm, x2), (y1, ym), (z1, zm)),
                ((x1, xm), (ym, y2), (z1, zm)), ((xm, x2), (ym, y2), (z1, zm)),
                ((x1, xm), (y1, ym), (zm, z2)), ((xm, x2), (y1, ym), (zm, z2)),
                ((x1, xm), (ym, y2), (zm, z2)), ((xm, x2), (ym, y2), (zm, z2))):
            child = [a1, a2, b1, b2, c1, c2, value(a1, a2, b1, b2, c1, c2), None]
            node[7].append(child)
            heapq.heappush(heap, (-child[6], serial, child))
            serial += 1
        count += 7
    leaves, stack = [], [root]
    while stack:  # depth first: children take their parent's place
        n = stack.pop()
        if n[7] is None:
            leaves.append(n)
        else:
            stack.extend(reversed(n[7]))
    boxes = np.asarray([n[:6] for n in leaves], np.int32).reshape(-1, 6)
    return boxes, np.asarray([n[6] for n in leaves], np.int64)


class FixedOctTree:
    """The tree of a cubic edge volume `domain` `[D, H, W]`: `boxes` `[n, 6]`
    and `values` `[n]` of its leaves in serialization order (`nodes`: the
    leaves as `[Cube, edge mass]`)."""

    def __init__(self, domain: np.ndarray, fixed_length: int = 128, norm_factor: int = 255
                 ) -> None:
        h, w, d = domain.shape
        if not (h > 0 and h == w == d):
            raise ValueError(f"the octree takes a cubic volume, got {domain.shape}")
        from ucf_vit_tpu_torch import native

        self.domain = domain
        self.fixed_length = fixed_length
        self.norm_factor = norm_factor
        self.boxes, self.values = native.octree_boxes(domain, fixed_length, norm_factor)

    @property
    def nodes(self):
        return [[Cube(*(int(c) for c in b)), int(v)] for b, v in zip(self.boxes, self.values)]

    def _serialize(self, img: np.ndarray, size, nearest: bool):
        h2, w2, d2, _ = size
        if not h2 == w2 == d2:
            raise ValueError(f"octree patches are cubic, got {size}")
        from ucf_vit_tpu_torch import native

        return native.octree_serialize(img, self.boxes, self.fixed_length, h2, nearest)

    def serialize(self, img: np.ndarray, size=(8, 8, 8, 1)):
        """Leaves of `img` `[D, H, W, C]` -> (patches `[L, p, p, p, C]` f32
        trilinear, sizes `[L]`, centres `[L, 3]`)."""
        return self._serialize(img, size, nearest=False)

    def serialize_labels(self, img: np.ndarray, size=(8, 8, 8, 1)):
        """Nearest-neighbour variant for integer label volumes."""
        return self._serialize(img, size, nearest=True)

    def deserialize(self, seq: np.ndarray, patch_size: int, channel: int) -> np.ndarray:
        """Write predicted patches `[fixed_length, p, p, p, channel]` back into
        volume space `[D, H, W, channel]`."""
        h, w, d = self.domain.shape
        seq = np.reshape(seq, (self.fixed_length,) + (patch_size,) * 3 + (channel,))
        mask = np.zeros(shape=(h, w, d, channel))
        for idx, (cube, _) in enumerate(self.nodes):
            mask = cube.set_area(mask, seq[idx])
        return mask
