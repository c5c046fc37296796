"""The fixed-length quadtree of adaptive patching (the port's own copy of
`ucf_vit_tpu/data/quadtree.py:86`): greedily split the leaf with the most
edge mass until `fixed_length` leaves exist (a leaf's side stops at 2
pixels), serialize the leaves to fixed-size patches with their sizes and
centres (zero-padded to `fixed_length`), and write predicted patches back
into image space.

A region's edge mass is `int(sum / 255)` from a summed-area table; that
truncation decides which leaf splits, so it is kept exactly. The frontier
is a max-heap that breaks ties by insertion order, and children take their
parent's place in the serialization order. The tree is built by the C++
build (`ucf_vit_tpu_torch.native`), which raises where it cannot build or
load; `quadtree_boxes_plain` is the numpy build, its plain version, which
the tests hold it against. cv2 is imported when a tree first serializes.
"""

from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("serializing an adaptive patch tree needs 'cv2', which is not "
                          "installed") from e
    return cv2


class Rect:
    __slots__ = ("x1", "x2", "y1", "y2")

    def __init__(self, x1: int, x2: int, y1: int, y2: int) -> None:
        if not (x1 <= x2 and y1 <= y2):
            raise ValueError(f"wrong coordinates ({x1}, {x2}, {y1}, {y2})")
        self.x1, self.x2, self.y1, self.y2 = x1, x2, y1, y2

    def get_area(self, img: np.ndarray) -> np.ndarray:
        return img[self.y1:self.y2, self.x1:self.x2, :]

    def set_area(self, mask: np.ndarray, patch: np.ndarray) -> np.ndarray:
        cv2 = _cv2()
        w, h = self.get_size()
        patch = cv2.resize(patch.astype("float32"), interpolation=cv2.INTER_CUBIC, dsize=(w, h))
        if patch.ndim == 2:
            patch = patch[:, :, None]
        mask[self.y1:self.y2, self.x1:self.x2, :] = patch
        return mask

    def get_coord(self):
        return self.x1, self.x2, self.y1, self.y2

    def get_size(self):
        return self.x2 - self.x1, self.y2 - self.y1

    def get_center(self):
        return (self.x2 + self.x1) / 2, (self.y2 + self.y1) / 2


def _sat(domain: np.ndarray) -> np.ndarray:
    """Summed-area table with a zero border: the sum of domain[y1:y2, x1:x2]
    is sat[y2, x2] - sat[y1, x2] - sat[y2, x1] + sat[y1, x1]."""
    s = np.zeros((domain.shape[0] + 1, domain.shape[1] + 1), np.int64)
    s[1:, 1:] = np.cumsum(np.cumsum(domain.astype(np.int64), axis=0), axis=1)
    return s


def _rect_value(sat: np.ndarray, x1: int, x2: int, y1: int, y2: int) -> int:
    return int((sat[y2, x2] - sat[y1, x2] - sat[y2, x1] + sat[y1, x1]) / 255)


def quadtree_boxes_plain(domain: np.ndarray, fixed_length: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy build: `(boxes [n, 4] int32 (x1, x2, y1, y2), values [n]
    int64)` of the leaves in serialization order, as `native.quadtree_boxes`
    gives them."""
    h, w = domain.shape
    sat = _sat(domain)
    # a node: [x1, x2, y1, y2, value, children]
    root = [0, w, 0, h, _rect_value(sat, 0, w, 0, h), None]
    heap: List[Tuple[int, int, list]] = [(-root[4], 0, root)]
    count, serial = 1, 1
    while count < fixed_length and heap:
        node = heapq.heappop(heap)[2]
        x1, x2, y1, y2 = node[:4]
        if x2 - x1 == 2:
            break  # the smallest leaf side
        xm, ym = (x1 + x2) // 2, (y1 + y2) // 2
        node[5] = []
        for q in ((x1, xm, ym, y2), (xm, x2, ym, y2), (x1, xm, y1, ym), (xm, x2, y1, ym)):
            child = [*q, _rect_value(sat, *q), None]
            node[5].append(child)
            heapq.heappush(heap, (-child[4], serial, child))
            serial += 1
        count += 3
    leaves, stack = [], [root]
    while stack:  # depth first: children take their parent's place
        n = stack.pop()
        if n[5] is None:
            leaves.append(n)
        else:
            stack.extend(reversed(n[5]))
    boxes = np.asarray([n[:4] for n in leaves], np.int32).reshape(-1, 4)
    return boxes, np.asarray([n[4] for n in leaves], np.int64)


class FixedQuadTree:
    """The tree of an edge map `domain` [H, W]: `nodes`, its leaves `[Rect,
    edge mass]` in serialization order."""

    def __init__(self, domain: np.ndarray, fixed_length: int = 128) -> None:
        h, w = domain.shape
        if h <= 0 or w <= 0:
            raise ValueError(f"wrong image size {domain.shape}")
        from ucf_vit_tpu_torch import native

        self.domain = domain
        self.fixed_length = fixed_length
        boxes, vals = native.quadtree_boxes(domain, fixed_length)
        self.nodes = [[Rect(*(int(c) for c in b)), int(v)] for b, v in zip(boxes, vals)]

    def encode_nodes(self):
        """The leaves' boxes `[[x1, x2, y1, y2], ...]`."""
        return [[r.x1, r.x2, r.y1, r.y2] for r, _ in self.nodes]

    def _serialize(self, img: np.ndarray, size, interpolation):
        h2, w2, c2 = size
        cv2 = _cv2()
        seq_patch, seq_size, seq_pos = [], [], []
        for rect, _ in self.nodes:
            area = rect.get_area(img)
            if area.shape[0] != area.shape[1]:
                raise ValueError(f"a leaf must be square, got {area.shape[:2]}")
            seq_patch.append(cv2.resize(area, (h2, w2), interpolation=interpolation))
            seq_size.append(rect.get_size()[0])
            seq_pos.append(rect.get_center())
        pad = self.fixed_length - len(seq_patch)
        if pad > 0:
            zero_shape = (h2, w2, c2) if c2 > 1 else (h2, w2)
            seq_patch += [np.zeros(zero_shape)] * pad
            seq_size += [0] * pad
            seq_pos += [(-1, -1)] * pad
        if len(seq_patch) != self.fixed_length:
            raise ValueError(f"{len(seq_patch)} leaves for a fixed length of "
                             f"{self.fixed_length}")
        return seq_patch, seq_size, seq_pos

    def serialize(self, img: np.ndarray, size=(8, 8, 3)):
        """Leaves -> (patches resized bicubic, sizes, centres)
        (`ucf_vit_tpu/data/quadtree.py:206`)."""
        return self._serialize(img, size, _cv2().INTER_CUBIC)

    def serialize_labels(self, img: np.ndarray, size=(8, 8, 3)):
        """Nearest-neighbour variant for integer label maps."""
        return self._serialize(img, size, _cv2().INTER_NEAREST)

    def deserialize(self, seq: np.ndarray, patch_size: int, channel: int):
        """Write predicted patches `[fixed_length, p, p, channel]` back into
        image space `[H, W, channel]`."""
        h, w = self.domain.shape
        seq = np.reshape(seq, (self.fixed_length, patch_size, patch_size, channel))
        mask = np.zeros(shape=(h, w, channel))
        for idx, (rect, _) in enumerate(self.nodes):
            mask = rect.set_area(mask, seq[idx])
        return mask
