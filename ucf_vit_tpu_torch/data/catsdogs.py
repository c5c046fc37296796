"""Cats-vs-dogs map-style dataset: the port's own copy of the non-adaptive
parts of `ucf_vit_tpu/data/catsdogs.py`. Filename-prefix labels (dog=1,
cat=0), images resized to the tile, and the shard/shuffle/drop-last batch
logic. JPEGs are decoded by PIL and resized by cv2, imported when the first
image is read (`pipeline._jpeg_modules`)."""

from __future__ import annotations

import glob
import os
from typing import Iterator, Sequence

import numpy as np

from ucf_vit_tpu_torch.data.pipeline import ADAPTIVE_NOT_PORTED, _jpeg_modules, collate


def list_file_split(root: str, start_frac: float, end_frac: float) -> list:
    """The *.jpg files under `root`, the [start_frac, end_frac) slice of a
    fixed-seed permutation (sorted order puts every cat before every dog, so
    a contiguous fraction of it would hold one class)."""
    files = sorted(glob.glob(os.path.join(root, "*.jpg")))
    perm = np.random.RandomState(0).permutation(len(files))
    files = [files[i] for i in perm]
    return files[int(start_frac * len(files)) : int(end_frac * len(files))]


class CatsDogsDataset:
    def __init__(
        self,
        file_list: Sequence[str],
        variables: Sequence[str],
        tile_size,
        adaptive_patching: bool = False,
    ):
        if adaptive_patching:
            raise NotImplementedError(ADAPTIVE_NOT_PORTED)
        self.file_list = list(file_list)
        self.variables = tuple(variables)
        self.tile_size = tile_size

    def __len__(self) -> int:
        return len(self.file_list)

    def __getitem__(self, idx: int) -> dict:
        Image, cv2 = _jpeg_modules()
        path = self.file_list[idx]
        img = np.array(Image.open(path).convert("RGB"))
        img = cv2.resize(img, dsize=(self.tile_size[0], self.tile_size[1]))
        name = path.split("/")[-1].split(".")[0]
        return {
            "x": np.moveaxis(img, -1, 0).astype(np.float32),
            "label": np.asarray(1 if name == "dog" else 0, dtype=np.int64),
            "variables": self.variables,
        }


def catsdogs_loader(
    ds: CatsDogsDataset,
    batch_size: int,
    shard_rank: int = 0,
    num_shards: int = 1,
    seed: int = 0,
    shuffle: bool = True,
    skip_batches: int = 0,
) -> Iterator[dict]:
    """Sharded, shuffled, drop-last batch iterator. The permutation is a pure
    function of `seed`, so `skip_batches=N` starts at batch N of the same
    stream without decoding the skipped files."""
    idx = np.arange(len(ds))
    if shuffle:
        idx = np.random.default_rng(seed).permutation(idx)
    idx = idx[shard_rank::num_shards]
    n_batches = len(idx) // batch_size
    for b in range(int(skip_batches), n_batches):
        samples = [ds[int(i)] for i in idx[b * batch_size : (b + 1) * batch_size]]
        yield collate(samples, "catsdogs")
