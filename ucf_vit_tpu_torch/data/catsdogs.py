"""Cats-vs-dogs map-style dataset: the port's own copy of
`ucf_vit_tpu/data/catsdogs.py`. Filename-prefix labels (dog=1, cat=0),
images resized to the tile, the optional adaptive patchify (one quadtree
across the three channels, drawn from the generator the caller gives), and
the shard/shuffle/drop-last batch logic. JPEGs are decoded by PIL and
resized by cv2, imported when the first image is read
(`pipeline._jpeg_modules`)."""

from __future__ import annotations

import glob
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from ucf_vit_tpu_torch.data.pipeline import _jpeg_modules, collate


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
        twoD: bool = True,
        adaptive_patching: bool = False,
        fixed_length: int = 196,
        patch_size: int = 16,
        num_channels: int = 3,
        dataset: str = "catsdogs",
        rng: Optional[np.random.Generator] = None,
    ):
        self.file_list = list(file_list)
        self.variables = tuple(variables)
        self.tile_size = tile_size
        self.adaptive_patching = adaptive_patching
        if adaptive_patching:
            if not twoD:
                raise ValueError("catsdogs is 2D")
            from ucf_vit_tpu_torch.data.transform import Patchify

            self.patchify = Patchify(fixed_length=fixed_length, patch_size=patch_size,
                                     num_channels=num_channels, dataset=dataset, rng=rng)

    def __len__(self) -> int:
        return len(self.file_list)

    def __getitem__(self, idx: int) -> dict:
        Image, cv2 = _jpeg_modules()
        path = self.file_list[idx]
        img = np.array(Image.open(path).convert("RGB"))
        img = cv2.resize(img, dsize=(self.tile_size[0], self.tile_size[1]))
        name = path.split("/")[-1].split(".")[0]
        sample = {
            "x": np.moveaxis(img, -1, 0).astype(np.float32),
            "label": np.asarray(1 if name == "dog" else 0, dtype=np.int64),
            "variables": self.variables,
        }
        if self.adaptive_patching:
            seq_img, seq_size, seq_pos, _ = self.patchify(img)
            sample["seq"] = np.asarray(seq_img, np.float32)
            sample["seq_size"] = np.asarray(seq_size, np.float32)[None]
            sample["seq_pos"] = np.asarray(seq_pos, np.float32)[None]
        return sample


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
