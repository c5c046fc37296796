"""Iterator data pipeline: file reading -> tiling -> shuffle -> channel
processing -> batching. The port's own copy of the non-adaptive parts of
`ucf_vit_tpu/data/pipeline.py`: the same readers, tile offsets, shuffle
draws and batch layout, so that the same files and seeds give the same
batches, array for array.

Batches are dicts of numpy arrays: `{x [B,C,...], (label), variables}`,
with adaptive patching also `seq`, `seq_size`, `seq_pos` (and `seq_label`,
`qdt`).

Adaptive patching: the quadtree `Patchify` in 2-D and the octree
`Patchify3D` in 3-D, label serialisation, per-sample augmentation seeds and
the spawn pool (`ProcessChannels`).
"""

from __future__ import annotations

import collections
import math
import multiprocessing.context
import os
import sys
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ucf_vit_tpu_torch.data import nifti

READ_THREADS = 4  # FileReader's read threads; it reads twice as many files ahead

# ---------------------------------------------------------------------------
# File reading
# ---------------------------------------------------------------------------


def _jpeg_modules():
    """(PIL.Image, cv2), imported when a JPEG is first read. They are the
    port's only optional third-party imports; a missing one raises here,
    named, and nothing stands in for it."""
    try:
        from PIL import Image
        import cv2
    except ImportError as e:
        raise ImportError(
            f"reading JPEG files needs {e.name!r} (PIL and cv2), which is not "
            "installed"
        ) from e
    return Image, cv2


def read_imagenet_file(path: str, resize=(256, 256), return_label=False):
    """JPEG -> [3, H, W] uint8 (+ class index from the parent dir name)."""
    Image, cv2 = _jpeg_modules()
    data = np.array(Image.open(path).convert("RGB"))
    data = cv2.resize(data, dsize=(resize[0], resize[1]))
    data = np.moveaxis(data, -1, 0)
    if not return_label:
        return data
    p = Path(path)
    classes = sorted(os.listdir(p.parent.parent))
    label = {c: i for i, c in enumerate(classes)}[p.parent.stem]
    return data, label


def read_nifti_file(path: str, num_channels: int = 1, return_label=False):
    """NIfTI volume, min-max normalised -> [C, ...] f32 (+ the label volume
    from the sibling labelsTr dir, shifted to 0-based)."""
    data = nifti.load(path).astype(np.float32)
    data = (data - data.min()) / (data.max() - data.min())
    if num_channels == 1:
        data = np.expand_dims(data, axis=0)
    if not return_label:
        return data
    p = Path(path)
    stem = p.stem.split("image")[-1]
    label_path = os.path.join(p.parent.parent, "labelsTr", "label" + stem + ".nii")
    label = nifti.load(label_path).astype(np.int64) - 1
    return data, label


def read_npy_file(path: str, num_channels: int = 1, return_label=False):
    """Plain .npy volume: image at <root>/imagesTr/x.npy, label at
    <root>/labelsTr/x.npy."""
    data = np.load(path).astype(np.float32)
    mx, mn = data.max(), data.min()
    if mx > mn:
        data = (data - mn) / (mx - mn)
    if data.ndim in (2, 3) and num_channels == 1:
        data = np.expand_dims(data, axis=0)
    if not return_label:
        return data
    label_path = str(Path(path).parent.parent / "labelsTr" / Path(path).name)
    label = np.load(label_path).astype(np.int64)
    return data, label


class FileReader:
    """Rank-sharded file iterator: this shard's files, read by READ_THREADS
    threads with a read-ahead window of twice as many files, emitted in
    order."""

    def __init__(
        self,
        file_list: Sequence[str],
        start_idx: float,
        end_idx: float,
        variables: Sequence[str],
        shard_rank: int = 0,
        data_par_size: int = 1,
        return_label: bool = False,
        keys_to_add: int = 1,
        dataset: str = "imagenet",
        imagenet_resize=(256, 256),
    ) -> None:
        s = int(start_idx * len(file_list))
        e = int(end_idx * len(file_list))
        self.file_list = list(file_list[s:e])
        self.variables = list(variables)
        self.num_channels_available = len(variables)
        self.shard_rank = shard_rank
        self.data_par_size = data_par_size
        self.return_label = return_label
        self.keys_to_add = keys_to_add
        self.dataset = dataset
        self.imagenet_resize = imagenet_resize

    def read_process_file(self, path: str):
        if self.dataset in ("imagenet", "catsdogs"):
            return read_imagenet_file(path, self.imagenet_resize, self.return_label)
        if path.endswith(".npy"):
            return read_npy_file(path, self.num_channels_available, self.return_label)
        return read_nifti_file(path, self.num_channels_available, self.return_label)

    def _shard_bounds(self) -> Tuple[int, int]:
        """This rank's file range."""
        num_shards, rank = self.data_par_size, self.shard_rank
        per_worker = int(
            math.floor(len(self.file_list) / float(self.keys_to_add) / num_shards)
        )
        if per_worker == 0:
            self.file_list = (
                self.file_list * math.ceil(num_shards / len(self.file_list))
            )[:num_shards]
            per_worker = 1
        start = rank * per_worker
        return start, start + per_worker

    def _indices(self):
        iter_start, iter_end = self._shard_bounds()
        per_key = int(len(self.file_list) / self.keys_to_add)
        for m in range(self.keys_to_add):
            yield from range(iter_start + m * per_key, iter_end + m * per_key)

    def __iter__(self) -> Iterator:
        window = 2 * READ_THREADS
        with ThreadPoolExecutor(max_workers=READ_THREADS) as pool:
            pending = collections.deque()
            for idx in self._indices():
                pending.append(pool.submit(self.read_process_file, self.file_list[idx]))
                while len(pending) >= window:
                    yield self._emit(pending.popleft().result())
            while pending:
                yield self._emit(pending.popleft().result())

    def _emit(self, out):
        if self.return_label:
            data, label = out
            return data, label, self.variables
        return out, self.variables


# ---------------------------------------------------------------------------
# Tiling
# ---------------------------------------------------------------------------


def tile_starts(length: int, tile: int, overlap: float, use_all_data: bool) -> List[int]:
    """Start offsets of tiles along one axis: evenly spaced tiles with the
    overlap's step, plus (use_all_data) end tiles clamped to cover the
    remainder."""
    ov = int(tile * overlap)
    if ov == 0:
        otp2 = 1
        step = tile
    else:
        otp2 = int(tile / ov)
        step = tile - ov
    tte = length // tile
    num_blocks = (tte - 1) * otp2 + 1
    if use_all_data:
        tt = length / tile
        ltop = math.floor((tt - tte) * otp2)
        if ov == 0:
            if length % tile != 0:
                ltop += 1
        else:
            if length % ov != 0:
                ltop += 1
        num_blocks = int(num_blocks + ltop)
    starts = []
    for i in range(num_blocks):
        s = i * step
        if s + tile > length - 1 and use_all_data:
            s = length - tile  # clamp to the end
        if not use_all_data or s + tile <= length:
            starts.append(min(s, length - tile))
    return starts


class TileIterator2D:
    """Slice [C, X, Y] images into [C, tx, ty] tiles."""

    def __init__(self, source, tile_size_x, tile_size_y, return_label=False,
                 tile_overlap=0.0, use_all_data=False, classification=False):
        self.source = source
        self.tx, self.ty = tile_size_x, tile_size_y
        self.return_label = return_label
        self.tile_overlap = tile_overlap
        self.use_all_data = use_all_data
        self.classification = classification

    def __iter__(self):
        for item in self.source:
            if self.return_label:
                data, label, variables = item
            else:
                data, variables = item
                label = None
            xs = tile_starts(data.shape[1], self.tx, self.tile_overlap, self.use_all_data)
            ys = tile_starts(data.shape[2], self.ty, self.tile_overlap, self.use_all_data)
            for sx in xs:
                for sy in ys:
                    tile = data[:, sx : sx + self.tx, sy : sy + self.ty]
                    if label is None:
                        yield tile, variables
                    elif self.classification:
                        yield tile, label, variables
                    else:
                        yield tile, label[sx : sx + self.tx, sy : sy + self.ty], variables


class TileIterator3D:
    """Slice [C, X, Y, Z] volumes into tiles; twoD=True yields 2-D slices
    from each z-chunk."""

    def __init__(self, source, tile_size_x, tile_size_y, tile_size_z, twoD=True,
                 return_label=False, tile_overlap=0.0, use_all_data=False):
        self.source = source
        self.tx, self.ty, self.tz = tile_size_x, tile_size_y, tile_size_z
        self.twoD = twoD
        self.return_label = return_label
        self.tile_overlap = tile_overlap
        self.use_all_data = use_all_data

    def __iter__(self):
        for item in self.source:
            if self.return_label:
                data, label, variables = item
            else:
                data, variables = item
                label = None
            xs = tile_starts(data.shape[1], self.tx, self.tile_overlap, self.use_all_data)
            ys = tile_starts(data.shape[2], self.ty, self.tile_overlap, self.use_all_data)
            if self.twoD:
                zlen = data.shape[3]
                zs = range(zlen) if self.use_all_data else range((zlen // self.tz) * self.tz)
                for sx in xs:
                    for sy in ys:
                        for z in zs:
                            tile = data[:, sx : sx + self.tx, sy : sy + self.ty, z]
                            if label is None:
                                yield tile, variables
                            else:
                                yield tile, label[sx : sx + self.tx, sy : sy + self.ty, z], \
                                    variables
            else:
                zs = tile_starts(data.shape[3], self.tz, self.tile_overlap, self.use_all_data)
                for sx in xs:
                    for sy in ys:
                        for sz in zs:
                            sl = (slice(sx, sx + self.tx), slice(sy, sy + self.ty),
                                  slice(sz, sz + self.tz))
                            tile = data[(slice(None),) + sl]
                            if label is None:
                                yield tile, variables
                            else:
                                yield tile, label[sl], variables


# ---------------------------------------------------------------------------
# Shuffle + channel processing + batching
# ---------------------------------------------------------------------------


class ShuffleBuffer:
    """Reservoir-style shuffle with an explicit seedable Generator."""

    def __init__(self, source, buffer_size: int, rng: Optional[np.random.Generator] = None):
        if buffer_size <= 0:
            raise ValueError(f"buffer_size must be positive, got {buffer_size}")
        self.source = source
        self.buffer_size = buffer_size
        self.rng = rng or np.random.default_rng()

    def __iter__(self):
        buf = []
        for x in self.source:
            if len(buf) == self.buffer_size:
                idx = int(self.rng.integers(0, self.buffer_size))
                yield buf[idx]
                buf[idx] = x
            else:
                buf.append(x)
        order = self.rng.permutation(len(buf))
        for i in order:
            yield buf[i]


class ProcessChannels:
    """Split channels into per-variable streams (single_channel mode: each
    variable's stream is buffered and flushed a full batch at a time, so
    every batch is channel-pure) and make sample dicts; see `collate`.

    Adaptive patching (`data/transform.Patchify` in 2-D, `Patchify3D` in
    3-D): each sample also carries `seq` `[C', L, p^nd]`, `seq_size` `[C',
    L]` and `seq_pos` `[C', L, nd]` (C' = 1 for one tree across the
    channels), `seq_label` (`[L, p, p(, p)]`) for a
    labelled basic_ct sample, and with `return_qdt` the tree objects. With
    `aug_seed` the patchify draws of the sample with consumption index i come
    from `SeedSequence([aug_seed, i])`, whatever process makes it.
    `num_workers > 0` makes samples in a spawn pool of that many processes
    (`make_pool`: the children import the port's data modules and nothing
    else, so none touches the card), started at the first iteration and kept
    until this object is collected; that needs `aug_seed`.

    `skip_samples` (mid-epoch fast-forward): the upstream chain (read, tile,
    shuffle) runs as usual so its state stays exact, the skipped samples are
    not patchified, and a None placeholder is emitted for each, which
    `BatchIterator` collapses into None batches."""

    def __init__(self, source, num_channels: int, single_channel: bool,
                 return_label: bool, dataset: str, batch_size: int = 1,
                 adaptive_patching: bool = False, separate_channels: bool = False,
                 patch_size: int = 16, fixed_length: int = 196, twoD: bool = True,
                 num_classes: Optional[int] = None, num_workers: int = 0,
                 return_qdt: bool = False, rng: Optional[np.random.Generator] = None,
                 aug_seed: Optional[int] = None):
        self.source = source
        self.num_channels = num_channels
        self.single_channel = single_channel
        self.return_label = return_label
        self.dataset = dataset
        self.batch_size = batch_size
        self.adaptive_patching = adaptive_patching
        self.separate_channels = separate_channels
        self.patch_size = patch_size
        self.fixed_length = fixed_length
        self.twoD = twoD
        self.num_classes = num_classes
        self.num_workers = int(num_workers)
        self.return_qdt = return_qdt
        self.aug_seed = aug_seed
        self.skip_samples = 0
        # a sample's consumption index, counted on across the re-iterations
        # of a looping epoch, as in the JAX pipeline
        self._next_idx = 0
        self._pool_ex = None
        self._pool_lock = threading.Lock()
        if adaptive_patching:
            from ucf_vit_tpu_torch.data.transform import Patchify, Patchify3D

            if self.num_workers > 0 and aug_seed is None:
                raise ValueError("num_workers > 0 needs aug_seed: each sample's draws must "
                                 "not depend on the process that makes it")
            nc = 1 if (single_channel or separate_channels) else num_channels
            self.patchify = (Patchify if twoD else Patchify3D)(
                fixed_length=fixed_length, patch_size=patch_size, num_channels=nc,
                dataset=dataset, rng=rng)

    def _serialize_label(self, qdt, np_label):
        p = self.patch_size
        size = (p, p, 1) if self.twoD else (p, p, p, 1)
        if self.dataset == "basic_ct":
            seq_label, _, _ = qdt.serialize_labels(np.expand_dims(np_label, axis=-1),
                                                   size=size)
            out = np.asarray(seq_label)
            # the singleton channel: cv2's resize drops it in 2-D, the octree keeps it
            return out[..., 0] if out.ndim == len(size) + 1 else out  # [L, p, p(, p)]
        seq_label, _, _ = qdt.serialize(np.expand_dims(np_label, axis=-1), size=size)
        return np.asarray(seq_label, dtype=np.float32).reshape(self.fixed_length, -1)

    def _patchify_sample(self, np_image, rng=None):
        """np_image `[C, *spatial]` -> (seq, size, pos, tree or trees), drawing
        from `rng` (default: the patchify's own generator)."""
        if self.single_channel or self.separate_channels:
            chans = [self.patchify(np.expand_dims(np_image[j], axis=-1), rng)
                     for j in range(np_image.shape[0])]
            if len(chans) == 1:
                return chans[0]
            return (np.stack([c[0] for c in chans]), np.stack([c[1] for c in chans]),
                    np.stack([c[2] for c in chans]), [c[3] for c in chans])
        return self.patchify(np.moveaxis(np_image, 0, -1), rng)

    def _make_sample(self, np_image, vars_out, label, idx=None) -> dict:
        """One sample dict. With `aug_seed` and `idx` the patchify draws come
        from a generator made for this call alone, so concurrent calls (the
        server's handler threads) never share one."""
        rng = None
        if self.adaptive_patching and self.aug_seed is not None and idx is not None:
            rng = np.random.default_rng(np.random.SeedSequence([self.aug_seed, int(idx)]))
        sample = {"x": np.asarray(np_image, dtype=np.float32), "variables": vars_out}
        if self.adaptive_patching:
            seq, size, pos, qdt = self._patchify_sample(np_image, rng)
            if seq.ndim == 2:  # one channel: [L, p^2]
                seq = seq[None]
            size = np.asarray(size, dtype=np.float32)
            pos = np.asarray(pos, dtype=np.float32)
            if size.ndim == 1:  # one tree across the channels: add their axis
                size, pos = size[None], pos[None]
            sample["seq"] = seq.astype(np.float32)
            sample["seq_size"] = size
            sample["seq_pos"] = pos
            if self.return_qdt:
                sample["qdt"] = qdt
            if label is not None and self.dataset != "imagenet":
                sample["seq_label"] = self._serialize_label(
                    qdt[0] if isinstance(qdt, list) else qdt, label)
        if label is not None:
            sample["label"] = (np.asarray(label) if np.ndim(label) > 0
                               else np.asarray(label, dtype=np.int64))
        return sample

    def _spec(self) -> dict:
        """What a pool child needs to make samples (`_pool_init`)."""
        return dict(num_channels=self.num_channels, single_channel=self.single_channel,
                    return_label=self.return_label, dataset=self.dataset,
                    batch_size=self.batch_size, adaptive_patching=self.adaptive_patching,
                    separate_channels=self.separate_channels, patch_size=self.patch_size,
                    fixed_length=self.fixed_length, twoD=self.twoD,
                    num_classes=self.num_classes, return_qdt=self.return_qdt,
                    aug_seed=self.aug_seed)

    def _indexed_raw(self):
        """Raw samples tagged with their consumption index; the ones
        `skip_samples` covers come out as None."""
        for item in self._raw_samples():
            idx = self._next_idx
            self._next_idx += 1
            if self.skip_samples > 0:
                self.skip_samples -= 1
                yield None
            else:
                yield (*item, idx)

    def __iter__(self):
        if self.num_workers <= 0 or not self.adaptive_patching:
            for item in self._indexed_raw():
                yield None if item is None else self._make_sample(*item)
            return
        window = 2 * self.num_workers
        pool = self._pool()
        pending = collections.deque()
        try:
            for args in self._indexed_raw():
                if args is None:  # a skipped sample: emit what is in flight first
                    while pending:
                        yield pending.popleft().result()
                    yield None
                    continue
                pending.append(pool.submit(_pool_make_sample, args))
                while len(pending) >= window:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:  # an epoch that stops early drops the samples in flight
            for f in pending:
                f.cancel()

    def _pool(self):
        """The spawn pool, started at the first iteration and kept for the
        next ones (a looping epoch iterates its chain again); shut down when
        this object is collected."""
        with self._pool_lock:
            if self._pool_ex is None:
                self._pool_ex = make_pool(self._spec(), self.num_workers)
                weakref.finalize(self, self._pool_ex.shutdown, wait=False,
                                 cancel_futures=True)
            return self._pool_ex

    def _raw_samples(self):
        num_buffers = self.num_channels if self.single_channel else 1
        buffers = [[] for _ in range(num_buffers)]
        for item in self.source:
            if self.return_label:
                data, label, variables = item
            else:
                data, variables = item
                label = None
            for i in range(num_buffers):
                if self.single_channel:
                    buffers[i].append((data[i : i + 1], (variables[i],), label))
                else:
                    buffers[i].append((data, tuple(variables), label))
                if len(buffers[i]) == self.batch_size:
                    while buffers[i]:
                        yield buffers[i].pop()


_POOL_PC: Optional[ProcessChannels] = None


def make_pool(spec: dict, workers: int):
    """A spawn pool of `workers` processes, each holding a source-less
    `ProcessChannels(**spec)` (`_pool_make_sample` makes a sample there).
    Spawn, never fork: the parent may hold a CUDA context. A spawned child
    would also run the parent's main module again (say the trainer's, which
    imports torch); these children do not (`_LeanSpawnProcess`), so one
    imports this module, numpy, cv2 and the port's data modules, and
    nothing that could touch the card. Every worker is started here, in
    the calling thread: with spawn, `ProcessPoolExecutor` would otherwise
    start them one by one inside later `submit` calls, in whatever thread
    makes them (a loader's prefetch thread, a server's handler)."""
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(max_workers=int(workers), mp_context=_LeanSpawnContext(),
                               initializer=_pool_init, initargs=(spec,))
    pool._launch_processes()  # all of them now; `submit` then finds the pool full
    return pool


# `_LeanSpawnProcess` edits the process-wide `__main__` while it starts a
# child: one start at a time, so that two pools started at once cannot leave
# it edited
_MAIN_SWAP_LOCK = threading.Lock()


class _LeanSpawnProcess(multiprocessing.context.SpawnProcess):
    @staticmethod
    def _Popen(process_obj):
        # a spawned child imports the main module when `__main__` names a
        # spec or a file (`multiprocessing.spawn.get_preparation_data`):
        # hide both while the child is prepared
        with _MAIN_SWAP_LOCK:
            main = sys.modules["__main__"]
            saved = {k: main.__dict__[k] for k in ("__spec__", "__file__")
                     if k in main.__dict__}
            main.__dict__["__spec__"] = None
            main.__dict__.pop("__file__", None)
            try:
                return multiprocessing.context.SpawnProcess._Popen(process_obj)
            finally:
                main.__dict__.pop("__spec__", None)
                main.__dict__.update(saved)


class _LeanSpawnContext(multiprocessing.context.SpawnContext):
    Process = _LeanSpawnProcess


def _pool_init(spec: dict) -> None:
    global _POOL_PC
    _POOL_PC = ProcessChannels(source=None, **spec)
    # one of several parallel workers: OpenCV's own thread pool in each (as many
    # threads as cores) would oversubscribe the host on calls this small; the
    # results are the same arrays either way
    from ucf_vit_tpu_torch.data.quadtree import _cv2

    _cv2().setNumThreads(1)


def _pool_make_sample(args) -> dict:
    img, vars_out, label, idx = args
    return _POOL_PC._make_sample(img, vars_out, label, idx)


def collate(samples: List[dict], dataset: str) -> dict:
    """Stack sample dicts into a numpy batch: x [B,C,...]; seq, seq_size and
    seq_pos keep their channel axis; labels stack; basic_ct labels get a
    leading channel dim; trees (`qdt`) stay a list."""
    batch = {"variables": samples[0]["variables"]}
    batch["x"] = np.stack([s["x"] for s in samples])
    for key in ("seq", "seq_size", "seq_pos"):
        if key in samples[0]:
            batch[key] = np.stack([s[key] for s in samples])
    if "label" in samples[0]:
        labels = [s["label"] for s in samples]
        if dataset == "basic_ct" and labels[0].ndim > 0:
            labels = [np.expand_dims(l, axis=0) for l in labels]
        batch["label"] = np.stack(labels)
    if "seq_label" in samples[0]:
        batch["seq_label"] = np.stack([s["seq_label"] for s in samples])
    if "qdt" in samples[0]:
        batch["qdt"] = [s["qdt"] for s in samples]
    return batch


class BatchIterator:
    """Group sample dicts into batches of batch_size (the last partial batch
    is dropped)."""

    def __init__(self, source, batch_size: int, dataset: str):
        self.source = source
        self.batch_size = batch_size
        self.dataset = dataset

    def __iter__(self):
        buf, skipped = [], 0
        for s in self.source:
            if s is None:  # a skipped sample (mid-epoch fast-forward)
                if buf:
                    raise ValueError("skip_samples must be a multiple of batch_size")
                skipped += 1
                if skipped == self.batch_size:
                    yield None
                    skipped = 0
                continue
            if skipped:
                raise ValueError("skip_samples must be a multiple of batch_size")
            buf.append(s)
            if len(buf) == self.batch_size:
                yield collate(buf, self.dataset)
                buf = []
