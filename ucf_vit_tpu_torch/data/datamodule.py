"""DataModule: multi-source datasets, step-level dataset scheduling, epoch
reshuffles, and a background-thread prefetcher. The port's own copy of
`ucf_vit_tpu/data/datamodule.py`: the same seeds give the same batches,
array for array, adaptive ones (2-D and 3-D) too.

Each dataset key gets one chain (`FileReader` -> tiles -> `ShuffleBuffer`
-> `ProcessChannels` -> `BatchIterator`) with a numpy Generator of its own,
keyed by (seed, epoch, dataset key). Datasets are scheduled across steps:
each step trains one dataset, chosen by a deterministic weighted
round-robin over the load-balanced group list (`gx`). Files are sharded per
process (`proc_rank` of `num_procs`); one process is shard 0 of 1.

Adaptive patching: each chain draws an augmentation seed from its
generator, and sample i of the chain patchifies from `SeedSequence([seed,
i])`, so the stream does not depend on `num_workers` (as in the JAX
package, `num_workers` N > 1 makes samples in a spawn pool of N - 1
processes, 0 and 1 in line) and a mid-epoch resume skips samples without
patchifying them.
"""

from __future__ import annotations

import queue
import threading
import zlib
from typing import Dict, Iterator, Optional

import numpy as np

from ucf_vit_tpu_torch.data.load_balance import process_root_dirs
from ucf_vit_tpu_torch.data.pipeline import (
    BatchIterator,
    FileReader,
    ProcessChannels,
    ShuffleBuffer,
    TileIterator2D,
    TileIterator3D,
)


class Prefetcher:
    """Background-thread prefetch, at most `depth` items ahead. A reader's
    exception is raised on the consumer's side. When the consumer stops
    early (an epoch ends before its iterator does), the thread stops at its
    next item and closes the source, so no reader outlives its epoch."""

    def __init__(self, iterable, depth: int = 2):
        self.iterable = iterable
        self.depth = depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        sentinel = object()
        err: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            it = iter(self.iterable)
            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                err.append(e)
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()


class DataModule:
    def __init__(
        self,
        dict_root_dirs: Dict,
        dict_start_idx: Dict,
        dict_end_idx: Dict,
        dict_buffer_sizes: Dict,
        dict_in_variables: Dict,
        num_channels_used: Dict,
        batch_size: int = 64,
        patch_size: int = 16,
        tile_size_x: int = 64,
        tile_size_y: int = 64,
        tile_size_z: Optional[int] = None,
        twoD: bool = True,
        single_channel: bool = False,
        dataset_group_list: str = "",
        batches_per_rank_epoch: Optional[Dict] = None,
        tile_overlap: float = 0.0,
        use_all_data: bool = False,
        adaptive_patching: bool = False,
        fixed_length: int = 4096,
        separate_channels: bool = False,
        data_par_size: int = 1,
        dataset: str = "imagenet",
        return_label: bool = False,
        num_classes: Optional[int] = None,
        imagenet_resize: Optional[Dict] = None,
        proc_rank: int = 0,
        num_procs: int = 1,
        seed: int = 0,
        prefetch: int = 2,
        num_workers: int = 0,
        return_qdt: bool = False,
    ):
        if len(dict_root_dirs) > data_par_size:
            raise ValueError("need at least one data-parallel rank per dataset")
        if dataset_group_list == "":
            per = data_par_size // len(dict_root_dirs)
            self.gx = ":".join([str(per)] * len(dict_root_dirs))
        else:
            self.gx = dataset_group_list
        if not 0 <= proc_rank < num_procs:
            raise ValueError(f"proc_rank {proc_rank} out of range for {num_procs} processes")
        if dataset == "basic_ct" and return_label and num_classes is None:
            raise ValueError("segmentation needs num_classes")

        self.dict_root_dirs = dict_root_dirs
        self.dict_start_idx = dict_start_idx
        self.dict_end_idx = dict_end_idx
        self.dict_buffer_sizes = dict_buffer_sizes
        self.dict_in_variables = {
            k: list(v) for k, v in dict_in_variables.items() if v is not None
        }
        self.num_channels_used = num_channels_used
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.tile_size = (tile_size_x, tile_size_y, tile_size_z)
        self.twoD = twoD
        self.single_channel = single_channel
        self.batches_per_rank_epoch = batches_per_rank_epoch or {}
        self.tile_overlap = tile_overlap
        self.use_all_data = use_all_data
        self.adaptive_patching = adaptive_patching
        self.fixed_length = fixed_length
        self.separate_channels = separate_channels
        self.data_par_size = data_par_size
        self.dataset = dataset
        self.return_label = return_label
        self.num_classes = num_classes
        self.imagenet_resize = imagenet_resize or {"imagenet": (256, 256)}
        self.proc_rank = proc_rank
        self.num_procs = num_procs
        self.prefetch = prefetch
        # as in the JAX package: 1 is the in-line worker, N > 1 a pool of N - 1
        self.num_workers = max(int(num_workers) - 1, 0)
        self.return_qdt = return_qdt
        self._epoch = 0
        self._seed = seed

        # imagenet: classes are pre-grouped into num_procs shards and each
        # process reads its own (key == proc_rank); other datasets get one file
        # list per dataset key, sharded per process inside FileReader
        self.dict_lister_trains = process_root_dirs(dataset, dict_root_dirs, num_procs)
        if dataset == "imagenet":
            self.dict_lister_trains = {proc_rank: self.dict_lister_trains[proc_rank]}
        self.dict_data_train: Optional[Dict] = None

    # ------------------------------------------------------------------ setup

    @property
    def max_balance(self) -> int:
        if self.dataset == "imagenet":
            return self.batches_per_rank_epoch.get("imagenet", 0)
        return max(self.batches_per_rank_epoch.values(), default=0)

    def _keys_to_add(self, k) -> int:
        if self.dataset == "imagenet" or not self.batches_per_rank_epoch:
            return 1
        return int(np.ceil(self.max_balance / self.batches_per_rank_epoch[k]))

    def _build_chain(self, k, file_list, keys_to_add, rng):
        key = "imagenet" if self.dataset == "imagenet" else k
        shards = 1 if self.dataset == "imagenet" else self.num_procs
        rank = 0 if self.dataset == "imagenet" else self.proc_rank
        reader = FileReader(
            file_list,
            start_idx=self.dict_start_idx[key],
            end_idx=self.dict_end_idx[key],
            variables=self.dict_in_variables[key],
            shard_rank=rank,
            data_par_size=shards,
            return_label=self.return_label,
            keys_to_add=keys_to_add,
            dataset=self.dataset,
            imagenet_resize=self.imagenet_resize.get("imagenet", (256, 256)),
        )
        tx, ty, tz = self.tile_size
        if self.dataset in ("imagenet", "catsdogs"):
            tiles = TileIterator2D(reader, tx, ty, return_label=self.return_label,
                                   tile_overlap=self.tile_overlap,
                                   use_all_data=self.use_all_data, classification=True)
        else:
            tiles = TileIterator3D(reader, tx, ty, tz, twoD=self.twoD,
                                   return_label=self.return_label,
                                   tile_overlap=self.tile_overlap,
                                   use_all_data=self.use_all_data)
        shuffled = ShuffleBuffer(tiles, self.dict_buffer_sizes[key], rng=rng)
        # the chain's augmentation seed, drawn before any shuffle draw, as the
        # JAX package draws it (and draws it without adaptive patching too)
        aug_seed = int(rng.integers(0, 2**63))
        processed = ProcessChannels(
            shuffled,
            num_channels=self.num_channels_used[key],
            single_channel=self.single_channel,
            return_label=self.return_label,
            dataset=self.dataset,
            batch_size=self.batch_size,
            adaptive_patching=self.adaptive_patching,
            separate_channels=self.separate_channels,
            patch_size=self.patch_size,
            fixed_length=self.fixed_length,
            twoD=self.twoD,
            num_classes=self.num_classes,
            num_workers=self.num_workers,
            return_qdt=self.return_qdt,
            rng=rng,
            aug_seed=aug_seed,
        )
        return BatchIterator(processed, self.batch_size, self.dataset)

    def _assemble(self):
        data = {}
        for k, lister in self.dict_lister_trains.items():
            # one Generator per chain, keyed by (seed, epoch, dataset key): a
            # chain's stream depends only on its own pull count
            rng = np.random.default_rng(
                np.random.SeedSequence([self._seed, self._epoch, zlib.crc32(str(k).encode())])
            )
            keys_to_add = self._keys_to_add(k)
            files = list(rng.permutation(np.asarray(lister, dtype=object)))
            for _ in range(keys_to_add - 1):
                files.extend(rng.permutation(np.asarray(lister, dtype=object)))
            data[k] = self._build_chain(k, [str(f) for f in files], keys_to_add, rng)
        self.dict_data_train = data

    def setup(self):
        if not self.dict_data_train:
            self._assemble()

    def reset(self):
        """The next epoch's file-list reshuffle."""
        self._epoch += 1
        self._assemble()

    def set_epoch(self, epoch: int):
        """Pin the shuffle epoch: the chains are (re)built for `epoch`'s
        file permutation, so a resumed run sees the same epoch-E stream as an
        uninterrupted one. No-op when they already are."""
        if self.dict_data_train is None or self._epoch != int(epoch):
            self._epoch = int(epoch)
            self._assemble()

    # ------------------------------------------------------------------- iter

    def _schedule_weights(self) -> Dict:
        """Dataset key -> step share, from the load-balanced group list."""
        keys = list(self.dict_data_train.keys())
        if len(keys) == 1:
            return {keys[0]: 1}
        group_list = [int(x) for x in self.gx.split(":")]
        if len(group_list) != len(keys):
            raise ValueError(
                f"dataset_group_list has {len(group_list)} entries for {len(keys)} datasets")
        if self.data_par_size != sum(group_list):
            raise ValueError(
                f"group list {self.gx} must sum to data_par_size {self.data_par_size}")
        return dict(zip(keys, group_list))

    def train_dataloader(self, loop: bool = False, skip_batches: int = 0) -> Iterator[dict]:
        """Scheduled batches across this process's dataset chains: each step
        one dataset, chosen by deterministic weighted round-robin; each batch
        carries its dataset key (`dict_key`).

        loop=True (the trainer's mode): the per-step dataset choice is a pure
        function of the step index; an exhausted chain wraps around and the
        epoch's length is the trainer's `iterations_per_epoch`. loop=False
        ends when every chain is exhausted.

        skip_batches=N (mid-epoch resume): the first batch yielded is batch N
        of the epoch's stream. The schedule is advanced by N picks and each
        chain skips its share of samples, its read/tile/shuffle state
        advancing exactly as in an uninterrupted run."""
        if self.dict_data_train is None:
            raise RuntimeError("call setup() first")
        weights = self._schedule_weights()
        # this epoch's chains: a prefetch thread still running after the epoch
        # ends must not wrap around into the next epoch's chains (`reset`)
        chains = dict(self.dict_data_train)

        # advance the schedule and hand each chain its skip budget before any
        # iteration starts: the prefetch thread must not race a mutation
        pre_emitted = {k: 0 for k in weights}
        for _ in range(int(skip_batches)):
            k = min(weights, key=lambda k: (pre_emitted[k] + 1) / weights[k])
            pre_emitted[k] += 1
        for k, n in pre_emitted.items():
            if n:
                chains[k].source.skip_samples += n * self.batch_size

        def scheduled():
            iters = {k: iter(chains[k]) for k in weights}
            emitted = dict(pre_emitted)
            while iters:
                # the dataset furthest below its share goes next
                k = min(iters, key=lambda k: (emitted[k] + 1) / weights[k])
                exhausted = False
                while True:  # drain this chain's skipped (None) batches
                    try:
                        batch = next(iters[k])
                    except StopIteration:
                        if not loop:
                            del iters[k]
                            exhausted = True
                            break
                        iters[k] = iter(chains[k])
                        try:
                            batch = next(iters[k])
                        except StopIteration:
                            raise RuntimeError(
                                f"dataset {k!r} yields no batches on this process's file "
                                f"shard: shard too small for the batch size") from None
                    if batch is not None:
                        break
                if exhausted:
                    continue
                emitted[k] += 1
                batch["dict_key"] = k
                yield batch

        if self.prefetch > 0:
            return iter(Prefetcher(scheduled(), depth=self.prefetch))
        return scheduled()
