"""Multi-dataset load balancing: assign data-parallel ranks to datasets in
proportion to their tile counts, and compute batches per rank per epoch.
The port's own copy of `ucf_vit_tpu/data/load_balance.py`. Tile counting
reuses the pipeline's `tile_starts`, so the count always matches what the
iterator yields.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Dict, List, Tuple

import numpy as np

from ucf_vit_tpu_torch.data.pipeline import read_nifti_file, read_npy_file, tile_starts


def list_files(root_dir: str, dataset: str) -> List[str]:
    """Training file list for one dataset root (<root>/imagesTr outside
    imagenet and catsdogs)."""
    if dataset in ("imagenet", "catsdogs"):
        out = []
        for cls_name in sorted(os.listdir(root_dir)):
            out.extend(sorted(glob.glob(os.path.join(root_dir, cls_name, "*.JPEG"))))
            out.extend(sorted(glob.glob(os.path.join(root_dir, cls_name, "*.jpg"))))
        return out
    d = os.path.join(root_dir, "imagesTr")
    return sorted(os.path.join(d, f) for f in os.listdir(d))


def process_root_dirs(
    dataset: str, dict_root_dirs: Dict[str, str], data_par_size: int
) -> Dict:
    """For imagenet, classes are grouped into data_par_size per-rank-group
    shards; otherwise one file list per dataset key."""
    if dataset == "imagenet":
        out = {}
        for _, root_dir in dict_root_dirs.items():
            classes = sorted(os.listdir(root_dir))
            classes_to_combine = max(int(len(classes) // data_par_size), 1)
            img_list: List[str] = []
            counter = 0
            num_roots = 0
            for cls_name in classes:
                if counter == classes_to_combine:
                    counter = 0
                    img_list = []
                img_list = img_list + sorted(
                    glob.glob(os.path.join(root_dir, cls_name, "*.JPEG"))
                )
                counter += 1
                if counter == classes_to_combine:
                    out[num_roots] = img_list
                    num_roots += 1
                if num_roots > data_par_size - 1:
                    break
        return out
    return {k: list_files(root, dataset) for k, root in dict_root_dirs.items()}


def _tiles_per_image(
    shape,
    tile_size,
    tile_overlap: float,
    use_all_data: bool,
    twoD: bool,
    dataset: str,
) -> int:
    """Count tiles one image/volume yields (via the actual tiling logic)."""
    if dataset in ("imagenet", "catsdogs"):
        nx = len(tile_starts(shape[0], tile_size[0], tile_overlap, use_all_data))
        ny = len(tile_starts(shape[1], tile_size[1], tile_overlap, use_all_data))
        return nx * ny
    nx = len(tile_starts(shape[0], tile_size[0], tile_overlap, use_all_data))
    ny = len(tile_starts(shape[1], tile_size[1], tile_overlap, use_all_data))
    if twoD:
        nz = shape[2] if use_all_data else (shape[2] // tile_size[2]) * tile_size[2]
        return nx * ny * nz
    nz = len(tile_starts(shape[2], tile_size[2], tile_overlap, use_all_data))
    return nx * ny * nz


def calculate_load_balancing(
    *,
    dataset: str,
    dict_root_dirs: Dict[str, str],
    dict_start_idx: Dict,
    dict_end_idx: Dict,
    num_channels_used: Dict,
    tile_size,
    twoD: bool,
    single_channel: bool,
    batch_size: int,
    tile_overlap: float,
    use_all_data: bool,
    data_par_size: int,
    imagenet_resize=None,
    verbose: bool = False,
) -> Tuple[Dict[str, int], str]:
    """Returns (batches_per_rank_epoch, dataset_group_list string)."""
    listers = process_root_dirs(dataset, dict_root_dirs, data_par_size)

    num_total_images, tiles_per_image, num_channels_ds, num_total_tiles = [], [], [], []
    for i, k in enumerate(listers.keys()):
        files = listers[k]
        key = "imagenet" if dataset == "imagenet" else k
        s = int(dict_start_idx[key] * len(files))
        e = int(dict_end_idx[key] * len(files))
        keys = files[s:e]
        num_total_images.append(len(keys))
        # assume all files in a dataset share the first file's shape
        path = keys[0]
        if dataset in ("imagenet", "catsdogs"):
            rs = imagenet_resize["imagenet"] if imagenet_resize else (256, 256)
            shape = (rs[0], rs[1])
        else:
            vol = (
                read_npy_file(path)
                if path.endswith(".npy")
                else read_nifti_file(path)
            )
            shape = vol.shape[1:]  # drop channel dim
        tiles_per_image.append(
            _tiles_per_image(shape, tile_size, tile_overlap, use_all_data, twoD, dataset)
        )
        num_channels_ds.append(
            num_channels_used["imagenet" if dataset == "imagenet" else k]
        )
        mult = num_channels_ds[i] if single_channel else 1
        num_total_tiles.append(tiles_per_image[i] * mult * num_total_images[i])

    total = sum(num_total_tiles)

    # proportional rank allocation + the reference's rebalance loop
    ddp_ratio = [t / total * data_par_size for t in num_total_tiles]
    ranks = [int(np.rint(r)) for r in ddp_ratio]
    while sum(ranks) != data_par_size:
        leftover = [
            (ranks[i] - ddp_ratio[i]) if ranks[i] >= ddp_ratio[i] else -(ddp_ratio[i] - ranks[i])
            for i in range(len(ranks))
        ]
        if sum(ranks) > data_par_size:
            cand = [i for i in range(len(ranks)) if leftover[i] >= 0 and ranks[i] > 1]
            if not cand:
                cand = [i for i in range(len(ranks)) if ranks[i] > 1]
            ranks[max(cand, key=lambda i: leftover[i])] -= 1
        else:
            cand = [i for i in range(len(ranks)) if leftover[i] <= 0]
            if not cand:
                cand = list(range(len(ranks)))
            ranks[min(cand, key=lambda i: leftover[i])] += 1
    if not all(r > 0 for r in ranks):
        raise ValueError(
            "all datasets need at least one rank; add devices or drop tiny datasets"
        )

    images_per_rank = [
        int(math.floor(num_total_images[i] / float(ranks[i]))) for i in range(len(ranks))
    ]
    if min(images_per_rank) < 1:
        raise ValueError("not all ranks have their own image")

    batches_per_rank = []
    for i in range(len(ranks)):
        mult = num_channels_ds[i] if single_channel else 1
        batches_per_rank.append(
            int(images_per_rank[i] * tiles_per_image[i] * mult // batch_size)
        )

    if dataset == "imagenet":
        bpre = {"imagenet": int(min(batches_per_rank))}
    else:
        bpre = {k: batches_per_rank[i] for i, k in enumerate(listers.keys())}
    group_list = ":".join(str(r) for r in ranks)
    if verbose:
        print("total images", num_total_images)
        print("tiles/image", tiles_per_image)
        print("total tiles", num_total_tiles)
        print("batches_per_rank_epoch:", bpre)
        print("dataset_group_list:", group_list)
    return bpre, group_list


def calculate_load_balancing_from_config(conf: dict, data_par_size: int, verbose=False):
    """YAML config dict -> load balancing."""
    init_args = conf["model"]["net"]["init_args"]
    data = conf["data"]
    return calculate_load_balancing(
        dataset=data["dataset"],
        dict_root_dirs=data["dict_root_dirs"],
        dict_start_idx=data["dict_start_idx"],
        dict_end_idx=data["dict_end_idx"],
        num_channels_used=data["num_channels_used"],
        tile_size=init_args["tile_size"],
        twoD=init_args["twoD"],
        single_channel=data["single_channel"],
        batch_size=data["batch_size"],
        tile_overlap=data["tile_overlap"],
        use_all_data=data["use_all_data"],
        data_par_size=data_par_size,
        imagenet_resize=conf.get("dataset_options", {}).get("imagenet_resize"),
        verbose=verbose,
    )
