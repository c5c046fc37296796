"""Trainer (port of `ucf_vit_tpu/train.py`):

    python -m ucf_vit_tpu_torch.train <config.yaml> [--synthetic]
        [--max-steps N] [--log-every K] [--single-device] [--device cuda|cpu]
    torchrun --nproc_per_node N -m ucf_vit_tpu_torch.train <config.yaml> ...

Seeded model init (the names `load_jax_params` fills) of the config's task
(classification, MAE, diffusion, UNETR or SAP), AdamW from the config's
`model:` keys, and one train step per batch: from the files the config's
`data:` section names (`build_dataloader`: the catsdogs folder through its
map-style loader, every other dataset through the `DataModule` with
`auto_load_balancing`),
or with `--synthetic` from the JAX package's `synthetic_batches` stream,
draw for draw. Epochs as the JAX trainer counts them (`max_epochs`;
`iterations_per_epoch` the largest of `batches_per_rank_epoch`; the data's
shuffle epoch pinned before each epoch), the one-step-lagged loss read, the
log line, the `trainer.metrics_path` JSONL records and `trainer.nan_guard`.
Runs on CUDA unless `device="cpu"`.

Checkpoints (`checkpoint.py`): with `trainer.checkpoint_path` set, the full
training state is saved at each epoch's end to the even/odd slot of the
epoch; `trainer.resume_from_checkpoint` continues from the slot that
`checkpoint_filename_for_loading` names (parameters, AdamW, loss scale, loss
list, step count and the generators' states, EMA reconciled with
`trainer.ema_decay`): at the next epoch, or inside the epoch a preemption
interrupted, fast-forwarding the batches it had trained on
(`skip_batches`); `trainer.init_params_from` warm-starts the parameters alone
from any port checkpoint or a file that the JAX package's `convert_checkpoint
to-torch` wrote; `trainer.pretrained_mae_checkpoint` (a file, or a directory
whose slot `pretrained_mae_filename` or `mae_checkpoint_filename` names,
empty: the newest) starts a UNETR's or a SAP's encoder from an MAE checkpoint
(`checkpoint.transfer_mae_encoder`: the decoder and mask token left out, the
position table resampled to the model's tokens).

Preemption: SIGTERM (or `trainer.preempt_after_steps`, a drill) stops the
run at the next step boundary with a checkpoint of the interrupted epoch
and its position (`data_it`), and `train` returns normally. Validation
(`trainer.val_every`, `val_batches`): the task loss with no gradient, in eval
mode, on the held-out split (`data.val_dict_start_idx` / `val_dict_end_idx`,
or another synthetic stream), through one looping iterator, logged beside
the train records. `trainer.tensorboard_dir` writes the scalars to
TensorBoard as well; `trainer.profile_dir` writes a `torch.profiler` trace of
steps 11-15 as a Chrome trace file.

Sharding: a config whose `parallelism:` asks for N = ddp x fsdp x tp > 1
processes trains on that many, launched by torchrun (or srun: `SLURM_PROCID`
/ `SLURM_NTASKS`), one device each (`parallel.mesh.init_distributed`;
`check_config` raises unless the launched world size is N). The model is
sharded by `parallel.train_step.shard_model`; the global batch is
`batch_size x data_par_size`, and each data rank reads its part: the
DataModule's `proc_rank`/`num_procs`, the catsdogs loader's shard, or the
synthetic stream's global batch sliced, so that a sharded synthetic run sees
the single-device run's data. Rank 0 alone prints the log lines and writes
`metrics_path`, TensorBoard and `profile_dir`; the loss it logs is the
global batch's. SIGTERM is agreed every `trainer.preempt_sync_every` steps
(25), so that every rank stops at the same step and saves together; the
dropout generators are seeded by the data rank (the tp ranks of one data
rank draw the same masks) and the attention-seed generator is the same on
every rank. `trainer.sync_check_every: N` checks the replicas every N steps
(`parallel.sync_check`). Sequence, pipeline and expert parallelism (sp, pp,
ep > 1) are not ported and are refused with their ROADMAP.md items.
`--single-device` trains any config on one device.

`trainer.data_type: bfloat16` trains under the bf16 compute policy (f32
parameters, gradients and optimizer state; `models/blocks.py`),
`trainer.remat` checkpoints each block's activations (MAE's decoder blocks
too), and `trainer.scan_layers` is accepted (`models/vit.py`). MAE draws its
mask noise, and the diffusion loss its steps t and noise e, from the device
generator that dropout draws from; both are seeded from `trainer.seed`. A
diffusion batch holds `x` only, as in the JAX stream. With `use_varemb`
each batch's `variables` give its `var_ids` (`tasks.var_ids_of`).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ucf_vit_tpu_torch import checkpoint as ckpt
from ucf_vit_tpu_torch.config import Config, load_config
from ucf_vit_tpu_torch.inference import Device, resolve_device
from ucf_vit_tpu_torch.parallel.mesh import (
    REFUSED_AXES,
    Mesh,
    init_distributed,
    is_main,
    mesh_context,
    mesh_from_config,
    shard_batch,
)
from ucf_vit_tpu_torch.parallel.train_step import (
    create_train_state,
    make_train_step,
    shard_model,
)
from ucf_vit_tpu_torch.tasks import build_task, example_variables, task_loss, var_ids_of
from ucf_vit_tpu_torch.utils.optim import configure_optimizer

# parallelism axes that are not ported yet -> the ROADMAP.md item that ports them
# the steps `trainer.profile_dir` traces: from after step PROFILE_STEPS[0] to
# after step PROFILE_STEPS[1] (`ucf_vit_tpu/train.py:853-879`)
PROFILE_STEPS = (10, 15)


def synthetic_batches(cfg: Config, global_batch: int, seed: int = 0) -> Iterator[dict]:
    """Shape-correct random batches (port of `ucf_vit_tpu/train.py:47`). The
    same numpy stream as the JAX package's, draw for draw; samples are drawn
    one at a time and stacked, so the stream does not depend on the batch
    size."""
    rng = np.random.default_rng(seed)
    nd = 2 if cfg.twoD else 3
    tile = tuple(cfg.tile_size[:nd])
    c = cfg.max_channels
    num_classes = int(
        cfg.init_args.get("num_classes", cfg.data.get("num_classes", 1000) or 1000)
    )
    p = cfg.patch_size

    def one_sample() -> dict:
        s = {"x": rng.normal(size=(c,) + tile).astype(np.float32)}
        if cfg.adaptive_patching:
            L = cfg.fixed_length
            s["seq"] = rng.normal(size=(c, L, p**nd)).astype(np.float32)
            s["seq_size"] = np.full((c, L), 2.0, np.float32)
            s["seq_pos"] = rng.uniform(0, tile[0], size=(c, L, nd)).astype(np.float32)
            if cfg.task in ("unetr", "sap"):
                s["seq_label"] = rng.integers(
                    0, num_classes, size=(L,) + (p,) * nd
                ).astype(np.int64)
        if cfg.task == "classification":
            s["label"] = rng.integers(0, num_classes, size=())
        elif cfg.task == "unetr":
            s["label"] = rng.integers(0, num_classes, size=(1,) + tile).astype(np.int64)
        return s

    variables = example_variables(cfg)
    while True:
        samples = [one_sample() for _ in range(global_batch)]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        batch["variables"] = variables
        yield batch


def example_batch(cfg: Config, global_batch: int) -> dict:
    return next(synthetic_batches(cfg, global_batch))


class _CatsDogsModule:
    """The catsdogs map-style loader behind the DataModule's interface: an
    epoch ends when the shuffled index list, a pure function of the epoch,
    does; `loop=True` chains the next epochs' lists after it (the trainer's
    mode, and the persistent validation iterator's). `skip_batches=N` starts
    at batch N of the epoch without decoding the skipped files (mid-epoch
    resume)."""

    def __init__(self, ds, batch: int, shard_rank: int = 0, num_shards: int = 1):
        self.ds, self.batch = ds, batch
        self.shard = dict(shard_rank=shard_rank, num_shards=num_shards)
        self._epoch = 0

    def train_dataloader(self, loop: bool = False, skip_batches: int = 0):
        from ucf_vit_tpu_torch.data.catsdogs import catsdogs_loader

        if not loop:
            return catsdogs_loader(self.ds, self.batch, seed=self._epoch,
                                   skip_batches=skip_batches, **self.shard)

        def chain():
            seed, skip = self._epoch, skip_batches
            while True:
                yield from catsdogs_loader(self.ds, self.batch, seed=seed,
                                           skip_batches=skip, **self.shard)
                seed, skip = seed + 1, 0

        return chain()

    def reset(self):
        self._epoch += 1

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)


def _sliced(stream: Iterator[dict], mesh: Optional[Mesh]) -> Iterator[dict]:
    for batch in stream:
        yield shard_batch(batch, mesh)


def build_dataloader(cfg: Config, global_batch: int, synthetic: bool, val_split: bool = False,
                     return_qdt: bool = False, mesh: Optional[Mesh] = None):
    """`(datamodule, synthetic_iter, batches_per_rank_epoch)` (port of
    `ucf_vit_tpu/train.py:95-294`): this data rank's part of the global batch
    (`mesh`; None: the whole of it). The catsdogs
    folder goes through its map-style loader; every other dataset through
    the `DataModule`, with `load_balancing.auto_load_balancing` computing
    `batches_per_rank_epoch` and the group list from the files, and with
    adaptive patching `data.num_workers` (N > 1: a spawn pool of N - 1
    processes patchifies).
    Adaptive catsdogs draws its augmentation from one generator seeded by
    `trainer.seed` (the JAX loader's is unseeded).

    `return_qdt`: adaptive batches also carry their trees (`qdt`), to write
    a prediction back to image space. `val_split`: the held-out validation
    loader instead. From files it reads
    the range `data.val_dict_start_idx` / `val_dict_end_idx` (say train 0.0-0.9,
    validate 0.9-1.0); the synthetic stream comes from another seed."""
    data_rank, data_size = (0, 1) if mesh is None else (mesh.data_rank, mesh.data_size)
    local_batch = global_batch // data_size
    if synthetic:
        stream = synthetic_batches(cfg, global_batch, seed=12345 if val_split else 0)
        return None, (stream if mesh is None else _sliced(stream, mesh)), None

    if val_split:
        if "val_dict_start_idx" not in cfg.data or "val_dict_end_idx" not in cfg.data:
            raise AssertionError("trainer.val_every needs data.val_dict_start_idx / "
                                 "val_dict_end_idx (held-out file-range fractions)")
        cfg = Config(raw={**cfg.raw, "data": {**cfg.data,
                                              "dict_start_idx": cfg.data["val_dict_start_idx"],
                                              "dict_end_idx": cfg.data["val_dict_end_idx"]}},
                     task=cfg.task)

    if cfg.dataset == "catsdogs":
        from ucf_vit_tpu_torch.data.catsdogs import CatsDogsDataset, list_file_split

        key = list(cfg.data["dict_root_dirs"])[0]
        s = float(cfg.data.get("dict_start_idx", {}).get(key, 0.0))
        e = float(cfg.data.get("dict_end_idx", {}).get(key, 1.0))
        files = list_file_split(cfg.data["dict_root_dirs"][key], s, e)
        if not files:
            raise FileNotFoundError(
                f"catsdogs file range [{s}, {e}) of {cfg.data['dict_root_dirs'][key]} is empty")
        if len(files) < global_batch:  # a looping loader would wait for a batch forever
            raise ValueError(f"catsdogs file range [{s}, {e}) holds {len(files)} files, "
                             f"fewer than a batch of {global_batch}")
        nd = 2 if cfg.twoD else 3
        ds = CatsDogsDataset(files, cfg.data["dict_in_variables"][key],
                             tuple(cfg.tile_size[:nd]), adaptive_patching=cfg.adaptive_patching,
                             fixed_length=cfg.fixed_length or 196, patch_size=cfg.patch_size,
                             num_channels=len(cfg.data["dict_in_variables"][key]),
                             rng=np.random.default_rng(int(cfg.trainer.get("seed", 0))))
        return (_CatsDogsModule(ds, local_batch, data_rank, data_size), None,
                {"catsdogs": len(ds) // global_batch})

    from ucf_vit_tpu_torch.data.datamodule import DataModule

    lb = cfg.load_balancing
    bpre = lb.get("batches_per_rank_epoch")
    group_list = lb.get("dataset_group_list", "")
    if lb.get("auto_load_balancing", False):
        from ucf_vit_tpu_torch.data.load_balance import calculate_load_balancing_from_config

        bpre, group_list = calculate_load_balancing_from_config(cfg.raw, cfg.data_par_size)

    ts = cfg.tile_size + [None] * (3 - len(cfg.tile_size))
    dm = DataModule(
        dict_root_dirs=cfg.data["dict_root_dirs"],
        dict_start_idx=cfg.data["dict_start_idx"],
        dict_end_idx=cfg.data["dict_end_idx"],
        dict_buffer_sizes=cfg.data["dict_buffer_sizes"],
        dict_in_variables=cfg.data["dict_in_variables"],
        num_channels_used=cfg.data["num_channels_used"],
        batch_size=local_batch,
        patch_size=cfg.patch_size,
        tile_size_x=ts[0],
        tile_size_y=ts[1],
        tile_size_z=ts[2],
        twoD=cfg.twoD,
        single_channel=cfg.single_channel,
        dataset_group_list=group_list,
        batches_per_rank_epoch=bpre,
        tile_overlap=float(cfg.data.get("tile_overlap", 0.0)),
        use_all_data=bool(cfg.data.get("use_all_data", False)),
        adaptive_patching=cfg.adaptive_patching,
        fixed_length=cfg.fixed_length or 4096,
        separate_channels=bool(cfg.init_args.get("separate_channels", False)),
        data_par_size=cfg.data_par_size,
        dataset=cfg.dataset,
        return_label=cfg.task in ("classification", "unetr", "sap"),
        num_classes=cfg.init_args.get("num_classes", cfg.data.get("num_classes")),
        imagenet_resize=cfg.dataset_options.get("imagenet_resize"),
        num_workers=int(cfg.data.get("num_workers", 1)),
        return_qdt=return_qdt,
        proc_rank=data_rank,
        num_procs=data_size,
    )
    dm.setup()
    return dm, None, bpre


def to_device(batch: dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device` (labels as int64): every key
    but `variables`, `dict_key` and the trees (`qdt`). `x` stays f32 whatever
    the compute dtype: the model casts it at the patch embed."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def check_config(cfg: Config) -> None:
    """Raise on what the config asks for and the port cannot do yet, and on a
    parallelism whose world size is not the launched one."""
    for key, item in REFUSED_AXES.items():
        if int(cfg.parallelism.get(key, 1)) > 1:
            raise NotImplementedError(
                f"parallelism.{key} > 1 is not ported yet (ROADMAP.md, modules to port, "
                f"{item}); pass --single-device")
    launched = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if cfg.world_size != launched:
        raise RuntimeError(
            f"parallelism {cfg.parallelism} asks for {cfg.world_size} processes but "
            f"{launched} {'was' if launched == 1 else 'were'} launched: run it under "
            f"`torchrun --nproc_per_node {cfg.world_size} -m ucf_vit_tpu_torch.train` (or "
            "srun), or pass --single-device")


def setup_mesh(cfg: Config, dev: torch.device) -> Optional[Mesh]:
    """Join the launched job (`init_distributed`), check the config against it
    and build its mesh; None for a config of one process."""
    if cfg.world_size > 1:
        init_distributed(dev)
    check_config(cfg)
    return mesh_from_config(cfg.parallelism, dev.type) if cfg.world_size > 1 else None


def init_train(cfg: Config, device: Device = None, init_seed: int = 0):
    """`(state, step)` for training `cfg`: the task's model with weights drawn
    on the CPU from `torch.Generator().manual_seed(init_seed)` (the same on
    every rank; modules know their shapes, so no example batch is traced,
    where the JAX package inits from one: a diffusion model's at `t = 0`),
    sharded on the config's mesh when it asks for more than one process,
    AdamW from the config's `model:` keys (`ucf_vit_tpu/train.py:349-363`),
    and the train step. The model's generators are seeded from
    `trainer.seed`: the device one (dropout, DropPath, MAE's mask, the
    diffusion loss's draws) differently for each data rank, the host one
    (attention-dropout seeds) the same on every rank."""
    dev = resolve_device(device)
    mesh = setup_mesh(cfg, dev)
    trainer, mcfg = cfg.trainer, cfg.model
    model = build_task(cfg)
    model.init_weights(torch.Generator().manual_seed(int(init_seed)))
    model.to(dev)
    shard_model(model, mesh)
    seed = int(trainer.get("seed", 0))
    data_rank = 0 if mesh is None else mesh.data_rank
    model.set_generator(torch.Generator(dev).manual_seed(seed + (data_rank << 32)),
                        torch.Generator().manual_seed(seed))
    optimizer = configure_optimizer(
        model,
        lr=float(mcfg.get("lr", 1e-4)),
        beta_1=float(mcfg.get("beta_1", 0.9)),
        beta_2=float(mcfg.get("beta_2", 0.95)),
        weight_decay=float(mcfg.get("weight_decay", 1e-5)),
        warmup_steps=int(mcfg.get("warmup_steps", 1000)),
        max_steps=int(mcfg.get("max_steps", 20000)),
        warmup_start_lr=float(mcfg.get("warmup_start_lr", 1e-8)),
        eta_min=float(mcfg.get("eta_min", 1e-8)),
        max_grad_norm=(float(mcfg["max_grad_norm"])
                       if mcfg.get("max_grad_norm") is not None else None),
    )
    state = create_train_state(model, optimizer,
                               use_grad_scaler=bool(mcfg.get("use_grad_scaler", False)),
                               ema=_ema_decay(cfg) is not None)
    step = make_train_step(task_loss(cfg), optimizer,
                           accum_steps=int(trainer.get("accum_steps", 1)),
                           ema_decay=_ema_decay(cfg))
    return state, step


def _ema_decay(cfg: Config) -> Optional[float]:
    ema_decay = cfg.trainer.get("ema_decay")
    ema_decay = None if ema_decay is None else float(ema_decay)
    if ema_decay is not None and not 0.0 < ema_decay < 1.0:
        raise ValueError(f"trainer.ema_decay must be in (0, 1), got {ema_decay}")
    return ema_decay


def _warm_start(cfg: Config, state) -> None:
    """`trainer.init_params_from`: the parameters alone (a fresh optimizer
    and schedule), every name and shape checked (`ucf_vit_tpu/train.py:473-503`)."""
    trainer = cfg.trainer
    payload = ckpt.restore_checkpoint(
        trainer["init_params_from"], trainer.get("init_params_filename", "converted_latest"),
        expect_head_meta=ckpt.head_meta_from_config(cfg))
    ckpt.load_params(state.model, payload["model_state_dict"], "init_params_from")
    if state.ema_params is not None:
        state.ema_params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    if is_main(state.mesh):
        print(f"initialized params from {trainer['init_params_from']}", flush=True)


def transfer_pretrained_mae(cfg: Config, model: torch.nn.Module, path: str,
                            filename: str = "") -> None:
    """Start `model`'s encoder from the MAE checkpoint at `path`
    (`checkpoint.transfer_mae_encoder`), in place; the encoders' head counts
    must agree (`ucf_vit_tpu/train.py:441-472`)."""
    payload = ckpt.restore_checkpoint(
        path, filename, expect_head_meta=(ckpt.head_meta_from_config(cfg)[0], None))
    new = ckpt.transfer_mae_encoder(payload["model_state_dict"], ckpt.full_state_dict(model),
                                    new_pos_embed_len=model.num_patches)
    ckpt.load_params(model, new, "pretrained_mae_checkpoint")
    if is_main(getattr(model, "mesh", None)):
        print("initialized encoder from MAE checkpoint", flush=True)


def _resume(cfg: Config, state) -> Tuple[int, list, int, int]:
    """`trainer.resume_from_checkpoint`: the state in place; returns (first
    epoch to run, loss list, total steps, batches of that epoch to skip).
    A checkpoint saved mid-epoch (`data_it` > 0) re-enters its epoch there
    when this run has as many data ranks as the one that wrote it (each data
    rank reads its own share of the files), and re-runs the epoch from its
    start otherwise (`ucf_vit_tpu/train.py:568-584`, where the share follows
    the process count); one saved at an epoch's end starts the next."""
    trainer = cfg.trainer
    t0 = time.perf_counter()
    payload = ckpt.restore_checkpoint(trainer["checkpoint_path"],
                                      trainer["checkpoint_filename_for_loading"],
                                      expect_head_meta=ckpt.head_meta_from_config(cfg))
    ckpt.restore_train_state(state, payload, _ema_decay(cfg))
    epoch, total_steps = int(payload["epoch"]), int(payload["total_steps"])
    loss_list = [float(v) for v in payload["loss_list"]]
    data_it, saved = int(payload.get("data_it", 0)), ckpt.saved_data_size(payload)
    data_size = ckpt.data_layout(state.mesh)[1]
    read = f"checkpoint read in {time.perf_counter() - t0:.3f} s"
    say = print if is_main(state.mesh) else (lambda *a, **k: None)
    if data_it > 0 and saved != data_size:
        # the position counts batches of other data ranks' file shares (the data
        # follows the data layout, not the world size): re-run the epoch
        say(f"mid-epoch checkpoint was written by {saved or 'an unrecorded number of'} data "
            f"ranks but this run has {data_size}; re-running epoch {epoch} from its start "
            f"({read})", flush=True)
        return epoch, loss_list, total_steps, 0
    if data_it > 0:
        say(f"resumed mid-epoch: epoch {epoch}, fast-forwarding {data_it} batches "
            f"(step {total_steps}; {read})", flush=True)
        return epoch, loss_list, total_steps, data_it
    say(f"resumed from epoch {epoch} ({read})", flush=True)
    return epoch + 1, loss_list, total_steps, 0


def _open_metrics(path: str, resume_epoch: int, resume_step: int, resume_it: int,
                  num_procs: int = 1):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    f = open(path, "a")
    # run-start marker, one per process launch (as the JAX trainer writes it)
    f.write(json.dumps({"run_start": True, "ts": time.time(), "resume_epoch": resume_epoch,
                        "resume_step": resume_step, "resume_it": resume_it,
                        "num_procs": num_procs}) + "\n")
    f.flush()
    return f


def _tensorboard(logdir: str):
    """A `SummaryWriter` on `logdir` from tensorboardX, else from
    `torch.utils.tensorboard`; None, with the reason printed, when neither
    opens. A host-side logger beside the JSONL, which stays the record."""
    errors = []
    for mod in ("tensorboardX", "torch.utils.tensorboard"):
        try:
            return importlib.import_module(mod).SummaryWriter(logdir)
        except Exception as e:  # keep the real error: an unwritable dir is no missing package
            errors.append(f"{mod}: {type(e).__name__}: {e}")
    print("tensorboard_dir ignored (" + "; ".join(errors) + ") — `pip install tensorboardX` "
          "enables scalar logging if the module is what's missing (per-step JSONL metrics "
          "are still written)", flush=True)
    return None


class _Profile:
    """`trainer.profile_dir`: a `torch.profiler` trace (CPU activity, and
    CUDA activity on a CUDA device) of the steps after step PROFILE_STEPS[0]
    up to PROFILE_STEPS[1], written to `profile_dir` as a Chrome trace file."""

    def __init__(self, profile_dir: str, dev: torch.device):
        self.dir, self.dev, self.prof = profile_dir, dev, None

    def before_step(self, total_steps: int) -> None:
        if total_steps == PROFILE_STEPS[0] and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def after_step(self, total_steps: int) -> None:
        if total_steps == PROFILE_STEPS[1]:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)  # the traced steps' kernels, all of them
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"trace_{int(time.time())}_{os.getpid()}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        print(f"profile of steps {PROFILE_STEPS[0] + 1}-{PROFILE_STEPS[1]} written to {path}",
              flush=True)


class _Validation:
    """`trainer.val_every`: the task loss with no gradient, in eval mode
    (dropout and DropPath off; MAE's mask and the diffusion loss's t and e
    are the objective and are drawn), over `trainer.val_batches` batches of
    the held-out split (`ucf_vit_tpu/train.py:617-671`). One looping iterator
    serves every pass, so successive passes walk the whole split; like the
    JAX loop, a pass takes one batch more than it uses. A pass draws from
    generators of its own, seeded from `seed`, so the trainer's stay where
    the step left them. Under a mesh each data rank takes its part of every
    batch and the pass returns the means over the data ranks."""

    def __init__(self, cfg: Config, global_batch: int, synthetic: bool, dev: torch.device,
                 mesh: Optional[Mesh] = None):
        self.dm, self.synth, _ = build_dataloader(cfg, global_batch, synthetic, val_split=True,
                                                  mesh=mesh)
        self.batches = int(cfg.trainer.get("val_batches", 8))
        self.loss_fn, self.dev, self.cfg, self.mesh = task_loss(cfg), dev, cfg, mesh
        self.it = None

    def run(self, model: torch.nn.Module, seed: int) -> Tuple[float, Dict[str, float], int]:
        if self.it is None:
            self.it = (self.synth if self.synth is not None
                       else self.dm.train_dataloader(loop=True))
        gens = (model.generator, model.host_generator)
        model.set_generator(torch.Generator(self.dev).manual_seed(seed),
                            torch.Generator().manual_seed(seed))
        model.eval()
        total, aux_tot, n = 0.0, {}, 0
        try:
            with torch.no_grad(), mesh_context(self.mesh):
                for batch in self.it:
                    if n >= self.batches:
                        break
                    var_ids = var_ids_of(self.cfg, model, batch.get("variables"))
                    loss, aux = self.loss_fn(model, to_device(batch, self.dev), var_ids=var_ids)
                    total += loss.item()
                    for k, v in (aux or {}).items():
                        aux_tot[k] = aux_tot.get(k, 0.0) + float(v)
                    n += 1
        finally:
            model.set_generator(*gens)
            model.train()
        if self.mesh is not None and self.mesh.data_size > 1:
            keys = sorted(aux_tot)
            v = torch.tensor([total] + [aux_tot[k] for k in keys], dtype=torch.float64,
                             device=self.dev)
            dist.all_reduce(v, group=self.mesh.data_group)
            v = (v / self.mesh.data_size).tolist()
            total, aux_tot = v[0], dict(zip(keys, v[1:]))
        return total / max(n, 1), {k: v / max(n, 1) for k, v in aux_tot.items()}, n

    def close(self) -> None:
        if self.it is not None and self.it is not self.synth:
            self.it.close()  # stops the loader's prefetch thread


def train(
    cfg: Config,
    max_steps: Optional[int] = None,
    synthetic: bool = False,
    log_every: int = 1,
    device: Device = None,
) -> Dict:
    """Train `cfg` for `max_epochs` epochs or `max_steps` steps; returns
    `{"state": TrainState, "loss_list": per-epoch mean losses}`. A preempted
    run (SIGTERM, or `trainer.preempt_after_steps`) returns the same, after
    its checkpoint."""
    dev = resolve_device(device)
    trainer = cfg.trainer
    # SIGTERM (a preemptible machine's notice) raises a flag that the loop reads
    # at the next step boundary: a checkpoint of the interrupted epoch, then return
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True

    prev_handler = None
    try:
        prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:
        pass  # not the main thread: no handler; the drill below still works
    preempt_drill = int(trainer.get("preempt_after_steps", 0))
    # under a mesh the ranks agree on the flag every N steps and at each epoch's
    # end (`ucf_vit_tpu/train.py:396-416`): one rank's signal stops them all at
    # the same step, and they save together
    preempt_sync_every = max(1, int(trainer.get("preempt_sync_every", 25)))
    sync_check_every = int(trainer.get("sync_check_every", 0))
    val_every = int(trainer.get("val_every", 0))
    metrics_file = tb_writer = validation = profile = None
    try:
        state, step = init_train(cfg, dev)
        mesh = state.mesh
        main = is_main(mesh)
        say = print if main else (lambda *a, **k: None)

        def agree_preempt() -> bool:
            """Whether any rank has been signalled. The local flag is only read:
            a signal handled while the all-reduce waits stays for the next."""
            flag = torch.tensor([float(preempted["flag"])], device=dev)
            dist.all_reduce(flag)
            return bool(flag.item() > 0)

        def preempt_now(step_idx: int) -> bool:
            if mesh is None:
                return preempted["flag"]
            return step_idx % preempt_sync_every == 0 and agree_preempt()

        head_meta = ckpt.head_meta_from_config(cfg)
        epoch_start, loss_list, total_steps, resume_it = 0, [], 0, 0
        if trainer.get("pretrained_mae_checkpoint"):
            # its slot: a key of its own, then the reference's spelling, then the newest
            # (not checkpoint_filename_for_loading, which names a slot of this run)
            transfer_pretrained_mae(
                cfg, state.model, trainer["pretrained_mae_checkpoint"],
                trainer.get("pretrained_mae_filename", trainer.get("mae_checkpoint_filename", "")))
            if state.ema_params is not None:
                state.ema_params = {n: p.detach().clone()
                                    for n, p in state.model.named_parameters()}
        if trainer.get("init_params_from"):
            _warm_start(cfg, state)
        if trainer.get("resume_from_checkpoint", False):
            epoch_start, loss_list, total_steps, resume_it = _resume(cfg, state)

        global_batch = cfg.batch_size * cfg.data_par_size
        if val_every > 0:
            validation = _Validation(cfg, global_batch, synthetic, dev, mesh)
        dm, synth, bpre = build_dataloader(cfg, global_batch, synthetic, mesh=mesh)
        max_epochs = int(trainer.get("max_epochs", 1))
        if bpre is None:
            bpre = cfg.load_balancing.get("batches_per_rank_epoch") or {}
        # every dataset steps for the longest one; the smaller ones refill
        if bpre:
            iterations_per_epoch = max(bpre.values())
        elif max_steps is not None:
            iterations_per_epoch = max_steps
        else:
            iterations_per_epoch = 100
            say("WARNING: no batches_per_rank_epoch (load_balancing) and no --max-steps; "
                  "capping each epoch at 100 iterations.", flush=True)

        if trainer.get("metrics_path") and main:
            metrics_file = _open_metrics(trainer["metrics_path"], epoch_start, total_steps,
                                         resume_it, 1 if mesh is None else mesh.world)
        if trainer.get("tensorboard_dir") and main:
            tb_writer = _tensorboard(trainer["tensorboard_dir"])
        if trainer.get("profile_dir") and main:
            profile = _Profile(trainer["profile_dir"], dev)
        # halt after N consecutive non-finite losses (0 = off)
        nan_guard = int(trainer.get("nan_guard", 0))
        epoch_state = {"loss": 0.0, "t_last": 0.0, "nonfinite": 0}

        def write(rec: dict) -> None:
            if metrics_file is not None:
                metrics_file.write(json.dumps(rec) + "\n")
                metrics_file.flush()

        def resolve(pending: Tuple) -> None:
            """Read step n's loss after step n+1 was submitted: `.item()` waits for
            the card, and waiting one step late lets the host queue the next step
            meanwhile (`ucf_vit_tpu/train.py:757-862`)."""
            p_epoch, p_it, p_step, loss, aux = pending
            loss_f = loss.item()
            if nan_guard:
                if not np.isfinite(loss_f):
                    epoch_state["nonfinite"] += 1
                    if epoch_state["nonfinite"] >= nan_guard:
                        raise RuntimeError(
                            f"loss non-finite for {nan_guard} consecutive steps (last: {loss_f} "
                            f"at epoch {p_epoch} it {p_it}) — training diverged"
                        )
                else:
                    epoch_state["nonfinite"] = 0
            now = time.perf_counter()
            dt = now - epoch_state["t_last"]
            epoch_state["t_last"] = now
            epoch_state["loss"] += loss_f
            if p_it % log_every == 0 and main:
                sps = global_batch / dt
                aux_f = {k: float(v) for k, v in (aux or {}).items()}
                print(f"epoch {p_epoch} it {p_it} loss {loss_f:.5f} {dt * 1e3:.1f} ms/it "
                      f"{sps:.1f} samples/s" + "".join(f" {k} {v:.4f}" for k, v in aux_f.items()),
                      flush=True)
                write({"epoch": p_epoch, "it": p_it, "step": p_step, "loss": loss_f,
                       "ms_per_it": dt * 1e3, "samples_per_s": sps, "ts": time.time(), **aux_f})
                if tb_writer is not None:
                    tb_writer.add_scalar("train/loss", loss_f, p_step)
                    tb_writer.add_scalar("train/ms_per_it", dt * 1e3, p_step)
                    tb_writer.add_scalar("train/samples_per_s", sps, p_step)
                    for k, v in aux_f.items():
                        tb_writer.add_scalar(f"train/{k}", v, p_step)

        for epoch in range(epoch_start, max_epochs):
            # pin the shuffle epoch, so that a resumed run reads epoch E's stream
            if dm is not None:
                dm.set_epoch(epoch)
            epoch_skip, resume_it = resume_it, 0  # only the re-entered epoch skips
            it = (synth if synth is not None
                  else dm.train_dataloader(loop=True, skip_batches=epoch_skip))
            count, t_epoch = epoch_skip, time.perf_counter()
            epoch_state["loss"] = 0.0
            epoch_state["t_last"] = t_epoch
            pending = None
            for batch in it:
                if count >= iterations_per_epoch:
                    break
                if max_steps is not None and total_steps >= max_steps:
                    break
                if preempt_now(total_steps):
                    break
                if profile is not None:
                    profile.before_step(total_steps)
                # each batch's own variables: single-channel batches that alternate
                # variables each take their variable's embed (the JAX trainer keys a
                # step by them, `ucf_vit_tpu/train.py:598-636`)
                state, loss, aux = step(state, to_device(batch, dev),
                                        var_ids_of(cfg, state.model, batch.get("variables")))
                count += 1
                total_steps += 1
                if preempt_drill and total_steps == preempt_drill:
                    preempted["flag"] = True
                if pending is not None:
                    resolve(pending)  # overlaps with the step just queued
                pending = (epoch, count, total_steps, loss, aux)
                if sync_check_every and mesh is not None and total_steps % sync_check_every == 0:
                    # raises ReplicaDesyncError naming the divergent ranks
                    from ucf_vit_tpu_torch.parallel.sync_check import check_replica_consistency

                    report = check_replica_consistency(state.model, mesh)
                    write({"sync_check": report.describe(), "step": total_steps})
                if profile is not None:
                    profile.after_step(total_steps)
            if it is not synth:
                it.close()  # stops the loader's prefetch thread
            if pending is not None:
                resolve(pending)
            epoch_mean = epoch_state["loss"] / max(count - epoch_skip, 1)
            # a signal since the last agreement stops every rank here
            if preempted["flag"] if mesh is None else agree_preempt():
                # the flag on an epoch's last step: the epoch is complete, so it
                # is saved as one (data_it 0), and resume starts the next
                epoch_done = count >= iterations_per_epoch
                if epoch_done:
                    loss_list.append(epoch_mean)
                if trainer.get("checkpoint_path"):
                    # no step of the epoch ran (the signal came first): the state is
                    # the previous epoch's end, and resume starts this epoch whole
                    saved = epoch if epoch_done or count else epoch - 1
                    path = ckpt.save_checkpoint(
                        trainer["checkpoint_path"], trainer.get("checkpoint_filename", "last"),
                        saved, state, loss_list, head_meta=head_meta, total_steps=total_steps,
                        data_it=0 if epoch_done else count, slot_epoch=epoch)
                    say(f"preempted in epoch {epoch} after {count} its: saved {path}",
                        flush=True)
                else:
                    say(f"preempted in epoch {epoch} after {count} its: no "
                        "trainer.checkpoint_path, nothing saved", flush=True)
                break
            loss_list.append(epoch_mean)
            say(f"epoch {epoch} done: mean loss {loss_list[-1]:.5f} ({count - epoch_skip} its"
                + (f" after {epoch_skip} skipped" if epoch_skip else "")
                + f", {time.perf_counter() - t_epoch:.1f}s)", flush=True)
            # fork validation's seed before the save, so that the saved host
            # generator is the post-validation one: a resumed run continues draw
            # for draw (`ucf_vit_tpu/train.py:930-936`)
            val_seed = None
            if validation is not None and (epoch + 1) % val_every == 0:
                val_seed = int(torch.randint(0, 2**62, (1,),
                                             generator=state.model.host_generator))
            if trainer.get("checkpoint_path"):
                t0 = time.perf_counter()
                path = ckpt.save_checkpoint(
                    trainer["checkpoint_path"], trainer.get("checkpoint_filename", "last"),
                    epoch, state, loss_list, head_meta=head_meta, total_steps=total_steps)
                say(f"epoch {epoch}: saved {path} in {time.perf_counter() - t0:.3f} s",
                    flush=True)
            if val_seed is not None:
                t0 = time.perf_counter()
                vloss, vaux, vn = validation.run(state.model, val_seed)
                say(f"epoch {epoch} val loss {vloss:.5f} ({vn} batches in "
                      f"{time.perf_counter() - t0:.3f} s)"
                      + "".join(f" val_{k} {v:.4f}" for k, v in vaux.items()), flush=True)
                write({"epoch": epoch, "val_loss": vloss, "val_batches": vn,
                       **{f"val_{k}": v for k, v in vaux.items()}})
                if tb_writer is not None:
                    tb_writer.add_scalar("val/loss", vloss, total_steps)
                    for k, v in vaux.items():
                        tb_writer.add_scalar(f"val/{k}", v, total_steps)
            if dm is not None:
                dm.reset()
            if max_steps is not None and total_steps >= max_steps:
                break
    finally:
        if profile is not None:
            profile.stop()
        if validation is not None:
            validation.close()
        if tb_writer is not None:
            tb_writer.close()
        if metrics_file is not None:
            metrics_file.close()
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    return {"state": state, "loss_list": loss_list}


def main(argv=None) -> Dict:
    """The CLI; returns what `train` returns."""
    parser = argparse.ArgumentParser(description="ucf_vit_tpu_torch trainer")
    parser.add_argument("config")
    parser.add_argument("launcher", nargs="?", default=None,
                        help="ignored (reference CLI compatibility: MPI|SLURM)")
    parser.add_argument("--task", default=None)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="random data (no dataset on disk needed)")
    parser.add_argument("--log-every", type=int, default=1)
    parser.add_argument("--single-device", action="store_true",
                        help="override parallelism to 1:1:1:1 (train on one device)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, task=args.task)
    if args.single_device:
        cfg.raw["parallelism"] = {"fsdp_size": 1, "simple_ddp_size": 1,
                                  "tensor_par_size": 1, "seq_par_size": 1}
    return train(cfg, max_steps=args.max_steps, synthetic=args.synthetic,
                 log_every=args.log_every, device=args.device)


if __name__ == "__main__":
    main()
