"""Trainer (port of `ucf_vit_tpu/train.py`, on one device):

    python -m ucf_vit_tpu_torch.train <config.yaml> [--synthetic]
        [--max-steps N] [--log-every K] [--single-device] [--device cuda|cpu]

Seeded model init (the names `load_jax_params` fills) of the config's task
(classification, MAE or diffusion), AdamW from the config's `model:` keys, and one
train step per batch: from the files the config's `data:` section names
(`build_dataloader`: the catsdogs folder through its map-style loader,
every other dataset through the `DataModule` with `auto_load_balancing`),
or with `--synthetic` from the JAX package's `synthetic_batches` stream,
draw for draw. Epochs as the JAX trainer counts them (`max_epochs`;
`iterations_per_epoch` the largest of `batches_per_rank_epoch`; the data's
shuffle epoch pinned before each epoch), the one-step-lagged loss read, the
log line, the `trainer.metrics_path` JSONL records and `trainer.nan_guard`.
Runs on CUDA unless `device="cpu"`.

Checkpoints (`checkpoint.py`): with `trainer.checkpoint_path` set, the full
training state is saved at each epoch's end to the even/odd slot of the
epoch; `trainer.resume_from_checkpoint` continues from the slot that
`checkpoint_filename_for_loading` names at the next epoch (parameters,
AdamW, loss scale, loss list, step count and the generators' states, EMA
reconciled with `trainer.ema_decay`); `trainer.init_params_from` warm-starts
the parameters alone from any port checkpoint or a file that the JAX
package's `convert_checkpoint to-torch` wrote.

Not ported yet, and refused with the ROADMAP.md item when the config asks
for it (`_REFUSED_KEYS`): the MAE-encoder transfer, validation, preemption,
TensorBoard, `profile_dir` and sharding. `trainer.data_type: bfloat16`
trains under the bf16 compute policy (f32 parameters, gradients and
optimizer state; `models/blocks.py`), `trainer.remat` checkpoints each
block's activations (MAE's decoder blocks too), and `trainer.scan_layers` is
accepted (`models/vit.py`). MAE draws its mask noise, and the diffusion
loss its steps t and noise e, from the device generator that dropout draws
from; both are seeded from `trainer.seed`. A diffusion batch holds `x` only,
as in the JAX stream.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ucf_vit_tpu_torch import checkpoint as ckpt
from ucf_vit_tpu_torch.config import Config, load_config
from ucf_vit_tpu_torch.inference import Device, resolve_device
from ucf_vit_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ucf_vit_tpu_torch.tasks import build_task, task_loss
from ucf_vit_tpu_torch.utils.optim import configure_optimizer

# trainer keys whose feature is not ported yet -> the ROADMAP.md item that ports it
_REFUSED_KEYS = {
    "pretrained_mae_checkpoint": "item 7: UNETR + evaluation",
    "val_every": "item 9: trainer parity",
    "tensorboard_dir": "item 9: trainer parity",
    "preempt_after_steps": "item 9: trainer parity",
    "profile_dir": "item 9: trainer parity",
    "sync_check_every": "item 10: data/tensor parallel",
}


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

    variables = tuple(cfg.default_vars[:c] or ("v",))
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
    does; `loop=True` chains the next epochs' lists after it."""

    def __init__(self, ds, global_batch: int):
        self.ds, self.global_batch = ds, global_batch
        self._epoch = 0

    def train_dataloader(self, loop: bool = False):
        from ucf_vit_tpu_torch.data.catsdogs import catsdogs_loader

        if not loop:
            return catsdogs_loader(self.ds, self.global_batch, seed=self._epoch)

        def chain():
            seed = self._epoch
            while True:
                yield from catsdogs_loader(self.ds, self.global_batch, seed=seed)
                seed += 1

        return chain()

    def reset(self):
        self._epoch += 1

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)


def build_dataloader(cfg: Config, global_batch: int, synthetic: bool):
    """`(datamodule, synthetic_iter, batches_per_rank_epoch)` (port of
    `ucf_vit_tpu/train.py:95-294`, one process: shard 0 of 1). The catsdogs
    folder goes through its map-style loader; every other dataset through
    the `DataModule`, with `load_balancing.auto_load_balancing` computing
    `batches_per_rank_epoch` and the group list from the files."""
    if synthetic:
        return None, synthetic_batches(cfg, global_batch, seed=0), None

    if cfg.dataset == "catsdogs":
        from ucf_vit_tpu_torch.data.catsdogs import CatsDogsDataset, list_file_split

        key = list(cfg.data["dict_root_dirs"])[0]
        s = float(cfg.data.get("dict_start_idx", {}).get(key, 0.0))
        e = float(cfg.data.get("dict_end_idx", {}).get(key, 1.0))
        files = list_file_split(cfg.data["dict_root_dirs"][key], s, e)
        if not files:
            raise FileNotFoundError(
                f"catsdogs file range [{s}, {e}) of {cfg.data['dict_root_dirs'][key]} is empty")
        nd = 2 if cfg.twoD else 3
        ds = CatsDogsDataset(files, cfg.data["dict_in_variables"][key],
                             tuple(cfg.tile_size[:nd]), adaptive_patching=cfg.adaptive_patching)
        return _CatsDogsModule(ds, global_batch), None, {"catsdogs": len(ds) // global_batch}

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
        batch_size=global_batch,
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
        data_par_size=cfg.data_par_size,
        dataset=cfg.dataset,
        return_label=cfg.task in ("classification", "unetr", "sap"),
        num_classes=cfg.init_args.get("num_classes", cfg.data.get("num_classes")),
        imagenet_resize=cfg.dataset_options.get("imagenet_resize"),
    )
    dm.setup()
    return dm, None, bpre


def to_device(batch: dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device` (labels as int64). `x` stays
    f32 whatever the compute dtype: the model casts it at the patch embed."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def check_config(cfg: Config) -> None:
    """Raise on what the config asks for and the port cannot do yet."""
    for key, item in _REFUSED_KEYS.items():
        if cfg.trainer.get(key):
            raise NotImplementedError(
                f"trainer.{key} is not ported yet (ROADMAP.md, modules to port, {item})"
            )
    if cfg.world_size > 1 or cfg.parallelism.get("fsdp_size", 1) > 1:
        raise NotImplementedError(
            f"parallelism {cfg.parallelism} needs sharding, which is not ported yet "
            "(ROADMAP.md, modules to port, item 10: data/tensor parallel); pass "
            "--single-device"
        )


def init_train(cfg: Config, device: Device = None, init_seed: int = 0):
    """`(state, step)` for training `cfg` on one device: the task's model with
    weights drawn on the CPU from `torch.Generator().manual_seed(init_seed)`
    (modules know their shapes, so no example batch is traced, where the JAX
    package inits from one: a diffusion model's at `t = 0`),
    AdamW from the config's `model:` keys (`ucf_vit_tpu/train.py:349-363`),
    and the train step. The model's dropout generators are seeded from
    `trainer.seed`."""
    dev = resolve_device(device)
    check_config(cfg)
    trainer, mcfg = cfg.trainer, cfg.model
    model = build_task(cfg)
    model.init_weights(torch.Generator().manual_seed(int(init_seed)))
    model.to(dev)
    seed = int(trainer.get("seed", 0))
    model.set_generator(torch.Generator(dev).manual_seed(seed),
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
    print(f"initialized params from {trainer['init_params_from']}", flush=True)


def _resume(cfg: Config, state) -> Tuple[int, list, int]:
    """`trainer.resume_from_checkpoint` at epoch granularity: the state in
    place; returns (first epoch to run, loss list, total steps)."""
    trainer = cfg.trainer
    t0 = time.perf_counter()
    payload = ckpt.restore_checkpoint(trainer["checkpoint_path"],
                                      trainer["checkpoint_filename_for_loading"],
                                      expect_head_meta=ckpt.head_meta_from_config(cfg))
    ckpt.restore_train_state(state, payload, _ema_decay(cfg))
    epoch = int(payload["epoch"])
    print(f"resumed from epoch {epoch} (checkpoint read in "
          f"{time.perf_counter() - t0:.3f} s)", flush=True)
    return epoch + 1, [float(v) for v in payload["loss_list"]], int(payload["total_steps"])


def _open_metrics(path: str, resume_epoch: int, resume_step: int):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    f = open(path, "a")
    # run-start marker, one per process launch (as the JAX trainer writes it)
    f.write(json.dumps({"run_start": True, "ts": time.time(), "resume_epoch": resume_epoch,
                        "resume_step": resume_step, "resume_it": 0, "num_procs": 1}) + "\n")
    f.flush()
    return f


def train(
    cfg: Config,
    max_steps: Optional[int] = None,
    synthetic: bool = False,
    log_every: int = 1,
    device: Device = None,
) -> Dict:
    """Train `cfg` for `max_epochs` epochs or `max_steps` steps; returns
    `{"state": TrainState, "loss_list": per-epoch mean losses}`."""
    dev = resolve_device(device)
    trainer = cfg.trainer
    state, step = init_train(cfg, dev)
    head_meta = ckpt.head_meta_from_config(cfg)
    epoch_start, loss_list, total_steps = 0, [], 0
    if trainer.get("init_params_from"):
        _warm_start(cfg, state)
    if trainer.get("resume_from_checkpoint", False):
        epoch_start, loss_list, total_steps = _resume(cfg, state)

    global_batch = cfg.batch_size * cfg.data_par_size
    dm, synth, bpre = build_dataloader(cfg, global_batch, synthetic)
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
        print("WARNING: no batches_per_rank_epoch (load_balancing) and no --max-steps; "
              "capping each epoch at 100 iterations.", flush=True)

    metrics_file = (_open_metrics(trainer["metrics_path"], epoch_start, total_steps)
                    if trainer.get("metrics_path") else None)
    # halt after N consecutive non-finite losses (0 = off)
    nan_guard = int(trainer.get("nan_guard", 0))
    epoch_state = {"loss": 0.0, "t_last": 0.0, "nonfinite": 0}

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
        if p_it % log_every == 0:
            sps = global_batch / dt
            aux_f = {k: float(v) for k, v in (aux or {}).items()}
            print(f"epoch {p_epoch} it {p_it} loss {loss_f:.5f} {dt * 1e3:.1f} ms/it "
                  f"{sps:.1f} samples/s" + "".join(f" {k} {v:.4f}" for k, v in aux_f.items()),
                  flush=True)
            if metrics_file is not None:
                rec = {"epoch": p_epoch, "it": p_it, "step": p_step, "loss": loss_f,
                       "ms_per_it": dt * 1e3, "samples_per_s": sps, "ts": time.time()}
                rec.update(aux_f)
                metrics_file.write(json.dumps(rec) + "\n")
                metrics_file.flush()

    try:
        for epoch in range(epoch_start, max_epochs):
            # pin the shuffle epoch, so that a resumed run reads epoch E's stream
            if dm is not None:
                dm.set_epoch(epoch)
            it = synth if synth is not None else dm.train_dataloader(loop=True)
            count, t_epoch = 0, time.perf_counter()
            epoch_state["loss"] = 0.0
            epoch_state["t_last"] = t_epoch
            pending = None
            for batch in it:
                if count >= iterations_per_epoch:
                    break
                if max_steps is not None and total_steps >= max_steps:
                    break
                state, loss, aux = step(state, to_device(batch, dev))
                count += 1
                total_steps += 1
                if pending is not None:
                    resolve(pending)  # overlaps with the step just queued
                pending = (epoch, count, total_steps, loss, aux)
            if it is not synth:
                it.close()  # stops the loader's prefetch thread
            if pending is not None:
                resolve(pending)
            loss_list.append(epoch_state["loss"] / max(count, 1))
            print(f"epoch {epoch} done: mean loss {loss_list[-1]:.5f} ({count} its, "
                  f"{time.perf_counter() - t_epoch:.1f}s)", flush=True)
            if trainer.get("checkpoint_path"):
                t0 = time.perf_counter()
                path = ckpt.save_checkpoint(
                    trainer["checkpoint_path"], trainer.get("checkpoint_filename", "last"),
                    epoch, state, loss_list, head_meta=head_meta, total_steps=total_steps)
                print(f"epoch {epoch}: saved {path} in {time.perf_counter() - t0:.3f} s",
                      flush=True)
            if dm is not None:
                dm.reset()
            if max_steps is not None and total_steps >= max_steps:
                break
    finally:
        if metrics_file is not None:
            metrics_file.close()
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
                        help="override parallelism to 1:1:1:1 (the port runs on one device)")
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
