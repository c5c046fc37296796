"""Trainer (port of `ucf_vit_tpu/train.py`, on one device):

    python -m ucf_vit_tpu_torch.train <config.yaml> --synthetic [--max-steps N]
        [--log-every K] [--device cuda|cpu]

Seeded model init (the names `load_jax_params` fills) of the config's task
(classification or MAE), AdamW from the config's `model:` keys, one train
step per synthetic batch (the JAX package's `synthetic_batches` stream,
draw for draw), the one-step-lagged loss read, the log line, the
`trainer.metrics_path` JSONL records and `trainer.nan_guard`. Runs on CUDA
unless `device="cpu"`.

Not ported yet, and refused with the ROADMAP.md item when the config asks
for it: the real data pipeline (run with `--synthetic`), checkpoints
(`trainer.checkpoint_path` is set by the shipped configs, so it is noted and
no checkpoint is written; resume and warm starts raise), validation,
preemption, TensorBoard, `profile_dir` and sharding. `trainer.data_type:
bfloat16` trains under the bf16 compute policy (f32 parameters, gradients
and optimizer state; `models/blocks.py`), `trainer.remat` checkpoints each
block's activations (MAE's decoder blocks too), and `trainer.scan_layers` is
accepted (`models/vit.py`). MAE draws its mask noise from the device
generator that dropout draws from; both are seeded from `trainer.seed`.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ucf_vit_tpu_torch.config import Config, load_config
from ucf_vit_tpu_torch.inference import Device, resolve_device
from ucf_vit_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ucf_vit_tpu_torch.tasks import build_task, task_loss
from ucf_vit_tpu_torch.utils.optim import configure_optimizer

# trainer keys whose feature is not ported yet -> the ROADMAP.md item that ports it
_REFUSED_KEYS = {
    "resume_from_checkpoint": "checkpoints",
    "pretrained_mae_checkpoint": "checkpoints",
    "init_params_from": "checkpoints",
    "val_every": "trainer parity",
    "tensorboard_dir": "trainer parity",
    "preempt_after_steps": "trainer parity",
    "profile_dir": "trainer parity",
    "sync_check_every": "data/tensor parallel",
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
                f"trainer.{key} is not ported yet (ROADMAP.md, modules to port: {item})"
            )
    if cfg.world_size > 1 or cfg.parallelism.get("fsdp_size", 1) > 1:
        raise NotImplementedError(
            f"parallelism {cfg.parallelism} needs sharding, which is not ported yet "
            "(ROADMAP.md, modules to port: data/tensor parallel); pass --single-device"
        )


def init_train(cfg: Config, device: Device = None, init_seed: int = 0):
    """`(state, step)` for training `cfg` on one device: the task's model with
    weights drawn on the CPU from `torch.Generator().manual_seed(init_seed)`,
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
    ema_decay = trainer.get("ema_decay")
    ema_decay = None if ema_decay is None else float(ema_decay)
    if ema_decay is not None and not 0.0 < ema_decay < 1.0:
        raise ValueError(f"trainer.ema_decay must be in (0, 1), got {ema_decay}")
    state = create_train_state(model, optimizer,
                               use_grad_scaler=bool(mcfg.get("use_grad_scaler", False)),
                               ema=ema_decay is not None)
    step = make_train_step(task_loss(cfg), optimizer,
                           accum_steps=int(trainer.get("accum_steps", 1)), ema_decay=ema_decay)
    return state, step


def _open_metrics(path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    f = open(path, "a")
    # run-start marker, one per process launch (as the JAX trainer writes it)
    f.write(json.dumps({"run_start": True, "ts": time.time(), "resume_epoch": 0,
                        "resume_step": 0, "resume_it": 0, "num_procs": 1}) + "\n")
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
    if not synthetic:
        raise NotImplementedError(
            "the data pipeline is not ported yet (ROADMAP.md, modules to port: data "
            "pipeline); run with --synthetic"
        )
    trainer = cfg.trainer
    if trainer.get("checkpoint_path"):
        print(f"trainer.checkpoint_path {trainer['checkpoint_path']!r}: checkpoints are not "
              "ported yet (ROADMAP.md, modules to port: checkpoints); none is written",
              flush=True)
    state, step = init_train(cfg, dev)
    global_batch = cfg.batch_size * cfg.data_par_size
    batches = synthetic_batches(cfg, global_batch, seed=0)

    max_epochs = int(trainer.get("max_epochs", 1))
    bpre = cfg.load_balancing.get("batches_per_rank_epoch") or {}
    if bpre:
        iterations_per_epoch = max(bpre.values())
    elif max_steps is not None:
        iterations_per_epoch = max_steps
    else:
        iterations_per_epoch = 100
        print("WARNING: no batches_per_rank_epoch (load_balancing) and no --max-steps; "
              "capping each epoch at 100 iterations.", flush=True)

    metrics_file = _open_metrics(trainer["metrics_path"]) if trainer.get("metrics_path") else None
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

    loss_list = []
    total_steps = 0
    try:
        for epoch in range(max_epochs):
            count, t_epoch = 0, time.perf_counter()
            epoch_state["loss"] = 0.0
            epoch_state["t_last"] = t_epoch
            pending = None
            for batch in batches:
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
            if pending is not None:
                resolve(pending)
            loss_list.append(epoch_state["loss"] / max(count, 1))
            print(f"epoch {epoch} done: mean loss {loss_list[-1]:.5f} ({count} its, "
                  f"{time.perf_counter() - t_epoch:.1f}s)", flush=True)
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
                        help="random data (the data pipeline is not ported yet)")
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
