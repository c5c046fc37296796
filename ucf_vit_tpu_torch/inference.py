"""Evaluation and the inference CLI (port of `ucf_vit_tpu/inference.py`):

    python -m ucf_vit_tpu_torch.inference <config.yaml> [--checkpoint D]
        [--mae-checkpoint D] [--synthetic] [--num-samples N] [--png-dir P]
        [--batch-size B] [--ema] [--device cuda|cpu]
        [--volume vol.npy [--volume-out pred.npy] [--sw-overlap F] [--sw-batch N]]
    torchrun --nproc_per_node N -m ucf_vit_tpu_torch.inference <config.yaml> ...

Device choice, seeded model init and checkpoint weights for evaluation and
serving (the roles of `_init_eval_params`, `ucf_vit_tpu/inference.py:78`, and
of the server's `load_weights`, `ucf_vit_tpu/serve.py:216-237`), an MAE's
reconstruction under a fixed mask, top-1 accuracy of a classifier
(`evaluate_classification`), and DiffusionVIT's images by the DDPM reverse
chain (`generate_diffusion`), with a PNG a sample, a UNETR's or a SAP's
Dice (`evaluate_segmentation`: per batch and the mean, MONAI's DiceMetric
without the background; SAP's in the sqrt-len pseudo-image space against
the reassembled serialized labels; `--mae-checkpoint` starts the encoder
from an MAE's; PNGs of the middle slice, SAP's prediction written back to
image space through the sample's tree), and the sliding-window segmentation
of a whole UNETR volume (`VolumePredictor`, `predict_volume`, the CLI's
`--volume`). The PNG writer imports matplotlib when it is asked for PNGs,
never at import time. `evaluate` sends a config to the evaluation of its
task.

Sharded (`ucf_vit_tpu/inference.py:49-100`): launched by torchrun or srun
with the processes the config's `parallelism:` asks for, evaluation and
generation run on its mesh (`parallel.mesh.eval_mesh`): the weights by
`parallel.train_step.shard_model` (tp by the JAX `kernel_axes`, FSDP by
`fully_shard`), each data rank on its share of the same global batches that
one device reads, top-1 from correct and sample counts summed over the data
ranks, Dice on the gathered predictions, the reverse chain split by rows,
rank 0 alone printing and writing PNGs. Under sequence parallelism the sp
ranks of a data rank run its batch together, each block stack split over
their tokens (`models/vit.py`; not UNETR and SAP). One process evaluates the whole
model on one device, whatever the config asks for. `--volume` runs in one
process, as in the JAX package.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ucf_vit_tpu_torch import checkpoint as ckpt
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.models import MAE, DiffusionVIT, ddpm_sample, ddpm_schedule
from ucf_vit_tpu_torch.ops.patchify import unpatchify
from ucf_vit_tpu_torch.parallel.mesh import (
    Mesh,
    eval_mesh,
    gather_data,
    is_main,
    mesh_context,
)
from ucf_vit_tpu_torch.parallel.train_step import shard_model
from ucf_vit_tpu_torch.tasks import (
    build_task,
    disassemble_sqrt_len,
    model_inputs,
    num_classes,
    sap_inputs,
    sap_labels,
    time_steps,
    unetr_inputs,
    var_ids_of,
)

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device to run on: CUDA unless the caller names another. Raises
    when CUDA is asked for (or left as the default) and none is present;
    nothing falls back to the CPU on its own. On CUDA it pins the port's f32
    policy: TF32 off for cuBLAS's matmuls and cuDNN's convolutions alike
    (cuDNN's flag is on by default), so f32 work keeps 23 mantissa bits as in
    the JAX package. The f32 flash and fused-MLP kernels do their own 3xTF32
    arithmetic, which these flags do not touch."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def init_eval_model(cfg: Config, seed: int = 0, device: Device = None,
                    mesh: Optional[Mesh] = None) -> torch.nn.Module:
    """The task's model with weights drawn on the CPU from
    `torch.Generator().manual_seed(seed)` (so every device gets the same
    weights), moved to `device`, put on `mesh` (`shard_model`; the roles of
    `_init_eval_params`, `ucf_vit_tpu/inference.py:78-100`) and in eval
    mode."""
    dev = resolve_device(device)
    model = build_task(cfg)
    model.init_weights(torch.Generator().manual_seed(int(seed)))
    return shard_model(model.to(dev), mesh).eval()


def _say(mesh: Optional[Mesh], msg: str) -> None:
    if is_main(mesh):
        print(msg, flush=True)


def _on_every_rank(it, mesh: Optional[Mesh], device: torch.device):
    """The batches of `it` while every rank of the mesh still has one: a data
    rank's share of the files may end before another's, and the ranks of a
    sharded model must run the same forwards."""
    if mesh is None:
        yield from it
        return
    for batch in it:
        have = torch.ones(1, device=device)
        dist.all_reduce(have, op=dist.ReduceOp.MIN)
        if not bool(have):
            return
        yield batch
    dist.all_reduce(torch.zeros(1, device=device), op=dist.ReduceOp.MIN)


def _check_split(what: str, n: int, mesh: Optional[Mesh]) -> None:
    if mesh is not None and n % mesh.data_size:
        raise ValueError(f"{what} {n} does not split over the mesh's {mesh.data_size} data "
                         "ranks (ddp x ep x fsdp)")


def checkpoint_weights(model: torch.nn.Module, cfg: Config, ckpt_dir: str,
                       use_ema: bool = False) -> Tuple[dict, int]:
    """(the whole tensors of a checkpoint's parameters, or with `use_ema` of
    its EMA, its epoch), checked against `model`'s names and shapes and the
    config's head grouping first. `ckpt_dir` is a checkpoint file, or a
    directory whose slot `trainer.checkpoint_filename_for_loading` names
    (empty: the newest)."""
    payload = ckpt.restore_checkpoint(
        ckpt_dir, cfg.trainer.get("checkpoint_filename_for_loading", ""),
        expect_head_meta=ckpt.head_meta_from_config(cfg))
    sd = payload["model_state_dict"]
    if use_ema:
        sd = payload.get("ema_state_dict")
        if sd is None:
            raise ValueError("--ema requested but this checkpoint has no EMA state; train "
                             "with trainer.ema_decay set")
    ckpt.check_state_dict(model, sd, f"checkpoint {ckpt_dir}")
    return sd, int(payload["epoch"])


def load_weights(model: torch.nn.Module, cfg: Config, ckpt_dir: str,
                 use_ema: bool = False) -> int:
    """Copy a checkpoint's parameters (or, with `use_ema`, its EMA of them)
    into `model` in place (`checkpoint_weights`); returns the checkpoint's
    epoch. A model on a mesh takes each rank's part of the whole tensors,
    whatever layout wrote them (`checkpoint.load_params`); every rank must
    call."""
    sd, epoch = checkpoint_weights(model, cfg, ckpt_dir, use_ema)
    ckpt.load_params(model, sd, f"checkpoint {ckpt_dir}")
    return epoch


@torch.no_grad()
def reconstruct(model: torch.nn.Module, x: torch.Tensor, seed: int = 0,
                seq_ps: Optional[torch.Tensor] = None, var_ids=None) -> torch.Tensor:
    """An MAE's reconstruction of images `x` `[B, C, *spatial]` in image
    space: the prediction of every token, unpatchified, under the mask that
    noise drawn from `torch.Generator(x.device).manual_seed(seed)` gives, so
    that the same request always gets the same visible-token subset (the
    JAX server's MAE branch, `ucf_vit_tpu/serve.py:277-297`). An adaptive
    MAE takes the sequence `[B, C, L, p^nd]` and its descriptors `seq_ps`
    and returns its predicted tokens `[B, L, p^nd * C]`. Puts the model in
    eval mode."""
    if not isinstance(model, MAE):
        raise TypeError(f"reconstruct takes an MAE, got {type(model).__name__}")
    noise = mask_noise(model, x.shape[0], seed, x.device)
    pred, _ = model.eval()(x, mask_noise=noise, seq_ps=seq_ps, var_ids=var_ids)
    if model.adaptive_patching:
        return pred
    return unpatchify(pred, tuple(x.shape), model.patch_size, model.twoD)


def mask_noise(model: MAE, rows: int, seed: int, device: Device) -> torch.Tensor:
    """The noise `[rows, num_patches]` that fixes an MAE's mask for `seed`:
    `torch.rand` from `torch.Generator(device).manual_seed(seed)`."""
    dev = torch.device(device)
    return torch.rand(rows, model.num_patches, device=dev,
                      generator=torch.Generator(dev).manual_seed(int(seed)))


def diffusion_sampler(cfg: Config, model: torch.nn.Module, num_samples: int
                      ) -> Callable[[int], torch.Tensor]:
    """`generate(seed) -> [num_samples, C, *tile]` f32 images on the model's
    device: the whole DDPM reverse chain of `cfg`'s `num_time_steps`, its
    draws from `torch.Generator(device).manual_seed(seed)`, so one seed
    always gives the same images. `generate.denoise(x_t, t)` is one step's
    noise prediction in image space (at `generate.shape`). Puts the model in
    eval mode.

    A model on a mesh (`shard_model`) runs the chain split by rows over the
    data ranks (`ucf_vit_tpu/inference.py:357-376`): every rank draws each
    step's noise for the whole batch from the one seeded generator and keeps
    its data rank's rows, so the images do not depend on the split; every
    rank returns the whole batch (`gather_data`). `num_samples` must divide
    over the data ranks. Every rank must call."""
    if not isinstance(model, DiffusionVIT):
        raise TypeError(f"the DDPM sampler takes a DiffusionVIT, got {type(model).__name__}")
    model.eval()
    mesh = getattr(model, "mesh", None)
    _check_split("num_samples", int(num_samples), mesh)
    dev = next(model.parameters()).device
    nd = 2 if cfg.twoD else 3
    shape = (int(num_samples), cfg.max_channels) + tuple(cfg.tile_size[:nd])
    rows = None
    if mesh is not None and mesh.data_size > 1:
        n = shape[0] // mesh.data_size
        rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
    local = shape if rows is None else (rows.stop - rows.start,) + shape[1:]
    schedule = ddpm_schedule(time_steps(cfg)).to(dev)
    var_ids = var_ids_of(cfg, model)

    def denoise(x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        with mesh_context(mesh):
            pred = model(x_t, t, var_ids=var_ids)
        return unpatchify(pred, tuple(x_t.shape), model.patch_size, model.twoD)

    @torch.inference_mode()
    def generate(seed: int) -> torch.Tensor:
        gen = torch.Generator(dev).manual_seed(int(seed))
        if rows is None:
            return ddpm_sample(schedule, denoise, gen, shape, dev)
        return gather_data(ddpm_sample(schedule, denoise, gen, shape, dev, rows=rows), mesh)

    generate.denoise = denoise
    generate.shape = local
    return generate


def generate_diffusion(cfg: Config, checkpoint_dir: Optional[str] = None,
                       num_samples: int = 8, png_dir: Optional[str] = None,
                       use_ema: bool = False, return_images: bool = False, *,
                       device: Device = None, seed: int = 0):
    """Images from a DiffusionVIT by ancestral DDPM sampling
    (`ucf_vit_tpu/inference.py:317-391`, the same positional arguments): the
    seeded init (seed 0) or a checkpoint's weights (`checkpoint_dir`; with
    `use_ema` its EMA), then the whole reverse chain at a batch of
    `num_samples`, drawn from `seed`. With `png_dir`, one gray PNG a sample
    (`generated_<i>.png`: its first channel, the middle slice of a volume).
    Returns samples/s, or `(samples/s, images [num_samples, C, *tile])` with
    `return_images`. On the config's mesh (`eval_mesh`) the chain is split by
    rows (`diffusion_sampler`), every rank returns the images and rank 0
    alone writes the PNGs."""
    mesh = eval_mesh(cfg, resolve_device(device))
    if png_dir and is_main(mesh):
        _pyplot()  # a missing matplotlib shows before the chain runs, not after
    model = init_eval_model(cfg, seed=0, device=device, mesh=mesh)
    if checkpoint_dir:
        epoch = load_weights(model, cfg, checkpoint_dir, use_ema=use_ema)
        _say(mesh, f"loaded checkpoint from epoch {epoch}")
    generate = diffusion_sampler(cfg, model, max(int(num_samples), 1))
    t0 = time.perf_counter()
    imgs = generate(seed).cpu().numpy()
    dt = time.perf_counter() - t0
    sps = imgs.shape[0] / dt
    _say(mesh, f"generated {imgs.shape[0]} samples in {dt:.1f}s ({sps:.2f} samples/s, "
         f"{time_steps(cfg)} DDPM steps)")
    if png_dir and is_main(mesh):
        for i, img in enumerate(imgs[:, 0]):  # the first channel
            if img.ndim == 3:  # a volume: its middle slice
                img = img[..., img.shape[-1] // 2]
            _dump_generated_png(png_dir, i, img)
    return (sps, imgs) if return_images else sps


def _dump_generated_png(png_dir: str, idx: int, img: np.ndarray) -> None:
    _save_panels(png_dir, f"generated_{idx}.png", [(None, img)], cmap="gray")


def _pyplot():
    """matplotlib's pyplot on the Agg backend; raises ModuleNotFoundError
    naming matplotlib where it does not import."""
    try:
        import matplotlib
    except ImportError as e:
        raise ModuleNotFoundError(
            "writing PNGs needs matplotlib, which does not import here "
            f"({e}); run without --png-dir", name="matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save_panels(png_dir: str, name: str, panels, cmap=None) -> None:
    """A row of image panels `[(title, 2-D array), ...]` as `<png_dir>/<name>`
    (`ucf_vit_tpu/inference.py:422-449`)."""
    plt = _pyplot()
    os.makedirs(png_dir, exist_ok=True)
    fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 4))
    if len(panels) == 1:
        axes = [axes]
    for ax, (title, img) in zip(axes, panels):
        ax.imshow(img, cmap=cmap, interpolation="nearest")
        if title:
            ax.set_title(title)
        ax.axis("off")
    fig.savefig(os.path.join(png_dir, name), dpi=80)
    plt.close(fig)


def evaluate_classification(cfg: Config, checkpoint_dir: Optional[str] = None,
                            synthetic: bool = False, num_samples: int = 64,
                            use_ema: bool = False, *, device: Device = None) -> float:
    """Top-1 accuracy of the seeded init or a checkpoint's weights (with
    `use_ema` its EMA) over at least `num_samples` samples, in global batches
    of `data.batch_size`: the synthetic stream, or one epoch of the config's
    file range (`ucf_vit_tpu/inference.py:111-172`). On the config's mesh
    each data rank takes its share of every batch, and a batch's accuracy
    comes from its correct and sample counts summed over the data ranks,
    the number one device computes."""
    from ucf_vit_tpu_torch.train import build_dataloader, to_device

    mesh = eval_mesh(cfg, resolve_device(device))
    _check_split("data.batch_size", cfg.batch_size, mesh)
    model = init_eval_model(cfg, seed=0, device=device, mesh=mesh)
    if checkpoint_dir:
        epoch = load_weights(model, cfg, checkpoint_dir, use_ema=use_ema)
        _say(mesh, f"loaded checkpoint from epoch {epoch}")
    dev = next(model.parameters()).device
    var_ids = var_ids_of(cfg, model)
    dm, synth, _ = build_dataloader(cfg, cfg.batch_size, synthetic, mesh=mesh)
    it = synth if synthetic else dm.train_dataloader()
    correct, seen = 0.0, 0
    try:
        with torch.inference_mode(), mesh_context(mesh):
            for batch in _on_every_rank(it, mesh, dev):
                if seen >= num_samples:
                    break
                b = to_device(batch, dev)
                x, ps = model_inputs(cfg, b)
                logits = model(x, seq_ps=ps, var_ids=var_ids)
                counts = torch.stack([(logits.argmax(dim=-1) == b["label"]).sum(),
                                      torch.tensor(logits.shape[0], device=dev)])
                if mesh is not None:
                    dist.all_reduce(counts, group=mesh.data_group)
                n = int(counts[1])
                # the batch's accuracy in f32, as the JAX package's `accuracy` gives it
                correct += float(counts[0].float() / counts[1].float()) * n
                seen += n
    finally:
        it.close()
    top1 = correct / max(seen, 1)
    _say(mesh, f"top-1 accuracy over {seen} samples: {top1:.4f}")
    return top1


def _dump_png(png_dir: str, idx: int, pred: np.ndarray, label: np.ndarray) -> None:
    """Prediction beside label (the middle slice of a volume), as
    `sample_<idx>.png` (`ucf_vit_tpu/inference.py:409-419`)."""
    if pred.ndim == 3:
        z = pred.shape[-1] // 2
        pred, label = pred[..., z], label[..., z]
    _save_panels(png_dir, f"sample_{idx}.png", [("prediction", pred), ("label", label)])


def _deserialize_pred(pred, qdt, sqrt_len: int, p: int, twoD: bool) -> np.ndarray:
    """A SAP class map in the sqrt-len pseudo-image space -> image space
    through the sample's quadtree or octree (`ucf_vit_tpu/inference.py:397-408`):
    its tokens `[L, p^nd]` as f32, each written over its leaf, rounded to
    int64; of a list of trees (one a channel) the first."""
    tokens = disassemble_sqrt_len(torch.as_tensor(pred).float().cpu(), sqrt_len, p, twoD)
    if isinstance(qdt, list):
        qdt = qdt[0]
    out = qdt.deserialize(tokens.numpy(), p, 1)
    return np.rint(out[..., 0]).astype(np.int64)


def evaluate_segmentation(cfg: Config, checkpoint_dir: Optional[str] = None,
                          mae_checkpoint_dir: Optional[str] = None, synthetic: bool = False,
                          num_samples: int = 8, png_dir: Optional[str] = None,
                          batch_size: int = 1, use_ema: bool = False, *,
                          device: Device = None) -> float:
    """A UNETR's or a SAP's Dice (`ucf_vit_tpu/inference.py:175-314`) over
    `num_samples` batches of `batch_size` (one Dice a batch; printed, then
    their mean, which it returns): the seeded init, a checkpoint's weights
    (with `use_ema` its EMA) and then, with `mae_checkpoint_dir`, the encoder
    from an MAE checkpoint (its slot: `trainer.checkpoint_filename_for_loading`,
    as the JAX CLI reads it). The synthetic stream, or the config's files
    through the `DataModule`. A SAP is scored in the pseudo-image space its
    logits live in, against the serialized labels reassembled the same way
    (`tasks.sap_labels`). With `png_dir`, one PNG a batch (its first sample);
    a SAP's prediction is first written back to image space through the
    sample's tree (`_deserialize_pred`; the loader keeps the trees then) and
    drawn beside the image-space label. On the config's mesh each data rank
    takes its share of every batch (`batch_size` must divide over the data
    ranks), and a batch's Dice is that of the predictions and labels gathered
    over the data ranks: the number one device computes
    (`ucf_vit_tpu/inference.py:199-271`)."""
    from ucf_vit_tpu_torch.train import build_dataloader, to_device, transfer_pretrained_mae
    from ucf_vit_tpu_torch.utils.metrics import dice_metric

    mesh = eval_mesh(cfg, resolve_device(device))
    _check_split("batch_size", batch_size, mesh)
    png_dir = png_dir if is_main(mesh) else None
    if png_dir:
        _pyplot()
    model = init_eval_model(cfg, seed=0, device=device, mesh=mesh)
    if checkpoint_dir:
        epoch = load_weights(model, cfg, checkpoint_dir, use_ema=use_ema)
        _say(mesh, f"loaded checkpoint from epoch {epoch}")
    if mae_checkpoint_dir:
        transfer_pretrained_mae(cfg, model, mae_checkpoint_dir,
                                cfg.trainer.get("checkpoint_filename_for_loading", ""))
    dev = next(model.parameters()).device
    classes = num_classes(cfg)
    var_ids = var_ids_of(cfg, model)
    sap = cfg.task == "sap"
    dm, synth, _ = build_dataloader(cfg, batch_size, synthetic, mesh=mesh,
                                    return_qdt=bool(png_dir) and cfg.adaptive_patching)
    it = synth if synthetic else dm.train_dataloader()
    dices = []
    try:
        with torch.inference_mode(), mesh_context(mesh):
            for i, batch in enumerate(_on_every_rank(it, mesh, dev)):
                if i >= num_samples:
                    break
                b = to_device(batch, dev)
                if sap:
                    img, ps = sap_inputs(cfg, b)
                    pred = model(img, seq_ps=ps, var_ids=var_ids).argmax(dim=1)
                    label = sap_labels(cfg, b)
                else:
                    x, ps, x_seq = unetr_inputs(cfg, b)
                    pred = model(x, seq_ps=ps, x_seq=x_seq, var_ids=var_ids).argmax(dim=1)
                    label = b["label"]
                    if label.ndim == pred.ndim + 1:
                        label = label[:, 0]
                pred, label = gather_data(pred, mesh), gather_data(label, mesh)
                d = float(dice_metric(pred, label, classes))
                dices.append(d)
                _say(mesh, f"sample {i}: dice {d:.4f}")
                if png_dir:
                    png_pred, png_label = pred[0].cpu().numpy(), label[0].cpu().numpy()
                    if sap and "qdt" in batch:
                        png_pred = _deserialize_pred(pred[0], batch["qdt"][0], cfg.sqrt_len,
                                                     cfg.patch_size, cfg.twoD)
                        png_label = np.asarray(batch["label"][0])
                        if png_label.ndim == png_pred.ndim + 1:
                            png_label = png_label[0]
                    _dump_png(png_dir, i, png_pred, png_label)
    finally:
        it.close()
    mean_dice = float(np.mean(dices)) if dices else float("nan")
    _say(mesh, f"mean dice over {len(dices)} samples: {mean_dice:.4f}")
    return mean_dice


def evaluate(cfg: Config, checkpoint_dir: Optional[str] = None,
             mae_checkpoint_dir: Optional[str] = None, synthetic: bool = False,
             num_samples: int = 8, png_dir: Optional[str] = None, batch_size: int = 1,
             use_ema: bool = False, *, device: Device = None) -> float:
    """The evaluation of `cfg`'s task, with the JAX function's arguments
    (`ucf_vit_tpu/inference.py:175`): top-1 accuracy for classification,
    samples/s of generation for diffusion (PNGs with `png_dir`), the mean
    Dice for UNETR and SAP (`evaluate_segmentation`; `mae_checkpoint_dir` and
    `batch_size` are its arguments)."""
    if cfg.task in ("unetr", "sap"):
        return evaluate_segmentation(cfg, checkpoint_dir, mae_checkpoint_dir, synthetic,
                                     num_samples, png_dir, batch_size, use_ema, device=device)
    if cfg.task == "classification":
        return evaluate_classification(cfg, checkpoint_dir, synthetic, num_samples, use_ema,
                                       device=device)
    if cfg.task == "diffusion":
        return generate_diffusion(cfg, checkpoint_dir, num_samples, png_dir, use_ema=use_ema,
                                  device=device)
    raise ValueError(f"the inference CLI evaluates classification, diffusion, unetr and sap; "
                     f"got task {cfg.task!r}")


def gaussian_importance(tile, sigma_scale: float = 0.125) -> np.ndarray:
    """A window's blend weight a voxel: a separable Gaussian centred on the
    tile (sigma = `sigma_scale` x the side, MONAI's), its peak 1, floored at
    1e-3 so that a voxel one window alone covers keeps its prediction
    (`ucf_vit_tpu/inference.py:461`)."""
    w = np.ones(tile, np.float32)
    for d, n in enumerate(tile):
        x = np.arange(n, dtype=np.float32) - (n - 1) / 2.0
        g = np.exp(-0.5 * (x / (sigma_scale * n)) ** 2)
        w *= g.reshape((1,) * d + (-1,) + (1,) * (len(tile) - d - 1))
    return np.maximum(w / w.max(), 1e-3)


def window_starts(dim: int, tile: int, stride: int) -> list:
    """A window every `stride` voxels, the last one flush with the far edge."""
    starts = list(range(0, max(dim - tile, 0) + 1, stride))
    if starts[-1] != dim - tile:
        starts.append(dim - tile)
    return starts


class VolumePredictor:
    """Sliding-window segmentation of whole volumes with one model
    (`ucf_vit_tpu/inference.py:471-603`): build once, call a volume at a time.

    The windows of the tile's size go through the server's preprocessor
    (`serve.make_preprocessor`: with adaptive patching the octree of each),
    `sw_batch` at a time through the model; their softmax probabilities are
    blended with a Gaussian importance map (`blend="gaussian"`, else flat)
    and the class map is the argmax of the blend. The host works one chunk
    ahead of the device: chunk i+1 is preprocessed and dispatched before
    chunk i's probabilities are read, which on a card come back through
    pinned memory once their own copy is done, while chunk i+1 runs.
    `last_stats` holds the last call's windows, seconds and seconds of host
    preprocessing, `last_probs` its blended probabilities `[classes,
    *spatial]` (padding included). It runs on one device: a model it builds
    is put on no mesh, whatever the config's `parallelism:` (sp too)."""

    def __init__(self, cfg: Config, checkpoint_dir: Optional[str] = None,
                 model: Optional[torch.nn.Module] = None, sw_batch: int = 4,
                 use_ema: bool = False, blend: str = "gaussian", *, device: Device = None):
        if cfg.task != "unetr":
            # the JAX package's assertion (`ucf_vit_tpu/inference.py:484-487`), raised
            # explicitly so that it holds under -O
            raise AssertionError(
                "sliding-window stitching needs image-space tile logits; SAP predicts in "
                "the sqrt-len pseudo-image space (use evaluate())")
        from ucf_vit_tpu_torch.serve import make_preprocessor

        self.cfg = cfg
        self.sw_batch = int(sw_batch)
        nd = 2 if cfg.twoD else 3
        self.tile = tuple(int(t) for t in cfg.tile_size[:nd])
        if model is None:
            model = init_eval_model(cfg, seed=0, device=device)
            if checkpoint_dir:
                load_weights(model, cfg, checkpoint_dir, use_ema=use_ema)
        self.model = model.eval()
        self.var_ids = var_ids_of(cfg, model)
        self.dev = next(model.parameters()).device
        self._pre = make_preprocessor(cfg)
        self._w_map = (gaussian_importance(self.tile) if blend == "gaussian"
                       else np.ones(self.tile, np.float32))
        self.num_classes = num_classes(cfg)
        self.last_stats: dict = {}

    @torch.inference_mode()
    def _dispatch(self, batch: dict):
        """The chunk's probabilities `[sw_batch, classes, *tile]`: launched,
        and on a card copied into pinned memory behind an event."""
        b = {k: torch.from_numpy(v).to(self.dev, non_blocking=True) for k, v in batch.items()}
        x, ps, x_seq = unetr_inputs(self.cfg, b)
        probs = torch.softmax(self.model(x, seq_ps=ps, x_seq=x_seq, var_ids=self.var_ids).float(),
                              dim=1)
        if self.dev.type != "cuda":
            return probs, None
        host = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)
        host.copy_(probs, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def __call__(self, volume: np.ndarray, overlap: float = 0.5) -> np.ndarray:
        """The int32 class map `[*spatial]` of a `[C, *spatial]` volume. A
        spatial side shorter than the tile is reflect-padded, and the map
        cropped back."""
        if not 0.0 <= overlap < 1.0:
            raise ValueError(f"overlap must be in [0, 1), got {overlap}")
        t0 = time.perf_counter()
        tile, sw_batch, nd = self.tile, self.sw_batch, len(self.tile)
        volume = np.asarray(volume, np.float32)
        if volume.ndim != nd + 1:
            raise ValueError(f"volume must be [C, *{nd}-d spatial], got {volume.shape}")
        pad = [(0, 0)] + [(0, max(t - s, 0)) for t, s in zip(tile, volume.shape[1:])]
        vol = np.pad(volume, pad, mode="reflect") if any(p for _, p in pad) else volume
        spatial = vol.shape[1:]
        strides = [max(1, int(round(t * (1.0 - overlap)))) for t in tile]
        corners = list(itertools.product(*(window_starts(s, t, st)
                                           for s, t, st in zip(spatial, tile, strides))))
        probs_acc = np.zeros((self.num_classes,) + spatial, np.float32)
        w_acc = np.zeros(spatial, np.float32)
        pre_s = 0.0

        def make_batch(i):
            nonlocal pre_s
            t1 = time.perf_counter()
            chunk = corners[i:i + sw_batch]
            samples = [self._pre(vol[(slice(None),) + tuple(slice(a, a + t)
                                                           for a, t in zip(c0, tile))])
                       for c0 in chunk]
            while len(samples) < sw_batch:  # one shape for every chunk; the extras dropped
                samples.append(samples[-1])
            batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
            pre_s += time.perf_counter() - t1
            return chunk, batch

        def accumulate(chunk, probs, done):
            if done is not None:
                done.synchronize()
            probs = probs.numpy()
            for j, c0 in enumerate(chunk):
                sl = tuple(slice(a, a + t) for a, t in zip(c0, tile))
                probs_acc[(slice(None),) + sl] += probs[j] * self._w_map
                w_acc[sl] += self._w_map

        in_flight = None
        for i in range(0, len(corners), sw_batch):
            chunk, batch = make_batch(i)
            out = self._dispatch(batch)
            if in_flight is not None:
                accumulate(*in_flight)
            in_flight = (chunk, *out)
        accumulate(*in_flight)
        pred = np.argmax(probs_acc / w_acc, axis=0).astype(np.int32)
        self.last_probs = probs_acc / w_acc
        self.last_stats = {"windows": len(corners), "seconds": time.perf_counter() - t0,
                           "preprocess_s": pre_s}
        return pred[tuple(slice(0, s) for s in volume.shape[1:])]


def predict_volume(cfg: Config, volume: np.ndarray, checkpoint_dir: Optional[str] = None,
                   overlap: float = 0.5, sw_batch: int = 4, use_ema: bool = False,
                   blend: str = "gaussian", *, device: Device = None) -> np.ndarray:
    """One volume through a `VolumePredictor` made for it
    (`ucf_vit_tpu/inference.py:606-618`)."""
    return VolumePredictor(cfg, checkpoint_dir, sw_batch=sw_batch, use_ema=use_ema,
                           blend=blend, device=device)(volume, overlap=overlap)


def main(argv=None) -> float:
    """The inference CLI (`ucf_vit_tpu/inference.py:633-671`); returns what
    `evaluate` returns, or with `--volume` the class map."""
    parser = argparse.ArgumentParser(description="ucf_vit_tpu_torch inference/eval")
    parser.add_argument("config")
    parser.add_argument("launcher", nargs="?", default=None)
    parser.add_argument("--task", default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="a checkpoint file, or a directory whose slot "
                             "trainer.checkpoint_filename_for_loading names")
    parser.add_argument("--mae-checkpoint", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--num-samples", type=int, default=8)
    parser.add_argument("--png-dir", default=None)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--ema", action="store_true",
                        help="evaluate the EMA weights (trainer.ema_decay)")
    parser.add_argument("--volume", default=None,
                        help="sliding-window segmentation of a [C, *spatial] .npy volume "
                             "(unetr)")
    parser.add_argument("--volume-out", default=None,
                        help="where the int32 class map goes (default <volume>.pred.npy)")
    parser.add_argument("--sw-overlap", type=float, default=0.5)
    parser.add_argument("--sw-batch", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    from ucf_vit_tpu_torch.config import load_config

    cfg = load_config(args.config, task=args.task)
    if args.volume:
        vol = np.load(args.volume)
        predictor = VolumePredictor(cfg, args.checkpoint, sw_batch=args.sw_batch,
                                    use_ema=args.ema, device=args.device)
        pred = predictor(vol, overlap=args.sw_overlap)
        out = args.volume_out or (args.volume + ".pred.npy")
        np.save(out, pred)
        vals, counts = np.unique(pred, return_counts=True)
        st = predictor.last_stats
        print(f"stitched {vol.shape[1:]} -> {out}; class voxels "
              f"{dict(zip(vals.tolist(), counts.tolist()))}; {st['windows']} windows in "
              f"{st['seconds']:.3f} s, {st['preprocess_s']:.3f} s of it preprocessing",
              flush=True)
        return pred
    return evaluate(cfg, args.checkpoint, args.mae_checkpoint, args.synthetic,
                    args.num_samples, args.png_dir, args.batch_size, use_ema=args.ema,
                    device=args.device)


if __name__ == "__main__":
    main()
