"""Evaluation and the inference CLI (port of `ucf_vit_tpu/inference.py`, on
one device):

    python -m ucf_vit_tpu_torch.inference <config.yaml> [--checkpoint D]
        [--synthetic] [--num-samples N] [--png-dir P] [--batch-size B] [--ema]
        [--device cuda|cpu]

Device choice, seeded model init and checkpoint weights for evaluation and
serving (the roles of `_init_eval_params`, `ucf_vit_tpu/inference.py:78`, and
of the server's `load_weights`, `ucf_vit_tpu/serve.py:216-237`), an MAE's
reconstruction under a fixed mask, top-1 accuracy of a classifier
(`evaluate_classification`), and DiffusionVIT's images by the DDPM reverse
chain (`generate_diffusion`), with a PNG a sample. The PNG writer imports
matplotlib when it is asked for PNGs, never at import time. `evaluate` sends
a config to the evaluation of its task; UNETR and SAP are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from ucf_vit_tpu_torch import checkpoint as ckpt
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.models import MAE, DiffusionVIT, ddpm_sample, ddpm_schedule
from ucf_vit_tpu_torch.ops.patchify import unpatchify
from ucf_vit_tpu_torch.tasks import build_task, model_inputs, time_steps

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device to run on: CUDA unless the caller names another. Raises
    when CUDA is asked for (or left as the default) and none is present;
    nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def init_eval_model(cfg: Config, seed: int = 0, device: Device = None) -> torch.nn.Module:
    """The task's model with weights drawn on the CPU from
    `torch.Generator().manual_seed(seed)` (so every device gets the same
    weights), moved to `device` and put in eval mode."""
    dev = resolve_device(device)
    model = build_task(cfg)
    model.init_weights(torch.Generator().manual_seed(int(seed)))
    return model.to(dev).eval()


def load_weights(model: torch.nn.Module, cfg: Config, ckpt_dir: str,
                 use_ema: bool = False) -> int:
    """Copy a checkpoint's parameters (or, with `use_ema`, its EMA of them)
    into `model` in place; returns the checkpoint's epoch. `ckpt_dir` is a
    checkpoint file, or a directory whose slot
    `trainer.checkpoint_filename_for_loading` names (empty: the newest).
    The head grouping, every name and every shape are checked first."""
    payload = ckpt.restore_checkpoint(
        ckpt_dir, cfg.trainer.get("checkpoint_filename_for_loading", ""),
        expect_head_meta=ckpt.head_meta_from_config(cfg))
    sd = payload["model_state_dict"]
    if use_ema:
        sd = payload.get("ema_state_dict")
        if sd is None:
            raise ValueError("--ema requested but this checkpoint has no EMA state; train "
                             "with trainer.ema_decay set")
    ckpt.load_params(model, sd, f"checkpoint {ckpt_dir}")
    return int(payload["epoch"])


@torch.no_grad()
def reconstruct(model: torch.nn.Module, x: torch.Tensor, seed: int = 0,
                seq_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
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
    pred, _ = model.eval()(x, mask_noise=noise, seq_ps=seq_ps)
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
    noise prediction in image space. Puts the model in eval mode."""
    if not isinstance(model, DiffusionVIT):
        raise TypeError(f"the DDPM sampler takes a DiffusionVIT, got {type(model).__name__}")
    model.eval()
    dev = next(model.parameters()).device
    nd = 2 if cfg.twoD else 3
    shape = (int(num_samples), cfg.max_channels) + tuple(cfg.tile_size[:nd])
    schedule = ddpm_schedule(time_steps(cfg)).to(dev)

    def denoise(x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return unpatchify(model(x_t, t), shape, model.patch_size, model.twoD)

    @torch.inference_mode()
    def generate(seed: int) -> torch.Tensor:
        gen = torch.Generator(dev).manual_seed(int(seed))
        return ddpm_sample(schedule, denoise, gen, shape, dev)

    generate.denoise = denoise
    generate.shape = shape
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
    `return_images`."""
    if png_dir:
        _pyplot()  # a missing matplotlib shows before the chain runs, not after
    model = init_eval_model(cfg, seed=0, device=device)
    if checkpoint_dir:
        epoch = load_weights(model, cfg, checkpoint_dir, use_ema=use_ema)
        print(f"loaded checkpoint from epoch {epoch}", flush=True)
    generate = diffusion_sampler(cfg, model, max(int(num_samples), 1))
    t0 = time.perf_counter()
    imgs = generate(seed).cpu().numpy()
    dt = time.perf_counter() - t0
    sps = imgs.shape[0] / dt
    print(f"generated {imgs.shape[0]} samples in {dt:.1f}s ({sps:.2f} samples/s, "
          f"{time_steps(cfg)} DDPM steps)", flush=True)
    if png_dir:
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
    `use_ema` its EMA) over at least `num_samples` samples, in batches of
    `data.batch_size`: the synthetic stream, or one epoch of the config's
    file range (`ucf_vit_tpu/inference.py:111-172`)."""
    from ucf_vit_tpu_torch.train import build_dataloader, synthetic_batches, to_device
    from ucf_vit_tpu_torch.utils.metrics import accuracy

    model = init_eval_model(cfg, seed=0, device=device)
    if checkpoint_dir:
        epoch = load_weights(model, cfg, checkpoint_dir, use_ema=use_ema)
        print(f"loaded checkpoint from epoch {epoch}", flush=True)
    dev = next(model.parameters()).device
    if synthetic:
        it = synthetic_batches(cfg, cfg.batch_size)
    else:
        dm, _, _ = build_dataloader(cfg, cfg.batch_size, synthetic=False)
        it = dm.train_dataloader()
    correct, seen = 0.0, 0
    try:
        with torch.inference_mode():
            for batch in it:
                if seen >= num_samples:
                    break
                b = to_device(batch, dev)
                x, ps = model_inputs(cfg, b)
                logits = model(x, seq_ps=ps)
                correct += float(accuracy(logits, b["label"])) * logits.shape[0]
                seen += logits.shape[0]
    finally:
        it.close()
    top1 = correct / max(seen, 1)
    print(f"top-1 accuracy over {seen} samples: {top1:.4f}", flush=True)
    return top1


# tasks whose evaluation and serving are still to port -> the ROADMAP.md item that
# ports each
UNPORTED_TASKS = {"unetr": "item 7: UNETR + evaluation", "sap": "item 8: SAP"}
_ITEM_7 = "(ROADMAP.md, modules to port, item 7: UNETR + evaluation)"


def evaluate(cfg: Config, checkpoint_dir: Optional[str] = None,
             mae_checkpoint_dir: Optional[str] = None, synthetic: bool = False,
             num_samples: int = 8, png_dir: Optional[str] = None, batch_size: int = 1,
             use_ema: bool = False, *, device: Device = None) -> float:
    """The evaluation of `cfg`'s task, with the JAX function's arguments
    (`ucf_vit_tpu/inference.py:175`): top-1 accuracy for classification,
    samples/s of generation for diffusion (PNGs with `png_dir`). `batch_size`
    is the segmentation tasks' batch, which are not ported yet."""
    if mae_checkpoint_dir:
        raise NotImplementedError(f"the MAE-encoder transfer is not ported yet {_ITEM_7}")
    if cfg.task == "classification":
        return evaluate_classification(cfg, checkpoint_dir, synthetic, num_samples, use_ema,
                                       device=device)
    if cfg.task == "diffusion":
        return generate_diffusion(cfg, checkpoint_dir, num_samples, png_dir, use_ema=use_ema,
                                  device=device)
    if cfg.task in UNPORTED_TASKS:
        raise NotImplementedError(f"evaluating task {cfg.task!r} is not ported yet "
                                  f"(ROADMAP.md, modules to port, {UNPORTED_TASKS[cfg.task]})")
    raise ValueError(f"the inference CLI evaluates classification, diffusion, unetr and sap; "
                     f"got task {cfg.task!r}")


def main(argv=None) -> float:
    """The inference CLI (`ucf_vit_tpu/inference.py:633-671`); returns what
    `evaluate` returns."""
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
                        help="sliding-window segmentation of a [C, *spatial] .npy volume")
    parser.add_argument("--volume-out", default=None)
    parser.add_argument("--sw-overlap", type=float, default=0.5)
    parser.add_argument("--sw-batch", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    from ucf_vit_tpu_torch.config import load_config

    cfg = load_config(args.config, task=args.task)
    if args.volume:
        raise NotImplementedError(f"--volume (sliding-window segmentation) is not ported yet "
                                  f"{_ITEM_7}")
    return evaluate(cfg, args.checkpoint, args.mae_checkpoint, args.synthetic,
                    args.num_samples, args.png_dir, args.batch_size, use_ema=args.ema,
                    device=args.device)


if __name__ == "__main__":
    main()
