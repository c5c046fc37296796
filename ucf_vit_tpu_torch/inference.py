"""Device choice, seeded model init and checkpoint weights for evaluation
and serving (the roles of `_init_eval_params`, `ucf_vit_tpu/inference.py:78`,
and of the server's `load_weights`, `ucf_vit_tpu/serve.py:216-237`, on one
device), an MAE's reconstruction under a fixed mask, and DiffusionVIT's
images by the DDPM reverse chain (`generate_diffusion`,
`ucf_vit_tpu/inference.py:317`)."""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ucf_vit_tpu_torch import checkpoint as ckpt
from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.models import MAE, DiffusionVIT, ddpm_sample, ddpm_schedule
from ucf_vit_tpu_torch.ops.patchify import unpatchify
from ucf_vit_tpu_torch.tasks import build_task, time_steps

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
def reconstruct(model: torch.nn.Module, x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """An MAE's reconstruction of images `x` `[B, C, *spatial]` in image
    space: the prediction of every token, unpatchified, under the mask that
    noise drawn from `torch.Generator(x.device).manual_seed(seed)` gives, so
    that the same request always gets the same visible-token subset (the
    JAX server's MAE branch, `ucf_vit_tpu/serve.py:277-297`). Puts the model
    in eval mode."""
    if not isinstance(model, MAE):
        raise TypeError(f"reconstruct takes an MAE, got {type(model).__name__}")
    noise = torch.rand(x.shape[0], model.num_patches, device=x.device,
                       generator=torch.Generator(x.device).manual_seed(int(seed)))
    pred, _ = model.eval()(x, mask_noise=noise)
    return unpatchify(pred, tuple(x.shape), model.patch_size, model.twoD)


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
                       num_samples: int = 8, use_ema: bool = False, device: Device = None,
                       seed: int = 0) -> Tuple[float, np.ndarray]:
    """Images from a DiffusionVIT by ancestral DDPM sampling: the seeded init
    (seed 0) or a checkpoint's weights (`checkpoint_dir`; with `use_ema` its
    EMA), then the whole reverse chain at a batch of `num_samples`, drawn
    from `seed`. Returns (samples/s, the images `[num_samples, C, *tile]`).
    Writing the images as PNG files is not ported yet (ROADMAP.md, modules
    to port: item 5's remainder)."""
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
    return sps, imgs
