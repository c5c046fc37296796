"""DDPM noise schedule, forward noising and the ancestral sampler (port of
`ucf_vit_tpu/models/ddpm.py`).

A linear beta over [1e-4, 0.02] in f32 and its f32 cumulative product
alpha-bar (`ddpm_schedule`, `:22`); `q_sample` noises x0 to step t (`:28`);
`sample_timesteps` draws training steps (`:45`); `ddpm_sample` runs the whole
reverse chain (`:49`). The JAX sampler is one `lax.fori_loop`; PyTorch runs
eagerly, so here the chain is a Python loop over `t = T-1 ... 0` whose tensors
stay on the device. Every draw comes from an explicit `torch.Generator`, never
from torch's global one; the tests inject the JAX side's draws instead
(`x_T`, `noises`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class DDPMSchedule(NamedTuple):
    beta: torch.Tensor  # [T] f32
    alpha_bar: torch.Tensor  # [T] f32, the cumulative product of (1 - beta)
    num_time_steps: int

    def to(self, device) -> "DDPMSchedule":
        return DDPMSchedule(self.beta.to(device), self.alpha_bar.to(device),
                            self.num_time_steps)


def ddpm_schedule(num_time_steps: int = 1000) -> DDPMSchedule:
    """The schedule on the CPU (`DDPMSchedule.to` moves it)."""
    beta = torch.linspace(1e-4, 0.02, num_time_steps, dtype=torch.float32)
    return DDPMSchedule(beta=beta, alpha_bar=torch.cumprod(1.0 - beta, dim=0),
                        num_time_steps=int(num_time_steps))


def q_sample(schedule: DDPMSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion: `sqrt(a_bar_t) x0 + sqrt(1 - a_bar_t) noise`, with
    `t` `[B]` integer steps broadcast over x0's trailing dims."""
    a = schedule.alpha_bar.to(x0.device)[t.to(x0.device)]
    a = a.reshape((x0.shape[0],) + (1,) * (x0.dim() - 1))
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def sample_timesteps(generator: torch.Generator, batch: int, num_time_steps: int
                     ) -> torch.Tensor:
    """`[batch]` steps uniform in [0, num_time_steps), drawn from `generator` on
    its device."""
    return torch.randint(0, num_time_steps, (batch,), device=generator.device,
                         generator=generator)


def _reverse_coefficients(schedule: DDPMSchedule) -> Tuple[np.ndarray, ...]:
    """Per step t: beta_t / sqrt(1 - a_bar_t), sqrt(alpha_t) and sqrt(beta_t),
    each computed in f32 as the JAX sampler computes it on its device."""
    beta = schedule.beta.cpu().numpy()
    a_bar = schedule.alpha_bar.cpu().numpy()
    one = np.float32(1.0)
    return beta / np.sqrt(one - a_bar), np.sqrt(one - beta), np.sqrt(beta)


@torch.no_grad()
def ddpm_sample(
    schedule: DDPMSchedule,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    generator: Optional[torch.Generator],
    shape: Sequence[int],
    device,
    x_T: Optional[torch.Tensor] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
    rows: Optional[slice] = None,
) -> torch.Tensor:
    """Ancestral DDPM sampling. `denoise_fn(x_t, t[B])` predicts the noise with
    x_t's shape. The chain runs on `device`; x_T and each step's noise are
    drawn from `generator` there, unless `x_T` and `noises` (T tensors, for
    t = T-1 ... 0) are given. As in the JAX sampler a noise is drawn at every
    step, t = 0 included, where it is not used. With `rows`, every draw is of
    the whole `shape` and the chain runs on those rows of it alone (a data
    rank's share of a sharded chain): the rows come out as in the whole
    chain."""
    shape = tuple(int(s) for s in shape)
    T = schedule.num_time_steps
    if (x_T is None or noises is None) and generator is None:
        raise ValueError("ddpm_sample draws from an explicit generator: pass one, or x_T "
                         "and noises")
    if noises is not None and len(noises) != T:
        raise ValueError(f"noises holds {len(noises)} steps, the schedule {T}")
    coef, sqrt_alpha, sigma = _reverse_coefficients(schedule)
    rows = slice(None) if rows is None else rows
    x = (torch.randn(shape, device=device, generator=generator) if x_T is None
         else x_T.to(device, torch.float32))[rows]
    for i in range(T):
        t = T - 1 - i
        eps = denoise_fn(x, torch.full((x.shape[0],), t, dtype=torch.long, device=device))
        mean = (x - float(coef[t]) * eps) / float(sqrt_alpha[t])
        noise = (torch.randn(shape, device=device, generator=generator) if noises is None
                 else noises[i].to(device, torch.float32))[rows]
        x = mean + float(sigma[t]) * noise if t > 0 else mean
    return x
