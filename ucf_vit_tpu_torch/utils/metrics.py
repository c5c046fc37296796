"""Losses and metrics (port of `ucf_vit_tpu/utils/metrics.py`).

The classification pair only (`cross_entropy` `:46`, `accuracy` `:54`); the
other losses come with their tasks (ROADMAP.md). Logits are taken as the
models give them and the results are f32 scalars.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross entropy with integer labels, [B, C] x [B] -> scalar, in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()
