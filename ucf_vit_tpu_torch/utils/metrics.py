"""Losses and metrics (port of `ucf_vit_tpu/utils/metrics.py`).

The classification pair (`cross_entropy` `:46`, `accuracy` `:54`), MAE's
two (`mse` `:29`, `masked_mse` `:35`) and the adaptive token-space MSE
(`token_masked_mse_adaptive` `:58`); the other losses come with their tasks
(ROADMAP.md). Predictions are taken as the models give them and the results
are f32 scalars.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over every entry, in f32."""
    return (pred.float() - target.float()).square().mean()


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MSE over the masked tokens only: pred and target `[B, L, F]`, mask
    `[B, L]` with 1 where a token is masked (and counted), in f32."""
    loss = (pred.float() - target.float()).square().mean(dim=-1)
    mask = mask.float()
    return (loss * mask).sum() / mask.sum().clamp_min(1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross entropy with integer labels, [B, C] x [B] -> scalar, in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


def token_masked_mse_adaptive(pred: torch.Tensor, target_tokens: torch.Tensor,
                              seq_size: torch.Tensor) -> torch.Tensor:
    """MSE over the serialized patches `[B, L, F]` whose leaf size `seq_size`
    `[B, L]` is not 0 (the quadtree's padding leaves are), in f32. The
    adaptive MAE's loss is `mse` over every token, as in the JAX task; this
    is the JAX package's token-space form of the reference's image-space
    loss."""
    valid = (seq_size > 0).float()
    loss = (pred.float() - target_tokens.float()).square().mean(dim=-1)
    return (loss * valid).sum() / valid.sum().clamp_min(1.0)
