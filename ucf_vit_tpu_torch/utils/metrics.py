"""Losses and metrics (port of `ucf_vit_tpu/utils/metrics.py`).

The classification pair (`cross_entropy` `:46`, `accuracy` `:54`), MAE's
two (`mse` `:29`, `masked_mse` `:35`), the adaptive token-space MSE
(`token_masked_mse_adaptive` `:58`) and UNETR's two (`dice_ce_loss` `:107`,
MONAI's DiceCELoss as the reference trains with it, and `dice_metric`
`:148`, MONAI's DiceMetric without the background) and SAP's `dice_b_loss` (`:74`).
Predictions are taken as the models give them and the results are f32
scalars.
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


def dice_b_loss(logits: torch.Tensor, targets: torch.Tensor, weight: float = 0.5,
                smooth: float = 1.0, apply_sigmoid: bool = True) -> torch.Tensor:
    """Dice plus binary cross entropy over the channels past the background
    (`ucf_vit_tpu/utils/metrics.py:74-104`): logits and one-hot targets
    `[B, C, *spatial]`. A sigmoid of channels `1:`, the BCE taken from the
    logits as `max(z, 0) - z t + log1p(exp(-|z|))` (or, with
    `apply_sigmoid=False`, from the inputs taken as probabilities, clipped to
    `[1e-7, 1 - 1e-7]`), averaged over every element; the Dice from sums over
    the whole batch, not per sample; the two mixed by `weight`. In f32."""
    x = logits.float()
    t = targets[:, 1:].float()
    if apply_sigmoid:
        z = x[:, 1:]
        p = torch.sigmoid(z)
        bce = (z.clamp_min(0) - z * t + torch.log1p(torch.exp(-z.abs()))).mean()
    else:
        p = x[:, 1:]
        pc = p.clamp(1e-7, 1 - 1e-7)
        bce = -(t * torch.log(pc) + (1 - t) * torch.log(1 - pc)).mean()
    intersection = (p * t).sum()
    dice = 1.0 - (2.0 * intersection + smooth) / (p.sum() + t.sum() + smooth)
    return weight * bce + (1 - weight) * dice


def dice_ce_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                 smooth_nr: float = 0.0, smooth_dr: float = 1e-6, squared_pred: bool = True,
                 include_background: bool = True) -> torch.Tensor:
    """MONAI's `DiceCELoss(to_onehot_y=True, softmax=True, squared_pred=True,
    smooth_nr=0, smooth_dr=1e-6)`: logits `[B, C, *spatial]`, labels `[B, 1,
    *spatial]` integer classes. Dice per (sample, class) over the voxels,
    averaged, plus the softmax cross entropy; in f32."""
    x = logits.float()
    b, c = x.shape[0], x.shape[1]
    lbl = labels.reshape(b, -1).long()
    probs = torch.softmax(x, dim=1).reshape(b, c, -1)
    onehot = F.one_hot(lbl, c).transpose(1, 2).float()
    if not include_background:
        probs, onehot = probs[:, 1:], onehot[:, 1:]
    intersection = (onehot * probs).sum(-1)
    if squared_pred:
        ground, pred_sum = (onehot * onehot).sum(-1), (probs * probs).sum(-1)
    else:
        ground, pred_sum = onehot.sum(-1), probs.sum(-1)
    dice = (1.0 - (2.0 * intersection + smooth_nr) / (ground + pred_sum + smooth_dr)).mean()
    logp = F.log_softmax(x, dim=1).reshape(b, c, -1)
    ce = -logp.gather(1, lbl[:, None, :]).mean()
    return dice + ce


def dice_metric(pred_labels: torch.Tensor, true_labels: torch.Tensor, num_classes: int,
                include_background: bool = False) -> torch.Tensor:
    """Mean Dice over the classes present (and the batch): MONAI's
    `DiceMetric(include_background=False, reduction="mean")`, a class absent
    from both prediction and label left out of the mean. `[B, *spatial]`
    integer classes each; an f32 scalar."""
    b = pred_labels.shape[0]
    p = F.one_hot(pred_labels.reshape(b, -1).long(), num_classes).float()
    t = F.one_hot(true_labels.reshape(b, -1).long(), num_classes).float()
    if not include_background:
        p, t = p[..., 1:], t[..., 1:]
    intersection = (p * t).sum(1)
    denom = p.sum(1) + t.sum(1)
    dice = 2.0 * intersection / denom.clamp_min(1e-6)
    present = (denom > 0).float()
    return (dice * present).sum() / present.sum().clamp_min(1.0)
