"""Losses and metrics (port of `ucf_vit_tpu/utils/metrics.py`).

The classification pair (`cross_entropy` `:46`, `accuracy` `:54`), MAE's
two (`mse` `:29`, `masked_mse` `:35`), the adaptive token-space MSE
(`token_masked_mse_adaptive` `:58`) and UNETR's two (`dice_ce_loss` `:107`,
MONAI's DiceCELoss as the reference trains with it, and `dice_metric`
`:148`, MONAI's DiceMetric without the background) and SAP's `dice_b_loss` (`:74`).
Predictions are taken as the models give them and the results are f32
scalars.

Under data parallelism (an active mesh with more than one data rank) each
rank holds a slice of the batch. A loss that is a mean of equal per-sample
terms needs nothing: the mean over the data ranks of the local means is the
global mean, and the train step averages the gradients over them. The
losses that are not (`masked_mse` and `token_masked_mse_adaptive` divide by
a mask count that differs between ranks; `dice_b_loss` takes its Dice from
sums over the whole batch) sum their numerators and denominators over the
data ranks (`_global_sum`: all-reduce forward, identity backward, so each
rank's gradient is that of the global loss with respect to its own samples)
and return the global value on every rank, its gradient scaled by the data
size (`_ScaleGrad`) so that the step's average over the ranks is the global
loss's gradient: the single-device step's on the global batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ucf_vit_tpu_torch.parallel.collectives import f_allreduce_b_identity
from ucf_vit_tpu_torch.parallel.mesh import active_mesh


def _data_parallel():
    """The active mesh's data group and size, or (None, 1)."""
    mesh = active_mesh()
    if mesh is None or mesh.data_size == 1:
        return None, 1
    return mesh.data_group, mesh.data_size


def _global_sum(x: torch.Tensor, group) -> torch.Tensor:
    return f_allreduce_b_identity(x, group)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times `n` backward."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over every entry, in f32."""
    return (pred.float() - target.float()).square().mean()


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MSE over the masked tokens only: pred and target `[B, L, F]`, mask
    `[B, L]` with 1 where a token is masked (and counted), in f32."""
    loss = (pred.float() - target.float()).square().mean(dim=-1)
    return _masked_mean(loss, mask.float())


def _masked_mean(loss: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(loss * mask) / max(sum(mask), 1), over the data ranks' samples."""
    group, n = _data_parallel()
    if group is None:
        return (loss * mask).sum() / mask.sum().clamp_min(1.0)
    num = _global_sum((loss * mask).sum(), group)
    den = _global_sum(mask.sum().detach(), group)
    return _ScaleGrad.apply(num / den.clamp_min(1.0), n)


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
    return _masked_mean(loss, valid)


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
    intersection, p_sum, t_sum = (p * t).sum(), p.sum(), t.sum()
    group, n = _data_parallel()
    if group is not None:  # the BCE's mean and the Dice's sums over the whole batch
        bce = _global_sum(bce, group) / n
        intersection, p_sum = _global_sum(intersection, group), _global_sum(p_sum, group)
        t_sum = _global_sum(t_sum, group)
    dice = 1.0 - (2.0 * intersection + smooth) / (p_sum + t_sum + smooth)
    loss = weight * bce + (1 - weight) * dice
    return loss if group is None else _ScaleGrad.apply(loss, n)


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
