"""Task registry: model factory and loss per task (port of `ucf_vit_tpu/tasks.py`).

The port has the classification, MAE, diffusion, UNETR and SAP tasks (model
and loss), with adaptive patching's inputs (`model_inputs`: the patch tree's
sequence and its descriptors; UNETR's `unetr_inputs`: the sequence
reassembled into the sqrt-len image beside the tile; SAP's `sap_inputs`: that
image alone). Every loss takes the batch's `var_ids` (`VIT.get_var_ids` of its
`variables`), which a model with `use_varemb` reads and any other ignores, as
the JAX losses take them.

A model with MoE blocks (`moe_num_experts > 1`) adds `moe_aux_weight` (0.01
by default) times the mean of its layers' load-balance losses to every loss
(`ucf_vit_tpu/tasks.py:135-151`), and reports that mean as `moe_aux` beside
the task's own aux; a dense model's loss is unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ucf_vit_tpu_torch.config import Config
from ucf_vit_tpu_torch.models import (
    MAE,
    SAP,
    UNETR,
    VIT,
    DiffusionVIT,
    ddpm_schedule,
    q_sample,
    sample_timesteps,
)
from ucf_vit_tpu_torch.ops.attention import AttnImpl
from ucf_vit_tpu_torch.ops.patchify import patchify, unpatchify
from ucf_vit_tpu_torch.utils.metrics import (
    accuracy,
    cross_entropy,
    dice_b_loss,
    dice_ce_loss,
    masked_mse,
    mse,
)


def _attn_impl(cfg: Config) -> AttnImpl:
    """`trainer.attn_impl` forces an impl; otherwise AUTO."""
    forced = cfg.trainer.get("attn_impl")
    if forced:
        return AttnImpl.from_string(forced)
    return AttnImpl.AUTO


def _common_kwargs(cfg: Config) -> dict:
    """VIT keyword arguments from the config, read as the JAX package reads
    them (`ucf_vit_tpu/tasks.py:40-95`). `remat` defaults to `fsdp_size > 1`
    as there; `sp_mode` rides the model (`:76-78`), not a global; the
    microbatches knob is not read."""
    ia = cfg.init_args
    nd = 2 if cfg.twoD else 3
    return dict(
        img_size=tuple(cfg.tile_size[:nd]),
        patch_size=cfg.patch_size,
        in_chans=cfg.max_channels,
        embed_dim=int(ia.get("embed_dim", 768)),
        depth=int(ia.get("depth", 12)),
        num_heads=int(ia.get("num_heads", 12)),
        mlp_ratio=float(ia.get("mlp_ratio", 4)),
        drop_path_rate=float(ia.get("drop_path", 0.0)),
        drop_rate=float(ia.get("drop_rate", 0.0)),
        pos_drop_rate=float(ia.get("pos_drop_rate", 0.0)),
        patch_drop_rate=float(ia.get("patch_drop_rate", 0.0)),
        proj_drop_rate=float(ia.get("proj_drop_rate", 0.0)),
        attn_drop_rate=float(ia.get("attn_drop_rate", 0.0)),
        twoD=cfg.twoD,
        default_vars=tuple(cfg.default_vars),
        single_channel=cfg.single_channel,
        use_varemb=bool(ia.get("use_varemb", False)),
        adaptive_patching=cfg.adaptive_patching,
        fixed_length=cfg.fixed_length,
        # gated on adaptive_patching, as in the JAX package: configs set the
        # flag for runs that pass no descriptors
        use_adaptive_pos_emb=bool(ia.get("use_adaptive_pos_emb", False))
        and cfg.adaptive_patching,
        attn_impl=_attn_impl(cfg),
        gelu_approx=bool(ia.get("gelu_approx", True)),
        remat=bool(cfg.trainer.get("remat", cfg.parallelism.get("fsdp_size", 1) > 1)),
        scan_layers=bool(
            cfg.trainer.get("scan_layers", ia.get("scan_layers", False))
            or int(cfg.parallelism.get("pipe_par_size", 1)) > 1
        ),
        pipe_par_size=int(cfg.parallelism.get("pipe_par_size", 1)),
        moe_num_experts=int(ia.get("moe_num_experts", 0)),
        moe_top_k=int(ia.get("moe_top_k", 2)),
        moe_capacity_factor=float(ia.get("moe_capacity_factor", 1.25)),
        moe_every=int(ia.get("moe_every", 2)),
        sp_mode=str(cfg.parallelism.get("sp_mode", "auto")).lower(),
        dtype=torch.bfloat16 if cfg.trainer.get("data_type") == "bfloat16" else None,
    )


def moe_weight(cfg: Config) -> float:
    """`init_args.moe_aux_weight` for a config with MoE blocks, else 0
    (`_moe_args`, `ucf_vit_tpu/tasks.py:135-141`)."""
    ia = cfg.init_args
    return float(ia.get("moe_aux_weight", 0.01)) if int(ia.get("moe_num_experts", 0)) > 1 else 0.0


def with_moe_aux(cfg: Config, model: torch.nn.Module, loss: torch.Tensor, aux: dict):
    """`(loss + moe_aux_weight * the model's MoE aux, aux with it as
    "moe_aux")` after a forward of a model with MoE blocks; `(loss, aux)` of a
    dense one."""
    w = moe_weight(cfg)
    if w == 0.0 or getattr(model, "moe_aux", None) is None:
        return loss, aux
    return loss + w * model.moe_aux, {**aux, "moe_aux": model.moe_aux.detach()}


def seq_ps(batch: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """The adaptive patches' descriptors `[B, L, 1 + nd]`: channel 0's leaf
    sizes and centres (`ucf_vit_tpu/tasks.py:155-163`); None for a batch
    without them."""
    if "seq_size" not in batch:
        return None
    return torch.cat([batch["seq_size"][:, 0, :, None], batch["seq_pos"][:, 0]], dim=-1)


def example_variables(cfg: Config) -> Tuple[str, ...]:
    """The variables of the config's example batch (and of its synthetic
    stream): the first `max_channels` of `default_vars`."""
    return tuple(cfg.default_vars[:cfg.max_channels] or ("v",))


def var_ids_of(cfg: Config, model: torch.nn.Module,
               variables: Optional[Tuple[str, ...]] = None) -> Optional[Tuple[int, ...]]:
    """The `var_ids` a loss or forward takes: with `use_varemb` the indices of
    `variables` (default: the example batch's) in the model's `default_vars`,
    else None (`ucf_vit_tpu/train.py:604-606`)."""
    if not bool(cfg.init_args.get("use_varemb", False)):
        return None
    return model.get_var_ids(tuple(variables) if variables is not None
                             else example_variables(cfg))


def model_inputs(cfg: Config, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`(input, seq_ps)` of a batch: the quadtree's sequence `seq` `[B, C, L,
    p^nd]` and its descriptors with adaptive patching, else the image `x`
    and None."""
    if cfg.adaptive_patching:
        return batch["seq"], seq_ps(batch)
    return batch["x"], None


def reassemble_sqrt_len(tokens: torch.Tensor, sqrt_len: int, p: int, twoD: bool
                        ) -> torch.Tensor:
    """`[..., L, p^nd]` -> `[..., (sqrt_len * p)^nd]`: token i becomes the
    i-th `p^nd` block of the image in row-major order (the sqrt-len method's
    input, `ucf_vit_tpu/tasks.py:98`)."""
    lead = tuple(tokens.shape[:-2])
    n = len(lead)
    side = sqrt_len * p
    if twoD:
        t = tokens.reshape(lead + (sqrt_len, sqrt_len, p, p))
        return t.movedim(n + 2, n + 1).reshape(lead + (side, side))
    t = tokens.reshape(lead + (sqrt_len,) * 3 + (p,) * 3)
    t = t.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2, n + 5)
    return t.reshape(lead + (side,) * 3)


def disassemble_sqrt_len(img: torch.Tensor, sqrt_len: int, p: int, twoD: bool
                         ) -> torch.Tensor:
    """The inverse of `reassemble_sqrt_len`: `[..., (sqrt_len * p)^nd]` ->
    `[..., L, p^nd]` (`ucf_vit_tpu/tasks.py:119`)."""
    lead = tuple(img.shape[:-2] if twoD else img.shape[:-3])
    n = len(lead)
    if twoD:
        t = img.reshape(lead + (sqrt_len, p, sqrt_len, p))
        return t.movedim(n + 1, n + 2).reshape(lead + (sqrt_len * sqrt_len, p * p))
    t = img.reshape(lead + (sqrt_len, p, sqrt_len, p, sqrt_len, p))
    t = t.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3, n + 5)
    return t.reshape(lead + (sqrt_len ** 3, p ** 3))


def unetr_inputs(cfg: Config, batch: Dict[str, torch.Tensor]):
    """`(x, seq_ps, x_seq)` of a UNETR batch: the tile `x`, and with adaptive
    patching the descriptors and the sequence reassembled into the sqrt-len
    image (`ucf_vit_tpu/tasks.py:262-270`); else None for both."""
    if not cfg.adaptive_patching:
        return batch["x"], None, None
    x_seq = reassemble_sqrt_len(batch["seq"], cfg.sqrt_len, cfg.patch_size, cfg.twoD)
    return batch["x"], seq_ps(batch), x_seq


def build_classification(cfg: Config) -> VIT:
    ia = cfg.init_args
    return VIT(
        num_classes=int(ia.get("num_classes", cfg.data.get("num_classes", 1000))),
        class_token=True,
        **_common_kwargs(cfg),
    )


def classification_loss(cfg: Config) -> Callable:
    """`loss_fn` of `build_classification` (`ucf_vit_tpu/tasks.py:180-187`):
    cross entropy of the logits of `x` (adaptive: of `seq` and its
    descriptors), with accuracy as aux, plus the MoE term."""

    def loss_fn(model: torch.nn.Module, batch: Dict[str, torch.Tensor], var_ids=None):
        x, ps = model_inputs(cfg, batch)
        logits = model(x, seq_ps=ps, var_ids=var_ids)
        return with_moe_aux(cfg, model, cross_entropy(logits, batch["label"]),
                            {"accuracy": accuracy(logits, batch["label"])})

    return loss_fn


def build_mae(cfg: Config) -> MAE:
    """`build_mae`'s model (`ucf_vit_tpu/tasks.py:197-208`)."""
    ia = cfg.init_args
    return MAE(
        mask_ratio=float(ia.get("mask_ratio", 0.75)),
        linear_decoder=bool(ia.get("linear_decoder", False)),
        decoder_depth=int(ia.get("decoder_depth", 8)),
        decoder_embed_dim=int(ia.get("decoder_embed_dim", 512)),
        decoder_num_heads=int(ia.get("decoder_num_heads", 16)),
        mlp_ratio_decoder=float(ia.get("mlp_ratio_decoder", 4)),
        seq_pack=int(ia.get("seq_pack", 1)),
        **_common_kwargs(cfg),
    )


def mae_loss(cfg: Config) -> Callable:
    """`loss_fn` of `build_mae` (`ucf_vit_tpu/tasks.py:213-236`): with
    adaptive patching the MSE over every token against the sequence `seq`
    `[B, C, L, p^nd]` as `[B, L, p^nd * C]` (the channel fastest), whatever
    `model.loss_fn` says; otherwise `model.loss_fn: maskMSE` takes the masked
    MSE of the prediction against the patchified input, any other name the
    MSE over every token. The mask is drawn from the model's generator. Plus
    the MoE term."""
    masked = cfg.model.get("loss_fn", "MSE") == "maskMSE"

    def loss_fn(model: torch.nn.Module, batch: Dict[str, torch.Tensor], var_ids=None):
        if cfg.adaptive_patching:
            seq = batch["seq"]
            pred, _ = model(seq, seq_ps=seq_ps(batch), var_ids=var_ids)
            b, c, l, p = seq.shape
            loss = mse(pred, seq.permute(0, 2, 3, 1).reshape(b, l, p * c))
        else:
            x = batch["x"]
            pred, mask = model(x, var_ids=var_ids)
            target = patchify(x, cfg.patch_size, cfg.twoD)
            loss = masked_mse(pred, target, mask) if masked else mse(pred, target)
        return with_moe_aux(cfg, model, loss, {})

    return loss_fn


def time_steps(cfg: Config) -> int:
    """The diffusion config's number of DDPM steps (`num_time_steps`, or the
    older `time_steps`)."""
    ia = cfg.init_args
    return int(ia.get("num_time_steps", ia.get("time_steps", 1000)))


def build_diffusion(cfg: Config) -> DiffusionVIT:
    """`build_diffusion`'s model (`ucf_vit_tpu/tasks.py:328-340`)."""
    ia = cfg.init_args
    return DiffusionVIT(
        linear_decoder=bool(ia.get("linear_decoder", False)),
        decoder_depth=int(ia.get("decoder_depth", 8)),
        decoder_embed_dim=int(ia.get("decoder_embed_dim", 512)),
        decoder_num_heads=int(ia.get("decoder_num_heads", 16)),
        mlp_ratio_decoder=float(ia.get("mlp_ratio_decoder", 4)),
        time_steps=time_steps(cfg),
        **_common_kwargs(cfg),
    )


def diffusion_loss(cfg: Config) -> Callable:
    """`loss_fn` of `build_diffusion` (`ucf_vit_tpu/tasks.py:342-355`): noise x0
    to step t with noise e (`q_sample`), predict the noise, and take the MSE
    of the prediction, unpatchified, against e. `t` `[B]` and `e` (x0's
    shape) come from the batch when it holds them, else from the model's
    generator on x0's device (t first, then e); the time embedding's dropout
    draws from it after them. The schedule moves to x0's device once: a copy
    from pageable host memory waits for the device's queue to drain."""
    steps, p, twoD = time_steps(cfg), cfg.patch_size, cfg.twoD
    schedule = ddpm_schedule(steps)

    def loss_fn(model: torch.nn.Module, batch: Dict[str, torch.Tensor], var_ids=None):
        nonlocal schedule
        x0 = batch["x"]
        if schedule.beta.device != x0.device:
            schedule = schedule.to(x0.device)
        t, e = batch.get("t"), batch.get("e")
        if t is None or e is None:
            gen = model.generator
            if gen is None:
                raise RuntimeError(
                    "the diffusion loss draws t and e from an explicit torch.Generator: "
                    "call model.set_generator(...) (the train step does) or put them in "
                    "the batch"
                )
            if t is None:
                t = sample_timesteps(gen, x0.shape[0], steps)
            if e is None:
                e = torch.randn(x0.shape, device=x0.device, dtype=x0.dtype, generator=gen)
        pred = model(q_sample(schedule, x0, t, e), t, var_ids=var_ids)
        return with_moe_aux(cfg, model, mse(unpatchify(pred, tuple(x0.shape), p, twoD), e), {})

    return loss_fn


def num_classes(cfg: Config) -> int:
    """A segmentation config's classes (`init_args`, then `data`)."""
    return int(cfg.init_args.get("num_classes", cfg.data.get("num_classes", 2)))


def build_unetr(cfg: Config) -> UNETR:
    """`build_unetr`'s model (`ucf_vit_tpu/tasks.py:244-256`): adaptive
    patching by the sqrt-len method."""
    ia = cfg.init_args
    return UNETR(
        num_classes=num_classes(cfg),
        linear_decoder=bool(ia.get("linear_decoder", False)),
        feature_size=int(ia.get("feature_size", 16)),
        skip_connection=bool(ia.get("skip_connection", True)),
        sqrt_len_method=cfg.adaptive_patching,
        **_common_kwargs(cfg),
    )


def unetr_loss(cfg: Config) -> Callable:
    """`loss_fn` of `build_unetr` (`ucf_vit_tpu/tasks.py:259-279`): MONAI's
    DiceCE of the logits against the label volume `[B, 1, *spatial]`."""
    classes = num_classes(cfg)

    def loss_fn(model: torch.nn.Module, batch: Dict[str, torch.Tensor], var_ids=None):
        x, ps, x_seq = unetr_inputs(cfg, batch)
        logits = model(x, seq_ps=ps, x_seq=x_seq, var_ids=var_ids)
        label = batch["label"]
        if label.ndim == logits.ndim - 1:
            label = label[:, None]
        return with_moe_aux(cfg, model, dice_ce_loss(logits, label, classes), {})

    return loss_fn


def sap_inputs(cfg: Config, batch: Dict[str, torch.Tensor]):
    """`(image, seq_ps)` of a SAP batch: the sequence reassembled into the
    sqrt-len image, the model's only input, and its descriptors
    (`ucf_vit_tpu/tasks.py:306-312`). SAP always runs the adaptive path."""
    return (reassemble_sqrt_len(batch["seq"], cfg.sqrt_len, cfg.patch_size, cfg.twoD),
            seq_ps(batch))


def sap_labels(cfg: Config, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The serialized labels `seq_label` `[B, L, p, ...]` reassembled the same
    way, `[B, (sqrt_len * p)^nd]` integer classes: SAP's target, in the
    pseudo-image space its logits live in (`ucf_vit_tpu/tasks.py:314-317`)."""
    lab = batch["seq_label"]
    flat = lab.reshape(lab.shape[0], lab.shape[1], -1).long()
    return reassemble_sqrt_len(flat, cfg.sqrt_len, cfg.patch_size, cfg.twoD)


def build_sap(cfg: Config) -> SAP:
    """`build_sap`'s model (`ucf_vit_tpu/tasks.py:290-298`): adaptive patching
    by the sqrt-len method."""
    return SAP(num_classes=num_classes(cfg), sqrt_len_method=cfg.adaptive_patching,
               **_common_kwargs(cfg))


def sap_loss(cfg: Config) -> Callable:
    """`loss_fn` of `build_sap` (`ucf_vit_tpu/tasks.py:303-320`): `dice_b_loss`
    of the logits of the reassembled image against the reassembled labels,
    one-hot on the class axis."""
    classes = num_classes(cfg)

    def loss_fn(model: torch.nn.Module, batch: Dict[str, torch.Tensor], var_ids=None):
        img, ps = sap_inputs(cfg, batch)
        logits = model(img, seq_ps=ps, var_ids=var_ids)
        onehot = F.one_hot(sap_labels(cfg, batch), classes).movedim(-1, 1).float()
        return with_moe_aux(cfg, model, dice_b_loss(logits, onehot), {})

    return loss_fn


TASKS: Dict[str, Callable[[Config], torch.nn.Module]] = {
    "classification": build_classification,
    "mae": build_mae,
    "diffusion": build_diffusion,
    "unetr": build_unetr,
    "sap": build_sap,
}
# each task's loss from its config
LOSSES: Dict[str, Callable[[Config], Callable]] = {
    "classification": classification_loss,
    "mae": mae_loss,
    "diffusion": diffusion_loss,
    "unetr": unetr_loss,
    "sap": sap_loss,
}


def _check_ported(cfg: Config) -> None:
    if cfg.task not in TASKS:
        raise NotImplementedError(
            f"task {cfg.task!r} is not ported yet (ROADMAP.md, modules to port)"
        )


def build_task(cfg: Config) -> torch.nn.Module:
    """The task's model, with torch's default init (see
    `inference.init_eval_model` for the seeded init)."""
    _check_ported(cfg)
    return TASKS[cfg.task](cfg)


def task_loss(cfg: Config) -> Callable:
    """The task's `loss_fn(model, batch, var_ids=None) -> (loss, aux)`."""
    _check_ported(cfg)
    return LOSSES[cfg.task](cfg)
