"""PyTorch models of the port."""

from ucf_vit_tpu_torch.models.ddpm import (
    DDPMSchedule,
    ddpm_sample,
    ddpm_schedule,
    q_sample,
    sample_timesteps,
)
from ucf_vit_tpu_torch.models.diffusion import DiffusionVIT
from ucf_vit_tpu_torch.models.mae import MAE
from ucf_vit_tpu_torch.models.sap import SAP
from ucf_vit_tpu_torch.models.unetr import UNETR
from ucf_vit_tpu_torch.models.vit import VIT

__all__ = ["DDPMSchedule", "DiffusionVIT", "MAE", "SAP", "UNETR", "VIT", "ddpm_sample",
           "ddpm_schedule", "q_sample", "sample_timesteps"]
