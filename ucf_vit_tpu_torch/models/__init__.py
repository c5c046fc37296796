"""PyTorch models of the port."""

from ucf_vit_tpu_torch.models.mae import MAE
from ucf_vit_tpu_torch.models.vit import VIT

__all__ = ["MAE", "VIT"]
