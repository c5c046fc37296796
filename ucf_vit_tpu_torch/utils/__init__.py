"""Losses, metrics and the optimizer (port of `ucf_vit_tpu/utils/`)."""
