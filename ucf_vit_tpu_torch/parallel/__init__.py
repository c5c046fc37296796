"""The train step (port of `ucf_vit_tpu/parallel/`, on one device)."""
