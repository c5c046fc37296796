"""The port's data pipeline: its own copies of the non-adaptive parts of
`ucf_vit_tpu/data/` (NIfTI-1 reading, file readers, tiling, shuffling,
batching, load balancing, the DataModule and the cats-vs-dogs loader)."""
