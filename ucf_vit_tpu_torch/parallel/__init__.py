"""Data and tensor parallelism (port of `ucf_vit_tpu/parallel/`): the mesh,
the conjugate collectives, sharding and the train step, the replica check."""
