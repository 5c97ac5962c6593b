"""Multi-device training: pixel-sharded data parallel under torch.distributed
(twin of marf_tpu/parallel/). `mesh` holds a rank's place and the packed
collectives, `shard_fused` the sharded train step on the single-card kernels,
`launch` starts the ranks."""
