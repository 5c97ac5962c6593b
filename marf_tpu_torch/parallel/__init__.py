"""Multi-device training: pixel-sharded data parallel under torch.distributed
(twin of marf_tpu/parallel/). `mesh` holds a rank's place and the packed
collectives, `sharded` the rank body on a 1-D or 2-D mesh, `launch` starts
the ranks."""
