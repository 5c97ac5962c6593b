"""Pure tensor ops (torch twins of marf_tpu.ops); ops.cuda holds the kernels."""
