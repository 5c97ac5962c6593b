"""Hand-written Hopper kernels (sources in marf_tpu_torch/csrc/), each beside
its plain PyTorch version."""
