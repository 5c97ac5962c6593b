"""marf_tpu_torch — the PyTorch / CUDA port of marf_tpu for NVIDIA Hopper.

Mirrors marf_tpu's layout so each module's counterpart is easy to find:

  marf_tpu_torch.utils   — options (CLI DSL, yaml, device, seeds), console
                           log and iteration timer, TensorBoard scalars and
                           images, vis helpers, JAX<->torch parameter
                           transfer, the reference torch-init loader
  marf_tpu_torch.ops     — grids, Lie/expm, homography, warps, posenc,
                           filters, losses; ops.cuda holds the hand-written
                           Hopper kernels (sources under csrc/)
  marf_tpu_torch.models  — the neural-image MLP and the planar graph
  marf_tpu_torch.data    — host-side on-disk loader and synthetic dataset
  marf_tpu_torch.engine  — train step (fused kernel or autograd), the
                           optimizers, checkpoints and the five-phase trainer
  marf_tpu_torch.train, marf_tpu_torch.sweep — the CLI entry points

The package imports torch and never jax, and imports no module of marf_tpu;
its yaml files (marf_tpu_torch/configs) are byte-equal copies of marf_tpu's.
"""

__version__ = "0.1.0"
