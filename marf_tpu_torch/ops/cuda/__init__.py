"""Hand-written Hopper kernels (sources in marf_tpu_torch/csrc/), each beside
its plain PyTorch version.

`LAUNCHES` counts the launches of each kernel in this process, by wrapper
name. A wrapper adds one where it launches its kernel and nowhere else: the
plain versions, which CPU tensors take, do not count. A step captured as a
CUDA graph runs no wrapper when it is replayed: engine/step.py's captured
chunk puts the counts back after the capture, and adds each graph's
recorded launches at each replay.

`presplit_products(k, dims, ...)` is how many products with a pre-split B (the
3xTF32 engine's warp-specialised kernel, TcEngine::run_presplit) one float32
call of kernel `k` enqueues; each float32 wrapper K1-K6 adds that to the
tracer's counter `presplit_products` where it launches its kernel, as it
adds to `LAUNCHES` (so a captured step counts at its capture, not at its
replays).

`KERNELS` gives each train-step kernel's id K1-K6 its wrapper (module and
name; the bf16 entry points share their float32 twin's id). `kernel(k)` is
that wrapper, as its module holds it when the step is made, called inside
the profiler range `marf.<k>`: the range shows in a profile of eager steps
only, as a replayed graph runs no wrapper. It opens around the wrapper, so
a range that a caller puts around the wrapper itself stays the innermost
one, which the profiler credits with the kernel's device operations.
"""

import importlib

import torch

from marf_tpu_torch.utils import trace

LAUNCHES = {
    "fused_train_kernel_warp": 0,  # K1, fused_step.py
    "fused_train_kernel": 0,  # K2, fused_step.py
    "fused_mask_forward": 0,  # K3, fused_mask.py
    "fused_mask_backward_dedup": 0,  # K4, fused_mask.py
    "fused_implicit_train_kernel": 0,  # K5, fused_implicit.py
    "fused_mask_backward_g": 0,  # K6, fused_mask.py
    # K1-K6 at compute_dtype = bfloat16 (their bf16 entry points)
    "fused_train_kernel_warp_bf16": 0,
    "fused_train_kernel_bf16": 0,
    "fused_mask_forward_bf16": 0,
    "fused_mask_backward_dedup_bf16": 0,
    "fused_implicit_train_kernel_bf16": 0,
    "fused_mask_backward_g_bf16": 0,
    "tc_gemm": 0,  # the 3xTF32 GEMM engine alone, tc_gemm.py (tests only, never on the train step)
    "tc_presplit": 0,  # the weights' pre-split alone, tc_gemm.py (tests only)
    "tc_gemm_bf16": 0,  # the bf16 GEMM engine alone, tc_gemm.py (tests only)
    "tc_presplit_bf16": 0,  # its weight conversion alone, tc_gemm.py (tests only)
}

KERNELS = {
    "K1": ("fused_step", "fused_train_kernel_warp"),
    "K2": ("fused_step", "fused_train_kernel"),
    "K3": ("fused_mask", "fused_mask_forward"),
    "K4": ("fused_mask", "fused_mask_backward_dedup"),
    "K5": ("fused_implicit", "fused_implicit_train_kernel"),
    "K6": ("fused_mask", "fused_mask_backward_g"),
}


MAX_GROUP = 16  # mask heads per grouped launch (csrc/mlp_kernels.cuh)


def presplit_products(k: str, dims, heads: int = 1, mask_dims=None) -> int:
    """The pre-split products one float32 call of kernel `k` enqueues, from
    the widths `dims` (input, hidden..., output) of the network whose hidden
    weights it pre-splits: the rgb MLP for K1, K2 and K5 (a forward and a dz
    product per hidden layer, the first layer's dz writing d(encoding)); the
    mask head for K3 (its hidden layers after the first), K4 (those again
    in its recompute, and their ReLU-gated dz products) and K6 (as K4, once
    per group of up to MAX_GROUP of its `heads`: one grouped launch over a
    group's heads is one product). K5 adds its mask heads' forward, from
    their widths `mask_dims`: as K3's, once per group of its `heads`."""
    layers = len(dims) - 1
    groups = -(-heads // MAX_GROUP)
    per = {"K1": 2 * (layers - 1), "K2": 2 * (layers - 1), "K3": layers - 2, "K4": 2 * (layers - 2),
           "K6": groups * 2 * (layers - 2)}
    if k == "K5":
        return max(0, 2 * (layers - 1)) + groups * max(0, len(mask_dims) - 3)
    return max(0, per[k])


def count_presplit(k: str, dims, heads: int = 1, mask_dims=None) -> None:
    """Add a float32 launch of kernel `k`'s pre-split products to the
    tracer's counter `presplit_products`."""
    trace.count("presplit_products", presplit_products(k, dims, heads, mask_dims))


def kernel(k: str):
    """Kernel `k`'s wrapper (`KERNELS`), called inside the range `marf.<k>`."""
    module, name = KERNELS[k]
    fn = getattr(importlib.import_module(f"marf_tpu_torch.ops.cuda.{module}"), name)

    def call(*args, **kwargs):
        with torch.profiler.record_function(f"marf.{k}"):
            return fn(*args, **kwargs)

    return call
