"""The fused implicit-mask train kernel without column dedup (K5,
csrc/fused_implicit.cu) beside its plain PyTorch version.

`fused_implicit_train_kernel` replaces marf_tpu/ops/pallas/fused_mask.py
`fused_implicit_train_kernel` ("kernel A"): the head-blocked mask forward
(per-image heads, or the shared head on all N columns), then the rgb step of
K2 masked by the predicted m, with the UNNORMALIZED rgb cotangent
2 C_r (rgb - t) m^2. It returns sum(m) and sum(m^2 sq) beside the per-point
outputs; the caller scales dcoords, the MLP gradients and the loss by
1 / (3 sum(m)) afterwards (the rgb backward is linear in its cotangent
scale). CUDA tensors launch the kernel (or raise), CPU tensors run
`fused_implicit_train_kernel_reference`. Both take the compute dtype of
marf_tpu's `arch.compute_dtype` (float32 or bfloat16; by default the neural
image's own); in bfloat16 they round where `_implicit_kernel` does: X, the
mask heads' hidden activations and the weights of every product in bf16, m
the float32 sigmoid, and the rgb step as K2's bf16 body rounds it
(fused_step.py's docstring).
"""

from __future__ import annotations

import ctypes

import torch

from marf_tpu_torch.models.neural_image import NeuralImage
from marf_tpu_torch.ops.cuda import LAUNCHES, count_presplit
from marf_tpu_torch.ops.cuda.fused_mask import checked_stacks, fused_mask_forward_reference
from marf_tpu_torch.ops.cuda.fused_step import (
    bind_bf16,
    check_compute_dtype,
    check_tensor,
    fused_train_kernel_reference,
    ptr_array,
    rgb_net_args,
)

SOURCES = ["fused_implicit.cu"]


def _bind(lib: ctypes.CDLL) -> None:
    p, i, pi, pp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    lib.marf_implicit_train_workspace.argtypes = [i, i, i, i, pi, i, pi]
    lib.marf_implicit_train_workspace.restype = ctypes.c_longlong
    lib.marf_implicit_train.argtypes = [i, i, i, i, pi, i, pi, p, p, p, p, p, pp, pp, pp, pp,
                                        p, p, p, p, p, p, pp, pp, p, p]
    lib.marf_implicit_train.restype = ctypes.c_int
    bind_bf16(lib, ["marf_implicit_train", "marf_implicit_train_workspace"])


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    from marf_tpu_torch.ops.cuda._build import load_library

    return load_library("fused_implicit", SOURCES, _bind)


def fused_implicit_train_kernel(net: NeuralImage, stacks: list, coords, x_cf, cw, targets, g2C,
                                compute_dtype: str | None = None):
    """One fused implicit-mask pass over N points (K5).

    Args:
      net: the neural image (weights [out, in], as nn.Linear keeps them).
      stacks: per head, its effective mask layers [(W [out, in], b [out])]
        (mask_w_stack); one list for the shared head, B for per-image heads.
      coords: [2, N] warped coordinates, columns b*HW + i.
      x_cf: [56, N] factored mask inputs in the same column order; head h
        owns columns [h HW, (h+1) HW), HW = N / len(stacks).
      cw: [L] c2f band weights, or None when c2f is off.
      targets: [3, N].
      g2C: 2 * C_r, the unnormalized rgb-loss cotangent scale: a 0-d tensor
        on the device of `coords` (on the CPU also a float). A float would
        be copied from the host at every call, which a captured CUDA graph
        cannot hold, so the kernel's path raises for one.
      compute_dtype: "float32" or "bfloat16" (module docstring); None takes
        net.cfg.compute_dtype.

    Returns:
      (rgb [3, N], m [1, N], sq [1, N], dcoords [2, N], msum 0-d,
       loss_unnorm 0-d = sum(m^2 sq), dmlp [(dW [out, in], db [out])]);
      dcoords and dmlp unnormalized.
    """
    fn = "fused_implicit_train_kernel"
    cdt = check_compute_dtype(fn, compute_dtype or net.cfg.compute_dtype)
    if coords.device.type == "cpu":
        return fused_implicit_train_kernel_reference(net, stacks, coords, x_cf, cw, targets, g2C, cdt)
    if coords.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {coords.device}")
    device = coords.device
    N = coords.shape[1]
    L, dims, c_dims, weights, biases, cw = rgb_net_args(fn, net, cw, device)
    _, mdims, c_mdims = checked_stacks(fn, stacks, x_cf)
    check_tensor(fn, "x_cf", x_cf, (mdims[0], N), device)  # as many columns as coords
    check_tensor(fn, "coords", coords, (2, N), device)
    check_tensor(fn, "targets", targets, (3, N), device)
    if not isinstance(g2C, torch.Tensor) or g2C.shape != () or g2C.device != device:
        raise ValueError(f"{fn}: g2C must be a 0-d tensor on {device}, got {type(g2C).__name__}")
    scal = torch.stack([g2C.to(torch.float32), torch.ones((), dtype=torch.float32, device=device)])

    lib = _library()
    sfx = "_bf16" if cdt == "bfloat16" else ""
    n_heads, n_rgb, n_mask = len(stacks), len(weights), len(stacks[0])
    rgb = torch.empty((3, N), dtype=torch.float32, device=device)
    m = torch.empty((1, N), dtype=torch.float32, device=device)
    sq = torch.empty((1, N), dtype=torch.float32, device=device)
    dcoords = torch.empty((2, N), dtype=torch.float32, device=device)
    msum = torch.empty((), dtype=torch.float32, device=device)
    loss = torch.empty((), dtype=torch.float32, device=device)
    dws = [torch.empty_like(w) for w in weights]
    dbs = [torch.empty_like(b) for b in biases]
    ws = torch.empty(getattr(lib, f"marf_implicit_train{sfx}_workspace")(N, n_heads, L, n_rgb, c_dims, n_mask, c_mdims),
                     dtype=torch.float32, device=device)
    flat = [wb for layers in stacks for wb in layers]
    rc = getattr(lib, f"marf_implicit_train{sfx}")(
        N, n_heads, L, n_rgb, c_dims, n_mask, c_mdims, coords.data_ptr(), x_cf.data_ptr(), cw.data_ptr(),
        targets.data_ptr(), scal.data_ptr(), ptr_array([w for w, _ in flat]), ptr_array([b for _, b in flat]),
        ptr_array(weights), ptr_array(biases), rgb.data_ptr(), m.data_ptr(), sq.data_ptr(), dcoords.data_ptr(),
        msum.data_ptr(), loss.data_ptr(), ptr_array(dws), ptr_array(dbs), ws.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{fn} ({cdt}) kernel launch failed: CUDA error {rc}")
    LAUNCHES[fn + sfx] += 1
    if not sfx:
        count_presplit("K5", dims, n_heads, mdims)
    return rgb, m, sq, dcoords, msum, loss, list(zip(dws, dbs))


def fused_implicit_train_kernel_reference(net: NeuralImage, stacks: list, coords, x_cf, cw, targets, g2C,
                                           compute_dtype: str | None = None):
    """Plain PyTorch version of `fused_implicit_train_kernel`: same arguments
    and returns. Each head's forward on its column block, then K2's plain
    version masked by m with dscale = 2 C_r and no normalization, both at
    the compute dtype."""
    cdt = compute_dtype or net.cfg.compute_dtype
    HW = x_cf.shape[1] // len(stacks)
    m = torch.cat([fused_mask_forward_reference(layers, x_cf[:, h * HW : (h + 1) * HW], cdt)
                   for h, layers in enumerate(stacks)], dim=1)
    one = torch.ones((), dtype=m.dtype, device=m.device)
    # K2's scalars are (2 g inv_sum3, inv_sum3): g = g2C / 2 and inv_sum3 = 1 give (g2C, 1) exactly
    rgb, loss, dmlp, dcoords, sq = fused_train_kernel_reference(net, coords, cw, targets, m, 0.5 * g2C, one, cdt)
    return rgb, m, sq, dcoords, torch.sum(m), loss, dmlp
