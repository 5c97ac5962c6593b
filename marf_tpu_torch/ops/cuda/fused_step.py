"""The fused planar train step: (warp +) posenc + MLP forward + masked-MSE
loss + full backward, in one call (csrc/fused_step.cu), beside its plain
PyTorch versions.

`fused_train_kernel_warp` replaces marf_tpu/ops/pallas/fused_step.py
`fused_train_kernel_warp` (K1): it warps the constant (u, v, b) grid by H[b]
in the kernel and returns dH [B, 3, 3]. `fused_train_kernel` replaces
`fused_train_kernel` (K2): it takes the warped coordinates [2, N] and returns
dcoords [2, N], for fused_warp=off and for more than 8 images. The masked rgb
MSE has the analytic cotangent d loss/d rgb = dscale * (rgb - t) * m * m with
dscale = 2 * C * inv_sum3, C = d total / d rgb_loss and inv_sum3 = 1 / (3 *
sum(mask)) (reference model/planar.py:359-390); the caller pulls dH or dcoords
back to the warp with autograd.

Each wrapper takes the compute dtype of marf_tpu's `arch.compute_dtype`
(float32 or bfloat16; by default the neural image's own) and dispatches on
the device of its inputs: CUDA tensors launch the kernel of that dtype (or
raise), CPU tensors run its `*_reference` plain version. In bfloat16 both
round where the Pallas kernels' cdtype does (marf_tpu/ops/pallas/
fused_step.py _stack_fwd, _stack_bwd): the encoding, the hidden activations
and the weights of every product in bf16; the output cotangent through the
sigmoid and each ReLU-gated dz rounded to bf16 before they feed a product;
every product and sum, the bias, the loss, d(encoding) and the posenc and
warp VJPs in float32.
"""

from __future__ import annotations

import ctypes

import torch

from marf_tpu_torch.models.neural_image import COMPUTE_DTYPES, NeuralImage, encode_coords_cf
from marf_tpu_torch.ops.cuda import LAUNCHES, count_presplit

# images per K1 call: the kernel keeps one dH accumulator per image in
# registers (MAX_IMAGES in csrc/fused_step.cu, which rejects a larger B)
MAX_IMAGES = 8


def _bind(lib: ctypes.CDLL) -> None:
    p, i, pi, pp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    lib.marf_fused_step_warp_workspace.argtypes = [i, i, i, i, pi]
    lib.marf_fused_step_warp_workspace.restype = ctypes.c_longlong
    lib.marf_fused_step_warp.argtypes = [i, i, i, i, pi, p, p, p, p, p, p, pp, pp, p, p, p, pp, pp, p, p, p]
    lib.marf_fused_step_warp.restype = ctypes.c_int
    lib.marf_fused_step_coords_workspace.argtypes = [i, i, i, pi]
    lib.marf_fused_step_coords_workspace.restype = ctypes.c_longlong
    lib.marf_fused_step_coords.argtypes = [i, i, i, pi, p, p, p, p, p, pp, pp, p, p, p, pp, pp, p, p, p]
    lib.marf_fused_step_coords.restype = ctypes.c_int
    bind_bf16(lib, ["marf_fused_step_warp", "marf_fused_step_warp_workspace", "marf_fused_step_coords",
                    "marf_fused_step_coords_workspace"])


def bind_bf16(lib: ctypes.CDLL, names: list) -> None:
    """Give each float32 entry point's bf16 twin (marf_x -> marf_x_bf16,
    marf_x_workspace -> marf_x_bf16_workspace) the same C signature."""
    for name in names:
        stem, tail = (name[: -len("_workspace")], "_workspace") if name.endswith("_workspace") else (name, "")
        src, dst = getattr(lib, name), getattr(lib, f"{stem}_bf16{tail}")
        dst.argtypes, dst.restype = src.argtypes, src.restype


SOURCES = ["fused_step.cu"]


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    from marf_tpu_torch.ops.cuda._build import load_library

    return load_library("fused_step", SOURCES, _bind)


def _scalars(g_loss_scale, inv_sum3: torch.Tensor) -> torch.Tensor:
    """[dscale, lscale] = [2 * C * inv_sum3, inv_sum3] on the device."""
    return torch.stack([2.0 * g_loss_scale * inv_sum3, inv_sum3])


def check_compute_dtype(fn: str, compute_dtype: str) -> str:
    """Raise unless `compute_dtype` is one the kernels take."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"{fn}: compute_dtype={compute_dtype!r} is not one of {COMPUTE_DTYPES}")
    return compute_dtype


def check_tensor(fn: str, name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous float32 tensor of `shape` on `device`."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous float32 {shape} tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


def ptr_array(ts) -> ctypes.Array:
    """A C array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def fused_train_kernel_warp(net: NeuralImage, grid_b, H, cw, targets, masks, g_loss_scale, inv_sum3,
                            compute_dtype: str | None = None):
    """One fused train-step pass over N points, warp in the kernel (K1).

    Args:
      net: the neural image (weights [out, in], as nn.Linear keeps them).
      grid_b: [3, N] float32 rows (u, v, b): the unwarped normalized grid and
        each column's image index (columns b*HW + i). A column whose b lies
        outside [0, B) is inert: zero coordinates, no dH.
      H: [B, 3, 3] homographies (sl3_to_SL3 of the warp), B <= 8.
      cw: [L] c2f band weights, or None when c2f is off.
      targets: [3, N]; masks: [1, N] (ones when masks are off, or the
        predicted occlusion probability of the implicit-mask model).
      g_loss_scale: d total / d rgb_loss (float or 0-d tensor).
      inv_sum3: 0-d tensor 1 / (3 * sum(mask)).
      compute_dtype: "float32" or "bfloat16" (module docstring); None takes
        net.cfg.compute_dtype.

    Returns:
      (rgb [3, N], rgb_loss 0-d, dparams [(dW [out, in], db [out]) per layer],
       dH [B, 3, 3], sq [1, N] raw per-point squared error).
    """
    cdt = check_compute_dtype("fused_train_kernel_warp", compute_dtype or net.cfg.compute_dtype)
    if grid_b.device.type == "cpu":
        return fused_train_kernel_warp_reference(net, grid_b, H, cw, targets, masks, g_loss_scale, inv_sum3, cdt)
    if grid_b.device.type != "cuda":
        raise ValueError(f"fused_train_kernel_warp: unsupported device {grid_b.device}")
    return _launch(net, None, grid_b, H, cw, targets, masks, _scalars(g_loss_scale, inv_sum3), cdt)


def fused_train_kernel(net: NeuralImage, coords, cw, targets, masks, g_loss_scale, inv_sum3,
                       compute_dtype: str | None = None):
    """One fused train-step pass over N given warped coordinates (K2).

    Args as `fused_train_kernel_warp`, with coords [2, N] in place of the grid
    and H; any number of images.

    Returns:
      (rgb [3, N], rgb_loss 0-d, dparams [(dW [out, in], db [out]) per layer],
       dcoords [2, N], sq [1, N] raw per-point squared error).
    """
    cdt = check_compute_dtype("fused_train_kernel", compute_dtype or net.cfg.compute_dtype)
    if coords.device.type == "cpu":
        return fused_train_kernel_reference(net, coords, cw, targets, masks, g_loss_scale, inv_sum3, cdt)
    if coords.device.type != "cuda":
        raise ValueError(f"fused_train_kernel: unsupported device {coords.device}")
    return _launch(net, coords, None, None, cw, targets, masks, _scalars(g_loss_scale, inv_sum3), cdt)


def rgb_net_args(fn: str, net: NeuralImage, cw, device: torch.device):
    """The rgb pipeline's network arguments, checked: (L, dims, C dims array,
    weights, biases, cw), with cw ones [max(L, 1)] when c2f is off."""
    cfg = net.cfg
    if cfg.skip:
        raise NotImplementedError(f"{fn}: the fused kernel has no skip re-concat (arch.skip)")
    L = int(cfg.posenc_L or 0)
    layers = list(net.layers)
    dims = [cfg.input_dim] + [layer.out_features for layer in layers]
    if len(layers) < 2 or dims[-1] != 3 or dims[-2] > 1024 or L > 16:
        raise ValueError(f"{fn}: unsupported shape (dims={dims}, L={L})")
    if cw is None:
        cw = torch.ones(max(L, 1), dtype=torch.float32, device=device)
    check_tensor(fn, "cw", cw, (max(L, 1),), device)
    weights = [layer.weight.detach() for layer in layers]
    biases = [layer.bias.detach() for layer in layers]
    for li, (w, b) in enumerate(zip(weights, biases)):
        check_tensor(fn, f"weight[{li}]", w, (dims[li + 1], dims[li]), device)
        check_tensor(fn, f"bias[{li}]", b, (dims[li + 1],), device)
    return L, dims, (ctypes.c_int * len(dims))(*dims), weights, biases, cw


def _launch(net, coords, grid_b, H, cw, targets, masks, scal, compute_dtype):
    """K2 when `coords` is given, else K1; the bf16 entry points under
    compute_dtype = bfloat16."""
    fn = "fused_train_kernel" if coords is not None else "fused_train_kernel_warp"
    stream_in = coords if coords is not None else grid_b
    device = stream_in.device
    N = stream_in.shape[1]
    L, dims, c_dims, weights, biases, cw = rgb_net_args(fn, net, cw, device)
    B = H.shape[0] if coords is None else 0
    if coords is None and not 1 <= B <= MAX_IMAGES:
        raise ValueError(f"{fn}: unsupported number of images B={B} (1 to {MAX_IMAGES})")
    check = lambda name, t, shape: check_tensor(fn, name, t, shape, device)
    if coords is not None:
        check("coords", coords, (2, N))
    else:
        check("grid_b", grid_b, (3, N))
        check("H", H, (B, 3, 3))
    check("targets", targets, (3, N))
    check("masks", masks, (1, N))
    check("scalars", scal, (2,))

    lib = _library()
    sfx = "_bf16" if compute_dtype == "bfloat16" else ""
    n_layers = len(weights)
    rgb = torch.empty((3, N), dtype=torch.float32, device=device)
    sq = torch.empty((1, N), dtype=torch.float32, device=device)
    loss = torch.empty((), dtype=torch.float32, device=device)
    dws = [torch.empty_like(w) for w in weights]
    dbs = [torch.empty_like(b) for b in biases]
    stream = torch.cuda.current_stream(device).cuda_stream
    common = (targets.data_ptr(), masks.data_ptr(), scal.data_ptr(), ptr_array(weights), ptr_array(biases),
              rgb.data_ptr(), sq.data_ptr(), loss.data_ptr(), ptr_array(dws), ptr_array(dbs))
    if coords is not None:
        dout = torch.empty((2, N), dtype=torch.float32, device=device)
        n_ws = getattr(lib, f"marf_fused_step_coords{sfx}_workspace")(N, L, n_layers, c_dims)
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
        rc = getattr(lib, f"marf_fused_step_coords{sfx}")(N, L, n_layers, c_dims, coords.data_ptr(), cw.data_ptr(),
                                                          *common, dout.data_ptr(), ws.data_ptr(), stream)
    else:
        dout = torch.empty((B, 3, 3), dtype=torch.float32, device=device)
        n_ws = getattr(lib, f"marf_fused_step_warp{sfx}_workspace")(N, B, L, n_layers, c_dims)
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
        rc = getattr(lib, f"marf_fused_step_warp{sfx}")(N, B, L, n_layers, c_dims, grid_b.data_ptr(), H.data_ptr(),
                                                        cw.data_ptr(), *common, dout.data_ptr(), ws.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{fn} ({compute_dtype}) kernel launch failed: CUDA error {rc}")
    LAUNCHES[fn + sfx] += 1
    if not sfx:
        count_presplit("K2" if coords is not None else "K1", dims)
    return rgb, loss, list(zip(dws, dbs)), dout, sq


def _mlp_loss_and_grads(net, coords, cw, targets, masks, scal, extra):
    """posenc + MLP + loss partial under autograd from coords [2, N]; the
    gradients of the weights, the biases and `extra` pulled back from rgb
    with the cotangent dscale * (rgb - t) * m * m."""
    weights = [layer.weight.detach().requires_grad_(True) for layer in net.layers]
    biases = [layer.bias.detach().requires_grad_(True) for layer in net.layers]
    feat = encode_coords_cf(coords, net.cfg.posenc_L, cw)
    last = len(weights) - 1
    for li, (w, b) in enumerate(zip(weights, biases)):
        feat = torch.addmm(b[:, None], w, feat)
        if li != last:
            feat = torch.relu(feat)
    rgb = torch.sigmoid(feat)
    diff = rgb - targets
    diff_m = diff * masks
    loss = torch.sum(diff_m * diff_m) * scal[1]
    grads = torch.autograd.grad(rgb, [*weights, *biases, extra], scal[0] * diff_m * masks)
    n = len(weights)
    sq = torch.sum(diff * diff, dim=0, keepdim=True)
    return rgb.detach(), loss.detach(), list(zip(grads[:n], grads[n : 2 * n])), grads[-1], sq.detach()


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest even), in t's own dtype: a float64
    run of a bf16 plain version rounds where the kernel does and nowhere else."""
    return t.to(torch.bfloat16).to(t.dtype)


def _mlp_loss_and_grads_bf16(net, coords, cw, targets, masks, scal, extra):
    """`_mlp_loss_and_grads` at compute_dtype = bfloat16, with the Pallas
    kernels' rounding (module docstring) written out: the backward is the
    kernels' (each d rounded before it feeds a product, dW and db summed from
    the rounded values), not autograd's. Only d(encoding) is pulled back to
    `extra` by autograd, through the posenc (and the warp)."""
    weights = [bf16_round(layer.weight.detach()) for layer in net.layers]
    biases = [layer.bias.detach() for layer in net.layers]
    enc = encode_coords_cf(coords, net.cfg.posenc_L, cw)
    acts = [bf16_round(enc.detach())]
    last = len(weights) - 1
    for li, (w, b) in enumerate(zip(weights, biases)):
        z = torch.addmm(b[:, None], w, acts[li])
        if li != last:
            acts.append(bf16_round(torch.relu(z)))
    rgb = torch.sigmoid(z)
    diff = rgb - targets
    diff_m = diff * masks
    loss = torch.sum(diff_m * diff_m) * scal[1]
    d = bf16_round(scal[0] * diff_m * masks * rgb * (1.0 - rgb))
    grads = [None] * len(weights)
    for li in range(last, -1, -1):
        grads[li] = (d @ acts[li].T, torch.sum(d, dim=1))
        da = weights[li].T @ d
        if li > 0:
            d = bf16_round(da * (acts[li] > 0))
    (dextra,) = torch.autograd.grad(enc, extra, da)
    sq = torch.sum(diff * diff, dim=0, keepdim=True)
    return rgb, loss, grads, dextra, sq


def _loss_and_grads(compute_dtype: str):
    return _mlp_loss_and_grads_bf16 if compute_dtype == "bfloat16" else _mlp_loss_and_grads


def fused_train_kernel_warp_reference(net: NeuralImage, grid_b, H, cw, targets, masks, g_loss_scale, inv_sum3,
                                      compute_dtype: str | None = None):
    """Plain PyTorch version of `fused_train_kernel_warp`: same arguments and
    returns. The warp, posenc, MLP and loss partial run under autograd (in
    bfloat16, the MLP's backward as the kernel rounds it)."""
    B = H.shape[0]
    scal = _scalars(g_loss_scale, inv_sum3)
    with torch.enable_grad():
        Hd = H.detach().requires_grad_(True)
        u, v, bidx = grid_b[0], grid_b[1], grid_b[2].long()
        valid = ((bidx >= 0) & (bidx < B)).to(torch.float32)
        hp = Hd.reshape(B, 9)[bidx.clamp(0, B - 1)] * valid[:, None]  # [N, 9] per-point H
        rden = 1.0 / (hp[:, 8] + hp[:, 6] * u + hp[:, 7] * v + 1e-8)
        x = (hp[:, 0] * u + hp[:, 1] * v + hp[:, 2]) * rden
        y = (hp[:, 3] * u + hp[:, 4] * v + hp[:, 5]) * rden
        loss_and_grads = _loss_and_grads(compute_dtype or net.cfg.compute_dtype)
        return loss_and_grads(net, torch.stack([x, y]), cw, targets, masks, scal, Hd)


def fused_train_kernel_reference(net: NeuralImage, coords, cw, targets, masks, g_loss_scale, inv_sum3,
                                 compute_dtype: str | None = None):
    """Plain PyTorch version of `fused_train_kernel`: same arguments and
    returns. Posenc, MLP and loss partial run under autograd (in bfloat16,
    the MLP's backward as the kernel rounds it)."""
    scal = _scalars(g_loss_scale, inv_sum3)
    with torch.enable_grad():
        c = coords.detach().requires_grad_(True)
        return _loss_and_grads(compute_dtype or net.cfg.compute_dtype)(net, c, cw, targets, masks, scal, c)
