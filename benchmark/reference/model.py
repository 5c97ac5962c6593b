"""The planar model, its loss and its Adam steps, in plain float32 PyTorch.

BARF's planar image alignment (Lin et al., ICCV 2021) with MARF's masks and
edge loss: per image an 8-vector h of sl(3) coordinates, H = expm(A(h)),
the patch grid warped by H and perspective-divided, a coordinate MLP over
[x, y, sin/cos(2^k pi x), sin/cos(2^k pi y)] with BARF's coarse-to-fine
band weights, ReLU hidden layers, a sigmoid output. The loss (MARF
model/planar.py:355-380): the masked MSE sum(((pred - t) m)^2) / (3 sum m),
the edge term (the blurred Sobel magnitude of the prediction, no gradient,
against the photos' edges, masked by the eroded masks or the learned mask),
the learned masks' counterweight mean((1 - m)^2), the render mix
(1 - alpha) rgb + 0.5 mask + alpha edge with alpha linear over max_iter,
and the total sum_k 10^w_k term_k. Learned masks are Ha-NeRF's heads (Chen
et al., CVPR 2022): an MLP 426 -> 256 x 4 -> 1 over the photo's RGB
embedded by `image.long()` rows of the view embedding and the uv grid's
[x, sin(f x), cos(f x)] embedding, f = 2^0 .. 2^9; one head per image or
one shared. Adam with bias correction, one rate per group (MLP, warp, mask
heads); warp 0 re-zeroed after each update (fix_first).

Departures: the matrix exponential is torch.linalg.matrix_exp (MARF takes
its own Pade); the fix modes of the port's `tpu` block other than the
defaults are not modelled (`check_options` raises).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from benchmark.reference.data import edge_map

EPS_DIV = 1e-8
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
HANERF_FREQS = 2.0 ** np.linspace(0, 9, 10)


def check_options(options: dict) -> None:
    tpu = options.get("tpu") or {}
    if tpu.get("differentiable_edges") or int(tpu.get("mask_quantize_levels", 1)) != 1:
        raise NotImplementedError("the reference models the reference-faithful defaults of the tpu block only")
    if (options.get("optim") or {}).get("algo", "Adam") != "Adam" or (options["optim"].get("apply_sched")):
        raise NotImplementedError("the reference steps Adam at constant rates")
    if (options.get("optim") or {}).get("train_view_embedding"):
        raise NotImplementedError("the reference keeps the view embedding frozen")


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products exactly (TF32 off), or in TF32 for the control."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def pixel_grid(options: dict, crop: bool, device) -> torch.Tensor:
    """[h w, 2] (x, y) pixel centres in [-1, 1], scaled by H / max and W /
    max, over the centred patch (crop) or the whole canvas (MARF warp.py:33-68)."""
    H, W = options["H"], options["W"]
    if crop:
        ph, pw = options["patch_H"], options["patch_W"]
        ys = torch.arange(H // 2 - ph // 2, H // 2 + ph // 2, dtype=torch.float32, device=device)
        xs = torch.arange(W // 2 - pw // 2, W // 2 + pw // 2, dtype=torch.float32, device=device)
    else:
        ys = torch.arange(H, dtype=torch.float32, device=device)
        xs = torch.arange(W, dtype=torch.float32, device=device)
    y = ((ys + 0.5) / H * 2 - 1) * (H / max(H, W))
    x = ((xs + 0.5) / W * 2 - 1) * (W / max(H, W))
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)


def homographies(warp: torch.Tensor) -> torch.Tensor:
    """[B, 8] -> [B, 3, 3]: expm of [[h5, h3, h1], [h4, -h5-h6, h2], [h7, h8, h6]]."""
    h1, h2, h3, h4, h5, h6, h7, h8 = warp.unbind(-1)
    A = torch.stack([torch.stack([h5, h3, h1], -1), torch.stack([h4, -h5 - h6, h2], -1),
                     torch.stack([h7, h8, h6], -1)], -2)
    return torch.linalg.matrix_exp(A)


def c2f_weights(progress: torch.Tensor, c2f, L: int) -> torch.Tensor:
    """BARF's band weights (1 - cos(clamp(a - k, 0, 1) pi)) / 2, a =
    (progress - start) / (end - start) L."""
    a = (progress - c2f[0]) / (c2f[1] - c2f[0]) * L
    k = torch.arange(L, dtype=torch.float32, device=progress.device)
    return (1 - torch.cos(torch.clamp(a - k, 0.0, 1.0) * math.pi)) / 2


def encode(xy: torch.Tensor, options: dict, progress: torch.Tensor) -> torch.Tensor:
    """[P, 2] -> [P, 2 + 4L]: x, y, sin(x f_k), cos(x f_k), sin(y f_k), cos(y f_k)."""
    arch = options["arch"]
    if not arch.get("posenc"):
        return xy
    L = int(arch["posenc"]["L_2D"])
    freqs = torch.tensor([2.0**k * math.pi for k in range(L)], dtype=torch.float32, device=xy.device)
    w = c2f_weights(progress, options["barf_c2f"], L) if options.get("barf_c2f") else torch.ones_like(freqs)
    parts = [xy]
    for c in range(2):
        s = xy[:, c : c + 1] * freqs
        parts += [torch.sin(s) * w, torch.cos(s) * w]
    return torch.cat(parts, dim=1)


def mlp(params: dict, prefix: str, x: torch.Tensor, n_layers: int, skip=(), x0=None) -> torch.Tensor:
    """[P, in] -> [P, out]: ReLU hidden layers, sigmoid output."""
    for i in range(n_layers):
        if i in skip:
            x = torch.cat([x, x0], dim=1)
        x = x @ params[f"{prefix}.{i}.weight"].T + params[f"{prefix}.{i}.bias"]
        x = torch.relu(x) if i < n_layers - 1 else torch.sigmoid(x)
    return x


def neural_image(params: dict, options: dict, xy: torch.Tensor, progress: torch.Tensor) -> torch.Tensor:
    """[P, 2] coordinates -> [P, 3] rgb."""
    feats = encode(xy, options, progress)
    n = len(options["arch"]["layers"]) - 1
    return mlp(params, "mlp", feats, n, tuple(options["arch"].get("skip") or ()), feats)


def hanerf_embedding(xy: torch.Tensor) -> torch.Tensor:
    """[P, 2] -> [P, 42]: [x, sin(f_0 x), cos(f_0 x), ..., sin(f_9 x), cos(f_9 x)]."""
    parts = [xy]
    for f in HANERF_FREQS:
        parts += [torch.sin(float(f) * xy), torch.cos(float(f) * xy)]
    return torch.cat(parts, dim=1)


def mask_inputs(embedding: torch.Tensor, image: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """[h w, 426] of one photo [3, h, w]: embedding rows at image.long() per
    channel (r, g, b), then the uv embedding."""
    idx = image.long().reshape(3, -1).T  # [h w, 3]
    return torch.cat([embedding[idx].reshape(idx.shape[0], -1), uv], dim=1)


def masked_mse(pred, target, mask=None):
    if mask is None:
        return torch.mean((pred - target) ** 2)
    return torch.sum(((pred - target) * mask) ** 2) / (torch.sum(mask) * 3)


def loss_terms(params: dict, data: dict, options: dict, step: int, keep=None) -> dict:
    """The loss terms at 0-based step `step` ({"rgb", "edge", "mask",
    "render", "all"}, 0-d tensors). `keep` (a number of images) leaves the
    later images out and takes every mean over the rest: a planted fault."""
    B = int(options["batch_size"]) if keep is None else int(keep)
    h, w = (options["patch_H"], options["patch_W"]) if options.get("use_cropped_images", True) else (
        options["H"], options["W"])
    dev = params["warp"].device
    max_iter = int(options["max_iter"])
    s = torch.tensor(float(step), dtype=torch.float32, device=dev)
    progress = s / max_iter
    grid = pixel_grid(options, options.get("use_cropped_images", True), dev)  # [h w, 2]
    Hs = homographies(params["warp"][:B])
    hom = torch.cat([grid, torch.ones_like(grid[:, :1])], dim=1)  # [h w, 3]
    warped = torch.einsum("bij,pj->bpi", Hs, hom)  # [B, h w, 3]
    xy = warped[..., :2] / (warped[..., 2:] + EPS_DIV)
    rgb = neural_image(params, options, xy.reshape(-1, 2), progress)  # [B h w, 3]
    rgb_map = rgb.reshape(B, h, w, 3).permute(0, 3, 1, 2)
    target = data["rgb"][:B]
    m_map = None
    if options.get("use_implicit_mask"):
        uv = hanerf_embedding(grid)
        single = bool(options.get("build_single_masks"))
        ms = [mlp(params, f"mask.{b if single else 0}", mask_inputs(params["embedding"], target[b], uv), 5)
              for b in range(B)]
        m_map = torch.stack(ms).reshape(B, h, w, 1).permute(0, 3, 1, 2)
    zero = torch.zeros((), device=dev)
    alpha = (options["alpha_initial"] + (options["alpha_final"] - options["alpha_initial"]) * progress
             if options.get("use_edges", True) else zero)
    if m_map is not None:
        rgb_mask = m_map
    else:
        rgb_mask = data["masks"][:B] if options.get("use_masks", True) else None
    terms = {"rgb": masked_mse(rgb_map, target, rgb_mask)}
    if options.get("use_edges", True):
        with torch.no_grad():
            edge_pred = edge_map(rgb_map.detach())
        edge_mask = m_map if m_map is not None else data["masks_eroded"][:B]
        terms["edge"] = masked_mse(edge_pred, data["edges"][:B], edge_mask)
    else:
        terms["edge"] = zero
    terms["mask"] = torch.mean((1 - m_map) ** 2) if m_map is not None else zero
    terms["render"] = (1 - alpha) * terms["rgb"] + 0.5 * terms["mask"] + alpha * terms["edge"]
    lw = options["loss_weight"]
    total = zero
    for k in ("render", "rgb", "mask", "edge"):
        if lw.get(k) is not None:
            total = total + 10.0 ** float(lw[k]) * terms[k]
    terms["all"] = total
    return terms


def group_lr(options: dict, leaf: str) -> float:
    optim = options["optim"]
    lr = float(optim["lr"])
    if leaf == "warp":
        return float(optim.get("lr_warp", lr))
    if leaf.startswith("mask."):
        return float(optim.get("lr_mask", lr))
    return lr


def train(init: dict, data: dict, options: dict, steps: int, tf32: bool = False, keep=None, start: int = 0) -> dict:
    """`steps` Adam steps from `init` (copied), the schedules (c2f weights,
    alpha) read at 0-based steps start, start + 1, ...; Adam's own count
    from 1. Returns {"losses": [{term: float}] per step, "grads": {leaf:
    step 1's gradient}, "params": {leaf: after the last step}}; the frozen
    embedding takes no gradient."""
    check_options(options)
    params = {k: v.detach().clone() for k, v in init.items()}
    trained = [k for k in params if k != "embedding"]
    m = {k: torch.zeros_like(params[k]) for k in trained}
    v = {k: torch.zeros_like(params[k]) for k in trained}
    b1, b2 = ADAM_BETAS
    out = {"losses": [], "grads": None}
    with precision(tf32):
        for t in range(1, steps + 1):
            for k in trained:
                params[k].requires_grad_(True)
            terms = loss_terms(params, data, options, start + t - 1, keep)
            grads = torch.autograd.grad(terms["all"], [params[k] for k in trained], allow_unused=True)
            grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(trained, grads)}
            out["losses"].append({k: float(x.detach()) for k, x in terms.items()})
            if t == 1:
                out["grads"] = {k: g.detach().clone() for k, g in grads.items()}
            with torch.no_grad():
                for k in trained:
                    p, g = params[k].detach(), grads[k]
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[k] / (1 - b2**t)).sqrt() + ADAM_EPS
                    params[k] = p - group_lr(options, k) * (m[k] / (1 - b1**t)) / denom
                if options["warp"].get("fix_first", True):
                    params["warp"][0] = 0.0
    out["params"] = {k: p.detach() for k, p in params.items()}
    return out


def render(params: dict, options: dict, it: int, tf32: bool = False) -> np.ndarray:
    """The full-canvas frame at iteration `it` as MARF writes it: [H, W, 3]
    uint8 of the MLP at progress max(it - 1, 0) / max_iter."""
    dev = params["mlp.0.weight"].device
    with precision(tf32), torch.no_grad():
        progress = torch.tensor(max(it - 1, 0), dtype=torch.float32, device=dev) / int(options["max_iter"])
        rgb = neural_image(params, options, pixel_grid(options, False, dev), progress)
    img = rgb.reshape(options["H"], options["W"], 3).clamp(0, 1).cpu().numpy()
    return (img * 255).astype(np.uint8)
