"""The train step and the chunked loop (twin of marf_tpu/engine/step.py).

Two gradient paths compute the same update:
  - the autograd step (`graph_forward` + `graph_loss` + backward), and
  - the fused step: one call of the K1 kernel (ops/cuda/fused_step.py)
    returns the MLP gradients and dH; dH is pulled back to the warp through
    the torch expm with `torch.autograd.grad`. No autograd runs through the MLP.
Then Adam with per-group learning rates (MLP at optim.lr, warp at
optim.lr_warp; reference model/planar.py:86-104), Homography_Error from the
post-update warp, and the fix_first re-zero of warp 0 (reference
model/planar.py:156-158), in that order.

Per-step constants (the flat target/mask/grid streams, 1/(3 sum m), and the
progress / alpha / c2f schedules for every step) are built once when the
step is made, so a step reads no value back to the host: its metrics stay on
the device until `run_chunk` reads a whole chunk at once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from marf_tpu_torch.models.planar import Graph, PlanarConfig, graph_forward, graph_loss, use_fused_step, use_lazy_metrics
from marf_tpu_torch.ops.filters import compute_edges
from marf_tpu_torch.ops.lie import sl3_to_SL3
from marf_tpu_torch.ops.losses import (
    alpha_schedule,
    check_finite,
    homography_error,
    mse,
    psnr_from_rgb_loss,
    render_loss,
    summarize_loss,
)
from marf_tpu_torch.ops.posenc import barf_c2f_weights
from marf_tpu_torch.utils.console import log


def _lr_lambda(optim_opt: dict, base_lr: float, max_iter: int):
    """Per-step LR factor from the reference's `optim.sched`, or None.

    The reference builds a scheduler but never steps it, so a configured
    schedule stays inert unless `optim.apply_sched` is set (fix mode):
    StepLR: gamma^(step // steps); ExponentialLR: gamma^step, gamma derived
    from optim.lr_end over max_iter when not given."""
    sched = optim_opt.get("sched") or {}
    stype = sched.get("type")
    if not stype or not optim_opt.get("apply_sched"):
        return None
    if stype == "StepLR":
        steps, gamma = int(sched["steps"]), float(sched.get("gamma", 0.1))
        return lambda count: gamma ** (count // steps)
    if stype == "ExponentialLR":
        if sched.get("gamma") is not None:
            gamma = float(sched["gamma"])
        else:
            gamma = (float(optim_opt["lr_end"]) / base_lr) ** (1.0 / max_iter)
        return lambda count: gamma**count
    raise ValueError(f"unsupported scheduler type: {stype}")


def make_optimizer(graph: Graph, optim_opt: dict, max_iter: int):
    """Adam with one learning rate per group and torch's default
    hyperparameters (the update optax.adam computes). Returns
    (optimizer, LR scheduler or None); step the scheduler once per step."""
    lr = float(optim_opt["lr"])
    groups = [
        {"params": list(graph.neural_image.parameters()), "lr": lr},
        {"params": [graph.warp], "lr": float(optim_opt.get("lr_warp") or lr)},
    ]
    algo = optim_opt.get("algo", "Adam")
    if algo != "Adam":
        raise NotImplementedError(f"optim.algo={algo!r} is not ported; the port runs Adam (ROADMAP.md)")
    opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    if (optim_opt.get("sched") or {}).get("type") and not optim_opt.get("apply_sched"):
        log.warn(
            "optim.sched is configured but inert (reference-faithful: the reference never steps its "
            "scheduler); set optim.apply_sched=true to apply it for real"
        )
    lambdas = [_lr_lambda(optim_opt, g["lr"], max_iter) for g in groups]
    if all(fn is None for fn in lambdas):
        return opt, None
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambdas)


def make_train_step(cfg: PlanarConfig, graph: Graph, optimizer, data: dict, scheduler=None, use_homographies: bool = True):
    """Build step_fn(step: int, heavy: bool) -> metrics dict of 0-d tensors.

    Metric timing matches the reference's `log_scalars` call site
    (model/planar.py:199-201): loss terms and PSNR from the pre-update
    forward, Homography_Error from the post-update warp before the fix_first
    re-zero. `heavy` marks the chunk-final step: with lazy metrics, only it
    computes the metric-only work and the other rows report 0.
    """
    device = graph.warp.device
    fused = use_fused_step(cfg, device)
    lazy = use_lazy_metrics(cfg, device)
    h, w = cfg.map_hw
    B = cfg.batch_size
    HW = h * w
    N = B * HW
    steps = torch.arange(cfg.max_iter + 1, device=device)
    progress = steps.to(torch.float32) / cfg.max_iter
    zero = torch.zeros((), dtype=torch.float32, device=device)
    alphas = alpha_schedule(steps, cfg.max_iter, cfg.alpha_initial, cfg.alpha_final) if cfg.use_edges else zero.expand(len(steps))
    gt_hom = data.get("gt_hom") if use_homographies else None
    log.info(f"train step: {'fused (K1)' if fused else 'autograd'} on {device}")

    if fused:
        from marf_tpu_torch.ops.cuda.fused_step import fused_train_kernel_warp

        arch = cfg.arch
        cws = barf_c2f_weights(progress, tuple(arch.barf_c2f), arch.posenc_L) if (arch.posenc_L and arch.barf_c2f is not None) else None
        targets_cf = data["rgb"].permute(1, 0, 2, 3).reshape(3, N).contiguous()
        if cfg.use_masks and data.get("masks") is not None:
            masks_cf = data["masks"].permute(1, 0, 2, 3).reshape(1, N).contiguous()
        else:
            masks_cf = torch.ones((1, N), dtype=torch.float32, device=device)
        inv_sum3 = 1.0 / (torch.sum(masks_cf) * 3.0)
        # the kernel's (u, v, b) stream: the unwarped grid repeated per image
        grid_b = torch.cat(
            [graph.grid.T.repeat(1, B), torch.arange(B, dtype=torch.float32, device=device).repeat_interleave(HW)[None]]
        ).contiguous()
        edges_cf = data["edges"].permute(1, 0, 2, 3).contiguous() if cfg.use_edges else None
        me = data.get("masks_eroded")
        me_cf = None if me is None else me.permute(1, 0, 2, 3).contiguous()
        c_render = 10.0 ** float(cfg.w_render)
        c_rgb = 10.0 ** float(cfg.w_rgb) if cfg.w_rgb is not None else None

    def fused_grads(step: int, heavy: bool):
        alpha = alphas[step]
        # d total / d loss_rgb: the render term's (1 - alpha) plus the direct rgb term
        g_loss_scale = c_render * (1.0 - alpha)
        if c_rgb is not None:
            g_loss_scale = g_loss_scale + c_rgb
        H = sl3_to_SL3(graph.warp)
        rgb_cf, rgb_loss, dmlp, dH, _ = fused_train_kernel_warp(
            graph.neural_image, grid_b, H.detach(), None if cws is None else cws[step],
            targets_cf, masks_cf, g_loss_scale, inv_sum3,
        )
        (dwarp,) = torch.autograd.grad(H, graph.warp, dH)
        for layer, (dw, db) in zip(graph.neural_image.layers, dmlp):
            layer.weight.grad = dw
            layer.bias.grad = db
        graph.warp.grad = dwarp
        if cfg.use_edges and (heavy or not lazy):
            # the gradient-blocked edge term; [3, B, h, w] keeps the image axis as channels
            edge_loss = mse(compute_edges(rgb_cf.reshape(3, B, h, w)), edges_cf, me_cf)
        else:
            edge_loss = zero
        return {
            "render": render_loss(rgb_loss, edge_loss, zero, alpha),
            "rgb": rgb_loss,
            "mask": zero,
            "edge": edge_loss,
        }

    def autograd_grads(step: int):
        optimizer.zero_grad(set_to_none=True)
        outputs = graph_forward(graph, data, cfg, progress[step])
        loss = graph_loss(outputs, data, cfg, steps[step])
        summarize_loss(loss, cfg.loss_weight).backward()
        return {k: v.detach() for k, v in loss.items()}

    def step_fn(step: int, heavy: bool = True) -> dict:
        loss = fused_grads(step, heavy) if fused else autograd_grads(step)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        metrics = {f"loss_{k}": v for k, v in loss.items()}
        metrics["all"] = summarize_loss(loss, cfg.loss_weight)
        metrics["PSNR"] = psnr_from_rgb_loss(loss["rgb"])
        metrics["finite"] = check_finite(loss)
        with torch.no_grad():
            if gt_hom is not None:
                metrics["Homography_Error"] = (
                    homography_error(sl3_to_SL3(graph.warp), gt_hom) if (heavy or not lazy) else zero
                )
            if cfg.fix_first:
                graph.warp[0].zero_()
        return metrics

    return step_fn


def run_chunk(step_fn, start: int, n: int) -> dict[str, np.ndarray]:
    """Run steps [start, start + n) and read their metrics back with one
    device->host copy: {name: [n] array}."""
    rows = [step_fn(start + i, heavy=(i == n - 1)) for i in range(n)]
    keys = list(rows[0])
    stacked = torch.stack([torch.stack([r[k].to(torch.float32) for k in keys]) for r in rows]).cpu().numpy()
    return {k: stacked[:, j] for j, k in enumerate(keys)}


def chunk_schedule(max_iter: int, freq_scalar: int, freq_vis: int, freq_ckpt: int | None = None) -> int:
    """Chunk length: the largest step count whose boundaries hit every
    scalar-log, vis and (if set) checkpoint cadence point."""
    c = math.gcd(int(freq_scalar), int(freq_vis))
    if freq_ckpt:
        c = math.gcd(c, int(freq_ckpt))
    return max(1, min(c, max_iter))
