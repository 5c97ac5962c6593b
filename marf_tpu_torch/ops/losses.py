"""Losses and metrics (torch twin of marf_tpu/ops/losses.py, reference
model/planar.py:219-254, 355-391). Every function returns a 0-d tensor on
the inputs' device, so a train step never syncs with the host for them."""

from __future__ import annotations

import math

import torch


def mse(pred: torch.Tensor, labels: torch.Tensor, masks: torch.Tensor | None = None) -> torch.Tensor:
    """Unmasked: mean((pred - labels)^2). Masked, as the reference computes
    it: sum(((pred - labels) * masks)^2) / (sum(masks) * 3) — the 1-channel
    mask sum times 3 channels."""
    if masks is None:
        return torch.mean((pred - labels) ** 2)
    masked_diff = (pred - labels) * masks
    return torch.sum(masked_diff**2) / (torch.sum(masks) * 3)


def alpha_schedule(step, max_iter: int, alpha_initial: float, alpha_final: float) -> torch.Tensor:
    """Linear edge/rgb mixing factor a0 + (a1 - a0) * (step / max_iter), in
    float32; `step` is an integer tensor of any shape."""
    return alpha_initial + (alpha_final - alpha_initial) * (step.to(torch.float32) / max_iter)


def render_loss(rgb_loss, edge_loss, mask_loss, alpha) -> torch.Tensor:
    """(1 - alpha) * rgb + 0.5 * mask + alpha * edge (reference model/planar.py:371-374)."""
    return (1 - alpha) * rgb_loss + 0.5 * mask_loss + alpha * edge_loss


def mask_counterweight(mask_prediction_map: torch.Tensor) -> torch.Tensor:
    """mean((1 - m)^2): keeps the learned mask from masking everything
    (reference model/planar.py:370)."""
    return torch.mean((1 - mask_prediction_map) ** 2)


def summarize_loss(loss: dict, loss_weight: dict) -> torch.Tensor:
    """sum_k 10^w_k * loss_k; weights are log10 exponents and None disables
    a term (reference model/planar.py:172-185)."""
    total = None
    for key, value in loss.items():
        if key not in loss_weight:
            raise KeyError(f"loss term {key!r} has no weight entry")
        weight = loss_weight[key]
        if weight is not None:
            term = (10.0 ** float(weight)) * value
            total = term if total is None else total + term
    if total is None:
        raise ValueError("every loss term is disabled")
    return total


def psnr_from_rgb_loss(rgb_loss: torch.Tensor) -> torch.Tensor:
    """-10 log10(masked rgb MSE) (reference model/planar.py:252-253)."""
    return -10.0 * torch.log(rgb_loss) / math.log(10.0)


def homography_error(pred_warp_H: torch.Tensor, gt_hom_norm: torch.Tensor) -> torch.Tensor:
    """||(H_pred - H_gt)^2||_F — the Frobenius norm of the elementwise-squared
    residual, as the reference computes it (model/planar.py:219-223)."""
    r2 = (pred_warp_H - gt_hom_norm) ** 2
    return torch.sqrt(torch.sum(r2**2))


def check_finite(loss: dict) -> torch.Tensor:
    """All-finite flag over the loss terms, kept on the device (the reference
    asserts per iteration on the host, model/planar.py:181-182)."""
    return torch.stack([torch.isfinite(v) for v in loss.values()]).all()
