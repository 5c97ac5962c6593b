"""Homography warps on normalized grids (torch twin of marf_tpu/ops/warp.py).

Homogenize, map the 8-vector warp through sl3_to_SL3, apply x @ H^T and
perspective-divide with +1e-8 (reference warp.py:70-81); `warp_corners`
maps the patch window's corners for the TensorBoard overlay
(warp.py:83-93).
"""

from __future__ import annotations

import torch

from marf_tpu_torch.ops.lie import sl3_to_SL3


def to_hom(points: torch.Tensor) -> torch.Tensor:
    """Append a homogeneous 1-coordinate (reference warp.py:27-31)."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def warp_grid_cf_flat(xy_grid: torch.Tensor, warp: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Warp a [HW, 2] grid by per-image sl(3) warps [B, 8].

    Returns [2, B*HW] channels-first coordinates in image-major order
    (b, then hw), so `out.reshape(2, B, HW)` is the per-image view."""
    grid_hom_T = to_hom(xy_grid).T  # [3, HW]
    H = sl3_to_SL3(warp)  # [B, 3, 3]
    warped_hom = torch.einsum("bjk,kn->jbn", H, grid_hom_T).reshape(3, -1)  # [3, B*HW]
    return warped_hom[:2] / (warped_hom[2:3] + eps)


def warp_corners(corners: torch.Tensor, warp: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """[4, 2] normalized corner coordinates (`grid.crop_corners`) warped by
    per-image sl(3) warps [B, 8] -> [B, 4, 2]."""
    warped_hom = torch.einsum("nk,bjk->bnj", to_hom(corners), sl3_to_SL3(warp))
    return warped_hom[..., :2] / (warped_hom[..., 2:] + eps)
