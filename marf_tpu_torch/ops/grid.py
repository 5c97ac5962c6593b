"""Normalized pixel-grid generation (torch twin of marf_tpu/ops/grid.py).

Pixel centers (+0.5) mapped to [-1, 1] per axis and scaled by the
aspect-preserving factors norm_h = H/max(H,W), norm_w = W/max(H,W); the crop
variant spans the centered patch_H x patch_W window of the full canvas
(reference warp.py:33-68); `crop_corners` gives that window's four corners.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static canvas/patch geometry (reference Warp.__init__, warp.py:9-25)."""

    H: int
    W: int
    patch_H: int
    patch_W: int

    @property
    def y_crop(self) -> tuple[int, int]:
        return (self.H // 2 - self.patch_H // 2, self.H // 2 + self.patch_H // 2)

    @property
    def x_crop(self) -> tuple[int, int]:
        return (self.W // 2 - self.patch_W // 2, self.W // 2 + self.patch_W // 2)

    @property
    def norm_h(self) -> float:
        return self.H / max(self.H, self.W)

    @property
    def norm_w(self) -> float:
        return self.W / max(self.H, self.W)


def normalized_pixel_grid(spec: GridSpec, crop: bool = False, device=None) -> torch.Tensor:
    """[HW, 2] grid of (x, y) normalized pixel-center coordinates, float32.

    crop=True spans the centered patch window (reference warp.py:37-53),
    else the full canvas (warp.py:54-68)."""
    if crop:
        y0, y1 = spec.y_crop
        x0, x1 = spec.x_crop
    else:
        y0, y1, x0, x1 = 0, spec.H, 0, spec.W
    ys = torch.arange(y0, y1, dtype=torch.float32, device=device)
    xs = torch.arange(x0, x1, dtype=torch.float32, device=device)
    y_range = ((ys + 0.5) / spec.H * 2 - 1) * spec.norm_h
    x_range = ((xs + 0.5) / spec.W * 2 - 1) * spec.norm_w
    Y, X = torch.meshgrid(y_range, x_range, indexing="ij")  # [h, w]
    return torch.stack([X, Y], dim=-1).reshape(-1, 2)


def crop_corners(spec: GridSpec, device=None) -> torch.Tensor:
    """[4, 2] normalized (x, y) coordinates of the patch window's corners
    (reference `Warp.warp_corners`, warp.py:86-91)."""
    Y = [((y + 0.5) / spec.H * 2 - 1) * spec.norm_h for y in spec.y_crop]
    X = [((x + 0.5) / spec.W * 2 - 1) * spec.norm_w for x in spec.x_crop]
    return torch.tensor([(X[0], Y[0]), (X[0], Y[1]), (X[1], Y[1]), (X[1], Y[0])], dtype=torch.float32, device=device)
