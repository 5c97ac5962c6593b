"""Sobel + Gaussian edge maps as depthwise convolutions (torch twin of
marf_tpu/ops/filters.py `compute_edges`, reference inputs.py:50-69).

cv2 numerics: Sobel ksize=3 correlation taps [-1,0,1] x [1,2,1] with
BORDER_REFLECT_101 (`F.pad(mode="reflect")`), magnitude, then
GaussianBlur((5,5), 0) = the separable [1,4,6,4,1]/16 table, same border.
Each 2-D filter runs as two 1-D depthwise `F.conv2d` passes. On CUDA, cuDNN
would run these float32 convolutions in TF32 unless
`torch.backends.cudnn.allow_tf32` is False; the port's device setup
(utils/config.py) turns TF32 off.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

_SMOOTH_121 = (1.0, 2.0, 1.0)
_DERIV_101 = (-1.0, 0.0, 1.0)
_GAUSS_1D = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


@functools.cache
def _taps(taps: tuple[float, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The taps as a tensor on `device`, copied from the host once: a
    captured CUDA graph can hold no copy from pageable host memory."""
    return torch.tensor(taps, dtype=dtype, device=device)


def _conv1d_axis(x: torch.Tensor, taps: tuple[float, ...], axis: int) -> torch.Tensor:
    """1-D correlation of [N, 1, H, W] along H (axis=2) or W (axis=3),
    reflect-101 borders."""
    k = _taps(taps, x.dtype, x.device)
    p = len(taps) // 2
    if axis == 2:
        return F.conv2d(F.pad(x, (0, 0, p, p), mode="reflect"), k.view(1, 1, -1, 1))
    return F.conv2d(F.pad(x, (p, p, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))


def _sep_conv2d(images: torch.Tensor, taps_h, taps_w) -> torch.Tensor:
    """Separable depthwise 2-D correlation of [B, C, H, W] (every channel
    filtered on its own)."""
    B, C, H, W = images.shape
    x = images.reshape(B * C, 1, H, W)
    x = _conv1d_axis(_conv1d_axis(x, taps_h, 2), taps_w, 3)
    return x.reshape(B, C, H, W)


def sobel_edges(images: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Per-channel Sobel gradient magnitude (cv2.Sobel ksize=3)."""
    gx = _sep_conv2d(images, _SMOOTH_121, _DERIV_101)
    gy = _sep_conv2d(images, _DERIV_101, _SMOOTH_121)
    return torch.sqrt(gx * gx + gy * gy + eps)


def gaussian_blur_5x5(images: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur(img, (5,5), 0)."""
    return _sep_conv2d(images, _GAUSS_1D, _GAUSS_1D)


def compute_edges(images: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
    """[B, C, H, W] images in [0, 1] -> blurred edge magnitudes.

    differentiable=False is the reference's `.detach()` (the edge loss
    carries no gradient, SURVEY.md §2.4(1)); True keeps gradients with an
    eps-guarded sqrt."""
    if differentiable:
        return gaussian_blur_5x5(sobel_edges(images, eps=1e-12))
    with torch.no_grad():
        return gaussian_blur_5x5(sobel_edges(images.detach()))
