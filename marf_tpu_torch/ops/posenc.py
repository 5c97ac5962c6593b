"""BARF positional encoding with coarse-to-fine band weights
(torch twin of marf_tpu/ops/posenc.py, reference model/planar.py:451-471).

Channels-first layout: coordinates [C, P] encode to [2*C*L, P] with rows
[sin(c_0 f_0..f_{L-1}), cos(c_0 f_0..f_{L-1}), sin(c_1 ...), cos(c_1 ...)],
f_k = 2^k * pi. The neural image prepends the raw coordinates, so the
planar model's 34-row input is [x, y, sin_x(8), cos_x(8), sin_y(8), cos_y(8)].
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.cache
def _frequencies(L: int, device: torch.device) -> torch.Tensor:
    """[L, 1] float32 2^k * fl32(pi) (exact) on `device`, copied from the
    host once: a captured CUDA graph can hold no copy from pageable host
    memory."""
    freq = (2.0 ** np.arange(L)).astype(np.float32) * np.float32(np.pi)
    return torch.as_tensor(freq, device=device)[:, None]


def barf_posenc_cf(coord_cf: torch.Tensor, L: int) -> torch.Tensor:
    """[C, P] -> [2*C*L, P] sin/cos encoding (no c2f weighting)."""
    freq = _frequencies(L, coord_cf.device)  # [L, 1]
    blocks = []
    for c in range(coord_cf.shape[0]):
        spec = coord_cf[c : c + 1] * freq  # [L, P]
        blocks += [torch.sin(spec), torch.cos(spec)]
    return torch.cat(blocks, dim=0)


def apply_c2f_cf(enc_cf: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Multiply the band weights [L] along the channel axis of [4L, P]."""
    L = weights.shape[-1]
    return enc_cf * weights.repeat(enc_cf.shape[0] // L)[:, None]


def barf_c2f_weights(progress, c2f: tuple[float, float], L: int) -> torch.Tensor:
    """Cosine-annealed band weights w_k = (1 - cos(clamp(alpha - k, 0, 1) pi)) / 2
    with alpha = (progress - start) / (end - start) * L (reference
    model/planar.py:462-470). `progress` is a float32 tensor of any shape;
    the result has that shape + [L]."""
    start, end = c2f
    alpha = (progress - start) / (end - start) * L
    k = torch.arange(L, dtype=torch.float32, device=progress.device)
    return (1 - torch.cos(torch.clamp(alpha[..., None] - k, 0.0, 1.0) * math.pi)) / 2


def hanerf_pos_embedding(x: torch.Tensor, max_logscale: int = 9, n_freqs: int = 10) -> torch.Tensor:
    """Ha-NeRF embedding of the mask head's uv input (reference
    model/planar.py:491-517): [..., C] -> [..., C * (1 + 2 n_freqs)], ordered
    [x, sin(f_0 x), cos(f_0 x), sin(f_1 x), ...] with f = 2^linspace(0, 9, 10)
    taken in float64 (powers of two, so exact in float32)."""
    parts = [x]
    for f in 2.0 ** np.linspace(0, max_logscale, n_freqs):
        parts += [torch.sin(float(f) * x), torch.cos(float(f) * x)]
    return torch.cat(parts, dim=-1)
