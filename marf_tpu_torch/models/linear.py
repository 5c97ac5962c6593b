"""Dense layers with torch.nn.Linear's default init drawn from an explicit
generator (twin of marf_tpu/models/linear.py): W, b ~ U(-1/sqrt(fan_in),
1/sqrt(fan_in)). Weights keep nn.Linear's [out, in] layout; marf_tpu stores
[in, out] (utils/params.py transposes)."""

from __future__ import annotations

import math

import torch
from torch import nn


def make_linear(fan_in: int, fan_out: int, generator: torch.Generator | None = None, device=None) -> nn.Linear:
    layer = nn.Linear(fan_in, fan_out, device=device, dtype=torch.float32)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
        nn.init.uniform_(layer.bias, -bound, bound, generator=generator)
    return layer
