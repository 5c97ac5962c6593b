"""The coordinate-MLP "neural image" with BARF coarse-to-fine posenc
(twin of marf_tpu/models/neural_image.py, reference model/planar.py:395-471).

2 + 4L input features (xy concat posenc), hidden stack from `arch.layers`
with optional skip re-concats, ReLU inner activations, sigmoid output. Under
barf_c2f the first layer's init is rescaled by sqrt(input_dim/2)
(model/planar.py:421-426). The forward keeps marf_tpu's channels-first layout
at its interface: [2, P] coordinates in, [3, P] rgb out.

compute_dtype (marf_tpu's `tpu.compute_dtype`): float32, or bfloat16 with
marf_tpu's casts (apply_neural_image_cf): the encoding, every weight and every
hidden activation rounded to bf16, each product taken in float32 on those
values (exact per term), the bias added in float32, the sigmoid on float32.
Autograd rounds each cotangent to bf16 where it crosses a rounding, as JAX's
transpose of `astype(bfloat16)` does. The parameters stay float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from marf_tpu_torch.models.linear import make_linear
from marf_tpu_torch.ops.posenc import apply_c2f_cf, barf_c2f_weights, barf_posenc_cf


COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class NeuralImageConfig:
    """Static architecture config (reference options/planar.yaml:33-39)."""

    layers: tuple = (None, 256, 256, 256, 256, 3)
    skip: tuple = ()
    posenc_L: int | None = 8  # None -> raw-coordinate MLP (--arch.posenc!)
    barf_c2f: tuple | None = None  # (start, end) or None
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r}: the port runs {' and '.join(COMPUTE_DTYPES)}"
            )

    @property
    def input_dim(self) -> int:
        return 2 + 4 * self.posenc_L if self.posenc_L else 2

    @property
    def layer_dims(self) -> list:
        """[(k_in, k_out)] with skip-widened inputs resolved."""
        resolved = []
        for li, (k_in, k_out) in enumerate(zip(self.layers[:-1], self.layers[1:])):
            if li == 0:
                k_in = self.input_dim
            if li in self.skip:
                k_in += self.input_dim
            resolved.append((k_in, k_out))
        return resolved


def encode_coords_cf(coord_cf: torch.Tensor, L: int | None, cw: torch.Tensor | None) -> torch.Tensor:
    """[2, P] -> [2 + 4L, P]: raw coordinates, then posenc weighted by the
    c2f band weights `cw` [L] (None = c2f off)."""
    if not L:
        return coord_cf
    enc = barf_posenc_cf(coord_cf, L)
    if cw is not None:
        enc = apply_c2f_cf(enc, cw)
    return torch.cat([coord_cf, enc], dim=0)


class NeuralImage(nn.Module):
    def __init__(self, cfg: NeuralImageConfig, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList()
        for li, (k_in, k_out) in enumerate(cfg.layer_dims):
            layer = make_linear(k_in, k_out, generator=generator, device=device)
            if cfg.barf_c2f is not None and li == 0:
                scale = math.sqrt(cfg.input_dim / 2.0)
                with torch.no_grad():
                    layer.weight.mul_(scale)
                    layer.bias.mul_(scale)
            self.layers.append(layer)

    def forward(self, coord_cf: torch.Tensor, progress: torch.Tensor | None = None) -> torch.Tensor:
        """[2, P] coordinates -> [3, P] rgb in (0, 1); `progress` (a float32
        tensor in [0, 1]) drives the c2f band weights when c2f is on."""
        cfg = self.cfg
        cw = None
        if cfg.posenc_L and cfg.barf_c2f is not None:
            cw = barf_c2f_weights(progress, tuple(cfg.barf_c2f), cfg.posenc_L)
        enc = encode_coords_cf(coord_cf, cfg.posenc_L, cw)
        bf16 = cfg.compute_dtype == "bfloat16"
        if bf16:  # the rounding as a bf16 tensor, read back as float32 by each product
            enc = enc.to(torch.bfloat16)
        feat = enc
        last = len(self.layers) - 1
        for li, layer in enumerate(self.layers):
            if li in self.cfg.skip:
                feat = torch.cat([feat, enc], dim=0)
            w = layer.weight.to(torch.bfloat16).float() if bf16 else layer.weight
            feat = torch.addmm(layer.bias[:, None], w, feat.float())  # W @ x + b, [out, P]
            if li != last:
                feat = torch.relu(feat)
                if bf16:
                    feat = feat.to(torch.bfloat16)
        return torch.sigmoid(feat)
