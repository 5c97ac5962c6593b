"""Ha-NeRF learned occlusion mask head (twin of marf_tpu/models/implicit_mask.py,
reference model/planar.py:475-517, 319-327).

An MLP [3*128 + 42 -> 256 x4 -> 1, sigmoid] over concat(embedded input RGB,
embedded *unwarped* uv grid). The view embedding is an Embedding(N_vocab, 128)
indexed by `image.long()`, which truncates [0, 1] floats to {0, 1}: only an
exact 1.0 maps to row 1. `quantize_levels > 1` is the fix mode
(floor(image * (levels - 1))). The head keeps marf_tpu's channels-first layout
at its interface: [426, P] features in, [1, P] occlusion probability out.
"""

from __future__ import annotations

import torch
from torch import nn

from marf_tpu_torch.models.linear import make_linear
from marf_tpu_torch.ops.posenc import hanerf_pos_embedding

MASK_MLP_WIDTH = 256
VIEW_EMBED_DIM = 128
UV_EMBED_DIM = 42  # 2 + 2*2*10 (the Ha-NeRF embedding of a 2-vector)


class ImplicitMask(nn.Module):
    """The 5-layer mask MLP, nn.Linear init from an explicit generator."""

    def __init__(self, generator: torch.Generator | None = None, device=None):
        super().__init__()
        dims = [3 * VIEW_EMBED_DIM + UV_EMBED_DIM] + [MASK_MLP_WIDTH] * 4 + [1]
        self.layers = nn.ModuleList(
            make_linear(k_in, k_out, generator=generator, device=device) for k_in, k_out in zip(dims[:-1], dims[1:])
        )

    def forward(self, x_cf: torch.Tensor) -> torch.Tensor:
        """[426, P] features -> [1, P] occlusion probability."""
        feat = x_cf
        last = len(self.layers) - 1
        for li, layer in enumerate(self.layers):
            feat = torch.addmm(layer.bias[:, None], layer.weight, feat)
            feat = torch.relu(feat) if li != last else torch.sigmoid(feat)
        return feat


def init_view_embedding(n_vocab: int, generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """Embedding(N_vocab, 128) with torch's default N(0, 1) init (reference
    model/planar.py:327)."""
    return torch.randn(n_vocab, VIEW_EMBED_DIM, generator=generator, device=device)


def embed_image(view_embedding: torch.Tensor, image: torch.Tensor, quantize_levels: int = 1) -> torch.Tensor:
    """[3, H, W] photo in [0, 1] -> [HW, 3*128] embedded features (reference
    model/planar.py:342-345)."""
    if quantize_levels > 1:
        indices = (image * (quantize_levels - 1)).long().clamp(0, view_embedding.shape[0] - 1)
    else:
        indices = image.long()  # truncation on [0, 1] -> {0, 1}
    flat = indices.reshape(3, -1).T  # [HW, 3]
    return view_embedding[flat].reshape(flat.shape[0], -1)


def mask_head_inputs_cf(view_embedding: torch.Tensor, images: torch.Tensor, xy_grid: torch.Tensor,
                        quantize_levels: int = 1) -> torch.Tensor:
    """Channels-first mask-head inputs [B, 426, HW]: concat(embedded RGB,
    embedded unwarped uv grid) per image (reference model/planar.py:340-349).
    Constant across training while the view embedding is frozen."""
    B = images.shape[0]
    uv = hanerf_pos_embedding(xy_grid)  # [HW, 42]
    rgb = torch.stack([embed_image(view_embedding, im, quantize_levels) for im in images])  # [B, HW, 384]
    return torch.cat([rgb, uv[None].expand(B, -1, -1)], dim=-1).transpose(1, 2)
