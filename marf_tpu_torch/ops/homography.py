"""Homography normalization (torch twin of marf_tpu/ops/homography.py).

The reference normalizes pixel-space homographies with
`kornia.geometry.conversions.normalize_homography(gt, (W, H), (W, H))`
(reference inputs.py:104), passing (W, H) where kornia expects (H, W). That
quirk is kept at the call site (SURVEY.md §2.4(5)): this module exposes the
kornia signature and the data layer passes the swapped sizes.

  normal_transform_pixel(h, w) = [[2/(w-1), 0, -1], [0, 2/(h-1), -1], [0, 0, 1]]
  normalize_homography(M, (hs, ws), (hd, wd)) = N(hd, wd) @ M @ inv(N(hs, ws))
"""

from __future__ import annotations

import torch


def normal_transform_pixel(height: int, width: int, eps: float = 1e-14, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-to-[-1,1] normalization matrix (kornia's normal_transform_pixel)."""
    w_denom = eps if width == 1 else width - 1.0
    h_denom = eps if height == 1 else height - 1.0
    return torch.tensor(
        [[2.0 / w_denom, 0.0, -1.0], [0.0, 2.0 / h_denom, -1.0], [0.0, 0.0, 1.0]],
        dtype=dtype,
        device=device,
    )


def normalize_homography(dst_pix_trans_src_pix: torch.Tensor, dsize_src: tuple[int, int], dsize_dst: tuple[int, int]) -> torch.Tensor:
    """[..., 3, 3] pixel-space homographies -> N_dst @ M @ N_src^{-1}.
    dsize_* are (height, width) in kornia's convention."""
    M = dst_pix_trans_src_pix
    src_norm = normal_transform_pixel(*dsize_src, dtype=M.dtype, device=M.device)
    dst_norm = normal_transform_pixel(*dsize_dst, dtype=M.dtype, device=M.device)
    return dst_norm @ (M @ torch.linalg.inv(src_norm))
