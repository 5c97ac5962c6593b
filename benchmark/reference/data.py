"""The reference's inputs, worked out from the scene's files as MARF's
loader does (inputs.py:16-127): photos and masks thumbnailed to the patch
size by PIL's LANCZOS, masks read as occlusion < 0.5, a 5x5 erosion of the
masks, and the target edges of the grey photos (Sobel ksize 3, magnitude,
5x5 Gaussian, reflect-101 borders, float64), all from the PNG files, with
nothing taken from the program."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

SOBEL_SMOOTH = (1.0, 2.0, 1.0)
SOBEL_DERIV = (-1.0, 0.0, 1.0)
GAUSS5 = (1.0, 4.0, 6.0, 4.0, 1.0)  # cv2's fixed 5-tap table for sigma 0, over 16


def _read(path: str, mode: str, size_hw) -> np.ndarray:
    from PIL import Image

    im = Image.open(path).convert(mode)
    if size_hw is not None:
        im.thumbnail((size_hw[1], size_hw[0]), Image.Resampling.LANCZOS)
    arr = np.asarray(im).astype(np.float32) / 255.0
    return arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)


def _filter(x: torch.Tensor, taps_y, taps_x) -> torch.Tensor:
    """Separable correlation of [N, 1, H, W] with reflect-101 borders."""
    ky = torch.tensor(taps_y, dtype=x.dtype, device=x.device).view(1, 1, -1, 1)
    kx = torch.tensor(taps_x, dtype=x.dtype, device=x.device).view(1, 1, 1, -1)
    py, px = len(taps_y) // 2, len(taps_x) // 2
    x = F.conv2d(F.pad(x, (0, 0, py, py), mode="reflect"), ky)
    return F.conv2d(F.pad(x, (px, px, 0, 0), mode="reflect"), kx)


def edge_map(images: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> blurred Sobel magnitude per channel, in its dtype."""
    B, C, H, W = images.shape
    x = images.reshape(B * C, 1, H, W)
    gx = _filter(x, SOBEL_SMOOTH, SOBEL_DERIV)
    gy = _filter(x, SOBEL_DERIV, SOBEL_SMOOTH)
    g = torch.sqrt(gx * gx + gy * gy)
    g = _filter(g, tuple(t / 16.0 for t in GAUSS5), tuple(t / 16.0 for t in GAUSS5))
    return g.reshape(B, C, H, W)


def load_inputs(ddir: str, options: dict, device) -> dict:
    """{"rgb": [B, 3, h, w], "masks", "masks_eroded": [B, 1, h, w] (1 =
    visible), "edges": [B, 1, h, w]}, float32 on `device`."""
    B = int(options["batch_size"])
    size = (options["patch_H"], options["patch_W"]) if options.get("use_cropped_images", True) else None
    rgb = np.stack([_read(os.path.join(ddir, f"{i}.png"), "RGB", size) for i in range(B)])
    masks = np.stack([(_read(os.path.join(ddir, f"{i}-m.png"), "L", size) < 0.5).astype(np.float32)
                      for i in range(B)])
    gray = np.stack([_read(os.path.join(ddir, f"{i}.png"), "L", size) for i in range(B)])
    masks_t = torch.from_numpy(masks).to(device)
    eroded = -F.max_pool2d(-masks_t, 5, stride=1, padding=2)  # the border never erodes (cv2's default)
    edges = edge_map(torch.from_numpy(gray).to(device, torch.float64)).to(torch.float32)
    return {"rgb": torch.from_numpy(rgb).to(device), "masks": masks_t, "masks_eroded": eroded, "edges": edges}
