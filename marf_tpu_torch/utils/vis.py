"""Visualization helpers on numpy (twin of marf_tpu/utils/vis.py, reference
util_vis.py).

`tb_image` / `preprocess_vis_image` / `get_heatmap` / `color_border` keep the
reference's observable behavior (reference util_vis.py:10-56): range
normalization and clamp, heatmap colormapping of 1-channel images,
`make_grid` tiling with pad_value=1 and the 4th-channel mask strip, and
per-image colored borders. `draw_corner_boxes` outlines the warped patch
windows on a full-canvas render.
"""

from __future__ import annotations

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """Tile [N, C, H, W] into one [C, H', W'] grid (torchvision semantics:
    `nrow` images per row, `padding` pixels of `pad_value` around each cell)."""
    N, C, H, W = images.shape
    ncol = nrow
    nrow_out = int(np.ceil(N / ncol))
    grid = np.full((C, padding + nrow_out * (H + padding), padding + ncol * (W + padding)), pad_value, dtype=images.dtype)
    for idx in range(N):
        r, c = divmod(idx, ncol)
        y = padding + r * (H + padding)
        x = padding + c * (W + padding)
        grid[:, y : y + H, x : x + W] = images[idx]
    return grid


def get_heatmap(gray: np.ndarray, cmap: str = "gray") -> np.ndarray:
    """[N, H, W] grayscale -> [N, 3, H, W] colormapped (reference
    util_vis.py:35-40): matplotlib's colormap when matplotlib is installed,
    else the channel replicated."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return np.repeat(gray[:, None], 3, axis=1).astype(np.float32)
    color = plt.get_cmap(cmap)(gray)[..., :3]  # [N, H, W, 3]
    return np.transpose(color, (0, 3, 1, 2)).astype(np.float32)


def preprocess_vis_image(images: np.ndarray, from_range=(0, 1), cmap: str = "gray") -> np.ndarray:
    """Range-normalize and clamp; colormap 1-channel stacks (reference
    util_vis.py:25-32)."""
    min_val, max_val = from_range
    images = (np.asarray(images, dtype=np.float32) - min_val) / (max_val - min_val)
    images = np.clip(images, 0.0, 1.0)
    if images.shape[1] == 1:
        images = get_heatmap(images[:, 0], cmap=cmap)
    return images


def tb_image(opt, tb, step, group, name, images, num_vis=None, from_range=(0, 1), cmap="gray"):
    """Publish an image panel to TensorBoard (reference util_vis.py:10-22)."""
    images = preprocess_vis_image(images, from_range=from_range, cmap=cmap)
    num_H, num_W = num_vis or opt.tb.num_images
    images = images[: num_H * num_W]
    image_grid = make_grid(images[:, :3], nrow=num_W, pad_value=1.0)
    if images.shape[1] == 4:
        mask_grid = make_grid(images[:, 3:], nrow=num_W, pad_value=1.0)[:1]
        image_grid = np.concatenate([image_grid, mask_grid], axis=0)
    tb.add_image(f"{group}/{name}", image_grid, step)


def draw_corner_boxes(frame: np.ndarray, corners_px: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """Outline each image's warped patch window on a full-canvas render
    (the consumer of the reference's never-called `warp_corners`, warp.py:83-93).

    frame: [3, H, W] in [0, 1]; corners_px: [B, 4, 2] corner (x, y) pixel
    coordinates; colors: [B, 3] 0-255 RGB. Returns a [3, H, W] copy with the
    outlines drawn (off-canvas segments clipped)."""
    out = frame.copy()
    H, W = frame.shape[1:]
    for b in range(corners_px.shape[0]):
        col = np.asarray(colors[b], dtype=np.float32) / 255.0
        quad = corners_px[b]
        for e in range(4):
            p0, p1 = quad[e], quad[(e + 1) % 4]
            n = max(2, int(np.ceil(np.abs(p1 - p0).max())) + 1)
            ts = np.linspace(0.0, 1.0, n)
            xs = np.rint(p0[0] + ts * (p1[0] - p0[0])).astype(int)
            ys = np.rint(p0[1] + ts * (p1[1] - p0[1])).astype(int)
            keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
            out[:, ys[keep], xs[keep]] = col[:, None]
    return out


def color_border(images: np.ndarray, colors: np.ndarray, width: int = 3, depth: int = 3) -> np.ndarray:
    """Frame each image of [B, C, H, W] with its color, [B, 3] 0-255 ints
    (reference util_vis.py:43-56); depth 1 puts a grey frame on 1-channel
    images."""
    images_pad = []
    for i, image in enumerate(np.asarray(images)):
        if depth == 1:
            image_pad = np.full((1, image.shape[1] + width * 2, image.shape[2] + width * 2), 127.0 / 255.0,
                                dtype=np.float32)
        else:
            image_pad = np.ones((3, image.shape[1] + width * 2, image.shape[2] + width * 2), dtype=np.float32)
            image_pad *= colors[i][:, None, None].astype(np.float32) / 255.0
        image_pad[:, width:-width, width:-width] = image
        images_pad.append(image_pad)
    return np.stack(images_pad)


BOX_COLORS = (
    "#FF0000", "#00FF00", "#0000FF", "#FFFF00", "#00FFFF", "#FF00FF",
    "#800000", "#808000", "#008080", "#800080", "#808080",
)  # reference model/planar.py:114-126
