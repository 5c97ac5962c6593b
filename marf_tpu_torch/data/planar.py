"""Planar dataset on the host (twin of marf_tpu/data/planar.py:119-298).

The synthetic generator gives the same arrays as marf_tpu's for the same
seed: a smooth random canvas, B pixel-space homographies around identity,
cv2 warps (identity when cv2 is absent, as in marf_tpu), LANCZOS thumbnails
and rectangular occlusions recorded in the masks. Pillow and OpenCV are
imported where they are used. The arrays move to the device once
(`to_device`); nothing here runs per step.
"""

from __future__ import annotations

import numpy as np
import torch

from marf_tpu_torch.ops.homography import normalize_homography


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def compute_edges_host(images: np.ndarray) -> np.ndarray:
    """Target edge maps with cv2 as the reference computes them
    (inputs.py:50-69): float64 Sobel ksize=3 x/y, magnitude, 5x5 Gaussian.
    [B, C, H, W] -> float32 [B, C, H, W]."""
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("cv2 is required for host-side edge computation")
    out = []
    for image in images:
        i = np.transpose(image, (1, 2, 0)).astype(np.float64)
        sx = cv2.Sobel(i, cv2.CV_64F, 1, 0, ksize=3)
        sy = cv2.Sobel(i, cv2.CV_64F, 0, 1, ksize=3)
        i = cv2.GaussianBlur(np.sqrt(sx**2 + sy**2), (5, 5), 0)
        if i.ndim == 2:
            i = i[:, :, None]
        out.append(i.transpose(2, 0, 1))
    return np.stack(out).astype(np.float32)


def erode_images_host(images: np.ndarray, kernel: tuple[int, int] = (5, 5)) -> np.ndarray:
    """5x5 rectangular erosion with cv2 (reference inputs.py:71-85)."""
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("cv2 is required for host-side erosion")
    element = cv2.getStructuringElement(cv2.MORPH_RECT, kernel)
    out = []
    for image in images:
        i = cv2.erode(np.transpose(image, (1, 2, 0)), element)
        if i.ndim == 2:
            i = i[:, :, None]
        out.append(i.transpose(2, 0, 1))
    return np.stack(out).astype(np.float32)


def synthesize_planar_dataset(cfg, seed: int = 0, occlusion_frac: float = 0.15, warp_scale: float = 0.1) -> dict:
    """Synthetic planar-alignment dataset with the on-disk dict layout
    (gt, rgb, gt_hom, masks, masks_eroded, gray, edges; numpy float32)."""
    from PIL import Image

    cv2 = _cv2()
    rng = np.random.RandomState(seed)
    H, W, B = cfg.H, cfg.W, cfg.batch_size
    low = rng.rand(H // 24 + 2, W // 24 + 2, 3).astype(np.float32)
    canvas = np.stack(
        [np.asarray(Image.fromarray((low[..., c] * 255).astype(np.uint8)).resize((W, H), Image.BICUBIC)) for c in range(3)],
        axis=-1,
    ).astype(np.float32) / 255.0

    rgbs, masks, homs = [], [], []
    for b in range(B):
        if b == 0:
            Hmat = np.eye(3)
        else:
            pert = rng.randn(3, 3) * warp_scale * np.array([[0.1, 0.1, W * 0.05], [0.1, 0.1, H * 0.05], [1e-4, 1e-4, 0.1]])
            Hmat = np.eye(3) + pert
            Hmat /= np.cbrt(np.abs(np.linalg.det(Hmat)))
        homs.append(Hmat.astype(np.float32))
        if cv2 is not None:
            warped = cv2.warpPerspective(canvas, np.linalg.inv(Hmat), (W, H), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
        else:
            warped = canvas.copy()
        im = Image.fromarray((np.clip(warped, 0, 1) * 255).astype(np.uint8))
        if cfg.use_cropped_images:
            im.thumbnail((cfg.patch_W, cfg.patch_H), Image.Resampling.LANCZOS)
        arr = np.asarray(im).astype(np.float32) / 255.0
        mask = np.ones((arr.shape[0], arr.shape[1]), dtype=np.float32)
        oh = max(1, int(arr.shape[0] * occlusion_frac))
        ow = max(1, int(arr.shape[1] * occlusion_frac))
        oy, ox = rng.randint(0, arr.shape[0] - oh), rng.randint(0, arr.shape[1] - ow)
        arr[oy : oy + oh, ox : ox + ow] = rng.rand(oh, ow, 3)
        mask[oy : oy + oh, ox : ox + ow] = 0.0  # 0 = occluded
        rgbs.append(arr.transpose(2, 0, 1))
        masks.append(mask[None])
    rgb = np.stack(rgbs)
    masks = np.stack(masks)
    gray = rgb.mean(axis=1, keepdims=True).astype(np.float32)
    # the reference's kornia call passes (W, H) where (H, W) is expected (SURVEY.md §2.4(5))
    gt_hom = normalize_homography(torch.from_numpy(np.stack(homs)), (cfg.W, cfg.H), (cfg.W, cfg.H)).numpy()
    return {
        "gt": canvas.transpose(2, 0, 1),
        "rgb": rgb,
        "gt_hom": gt_hom,
        "masks": masks,
        "masks_eroded": erode_images_host(masks) if cv2 is not None else masks,
        "gray": gray,
        "edges": compute_edges_host(gray) if cv2 is not None else np.zeros_like(gray),
    }


def to_device(data: dict, device) -> dict:
    """Move the dataset dict to `device` once as float32; None entries pass through."""
    return {k: None if v is None else torch.as_tensor(np.asarray(v), dtype=torch.float32).to(device) for k, v in data.items()}
