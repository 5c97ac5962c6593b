"""The synthetic planar scene from the seed, written in the `data/planar`
layout that the port's loader reads (`<root>/<set>/i.png`, `i-m.png`,
`gt.png`, `H_0_i.mat`).

A frozen copy of the port's synthetic generator (`data/planar.py`
`synthesize_planar_dataset` and `save_planar_dataset` at full size), kept
here so that the inputs do not move when the program changes: a smooth
random canvas, B pixel-space homographies near the identity (image 0 the
identity), each photo the canvas warped by cv2 with one rectangular
occluder of random colour, and its mask (occlusion = 1 on disk, the SIDAR
convention). One difference: the seed drives numpy's `default_rng`, which
takes any whole number, where the port's `RandomState` takes 32 bits.
Every seed gives the same sizes and the same kinds of work.
"""

from __future__ import annotations

import os

import numpy as np

OCCLUSION_FRAC = 0.15
WARP_SCALE = 0.1


def _png(chw: np.ndarray, path: str) -> None:
    from PIL import Image

    hwc = (np.clip(chw, 0.0, 1.0).transpose(1, 2, 0) * 255).astype(np.uint8)
    Image.fromarray(hwc[..., 0] if hwc.shape[-1] == 1 else hwc).save(path)


def make_scene(seed: int, H: int, W: int, B: int) -> dict:
    """{"gt": [3, H, W], "rgb": [B, 3, H, W], "masks": [B, 1, H, W] (1 =
    visible), "homs": [B, 3, 3] pixel space}, float32 / float64."""
    import cv2
    from PIL import Image

    rng = np.random.default_rng(int(seed) % 2**64)
    low = rng.random((H // 24 + 2, W // 24 + 2, 3)).astype(np.float32)
    canvas = np.stack(
        [np.asarray(Image.fromarray((low[..., c] * 255).astype(np.uint8)).resize((W, H), Image.BICUBIC))
         for c in range(3)], axis=-1).astype(np.float32) / 255.0
    rgbs, masks, homs = [], [], []
    scale = WARP_SCALE * np.array([[0.1, 0.1, W * 0.05], [0.1, 0.1, H * 0.05], [1e-4, 1e-4, 0.1]])
    for b in range(B):
        if b == 0:
            hom = np.eye(3)
        else:
            hom = np.eye(3) + rng.standard_normal((3, 3)) * scale
            hom /= np.cbrt(np.abs(np.linalg.det(hom)))
        homs.append(hom)
        warped = cv2.warpPerspective(canvas, np.linalg.inv(hom), (W, H), flags=cv2.INTER_LINEAR,
                                     borderMode=cv2.BORDER_REFLECT)
        arr = np.asarray(Image.fromarray((np.clip(warped, 0, 1) * 255).astype(np.uint8))).astype(np.float32) / 255.0
        mask = np.ones((H, W), dtype=np.float32)
        oh, ow = max(1, int(H * OCCLUSION_FRAC)), max(1, int(W * OCCLUSION_FRAC))
        oy, ox = int(rng.integers(0, H - oh)), int(rng.integers(0, W - ow))
        arr[oy : oy + oh, ox : ox + ow] = rng.random((oh, ow, 3))
        mask[oy : oy + oh, ox : ox + ow] = 0.0
        rgbs.append(arr.transpose(2, 0, 1))
        masks.append(mask[None])
    return {"gt": canvas.transpose(2, 0, 1), "rgb": np.stack(rgbs), "masks": np.stack(masks), "homs": np.stack(homs)}


def write_scene(scene: dict, ddir: str) -> None:
    """The scene in the on-disk layout under `ddir`."""
    os.makedirs(ddir, exist_ok=True)
    for i, im in enumerate(scene["rgb"]):
        _png(im, os.path.join(ddir, f"{i}.png"))
    for i, m in enumerate(scene["masks"]):
        _png(1.0 - m, os.path.join(ddir, f"{i}-m.png"))
    _png(scene["gt"], os.path.join(ddir, "gt.png"))
    for i, hom in enumerate(scene["homs"][1:], start=1):
        np.savetxt(os.path.join(ddir, f"H_0_{i}.mat"), hom)
