"""Planar dataset on the host (twin of marf_tpu/data/planar.py).

The on-disk loader reads the `data/planar/<set>` layout: `i.png` warped and
occluded photos, `i-m.png` occlusion masks (SIDAR convention: occlusion = 1,
inverted on load), `gt.png` the canvas, and optional `H_0_i.mat` plain-text
3x3 pixel-space homographies (image 0 takes the identity). Photos decode
with PIL and shrink by the LANCZOS thumbnail when `use_cropped_images`;
edges and erosion come from cv2; the homographies are normalized on the CPU
with the reference's (W, H)-as-(h, w) argument order.

The synthetic generator gives the same arrays as marf_tpu's for the same
seed: a smooth random canvas, B pixel-space homographies around identity,
cv2 warps (identity when cv2 is absent, as in marf_tpu), LANCZOS thumbnails
and rectangular occlusions recorded in the masks. `save_planar_dataset`
writes such a set in the on-disk layout. Pillow and OpenCV are imported where
they are used. The arrays move to the device once (`to_device`); nothing here
runs per step.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from marf_tpu_torch.ops.homography import normal_transform_pixel, normalize_homography
from marf_tpu_torch.utils.console import log

# Candidate roots for `<root>/<dataset>`, relative to the working directory
# and to the repository; `data.root` replaces them
_DATA_ROOTS = (
    "data/planar",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data", "planar"),
)


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


def resolve_data_root(dataset: str, root: str | None = None) -> str:
    """The directory holding `<dataset>/0.png` etc.: under `root` when given,
    else under the first candidate root that has it."""
    candidates = [root] if root else list(_DATA_ROOTS)
    for cand in candidates:
        if cand and os.path.isdir(os.path.join(cand, dataset)):
            return os.path.join(cand, dataset)
    raise FileNotFoundError(f"dataset {dataset!r} not found under any of {candidates}")


def _to_tensor(im) -> np.ndarray:
    """PIL image -> [C, H, W] float32, uint8 scaled to [0, 1] (torchvision's
    to_tensor)."""
    arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    arr = arr.transpose(2, 0, 1)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    return arr.astype(np.float32)


def load_images(fps: list[str] | None, mode: str = "RGB", invert_gray: bool = False,
                thumbnail_hw: tuple[int, int] | None = None) -> np.ndarray | None:
    """A stack of images as [B, C, h, w] float32, or None when `fps` is empty
    (reference inputs.py:16-33). `invert_gray` thresholds a grayscale mask to
    `im < 0.5` (the SIDAR occlusion convention); `thumbnail_hw` is the
    (patch_H, patch_W) LANCZOS thumbnail of use_cropped_images."""
    from PIL import Image

    if not fps:
        return None
    if not isinstance(fps, list):
        raise TypeError("load_images requires a list of file paths")
    loaded = []
    for fp in fps:
        im = Image.open(fp).convert(mode)
        if thumbnail_hw is not None:
            im.thumbnail((thumbnail_hw[1], thumbnail_hw[0]), Image.Resampling.LANCZOS)
        arr = _to_tensor(im)
        if mode == "L" and invert_gray:
            arr = (arr < 0.5).astype(np.float32)
        loaded.append(arr)
    return np.stack(loaded)


def load_single_image(fp: str, mode: str = "RGB") -> np.ndarray:
    """One image as [C, H, W] float32 (reference inputs.py:43-48)."""
    from PIL import Image

    return _to_tensor(Image.open(fp).convert(mode))


def _save_png(chw: np.ndarray, path: str) -> None:
    """[C, H, W] in [0, 1] -> an 8-bit PNG (gray for C = 1)."""
    from PIL import Image

    hwc = (np.clip(np.asarray(chw), 0.0, 1.0).transpose(1, 2, 0) * 255).astype(np.uint8)
    Image.fromarray(hwc[..., 0] if hwc.shape[-1] == 1 else hwc).save(path)


def save_images(images, suffix: str, out_dir: str = ".") -> list[str]:
    """Write a [B, C, H, W] stack as `<i>-<suffix>.png` (reference
    inputs.py:35-41); returns the paths."""
    paths = []
    for i, im in enumerate(np.asarray(images)):
        path = os.path.join(out_dir, f"{i}-{suffix}.png")
        _save_png(im, path)
        paths.append(path)
    return paths


def load_homography(fps: list[str] | None, width: int, height: int, append_identity: bool = True) -> np.ndarray | None:
    """Plain-text `.mat` 3x3 homographies, normalized on the CPU, with the
    identity prepended for image 0 (reference inputs.py:87-105). The
    reference passes (W, H) where kornia expects (h, w) (SURVEY.md
    §2.4(5)), so the sizes go in as (width, height)."""
    if not fps:
        return None
    if not isinstance(fps, list):
        raise TypeError("load_homography requires a list of file paths")
    homs = [np.eye(3, dtype=np.float32)] if append_identity else []
    homs += [np.loadtxt(fp).astype(np.float32) for fp in fps]
    return normalize_homography(torch.from_numpy(np.stack(homs)), (width, height), (width, height)).numpy()


def prepare_images(cfg, fps_images=None, fps_masks=None, fp_gt=None, fps_hom=None, edges=True) -> dict:
    """The dataset dict of numpy arrays (reference inputs.py:107-127): gt,
    rgb, gt_hom, masks, masks_eroded, gray, edges; None where an input is
    disabled."""
    thumb = (cfg.patch_H, cfg.patch_W) if cfg.use_cropped_images else None
    data = {"gt": load_single_image(fp_gt) if fp_gt else None}
    data["rgb"] = load_images(fps_images, thumbnail_hw=thumb)
    data["gt_hom"] = load_homography(fps_hom, cfg.W, cfg.H)
    data["masks"] = load_images(fps_masks, mode="L", invert_gray=True, thumbnail_hw=thumb)
    data["masks_eroded"] = erode_images_host(data["masks"]) if data["masks"] is not None else None
    data["gray"] = load_images(fps_images, mode="L", thumbnail_hw=thumb)
    data["edges"] = compute_edges_host(data["gray"]) if edges else None
    return data


def load_planar_dataset(cfg, dataset: str, root: str | None = None, use_masks=True, use_homographies=True,
                        use_edges=True) -> dict:
    """The `<root>/<dataset>` layout for a PlanarConfig (reference
    model/planar.py:59-78). Missing `H_0_i.mat` files turn the
    Homography_Error metric off with a warning."""
    ddir = resolve_data_root(dataset, root)
    image_paths = [os.path.join(ddir, f"{i}.png") for i in range(cfg.batch_size)]
    mask_paths = [os.path.join(ddir, f"{i}-m.png") for i in range(cfg.batch_size)]
    hom_paths = [os.path.join(ddir, f"H_0_{i}.mat") for i in range(1, cfg.batch_size)]
    if use_homographies and not all(os.path.isfile(p) for p in hom_paths):
        log.warn(f"homography files missing under {ddir}; disabling Homography_Error metric")
        use_homographies = False
    return prepare_images(
        cfg,
        fps_images=image_paths,
        fps_masks=mask_paths if use_masks else None,
        fp_gt=os.path.join(ddir, "gt.png"),
        fps_hom=hom_paths if use_homographies else None,
        edges=use_edges,
    )


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


def save_planar_dataset(data: dict, ddir: str, H: int, W: int) -> None:
    """Write a full-size dataset dict (synthesize_planar_dataset with
    use_cropped_images off) in the on-disk layout under `ddir`: `i.png`,
    `i-m.png` with occlusion = 1, `gt.png` and `H_0_i.mat`, the pixel-space
    homographies that `load_homography` normalizes back to `gt_hom`."""
    os.makedirs(ddir, exist_ok=True)
    for i, im in enumerate(data["rgb"]):
        _save_png(im, os.path.join(ddir, f"{i}.png"))
    save_images(1.0 - data["masks"], "m", ddir)
    _save_png(data["gt"], os.path.join(ddir, "gt.png"))
    norm = normal_transform_pixel(W, H, dtype=torch.float64).numpy()  # the (W, H)-as-(h, w) order
    for i, g in enumerate(np.asarray(data["gt_hom"], np.float64)[1:], start=1):
        np.savetxt(os.path.join(ddir, f"H_0_{i}.mat"), np.linalg.inv(norm) @ g @ norm)


def to_device(data: dict, device) -> dict:
    """Move the dataset dict to `device` once as float32; None entries pass through."""
    return {k: None if v is None else torch.as_tensor(np.asarray(v), dtype=torch.float32).to(device) for k, v in data.items()}
