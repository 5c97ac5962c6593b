"""Operation and byte counts of the planar model's work, and the card's
published peaks: the yardstick's arithmetic, frozen here so that it does not
move when the program changes.

Every count is taken from shapes (the configuration's options), never from
the program. FLOPs are 2 per multiply-add of the matrix products; the
elementwise work (posenc, activations, the loss, Adam) is left out, so a
share of a peak computed from these counts is a lower bound on the work.

What a count includes:
  - The rgb MLP (the neural image): forward, and a backward that forms every
    layer's weight gradient and every layer's input gradient, the first
    layer's too: the warp's gradient reaches the coordinates through the
    encoding. So forward + backward = 3 x the forward's products.
  - The mask head (Ha-NeRF, one per image or one shared): its first layer
    counted at the depth the function needs. The view embedding is indexed
    by `image.long()`, which takes two values per channel, so the 384
    embedded-RGB inputs fold into 8 one-hot rows, and with the 42 uv rows
    and 6 zero rows the layer is 56 wide, as the port's `csrc/mask_head.cuh`
    computes it: about 0.42 MFLOP per point forward, where the naive
    426-wide count gives 0.61 (about 45% more). Its backward forms every
    weight gradient and the input gradients of every layer but the first,
    whose input is a constant.
  - Each piece of work counted once: no forward recomputed in a backward.
    A kernel that recomputes (K6 recomputes the mask forward) is held to
    the bound of the work, not of what it chose to do.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): float32
configurations are held to 495 TFLOP/s, the TF32 tensor-core rate, since no
float32-accurate product runs faster on this card than TF32; the port's
3xTF32 engine reaches at most a third of it (165), which is that
implementation's ceiling and never the divisor here. bfloat16 to 989
TFLOP/s. Memory 3.35 TB/s.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
F32 = 4

MASK_WIDTH = 256
MASK_LAYERS = 5  # 4 hidden layers of MASK_WIDTH, one output
MASK_IN_FOLDED = 56  # 42 uv + 8 one-hot RGB combinations + 6 zero rows


def peak_flops(options: dict) -> float:
    return PEAK_FLOPS[str((options.get("tpu") or {}).get("compute_dtype", "float32"))]


def points(options: dict) -> int:
    """N = B x h x w, the points one step trains on."""
    h, w = (options["patch_H"], options["patch_W"]) if options.get("use_cropped_images", True) else (
        options["H"], options["W"])
    return int(options["batch_size"]) * int(h) * int(w)


def rgb_dims(options: dict) -> list[tuple[int, int]]:
    """(k_in, k_out) per layer of the neural image, skip re-concats included."""
    arch = options["arch"]
    L = (arch.get("posenc") or {}).get("L_2D") if arch.get("posenc") else None
    d_in = 2 + 4 * L if L else 2
    layers = list(arch["layers"])
    skip = set(arch.get("skip") or [])
    dims = []
    for li, (k_in, k_out) in enumerate(zip(layers[:-1], layers[1:])):
        k_in = d_in if li == 0 else k_in
        dims.append((k_in + (d_in if li in skip else 0), k_out))
    return dims


def mask_dims() -> list[tuple[int, int]]:
    widths = [MASK_IN_FOLDED] + [MASK_WIDTH] * (MASK_LAYERS - 1) + [1]
    return list(zip(widths[:-1], widths[1:]))


def _macs(dims) -> int:
    return sum(a * b for a, b in dims)


def rgb_flops_per_point(options: dict) -> dict:
    fwd = 2 * _macs(rgb_dims(options))
    return {"fwd": fwd, "bwd": 2 * fwd}


def mask_flops_per_point() -> dict:
    dims = mask_dims()
    fwd = 2 * _macs(dims)
    return {"fwd": fwd, "bwd": fwd + 2 * _macs(dims[1:])}


def step_flops(options: dict) -> float:
    """Model FLOPs of one training step: the rgb MLP and (implicit masks) the
    mask head over all N points, forward and backward, no recompute."""
    n = points(options)
    r = rgb_flops_per_point(options)
    total = n * (r["fwd"] + r["bwd"])
    if options.get("use_implicit_mask"):
        m = mask_flops_per_point()
        total += n * (m["fwd"] + m["bwd"])
    return float(total)


def _bound_s(flops: float, nbytes: float, options: dict) -> float:
    return max(flops / peak_flops(options), nbytes / PEAK_BYTES_PER_S)


def weight_bytes(dims) -> int:
    return F32 * sum(a * b + b for a, b in dims)


def k1_bound_s(options: dict) -> float:
    """K1 (rgb step, warp in the kernel) on N points: the rgb MLP forward and
    backward; bytes: the (u, v, b) grid, targets and mask read, rgb and the
    squared error written, the weights read and their gradients written."""
    n = points(options)
    r = rgb_flops_per_point(options)
    nbytes = n * F32 * (3 + 3 + 1 + 3 + 1) + 2 * weight_bytes(rgb_dims(options))
    return _bound_s(n * (r["fwd"] + r["bwd"]), nbytes, options)


def k5k6_bound_s(options: dict) -> float:
    """K5 + K6 together on N points: the mask head forward and backward and
    the rgb MLP forward and backward, each once; bytes: X (56 rows), the
    coordinates, targets and the edge error read, rgb, m and dcoords
    written, every head's and the MLP's weights read and gradients written.
    What K5 hands K6 is internal to the pair and not counted."""
    n = points(options)
    r = rgb_flops_per_point(options)
    m = mask_flops_per_point()
    heads = int(options["batch_size"]) if options.get("build_single_masks") else 1
    nbytes = n * F32 * (MASK_IN_FOLDED + 2 + 3 + 1 + 3 + 1 + 2)
    nbytes += 2 * (weight_bytes(rgb_dims(options)) + heads * weight_bytes(mask_dims()))
    return _bound_s(n * (r["fwd"] + r["bwd"] + m["fwd"] + m["bwd"]), nbytes, options)
