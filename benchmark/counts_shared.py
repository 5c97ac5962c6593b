"""Operation and byte counts of the shared mask head's work on its dedup
columns (K3's forward and K4's backward), from shapes, beside
`benchmark/counts.py`'s, under its rules.

The dedup step runs the shared head on K = HW + E columns: one slot0 column
per pixel and E extras where an image's truncated colour differs from its
pixel's majority. E depends on the photos, so the count takes the HW
columns alone: the least work any exact dedup does (every pixel needs its
column), the same on every seed. The extras' few per cent of columns are
left out, as `counts.py` leaves out the elementwise work, so a share of the
peak computed from this count is a lower bound.
"""

from __future__ import annotations

from benchmark import counts


def dedup_columns(options: dict) -> int:
    """HW, the pixels of one patch: the dedup columns every seed has."""
    n = counts.points(options)
    return n // int(options["batch_size"])


def k3k4_bound_s(options: dict) -> float:
    """K3 + K4 on the HW columns: the mask head's forward and its backward
    (every weight gradient, the input gradients of all layers but the
    first), each once (`counts.mask_flops_per_point`); bytes: X (56 rows)
    and m of each column, the per-position rgb and edge squared errors and
    the slot0 map read by K4, the head's weights read and their gradients
    written."""
    hw = dedup_columns(options)
    m = counts.mask_flops_per_point()
    nbytes = hw * counts.F32 * (counts.MASK_IN_FOLDED + 1) + counts.points(options) * counts.F32 * 3
    nbytes += 2 * counts.weight_bytes(counts.mask_dims())
    return max(hw * (m["fwd"] + m["bwd"]) / counts.peak_flops(options), nbytes / counts.PEAK_BYTES_PER_S)
