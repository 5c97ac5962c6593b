"""The counts of `benchmark/counts.py` against hand counts."""

from __future__ import annotations

import pytest

from benchmark import counts
from benchmark.tests.conftest import ROOT, load


def tiny(**over):
    opt = {"H": 8, "W": 8, "patch_H": 2, "patch_W": 3, "batch_size": 2, "use_cropped_images": True,
           "arch": {"layers": [None, 4, 3], "skip": [], "posenc": {"L_2D": 1}}, "tpu": {"compute_dtype": "float32"}}
    opt.update(over)
    return opt


def test_rgb_hand_count():
    # input 2 + 4 x 1 = 6; forward MACs 6 x 4 + 4 x 3 = 36; backward twice that
    assert counts.rgb_dims(tiny()) == [(6, 4), (4, 3)]
    assert counts.rgb_flops_per_point(tiny()) == {"fwd": 72, "bwd": 144}
    assert counts.points(tiny()) == 2 * 2 * 3
    assert counts.step_flops(tiny()) == 12 * (72 + 144)


def test_skip_and_no_posenc():
    opt = tiny(arch={"layers": [None, 4, 4, 3], "skip": [1], "posenc": None})
    assert counts.rgb_dims(opt) == [(2, 4), (4 + 2, 4), (4, 3)]


def test_mask_head_hand_count():
    # 56 x 256 + 3 x 256 x 256 + 256 x 1 MACs forward; backward: every weight
    # gradient, and the input gradients of all layers but the first
    fwd_macs = 56 * 256 + 3 * 256 * 256 + 256
    assert counts.mask_flops_per_point() == {"fwd": 2 * fwd_macs, "bwd": 2 * fwd_macs + 2 * (3 * 256 * 256 + 256)}
    assert counts.mask_flops_per_point()["fwd"] == pytest.approx(0.4224e6, rel=1e-4)


def test_published_sizes():
    fixed = load(ROOT, "benchmark", "configs", "marf_fixed_masks_f32.json")["options"]
    heads = load(ROOT, "benchmark", "configs", "marf_implicit_heads_f32.json")["options"]
    assert counts.points(fixed) == 216_000
    # K1: 267.1 GFLOP per step, 0.540 ms at 495 TFLOP/s (compute-bound)
    assert counts.step_flops(fixed) == pytest.approx(267.1e9, rel=1e-3)
    assert counts.k1_bound_s(fixed) == pytest.approx(267.1e9 / 495e12, rel=1e-3)
    # K5 + K6, each piece once: 534.6 GFLOP
    assert counts.step_flops(heads) == pytest.approx(534.6e9, rel=1e-3)
    assert counts.k5k6_bound_s(heads) == pytest.approx(534.6e9 / 495e12, rel=1e-3)
    assert counts.peak_flops(dict(fixed, tpu={"compute_dtype": "bfloat16"})) == 989e12


def test_bytes_bound_when_flops_vanish():
    opt = tiny(arch={"layers": [None, 1, 3], "skip": [], "posenc": None}, batch_size=1000, patch_H=100, patch_W=100)
    assert counts.k1_bound_s(opt) > counts.points(opt) * 2 * 3 * (2 + 3) / 495e12
    assert counts.k1_bound_s(opt) == pytest.approx(
        (counts.points(opt) * 4 * 11 + 2 * counts.weight_bytes(counts.rgb_dims(opt))) / counts.PEAK_BYTES_PER_S)
