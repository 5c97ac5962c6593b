"""The control on a card (marked `cuda`; it skips without one): at each
configuration's own size, on three seeds, the program's numbers stay within
the limits of each of its cells, and the control, the reference in TF32 in
the program's place, fails one of them, as does the planted half batch.

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q     # on the card
"""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.check import load_limits
from benchmark.run import cell_inputs, load_json
from benchmark.tests.conftest import ROOT

CASES = [("marf_fixed_masks_f32", ["fixed_masks.steady", "fixed_masks.trainer"]),
         ("marf_implicit_heads_f32", ["implicit_heads.steady", "implicit_heads.trainer"])]


@pytest.mark.cuda
@pytest.mark.parametrize("config,cells", CASES)
def test_control_fails_program_passes(tmp_path, config, cells):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = load_json(ROOT, "BENCHMARK.json")
    _, traffic, options = cell_inputs(ROOT, bench, {"config": config, "traffic": "steady"})
    for seed in (101, 102, 103):
        rows = {r["kind"]: r for r in control.readings(options, traffic, seed, "cuda", str(tmp_path / str(seed)))}
        for cell in cells:
            limits = load_limits(ROOT, cell)
            for kind, should_pass in (("program", True), ("control_tf32", False), ("fault_half_batch", False)):
                over = [k for k, v in rows[kind].items() if k in limits and v > limits[k]]
                assert (not over) == should_pass, (seed, cell, kind, rows[kind], limits)
