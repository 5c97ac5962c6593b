"""The shared-head cell `implicit_shared.steady`: its configuration and files
found by name, the K3 + K4 count against a hand count, its readers on
recorded fakes, and, driven on the CPU at a tiny size, the planted faults
that the comparison fails and the dedup path's traced run."""

from __future__ import annotations

import json
import os
import sys
import time

import pytest

from benchmark import counts, counts_shared
from benchmark.run import cell_inputs, find, load_reader, run_cell
from benchmark.tests.conftest import ROOT, load
from benchmark.tests.test_bench_faults import band_frequency, half_batch, state_unchanged
from benchmark.tests.test_bench_readers import record, run_for

CELL = "implicit_shared.steady"
CONFIG = "marf_implicit_shared_f32"


def test_config_and_files_by_name(bench):
    spec = find(bench["configs"], CONFIG, "configuration")
    cfg = load(ROOT, spec["file"])
    assert cfg["name"] == CONFIG and set(cfg["reduced"]) == {"barf_c2f", "dataset", "use_masks", "use_implicit_mask"}
    heads = load(ROOT, "benchmark", "configs", "marf_implicit_heads_f32.json")["options"]
    # the per-image heads' configuration with one shared head: nothing else differs
    assert cfg["options"] == dict(heads, build_single_masks=False)
    w = find(bench["workloads"], CELL, "workload")
    config, traffic, options = cell_inputs(ROOT, bench, w)
    assert w["chips"] == 1 and config["name"] == CONFIG and traffic["loop"] == "steady"
    assert options["use_implicit_mask"] and not options["build_single_masks"] and not options["use_masks"]
    limits = load(ROOT, "benchmark", "limits", f"{CELL}.json")
    assert limits["cell"] == CELL
    for m in bench["per_layer"]:
        if CELL in m["workloads"]:
            assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
    named = {m["name"] for m in bench["per_layer"] + bench["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert {"K3K4_roofline", "setup_dedup_s", "steps_per_s", "setup_s", "K1_roofline", "step_mfu"} <= named


def test_k3k4_hand_count():
    # HW = 2 x 3 columns; the head forward 56 x 256 + 3 x 256 x 256 + 256 x 1
    # MACs a column, its backward every weight gradient and the input
    # gradients of all layers but the first
    opt = {"patch_H": 2, "patch_W": 3, "batch_size": 4, "use_cropped_images": True,
           "tpu": {"compute_dtype": "float32"}}
    fwd = 2 * (56 * 256 + 3 * 256 * 256 + 256)
    bwd = fwd + 2 * (3 * 256 * 256 + 256)
    flops = 6 * (fwd + bwd)
    weights = 4 * (56 * 256 + 256 + 3 * (256 * 256 + 256) + 256 + 1)
    nbytes = 6 * 4 * 57 + 24 * 4 * 3 + 2 * weights
    assert counts_shared.dedup_columns(opt) == 6
    assert counts_shared.k3k4_bound_s(opt) == pytest.approx(max(flops / 495e12, nbytes / 3.35e12))
    # at the published size the head's work at HW = 43,200 columns: 53.5 GFLOP, compute-bound
    shared = load(ROOT, "benchmark", "configs", f"{CONFIG}.json")["options"]
    assert counts_shared.dedup_columns(shared) == 43_200
    assert counts_shared.k3k4_bound_s(shared) == pytest.approx(53.50e9 / 495e12, rel=1e-3)
    # `step_mfu` counts the head over every position, as the model defines the work
    assert counts.step_flops(shared) == pytest.approx(534.6e9, rel=1e-3)


def test_readers_on_a_fake():
    a = {"device_us": 9000.0, "K1": {"calls": 2, "us": 11000.0}, "K3": {"calls": 2, "us": 1000.0},
         "K4": {"calls": 2, "us": 2800.0}}
    run = run_for(CELL, "steady", record(attribution=a, attribution_steps=2))
    assert load_reader(ROOT, "K3K4_roofline")(run) == pytest.approx(
        100 * counts_shared.k3k4_bound_s(run.options) / (3800.0 / 2 / 1e6))
    assert load_reader(ROOT, "K5K6_roofline")(run) is None


def test_readers_find_nothing_without_their_ranges_and_span(monkeypatch):
    """A fallback off the dedup path (no K3 or K4 range) and a program
    without the `setup.dedup` span, or without the tracer (the parent of
    the span), read None and raise nothing."""
    from marf_tpu_torch.utils import trace
    from marf_tpu_torch.utils.trace import Span, Tracer

    for a in ({"device_us": 1.0, "K5": {"calls": 1, "us": 1.0}, "K6": {"calls": 1, "us": 1.0}},
              {"device_us": 1.0, "K3": {"calls": 1, "us": 1.0}}, None):
        assert load_reader(ROOT, "K3K4_roofline")(run_for(CELL, "steady", record(attribution=a))) is None
    run = run_for(CELL, "steady", record(e2e={"steps_per_s": 100.0, "setup_s": 6.0}, window=(10.0, 20.0)))
    t = Tracer()
    t.records.extend([Span("setup.make_step", 5.0, 5.5, None, {}, 0)])
    monkeypatch.setattr(trace, "spans", t.spans)
    assert load_reader(ROOT, "setup_dedup_s")(run) is None
    t.records.extend([Span("setup.dedup", 1.0, 1.2, None, {}, 1), Span("setup.dedup", 5.1, 5.3, 0, {}, 2)])
    assert load_reader(ROOT, "setup_dedup_s")(run) == pytest.approx(0.2)  # this run's set-up only
    import marf_tpu_torch.utils

    monkeypatch.delattr(marf_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "marf_tpu_torch.utils.trace", None)  # its import now raises
    assert load_reader(ROOT, "setup_dedup_s")(run) is None


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, band_frequency],
                         ids=["state_unchanged", "half_batch", "band_frequency"])
def test_fault_fails(tiny_root, bench, monkeypatch, fault):
    fault(monkeypatch)
    result = run_cell(tiny_root, bench, find(bench["workloads"], CELL, "w"), 5, 0.3, False, "cpu",
                      time.perf_counter())
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_dedup_path_traced_on_the_cpu(tiny_root, bench):
    """The cell with its step forced onto the dedup path (the kernels' plain
    twins; `auto` takes the autograd step on the CPU): the comparison passes
    and the traced line reads the staging's span; nothing of the device."""
    path = os.path.join(tiny_root, "benchmark", "configs", f"{CONFIG}.json")
    cfg = load(path)
    cfg["options"]["tpu"]["fused_step"] = "on"
    with open(path, "w") as f:
        json.dump(cfg, f)
    result = run_cell(tiny_root, bench, find(bench["workloads"], CELL, "w"), 2**31 + 13, 0.5, True, "cpu",
                      time.perf_counter())
    assert result["correct"] is True, result["checks"]
    metrics = result["metrics"]
    assert metrics["setup_dedup_s"]["value"] > 0 and metrics["setup_dedup_s"]["unit"] == "s"
    assert {"setup_port_s", "setup_capture_s"} <= set(metrics)
    assert not {"K3K4_roofline", "K1_roofline", "ops_device_ms", "idle_share.steady"} & set(metrics)


@pytest.mark.cuda
def test_control_and_faults_fail_program_passes(tmp_path):
    """On a card, at the configuration's own size, on three seeds: the
    program within the cell's limits; the TF32 control, the half batch and
    the extras dropped each over one of them.

        python -m pytest benchmark/tests/test_bench_shared.py -m cuda -q
    """
    import torch

    from benchmark import control_shared
    from benchmark.check import load_limits

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = load(ROOT, "BENCHMARK.json")
    _, traffic, options = cell_inputs(ROOT, bench, {"config": CONFIG, "traffic": "steady"})
    limits = load_limits(ROOT, CELL)
    for seed in (201, 202, 203):
        rows = {r["kind"]: r for r in control_shared.readings(options, traffic, seed, "cuda", str(tmp_path / str(seed)))}
        assert rows["dedup"]["E"] > 0
        for kind, should_pass in (("program", True), ("control_tf32", False), ("fault_half_batch", False),
                                  ("fault_extras_dropped", False)):
            over = [k for k, v in rows[kind].items() if k in limits and v > limits[k]]
            assert (not over) == should_pass, (seed, kind, rows[kind], limits)
