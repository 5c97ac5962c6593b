"""The trace reduction and every per-layer reader on a recorded fake trace."""

from __future__ import annotations

import types

import pytest

from benchmark import counts, trace
from benchmark.loops import Record
from benchmark.program import Spans
from benchmark.run import load_reader
from benchmark.tests.conftest import ROOT, load

# a traced window of 1000 us: two kernels overlapping, a copy, and gaps
# under the harness's dispatch and metrics_read ranges
OPS = sorted([(100.0, 300.0, "void tc_gemm_kernel<64>(float*)"), (250.0, 400.0, "expm_kernel"),
              (600.0, 650.0, "Memcpy DtoH (Device -> Pinned)"), (2000.0, 2100.0, "outside")])
RANGES = sorted([(0.0, 1000.0, "bench.traced_window"), (0.0, 90.0, "bench.dispatch"),
                 (400.0, 700.0, "bench.metrics_read"), (500.0, 560.0, "bench.dispatch")])
# an eager chunk of 2 steps: K1 twice (its device-side projections), other ops
EAGER_OPS = [(0.0, 50.0, "k1_main"), (50.0, 60.0, "k1_presplit"), (60.0, 70.0, "adam"),
             (100.0, 150.0, "k1_main"), (150.0, 160.0, "k1_presplit"), (160.0, 180.0, "expm")]
EAGER_RANGES = [(0.0, 1.0, "bench.K1"), (90.0, 91.0, "bench.K1")]
EAGER_PROJ = [(0.0, 60.0, "bench.K1"), (100.0, 160.0, "bench.K1")]


def test_window():
    w = trace.window(OPS, RANGES)
    assert w.window_us == 1000.0
    assert w.busy_us == pytest.approx(300.0 + 50.0)  # [100, 400] and [600, 650]
    assert w.idle_share == pytest.approx(0.65)
    assert w.top_ops[0] == ("tc_gemm_kernel<64>", 200.0)
    # gaps, named by the innermost range open at their midpoint: [0, 100]
    # dispatch; [400, 600] the dispatch opened at 500 inside metrics_read;
    # [650, 1000] none
    names = dict((round(us), n) for n, us in w.gaps)
    assert names == {100: "dispatch", 200: "dispatch", 350: "none"}


def test_attribute():
    a = trace.attribute(EAGER_OPS, EAGER_RANGES, EAGER_PROJ, ["K1", "K5"])
    assert a["device_us"] == 150.0
    assert a["K1"] == {"calls": 2, "us": 120.0}
    assert "K5" not in a


def run_for(cell: str, loop: str, record: Record, spans=None):
    bench = load(ROOT, "BENCHMARK.json")
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    options = load(ROOT, "benchmark", "configs", f"{w['config']}.json")["options"]
    return types.SimpleNamespace(options=options, loop=loop, record=record, spans=spans or Spans())


def record(**over) -> Record:
    rec = Record(e2e={"steps_per_s": 150.0}, window=(10.0, 20.0), attempted=1500, failed=0, first_steps={},
                 steps_per_chunk=100)
    for k, v in over.items():
        setattr(rec, k, v)
    return rec


def test_steady_readers():
    spans = Spans()
    spans.records = [("dispatch", 11.0, 11.012), ("dispatch", 12.0, 12.014), ("dispatch", 30.0, 31.0)]
    rec = record(traced=trace.window(OPS, RANGES), attribution=trace.attribute(EAGER_OPS, EAGER_RANGES, EAGER_PROJ,
                                                                                ["K1"]), attribution_steps=2)
    run = run_for("fixed_masks.steady", "steady", rec, spans)
    assert load_reader(ROOT, "step_host_ms.steady")(run) == pytest.approx(0.013 / 100 * 1e3)
    assert load_reader(ROOT, "idle_share.steady")(run) == pytest.approx(65.0)
    assert load_reader(ROOT, "idle_share.trainer")(run) is None
    assert load_reader(ROOT, "ops_device_ms")(run) == pytest.approx((150.0 - 120.0) / 2 / 1e3)
    k1_call_s = 120.0 / 2 / 1e6
    assert load_reader(ROOT, "K1_roofline")(run) == pytest.approx(100 * counts.k1_bound_s(run.options) / k1_call_s)
    assert load_reader(ROOT, "K5K6_roofline")(run) is None
    mfu = 100 * counts.step_flops(run.options) * 150.0 / 495e12
    assert load_reader(ROOT, "step_mfu")(run) == pytest.approx(mfu)
    assert load_reader(ROOT, "vis_ms")(run) is None


def test_k5k6_reader():
    a = {"device_us": 30000.0, "K5": {"calls": 2, "us": 16000.0}, "K6": {"calls": 2, "us": 12000.0}}
    run = run_for("implicit_heads.steady", "steady", record(attribution=a, attribution_steps=2))
    assert load_reader(ROOT, "K5K6_roofline")(run) == pytest.approx(
        100 * counts.k5k6_bound_s(run.options) / (28000.0 / 2 / 1e6))
    assert load_reader(ROOT, "ops_device_ms")(run) == pytest.approx(1.0)


def test_trainer_readers():
    spans = Spans()
    spans.records = [("visualize", 5.0, 5.3), ("visualize", 12.0, 12.2), ("visualize", 19.0, 19.4)]
    rec = record(e2e={"trainer_steps_per_s": 100.0}, traced=trace.window(OPS, RANGES))
    run = run_for("fixed_masks.trainer", "trainer", rec, spans)
    assert load_reader(ROOT, "vis_ms")(run) == pytest.approx(300.0)
    assert load_reader(ROOT, "idle_share.trainer")(run) == pytest.approx(65.0)
    for name in ("idle_share.steady", "step_host_ms.steady", "step_mfu", "ops_device_ms", "K1_roofline"):
        assert load_reader(ROOT, name)(run) is None


def test_nothing_to_read():
    """A trace with no device operation (a CPU run) reads nothing, never 0."""
    empty = trace.window([], [(0.0, 10.0, "bench.traced_window")])
    rec = record(traced=empty, attribution={"device_us": 0.0}, attribution_steps=2)
    run = run_for("fixed_masks.steady", "steady", rec)
    for name in ("idle_share.steady", "ops_device_ms", "K1_roofline"):
        assert load_reader(ROOT, name)(run) is None
