"""The readers of the program's own spans (`marf_tpu_torch.utils.trace`):
each on a recorded fake, nothing from a program without the tracer, and a
traced CPU run of a trainer cell and a steady cell that reports each."""

from __future__ import annotations

import sys
import time

import pytest

from benchmark.run import find, load_reader, run_cell
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_bench_readers import record, run_for
from marf_tpu_torch.utils import trace
from marf_tpu_torch.utils.trace import Span, Tracer

VIS = ["vis_render_ms", "vis_png_ms", "vis_panels_ms"]
SETUP = ["setup_port_s", "setup_capture_s"]

# a run whose set-up began at 4.0 (window 10-20, setup_s 6): one span of
# an earlier run in the same process, the set-up's phases, its first chunk
# (warm-up with a build inside, capture), two frames in the window and one
# before it
SPANS = [
    Span("setup.load_dataset", 1.0, 2.0, None, {}, 0),
    Span("setup.load_dataset", 4.0, 5.0, None, {}, 1),
    Span("setup.build_networks", 5.0, 5.5, None, {}, 2),
    Span("setup.optimizer", 5.5, 5.75, None, {}, 3),
    Span("setup.make_step", 5.75, 6.0, None, {}, 4),
    Span("chunk.warmup", 6.0, 8.0, None, {"steps": 100}, 5),
    Span("build.fused_step", 6.1, 7.6, 5, {}, 6),
    Span("chunk.capture", 8.0, 8.5, None, {}, 7),
    Span("chunk.replay", 8.6, 8.7, None, {"steps": 1}, 8),
    Span("train.vis", 9.0, 9.3, None, {"it": 100}, 9),
    Span("vis.render", 9.0, 9.01, 9, {"it": 100}, 10),
    Span("train.vis", 12.0, 12.3, None, {"it": 200}, 11),
    Span("vis.render", 12.0, 12.004, 11, {"it": 200}, 12),
    Span("vis.png", 12.004, 12.104, 11, {"it": 200}, 13),
    Span("vis.panels", 12.104, 12.3, 11, {"it": 200}, 14),
    Span("train.vis", 15.0, 15.4, None, {"it": 300}, 15),
    Span("vis.render", 15.0, 15.006, 15, {"it": 300}, 16),
    Span("vis.png", 15.006, 15.106, 15, {"it": 300}, 17),
    Span("vis.panels", 15.106, 15.4, 15, {"it": 300}, 18),
]


@pytest.fixture
def fake(monkeypatch):
    t = Tracer()
    t.records.extend(SPANS)
    monkeypatch.setattr(trace, "spans", t.spans)
    monkeypatch.setattr(trace, "self_time", t.self_time)
    return t


def _record(**e2e):
    return record(e2e=dict(e2e, setup_s=6.0), window=(10.0, 20.0))


def test_trainer_readers(fake):
    run = run_for("fixed_masks.trainer", "trainer", _record(trainer_steps_per_s=100.0))
    assert load_reader(ROOT, "vis_render_ms")(run) == pytest.approx(5.0)
    assert load_reader(ROOT, "vis_png_ms")(run) == pytest.approx(100.0)
    assert load_reader(ROOT, "vis_panels_ms")(run) == pytest.approx((196.0 + 294.0) / 2)
    # the phases of this run's set-up only; the first chunk less the build inside it
    assert load_reader(ROOT, "setup_port_s")(run) == pytest.approx(1.0 + 0.5 + 0.25 + 0.25)
    assert load_reader(ROOT, "setup_capture_s")(run) == pytest.approx(2.0 - 1.5 + 0.5)


def test_steady_run_reads_no_frame(fake):
    t = Tracer()
    t.records.extend(s for s in SPANS if not s.name.startswith(("train.", "vis.")))
    t.records.append(Span("chunk.eager", 21.0, 22.0, None, {"steps": 100}, 30))  # the attribution chunk
    fake.records = t.records
    run = run_for("fixed_masks.steady", "steady", _record(steps_per_s=150.0))
    assert all(load_reader(ROOT, name)(run) is None for name in VIS)
    assert load_reader(ROOT, "setup_capture_s")(run) == pytest.approx(1.0)


def test_an_eager_first_chunk_reads_when_nothing_was_captured(fake):
    fake.records.clear()
    fake.records.extend([Span("chunk.eager", 6.0, 7.0, None, {"steps": 10}, 0),
                         Span("chunk.eager", 7.0, 7.5, None, {"steps": 1}, 1)])
    run = run_for("fixed_masks.steady", "steady", _record(steps_per_s=150.0))
    assert load_reader(ROOT, "setup_capture_s")(run) == pytest.approx(1.0)
    assert load_reader(ROOT, "setup_port_s")(run) is None


def test_a_program_without_the_tracer_reports_nothing(monkeypatch):
    """The parent of the tracer: the readers return None and raise nothing."""
    monkeypatch.setitem(sys.modules, "marf_tpu_torch.utils.trace", None)
    run = run_for("fixed_masks.trainer", "trainer", _record(trainer_steps_per_s=100.0))
    for name in VIS + SETUP:
        assert load_reader(ROOT, name)(run) is None


@pytest.mark.parametrize("cell", ["implicit_heads.trainer", "fixed_masks.steady"])
def test_traced_run_reports_each_metric(tiny_root, bench, cell):
    result = run_cell(tiny_root, bench, find(bench["workloads"], cell, "w"), 2**31 + 11, 0.5, True, "cpu",
                      time.perf_counter())
    expected = SETUP + (VIS if cell.endswith(".trainer") else [])
    assert set(expected) <= set(result["metrics"])
    assert all(result["metrics"][n]["value"] > 0 for n in expected)
    if cell.endswith(".trainer"):
        parts = sum(result["metrics"][n]["value"] for n in VIS)
        assert parts <= result["metrics"]["vis_ms"]["value"]
