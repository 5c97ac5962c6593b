"""`vis_wait_ms`, the reader of the program's `vis.wait` spans (the frame
hand-off's wait for the writer thread): on a recorded fake, and nothing from
a program without the tracer or without the writer."""

from __future__ import annotations

import sys

import pytest

from benchmark.run import load_reader
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_bench_readers import record, run_for
from marf_tpu_torch.utils import trace
from marf_tpu_torch.utils.trace import Span, Tracer

# a trainer window 10-20 (set-up 6 s): a frame before it and three in it,
# each `train.vis` holding its render and its hand-off's wait; the writer's
# `vis.write` spans on their own thread, with no parent
SPANS = [
    Span("train.vis", 9.0, 9.02, None, {"it": 100}, 0),
    Span("vis.wait", 9.01, 9.02, 0, {"it": 100}, 1),
    Span("vis.write", 9.02, 9.3, None, {"it": 100}, 2),
    Span("train.vis", 11.0, 11.01, None, {"it": 200}, 3),
    Span("vis.wait", 11.006, 11.0061, 3, {"it": 200}, 4),
    Span("vis.write", 11.01, 11.3, None, {"it": 200}, 5),
    Span("train.vis", 12.0, 12.01, None, {"it": 300}, 6),
    Span("vis.wait", 12.005, 12.0051, 6, {"it": 300}, 7),
    Span("train.vis", 13.0, 13.02, None, {"it": 400}, 8),
    Span("vis.wait", 13.001, 13.0018, 8, {"it": 400}, 9),
]


def _run():
    return run_for("fixed_masks.trainer", "trainer", record(e2e=dict(trainer_steps_per_s=100.0, setup_s=6.0),
                                                            window=(10.0, 20.0)))


def test_vis_wait_ms_reads_the_waits_begun_in_the_window(monkeypatch):
    t = Tracer()
    t.records.extend(SPANS)
    monkeypatch.setattr(trace, "spans", t.spans)
    assert load_reader(ROOT, "vis_wait_ms")(_run()) == pytest.approx((0.1 + 0.1 + 0.8) / 3)


@pytest.mark.parametrize("program", ["no_tracer", "no_writer"])
def test_vis_wait_ms_reports_nothing_without_the_spans(monkeypatch, program):
    """The tracer's parent reports nothing and raises nothing; so does a
    program that writes its frames in line (no `vis.wait`)."""
    if program == "no_tracer":
        monkeypatch.setitem(sys.modules, "marf_tpu_torch.utils.trace", None)
    else:
        t = Tracer()
        t.records.extend(s for s in SPANS if s.name != "vis.wait")
        monkeypatch.setattr(trace, "spans", t.spans)
    assert load_reader(ROOT, "vis_wait_ms")(_run()) is None
