"""The program's own spans (`marf_tpu_torch.utils.trace`: the port's tracer,
on the host clock of the harness's spans), for the readers of per-layer
metrics that read them. A program without the tracer gives None, never an
error: its readers then report nothing."""

from __future__ import annotations


def tracer():
    """The port's tracer module, or None where the program has none."""
    try:
        from marf_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def mean_ms(run, name: str) -> float | None:
    """The mean milliseconds of the program's `name` spans begun in the
    run's untraced window, or None where there are none."""
    trace = tracer()
    if trace is None:
        return None
    t0, t1 = run.record.window
    ms = [(s.end - s.start) * 1e3 for s in trace.spans(name, t0, t1)]
    return sum(ms) / len(ms) if ms else None


def before_window(run, name: str) -> list:
    """The program's `name` spans begun in the run's set-up: from its start
    (the window's opening less `setup_s`) to the window's opening."""
    trace = tracer()
    t0 = run.record.window[0]
    return [] if trace is None else trace.spans(name, t0 - run.record.e2e["setup_s"], t0)
