"""`setup_capture_s`: the seconds of the set-up's first chunk, the program's
self time (less its child spans, so the kernels' `build.<lib>`, nvcc on a
cold cache among them) of the first `chunk.warmup` and `chunk.capture`
begun in the set-up: the eager steps before the capture and the
capture. A chunk that captures nothing (the CPU) reads its first
`chunk.eager` instead."""

from benchmark.program_spans import before_window, tracer


def read(run):
    first = [s[0] for s in (before_window(run, "chunk.warmup"), before_window(run, "chunk.capture")) if s]
    if not first:
        first = before_window(run, "chunk.eager")[:1]
    return sum(tracer().self_time(s) for s in first) if first else None
