"""The port's tracer: spans and counters, kept in memory.

`span(name, **attrs)` times a block on `time.perf_counter()` (the host clock
of a caller's own timers) and records `Span(name, start, end, parent, attrs,
index)`: `parent` is the index of the span open around it (the one that
caused it), `index` its own, in the order spans open. `attrs` carries `it`,
the step counter at the end of the chunk the span belongs to (a span without
its own takes its parent's, so every span of one chunk shares it), and
`steps` where a span covers steps. While a profiler runs, the same block is
a range `marf.<name>` (`torch.profiler.record_function`) on its timeline,
beside the device's operations; without one, a span costs two clock
readings and an append, and opens no range.

Records go into a ring of `RING` spans; the per-name totals beside it
(count, seconds, steps) never drop. `count(name, n)` adds to `COUNTERS`
(the kernels' launches are `marf_tpu_torch.ops.cuda.LAUNCHES`). There is no
switch: spans are opened only at chunk and boundary granularity, never per
step inside a chunk and never inside a captured graph, whose replays run no
host code.

Spans come from two threads: the training loop's and the frame writer's
(utils/frame_writer.py). Each thread keeps its own stack of open spans, so a
span's `parent` is the span open around it on its own thread; indices,
records, totals and counters are taken under one lock. The profiler records
ranges on the thread that started it: the writer's spans are records only.

    span name         where                                  what it times
    setup.*           engine/trainer.py phases               load_dataset, build_networks,
                                                             optimizer (with its restore),
                                                             visualizer, make_step
      setup.dedup     engine/step.py _dedup_grads            the shared head's dedup staging
                                                             (stage_mask_inputs), inside
                                                             setup.make_step
    train.iter        Model.train                            one chunk: dispatch and reads
    train.dispatch    Model.train                            the chunk's dispatch
    train.read        Model.train                            a chunk's metric read (consume)
    train.scalars     Model.train                            TB scalars and the log line
    train.vis         Model.visualize                        the frame boundary's device part:
      vis.render                                             the full-canvas render to host
      vis.panel_forward                                      graph_forward for the panels, to host
      vis.wait        utils/frame_writer.py                  the hand-off's wait for the frame
                                                             before it to be written
    vis.write         utils/frame_writer.py (writer thread)  one frame's host part, with
      vis.png         Model._write_frame                     the frame's PNG, encoded, written
      vis.panels                                             every TB image panel, with
        tb.image      utils/tb.py                            one image summary
    train.ckpt        Model.save_checkpoint                  a checkpoint write
    train.video       Model.train                            vis.mp4
    chunk.*           engine/step.py TrainChunk              warmup, capture, eager, replay,
                                                             copy (the rows' read), wait
    build.<lib>       ops/cuda/_build.py load_library         nvcc on a miss, dlopen, bind

    counter           counts
    replays           steps replayed from captured graphs
    eager_steps       steps run eagerly
    captures          steps captured (a light and a heavy one per capture)
    frames            vis frames written; frame_bytes their bytes
    vis_handoffs      frames handed to the writer; vis_waits those that
                      found the frame before still being written
    tb_events         TB events written (scalars, images); tb_bytes their bytes
    presplit_products the 3xTF32 engine's pre-split products (its
                      warp-specialised kernel) that K1-K6's float32 calls
                      enqueued (ops/cuda presplit_products): eager steps
                      and captures, not replays
    ckpt_bytes        checkpoint bytes written
    dedup_columns     the shared head's dedup columns K = HW + E, once per step made
    dedup_extras      its extra columns E (the (pixel, colour) pairs past each
                      pixel's slot0 column)
    dedup_pairs       the extras' (position, column) pairs on this rank
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple

import torch

RING = 65536
_NO_RANGE = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start: float
    end: float
    parent: int | None
    attrs: dict
    index: int


class Tracer:
    """Spans in a ring of `maxlen`, totals by name, and counters."""

    def __init__(self, maxlen: int = RING):
        self.records: collections.deque[Span] = collections.deque(maxlen=maxlen)
        self.totals: dict[str, list] = {}  # name: [count, seconds, steps]
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()  # .open: (index, attrs) of this thread's open spans, innermost last
        self._next = 0

    def _stack(self) -> list[tuple[int, dict]]:
        stack = getattr(self._local, "open", None)
        if stack is None:
            stack = self._local.open = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        stack = self._stack()
        with self._lock:
            index, self._next = self._next, self._next + 1
        parent = stack[-1] if stack else None
        if parent is not None and "it" not in attrs and "it" in parent[1]:
            attrs["it"] = parent[1]["it"]
        stack.append((index, attrs))
        profiled = torch.autograd._profiler_enabled()
        with torch.profiler.record_function(f"marf.{name}") if profiled else _NO_RANGE:
            start = time.perf_counter()
            try:
                yield
            finally:
                end = time.perf_counter()
                stack.pop()
                with self._lock:
                    self.records.append(Span(name, start, end, None if parent is None else parent[0], attrs, index))
                    total = self.totals.setdefault(name, [0, 0.0, 0])
                    total[0] += 1
                    total[1] += end - start
                    total[2] += attrs.get("steps", 0)

    def total(self, name: str) -> list:
        """[count, seconds, steps] of every `name` span so far (a copy)."""
        with self._lock:
            return list(self.totals.get(name, [0, 0.0, 0]))

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def _records(self) -> list[Span]:
        with self._lock:
            return list(self.records)

    def spans(self, name: str, t0: float = float("-inf"), t1: float = float("inf")) -> list[Span]:
        """The spans of `name` the ring holds that began in [t0, t1], in the
        order they began."""
        return sorted((s for s in self._records() if s.name == name and t0 <= s.start <= t1), key=lambda s: s.start)

    def self_time(self, span: Span) -> float:
        """Seconds of `span` less the part of it that its children cover."""
        covered, last = 0.0, span.start
        for s in sorted((s for s in self._records() if s.parent == span.index), key=lambda s: s.start):
            lo, hi = max(s.start, last), min(s.end, span.end)
            if hi > lo:
                covered += hi - lo
                last = hi
        return span.end - span.start - covered

    def snapshot(self) -> tuple[dict, dict]:
        """(totals, counters) as they stand, for `summary` to subtract."""
        with self._lock:
            return {k: list(v) for k, v in self.totals.items()}, dict(self.counters)

    def summary(self, since: tuple[dict, dict] | None = None) -> list[str]:
        """One line per span name (count, total seconds, mean ms) and one
        line of counters, of what was recorded after the snapshot `since`."""
        base_totals, base_counters = since or ({}, {})
        totals, counters = self.snapshot()
        lines = []
        for name in sorted(totals):
            n, s, _ = (a - b for a, b in zip(totals[name], base_totals.get(name, [0, 0.0, 0])))
            if n:
                lines.append(f"span {name}: {n} x, {s:.3f} s, mean {s / n * 1e3:.3f} ms")
        # a counter new since `since` shows even at 0 (a dedup step with no extra column)
        grown = {k: v - base_counters.get(k, 0) for k, v in sorted(counters.items())
                 if k not in base_counters or v != base_counters[k]}
        lines.append("counters: " + (", ".join(f"{k} {v}" for k, v in grown.items()) or "none"))
        return lines

    def reset(self) -> None:
        """Forget every span, total and counter (open spans still close)."""
        with self._lock:
            self.records.clear()
            self.totals.clear()
            self.counters.clear()


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
total = TRACER.total
spans = TRACER.spans
self_time = TRACER.self_time
snapshot = TRACER.snapshot
summary = TRACER.summary
reset = TRACER.reset
COUNTERS = TRACER.counters
