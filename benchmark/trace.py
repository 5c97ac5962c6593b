"""From a torch.profiler trace to the numbers the readers take: the device's
operations on its timeline (kernels, copies, sets; not the projections of
host ranges), their union inside a traced window, the idle gaps named by the
harness's host range open at the time, and each kernel wrapper's device time
(the device operations inside its `bench.K<i>` range, eager steps only).
Times are in microseconds, as the profiler gives them."""

from __future__ import annotations

import dataclasses

import torch

WINDOW = "bench.traced_window"
TOP = 10


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def split_events(prof) -> tuple[list, list, list]:
    """(device operations, host ranges of the harness, the device-side
    projections of those ranges), each [(start, end, name)] sorted, of a
    finished profile."""
    events = prof.events()
    host_names = {e.name for e in events if not _is_device(e)}
    ops, ranges, projections = [], [], []
    for e in events:
        item = (float(e.time_range.start), float(e.time_range.end), e.name)
        if _is_device(e):
            if e.name.startswith("bench."):
                projections.append(item)
            elif not getattr(e, "is_user_annotation", False) and e.name not in host_names:
                ops.append(item)
        elif e.name.startswith("bench."):
            ranges.append(item)
    return sorted(ops), sorted(ranges), sorted(projections)


def union(intervals: list) -> list:
    """Merged [(start, end)] of sorted [(start, end, ...)]."""
    out = []
    for s, e, *_ in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A kernel's name without namespaces and arguments."""
    return name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0][:120]


@dataclasses.dataclass
class Window:
    """One traced window: its length, the device's busy time inside it, the
    device operations that took most of it and the longest idle gaps."""

    window_us: float
    busy_us: float
    top_ops: list  # [(name, us)]
    gaps: list  # [(host range, us)]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_us / self.window_us


def window(ops: list, ranges: list) -> Window:
    """The traced window (the `bench.traced_window` range) of a trace."""
    spans = [r for r in ranges if r[2] == WINDOW]
    if len(spans) != 1:
        raise ValueError(f"a trace needs one {WINDOW} range, found {len(spans)}")
    w0, w1, _ = spans[0]
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in ops if e > w0 and s < w1]
    busy = union(inside)
    by_name: dict[str, float] = {}
    for s, e, n in inside:
        by_name[short_name(n)] = by_name.get(short_name(n), 0.0) + (e - s)
    edges = [w0] + [x for b in busy for x in b] + [w1]
    inner = [r for r in ranges if r[2] != WINDOW]
    gaps = []
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 > g0:
            mid = (g0 + g1) / 2
            open_ = [r for r in inner if r[0] <= mid <= r[1]]
            name = max(open_, key=lambda r: r[0])[2][len("bench."):] if open_ else "none"
            gaps.append((name, g1 - g0))
    return Window(window_us=w1 - w0, busy_us=sum(e - s for s, e in busy),
                  top_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
                  gaps=sorted(gaps, key=lambda g: -g[1])[:TOP])


def attribute(ops: list, ranges: list, projections: list, tags: list[str]) -> dict:
    """{"device_us": all device time, tag: {"us", "calls"}} of an eager
    trace: a wrapper's device time is that of the operations inside the
    device-side projection of its range, its calls its host ranges. A tag
    that never ran is left out."""
    out = {"device_us": sum(e - s for s, e, _ in ops)}
    for tag in tags:
        calls = sum(1 for r in ranges if r[2] == f"bench.{tag}")
        spans = [(s, e) for s, e, n in projections if n == f"bench.{tag}"]
        if calls and spans:
            us = sum(e - s for s, e, _ in ops if any(t0 <= s and e <= t1 for t0, t1 in spans))
            out[tag] = {"calls": calls, "us": us}
    return out
