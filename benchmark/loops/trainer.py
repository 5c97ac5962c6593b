"""The `trainer` loop: the user's training loop with its boundaries.

The window drives the port's `Model.train()` at the traffic's cadence
(`freq.scalar`, `freq.vis`, TensorBoard under `tb`, no checkpoint inside the
window). Set-up: the port's phases up to the step, the eager first chunk and
the capture, three steps from the seed's state part-way through the
schedule (`program.first_steps`), steps to the next chunk boundary, then `train()`
up to its first frame boundary after the capture: the window starts when
that frame is written. It ends when the first frame at or past the
window's seconds is written, so it holds whole `freq.vis` segments, each
with its frame; the harness's hook after `visualize` (`BenchModel.on_frame`)
ends `train()` there. `trainer_steps_per_s` = steps in the window / its wall
time, frames, TensorBoard writes and metric reads included. The final
checkpoint and vis.mp4 fall after the window and are not measured.

Traced (`--trace 1`): after the untraced window, `traced_segments` more
segments inside a `bench.traced_window` range.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import program, trace
from benchmark.loops import Record, percentiles, smi
from benchmark.loops.steady import profile, sync


class StopWindow(Exception):
    """Raised from the frame hook to end `Model.train()` at a boundary."""


class Frames:
    """The hook after each `visualize`: opens the window at the first frame
    boundary, closes it at the first one at or past the seconds, then
    traces `traced` segments or ends the loop."""

    def __init__(self, ctx, vis: int, traced: int):
        self.ctx, self.vis, self.traced = ctx, vis, traced
        self.t0 = self.t1 = None
        self.segments = []
        self.prof = self.range = None

    def __call__(self, m, step: int) -> None:
        if step == 0 or step != m.it or m.it % self.vis:
            return
        now = time.perf_counter()
        if self.t0 is None:
            self.t0, self.last, self.it0, self.h0 = now, now, m.it, len(m.history)
            program.reset_launches()
            return
        if self.t1 is None:
            self.segments.append(now - self.last)
            self.last = now
            if now - self.t0 < self.ctx.seconds:
                return
            self.t1, self.it1, self.h1 = now, m.it, len(m.history)
            self.launches = program.launches_per_step(self.it1 - self.it0)
            self.frame = (f"{m.vis_path}/{m.vis_it - 1}.png", program.neural_image_params(m), m.it)
            if not self.ctx.trace:
                raise StopWindow
            self.prof = profile(self.ctx.device)
            self.prof.start()
            self.range = torch.profiler.record_function(trace.WINDOW)
            self.range.__enter__()
            return
        self.traced -= 1
        if self.traced == 0:
            sync(self.ctx.device)
            self.range.__exit__(None, None, None)
            self.prof.stop()
            raise StopWindow


def run(ctx) -> Record:
    from marf_tpu_torch.engine.step import chunk_schedule

    opt = ctx.options
    freq = opt["freq"]
    m, step = program.build(opt, ctx.seed, ctx.init, ctx.run_dir, ctx.data_root, ctx.device, ctx.spans,
                            visualizer=True)
    ctx.mark("the port built, its step made")
    n = chunk_schedule(int(opt["max_iter"]), freq["scalar"], freq["vis"], freq.get("ckpt"))
    m.chunk(step, n)().result()  # the eager first chunk, then the capture
    ctx.mark("the eager chunk and the capture")
    first = program.first_steps(m, step, ctx.init, n)
    ctx.mark("three checked steps from the seed")
    m.it = first["start"] + program.CHECK_STEPS
    rest = -m.it % n
    if rest:
        m.chunk(step, rest)().result()
    m.it += rest
    smi_before = smi(ctx.device)
    frames = m.on_frame = Frames(ctx, int(freq["vis"]), int(ctx.traffic.get("traced_segments", 1)))
    try:
        m.train()
    except StopWindow:
        pass
    finally:
        if m.tb:
            m.tb.close()
    if frames.t1 is None:
        raise RuntimeError("the trainer ended before its window closed: raise max_iter")
    t0, t1 = frames.t0, frames.t1
    steps = frames.it1 - frames.it0
    rec = Record(e2e={"trainer_steps_per_s": steps / (t1 - t0), "setup_s": t0 - ctx.t_start}, window=(t0, t1),
                 attempted=steps, failed=program.finite_failures(m.history[frames.h0 : frames.h1]),
                 first_steps=first, steps_per_chunk=n, frame=frames.frame)
    frames_ms = [d * 1e3 for d in ctx.spans.durations("visualize", t0, t1)]
    rec.notes += [f"launches per step: {frames.launches}", f"nvcc seconds: {program.build_seconds()}",
                  f"card before the window: {smi_before}", f"card after the window: {smi(ctx.device)}",
                  f"segment wall time ({freq['vis']} steps and a frame): {percentiles(frames.segments)}",
                  f"visualize ms in the window: {[round(x, 3) for x in frames_ms]}"]
    if frames.prof is not None:
        rec.traced = trace.window(*trace.split_events(frames.prof)[:2])
    held = {"m": m, "step": step}
    del m, step, frames

    def release():
        held.clear()
        gc.collect()
        if ctx.device == "cuda":
            torch.cuda.empty_cache()

    rec.release = release
    return rec
