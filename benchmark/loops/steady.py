"""The `steady` loop: the device-bound training step.

The window drives `Model.chunk(Model.make_step(), chunk)`, bench.py's chunk
(captured as CUDA graphs on a card), dispatched one chunk deep as
`Model.train` does it (chunk k + 1 before chunk k's metrics are read), with
no frames, TensorBoard or checkpoints. Set-up: the port's phases up to the
step, the eager first chunk and the capture, then three steps from the
seed's state part-way through the schedule on the window's chunks
(`program.first_steps`); the window goes on from there. The
window: whole chunks, from the first dispatch after set-up until the last
chunk that ends past the window's seconds has been read.
`steps_per_s` = steps in the window / its time.

Traced (`--trace 1`), after the untraced window: `traced_chunks` chunks
dispatched the same way inside a `bench.traced_window` range, then one
eager chunk of `attribution_steps` steps, whose kernel wrappers show their
ranges, for each wrapper's device time.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import program, trace
from benchmark.loops import Record, percentiles, smi


def profile(device: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> Record:
    n = int(ctx.traffic["chunk"])
    m, step = program.build(ctx.options, ctx.seed, ctx.init, ctx.run_dir, ctx.data_root, ctx.device, ctx.spans,
                            visualizer=False)
    ctx.mark("the port built, its step made")
    chunk = m.chunk(step, n)
    chunk().result()  # the eager first chunk, then the capture
    ctx.mark("the eager chunk and the capture")
    first = program.first_steps(m, step, ctx.init, n)
    ctx.mark("three checked steps from the seed")
    smi_before = smi(ctx.device)
    program.reset_launches()

    t0 = time.perf_counter()
    reads, history = [], []
    pending, chunks = chunk(), 1
    while True:
        nxt = chunk()
        chunks += 1
        history.append(pending.result())
        reads.append(time.perf_counter())
        pending = nxt
        if reads[-1] - t0 >= ctx.seconds:
            break
    history.append(pending.result())
    t1 = time.perf_counter()
    reads.append(t1)

    steps = chunks * n
    rec = Record(e2e={"steps_per_s": steps / (t1 - t0), "setup_s": t0 - ctx.t_start}, window=(t0, t1),
                 attempted=steps, failed=program.finite_failures(history), first_steps=first, steps_per_chunk=n)
    walls = [b - a for a, b in zip([t0] + reads[:-1], reads)]
    rec.notes += [f"launches per step: {program.launches_per_step(steps)}",
                  f"nvcc seconds: {program.build_seconds()}",
                  f"card before the window: {smi_before}", f"card after the window: {smi(ctx.device)}",
                  f"chunk wall time: {percentiles(walls)}"]
    if ctx.trace:
        prof = profile(ctx.device)
        prof.start()
        with ctx.spans("traced_window"):
            pending = chunk()
            for _ in range(int(ctx.traffic["traced_chunks"]) - 1):
                nxt = chunk()
                pending.result()
                pending = nxt
            pending.result()
            sync(ctx.device)
        prof.stop()
        rec.traced = trace.window(*trace.split_events(prof)[:2])
        from marf_tpu_torch.engine.step import make_train_chunk

        k = int(ctx.traffic["attribution_steps"])
        eager = program.SpannedChunk(make_train_chunk(step, k, capture=False), ctx.spans)
        prof = profile(ctx.device)
        prof.start()
        eager().result()
        sync(ctx.device)
        prof.stop()
        rec.attribution = trace.attribute(*trace.split_events(prof), [tag for tag, _, _ in program.KERNELS])
        rec.attribution_steps = k
        del eager, prof

    held = {"m": m, "step": step, "chunk": chunk}
    del m, step, chunk, pending

    def release():
        held.clear()
        gc.collect()
        if ctx.device == "cuda":
            torch.cuda.empty_cache()

    rec.release = release
    return rec
