"""Time the port's train step on the card, captured and eager, and split
its device time.

    python -m marf_tpu_torch.step_profile                       # canonical config
    python -m marf_tpu_torch.step_profile --use_implicit_mask --use_masks=false
    python -m marf_tpu_torch.step_profile --tpu.fused_step=off  # the autograd step
    python -m marf_tpu_torch.step_profile --use_implicit_mask --use_masks=false --build_single_masks
    python -m marf_tpu_torch.step_profile --tpu.compute_dtype=bfloat16  # the bf16 kernels (K1-K6)

Takes the options of `python -m marf_tpu_torch.train` on top of planar.yaml,
--barf_c2f=[0,0.4], --dataset=synthetic and --seed=3, builds the trainer's
step once (`Model.make_step`), and then, on one CUDA card, for its chunks of
20 steps (engine/step.py `make_train_chunk`) eager, then captured as CUDA
graphs (the first captured chunk runs eagerly and captures):
  - runs one warm-up chunk;
  - times 5 chunks dispatched one chunk deep as the trainer dispatches them,
    ended by the last chunk's metric read (steps/s);
  - times one chunk's dispatch (host ms/step: the enqueue of every op
    eager, of 20 graph replays captured);
  - traces one chunk with torch.profiler: device ms/step of all device work
    (kernels only: no range that a record_function, the optimizer's step
    among them, draws on the device timeline) and the device kernels that
    take the most of it, by name (the GEMM engine's template instances
    among them); eager, also each hand-written kernel's share (K1-K6, in
    float32 or bfloat16: the device kernels inside the `marf.K<i>` range
    the step opens around each wrapper, ops/cuda `kernel`, on the device
    timeline) and each wrapper's own kernels by name (a replayed graph runs
    no wrapper); the busy share is that device time over the step time of
    the untraced chunks.
Metric-only work follows the trainer's cadence: the last step of every chunk
is the heavy one. Prints one line per part, captured beside eager, with the
card's nvidia-smi name and power limit; it raises without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import torch

from marf_tpu_torch.ops.cuda import KERNELS

CHUNK = 20
TOP_KERNELS = 12


def _short(key: str) -> str:
    """A device kernel's name without namespaces and arguments (template
    arguments kept)."""
    return key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


def device_kernels(prof) -> tuple[list, set]:
    """(kernel ms over the trace, sorted, as (ms, short name)), and the keys
    of the CPU-side ranges (record_function ranges also appear on the device
    timeline, spanning their kernels and the idle gaps between them: count
    kernels only). A trace of CUDA activity alone gives the same kernels."""
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {e.key for e in events if e.device_type != cuda}
    by_kernel = sorted(((e.self_device_time_total / 1e3, _short(e.key)) for e in events
                        if e.device_type == cuda and not e.is_user_annotation and e.key not in ranges), reverse=True)
    return by_kernel, ranges


def _measure(chunk, per_wrapper: bool) -> dict:
    """One mode's numbers (module docstring) for `chunk` of CHUNK steps."""
    chunk().result()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = None
    for _ in range(5):
        handle = chunk()
        if pending is not None:
            pending.result()
        pending = handle
    pending.result()
    steps_per_sec = 5 * CHUNK / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    handle = chunk()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / CHUNK
    handle.result()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        chunk().result()
        torch.cuda.synchronize()
    by_kernel, ranges = device_kernels(prof)
    by_kernel = [(ms / CHUNK, name) for ms, name in by_kernel]
    device_ms = sum(ms for ms, _ in by_kernel)
    out = {
        "steps_per_sec": steps_per_sec,
        "host_enqueue_ms_per_step": enqueue_ms,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms * steps_per_sec / 1e3,
        "top_device_kernels_ms_per_step": {name: ms for ms, name in by_kernel[:TOP_KERNELS]},
    }
    if per_wrapper:
        # each wrapper's kernels: the device kernels inside its range on the device timeline
        cuda = torch.autograd.DeviceType.CUDA
        tags = {f"marf.{tag}" for tag in KERNELS}
        dev = [e for e in prof.events() if e.device_type == cuda]
        spans = [(e.time_range.start, e.time_range.end, e.name[len("marf."):]) for e in dev if e.name in tags]
        wrappers: dict[str, dict[str, float]] = {}
        for e in dev:
            if e.name in ranges:
                continue
            for t0, t1, tag in spans:
                if t0 <= e.time_range.start and e.time_range.end <= t1:
                    names = wrappers.setdefault(tag, {})
                    names[_short(e.name)] = names.get(_short(e.name), 0.0) + e.time_range.elapsed_us() / 1e3 / CHUNK
                    break
        parts = {tag: sum(names.values()) for tag, names in sorted(wrappers.items())}
        out.update(kernel_ms_per_step=parts, other_device_ms_per_step=device_ms - sum(parts.values()),
                   wrapper_kernels_ms_per_step=wrappers)
    return out


def main(argv: list[str]) -> dict:
    from marf_tpu_torch.engine.step import make_train_chunk
    from marf_tpu_torch.engine.trainer import Model
    from marf_tpu_torch.utils.config import parse_arguments, set_opt

    if not torch.cuda.is_available():
        raise RuntimeError("step_profile measures the card: no CUDA device is available")
    with tempfile.TemporaryDirectory(prefix="step_profile_") as out_root:
        base = ["--model=planar", "--yaml=planar", "--group=profile", "--name=step", "--seed=3",
                "--barf_c2f=[0,0.4]", "--dataset=synthetic", f"--output_root={out_root}", "--tb="]
        m = Model(set_opt(parse_arguments(base + argv), interactive=False))
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    step = m.make_step()
    result = {"options": argv}
    for mode, capture in (("eager", False), ("captured", True)):
        result[mode] = _measure(make_train_chunk(step, CHUNK, capture), per_wrapper=not capture)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result["device"] = smi
    for mode in ("eager", "captured"):
        r = result[mode]
        parts = r.get("kernel_ms_per_step", {})
        line = (f"[profile {mode}] {' '.join(argv) or 'canonical'}: {r['steps_per_sec']:.2f} steps/s, host enqueue "
                f"{r['host_enqueue_ms_per_step']:.3f} ms/step, device {r['device_ms_per_step']:.3f} ms/step")
        if parts:
            line += (" " + " ".join(f"{k}={v:.3f}" for k, v in parts.items())
                     + f" other={r['other_device_ms_per_step']:.3f}")
        print(line + f", busy share {r['device_busy_share']:.3f}; {smi}", flush=True)
        print(f"[kernels {mode}] " + "; ".join(f"{name} {ms:.3f}" for name, ms in
                                              r["top_device_kernels_ms_per_step"].items()), flush=True)
    for tag, names in sorted(result["eager"]["wrapper_kernels_ms_per_step"].items()):
        print(f"[kernels {tag}] " + "; ".join(f"{name} {ms:.3f}" for name, ms in
                                             sorted(names.items(), key=lambda kv: -kv[1])), flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
