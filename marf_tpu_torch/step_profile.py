"""Time the port's train step on the card and split its device time.

    python -m marf_tpu_torch.step_profile                       # canonical config
    python -m marf_tpu_torch.step_profile --use_implicit_mask --use_masks=false
    python -m marf_tpu_torch.step_profile --tpu.fused_step=off  # the autograd step
    python -m marf_tpu_torch.step_profile --use_implicit_mask --use_masks=false --build_single_masks
    python -m marf_tpu_torch.step_profile --tpu.compute_dtype=bfloat16  # the bf16 kernels (K1-K6)

Takes the options of `python -m marf_tpu_torch.train` on top of planar.yaml,
--barf_c2f=[0,0.4], --dataset=synthetic and --seed=3, builds the trainer's
step once, and then, on one CUDA card:
  - runs 20 warm-up steps;
  - times 100 steps ended by torch.cuda.synchronize() (steps/s);
  - times 20 steps without a sync (host enqueue ms/step);
  - traces 20 steps with torch.profiler: device ms/step of each hand-written
    kernel (K1-K6, in float32 or bfloat16: the device kernels inside each
    wrapper's range on the device timeline) and of all device work (kernels only: no range that
    a record_function, the optimizer's step among them, draws on the
    device timeline), the device kernels that take the most of it, by name
    (the GEMM engine's template instances among them), and each wrapper's
    own kernels by name; the busy share is that device time over the step
    time of the untraced steps.
Metric-only work follows the trainer's cadence: the last step of every 20 is
the chunk-final one. Prints one line per part and the card's nvidia-smi name
and power limit; it raises without a card.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import tempfile
import time

import torch

from marf_tpu_torch.ops.cuda import fused_implicit, fused_mask, fused_step

WRAPPERS = [
    ("K1", fused_step, "fused_train_kernel_warp"),
    ("K2", fused_step, "fused_train_kernel"),
    ("K3", fused_mask, "fused_mask_forward"),
    ("K4", fused_mask, "fused_mask_backward_dedup"),
    ("K5", fused_implicit, "fused_implicit_train_kernel"),
    ("K6", fused_mask, "fused_mask_backward_g"),
]
CHUNK = 20
TOP_KERNELS = 12


def _short(key: str) -> str:
    """A device kernel's name without namespaces and arguments (template
    arguments kept)."""
    return key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


def _traced(tag: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(tag):
            return fn(*args, **kwargs)

    return wrapper


def main(argv: list[str]) -> dict:
    from marf_tpu_torch.engine.step import make_train_step
    from marf_tpu_torch.engine.trainer import Model
    from marf_tpu_torch.utils.config import parse_arguments, set_opt

    if not torch.cuda.is_available():
        raise RuntimeError("step_profile measures the card: no CUDA device is available")
    for tag, mod, name in WRAPPERS:
        setattr(mod, name, _traced(tag, getattr(mod, name)))
    with tempfile.TemporaryDirectory(prefix="step_profile_") as out_root:
        base = ["--model=planar", "--yaml=planar", "--group=profile", "--name=step", "--seed=3",
                "--barf_c2f=[0,0.4]", "--dataset=synthetic", f"--output_root={out_root}", "--tb="]
        m = Model(set_opt(parse_arguments(base + argv), interactive=False))
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    step_fn = make_train_step(m.cfg, m.graph, m.optimizer, m.data, m.scheduler, use_homographies=m.use_homographies)
    it = 0

    def run(n: int):
        nonlocal it
        for _ in range(n):
            step_fn(it, heavy=(it % CHUNK == CHUNK - 1))
            it += 1

    run(CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(5 * CHUNK)
    torch.cuda.synchronize()
    steps_per_sec = 5 * CHUNK / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    run(CHUNK)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / CHUNK
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(CHUNK)
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    tags = {tag for tag, _, _ in WRAPPERS}
    # record_function ranges (the wrappers' tags, the optimizer's step) also
    # appear on the device timeline, spanning their kernels and the idle gaps
    # between them: count kernels only
    ranges = {e.key for e in events if e.device_type != cuda}
    by_kernel = sorted(((e.self_device_time_total / 1e3 / CHUNK, _short(e.key)) for e in events
                        if e.device_type == cuda and e.key not in ranges), reverse=True)
    device_ms = sum(ms for ms, _ in by_kernel)
    # each wrapper's kernels: the device kernels inside its range on the device timeline
    dev = [e for e in prof.events() if e.device_type == cuda]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in dev if e.name in tags]
    per_wrapper: dict[str, dict[str, float]] = {}
    for e in dev:
        if e.name in ranges:
            continue
        for t0, t1, tag in spans:
            if t0 <= e.time_range.start and e.time_range.end <= t1:
                names = per_wrapper.setdefault(tag, {})
                names[_short(e.name)] = names.get(_short(e.name), 0.0) + e.time_range.elapsed_us() / 1e3 / CHUNK
                break
    parts = {tag: sum(names.values()) for tag, names in sorted(per_wrapper.items())}
    result = {
        "options": argv,
        "steps_per_sec": steps_per_sec,
        "host_enqueue_ms_per_step": enqueue_ms,
        "device_ms_per_step": device_ms,
        "kernel_ms_per_step": parts,
        "other_device_ms_per_step": device_ms - sum(parts.values()),
        "device_busy_share": device_ms * steps_per_sec / 1e3,
        "top_device_kernels_ms_per_step": {name: ms for ms, name in by_kernel[:TOP_KERNELS]},
        "wrapper_kernels_ms_per_step": per_wrapper,
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[profile] {' '.join(argv) or 'canonical'}: {steps_per_sec:.2f} steps/s, host enqueue "
          f"{enqueue_ms:.2f} ms/step, device {result['device_ms_per_step']:.3f} ms/step "
          + " ".join(f"{k}={v:.3f}" for k, v in parts.items())
          + f" other={result['other_device_ms_per_step']:.3f}, busy share {result['device_busy_share']:.3f}; {smi}",
          flush=True)
    print("[kernels] " + "; ".join(f"{name} {ms:.3f}" for ms, name in by_kernel[:TOP_KERNELS]), flush=True)
    for tag, names in sorted(per_wrapper.items()):
        print(f"[kernels {tag}] " + "; ".join(f"{name} {ms:.3f}" for name, ms in
                                             sorted(names.items(), key=lambda kv: -kv[1])), flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
