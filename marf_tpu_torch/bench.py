"""Benchmark of the port: optimization steps/sec of the trainer's own step
(twin of the repository's bench.py).

    python -m marf_tpu_torch.bench           # on CUDA device 0
    python -m marf_tpu_torch.bench --cpu     # on the CPU (the kernels' plain versions)

Builds a case's config from the port's planar.yaml, trains it through
`Model.make_step` and `Model.chunk`, exactly the step and the chunks `python
-m marf_tpu_torch.train` runs (on a card: captured as CUDA graphs after the
first chunk, replayed; one chunk deep), and prints ONE JSON line on stdout
(everything else goes to stderr):

    {"metric": "steps_per_sec", "value": N, "unit": "steps/s",
     "vs_baseline": N / REF_BASELINE_STEPS_PER_SEC[case], "extra": {...}}

`extra` carries the case, the dataset actually used, the device (the card's
`nvidia-smi --query-gpu=name,power.limit` line, or "cpu"), the timed steps,
the final PSNR, homography error and (implicit masks) mask error, the
compute dtype, the chunks' mode (captured or eager, and why), each kernel's
launches per timed step (`ops/cuda` LAUNCHES, counted through the replays;
0 on the autograd path and on the CPU) and the golden check.

Env knobs (bench.py's):
    MARF_BENCH_CASE         canonical | fullposenc | edges_only | noposenc | implicit | implicit_single
    MARF_BENCH_ITERS        total steps, a multiple of 100, at least 200 (default 3000)
    MARF_BENCH_SEED         init seed (default 3)
    MARF_BENCH_DTYPE        float32 | bfloat16 (tpu.compute_dtype)
    MARF_BENCH_FUSED_STEP   auto | on | off (tpu.fused_step; off = the autograd step)
    MARF_BENCH_FUSED_WARP   auto | on | off (tpu.fused_warp; off = K2 in place of K1)
    MARF_BENCH_FUSED_DEDUP  auto | on | off (tpu.fused_dedup; off = K5 -> K6 for the shared head)
    MARF_BENCH_LAZY_METRICS auto | on | off (tpu.lazy_metrics)
    MARF_BENCH_CAPTURE      auto | off (the Model's `capture`: auto captures the step on a card; off
                            runs the eager chunk, the oracle); `extra.chunk` names the mode that ran
    MARF_BENCH_PRECISION    '' | highest: both full float32 (TF32 is off), anything else raises
    MARF_BENCH_CHECK        1 (default) = hold the final PSNR to tools/bench_goldens.json (exit 1
                            outside the band); 0 = report only
    MARF_BENCH_FLAT_ADAM    accepted and ignored (flat-space Adam is not ported)
The TPU lock, the backend probe (MARF_BENCH_PROBE*) and MARF_FUSED_STREAMS
serve the TPU alone and are not ported. Without a card and without --cpu the
line carries `"error": "no_cuda_device"` and the exit code is 2.

Departures from bench.py: steps/s is the timed steps over their time, and
the iteration count must be a multiple of 100 and at least 200 (bench.py
divides ITERS - 100 steps by the time of (ITERS - 100) // 100 chunks, which
counts steps it never ran when ITERS is not a multiple of 100). The goldens
were recorded on cat_batch3 and their key names no dataset, so a golden is
checked only on cat_batch3 at float32; otherwise `extra.golden` says why it
was skipped.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from marf_tpu_torch.utils.attrdict import AttrDict
from marf_tpu_torch.utils.console import log

# Per-case reference-on-GPU estimates (bench.py:65-72, derived in
# BASELINE_MEASURED.md): vs_baseline divides by them.
REF_BASELINE_STEPS_PER_SEC = {
    "canonical": 30.0,
    "fullposenc": 30.0,
    "edges_only": 30.0,
    "noposenc": 30.0,
    "implicit": 25.0,
    "implicit_single": 3.0,
}
# BASELINE.md's evaluation configs (bench.py:86-93)
CASES = {
    "canonical": {},
    "fullposenc": dict(_no_c2f=True),
    "edges_only": dict(use_masks=False, alpha_initial=1.0, alpha_final=1.0),
    "noposenc": dict(_no_posenc=True, _no_c2f=True),
    "implicit": dict(use_masks=False, use_implicit_mask=True),
    "implicit_single": dict(use_masks=False, use_implicit_mask=True, build_single_masks=True),
}
CHUNK = 100
WARMUP_CHUNKS = 1
CAPTURE = {"auto": None, "off": False}  # MARF_BENCH_CAPTURE -> the Model's capture
GOLDEN_DATASET = "cat_batch3"
GOLDENS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "bench_goldens.json")


def bench_options(case: str, iters: int, seed: int, dtype: str, fused_step: str, fused_warp: str, fused_dedup: str,
                  lazy_metrics: str, output_path: str, overrides: dict | None = None, cpu: bool = False) -> AttrDict:
    """A case's options: planar.yaml, the case's overrides (`_no_posenc`
    turns arch.posenc off, `_no_c2f` sets barf_c2f to None), then the
    knobs (bench.py:100-130); `overrides` last."""
    from marf_tpu_torch.utils.config import load_options, resolve_yaml_path

    case_opts = dict(CASES[case])
    no_posenc = case_opts.pop("_no_posenc", False)
    no_c2f = case_opts.pop("_no_c2f", False)
    opt = load_options(resolve_yaml_path("planar"))
    opt.update(AttrDict(model="planar", yaml="planar", group="bench", name=case, seed=seed, max_iter=iters,
                        barf_c2f=None if no_c2f else [0, 0.4], output_path=output_path, cpu=cpu))
    opt.update(AttrDict(case_opts))
    opt.tpu.compute_dtype = dtype
    opt.tpu.fused_step = fused_step
    opt.tpu.fused_warp = fused_warp
    opt.tpu.fused_dedup = fused_dedup
    opt.tpu.lazy_metrics = lazy_metrics
    if no_posenc:
        opt.arch.posenc = False
    if overrides:
        opt.update(AttrDict(overrides))
    return opt


def build_model(case: str, iters: int, seed: int, dtype: str, fused_step: str, fused_warp: str, fused_dedup: str,
                lazy_metrics: str, overrides: dict | None = None, cpu: bool = False, *, output_path: str,
                capture: bool | None = None):
    """(Model, its train step, the dataset used): the case's options through
    load_dataset -> build_networks -> setup_optimizer -> make_step. A dataset
    missing on disk falls back to `synthetic` (bench.py:138-144).
    `output_path` is the run directory (the Model writes nothing else);
    `capture` is the Model's."""
    from marf_tpu_torch.engine.trainer import Model

    opt = bench_options(case, iters, seed, dtype, fused_step, fused_warp, fused_dedup, lazy_metrics, output_path,
                        overrides, cpu)
    m = Model(opt, capture=capture)
    try:
        m.load_dataset()
    except FileNotFoundError as e:
        log.warn(f"{e}; benchmarking dataset=synthetic")
        m.dataset = "synthetic"
        m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    return m, m.make_step(), m.dataset


def golden_record(final_psnr, g):
    """One golden band -> (ok, record), pure Python (bench.py:248-260)."""
    delta = abs(final_psnr - g["psnr"])
    ok = bool(delta <= g["band"]) and bool(np.isfinite(final_psnr))
    return ok, {"psnr": g["psnr"], "band": g["band"], "delta": round(float(delta), 4), "ok": ok}


def golden_check(case: str, iters: int, seed: int, dtype: str, dataset: str, final_psnr: float, check: bool = True):
    """(ok or None when not checked, the record for extra.golden). The key is
    bench.py's `CASE@ITERS/seedN`; a golden is held only on cat_batch3 at
    float32, where it was recorded."""
    key = f"{case}@{iters}/seed{seed}"
    if not check:
        return None, {"key": key, "skipped": "MARF_BENCH_CHECK=0"}
    if dataset != GOLDEN_DATASET:
        return None, {"key": key, "skipped": f"dataset {dataset}"}
    if dtype != "float32":
        return None, {"key": key, "skipped": f"compute_dtype {dtype}"}
    try:
        with open(GOLDENS) as f:
            g = json.load(f).get(key)
    except FileNotFoundError:
        g = None
    if g is None:
        return None, {"key": key, "skipped": "no golden"}
    ok, rec = golden_record(final_psnr, g)
    return ok, {"key": key, **rec}


def device_name(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_case(case: str = "canonical", iters: int = 3000, seed: int = 3, dtype: str = "float32",
             fused_step: str = "auto", fused_warp: str = "auto", fused_dedup: str = "auto", lazy_metrics: str = "auto",
             check: bool = True, overrides: dict | None = None, cpu: bool = False, capture: bool | None = None):
    """Time one case: WARMUP_CHUNKS chunks of CHUNK steps (the kernels'
    first-use build and the capture among them), then the rest, dispatched
    one chunk deep as `Model.train` does (chunk k + 1 before chunk k's
    metrics are read); the time ends at the last chunk's read. `capture`
    is the Model's (None: captured on a card; False: eager). Returns (the
    JSON line's dict, golden ok or None when not checked)."""
    from marf_tpu_torch.ops.cuda import LAUNCHES

    if case not in CASES:
        raise ValueError(f"unknown case {case!r} (available: {', '.join(CASES)})")
    if iters % CHUNK or iters < (WARMUP_CHUNKS + 1) * CHUNK:
        raise ValueError(f"MARF_BENCH_ITERS={iters}: need a multiple of {CHUNK}, at least {(WARMUP_CHUNKS + 1) * CHUNK}")
    with tempfile.TemporaryDirectory(prefix="marf_bench_") as out:
        m, step_fn, dataset = build_model(case, iters, seed, dtype, fused_step, fused_warp, fused_dedup, lazy_metrics,
                                          overrides, cpu, output_path=out, capture=capture)
        chunk = m.chunk(step_fn, CHUNK)
        device = device_name(m.device)
        log.info(f"bench case: {case}, dataset: {dataset}, device: {device}")
        it = 0
        for _ in range(WARMUP_CHUNKS):
            chunk().result()
            it += CHUNK
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        n_timed = iters - it
        pending = None
        t0 = time.perf_counter()
        while it < iters:
            handle = chunk()
            if pending is not None:
                pending.result()
            pending = handle
            it += CHUNK
        md = pending.result()
        dt = time.perf_counter() - t0
    steps_per_sec = n_timed / dt
    final = {k: float(v[-1]) for k, v in md.items()}
    log.info(f"timed {n_timed} steps in {dt:.2f}s -> {steps_per_sec:.1f} steps/s")
    log.info(f"final: PSNR={final['PSNR']:.3f} dB, loss={final['all']:.5f}, "
             f"hom_err={final.get('Homography_Error', float('nan')):.4f}")
    extra = {
        "case": case,
        "dataset": dataset,
        "device": device,
        "iters_timed": n_timed,
        "final_psnr_db": round(final["PSNR"], 3),
        "final_homography_error": round(final.get("Homography_Error", float("nan")), 5),
        "ref_baseline_steps_per_sec": REF_BASELINE_STEPS_PER_SEC[case],
        "compute_dtype": dtype,
        "chunk": chunk.mode,
        "launches": {k: v / n_timed for k, v in LAUNCHES.items()},
    }
    if "Mask_Error" in final:
        extra["final_mask_error"] = round(final["Mask_Error"], 5)
    golden_ok, extra["golden"] = golden_check(case, iters, seed, dtype, dataset, final["PSNR"], check)
    if golden_ok is False:
        log.warn(f"GOLDEN CHECK FAILED: {extra['golden']}")
    result = {
        "metric": "steps_per_sec",
        "value": round(steps_per_sec, 2),
        "unit": "steps/s",
        "vs_baseline": round(steps_per_sec / REF_BASELINE_STEPS_PER_SEC[case], 3),
        "extra": extra,
    }
    return result, golden_ok


def main(argv: list[str] | None = None) -> dict:
    """The env knobs -> one run_case -> one JSON line on stdout, the logs on
    stderr; exit 1 on a golden miss, 2 without a card (unless --cpu)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv not in ([], ["--cpu"]):
        raise SystemExit(f"usage: python -m marf_tpu_torch.bench [--cpu] (options go through MARF_BENCH_*), got {argv}")
    cpu = argv == ["--cpu"]
    env = os.environ.get
    case = env("MARF_BENCH_CASE", "canonical")
    precision = env("MARF_BENCH_PRECISION", "")
    if precision not in ("", "highest"):
        raise ValueError(f"MARF_BENCH_PRECISION={precision!r}: the port runs full float32 ('' or 'highest')")
    capture = env("MARF_BENCH_CAPTURE", "auto")
    if capture not in CAPTURE:
        raise ValueError(f"MARF_BENCH_CAPTURE={capture!r}: one of {', '.join(CAPTURE)}")
    out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        if not cpu and not torch.cuda.is_available():
            print(json.dumps({"metric": "steps_per_sec", "value": None, "unit": "steps/s", "vs_baseline": None,
                              "error": "no_cuda_device", "extra": {"case": case, "device": None}}), file=out, flush=True)
            log.warn("no CUDA device is available; pass --cpu to benchmark the CPU")
            sys.exit(2)
        if env("MARF_BENCH_FLAT_ADAM"):
            log.warn("MARF_BENCH_FLAT_ADAM is ignored: flat-space Adam is not ported")
        result, golden_ok = run_case(
            case=case, iters=int(env("MARF_BENCH_ITERS", 3000)), seed=int(env("MARF_BENCH_SEED", 3)),
            dtype=env("MARF_BENCH_DTYPE", "float32"), fused_step=env("MARF_BENCH_FUSED_STEP", "auto"),
            fused_warp=env("MARF_BENCH_FUSED_WARP", "auto"), fused_dedup=env("MARF_BENCH_FUSED_DEDUP", "auto"),
            lazy_metrics=env("MARF_BENCH_LAZY_METRICS", "auto"), check=env("MARF_BENCH_CHECK", "1") != "0", cpu=cpu,
            capture=CAPTURE[capture])
    print(json.dumps(result), file=out, flush=True)
    if golden_ok is False:
        sys.exit(1)
    return result


if __name__ == "__main__":
    main()
