"""The benchmark of the port (`marf_tpu_torch`) on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the card it is started on and prints one
JSON line as the last line of standard output: `correct`, `attempted`,
`failed`, `metrics`, `device`, with --trace 1 `breakdown`, and last
`checks`, each number compared beside its limit (also the last lines of
standard error). Everything of a cell is found by name: its configuration
in `benchmark/configs/<config>.json`, its traffic in
`benchmark/traffic/<traffic>.json`, whose `loop` names the loop kind in
`benchmark/loops/<loop>.py`, its limits in `benchmark/limits/<cell>.json`,
and each per-layer metric's reader in `benchmark/metrics/<metric>.py`.

A run: the scene and the initial parameters from the seed (the scene
written under the run's temporary directory, in the layout the port's
loader reads); the loop's set-up and window (`--trace 0`: the end-to-end
metrics), with --trace 1 a traced window after it (the per-layer metrics);
the peak device memory; then, with the program's state freed, the plain
reference on the same inputs, and the verdict. Exits 2 without enough CUDA
cards, and 3 if JAX or the JAX package was loaded, without a result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "marf_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def merge(base: dict, over: dict) -> dict:
    """`over` on top of `base`, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else copy.deepcopy(v)
    return out


def find(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_inputs(root: str, bench: dict, cell: dict) -> tuple[dict, dict, dict]:
    """(configuration file, traffic file, the run's options: the
    configuration's options with the traffic's on top)."""
    spec = find(bench["configs"], cell["config"], "configuration")
    config = load_json(root, spec["file"])
    traffic = load_json(root, "benchmark", "traffic", f"{cell['traffic']}.json")
    return config, traffic, merge(config["options"], traffic.get("options", {}))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(root: str, name: str):
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def note(line: str) -> None:
    print(f"[bench] {line}", file=sys.stderr, flush=True)


def run_cell(root: str, bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """One run of `cell` on `device` ("cuda", or "cpu" for the tests): the
    result line's dict."""
    from benchmark import check, params, program, scene
    from benchmark.loops import Context
    from benchmark.reference import data as ref_data
    from benchmark.reference import model as ref_model

    config, traffic, options = cell_inputs(root, bench, cell)
    limits = check.load_limits(root, cell["name"])
    loop = importlib.import_module(f"benchmark.loops.{traffic['loop']}")
    imported = time.perf_counter()
    spans = program.Spans()
    with tempfile.TemporaryDirectory(prefix="marf_bench_") as run_dir:
        data_root = os.path.join(run_dir, "planar")
        scene_dir = os.path.join(data_root, options["dataset"])
        scene.write_scene(scene.make_scene(seed, options["H"], options["W"], options["batch_size"]), scene_dir)
        init = params.make_init(options, seed, device)
        ctx = Context(options=options, traffic=traffic, seed=seed, seconds=seconds, trace=trace, device=device,
                      init=init, run_dir=run_dir, data_root=data_root, spans=spans, t_start=t_start)
        ctx.marks.append(("imports", imported))
        ctx.mark("the scene and the initial parameters")
        rec = loop.run(ctx)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        rec.release()
        rec.release = None
        ctx.marks.append(("the window opened", rec.window[0]))
        steps = [f"{label} {t - t0:.3f}" for (label, t), t0 in zip(ctx.marks, [t_start] + [t for _, t in ctx.marks])]
        for line in rec.notes + [f"memory peak: {peak} bytes (max_memory_allocated)", "set-up seconds: "
                                 + "; ".join(steps)]:
            note(line)

        # the reference, once the window has closed and the program's state is freed
        inputs = ref_data.load_inputs(scene_dir, options, device)
        ref = ref_model.train(init, inputs, options, program.CHECK_STEPS, start=rec.first_steps["start"])
        numbers = check.training_gaps(rec.first_steps, ref, init)
        if rec.frame is not None:
            png, leaves, it = rec.frame
            frame = ref_model.render({k: v.to(device) for k, v in leaves.items()}, options, it)
            numbers["frame"] = check.frame_gap(png, frame)
        numbers["nonfinite_steps"] = rec.failed
        correct, checks = check.verdict(numbers, limits)

    if trace:
        run = types.SimpleNamespace(options=options, loop=traffic["loop"], record=rec, spans=spans)
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, cell["name"]):
                value = load_reader(root, m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": rec.e2e[m["name"]], "unit": m["unit"]} for m in bench["end_to_end"]
                   if applies(m, cell["name"])}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(rec.attempted), "failed": int(rec.failed),
              "metrics": metrics, "device": dev}
    if trace and rec.traced is not None:
        dev["busy_s"] = rec.traced.busy_us / 1e6
        dev["window_s"] = rec.traced.window_us / 1e6
        result["breakdown"] = {"device_ops": [[n, us / 1e6] for n, us in rec.traced.top_ops],
                               "idle_gaps": [[n, us / 1e6] for n, us in rec.traced.gaps]}
    result["checks"] = checks
    return result


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's (whole names: `marf_tpu_torch` is not `marf_tpu`)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        result = run_cell(ROOT, bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
