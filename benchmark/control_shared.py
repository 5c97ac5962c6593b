"""The readings that `limits/implicit_shared.steady.json` is set from, on a
card at the cell's own size; no benchmark run runs this.

    python3 -m benchmark.control_shared --seeds 11,12,13

For each seed, in one process: `benchmark.control`'s readings for the
shared-head configuration (the program, the TF32 control, the half batch),
then a fourth fault, planted in the program itself: the dedup's extra
columns dropped, so that every position reads its pixel's slot0 column
(`extras_dropped`), the program's three checked steps held to the same
float32 reference; and the seed's dedup sizes, K, E and the extras'
(position, column) pairs, from the program's counters. One JSON line per
seed and kind on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONFIG = "marf_implicit_shared_f32"
DEDUP_COUNTERS = ("dedup_columns", "dedup_extras", "dedup_pairs")


@contextlib.contextmanager
def extras_dropped():
    """The planted fault: the port's dedup staging with its E extra columns
    and their (position, column) pairs left out, each slot0 column counted
    for all B images of its pixel, so that every position reads its pixel's
    slot0 column, whatever its own image's colour there."""
    import marf_tpu_torch.engine.step as step_mod

    real = step_mod.stage_mask_inputs

    def staged(graph, images, n_ranks=1, rank=0):
        X_all, cnt_all, slot0, ext_off, ext_img, ext_j, table, _ = real(graph, images, n_ranks, rank)
        hw = graph.grid.shape[0]
        multiple = step_mod.DEDUP_COLUMN_MULTIPLE * n_ranks
        k_pad = multiple * -(-hw // multiple)
        X = X_all.new_zeros((X_all.shape[0], k_pad))
        X[:, :hw] = X_all[:, :hw]
        cnt = cnt_all.new_zeros((1, k_pad))
        cnt[:, :hw] = images.shape[0]
        return X, cnt, torch.ones_like(slot0), ext_off[:0], ext_img[:0], ext_j[:0], table, hw

    step_mod.stage_mask_inputs = staged
    try:
        yield
    finally:
        step_mod.stage_mask_inputs = real


def dedup_sizes() -> dict:
    """The program's dedup counters as they stand."""
    from marf_tpu_torch.utils import trace

    return {k: trace.COUNTERS.get(k, 0) for k in DEDUP_COUNTERS}


def fault_readings(options: dict, traffic: dict, seed: int, device: str, run_dir: str) -> dict:
    """The program with its extras dropped against the float32 reference, on
    the scene `benchmark.control.readings` wrote under `run_dir`."""
    from benchmark import check, params, program
    from benchmark.reference import data as ref_data
    from benchmark.reference import model as ref_model

    data_root = os.path.join(run_dir, "planar")
    init = params.make_init(options, seed, device)
    n = int(traffic.get("chunk") or 20)
    with extras_dropped():
        m, step = program.build(options, seed, init, os.path.join(run_dir, "fault"), data_root, device,
                                program.Spans(), visualizer=False)
    m.chunk(step, n)().result()
    prog = program.first_steps(m, step, init, n)
    del m, step
    if device == "cuda":
        torch.cuda.empty_cache()
    inputs = ref_data.load_inputs(os.path.join(data_root, options["dataset"]), options, device)
    ref = ref_model.train(init, inputs, options, program.CHECK_STEPS, start=prog["start"])
    return dict(kind="fault_extras_dropped", **check.training_gaps(prog, ref, init))


def readings(options: dict, traffic: dict, seed: int, device: str, run_dir: str) -> list[dict]:
    from benchmark import control

    before = dedup_sizes()
    rows = control.readings(options, traffic, seed, device, run_dir)
    sizes = {k: v - before[k] for k, v in dedup_sizes().items()}
    rows.append(fault_readings(options, traffic, seed, device, run_dir))
    rows.append(dict(kind="dedup", K=sizes["dedup_columns"], E=sizes["dedup_extras"], pairs=sizes["dedup_pairs"]))
    return rows


def main(argv: list[str] | None = None) -> int:
    from benchmark.run import cell_inputs, load_json

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = load_json(ROOT, "BENCHMARK.json")
    _, traffic, options = cell_inputs(ROOT, bench, {"config": CONFIG, "traffic": "steady"})
    out = sys.stdout
    for seed in [int(s) for s in args.seeds.split(",")]:
        with tempfile.TemporaryDirectory(prefix="marf_control_") as run_dir, \
                contextlib.redirect_stdout(sys.stderr):
            rows = readings(options, traffic, seed, "cuda", run_dir)
        for row in rows:
            print(json.dumps({"config": CONFIG, "seed": seed, **row}), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
