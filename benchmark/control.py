"""The readings that the limits in `benchmark/limits/` are set from, on a card
at a cell's own size; no benchmark run runs this.

    python3 -m benchmark.control --config marf_fixed_masks_f32 --traffic steady --seeds 11,12,13

For each seed, in one process: the program's three checked steps from the
seed's state on its captured chunks (`program.first_steps`, part-way
through the schedule) against the float32 reference (the lower readings);
the control, the reference put in the program's place at the next
precision below the configuration's (TF32 products for float32), against
the same reference; and the planted fault of half the batch left out with
every mean over the rest, in the reference put in the program's place. A
state left unchanged reads 1 on `change` by the measure and needs no run.
Then the program trains on to `FRAME_STEPS` past the checked steps' start,
where the trainer cells' frames fall, and its `visualize` renders a frame:
the program's frame and the reference's render of the same parameters in
TF32 are each held to the reference's render in float32 (`frame` checks the
render stage alone). One JSON line per seed and kind on standard output.
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

# the trainer cells' frames fall 1,600-3,500 steps past the checked steps' start
FRAME_STEPS = 2000


def as_readings(ref: dict, init: dict, heavy: list) -> dict:
    """A reference run in the form of `program.first_steps`' readings."""
    from benchmark.check import ref_norms

    grads, change = ref_norms(ref, init)
    losses = [{"rgb": r["rgb"], "all": r["all"], "heavy": h} for r, h in zip(ref["losses"], heavy)]
    return {"losses": losses, "grads": grads, "change": change}


def readings(options: dict, traffic: dict, seed: int, device: str, run_dir: str) -> list[dict]:
    from benchmark import check, params, program, scene
    from benchmark.reference import data as ref_data
    from benchmark.reference import model as ref_model

    data_root = os.path.join(run_dir, "planar")
    scene_dir = os.path.join(data_root, options["dataset"])
    scene.write_scene(scene.make_scene(seed, options["H"], options["W"], options["batch_size"]), scene_dir)
    init = params.make_init(options, seed, device)
    spans = program.Spans()
    m, step = program.build(options, seed, init, run_dir, data_root, device, spans, visualizer=True)
    n = int(traffic.get("chunk") or 20)
    m.chunk(step, n)().result()
    prog = program.first_steps(m, step, init, n)
    start = prog["start"]
    m.it = start + program.CHECK_STEPS
    while m.it < start + FRAME_STEPS:
        k = min(n - m.it % n, start + FRAME_STEPS - m.it)
        m.chunk(step, k)().result()
        m.it += k
    m.visualize(step=m.it)
    png, leaves, it = f"{m.vis_path}/{m.vis_it - 1}.png", program.neural_image_params(m), m.it
    del m, step
    if device == "cuda":
        torch.cuda.empty_cache()
    heavy = [x["heavy"] for x in prog["losses"]]
    inputs = ref_data.load_inputs(scene_dir, options, device)
    train = lambda **kw: ref_model.train(init, inputs, options, program.CHECK_STEPS, start=start, **kw)  # noqa: E731
    ref = train()
    leaves = {k: v.to(device) for k, v in leaves.items()}
    ref_frame = ref_model.render(leaves, options, it)
    out = [dict(kind="program", **check.training_gaps(prog, ref, init), frame=check.frame_gap(png, ref_frame))]
    tf32 = train(tf32=True)
    frame_tf32 = ref_model.render(leaves, options, it, tf32=True)
    out.append(dict(kind="control_tf32", **check.training_gaps(as_readings(tf32, init, heavy), ref, init),
                    frame=float((frame_tf32 != ref_frame).mean())))
    B = int(options["batch_size"])
    half = train(keep=B - B // 2)
    out.append(dict(kind="fault_half_batch", **check.training_gaps(as_readings(half, init, heavy), ref, init)))
    out.append(dict(kind="left_out_of_change", leaves=check.left_out(ref)))
    return out


def main(argv: list[str] | None = None) -> int:
    from benchmark.run import cell_inputs, load_json

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="steady")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = load_json(ROOT, "BENCHMARK.json")
    _, traffic, options = cell_inputs(ROOT, bench, {"config": args.config, "traffic": args.traffic})
    out = sys.stdout
    for seed in [int(s) for s in args.seeds.split(",")]:
        with tempfile.TemporaryDirectory(prefix="marf_control_") as run_dir, \
                contextlib.redirect_stdout(sys.stderr):
            rows = readings(options, traffic, seed, "cuda", run_dir)
        for row in rows:
            print(json.dumps({"config": args.config, "seed": seed, **row}), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
