"""The port's fused dedup step for the shared implicit mask head (K3 -> K1 ->
K4, their plain twins on the CPU) against the benchmark's plain reference
(`benchmark/reference/model.py`, float32 PyTorch that computes every
position's mask column with no dedup): three steps from seeded random
weights on a tiny scene whose photos hold saturated pixels, so that the
dedup has extra columns (E > 0). Loss, the first gradient and the change
after three steps agree within float32 rounding; the planted fault of the
extras dropped (every position reads its pixel's slot0 column) does not.
This file imports no JAX."""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import os

import numpy as np
import pytest
import torch

from benchmark import params, program, scene
from benchmark.control_shared import extras_dropped
from benchmark.reference import data as ref_data
from benchmark.reference import model as ref_model
from benchmark.run import cell_inputs, load_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7
SIZE = {"H": 48, "W": 64, "patch_H": 24, "patch_W": 32}
# Each gap over the reference's own scale: the loss terms relative, each
# leaf's first gradient and 3-step change by the norm of its difference over
# the reference leaf's norm, the worst leaf. The dedup step sums in another
# order than the reference (the normalizer as a dot of column counts and m,
# the segment sums over slot0 tiles and extras), so on this scene its loss
# reads 9e-7 and its gradients 5-7e-7 from run to run (the K1 plain twin's
# gather backward sums in parallel on the CPU): ten times and more. Adam's
# first steps divide each element's gradient by its own root mean square,
# so an element whose gradient is nought to rounding moves by up to 2 lr
# either way: the neural image's change reads 2.0e-3 (`mlp.0.weight`); the
# head's, whose every element has a gradient, reads 1.2e-6 and is held on
# its own. The extras dropped read 4.7e-3 (loss), 9.5e-3 (gradient), 0.53
# (change) and 0.53 (the head's change).
TOL = {"loss": 1e-5, "grad": 1e-5, "change": 2e-2, "mask_change": 2e-5}


def _options() -> dict:
    bench = load_json(ROOT, "BENCHMARK.json")
    _, _, options = cell_inputs(ROOT, bench, {"config": "marf_implicit_shared_f32", "traffic": "steady"})
    options.update(SIZE)
    options["tpu"]["fused_step"] = "on"
    return options


def _scene(tmp_path, options) -> str:
    """The benchmark's scene with saturated blocks planted: white in photo 1,
    a red channel at 1 in photo 2, so that those pixels' truncated colour
    differs between images."""
    s = scene.make_scene(SEED, options["H"], options["W"], options["batch_size"])
    s["rgb"][1, :, 14:26, 18:34] = 1.0
    s["rgb"][2, 0, 20:34, 26:46] = 1.0
    ddir = os.path.join(tmp_path, "planar", options["dataset"])
    scene.write_scene(s, ddir)
    return ddir


def _program_run(tmp_path, options, ddir, init) -> dict:
    """Three steps of the port from `init`, the counter at the check's start:
    {"path", "K", "E", "losses": [{"rgb", "all"}] per step, "grads": step
    1's gradient by leaf (Adam's first moment over 1 - beta1), "params"}."""
    from marf_tpu_torch.utils import trace

    before = dict(trace.COUNTERS)
    m, step = program.build(options, SEED, init, str(tmp_path), os.path.dirname(ddir), "cpu", program.Spans(), False)
    sizes = {k: trace.COUNTERS.get(k, 0) - before.get(k, 0) for k in ("dedup_columns", "dedup_extras")}
    program.reset(m, step, init, program.check_start(options))
    leaves = {k: p for k, p in params.program_leaves(m.graph).items() if p.requires_grad}
    rows = [m.chunk(step, 1)().result()]
    beta1 = {id(p): g["betas"][0] for g in m.optimizer.param_groups for p in g["params"]}
    grads = {k: m.optimizer.state[p]["exp_avg"] / (1.0 - beta1[id(p)]) for k, p in leaves.items()}
    rows.append(m.chunk(step, 2)().result())
    losses = [{"rgb": float(md["loss_rgb"][i]), "all": float(md["all"][i])} for md in rows
              for i in range(len(md["all"]))]
    return {"path": step.path, "K": sizes["dedup_columns"], "E": sizes["dedup_extras"], "losses": losses,
            "grads": {k: g.clone() for k, g in grads.items()}, "params": {k: p.detach().clone() for k, p in leaves.items()}}


def _gaps(prog: dict, ref: dict, init: dict) -> dict:
    loss = max(abs(p[k] - r[k]) / abs(r[k]) for p, r in zip(prog["losses"], ref["losses"]) for k in ("rgb", "all")
               if k == "rgb" or p["all"] != 0)  # a light step's total is a chunk-final metric only
    gap = lambda a, b: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))  # noqa: E731
    change = {k: gap(prog["params"][k] - init[k], ref["params"][k] - init[k]) for k in prog["grads"]}
    return {"loss": loss, "grad": max(gap(prog["grads"][k], ref["grads"][k]) for k in prog["grads"]),
            "change": max(change.values()), "mask_change": max(v for k, v in change.items() if k.startswith("mask."))}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("shared")
    options = _options()
    ddir = _scene(str(tmp_path), options)
    init = params.make_init(options, SEED, "cpu")
    ref = ref_model.train(init, ref_data.load_inputs(ddir, options, "cpu"), options, program.CHECK_STEPS,
                          start=program.check_start(options))
    return tmp_path, options, ddir, init, ref


def test_dedup_step_follows_the_reference(case):
    tmp_path, options, ddir, init, ref = case
    prog = _program_run(tmp_path / "ok", options, ddir, init)
    assert prog["path"].startswith("fused implicit dedup (K3 -> K1 -> K4)")
    hw = options["patch_H"] * options["patch_W"]
    assert prog["E"] > 0 and prog["K"] == hw + prog["E"]
    assert set(prog["grads"]) == set(ref["grads"]) and any(k.startswith("mask.0.") for k in prog["grads"])
    gaps = _gaps(prog, ref, init)
    assert all(gaps[k] < TOL[k] for k in TOL), gaps


def test_extras_dropped_fails_the_comparison(case):
    """The planted fault: every position reads its pixel's slot0 column."""
    tmp_path, options, ddir, init, ref = case
    with extras_dropped():
        prog = _program_run(tmp_path / "fault", options, ddir, init)
    hw = options["patch_H"] * options["patch_W"]
    assert prog["E"] == 0 and prog["K"] == hw
    gaps = _gaps(prog, ref, init)
    assert all(gaps[k] > 10 * TOL[k] for k in TOL), gaps
    assert np.isfinite(list(gaps.values())).all()
