"""The comparison that decides `correct`: what the timed path produced,
against the plain reference run on the same inputs from the same seed.

Numbers (each a gap, 0 when equal; each held to its limit in
`limits/<cell>.json`):
  - `loss`: over the three checked steps (from the seed's state, the step
    counter at `program.check_start`, part-way through the schedule), the
    worst relative gap |p - r| / |r| of the step's masked rgb MSE, and of
    the total loss on the chunk-final (heavy) steps, where every term is
    computed (a light step skips metric-only terms under the port's lazy
    metrics);
  - `grad`: over the trained leaves, the worst gap between the norms of the
    first gradient, the program's read from Adam's state after step 1 (its
    first moment over 1 - beta1), |‖g_p‖ - ‖g_r‖| / max(‖g_r‖, the median
    leaf's ‖g_r‖): the gap of the norms, not the norm of the difference;
  - `grad_median`: the median over the leaves of the same gaps, steadier
    from seed to seed than the worst leaf (PERF.md gives the readings);
  - `change`: the same for the change of each leaf over the three steps, over the
    leaves whose reference gradient is at least a thousandth of the median
    leaf's (a leaf with a gradient nought to rounding moves by round-off
    alone under Adam);
  - `frame` (the trainer loop): the share of the last frame's 8-bit values
    that differ from the reference's render of the same parameters;
  - `nonfinite_steps`: the steps of the window whose loss was not finite.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

CHANGE_FLOOR = 1e-3  # of the median leaf's reference gradient


def ref_norms(ref: dict, init: dict) -> tuple[dict, dict]:
    grads = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref["grads"].items()}
    change = {k: float(torch.linalg.vector_norm((ref["params"][k] - init[k]).double())) for k in ref["grads"]}
    return grads, change


def _norm_gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: |prog - ref| / max(ref, the median leaf's ref)} of leaf norms."""
    scale = float(np.median([ref[k] for k in leaves]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], scale) for k in leaves}


def leaf_gaps(prog: dict, ref: dict, init: dict) -> tuple[dict, dict]:
    """({leaf: grad gap}, {leaf: change gap}) over the leaves each covers."""
    g_ref, c_ref = ref_norms(ref, init)
    if set(g_ref) != set(prog["grads"]):
        raise ValueError(f"trained leaves differ: {sorted(set(g_ref) ^ set(prog['grads']))}")
    median = float(np.median(list(g_ref.values())))
    moved = [k for k in g_ref if g_ref[k] >= CHANGE_FLOOR * median]
    return _norm_gaps(prog["grads"], g_ref, list(g_ref)), _norm_gaps(prog["change"], c_ref, moved)


def training_gaps(prog: dict, ref: dict, init: dict) -> dict:
    """`loss`, `grad` and `change` of the program's first steps (`program.
    first_steps`) against the reference's (`reference.model.train`)."""
    losses = []
    for p, r in zip(prog["losses"], ref["losses"]):
        losses.append(abs(p["rgb"] - r["rgb"]) / abs(r["rgb"]))
        if p["heavy"]:
            losses.append(abs(p["all"] - r["all"]) / abs(r["all"]))
    grad, change = leaf_gaps(prog, ref, init)
    return {"loss": max(losses), "grad": max(grad.values()), "grad_median": float(np.median(list(grad.values()))),
            "change": max(change.values())}


def left_out(ref: dict) -> list[str]:
    """The leaves that `change` leaves out, by the rule on the reference's gradient."""
    g = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["grads"].items()}
    median = float(np.median(list(g.values())))
    return sorted(k for k in g if g[k] < CHANGE_FLOOR * median)


def frame_gap(frame_png: str, reference_frame: np.ndarray) -> float:
    """The share of 8-bit values of the written frame that differ from the
    reference's [H, W, 3] uint8 frame."""
    from PIL import Image

    written = np.asarray(Image.open(frame_png).convert("RGB"))
    if written.shape != reference_frame.shape:
        return 1.0
    return float(np.mean(written != reference_frame))


def load_limits(root: str, cell: str) -> dict:
    with open(os.path.join(root, "benchmark", "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit (a NaN fails)."""
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
