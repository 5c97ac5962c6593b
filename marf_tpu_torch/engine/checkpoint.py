"""Checkpoint save, restore and resume (twin of marf_tpu/engine/checkpoint.py).

The reference has `load:` / `resume:` config keys (options/planar.yaml:31,88)
but never saves or restores (SURVEY.md §2.4(2)). A checkpoint here is the
directory `<output_path>/ckpt/<step>/` holding `state.pt`: the step, the
graph's state_dict, the optimizer's and the LR scheduler's (None without
one), written by `torch.save` and read back onto the run's device with
`map_location`. `--resume` takes the latest step of the run directory (an
int takes that step); `--load=<path>` restores from a run directory or from a
checkpoint directory.

One format on every device: the optimizer's learning rates are written as
floats (on a card they are tensors, `LrSchedule`), and a restore keeps the
live optimizer's own build flags (`capturable`, `fused`, `foreach`) and
learning-rate tensors. So a checkpoint moves between the CPU and a card,
between a captured run and an eager one, and one written before the
schedule moved to the device (a LambdaLR state, float rates) loads.
"""

from __future__ import annotations

import os

import torch

from marf_tpu_torch.utils import trace
from marf_tpu_torch.utils.console import log

_CKPT_SUBDIR = "ckpt"
_STATE_FILE = "state.pt"


def _ckpt_dir(output_path: str) -> str:
    return os.path.abspath(os.path.join(output_path, _CKPT_SUBDIR))


def save_checkpoint(output_path: str, step: int, graph, optimizer, scheduler=None) -> str:
    """Write the training state under `<output_path>/ckpt/<step>`; returns
    that directory. The file is written beside its final name and renamed
    over it, so a run stopped mid-write leaves the earlier file whole."""
    path = os.path.join(_ckpt_dir(output_path), str(int(step)))
    os.makedirs(path, exist_ok=True)
    state = {
        "step": int(step),
        "graph": graph.state_dict(),
        "optimizer": _float_lrs(optimizer.state_dict()),
        "scheduler": None if scheduler is None else scheduler.state_dict(),
    }
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    torch.save(state, tmp)
    trace.count("ckpt_bytes", os.path.getsize(tmp))
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    log.info(f"saved checkpoint @ step {step} -> {path}")
    return path


# an optimizer's build flags: the live optimizer's stand over a checkpoint's
_BUILD_FLAGS = ("capturable", "fused", "foreach", "differentiable")


def _float_lrs(opt_state: dict) -> dict:
    groups = [{k: float(v) if k == "lr" else v for k, v in g.items()} for g in opt_state["param_groups"]]
    return dict(opt_state, param_groups=groups)


def latest_checkpoint(output_path: str) -> str | None:
    """The checkpoint directory of the highest step, or None."""
    d = _ckpt_dir(output_path)
    if not os.path.isdir(d):
        return None
    steps = [int(s) for s in os.listdir(d) if s.isdigit()]
    if not steps:
        return None
    return os.path.join(d, str(max(steps)))


def restore_checkpoint(path: str, graph, optimizer, scheduler=None, device=None) -> int:
    """Load the state at `path` (a checkpoint directory or its file) into
    `graph`, `optimizer` and `scheduler`; returns its step. Raises when the
    file is missing or does not fit: a scheduler on one side only, other
    parameter names or shapes."""
    fname = os.path.join(path, _STATE_FILE) if os.path.isdir(path) else path
    state = torch.load(fname, map_location=device, weights_only=True)
    if (state["scheduler"] is None) != (scheduler is None):
        raise ValueError(f"checkpoint {path}: LR scheduler state {'absent' if state['scheduler'] is None else 'present'}, "
                         f"but this run {'has' if scheduler is not None else 'has no'} scheduler (optim.apply_sched)")
    graph.load_state_dict(state["graph"])
    live = optimizer.param_groups
    saved = state["optimizer"]
    if len(saved["param_groups"]) == len(live):
        groups = [dict(g, **{k: lg[k] for k in _BUILD_FLAGS if k in lg}) for g, lg in zip(saved["param_groups"], live)]
        saved = dict(saved, param_groups=groups)
    lrs = [g["lr"] for g in live]
    optimizer.load_state_dict(saved)
    for group, lr in zip(optimizer.param_groups, lrs):
        if isinstance(lr, torch.Tensor):
            group["lr"] = lr  # the schedule's tensor, rewritten by its own state below
        else:
            group["lr"] = float(group["lr"])
    if scheduler is not None:
        scheduler.load_state_dict(state["scheduler"])
    return int(state["step"])


def resolve_restore_path(output_path: str, load: str | None, resume) -> str | None:
    """Honor the reference's `load:` / `resume:` config keys
    (options/planar.yaml:31,88): `load` is an explicit path (a run directory
    or a checkpoint directory); `resume` True -> the latest checkpoint of
    this run directory, an int -> that step."""
    if load:
        cand = load
        if os.path.isdir(os.path.join(cand, _CKPT_SUBDIR)):
            cand = latest_checkpoint(cand)
        return cand
    if resume:
        if resume is True:
            return latest_checkpoint(output_path)
        return os.path.join(_ckpt_dir(output_path), str(int(resume)))
    return None
