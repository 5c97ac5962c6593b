"""The comparison fails a broken timed path: each run drives the harness
on the CPU at a tiny size (its look for a card skipped) with a fault planted
in the program, and `correct` comes out false: a step that leaves its state
unchanged; half of the batch left out, the mean taken over the rest; the
top posenc band at twice its frequency, which a check at step counter 0,
where every band weighs 0, could not see. (The
cells run on one card: no exchange between chips; a training step has no
token to alter.)"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.run import find, run_cell

CELLS = ["fixed_masks.steady", "implicit_heads.steady", "fixed_masks.trainer", "implicit_heads.trainer"]


def state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch(monkeypatch):
    import marf_tpu_torch.engine.step as step_mod

    orig = step_mod.graph_loss

    def loss_over_half(outputs, data, cfg, step):
        keep = cfg.batch_size - cfg.batch_size // 2
        cut = lambda d: {k: v[:keep] if isinstance(v, torch.Tensor) and v.dim() == 4 else v  # noqa: E731
                         for k, v in d.items()}
        outputs = dict(outputs, **{k: v[:keep] for k, v in outputs.items() if v.dim() == 3})
        return orig(cut(outputs), cut(data), cfg, step)

    monkeypatch.setattr(step_mod, "graph_loss", loss_over_half)


def band_frequency(monkeypatch):
    import marf_tpu_torch.ops.posenc as posenc

    orig = posenc._frequencies

    def doubled_top_band(L, device):
        freq = orig(L, device).clone()
        freq[-1] *= 2
        return freq

    monkeypatch.setattr(posenc, "_frequencies", doubled_top_band)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, band_frequency],
                         ids=["state_unchanged", "half_batch", "band_frequency"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_fails(tiny_root, bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = run_cell(tiny_root, bench, find(bench["workloads"], cell, "w"), 5, 0.3, False, "cpu",
                      time.perf_counter())
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
