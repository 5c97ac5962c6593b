"""The trainer's `--profile=N` overlay on the CPU (twin of marf_tpu's
`profile` key, marf_tpu/engine/trainer.py:432-442, 505-533): chunks
[1, 1 + N) traced with torch.profiler (CPU activity) into `<run>/profile`,
the run otherwise bitwise the run without it, and the trace closed when the
run raises inside the window.

Bitwise: both runs under `torch.use_deterministic_algorithms(True)`, as in
tests/test_torch_lifecycle.py (on the CPU the K1 plain version's gather
backward accumulates in parallel). Sizes are `TINY` of
tests/test_torch_trainer.py; 6 steps in chunks of 2.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import glob
import json
import os

import numpy as np
import pytest
import torch

from marf_tpu_torch.engine import trainer
from test_torch_trainer import TINY


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _run(root, *extra):
    from marf_tpu_torch.train import main

    return main(["--model=planar", "--yaml=planar", "--cpu", f"--output_root={root}", "--max_iter=6",
                 "--freq.scalar=2", "--freq.vis=6", "--tpu.fused_step=on", *TINY, *extra])


def _traces(run_dir):
    files = glob.glob(os.path.join(run_dir, "profile", "*.pt.trace.json"))
    return [json.load(open(f)) for f in files]


def test_profile_is_a_pure_overlay(tmp_path, monkeypatch, capsys, deterministic):
    monkeypatch.setenv("MARF_YES", "1")
    plain = _run(tmp_path / "plain")
    capsys.readouterr()
    traced = _run(tmp_path / "traced", "--profile=1")
    out = capsys.readouterr().out
    assert f"profiler trace written to {traced.opt.output_path}/profile" in out
    assert out.count("profiler trace written") == 1
    (trace,) = _traces(traced.opt.output_path)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)  # the traced chunk's CPU ops
    assert not os.path.exists(os.path.join(plain.opt.output_path, "profile"))
    assert traced.it == plain.it == 6 and len(traced.history) == len(plain.history) == 3
    for a, b in zip(plain.history, traced.history):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    a, b = (torch.load(os.path.join(m.opt.output_path, "ckpt", "6", "state.pt"), weights_only=True)
            for m in (plain, traced))
    assert a["step"] == b["step"] == 6 and a["graph"].keys() == b["graph"].keys()
    for k in a["graph"]:
        assert torch.equal(a["graph"][k], b["graph"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)


def test_trace_closed_when_the_run_raises_inside_the_window(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MARF_YES", "1")
    real = trainer.make_train_chunk
    calls = []

    def failing(step, n, capture=None):
        chunk = real(step, n, capture)

        def dispatch():
            calls.append(n)
            handle = chunk()
            if len(calls) == 2:  # chunk 1, the traced one
                raise FloatingPointError("non-finite loss (injected)")
            return handle

        return dispatch

    monkeypatch.setattr(trainer, "make_train_chunk", failing)
    with pytest.raises(FloatingPointError, match="injected"):
        _run(tmp_path, "--profile=2", "--group=g", "--name=raises")
    assert not torch.autograd._profiler_enabled()
    run_dir = str(tmp_path / "g" / "raises_seed3")
    (trace,) = _traces(run_dir)
    assert trace["traceEvents"]
    assert f"profiler trace written to {run_dir}/profile" in capsys.readouterr().out
