"""Without a card the harness fails, prints no result, and does not fall
back to the CPU; nor does it run from a copy that holds only the benchmark."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT

ARGS = ["--workload", "fixed_masks.steady", "--seed", "1", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_main_refuses_without_card(monkeypatch, capsys):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) == 2
    assert capsys.readouterr().out == ""
