"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
with every configuration cut to a tiny canvas (24 x 32, patches of 12 x 16)
and short chunks, so that a whole run fits a test."""

from __future__ import annotations

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {"H": 24, "W": 32, "patch_H": 12, "patch_W": 16}


def load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def bench():
    return load(ROOT, "BENCHMARK.json")


@pytest.fixture
def tiny_root(tmp_path):
    """A root holding BENCHMARK.json and a copy of benchmark/ at the tiny size."""
    root = str(tmp_path / "root")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for c in load(root, "BENCHMARK.json")["configs"]:
        path = os.path.join(root, c["file"])
        cfg = load(path)
        cfg["options"].update(TINY)
        with open(path, "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(root, "benchmark", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        t = load(path)
        if t["loop"] == "steady":
            t["chunk"] = 10
        else:
            t["options"]["freq"] = {"scalar": 2, "vis": 10, "ckpt": None}
        t["options"]["max_iter"] = 1000
        with open(path, "w") as f:
            json.dump(t, f)
    return root
