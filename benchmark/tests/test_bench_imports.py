"""Nothing the harness or the reference loads is JAX, its libraries or the
JAX package, compared by whole top-level name (`marf_tpu_torch` is not
`marf_tpu`); the reference imports nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark.run import FORBIDDEN
from benchmark.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def modules_of(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def sources(sub: str = "") -> list[str]:
    out = []
    for d, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_whole_names():
    top = lambda m: m.split(".")[0]  # noqa: E731
    assert top("marf_tpu_torch.engine") not in FORBIDDEN and top("marf_tpu.engine") in FORBIDDEN


def test_sources_import_no_jax():
    for path in sources():
        bad = {m for m in modules_of(path) if m.split(".")[0] in FORBIDDEN}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "contextlib", "math", "os", "numpy", "torch", "PIL", "benchmark"}
    for path in sources("reference"):
        mods = modules_of(path)
        assert {m.split(".")[0] for m in mods} <= allowed, (path, mods)
        assert all(m == "benchmark" or m.startswith("benchmark.reference") for m in mods if m.startswith("benchmark"))


def test_loaded_modules():
    """Import every module of the harness and the reference in a fresh
    process, load every reader, and look at sys.modules."""
    code = (
        "import os, sys, importlib\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark import run\n"
        f"for path in {sources()!r}:\n"
        f"    rel = os.path.relpath(path, {ROOT!r})[:-3]\n"
        "    if rel.startswith(os.path.join('benchmark', 'metrics')):\n"
        f"        run.load_reader({ROOT!r}, os.path.basename(rel))\n"
        "    else:\n"
        "        importlib.import_module(rel.replace(os.sep, '.'))\n"
        "print(run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
