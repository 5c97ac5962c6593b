"""BENCHMARK.json against the benchmark's contract, and each cell's files
found by name."""

from __future__ import annotations

import os
import re

import pytest

from benchmark.tests.conftest import ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|_dim$|_rank$|expansion|experts_per_tok)")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert bench["command"][1] == "benchmark/run.py" and os.path.isfile(os.path.join(ROOT, bench["command"][1]))
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_check_budget(bench):
    """A full check of 24 cells at run_seconds fits its 43,200 seconds."""
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in bench[group]:
            assert NAME.match(item["name"]), item["name"]
            names.append((group, item["name"]))
            if "unit" in item:
                assert UNIT.match(item["unit"]) and item["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [n for g, n in names if g == group]
        assert len(group_names) == len(set(group_names))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        cfg = load(ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert set(cfg["changed"]) == set(c["reduced"])


@pytest.mark.parametrize("cell", [w["name"] for w in load(ROOT, "BENCHMARK.json")["workloads"]])
def test_cell_resolves_by_name(bench, cell):
    from benchmark.run import cell_inputs

    w = next(w for w in bench["workloads"] if w["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4) and _line(w["why"])
    config, traffic, options = cell_inputs(ROOT, bench, w)
    assert config["name"] == w["config"]
    assert os.path.isfile(os.path.join(ROOT, "benchmark", "loops", f"{traffic['loop']}.py"))
    limits = load(ROOT, "benchmark", "limits", f"{cell}.json")
    assert limits["cell"] == cell
    expected = {"loss", "grad", "grad_median", "change", "nonfinite_steps"}
    if traffic["loop"] == "trainer":
        expected.add("frame")
    assert set(limits["limits"]) == expected
    assert options["max_iter"] == traffic["options"]["max_iter"]
    reported = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_pairs_and_chips(bench):
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_end_to_end(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells


def test_per_layer(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
        # every cell it lists reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())

