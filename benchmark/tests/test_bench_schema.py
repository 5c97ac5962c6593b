"""The result line of a run, driven on the CPU at a tiny size (the harness's
look for a card skipped): its keys, the metrics BENCHMARK.json names for the
cell, and the numbers compared with their limits, last."""

from __future__ import annotations

import json
import time

import pytest

from benchmark.run import find, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["fixed_masks.steady", "implicit_heads.trainer"])
def test_end_to_end_line(tiny_root, bench, cell):
    result = run_cell(tiny_root, bench, find(bench["workloads"], cell, "w"), 2**31 + 7, 0.5, False, "cpu",
                      time.perf_counter())
    assert list(result) == KEYS
    json.dumps(result)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    expected = {m["name"]: m["unit"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == expected
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_line(tiny_root, bench):
    cell = "fixed_masks.steady"
    result = run_cell(tiny_root, bench, find(bench["workloads"], cell, "w"), 11, 0.5, True, "cpu",
                      time.perf_counter())
    assert list(result) == KEYS[:5] + ["breakdown", "checks"]
    allowed = {m["name"]: m["unit"] for m in bench["per_layer"] if cell in m["workloads"]}
    assert result["metrics"] and all(allowed[k] == v["unit"] for k, v in result["metrics"].items())
    # on the CPU nothing runs on a device: no idle share, roofline or device time is read
    assert not {"idle_share.steady", "K1_roofline", "ops_device_ms"} & set(result["metrics"])
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in result["breakdown"].values())
