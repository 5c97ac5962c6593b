"""The port's bench entry (`python -m marf_tpu_torch.bench`) against the
repository's bench.py on the CPU: the case table and baselines, each case's
options, the JSON line, the synthetic fallback and its golden label, the
golden check, the iteration rule, and the line without a card.

No JAX model is built: bench.py's `build_model` runs up to the `Model(opt)`
call, where a stand-in takes the options. The one timed run is the
canonical case at 96x128 with 24x32 patches, 200 steps on the CPU (the
kernels' plain versions; no launches).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import json

import numpy as np
import pytest
import torch

import bench
from marf_tpu_torch import bench as tbench
from marf_tpu_torch.ops.cuda import LAUNCHES
from marf_tpu_torch.utils.attrdict import to_plain_dict

SMALL = dict(H=96, W=128, patch_H=24, patch_W=32)
# the keys of bench.py's result line (bench.py:323-345) and of its `extra`
# (:297-306; final_mask_error and golden where they apply)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA_KEYS = {"case", "dataset", "device", "iters_timed", "final_psnr_db", "final_homography_error",
                    "ref_baseline_steps_per_sec", "golden"}


def test_cases_and_baselines_equal_bench_py():
    assert tbench.CASES == bench.CASES
    assert tbench.REF_BASELINE_STEPS_PER_SEC == bench.REF_BASELINE_STEPS_PER_SEC
    assert (tbench.CHUNK, tbench.WARMUP_CHUNKS) == (bench.CHUNK, bench.WARMUP_CHUNKS)


class _Built(Exception):
    pass


@pytest.mark.parametrize("case", list(bench.CASES))
def test_case_options_equal_bench_py(case, monkeypatch, tmp_path):
    """The options the port's bench trains a case with equal those that
    bench.py's build_model puts into marf_tpu's Model, knobs included."""
    import marf_tpu.engine.trainer as jtrainer

    seen = {}

    def stand_in(opt):
        seen["opt"] = opt
        raise _Built

    monkeypatch.setattr(jtrainer, "Model", stand_in)
    monkeypatch.setattr(bench.tempfile, "mkdtemp", lambda prefix: str(tmp_path))
    knobs = dict(CASE=case, MAX_ITER=600, SEED=5, DTYPE="bfloat16", FUSED_STEP="on", FUSED_WARP="off",
                 FUSED_DEDUP="off", LAZY_METRICS="on")
    for k, v in knobs.items():
        monkeypatch.setattr(bench, k, v)
    monkeypatch.delenv("MARF_BENCH_FLAT_ADAM", raising=False)
    monkeypatch.delenv("MARF_FUSED_STREAMS", raising=False)
    with pytest.raises(_Built):
        bench.build_model()
    ref = to_plain_dict(seen["opt"])
    ours = to_plain_dict(tbench.bench_options(case, 600, 5, "bfloat16", "on", "off", "off", "on", str(tmp_path)))
    assert ours == ref
    assert (ours["barf_c2f"] is None) == (case in ("fullposenc", "noposenc"))
    assert (ours["arch"]["posenc"] is False) == (case == "noposenc")


@pytest.fixture(scope="module")
def cpu_line(tmp_path_factory):
    """`main(["--cpu"])` on the canonical case at the small size, through
    the env knobs: (stdout, stderr, the returned dict)."""
    import contextlib
    import functools
    import io
    import os

    mp = pytest.MonkeyPatch()
    env = dict(MARF_BENCH_CASE="canonical", MARF_BENCH_ITERS="200", MARF_BENCH_SEED="3", MARF_BENCH_FUSED_STEP="on",
               MARF_BENCH_FLAT_ADAM="on", MARF_BENCH_PRECISION="highest")
    for k, v in env.items():
        mp.setenv(k, v)
    mp.setattr(tbench, "run_case", functools.partial(tbench.run_case, overrides=SMALL))
    mp.chdir(tmp_path_factory.mktemp("bench"))  # no data/planar here: the synthetic fallback
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            result = tbench.main(["--cpu"])
    finally:
        mp.undo()
    return out.getvalue(), err.getvalue(), result


def test_json_line_has_bench_py_keys(cpu_line):
    out, err, result = cpu_line
    lines = out.splitlines()
    assert len(lines) == 1, out  # the logs went to stderr
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(result))
    assert BENCH_KEYS <= set(line) and BENCH_EXTRA_KEYS <= set(line["extra"])
    extra = line["extra"]
    assert line["metric"] == "steps_per_sec" and line["unit"] == "steps/s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 30.0, abs=1e-3)
    assert extra["case"] == "canonical" and extra["iters_timed"] == 100 and extra["device"] == "cpu"
    assert extra["compute_dtype"] == "float32" and np.isfinite(extra["final_psnr_db"])
    assert extra["chunk"] == "eager (cpu)"  # CUDA graphs capture the step on a card only
    # the CPU runs the kernels' plain versions, which count no launch
    assert set(extra["launches"]) == set(LAUNCHES)
    assert not any(extra["launches"].values())
    assert "MARF_BENCH_FLAT_ADAM is ignored" in err


def test_synthetic_fallback_is_labelled_and_golden_skipped(cpu_line):
    extra = json.loads(cpu_line[0])["extra"]
    assert extra["dataset"] == "synthetic"
    assert extra["golden"] == {"key": "canonical@200/seed3", "skipped": "dataset synthetic"}
    assert "not found" in cpu_line[1]


@pytest.mark.parametrize("psnr", [np.float32(21.9), np.float64(25.0), float("nan")])
def test_golden_record_equals_bench_py(psnr):
    g = {"psnr": 21.97, "band": 0.35}
    ours, ref = tbench.golden_record(psnr, g), bench.golden_record(psnr, g)
    assert ours == ref or (np.isnan(psnr) and ours[0] is ref[0] is False)
    assert isinstance(ours[0], bool)
    json.dumps(ours[1])


@pytest.mark.parametrize("dataset, dtype, check, psnr, want", [
    ("cat_batch3", "float32", True, 21.9, True),
    ("cat_batch3", "float32", True, 25.0, False),
    ("synthetic", "float32", True, 21.9, "dataset synthetic"),
    ("cat_batch3", "bfloat16", True, 21.9, "compute_dtype bfloat16"),
    ("cat_batch3", "float32", False, 21.9, "MARF_BENCH_CHECK=0"),
])
def test_golden_check_only_on_cat_batch3_float32(dataset, dtype, check, psnr, want):
    ok, rec = tbench.golden_check("canonical", 600, 3, dtype, dataset, psnr, check)
    assert rec["key"] == "canonical@600/seed3"
    if isinstance(want, bool):
        assert ok is want and rec["ok"] is want and rec["psnr"] == 21.97
    else:
        assert ok is None and rec["skipped"] == want and "ok" not in rec
    assert tbench.golden_check("fullposenc", 600, 3, "float32", "cat_batch3", 21.9)[1]["skipped"] == "no golden"


@pytest.mark.parametrize("iters", [100, 150, 250, 0])
def test_iters_must_be_whole_chunks_past_warmup(iters):
    with pytest.raises(ValueError, match="multiple of 100"):
        tbench.run_case("canonical", iters, cpu=True)


def test_no_card_prints_one_error_line_and_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("MARF_BENCH_PRECISION", raising=False)
    with pytest.raises(SystemExit) as exc:
        tbench.main([])
    assert exc.value.code == 2
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["error"] == "no_cuda_device" and line["value"] is None and line["metric"] == "steps_per_sec"


@pytest.mark.parametrize("argv, precision, exc, match", [
    (["--cuda"], None, SystemExit, r"usage: python -m marf_tpu_torch.bench \[--cpu\]"),
    (["--cpu"], "high", ValueError, "MARF_BENCH_PRECISION='high'"),
    ([], "default", ValueError, "MARF_BENCH_PRECISION='default'"),
])
def test_rejects_other_arguments_and_precisions(argv, precision, exc, match, monkeypatch):
    """Each wrong input is refused by its own check, before the no-card exit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if precision is None:
        monkeypatch.delenv("MARF_BENCH_PRECISION", raising=False)
    else:
        monkeypatch.setenv("MARF_BENCH_PRECISION", precision)
    with pytest.raises(exc, match=match):
        tbench.main(argv)
