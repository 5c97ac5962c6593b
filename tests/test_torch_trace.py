"""The port's tracer (marf_tpu_torch/utils/trace.py) and what the trainer,
the chunk and the kernel wrappers record with it.

CPU: the tracer alone (nesting, parents, the step counter shared down a
chunk's spans, the ring's bound, totals, self time, counters, the summary);
a tiny `Model.train()` (tests/test_torch_trainer.py sizes, TensorBoard on)
records each set-up phase once, one `train.vis` per frame holding its
render, the panels' forward and the hand-off's wait, one `vis.write` per
frame on the writer thread holding its PNG and panels, counts the frames
and their bytes as written and every step as eager, and `steps_per_sec`
keeps its meaning; under torch.profiler the training thread's spans are
`marf.*` ranges with the same nesting (the writer thread runs with the
profiler off: its spans are records only); a tiny shared-head dedup Model
records its staging as one `setup.dedup` inside `setup.make_step` and
counts its K, E and extra pairs; the pre-split products that a float32
call of K1-K6 enqueues, at the three benchmark configurations' widths and
at 17 heads (two groups), against a hand count, and their counter `presplit_products` in the summary.
Card (`cuda`): in an eager chunk each `marf.K<i>` range holds its kernel's
device operations; a replayed graph opens none and counts its launches.
This file imports no JAX, so it runs on the card's machine as it is:
`python -m pytest tests/test_torch_trace.py -m cuda`.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import glob
import json
import os
import re
import time

import pytest
import torch

from marf_tpu_torch.utils import trace
from marf_tpu_torch.utils.attrdict import AttrDict
from marf_tpu_torch.utils.config import load_options, resolve_yaml_path
from marf_tpu_torch.utils.trace import Span, Tracer

SETUP = ["setup.load_dataset", "setup.build_networks", "setup.optimizer", "setup.visualizer", "setup.make_step"]


# ------------------------------------------------------------------ the tracer


def test_nesting_parents_and_the_chunks_counter():
    t = Tracer()
    with t.span("a", it=20, steps=20):
        with t.span("b"):
            with t.span("c", it=5):
                pass
        with t.span("d", steps=3):
            pass
    with t.span("e"):
        pass
    by = {s.name: s for s in t.records}
    assert [s.name for s in t.records] == ["c", "b", "d", "a", "e"]  # recorded as they close
    assert [by[n].index for n in "abcde"] == [0, 1, 2, 3, 4]
    assert by["a"].parent is None and by["e"].parent is None
    assert by["b"].parent == by["d"].parent == 0 and by["c"].parent == 1
    assert by["b"].attrs == {"it": 20} and by["c"].attrs == {"it": 5} and by["e"].attrs == {}
    assert by["a"].start <= by["b"].start <= by["c"].start <= by["c"].end <= by["b"].end <= by["d"].start
    assert t.totals["a"][::2] == [1, 20] and t.totals["d"][::2] == [1, 3] and t.totals["b"][::2] == [1, 0]


def test_a_span_that_raises_is_recorded_and_closed():
    t = Tracer()
    with pytest.raises(ValueError):
        with t.span("outer"):
            with t.span("inner"):
                raise ValueError("boom")
    with t.span("after"):
        pass
    assert [s.name for s in t.records] == ["inner", "outer", "after"]
    assert t.records[-1].parent is None


def test_ring_bound_and_totals_that_never_drop():
    t = Tracer(maxlen=4)
    for i in range(10):
        with t.span("x" if i % 2 else "y", steps=i):
            pass
    assert len(t.records) == 4 and [s.index for s in t.records] == [6, 7, 8, 9]
    assert t.totals["x"][0] == t.totals["y"][0] == 5
    assert t.totals["x"][2] == 1 + 3 + 5 + 7 + 9
    assert trace.RING == 65536 and trace.TRACER.records.maxlen == trace.RING


def test_spans_and_self_time():
    t = Tracer()
    t.records.extend([Span("child", 1.0, 3.0, 0, {}, 1), Span("child", 5.0, 6.0, 0, {}, 2),
                      Span("grandchild", 5.2, 5.8, 2, {}, 3), Span("parent", 0.0, 10.0, None, {}, 0),
                      Span("child", 11.0, 12.0, None, {}, 4)])
    parent = t.spans("parent")[0]
    assert t.self_time(parent) == pytest.approx(10.0 - 2.0 - 1.0)
    assert t.self_time(t.spans("child")[1]) == pytest.approx(1.0 - 0.6)
    assert [s.index for s in t.spans("child", 0.5, 5.0)] == [1, 2]
    assert [s.index for s in t.spans("child")] == [1, 2, 4]


def test_counters_snapshot_summary_and_reset():
    t = Tracer()
    t.count("frames")
    with t.span("train.vis"):
        pass
    base = t.snapshot()
    t.count("frames", 2)
    t.count("frame_bytes", 300)
    for _ in range(2):
        with t.span("train.vis"):
            pass
    assert t.counters == {"frames": 3, "frame_bytes": 300}
    lines = t.summary(base)
    assert len(lines) == 2 and lines[0].startswith("span train.vis: 2 x, ")
    assert lines[1] == "counters: frame_bytes 300, frames 2"
    assert t.summary(t.snapshot()) == ["counters: none"]
    t.reset()
    assert not t.records and not t.totals and not t.counters
    with t.span("z"):
        pass
    assert t.records[0].index == 3  # indices go on after a reset


def test_a_counter_new_since_the_snapshot_shows_at_zero():
    """A dedup step with no extra column still prints `dedup_extras 0`; a
    counter the snapshot held and that did not grow stays out."""
    t = Tracer()
    t.count("frames")
    base = t.snapshot()
    t.count("frames", 0)
    t.count("dedup_extras", 0)
    assert t.summary(base) == ["counters: dedup_extras 0"]


# the pre-split products a float32 step's kernels enqueue, counted by hand at
# planar.yaml's widths (rgb 34 -> 256 x4 -> 3, the Ha-NeRF mask head 426 ->
# 256 x4 -> 1), a grouped launch over up to 16 heads counting once: K1, K2
# and K5 a forward and a dz product per hidden rgb layer (4 + 4); K3 the mask
# head's hidden layers after its first (3); K4 those in its recompute and
# their gated dz products (3 + 3); K5 adds its heads' forward of those 3
# layers per group (8 + 3 at 5 heads, 8 + 3 + 3 at 17: two groups); K6 its
# recompute and gated dz per group (6 at 5 heads, 12 at 17)
PRESPLIT_BY_HAND = {
    "fixed_masks": (1, {"K1": 8}),
    "implicit_heads": (5, {"K5": 11, "K6": 6}),
    "implicit_heads_17": (17, {"K5": 14, "K6": 12}),
    "implicit_shared": (1, {"K3": 3, "K1": 8, "K4": 6}),
}


@pytest.mark.parametrize("config", sorted(PRESPLIT_BY_HAND))
def test_presplit_products_at_the_configurations_widths(config):
    from marf_tpu_torch.models.implicit_mask import ImplicitMask
    from marf_tpu_torch.models.neural_image import NeuralImageConfig
    from marf_tpu_torch.ops.cuda import count_presplit, presplit_products

    opt = load_options(resolve_yaml_path("planar"))
    arch = NeuralImageConfig(layers=tuple(opt.arch.layers), posenc_L=opt.arch.posenc.L_2D)
    head = ImplicitMask()
    widths = {"rgb": [arch.input_dim] + [k_out for _, k_out in arch.layer_dims],
              "mask": [head.layers[0].in_features] + [layer.out_features for layer in head.layers]}
    assert widths == {"rgb": [34, 256, 256, 256, 256, 3], "mask": [426, 256, 256, 256, 256, 1]}
    heads, by_hand = PRESPLIT_BY_HAND[config]
    args = {"K1": (widths["rgb"],), "K2": (widths["rgb"],), "K3": (widths["mask"],), "K4": (widths["mask"],),
            "K5": (widths["rgb"], heads, widths["mask"]), "K6": (widths["mask"], heads)}
    got = {k: presplit_products(k, *args[k]) for k in by_hand}
    assert got == by_hand
    assert presplit_products("K2", widths["rgb"]) == 8

    base = trace.snapshot()
    for k in by_hand:
        count_presplit(k, *args[k])
    step = sum(by_hand.values())
    assert trace.COUNTERS["presplit_products"] - base[1].get("presplit_products", 0) == step
    assert f"presplit_products {step}" in trace.summary(base)[-1]


# ----------------------------------------------------------------- the trainer


def make_opt(tmp_path, **overrides):
    opt = load_options(resolve_yaml_path("planar"))
    opt.update(AttrDict(
        model="planar", yaml="planar", group="it", name="run", seed=3, dataset="synthetic",
        H=32, W=64, patch_H=16, patch_W=32, batch_size=3, max_iter=12, barf_c2f=[0, 0.4],
        output_path=str(tmp_path / "out"), freq=AttrDict(scalar=2, vis=4, ckpt=6), save_checkpoint=True, cpu=True,
    ))
    opt.arch.layers = [None, 64, 64, 3]
    opt.arch.posenc.L_2D = 4
    opt.update(AttrDict(overrides))
    os.makedirs(opt.output_path, exist_ok=True)
    return opt


def _train(opt):
    from marf_tpu_torch.engine.trainer import Model

    m = Model(opt)
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    m.setup_visualizer()
    m.train()
    return m


def _children(parent: Span, spans: list) -> list:
    return [s for s in spans if s.parent == parent.index]


def _on_writer_thread(spans: list) -> set:
    """Indices of the `vis.write` spans and every span under them."""
    by_index = {s.index: s for s in spans}

    def under_write(s):
        while s is not None:
            if s.name == "vis.write":
                return True
            s = by_index.get(s.parent)
        return False

    return {s.index for s in spans if under_write(s)}


@pytest.mark.parametrize("implicit", [False, True], ids=["fixed_masks", "implicit_heads"])
def test_train_records_its_spans_and_counters(tmp_path, capsys, implicit):
    extra = dict(use_implicit_mask=True, use_masks=False, build_single_masks=True) if implicit else {}
    t0 = time.perf_counter()
    counters = dict(trace.COUNTERS)
    m = _train(make_opt(tmp_path, **extra))
    out = capsys.readouterr().out
    recorded = [s for s in trace.TRACER.records if s.start >= t0]
    names = [s.name for s in recorded]
    grown = {k: v - counters.get(k, 0) for k, v in trace.COUNTERS.items()}

    assert all(names.count(n) == 1 for n in SETUP)
    # one train.vis per frame (step 0, then every freq.vis), holding its render, the panels' forward and the
    # hand-off's wait; one vis.write per frame on the writer thread, holding its PNG and panels
    pngs = sorted(glob.glob(os.path.join(m.vis_path, "*.png")))
    frames = [s for s in recorded if s.name == "train.vis"]
    writes = [s for s in recorded if s.name == "vis.write"]
    assert len(frames) == len(writes) == len(pngs) == 1 + 12 // 4
    assert [s.attrs["it"] for s in frames] == [s.attrs["it"] for s in writes] == [0, 4, 8, 12]
    waits = []
    for f, w in zip(frames, writes):
        kids = _children(f, recorded)
        assert [k.name for k in kids] == ["vis.render"] + ["vis.panel_forward"] * implicit + ["vis.wait"]
        assert sum(k.end - k.start for k in kids) <= f.end - f.start
        assert all(f.start <= k.start and k.end <= f.end and k.attrs["it"] == f.attrs["it"] for k in kids)
        waits.append(kids[-1])
        assert w.parent is None and w.start >= kids[-1].end  # handed off after the wait
        parts = _children(w, recorded)
        assert [k.name for k in parts] == ["vis.png", "vis.panels"]
        assert all(w.start <= k.start and k.end <= w.end and k.attrs["it"] == w.attrs["it"] for k in parts)
        assert {p.name for p in _children(parts[1], recorded)} == {"tb.image"}
    # one frame deep: a hand-off goes on only once the frame before it is written
    assert all(wait.end >= w.end for wait, w in zip(waits[1:], writes))
    assert grown["vis_handoffs"] == len(frames) and 0 <= grown.get("vis_waits", 0) < len(frames)
    assert grown["frames"] == len(pngs) and grown["frame_bytes"] == sum(os.path.getsize(p) for p in pngs)
    assert grown["tb_events"] > 0 and grown["tb_bytes"] > 0
    assert grown["ckpt_bytes"] == sum(os.path.getsize(p) for p in glob.glob(f"{m.opt.output_path}/ckpt/*/state.pt"))
    assert names.count("train.ckpt") == 2 and names.count("train.video") == 1
    # the CPU runs every step eagerly, in chunks of gcd(2, 4, 6) = 2 steps
    assert grown["eager_steps"] == 12 and grown.get("captures", 0) == grown.get("replays", 0) == 0
    iters = [s for s in recorded if s.name == "train.iter"]
    assert [s.attrs for s in iters] == [{"it": 2 * (k + 1), "steps": 2} for k in range(6)]
    for it in iters:
        dispatch = [k for k in _children(it, recorded) if k.name == "train.dispatch"]
        assert len(dispatch) == 1
        assert [c.name for c in _children(dispatch[0], recorded)] == ["chunk.eager", "chunk.copy"]
        reads = [k for k in _children(it, recorded) if k.name == "train.read"]
        assert all([c.name for c in _children(r, recorded)][:1] == ["chunk.wait"] for r in reads)
    # steps_per_sec: the steps of every chunk after the first over their train.iter seconds
    assert m.steps_per_sec == pytest.approx(10 / sum(s.end - s.start for s in iters[1:]))
    assert "mean steps/sec" in out and "span train.vis: 4 x" in out
    assert re.search(r"counters: .*eager_steps 12, .*frames 4", out)


def test_profiler_shows_the_spans_as_marf_ranges(tmp_path):
    from marf_tpu_torch.engine.trainer import Model

    m = Model(make_opt(tmp_path, max_iter=4, freq=AttrDict(scalar=2, vis=4, ckpt=None), save_checkpoint=False))
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    m.setup_visualizer()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m.train()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if str(e.get("name", "")).startswith("marf.")]
    recorded = [s for s in trace.TRACER.records if s.start >= t0]
    # the writer thread runs with the profiler off: its spans (vis.write, vis.png, vis.panels, tb.image) open
    # no range; every span of the training thread does
    writer = _on_writer_thread(recorded)
    assert {s.name for s in recorded if s.index in writer} == {"vis.write", "vis.png", "vis.panels", "tb.image"}
    recorded = [s for s in recorded if s.index not in writer]
    ranges = {}
    for e in events:
        ranges.setdefault(e["name"][len("marf."):], []).append((e["ts"], e["ts"] + e["dur"]))
    assert {n: len(v) for n, v in ranges.items()} == {n: [s.name for s in recorded].count(n) for n in
                                                      {s.name for s in recorded}}
    assert {"train.vis", "vis.render", "vis.wait", "train.iter"} <= set(ranges)
    # each span's range lies inside its parent's range
    by_index = {s.index: s for s in recorded}
    order = {n: sorted(v) for n, v in ranges.items()}
    rank = {s.index: sorted(x.start for x in recorded if x.name == s.name).index(s.start) for s in recorded}
    for s in recorded:
        if s.parent in by_index:
            p = by_index[s.parent]
            a0, a1 = order[s.name][rank[s.index]]
            b0, b1 = order[p.name][rank[p.index]]
            assert b0 <= a0 and a1 <= b1, (s.name, p.name)


def test_dedup_staging_is_a_span_of_make_step_with_its_sizes_counted(tmp_path, capsys):
    """The shared head's fused dedup step (plain twins on the CPU): one
    `setup.dedup` inside `setup.make_step`, the counters equal to the K, E
    and extra pairs that `stage_mask_inputs` stages, and the closing summary
    prints them."""
    from marf_tpu_torch.engine.step import stage_mask_inputs
    from marf_tpu_torch.engine.trainer import Model

    opt = make_opt(tmp_path, use_implicit_mask=True, use_masks=False, build_single_masks=False, max_iter=4,
                   freq=AttrDict(scalar=2, vis=4, ckpt=None), save_checkpoint=False, tb=None)
    opt.tpu.fused_step = "on"
    m = Model(opt)
    m.load_dataset()
    m.data["rgb"][1, :, 2:8, 4:12] = 1.0  # saturated in one photo: extra dedup columns there
    m.build_networks()
    m.setup_optimizer()
    m.setup_visualizer()
    t0, counters = time.perf_counter(), dict(trace.COUNTERS)
    m.train()
    out = capsys.readouterr().out
    recorded = [s for s in trace.TRACER.records if s.start >= t0]
    grown = {k: trace.COUNTERS.get(k, 0) - counters.get(k, 0) for k in ("dedup_columns", "dedup_extras", "dedup_pairs")}

    assert "fused implicit dedup (K3 -> K1 -> K4)" in m.step.path
    (dedup,) = [s for s in recorded if s.name == "setup.dedup"]
    (make_step,) = [s for s in recorded if s.name == "setup.make_step"]
    assert dedup.parent == make_step.index and make_step.start <= dedup.start <= dedup.end <= make_step.end
    *_, ext_off, _, _, _, K = stage_mask_inputs(m.graph, m.data["rgb"])
    E = K - opt.patch_H * opt.patch_W
    assert E > 0 and grown == {"dedup_columns": K, "dedup_extras": E, "dedup_pairs": ext_off.numel()}
    assert re.search(rf"counters: .*dedup_columns {K}, dedup_extras {E}, dedup_pairs {ext_off.numel()}", out)
    assert "span setup.dedup: 1 x" in out


# -------------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the card: python -m pytest tests/test_torch_trace.py -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# the hand-written kernels' device functions (csrc/*.cu, *.cuh)
OWN_KERNEL = re.compile(r"\b(tc_gemm|tc_presplit|tb_gemm|head|encode|encode_bwd|coords_bwd|mask_head_fwd|mask_head_bwd|presplit|"
                        r"presplit_bf16|cast_bf16|colsum|reduce|reduce_group|reduce_tree_group)_kernel\b")


def _card_step(tmp_path, implicit: bool):
    from marf_tpu_torch.engine.trainer import Model

    extra = dict(use_implicit_mask=True, use_masks=False, build_single_masks=True) if implicit else {}
    m = Model(make_opt(tmp_path, cpu=False, tb=None, **extra))
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    return m.make_step()


def _eager_profile(step, names: list) -> tuple[dict, list]:
    """({name: device-side spans of that range}, [(start, end, name)] of the
    device operations) of a profiled eager chunk of 3 steps, the kernels
    built and warm."""
    from marf_tpu_torch.engine.step import make_train_chunk

    make_train_chunk(step, 2, capture=False)().result()
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        make_train_chunk(step, 3, capture=False)().result()
        torch.cuda.synchronize()
    events = prof.events()
    host = {e.name for e in events if e.device_type != cuda}
    ranges = {n: [(e.time_range.start, e.time_range.end) for e in events if e.device_type == cuda and e.name == n]
              for n in names}
    ops = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == cuda and e.name not in host]
    return ranges, ops


def _check_ranges_hold_the_kernels(ranges: dict, ops: list) -> None:
    for name, spans in ranges.items():
        assert len(spans) == 3, name  # one a step
        assert all(any(r0 <= s and e <= r1 for s, e, _ in ops) for r0, r1 in spans), name
    own = [(s, e) for s, e, n in ops if OWN_KERNEL.search(n) and "at::" not in n]
    assert own and all(any(r0 <= s and e <= r1 for spans in ranges.values() for r0, r1 in spans) for s, e in own)


@pytest.mark.cuda
@pytest.mark.parametrize("implicit", [False, True], ids=["K1", "K5_K6"])
def test_kernel_ranges_hold_their_device_operations(cuda_device, tmp_path, implicit):
    from marf_tpu_torch.engine.step import make_train_chunk
    from marf_tpu_torch.ops.cuda import LAUNCHES

    step = _card_step(tmp_path, implicit)
    tags = ["K5", "K6"] if implicit else ["K1"]
    _check_ranges_hold_the_kernels(*_eager_profile(step, [f"marf.{t}" for t in tags]))

    # captured: the warm-up and capture count each launch once; a replay opens no range and counts as before
    fn = "fused_implicit_train_kernel" if implicit else "fused_train_kernel_warp"
    chunk = make_train_chunk(step, 4)
    before, counters = LAUNCHES[fn], dict(trace.COUNTERS)
    chunk().result()
    assert LAUNCHES[fn] == before + 4
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        chunk().result()
    assert LAUNCHES[fn] == before + 8
    names = {e.name for e in prof.events()}
    assert "marf.chunk.replay" in names and not {f"marf.{t}" for t in tags} & names
    grown = {k: trace.COUNTERS.get(k, 0) - counters.get(k, 0) for k in ("eager_steps", "captures", "replays")}
    assert grown == {"eager_steps": 4, "captures": 2, "replays": 4}


@pytest.mark.cuda
def test_a_callers_own_range_on_a_wrapper_keeps_its_kernels(cuda_device, tmp_path, monkeypatch):
    """A range that a caller puts around a wrapper before the step is made
    (a harness's own attribution) stays the innermost range: the profiler
    credits it, not `marf.K1` around it, with K1's device operations."""
    from marf_tpu_torch.ops.cuda import fused_step

    real = fused_step.fused_train_kernel_warp

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function("caller.K1"):
            return real(*args, **kwargs)

    monkeypatch.setattr(fused_step, "fused_train_kernel_warp", wrapped)
    _check_ranges_hold_the_kernels(*_eager_profile(_card_step(tmp_path, False), ["caller.K1"]))
