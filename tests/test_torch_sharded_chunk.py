"""The compiled sharded chunk on the CPU: how a step under a mesh is split
into CUDA graphs at its collectives (engine/step.py `chunk_mode`,
`_Segments`, `TrainChunk`; parallel/mesh.py `Collectives`).

The capture and its replay run only on a card (tests/test_torch_parallel_card.py,
`-m cuda`); here:
- `chunk_mode` on stand-in steps: a CPU mesh eager, a card mesh (gloo or
  NCCL) captured in segments, capture=False eager, capture=True on the CPU
  refused; the mode's segment counts once captured;
- `Collectives.psum` under a stand-in capture: no collective, the buffer
  handed to the cut, the views read what the replay's all_reduce writes;
- `_Segments.replay` with stand-in graphs: graph 0, all_reduce(buffer 0),
  graph 1, ..., the launches of every segment added per replay;
- the collectives of one rank's step on each sharded path, recorded with
  `torch.distributed.all_reduce` replaced by a recorder in one process
  (rank 0 and rank 1 of 2 in turn, half the patch sides of
  tests/test_torch_parallel.py, lazy metrics on as on a card): count,
  order, parts and buffer sizes of rank 0's 3 light and 3 heavy steps,
  equal from step to step, rank 1's first light and heavy step equal to
  them, and what the chunk state keeps of them (one list per kind; two
  raise).
The multi-step sharded chunk against marf_tpu's runs in
tests/test_torch_parallel.py's 2-rank spawn.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import math
import types

import pytest
import torch

from marf_tpu_torch.engine.step import TrainChunk, _Segments, chunk_mode, make_optimizer, make_train_chunk, make_train_step
from marf_tpu_torch.parallel.mesh import Collectives, Mesh
from test_torch_models import port_graph, to_torch
from test_torch_parallel import IMPLICIT, OPTIM, UNCROPPED, case_inputs

CPU = torch.device("cpu")
CARD = torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as a spawned CPU rank runs (parallel/launch.py):
    the suite's workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def stand_in(device, backend):
    return types.SimpleNamespace(device=device, mesh=None if backend is None else Mesh(0, 2, device, backend))


@pytest.mark.parametrize("device,backend,capture,want", [
    (CPU, "gloo", None, (False, "gloo")),
    (CPU, "gloo", False, (False, "gloo")),
    (CPU, None, None, (False, "cpu")),
    (CARD, "gloo", None, (True, "2 ranks, gloo")),
    (CARD, "nccl", None, (True, "2 ranks, nccl")),
    (CARD, "gloo", True, (True, "2 ranks, gloo")),
    (CARD, "gloo", False, (False, "capture=False")),
    (CARD, None, None, (True, "CUDA graphs of a light and a heavy step, replayed")),
    (CARD, None, False, (False, "capture=False")),
    (CPU, "gloo", True, "capture=True"),
    (CPU, None, True, "capture=True"),
], ids=["cpu_mesh", "cpu_mesh_off", "cpu", "card_gloo", "card_nccl", "card_gloo_on", "card_gloo_off", "card",
        "card_off", "cpu_mesh_on_raises", "cpu_on_raises"])
def test_chunk_mode_table(device, backend, capture, want):
    """Captured in segments on a card under any backend, eager on the CPU
    and with capture=False; capture=True on the CPU raises."""
    step = stand_in(device, backend)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            chunk_mode(step, capture)
    else:
        assert chunk_mode(step, capture) == want


def test_chunk_mode_names_the_segments_once_captured():
    step = stand_in(CARD, "gloo")
    step.chunk_state = types.SimpleNamespace(segments=None)
    chunk = TrainChunk(step, 4, True, "2 ranks, gloo")
    assert chunk.mode == "captured (2 ranks, gloo)"
    step.chunk_state.segments = {False: types.SimpleNamespace(graphs=[0, 1]), True: types.SimpleNamespace(graphs=[0, 1, 2])}
    assert chunk.mode == "captured (2 ranks, gloo: 2 segments light, 3 heavy)"
    step.chunk_state.segments = {h: types.SimpleNamespace(graphs=[0]) for h in (False, True)}
    assert chunk.mode == "captured (2 ranks, gloo: 1 segment light, 1 heavy)"
    assert TrainChunk(step, 4, False, "capture=False").mode == "eager (capture=False)"


def test_psum_under_capture_cuts_in_place_of_the_collective(monkeypatch):
    """During a capture `psum` issues no all_reduce: the packed buffer goes
    to the cut and the sums are views of it, so what the replay's all_reduce
    writes into the buffer is what the next graph reads. Without a capture
    it all-reduces as before. `issued` lists each sum's parts."""
    calls = []
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t: calls.append(t.clone()))
    cut = types.SimpleNamespace(buffers=[])
    cut.cut = cut.buffers.append
    coll = Collectives()
    coll.capture = cut
    a, b = torch.arange(3.0), torch.ones(2, 2)
    out = coll.psum({"a": [a], "b": [b], "c": []})
    assert calls == [] and len(cut.buffers) == 1
    flat = cut.buffers[0]
    assert torch.equal(flat, torch.cat([a, b.reshape(-1)]))
    flat.mul_(2.0)  # as an all_reduce over two ranks holding the same values
    assert torch.equal(out["a"][0], 2 * a) and torch.equal(out["b"][0], 2 * b) and out["c"] == []
    coll.capture = None
    coll.psum({"a": [a]})
    assert len(calls) == 1 and len(cut.buffers) == 1
    assert coll.issued == [(("a", ((3,),)), ("b", ((2, 2),)), ("c", ())), (("a", ((3,),)),)]


def test_segments_replay_runs_the_collectives_between_the_graphs(monkeypatch):
    """Each step replays graph 0, all_reduce(buffer 0), graph 1, ...; each
    segment's launches are added once per replay."""
    from marf_tpu_torch.ops.cuda import LAUNCHES

    order = []
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t: order.append(f"sum {int(t[0])}"))
    monkeypatch.setitem(LAUNCHES, "fused_train_kernel_warp", 0)
    monkeypatch.setitem(LAUNCHES, "fused_mask_backward_g", 0)
    seg = _Segments(pool=None)
    seg.graphs = [types.SimpleNamespace(replay=lambda i=i: order.append(f"graph {i}")) for i in range(3)]
    seg.buffers = [torch.zeros(4), torch.ones(2)]
    seg.launches = [{"fused_train_kernel_warp": 1}, {}, {"fused_mask_backward_g": 1}]
    seg.replay(2)
    assert order == ["graph 0", "sum 0", "graph 1", "sum 1", "graph 2"] * 2
    assert LAUNCHES["fused_train_kernel_warp"] == 2 and LAUNCHES["fused_mask_backward_g"] == 2


# light and heavy steps as on a card; half tests/test_torch_parallel.py's
# patch sides (the collectives do not depend on the size)
SMALL = dict(lazy_metrics="on", H=24, W=32, patch_H=12, patch_W=16)
RGB = ("rgb",)
K5_LIGHT = ("msum", "loss", "warp", "mlp", "mask")
# (id, config, each collective's nonempty parts in a light step, and in a
# heavy step); the fixed-mask normalizer's sum runs once at setup, outside
PATHS = [
    ("K1", dict(fused_step="on", fused_warp="on"), [("geo", "loss", "mlp")], [("geo", "loss", "mlp", *RGB)]),
    ("K2", dict(fused_step="on", fused_warp="off"), [("geo", "loss", "mlp")], [("geo", "loss", "mlp", *RGB)]),
    ("dedup", dict(IMPLICIT, fused_dedup="on"),
     [("m",), ("geo", "loss", "mlp", "mask", *RGB), ("sq", "edge", "esq"), ("g",)],
     [("m",), ("geo", "loss", "mlp", "mask", "mask_error", *RGB), ("sq", "edge", "esq"), ("g",)]),
    ("dedup_off", dict(IMPLICIT, fused_dedup="off"),
     [(*K5_LIGHT, *RGB), ("e",), (0,)], [(*K5_LIGHT, "mask_error", *RGB), ("e",), (0,)]),
    ("heads_B4", dict(IMPLICIT, build_single_masks=True, batch_size=4),
     [(*K5_LIGHT, *RGB), ("e",), tuple(range(4))], [(*K5_LIGHT, "mask_error", *RGB), ("e",), tuple(range(4))]),
    ("heads_B5", dict(IMPLICIT, build_single_masks=True, batch_size=5),
     [(*K5_LIGHT, *RGB), ("e",), tuple(range(5))], [(*K5_LIGHT, "mask_error", *RGB), ("e",), tuple(range(5))]),
    ("autograd", dict(fused_step="off"), [("maps",), ("g",)], [("maps",), ("g",)]),
    ("replicated", dict(fused_step="on", fused_warp="on", **UNCROPPED, W=31), [], []),  # N odd
]


def rank_step(kw, rank):
    _, tcfg, jp, data = case_inputs(dict(SMALL, **kw), False)
    graph = port_graph(tcfg, jp)
    opt, sched = make_optimizer(graph, OPTIM, tcfg.max_iter)
    return make_train_step(tcfg, graph, opt, to_torch(data), sched, mesh=Mesh(rank, 2, CPU, "gloo")), tcfg


@pytest.mark.parametrize("pid,kw,light,heavy", PATHS, ids=[p[0] for p in PATHS])
def test_collectives_per_step_repeat(monkeypatch, pid, kw, light, heavy):
    """Each path's light and heavy steps issue the collectives of PERF.md
    section 3 (fixed masks 1, dedup 4, K5 -> K6 3, partitioned autograd 2,
    replicated none), in the same order with the same buffers from step to
    step and on both ranks (a captured step replays one list, and a sum
    pairs the ranks' buffers); the heavy step adds the gathered rgb (fixed
    masks) or Mask_Error's part. The all_reduce each issues is the packed
    buffer of its parts. A chunk's state keeps one list per kind."""
    sizes = []
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t: sizes.append(t.numel()))
    lists = []
    for rank in (0, 1):
        step, tcfg = rank_step(kw, rank)
        h, w = tcfg.map_hw
        N = tcfg.batch_size * h * w
        coll = step.collectives
        assert (coll is None) == (pid == "replicated")
        per_kind = {False: [], True: []}
        for heavy_step in (False, True) * (3 if rank == 0 else 1):
            sizes.clear()
            if coll is not None:
                coll.issued.clear()
            step(heavy=heavy_step)
            issued = [] if coll is None else list(coll.issued)
            assert sizes == [sum(math.prod(s) for _, shapes in c for s in shapes) for c in issued]
            per_kind[heavy_step].append(issued)
        for heavy_step, want in ((False, light), (True, heavy)):
            first, *rest = per_kind[heavy_step]
            assert all(x == first for x in rest), f"{'heavy' if heavy_step else 'light'} steps differ"
            assert [tuple(name for name, shapes in c if shapes) for c in first] == want
            parts = {name: shapes for c in first for name, shapes in c}
            if "rgb" in parts and parts["rgb"]:
                assert parts["rgb"] == ((3, N),)
            if "maps" in parts:
                assert parts["maps"] == ((3, N),)
        lists.append(per_kind)
        if coll is not None and rank == 0:
            chunk = make_train_chunk(step, 3)
            chunk()
            assert step.chunk_state.issued == {False: {tuple(per_kind[False][0])}, True: {tuple(per_kind[True][0])}}
            step.chunk_state.check_issued()
            step.chunk_state.issued[False].add(())
            with pytest.raises(RuntimeError, match="the light steps issued 2 different lists"):
                step.chunk_state.check_issued()
    assert all(lists[1][h] == lists[0][h][:1] for h in (False, True)), "the ranks issue different collectives"
