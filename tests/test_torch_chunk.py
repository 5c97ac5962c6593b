"""The port's compiled chunk on the CPU (engine/step.py `make_train_chunk`,
`LrSchedule`; engine/trainer.py's one-deep loop; engine/checkpoint.py).

- The eager chunk with the step counter on the device against marf_tpu's
  `make_train_chunk` (donate=False) over 6 steps, run as two chunks of 3 so
  that the counter carries from one chunk to the next: the fused and
  autograd paths, masks on and off, and the fused implicit dedup path. The
  tolerances are test_trajectory_matches_jax's
  (tests/test_torch_train_step.py): per-step losses rtol 1e-3, each
  parameter's update within 2e-2 of marf_tpu's in L2 norm.
- The schedule's rate tables against torch's LambdaLR, step by step over
  max_iter steps (float64 on the CPU: equal).
- `Model.train` (one chunk deep) against the loop without the pipeline,
  written out here: TB scalars, history, vis frames and checkpoints equal.
- A non-finite loss at a known step raises one chunk late and names it.
- Checkpoints: one written before the schedule moved to the device (a
  LambdaLR state and float rates; the fixture ckpt_lambdalr_step3.pt, step
  3 of `RESUME_CASES["canonical_fused_sched"]` of
  tests/test_torch_lifecycle.py) resumes bitwise to the run that never
  stopped, and a state written with a card's optimizer flags (capturable,
  fused, tensor rates) loads on the CPU under the live optimizer's.
- On a card (`cuda`, skipped here): the captured chunk bitwise the eager
  one, and the launch counts through the replays.

Bitwise comparisons run under `torch.use_deterministic_algorithms(True)`
(on the CPU the K1 plain version's gather backward accumulates in
parallel). Sizes: the small configs of tests/test_torch_models.py against
marf_tpu; the trainer tests at H=96, W=128, 48x64 patches.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from marf_tpu_torch.engine import step as tstep
from marf_tpu_torch.engine.step import (
    LrSchedule,
    _lr_lambda,
    chunk_schedule,
    make_optimizer,
    make_train_chunk,
    make_train_step,
    run_chunk,
)
from marf_tpu_torch.utils.attrdict import AttrDict
from marf_tpu_torch.utils.params import params_to_jax
from test_torch_models import cfg_pair, fake_data, jax_params, port_graph, to_torch
from test_torch_trainer import make_opt

# the helpers of test_torch_implicit.py and test_torch_lifecycle.py are
# imported where they are used: they import marf_tpu.engine (flax, optax),
# which the card's machine lacks, and the card tests below must collect there
OPTIM = {"lr": 1e-3, "lr_warp": 1e-3, "lr_mask": 1e-3, "algo": "Adam"}  # test_torch_implicit.py's
HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "ckpt_lambdalr_step3.pt")
SIZE = dict(H=96, W=128, patch_H=48, patch_W=64)


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


# ------------------------------------------------------ the chunk vs marf_tpu


CHUNK_PATHS = {
    "fused_masks": (dict(fused_step="on", fused_warp="on"), True, False),
    "fused_no_masks": (dict(fused_step="on", fused_warp="on", use_masks=False), False, False),
    "autograd_masks": (dict(fused_step="off"), True, False),
    "implicit_dedup": (dict(fused_step="on", fused_warp="on", use_implicit_mask=True, use_masks=False, N_vocab=8),
                       False, True),
}


@pytest.mark.parametrize("path", list(CHUNK_PATHS))
def test_chunk_matches_jax_chunk(rng, path):
    """6 steps: marf_tpu's one chunk against the port's two eager chunks of
    3, the counter carried on the device (module docstring)."""
    from test_torch_implicit import icfg, implicit_data, jax_trajectory

    kw, masks, implicit = CHUNK_PATHS[path]
    jcfg, tcfg = (icfg if implicit else cfg_pair)(alpha_initial=0.3, **kw)
    jp = jax_params(jcfg)
    data = implicit_data(jcfg, rng) if implicit else fake_data(jcfg, rng)
    if not masks:
        data.update(masks=None, masks_eroded=None)
    jstate, jm = jax_trajectory(jcfg, jp, data, 6, dedup=implicit)
    g = port_graph(tcfg, jp)
    opt, _ = make_optimizer(g, OPTIM, tcfg.max_iter)
    step = make_train_step(tcfg, g, opt, to_torch(data))
    chunk = make_train_chunk(step, 3, capture=None)
    assert chunk.mode == "eager (cpu)" and not chunk.capture
    halves = [chunk().result(), chunk().result()]
    assert int(step.counter) == 6
    tm = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}
    assert tm["finite"].all()
    keys = ["all", "loss_rgb", "loss_render", "PSNR"] + (["loss_mask"] if implicit else ["loss_edge", "Homography_Error"])
    for k in keys:
        np.testing.assert_allclose(tm[k], np.asarray(jm[k]), rtol=1e-3, atol=1e-7, err_msg=k)
    ours = params_to_jax(g.state_dict())
    for key in ["warp", "neural_image"] + (["implicit_mask"] if implicit else []):
        for a, b, c in zip(jax.tree.leaves(ours[key]), jax.tree.leaves(jstate.params[key]), jax.tree.leaves(jp[key])):
            d_ref = np.asarray(b) - np.asarray(c)
            assert np.linalg.norm((np.asarray(a) - c) - d_ref) <= 2e-2 * np.linalg.norm(d_ref), key


def test_chunk_modes_and_rows():
    """Eager everywhere on the CPU, capture=True refused there; a chunk's rows
    are its steps' metrics (the oracle's `run_chunk` equal)."""
    jcfg, tcfg = cfg_pair(fused_step="on", fused_warp="on")
    data = to_torch(fake_data(jcfg, np.random.RandomState(3)))
    runs = []
    for _ in range(2):
        g = port_graph(tcfg, jax_params(jcfg))
        opt, _ = make_optimizer(g, OPTIM, tcfg.max_iter)
        runs.append((make_train_step(tcfg, g, opt, data), g))
    with pytest.raises(ValueError, match="capture=True"):
        make_train_chunk(runs[0][0], 2, capture=True)
    with pytest.raises(ValueError, match="a chunk of 0 steps"):
        make_train_chunk(runs[0][0], 0)
    a = [make_train_chunk(runs[0][0], 2)().result() for _ in range(2)]
    b = [run_chunk(runs[1][0], 0, 2), run_chunk(runs[1][0], 2, 2)]
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert torch.equal(runs[0][1].warp, runs[1][1].warp)
    assert np.all(a[0]["Homography_Error"] > 0)


# ------------------------------------------------------------ the schedule


@pytest.mark.parametrize("sched", [{"type": "StepLR", "steps": 3, "gamma": 0.5},
                                   {"type": "ExponentialLR", "gamma": None}], ids=["StepLR", "ExponentialLR"])
def test_lr_tables_match_lambdalr(sched):
    """Every group's rate over max_iter steps equals LambdaLR's, factor and
    rate (float64 on the CPU), and the state dict carries the position."""
    from test_torch_implicit import icfg

    max_iter = 12
    optim = {"lr": 1e-3, "lr_warp": 2e-3, "lr_mask": 5e-4, "lr_end": 1e-5, "algo": "Adam", "sched": sched,
             "apply_sched": True}
    _, tcfg = icfg(max_iter=max_iter)
    g = port_graph(tcfg, jax_params(icfg(max_iter=max_iter)[0]))
    opt, s = make_optimizer(g, optim, max_iter)
    assert isinstance(s, LrSchedule) and s.table.dtype == torch.float64 and s.table.shape == (3, max_iter + 1)
    base = [1e-3, 2e-3, 5e-4]
    ref_groups = [{"params": [torch.zeros(1, requires_grad=True)], "lr": b} for b in base]
    ref_opt = torch.optim.Adam(ref_groups)
    ref = torch.optim.lr_scheduler.LambdaLR(ref_opt, [_lr_lambda(optim, b, max_iter) for b in base])
    for i in range(max_iter + 1):
        assert [float(grp["lr"]) for grp in opt.param_groups] == [grp["lr"] for grp in ref_opt.param_groups], i
        assert s.state_dict() == {"last_epoch": i, "base_lrs": base}
        if i < max_iter:
            s.step()
            ref_opt.step()  # no gradients: only the order LambdaLR expects
            ref.step()
    factor = ref_opt.param_groups[0]["lr"] / base[0]
    assert factor == pytest.approx(0.5**4 if sched["type"] == "StepLR" else 1e-5 / 1e-3, rel=1e-12)
    s.step()  # past max_iter: the last rates
    assert int(s.position) == max_iter and float(opt.param_groups[0]["lr"]) == ref_opt.param_groups[0]["lr"]
    s.load_state_dict(ref.state_dict())  # a LambdaLR state loads
    assert int(s.position) == max_iter


# ------------------------------------------------------------- the trainer


def _model(opt):
    from marf_tpu_torch.engine.trainer import Model

    m = Model(opt)
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    m.setup_visualizer()
    return m


def _unpipelined_train(m):
    """`Model.train`'s loop without the pipeline: each chunk's metrics read
    before the next chunk runs."""
    freq = m.opt.freq
    step = m.make_step()
    max_iter = int(m.cfg.max_iter)
    c = chunk_schedule(max_iter, freq.scalar, freq.vis, freq.get("ckpt"))
    m.visualize(step=0)
    while m.it < max_iter:
        n = min(c, max_iter - m.it)
        md = run_chunk(step, m.it, n)
        m.it += n
        m.history.append(md)
        assert md["finite"].all()
        if m.it % freq.scalar == 0:
            m.log_scalars({k: float(v[-1]) for k, v in md.items() if k != "finite"}, step=m.it)
        if m.it % freq.vis == 0:
            m.visualize(step=m.it)
        if freq.get("ckpt") and m.it % freq.ckpt == 0:
            m.save_checkpoint()
    if m._saved_at != m.it:
        m.save_checkpoint()
    m.tb.flush()
    m.tb.close()


def _trainer_opt(root, **kw):
    base = dict(SIZE, cpu=True, max_iter=8, save_checkpoint=True, tb=AttrDict(num_images=[4, 8]),
                freq=AttrDict(scalar=2, vis=4, ckpt=4), tpu=AttrDict(fused_step="on"))
    return make_opt(root, **dict(base, **kw))


def test_pipelined_train_matches_unpipelined(tmp_path, deterministic):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from test_torch_lifecycle import _assert_equal_tree, _state

    piped = _model(_trainer_opt(tmp_path / "piped"))
    piped.train()
    plain = _model(_trainer_opt(tmp_path / "plain"))
    _unpipelined_train(plain)
    assert piped.it == plain.it == 8 and len(piped.history) == len(plain.history) == 4
    for a, b in zip(piped.history, plain.history):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    runs = [m.opt.output_path for m in (piped, plain)]
    scalars = []
    for run in runs:
        ea = EventAccumulator(run, size_guidance={"scalars": 0})
        ea.Reload()
        scalars.append({t: [(e.step, e.value) for e in ea.Scalars(t)] for t in ea.Tags()["scalars"]})
    assert scalars[0] == scalars[1] and [s for s, _ in scalars[0]["train/PSNR"]] == [2, 4, 6, 8]
    frames = [sorted(os.listdir(os.path.join(run, "vis"))) for run in runs]
    assert frames[0] == frames[1] == ["0.png", "1.png", "2.png"]
    for f in frames[0]:
        with open(os.path.join(runs[0], "vis", f), "rb") as x, open(os.path.join(runs[1], "vis", f), "rb") as y:
            assert x.read() == y.read(), f
    ckpts = [sorted(os.listdir(os.path.join(run, "ckpt")), key=int) for run in runs]
    assert ckpts[0] == ckpts[1] == ["4", "8"]
    for s in ckpts[0]:
        _assert_equal_tree(*(_state(os.path.join(run, "ckpt", s)) for run in runs), where=f"ckpt/{s}")


def test_non_finite_loss_names_its_step(tmp_path, monkeypatch):
    """A non-finite loss at iteration 5 raises when its chunk is read, one
    chunk late (steps 7-8 are dispatched), naming iteration 5."""
    real, calls = tstep.check_finite, []

    def flaky(loss):
        calls.append(None)
        ok = real(loss)
        return ok & (len(calls) != 5)

    monkeypatch.setattr(tstep, "check_finite", flaky)
    m = _model(_trainer_opt(tmp_path, freq=AttrDict(scalar=2, vis=8, ckpt=None), save_checkpoint=False))
    with pytest.raises(FloatingPointError, match="non-finite loss at iteration 5$"):
        m.train()
    assert m.it == 8 and len(m.history) == 3 and len(calls) == 8


# ------------------------------------------------------------- checkpoints

# torch's CPU pool when the fixture was written: its state is bitwise the
# straight run's only at that size, as the CPU sums split by thread
FIXTURE_THREADS = 8


@pytest.fixture
def fixture_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(FIXTURE_THREADS)
    yield
    torch.set_num_threads(before)


def test_checkpoint_from_before_the_device_schedule_resumes_bitwise(tmp_path, deterministic, fixture_threads):
    """The fixture (LambdaLR state, float rates) resumed at step 3 runs steps
    4-6 bitwise as the run that never stopped; the new checkpoints keep the
    fixture's format (float rates, the optimizer's keys, last_epoch)."""
    from test_torch_lifecycle import RESUME_CASES, _assert_equal_tree, _state, _train

    kw = dict(RESUME_CASES["canonical_fused_sched"], cpu=True, max_iter=6, freq=AttrDict(scalar=3, vis=3, ckpt=3))
    straight = _train(make_opt(tmp_path / "straight", **kw))
    resumed_opt = make_opt(tmp_path / "resumed", resume=True, **kw)
    os.makedirs(os.path.join(resumed_opt.output_path, "ckpt", "3"))
    shutil.copy(FIXTURE, os.path.join(resumed_opt.output_path, "ckpt", "3", "state.pt"))
    resumed = _train(resumed_opt)
    assert resumed.it == 6 and float(resumed.optimizer.param_groups[0]["lr"]) == 1e-3 * 0.5**3
    a, b = (_state(os.path.join(m.opt.output_path, "ckpt", "6")) for m in (straight, resumed))
    _assert_equal_tree(a, b)
    for k, v in resumed.history[0].items():
        np.testing.assert_array_equal(v, straight.history[1][k], err_msg=k)
    old = torch.load(FIXTURE, weights_only=True)
    new = _state(os.path.join(straight.opt.output_path, "ckpt", "3"))
    assert new["scheduler"] == {"last_epoch": 3, "base_lrs": old["scheduler"]["base_lrs"]}
    assert old["scheduler"]["last_epoch"] == 3
    for og, ng in zip(old["optimizer"]["param_groups"], new["optimizer"]["param_groups"]):
        assert set(ng) == set(og) and type(ng["lr"]) is float and ng["lr"] == og["lr"]
    _assert_equal_tree(old["graph"], new["graph"])
    _assert_equal_tree(old["optimizer"]["state"], new["optimizer"]["state"])


def test_checkpoint_with_card_flags_loads_on_the_cpu(tmp_path, deterministic):
    """A state whose optimizer groups carry a card's build flags (capturable,
    fused) and tensor rates, and whose Adam step counts are tensors, loads
    on the CPU: the live optimizer keeps its own flags and continues as from
    the plain state."""
    from test_torch_lifecycle import RESUME_CASES, _assert_equal_tree, _state, _train

    kw = dict(RESUME_CASES["canonical_fused_sched"], cpu=True, max_iter=6, freq=AttrDict(scalar=3, vis=3, ckpt=3))
    straight = _train(make_opt(tmp_path / "straight", **kw))
    state = _state(os.path.join(straight.opt.output_path, "ckpt", "3"))
    for grp in state["optimizer"]["param_groups"]:
        grp.update(capturable=True, fused=None, foreach=True, lr=torch.tensor(grp["lr"], dtype=torch.float32))
    resumed_opt = make_opt(tmp_path / "resumed", resume=True, **kw)
    os.makedirs(os.path.join(resumed_opt.output_path, "ckpt", "3"))
    torch.save(state, os.path.join(resumed_opt.output_path, "ckpt", "3", "state.pt"))
    resumed = _train(resumed_opt)
    assert all(grp["capturable"] is False and grp["foreach"] is None for grp in resumed.optimizer.param_groups)
    assert isinstance(resumed.scheduler, LrSchedule) and resumed.optimizer.param_groups[0]["lr"].dtype == torch.float64
    _assert_equal_tree(*(_state(os.path.join(m.opt.output_path, "ckpt", "6")) for m in (straight, resumed)))


# ----------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the card: python -m pytest tests/test_torch_chunk.py -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_step(device, **kw):
    jcfg, tcfg = cfg_pair(alpha_initial=0.3, **kw)
    g = port_graph(tcfg, jax_params(jcfg)).to(device)
    data = {k: None if v is None else v.to(device) for k, v in to_torch(fake_data(jcfg, np.random.RandomState(4))).items()}
    opt, sched = make_optimizer(g, dict(OPTIM, sched={"type": "StepLR", "steps": 2, "gamma": 0.5}, apply_sched=True),
                                tcfg.max_iter)
    return make_train_step(tcfg, g, opt, data, sched), g, opt


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(fused_step="on", fused_warp="on"), dict(fused_step="off")], ids=["fused", "autograd"])
def test_captured_chunk_is_bitwise_eager(cuda_device, kw):
    """Three chunks of 4 steps, the first the captured run's warm-up and
    capture: metrics, parameters and optimizer state bitwise equal."""
    out = {}
    for capture in (True, False):
        step, g, opt = _card_step(cuda_device, **kw)
        chunk = make_train_chunk(step, 4, capture)
        assert chunk.mode.startswith("captured" if capture else "eager")
        rows = [chunk().result() for _ in range(3)]
        out[capture] = (rows, [t.clone() for t in step.bound_tensors()[1:]])
    for a, b in zip(out[True][0], out[False][0]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_launches_count_through_replays(cuda_device):
    """K1 once per step through the replays; the capture counts nothing; a
    rebound optimizer state is refused."""
    from marf_tpu_torch.ops.cuda import LAUNCHES

    step, g, opt = _card_step(cuda_device, fused_step="on", fused_warp="on")
    chunk = make_train_chunk(step, 5)
    before = LAUNCHES["fused_train_kernel_warp"]
    chunk()  # 5 eager steps, then the capture
    assert LAUNCHES["fused_train_kernel_warp"] == before + 5
    chunk().result()
    make_train_chunk(step, 3)().result()  # a tail chunk replays the same graphs
    assert LAUNCHES["fused_train_kernel_warp"] == before + 13 and int(step.counter) == 13
    with pytest.raises(ValueError, match="at most 5 rows"):
        make_train_chunk(step, 6)
    opt.load_state_dict(opt.state_dict())
    with pytest.raises(RuntimeError, match="rebound"):
        chunk()
