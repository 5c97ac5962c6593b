"""The port's training lifecycle against marf_tpu on the CPU: the optimizers,
checkpoint save and resume, `load_torch_init`, the vis helpers, the
full-canvas render, the frames and image panels of a short run, the CLI on
an on-disk fixture, and the sweep runner.

Sizes are the port's tiny ones (`TINY` in tests/test_torch_trainer.py:
32x64 canvas, 16x32 patches, 3 images, layers [null, 64, 64, 3], L = 4).
Tolerances: the optimizers' parameters after 5 steps within 2e-5 of their
move (+1e-7) from optax's (float32 rounding of the same update rule, which
Adam's normalization amplifies where gradients are near 1e-6; decaying
after the update, or torch's RMSprop eps placement, fails it); the
render within 1e-5 (float32 summation order); first-step losses from one
torch init within rtol 1e-5. A resumed run equals the unbroken run
bitwise: both run with `torch.use_deterministic_algorithms(True)`, since
on the CPU the backward of an index gather (the per-point H in the K1 plain
version) accumulates in parallel and so differs run to run in the last bits.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch

from marf_tpu.engine import checkpoint as jckpt
from marf_tpu.engine import step as jstep
from marf_tpu.models import planar as jplanar
from marf_tpu.utils import vis as jvis
from marf_tpu_torch.data.planar import save_planar_dataset, synthesize_planar_dataset
from marf_tpu_torch.engine import checkpoint as tckpt
from marf_tpu_torch.engine.step import OptaxRMSprop, make_optimizer
from marf_tpu_torch.models import planar as tplanar
from marf_tpu_torch.utils import vis as tvis
from marf_tpu_torch.utils.attrdict import AttrDict
from marf_tpu_torch.utils.params import params_from_jax
from test_torch_init import _dump_ref_style_npz
from test_torch_models import cfg_pair, jax_params
from test_torch_trainer import TINY, make_opt

SCHED = {"type": "StepLR", "steps": 2, "gamma": 0.5}


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


# ------------------------------------------------------------------ optimizers


def _grad_tree(params, rng):
    """Gradients spanning 1e-6 to 1 in size, where RMSprop's eps placement
    matters (the port's gradients reach down to 1e-6)."""
    return jax.tree.map(lambda p: (rng.randn(*np.shape(p)) * 10.0 ** rng.uniform(-6, 0, np.shape(p))).astype(np.float32),
                        params)


@pytest.mark.parametrize("algo", ["AdamW", "SGD", "RMSprop"])
def test_optimizer_matches_optax(algo):
    """Five steps against marf_tpu's optax chain (engine/step.py _algo), two
    groups at their own learning rates under a StepLR that the LR
    scheduler applies: AdamW's decoupled decay, SGD, and RMSprop with eps
    inside the root."""
    jcfg, tcfg = cfg_pair()
    init = jax_params(jcfg)
    optim = {"lr": 0.1, "lr_warp": 0.2, "lr_mask": 0.1, "algo": algo, "sched": SCHED, "apply_sched": True}
    tx = jstep.make_optimizer(optim, 100)
    params = jax.tree.map(np.asarray, init)
    state = tx.init(params)
    g = tplanar.Graph(tcfg)
    g.load_state_dict(params_from_jax(init))
    opt, sched = make_optimizer(g, optim, 100)
    assert type(opt) is {"AdamW": torch.optim.AdamW, "SGD": torch.optim.SGD, "RMSprop": OptaxRMSprop}[algo]
    named = dict(g.named_parameters())
    rng = np.random.RandomState(0)
    grads = []
    for _ in range(5):
        grad = _grad_tree(params, rng)
        grads.append(grad)
        upd, state = tx.update(grad, state, params)
        params = optax.apply_updates(params, upd)
        for k, v in params_from_jax(grad).items():
            named[k].grad = v
        opt.step()
        sched.step()
    start = params_from_jax(init)
    ref = params_from_jax(jax.tree.map(np.asarray, params))
    assert max((v - start[k]).abs().max().item() for k, v in ref.items()) > 0.1
    for k, v in ref.items():
        moved = (v - start[k]).abs().max().item()
        assert (named[k].detach() - v).abs().max().item() <= 2e-5 * moved + 1e-7, k
    if algo == "RMSprop":  # torch's own RMSprop (eps outside the root) lands elsewhere
        g2 = tplanar.Graph(tcfg)
        g2.load_state_dict(params_from_jax(init))
        opt2 = torch.optim.RMSprop(g2.parameters(), lr=0.1, alpha=0.99, eps=1e-8)
        named2 = dict(g2.named_parameters())
        for k, v in params_from_jax(grads[0]).items():
            named2[k].grad = v
        opt2.step()
        first = optax.apply_updates(jax.tree.map(np.asarray, init), tx.update(grads[0], tx.init(init), init)[0])
        w0 = params_from_jax(jax.tree.map(np.asarray, first))["neural_image.layers.0.weight"]
        assert not np.allclose(g2.neural_image.layers[0].weight.detach().numpy(), w0.numpy(), rtol=1e-2, atol=1e-3)


# ---------------------------------------------------------------- checkpoints


RESUME_CASES = {
    "canonical_autograd": dict(tpu=AttrDict(fused_step="off")),
    "canonical_fused": dict(tpu=AttrDict(fused_step="on", fused_warp="on")),
    "implicit_heads_fused": dict(tpu=AttrDict(fused_step="on"), use_implicit_mask=True, use_masks=False,
                                 build_single_masks=True, N_vocab=8),
    "canonical_fused_sched": dict(tpu=AttrDict(fused_step="on", fused_warp="on"),
                                  optim=AttrDict(lr=1e-3, lr_warp=1e-3, lr_mask=1e-3, algo="Adam", sched=SCHED,
                                                 apply_sched=True)),
}


def _train(opt):
    from marf_tpu_torch.engine.trainer import Model

    m = Model(opt)
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    m.setup_visualizer()
    m.train()
    return m


def _state(path):
    return torch.load(os.path.join(path, "state.pt"), weights_only=True)


def _assert_equal_tree(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_tree(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_is_bitwise(tmp_path, case, deterministic):
    """3 steps, then a resume for 3 more, equal bitwise to 6 steps without a
    stop: parameters, optimizer state, LR scheduler state and losses."""
    kw = dict(RESUME_CASES[case], cpu=True, max_iter=6, freq=AttrDict(scalar=3, vis=3, ckpt=3))
    straight = _train(make_opt(tmp_path / "straight", **kw))
    assert sorted(os.listdir(os.path.join(straight.opt.output_path, "ckpt"))) == ["3", "6"]
    resumed_opt = make_opt(tmp_path / "resumed", resume=True, **kw)
    os.makedirs(os.path.join(resumed_opt.output_path, "ckpt"))
    shutil.copytree(os.path.join(straight.opt.output_path, "ckpt", "3"), os.path.join(resumed_opt.output_path, "ckpt", "3"))
    resumed = _train(resumed_opt)
    assert resumed.it == 6 and len(resumed.history) == 1
    a, b = (_state(os.path.join(m.opt.output_path, "ckpt", "6")) for m in (straight, resumed))
    assert a["step"] == b["step"] == 6
    _assert_equal_tree(a, b)
    if "sched" in case:
        assert a["scheduler"]["last_epoch"] == 6 and a["optimizer"]["param_groups"][0]["lr"] == 1e-3 * 0.5**3
    for k, v in resumed.history[0].items():
        np.testing.assert_array_equal(v, straight.history[1][k], err_msg=k)


def test_restore_paths_match_jax(tmp_path):
    run = tmp_path / "run"
    for s in ("2", "10", "7", "tmp"):
        (run / "ckpt" / s).mkdir(parents=True)
    (tmp_path / "empty" / "ckpt").mkdir(parents=True)
    cases = [(str(run), None, True), (str(run), None, 7), (str(run), None, False), (str(tmp_path / "none"), None, True),
             (str(tmp_path / "empty"), None, True), (str(tmp_path / "x"), str(run), False),
             (str(tmp_path / "x"), str(run / "ckpt" / "2"), True), (str(tmp_path / "x"), str(tmp_path / "empty"), None)]
    for out, load, resume in cases:
        assert tckpt.resolve_restore_path(out, load, resume) == jckpt.resolve_restore_path(out, load, resume)
    for d in (run, tmp_path / "empty", tmp_path / "none"):
        assert tckpt.latest_checkpoint(str(d)) == jckpt.latest_checkpoint(str(d))
    assert tckpt.latest_checkpoint(str(run)).endswith(os.path.join("ckpt", "10"))


def test_save_checkpoint_false_writes_nothing(tmp_path):
    m = _train(make_opt(tmp_path, cpu=True, max_iter=4, freq=AttrDict(scalar=2, vis=2, ckpt=None),
                        save_checkpoint=False, tpu=AttrDict(fused_step="on")))
    assert m.it == 4 and not os.path.exists(os.path.join(m.opt.output_path, "ckpt"))
    m = _train(make_opt(tmp_path / "end", cpu=True, max_iter=4, freq=AttrDict(scalar=2, vis=2, ckpt=None),
                        save_checkpoint=True, tpu=AttrDict(fused_step="on")))
    assert os.listdir(os.path.join(m.opt.output_path, "ckpt")) == ["4"]


def test_failed_restore_raises(tmp_path):
    """No fallback to step 0: a requested restore that finds nothing, or a
    checkpoint that does not fit the run, raises."""
    from marf_tpu_torch.engine.trainer import Model

    for kw in (dict(resume=True), dict(resume=4), dict(load=str(tmp_path / "absent"))):
        m = Model(make_opt(tmp_path / "a", cpu=True, **kw))
        m.load_dataset()
        m.build_networks()
        with pytest.raises(FileNotFoundError):
            m.setup_optimizer()
    m = _train(make_opt(tmp_path / "b", cpu=True, max_iter=2, freq=AttrDict(scalar=2, vis=2, ckpt=None),
                        save_checkpoint=True))
    sched = AttrDict(lr=1e-3, lr_warp=1e-3, lr_mask=1e-3, algo="Adam", sched=SCHED, apply_sched=True)
    m2 = Model(make_opt(tmp_path / "c", cpu=True, optim=sched, load=m.opt.output_path))
    m2.load_dataset()
    m2.build_networks()
    with pytest.raises(ValueError, match="scheduler"):
        m2.setup_optimizer()
    m3 = Model(make_opt(tmp_path / "d", cpu=True, use_implicit_mask=True, N_vocab=8, load=m.opt.output_path))
    m3.load_dataset()
    m3.build_networks()
    with pytest.raises(RuntimeError, match="state_dict"):
        m3.setup_optimizer()


# ------------------------------------------------------------ load_torch_init


def test_load_torch_init_first_step_matches_jax(tmp_path):
    """A reference-named npz (tests/test_torch_init.py's module tree) loaded
    by both trainers' build_networks: equal parameters, and first-step
    losses (graph_forward + graph_loss at step 0 on each trainer's data)
    within rtol 1e-5."""
    from marf_tpu.ops.losses import summarize_loss as jsum
    from marf_tpu_torch.ops.losses import summarize_loss as tsum

    npz = str(tmp_path / "init.npz")
    sd = _dump_ref_style_npz(npz, [18, 64, 64, 3], batch_size=3)
    sd["warp_param.weight"] = np.random.RandomState(1).randn(3, 8).astype(np.float32) * 0.05
    np.savez(npz, **sd)
    jm = _jax_model(make_opt(tmp_path / "jax", load_torch_init=npz))
    m = Model_from(make_opt(tmp_path / "torch", cpu=True, load_torch_init=npz))
    for i, layer in enumerate(m.graph.neural_image.layers):
        np.testing.assert_array_equal(layer.weight.detach().numpy(), sd[f"neural_image.mlp.{i}.weight"])
        np.testing.assert_array_equal(layer.bias.detach().numpy(), sd[f"neural_image.mlp.{i}.bias"])
    np.testing.assert_array_equal(m.graph.warp.detach().numpy(), sd["warp_param.weight"])
    out = jplanar.graph_forward(jm.params, jm.data, jm.cfg, jax.numpy.float32(0.0))
    ref = float(jsum(jplanar.graph_loss(out, jm.data, jm.cfg, jax.numpy.int32(0)), jm.cfg.loss_weight))
    with torch.no_grad():
        out = tplanar.graph_forward(m.graph, m.data, m.cfg, torch.tensor(0.0))
        ours = float(tsum(tplanar.graph_loss(out, m.data, m.cfg, torch.tensor(0)), m.cfg.loss_weight))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


def Model_from(opt):
    from marf_tpu_torch.engine.trainer import Model

    m = Model(opt)
    m.load_dataset()
    m.build_networks()
    return m


def test_load_torch_init_implicit_and_mismatch(tmp_path, monkeypatch):
    import marf_tpu_torch.models.implicit_mask as im
    from marf_tpu_torch.utils.torch_init import load_torch_init

    monkeypatch.setattr(im, "MASK_MLP_WIDTH", 16)
    _, tcfg = cfg_pair(use_implicit_mask=True, N_vocab=6)
    npz = str(tmp_path / "init.npz")
    sd = _dump_ref_style_npz(npz, [18, 64, 64, 3], batch_size=3, with_mask=True)
    g = load_torch_init(tplanar.Graph(tcfg), npz)
    for i in range(5):
        np.testing.assert_array_equal(g.implicit_mask.layers[i].weight.detach().numpy(),
                                      sd[f"implicit_mask.mask_mapping.{2 * i}.weight"])
    np.testing.assert_array_equal(g.view_embedding.detach().numpy(), sd["embedding_view.weight"])
    _dump_ref_style_npz(npz, [18, 32, 32, 3], batch_size=3)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_torch_init(tplanar.Graph(tcfg), npz)
    _dump_ref_style_npz(npz, [18, 64, 64, 3], batch_size=3, with_mask=True)
    _, single = cfg_pair(use_implicit_mask=True, build_single_masks=True, N_vocab=6)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_torch_init(tplanar.Graph(single), npz)


# ------------------------------------------------------------------------ vis


class RecordingWriter:
    def __init__(self):
        self.images = []

    def add_image(self, tag, image, step):
        self.images.append((tag, np.asarray(image), step))


def test_vis_helpers_equal_jax(rng):
    images = rng.rand(5, 3, 6, 7).astype(np.float32)
    gray = rng.rand(5, 1, 6, 7).astype(np.float32)
    colors = rng.randint(0, 256, (5, 3))
    for nrow, pad in ((2, 2), (8, 1)):
        np.testing.assert_array_equal(tvis.make_grid(images, nrow, pad, 1.0), jvis.make_grid(images, nrow, pad, 1.0))
    for x, rng_ in ((images, (0, 1)), (gray * 3 - 1, (-1, 2))):
        np.testing.assert_array_equal(tvis.preprocess_vis_image(x, rng_), jvis.preprocess_vis_image(x, rng_))
    for width, depth, x in ((3, 3, images), (1, 1, gray)):
        np.testing.assert_array_equal(tvis.color_border(x, colors, width, depth), jvis.color_border(x, colors, width, depth))
    corners = rng.uniform(-3, 9, (5, 4, 2))
    np.testing.assert_array_equal(tvis.draw_corner_boxes(images[0], corners, colors),
                                  jvis.draw_corner_boxes(images[0], corners, colors))
    opt = AttrDict(tb=AttrDict(num_images=[2, 2]))
    ours, ref = RecordingWriter(), RecordingWriter()
    for x in (images, gray, np.concatenate([images, gray], axis=1)):
        tvis.tb_image(opt, ours, 3, "train", "p", x)
        jvis.tb_image(opt, ref, 3, "train", "p", x)
    for (t1, i1, s1), (t2, i2, s2) in zip(ours.images, ref.images, strict=True):
        assert (t1, s1) == (t2, s2)
        np.testing.assert_array_equal(i1, i2)
    assert tvis.BOX_COLORS == jvis.BOX_COLORS


def test_corner_ops_equal_jax():
    from marf_tpu.ops.grid import crop_corners as jcrop
    from marf_tpu.ops.warp import warp_corners as jwarp
    from marf_tpu_torch.ops.grid import crop_corners
    from marf_tpu_torch.ops.warp import warp_corners
    from marf_tpu_torch.utils.console import colorcode_to_number
    from marf_tpu.utils.console import colorcode_to_number as jcolor

    jcfg, tcfg = cfg_pair()
    c = crop_corners(tcfg.grid_spec)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jcrop(jcfg.grid_spec)))
    warp = jax_params(jcfg)["warp"]
    np.testing.assert_allclose(warp_corners(c, torch.from_numpy(warp)).numpy(),
                               np.asarray(jwarp(jcrop(jcfg.grid_spec), warp)), rtol=1e-5, atol=1e-6)
    assert [colorcode_to_number(c) for c in tvis.BOX_COLORS] == [jcolor(c) for c in jvis.BOX_COLORS]


def _jax_model(opt):
    from marf_tpu.engine.trainer import Model as JaxModel

    jm = JaxModel(opt)
    jm.load_dataset()
    jm.build_networks()
    return jm


def test_predict_entire_image_matches_jax(tmp_path):
    jm = _jax_model(make_opt(tmp_path / "jax"))
    init = jax.tree.map(np.asarray, jm.params)
    init["warp"] = jax_params(jplanar.PlanarConfig(batch_size=3))["warp"]
    jm.params = jax.tree.map(jax.numpy.asarray, init)
    jm.setup_optimizer()
    jm.setup_visualizer()
    jm._build_compiled()
    m = Model_from(make_opt(tmp_path / "torch", cpu=True))
    m.graph.load_state_dict(params_from_jax(init))
    for it in (0, 4, 10):
        jm.it = m.it = it
        ours, ref = m.predict_entire_image(), jm.predict_entire_image()
        assert ours.shape == (3, 32, 64)
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("implicit", [False, True])
def test_frames_and_panels_match_jax(tmp_path, implicit):
    """A 4-step run of each package from one init: the same frame files,
    the same TB image tags at the same steps, vis.mp4, and the same first
    frame to within one 8-bit step."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from marf_tpu_torch.engine.trainer import Model

    kw = dict(max_iter=4, freq=AttrDict(scalar=2, vis=2, ckpt=None),
              tb=AttrDict(num_images=[4, 8], show_edges=True, show_corners=True))
    if implicit:
        kw.update(use_implicit_mask=True, N_vocab=8, tpu=AttrDict(fused_step="on"))
    jm = _jax_model(make_opt(tmp_path / "jax", **kw))
    init = jax.tree.map(np.asarray, jm.params)
    jm.setup_optimizer()
    jm.setup_visualizer()
    jm.train()
    m = Model(make_opt(tmp_path / "torch", cpu=True, **kw))
    m.load_dataset()
    m.build_networks()
    m.graph.load_state_dict(params_from_jax(init))
    m.setup_optimizer()
    m.setup_visualizer()
    m.train()
    tags = []
    for out in (jm.opt.output_path, m.opt.output_path):
        assert sorted(os.listdir(os.path.join(out, "vis"))) == ["0.png", "1.png", "2.png"]
        assert os.path.getsize(os.path.join(out, "vis.mp4")) > 0
        ea = EventAccumulator(out, size_guidance={"images": 0})
        ea.Reload()
        tags.append({t: [e.step for e in ea.Images(t)] for t in ea.Tags()["images"]})
    assert tags[1] == tags[0]
    want = {"predicted_image", "input_images", "input_masks", "predicted_edges", "warp_corners"}
    assert {t.split("/")[1] for t in tags[0]} == (want | {"implicit_masks"} if implicit else want)
    assert tags[0]["train/predicted_image"] == [1, 2, 4] and tags[0]["train/input_images"] == [1]
    from PIL import Image

    f0 = [np.asarray(Image.open(os.path.join(out, "vis", "0.png")), np.int16) for out in (jm.opt.output_path,
                                                                                            m.opt.output_path)]
    assert np.abs(f0[0] - f0[1]).max() <= 1


def test_iter_timer(monkeypatch):
    """The EMA per-step time behind the tqdm bar's it_per_sec (marf_tpu's
    IterTimer): a chunk of n steps counts as n steps of its mean time."""
    from marf_tpu_torch.utils import console

    clock = iter([0.0, 2.0, 10.0, 11.0])
    monkeypatch.setattr(console.time, "perf_counter", lambda: next(clock))
    timer = console.IterTimer(momentum=0.5)
    assert timer.steps_per_sec == 0.0
    timer.tic()
    assert timer.toc(4) == 0.5
    timer.tic()
    assert timer.toc(1) == 1.0
    assert timer.it_mean == 0.75 and timer.steps_per_sec == 1 / 0.75


# ------------------------------------------------------------------- CLI, sweep


def test_cli_trains_on_disk_fixture_and_resumes(tmp_path, monkeypatch):
    """`python -m marf_tpu_torch.train` on a fixture under --data.root, no
    --dataset=synthetic: frames, panels, vis.mp4 and checkpoints; --resume
    continues from the latest checkpoint."""
    from marf_tpu_torch.train import main

    monkeypatch.setenv("MARF_YES", "1")
    _, full = cfg_pair(use_cropped_images=False)
    save_planar_dataset(synthesize_planar_dataset(full, seed=3), str(tmp_path / "planar" / "fx"), full.H, full.W)
    args = ["--model=planar", "--yaml=planar", "--cpu", f"--output_root={tmp_path / 'out'}", "--max_iter=6",
            "--freq.scalar=2", "--freq.vis=2", "--freq.ckpt=4", "--tpu.fused_step=on",
            *[a for a in TINY if not a.startswith(("--dataset", "--tb"))], "--dataset=fx", f"--data.root={tmp_path / 'planar'}"]
    m = main([*args, "--save_checkpoint=false"])
    out = m.opt.output_path
    assert m.it == 6 and m.use_homographies
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["4"]
    assert sorted(os.listdir(os.path.join(out, "vis"))) == [f"{i}.png" for i in range(4)]
    assert os.path.isfile(os.path.join(out, "vis.mp4")) and any(f.startswith("events.") for f in os.listdir(out))
    r = main([*args, "--resume"])
    assert r.it == 6 and sum(len(h["all"]) for h in r.history) == 2
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["4", "6"]


def test_sweep_matches_jax_sweep(tmp_path, monkeypatch):
    import sweep as jsweep

    from marf_tpu_torch import sweep

    assert sweep.CASES == jsweep.CASES and sweep.DEFAULT_DATASETS == jsweep.DEFAULT_DATASETS
    monkeypatch.chdir(tmp_path)  # output/ lands in tmp
    m = sweep.run_case("synthetic", 8, seed=3, group="sweeptest", extra=dict(
        cpu=True, H=32, W=64, patch_H=16, patch_W=32, batch_size=3, N_vocab=8, max_iter=4,
        freq={"scalar": 2, "vis": 4, "ckpt": None}, save_checkpoint=False, tpu={"fused_step": "on"}))
    assert m.it == 4 and m.cfg.use_implicit_mask and not m.cfg.use_masks
    assert m.opt.output_path == "output/sweeptest/synthetic_implicit_masks_seed3"
    assert sorted(os.listdir(m.vis_path)) == ["0.png", "1.png"]
