"""The port's slice end to end on the CPU: the synthetic dataset, the
options DSL and the five-phase `Model` against marf_tpu's, the CLI entry,
device resolution, and that the port imports neither jax nor marf_tpu.

Tolerances: the synthetic arrays are equal (same numpy/PIL/cv2 code), the
normalized ground-truth homographies rtol=1e-5 (float32 matmul order); the
trainers' parameter updates within 2e-2 in L2 norm (Adam amplifies float32
rounding in near-zero gradient components, tests/test_torch_train_step.py).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from marf_tpu.data.planar import synthesize_planar_dataset as jsynth
from marf_tpu.utils.attrdict import AttrDict
from marf_tpu.utils.config import load_options
from marf_tpu.utils.config import parse_arguments as jparse
from marf_tpu_torch.data.planar import synthesize_planar_dataset
from marf_tpu_torch.utils import config as tconfig
from marf_tpu_torch.utils.config import resolve_device, resolve_yaml_path
from marf_tpu_torch.utils.params import params_from_jax
from test_torch_models import cfg_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--H=32", "--W=64", "--patch_H=16", "--patch_W=32", "--batch_size=3", "--arch.layers=[null,64,64,3]",
        "--arch.posenc.L_2D=4", "--barf_c2f=[0,0.4]", "--dataset=synthetic", "--seed=3", "--tb="]


@pytest.mark.parametrize("crop", [True, False])
def test_synthetic_dataset_equals_jax(crop):
    jcfg, tcfg = cfg_pair(use_cropped_images=crop, batch_size=4)
    ref = jsynth(jcfg, seed=3)
    ours = synthesize_planar_dataset(tcfg, seed=3)
    assert set(ours) == set(ref)
    for k in ref:
        if k == "gt_hom":
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize(
    "args",
    [
        ["--model=planar", "--yaml=planar", *TINY],
        ["--a.b.c=3", "--a.b.d=x", "--flag", "--off!", "--none=", "--tpu.fused_step=on", "--lst=[0,0.4]"],
    ],
)
def test_parse_arguments_matches_jax(args):
    assert tconfig.parse_arguments(args) == jparse(args)


def test_load_options_matches_jax(tmp_path):
    """`_parent_` inheritance: a child yaml over planar.yaml, nested keys merged."""
    child = tmp_path / "child.yaml"
    child.write_text(f"_parent_: {resolve_yaml_path('planar')}\nmax_iter: 7\narch:\n  posenc:\n    L_2D: 4\nnew_key: 1\n")
    ours = tconfig.load_options(str(child))
    assert ours == load_options(str(child))
    assert ours.max_iter == 7 and ours.arch.posenc.L_2D == 4 and "_parent_" not in ours


def test_options_file_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("MARF_YES", "1")
    opt = tconfig.set_opt(tconfig.parse_arguments(["--model=planar", "--yaml=planar", "--cpu", f"--output_root={tmp_path}",
                                                   "--group=g", "--name=n", *TINY]))
    assert opt.output_path == f"{tmp_path}/g/n_seed3" and opt.device == "cpu"
    tconfig.save_options_file(opt)
    opt.max_iter = 11
    tconfig.save_options_file(opt)  # a different snapshot is overridden in a non-interactive run
    assert tconfig.load_options(f"{opt.output_path}/options.yaml") == opt


def make_opt(tmp_path, **overrides):
    opt = load_options(resolve_yaml_path("planar"))
    opt.update(AttrDict(
        model="planar", yaml="planar", group="it", name="run", seed=3, dataset="synthetic",
        H=32, W=64, patch_H=16, patch_W=32, batch_size=3, max_iter=10, barf_c2f=[0, 0.4],
        output_path=str(tmp_path / "out"), freq=AttrDict(scalar=5, vis=5, ckpt=None), tb=None,
        save_checkpoint=False,
    ))
    opt.arch.layers = [None, 64, 64, 3]
    opt.arch.posenc.L_2D = 4
    opt.update(AttrDict(overrides))
    os.makedirs(opt.output_path, exist_ok=True)
    return opt


@pytest.mark.parametrize("fused_step", ["off", "on"])
def test_model_matches_jax_model(tmp_path, fused_step):
    from marf_tpu.engine.trainer import Model as JaxModel
    from marf_tpu_torch.engine.trainer import Model

    tpu = AttrDict(fused_step=fused_step, fused_warp="on")
    jm = JaxModel(make_opt(tmp_path / "jax", tpu=tpu))
    jm.load_dataset()
    jm.build_networks()
    init = jax.tree.map(np.asarray, jm.params)
    jm.setup_optimizer()
    jm.setup_visualizer()
    jm.train()

    m = Model(make_opt(tmp_path / "torch", tpu=tpu, cpu=True))
    m.load_dataset()
    m.build_networks()
    m.graph.load_state_dict(params_from_jax(init))
    m.setup_optimizer()
    m.setup_visualizer()
    m.train()

    assert m.it == jm.it == 10
    rgb = np.concatenate([h["loss_rgb"] for h in m.history])
    assert rgb.shape == (10,) and np.isfinite(rgb).all() and rgb[-1] < rgb[0]
    np.testing.assert_array_equal(m.graph.warp.detach().numpy()[0], 0.0)
    pairs = [(m.graph.warp.detach().numpy(), np.asarray(jm.state.params["warp"]), init["warp"])]
    for layer, jl, j0 in zip(m.graph.neural_image.layers, jm.state.params["neural_image"]["mlp"], init["neural_image"]["mlp"]):
        pairs.append((layer.weight.detach().numpy().T, np.asarray(jl["w"]), j0["w"]))
        pairs.append((layer.bias.detach().numpy(), np.asarray(jl["b"]), j0["b"]))
    for ours, ref, start in pairs:
        assert np.linalg.norm((ours - start) - (ref - start)) <= 2e-2 * np.linalg.norm(ref - start)


def test_cli_trains_on_cpu(tmp_path, monkeypatch):
    from marf_tpu_torch.train import main

    monkeypatch.setenv("MARF_YES", "1")
    m = main(["--model=planar", "--yaml=planar", "--cpu", f"--output_root={tmp_path}", "--max_iter=6",
              "--freq.scalar=3", "--freq.vis=3", "--tpu.fused_step=on", *TINY])
    assert m.it == 6 and m.device.type == "cpu"
    assert os.path.isfile(os.path.join(m.opt.output_path, "options.yaml"))
    assert all(np.isfinite(h["all"]).all() for h in m.history)


def test_tb_scalars(tmp_path):
    """The port's TensorBoard writer: scalar tags and steps read back."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from marf_tpu_torch.utils.tb import SummaryWriter

    w = SummaryWriter(str(tmp_path))
    for step in (5, 10):
        w.add_scalar("train/PSNR", 10.0 + step, step)
    w.flush()
    w.close()
    ea = EventAccumulator(str(tmp_path))
    ea.Reload()
    assert [(e.step, e.value) for e in ea.Scalars("train/PSNR")] == [(5, 15.0), (10, 20.0)]


def test_config_copies_equal_marf_tpu():
    """The port reads its own copy of the planar.yaml family
    (marf_tpu_torch/configs); each file stays byte-equal to its marf_tpu
    original, so a drift of either shows here."""
    ours, theirs = (os.path.join(REPO, pkg, "configs") for pkg in ("marf_tpu_torch", "marf_tpu"))
    names = sorted(f for f in os.listdir(theirs) if f.endswith(".yaml"))
    assert names and sorted(f for f in os.listdir(ours) if f.endswith(".yaml")) == names
    for name in names:
        with open(os.path.join(ours, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    assert os.path.dirname(resolve_yaml_path("planar")) == ours


def test_device_resolution_without_cuda(monkeypatch, tmp_path):
    """No silent CPU fallback: without --cpu the port needs a card."""
    from marf_tpu_torch.engine.trainer import Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device(cpu=True).type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(make_opt(tmp_path))


def test_port_never_imports_jax(tmp_path):
    """Neither jax nor any module of marf_tpu (the JAX package) is imported,
    on the canonical path and on the implicit-mask path, nor by the
    multi-device modules (marf_tpu_torch/parallel/) or the bench entry."""
    code = f"""
import sys
from marf_tpu_torch.train import main
m = main(["--model=planar", "--yaml=planar", "--cpu", "--output_root={tmp_path}", "--max_iter=2",
          "--freq.scalar=2", "--freq.vis=2", "--tpu.fused_step=on", *{TINY!r}])
assert m.it == 2
m = main(["--model=planar", "--yaml=planar", "--cpu", "--output_root={tmp_path}", "--max_iter=2", "--name=implicit",
          "--freq.scalar=2", "--freq.vis=2", "--tpu.fused_step=on", "--use_implicit_mask", "--use_masks=false",
          "--N_vocab=8", *{TINY!r}])
assert m.it == 2
import marf_tpu_torch.ops.cuda._build, marf_tpu_torch.ops.cuda.fused_step, marf_tpu_torch.ops.cuda.fused_mask
import marf_tpu_torch.utils.params
import marf_tpu_torch.parallel.mesh, marf_tpu_torch.parallel.sharded, marf_tpu_torch.parallel.launch
from marf_tpu_torch import bench
bench.golden_check("canonical", 600, 3, "float32", "cat_batch3", 21.9)
leaked = sorted(k for k in sys.modules if k in ("jax", "marf_tpu") or k.startswith(("jax.", "jaxlib", "flax", "optax", "marf_tpu.")))
assert not leaked, leaked
print("JAX-FREE")
"""
    env = dict(os.environ, PYTHONPATH=REPO, MARF_YES="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "JAX-FREE" in proc.stdout
