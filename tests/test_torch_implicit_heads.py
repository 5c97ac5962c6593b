"""Per-image mask heads and the shared head without column dedup (the K5 ->
K6 step) of the PyTorch port against marf_tpu on the CPU: `build_mask_x`, the
plain versions of K5 (`fused_implicit_train_kernel`) and K6
(`fused_mask_backward_g`) against the Pallas kernels in interpret mode,
3-step trajectories of the fused step against marf_tpu's
`_fused_implicit_grads`, one-step gradients against the port's own autograd
step, Mask_Error, the dedup gate, and tiny `Model` runs through the CLI.
The card tests of K5 and K6 are in tests/test_torch_fused_step.py (marker
`cuda`), which imports no marf_tpu module that the card's machine lacks.

Small shapes as in tests/test_torch_implicit.py: 16x32 patches, B=3,
N_vocab=8, the 64-wide MLP, the saturated-pixel mix. Every head has its own
weights (marf_tpu's init) and every image its own pixels, so a head trained
on another head's column block shows. Tolerances: float32 values rtol 1e-5;
sums rtol 1e-5 (sum m) and 1e-4 (sum m^2 sq, a product of two rounded
values); gradients by relative error to the max-abs <= 1e-4, and 1e-3 for
dcoords: each point's dcoords is a difference of posenc terms up to 2^(L-1)
pi larger than itself, so float32 cancellation leaves ~1e-4 of its max-abs
in either framework whatever the order of the sums. Trajectories use
`assert_same_trajectory` (tests/test_torch_implicit.py).

The trajectory and step-gradient tests take their batch from
RandomState(DATA_SEED), not the `rng` fixture. Per-image heads hold three
heads' weights, and with some batches float32 rounding moves a few of their
gradients in either framework's dense autograd path: at seed 0 head 2's
first-layer gradient is 4.0e-4 (of its max-abs) from a float64 recompute
in marf_tpu's autodiff and in the port's autograd alike, while the fused
K5 -> K6 step is within 1.1e-7 of it. A few other components sit at
cancellation level (~1e-5 of the max-abs), where Adam's first step turns
their sign into +-lr, and two implementations part by up to 2e-3 on those
weights after 3 steps (1.1e-3 between the two autograd paths at seed 3).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marf_tpu.ops.pallas import fused_mask as jfm
from marf_tpu.ops.warp import warp_grid_cf_flat as jwarp
from marf_tpu_torch.engine.step import make_optimizer, make_train_step
from marf_tpu_torch.models import planar as tplanar
from marf_tpu_torch.ops.cuda import LAUNCHES
from marf_tpu_torch.ops.cuda import fused_implicit as tfi
from marf_tpu_torch.ops.cuda import fused_mask as tfm
from marf_tpu_torch.utils.params import params_to_jax
from test_torch_implicit import assert_same_trajectory, grid_of, icfg, implicit_data, jax_trajectory, port_trajectory
from test_torch_models import jax_params, port_graph, rel_err, to_torch

DATA_SEED = 5
CW = np.array([1.0, 0.8, 0.3, 0.0], np.float32)  # c2f band weights part-way through the schedule (L = 4)
G2C = 1.7


def factored(jcfg, jp, data):
    """marf_tpu's factoring of the batch: (uv, onehot, table) as numpy."""
    uv, onehot, table = jfm.factor_mask_inputs(jnp.asarray(jp["view_embedding"]), jnp.asarray(data["rgb"]), grid_of(jcfg))
    return np.array(uv), np.array(onehot), np.array(table)


def head_inputs(n_heads, rng, device=None, **kw):
    """Both packages' head-blocked inputs for n_heads 1 (shared) or B:
    (jcfg, jp, port graph, JAX stacks, port stacks, X [56, N] numpy, data);
    kw: further config (icfg)."""
    jcfg, tcfg = icfg(build_single_masks=n_heads > 1, **kw)
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp).to(device)
    data = implicit_data(jcfg, rng)
    uv, onehot, table = factored(jcfg, jp, data)
    X = np.asarray(jfm.build_mask_x(jnp.asarray(uv), jnp.asarray(onehot), n_heads > 1))
    if n_heads > 1:
        X = X.transpose(1, 0, 2).reshape(X.shape[1], -1)  # head h's block: columns h*HW .. (h+1)*HW - 1
    jstacks = jfm.mask_w_stack_batched(jax.tree.map(jnp.asarray, jp["implicit_mask"]), jnp.asarray(table), n_heads)
    heads = list(g.implicit_mask) if n_heads > 1 else [g.implicit_mask]
    stacks = [tfm.mask_w_stack(h, torch.from_numpy(table).to(device)) for h in heads]
    assert len(stacks) == n_heads
    if n_heads > 1:
        assert not torch.equal(stacks[0][0][0], stacks[1][0][0])  # distinct heads
    return jcfg, jp, g, jstacks, stacks, np.ascontiguousarray(X), data


@pytest.mark.parametrize("single", [False, True], ids=["shared", "per_image"])
def test_build_mask_x_matches_jax(rng, single):
    jcfg, _ = icfg(build_single_masks=single)
    jp = jax_params(jcfg)
    uv, onehot, _ = factored(jcfg, jp, implicit_data(jcfg, rng))
    ref = np.asarray(jfm.build_mask_x(jnp.asarray(uv), jnp.asarray(onehot), single))
    ours = tfm.build_mask_x(torch.from_numpy(uv), torch.from_numpy(onehot), single).numpy()
    B, _, HW = onehot.shape
    assert ours.shape == ((B, tfm.X_ROWS, HW) if single else (tfm.X_ROWS, B * HW))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("n_heads", [1, 3], ids=["shared", "per_image"])
def test_implicit_train_plain_matches_pallas(rng, n_heads):
    """K5's plain version against marf_tpu's `fused_implicit_train_kernel`
    (interpret mode), all seven outputs, unnormalized."""
    jcfg, jp, g, jstacks, stacks, X, data = head_inputs(n_heads, rng)
    N = X.shape[1]
    coords = np.asarray(jwarp(grid_of(jcfg), jnp.asarray(jp["warp"])))
    targets = np.ascontiguousarray(data["rgb"].transpose(1, 0, 2, 3).reshape(3, N))
    ref = jfm.fused_implicit_train_kernel(
        jax.tree.map(jnp.asarray, jp["neural_image"]), jstacks, jnp.asarray(coords), jnp.asarray(X), jnp.asarray(CW),
        jnp.asarray(targets), jnp.float32(G2C), jcfg.arch, n_heads,
    )
    t = torch.from_numpy
    rgb, m, sq, dcoords, msum, loss, dmlp = tfi.fused_implicit_train_kernel(
        g.neural_image, stacks, t(coords), t(X), t(CW), t(targets), torch.tensor(G2C)
    )
    for name, ours, r in (("rgb", rgb, ref[0]), ("m", m, ref[1]), ("sq", sq, ref[2])):
        assert tuple(ours.shape) == np.shape(r), name
        np.testing.assert_allclose(ours.numpy(), np.asarray(r), rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(msum.numpy(), np.asarray(ref[4]), rtol=1e-5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref[5]), rtol=1e-4)
    assert rel_err(dcoords.numpy(), ref[3]) <= 1e-3
    for (dw, db), jl in zip(dmlp, ref[6]["mlp"]):
        assert rel_err(dw.numpy().T, jl["w"]) <= 1e-4
        assert rel_err(db.numpy(), jl["b"]) <= 1e-4


@pytest.mark.parametrize("n_heads", [1, 3], ids=["shared", "per_image"])
@pytest.mark.parametrize("use_esq", [True, False], ids=["esq", "no_esq"])
@pytest.mark.parametrize("use_cnt", [False, True], ids=["ones", "cnt"])
def test_mask_backward_g_plain_matches_pallas(rng, n_heads, use_esq, use_cnt):
    """K6's plain version against marf_tpu's `fused_mask_backward_g`
    (interpret mode): every head's dW/db of every effective layer."""
    _, _, _, jstacks, stacks, X, _ = head_inputs(n_heads, rng)
    N = X.shape[1]
    sq = np.abs(rng.randn(1, N)).astype(np.float32)
    esq = np.abs(rng.randn(1, N)).astype(np.float32) if use_esq else None
    cnt = rng.randint(1, 5, (1, N)).astype(np.float32) if use_cnt else None
    a, b, c, k = 0.7, 0.3, -0.2, 0.05
    ref = jfm.fused_mask_backward_g(
        jstacks, jnp.asarray(X), jnp.asarray(sq), None if esq is None else jnp.asarray(esq),
        jnp.asarray([a, b, c, k], jnp.float32), n_heads=n_heads, cnt_cf=None if cnt is None else jnp.asarray(cnt),
    )
    t = lambda x: None if x is None else torch.from_numpy(x)
    ours = tfm.fused_mask_backward_g(stacks, t(X), t(sq), t(esq), torch.tensor([a, b, k]), c, t(cnt))
    assert len(ours) == n_heads
    for h, grads in enumerate(ours):
        for li, ((dw, db), jl) in enumerate(zip(grads, ref)):
            assert rel_err(dw.numpy().T, np.asarray(jl["w"])[h]) <= 1e-4, (h, li)
            assert rel_err(db.numpy(), np.asarray(jl["b"])[h]) <= 1e-4, (h, li)


CASES = [({"build_single_masks": True}, True), ({"build_single_masks": True}, False), ({"fused_dedup": "off"}, True)]
CASE_IDS = ["per_image_edges", "per_image_no_edges", "shared_no_dedup_edges"]


@pytest.mark.parametrize("kw,use_edges", CASES, ids=CASE_IDS)
def test_heads_trajectory_matches_jax(kw, use_edges):
    """3 fused K5 -> K6 steps of the port (plain versions) against
    marf_tpu's `_fused_implicit_grads` (its Pallas kernels in interpret
    mode)."""
    jcfg, tcfg = icfg(use_edges=use_edges, alpha_initial=0.3, fused_step="on", **kw)
    jp = jax_params(jcfg)
    data = implicit_data(jcfg, np.random.RandomState(DATA_SEED))
    if not use_edges:
        data["edges"] = None
    jstate, jm = jax_trajectory(jcfg, jp, data, 3, dedup=False)
    g, tm = port_trajectory(tcfg, jp, data, 3)
    assert tm["finite"].all()
    assert_same_trajectory(tm, jm, params_to_jax(g.state_dict()), jstate.params, use_edges)


@pytest.mark.parametrize("kw,use_edges", CASES, ids=CASE_IDS)
def test_heads_step_grads_match_port_autograd(kw, use_edges, capsys):
    """One fused K5 -> K6 step (plain versions) against the port's autograd
    step: every parameter's gradient."""
    grads = {}
    data = implicit_data(icfg(**kw)[0], np.random.RandomState(DATA_SEED))
    if not use_edges:
        data["edges"] = None
    for mode in ("off", "on"):
        jcfg, tcfg = icfg(use_edges=use_edges, alpha_initial=0.3, fused_step=mode, **kw)
        g = port_graph(tcfg, jax_params(jcfg))
        opt, _ = make_optimizer(g, {"lr": 0.0, "lr_warp": 0.0}, tcfg.max_iter)
        step_fn = make_train_step(tcfg, g, opt, to_torch(data))
        step_fn.set_step(3)
        step_fn()
        grads[mode] = {k: p.grad.clone() for k, p in g.named_parameters() if p.grad is not None}
    assert "(K5 -> K6)" in capsys.readouterr().out
    assert set(grads["on"]) == set(grads["off"]) and len(grads["on"]) == len(list(g.parameters())) - 1
    for k, ref in grads["off"].items():
        assert rel_err(grads["on"][k].numpy(), ref.numpy()) <= 1e-4, k


@pytest.mark.parametrize("mode", ["on", "off"])
def test_mask_error_per_image_matches_jax(rng, mode):
    """use_masks + per-image heads: Mask_Error of the pre-update mask, fused
    (K5 -> K6) and autograd, against marf_tpu's."""
    jcfg, tcfg = icfg(use_masks=True, build_single_masks=True, fused_step=mode)
    jp = jax_params(jcfg)
    data = implicit_data(jcfg, rng)
    _, jm = jax_trajectory(jcfg, jp, data, 2, dedup=False)
    _, tm = port_trajectory(tcfg, jp, data, 2)
    np.testing.assert_allclose(tm["Mask_Error"], np.asarray(jm["Mask_Error"]), rtol=1e-5, atol=1e-7)
    assert (tm["Mask_Error"] > 0).all()


def test_dedup_gate(capsys):
    """Per-image heads and fused_dedup=off run the fused K5 -> K6 step; only
    the shared head with fused_dedup auto/on deduplicates; fused_dedup=on
    with per-image heads is ignored with a log line."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    cfg = lambda **kw: icfg(**kw)[1]
    for kw in ({"build_single_masks": True}, {"fused_dedup": "off"}, {"build_single_masks": True, "fused_dedup": "on"}):
        assert tplanar.use_fused_implicit(cfg(fused_step="on", **kw), cpu)
        assert tplanar.use_fused_implicit(cfg(fused_step="auto", **kw), cuda)
        assert not tplanar.use_fused_dedup(cfg(fused_step="auto", **kw), cuda)
    assert "fused_dedup=on ignored" in capsys.readouterr().out
    for kw in ({}, {"fused_dedup": "on"}, {"fused_dedup": "auto"}):
        assert tplanar.use_fused_dedup(cfg(fused_step="auto", **kw), cuda)
        assert not tplanar.use_fused_dedup(cfg(fused_step="auto", **kw), cpu)
    assert not tplanar.use_fused_dedup(cfg(fused_step="off"), cuda)
    assert "ignored" not in capsys.readouterr().out


def test_wrappers_run_plain_versions_on_cpu_without_counting(rng):
    jcfg, jp, g, _, stacks, X, data = head_inputs(3, rng)
    N = X.shape[1]
    t = torch.from_numpy
    coords = t(np.asarray(jwarp(grid_of(jcfg), jnp.asarray(jp["warp"]))))
    targets = t(np.ascontiguousarray(data["rgb"].transpose(1, 0, 2, 3).reshape(3, N)))
    before = dict(LAUNCHES)
    k5 = (g.neural_image, stacks, coords, t(X), None, targets, 2.0)
    a, b = tfi.fused_implicit_train_kernel(*k5), tfi.fused_implicit_train_kernel_reference(*k5)
    sq = t(np.abs(rng.randn(1, N)).astype(np.float32))
    k6 = (stacks, t(X), sq, None, torch.tensor([0.7, 0.3, 0.05]), -0.2)
    c, d = tfm.fused_mask_backward_g(*k6), tfm.fused_mask_backward_g_reference(*k6)
    assert LAUNCHES == before
    assert all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))
    assert all(torch.equal(x[0][0], y[0][0]) for x, y in zip(c, d))


@pytest.mark.parametrize("flag", ["--build_single_masks", "--tpu.fused_dedup=off"])
def test_model_trains_heads_on_cpu(tmp_path, monkeypatch, capsys, flag):
    from marf_tpu_torch.train import main
    from test_torch_trainer import TINY

    monkeypatch.setenv("MARF_YES", "1")
    m = main(["--model=planar", "--yaml=planar", "--cpu", f"--output_root={tmp_path}", "--max_iter=12",
              "--freq.scalar=4", "--freq.vis=4", "--tpu.fused_step=on", "--use_implicit_mask", "--use_masks=false",
              "--N_vocab=8", flag, *TINY])
    assert "(K5 -> K6)" in capsys.readouterr().out
    assert m.it == 12 and m.device.type == "cpu"
    loss = np.concatenate([h["all"] for h in m.history])
    assert np.isfinite(loss).all() and loss[-1] < loss[0]
    assert np.concatenate([h["loss_mask"] for h in m.history]).min() > 0
