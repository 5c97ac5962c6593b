"""The port's train step against marf_tpu's `make_train_step` on the CPU,
on the autograd path and on the fused_step=on path (the plain K1 version on
the CPU against the Pallas kernel in interpret mode).

Tolerances: gradients by relative error to the max-abs <= 1e-4 (summation
order); per-step losses of a 5-step trajectory rtol=1e-3; each parameter's
update over the trajectory (final - initial) within 2e-2 of marf_tpu's in L2
norm. Adam normalizes each component, so a gradient component near zero (a
sum that cancels, whose relative rounding difference between the frameworks
reaches ~3e-3) still takes a step of up to lr, and rounding changes that
step; measured up to 9.2e-3 (layer-1 bias, masks on).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marf_tpu.engine import step as jstep
from marf_tpu.models import planar as jplanar
from marf_tpu.ops.losses import summarize_loss as jsum
from marf_tpu_torch.engine.step import chunk_schedule, make_optimizer, make_train_step, run_chunk
from marf_tpu_torch.models import planar as tplanar
from test_torch_models import cfg_pair, fake_data, jax_params, port_graph, rel_err, to_jax, to_torch

OPTIM = {"lr": 1e-3, "lr_warp": 2e-3, "lr_mask": 1e-3, "algo": "Adam"}


def setup(mode, rng, **kw):
    jcfg, tcfg = cfg_pair(fused_step=mode, fused_warp="on", alpha_initial=0.2, **kw)
    jp = jax_params(jcfg)
    data = fake_data(jcfg, rng)
    return jcfg, tcfg, jp, data


@pytest.mark.parametrize("mode", ["off", "on"])
def test_one_step_gradients_match_jax(rng, mode):
    jcfg, tcfg, jp, data = setup(mode, rng)
    jdata = to_jax(data)
    step = 4

    def loss_fn(params):
        out = jplanar.graph_forward(params, jdata, jcfg, jnp.float32(step) / jcfg.max_iter)
        return jsum(jplanar.graph_loss(out, jdata, jcfg, jnp.int32(step)), jcfg.loss_weight)

    jgrads = jax.grad(loss_fn)(jax.tree.map(jnp.asarray, jp))
    g = port_graph(tcfg, jp)
    opt, _ = make_optimizer(g, OPTIM, tcfg.max_iter)
    step_fn = make_train_step(tcfg, g, opt, to_torch(data))
    step_fn.set_step(step)
    step_fn()
    assert rel_err(g.warp.grad.numpy(), jgrads["warp"]) <= 1e-4
    for layer, jl in zip(g.neural_image.layers, jgrads["neural_image"]["mlp"]):
        assert rel_err(layer.weight.grad.numpy().T, jl["w"]) <= 1e-4
        assert rel_err(layer.bias.grad.numpy(), jl["b"]) <= 1e-4


@pytest.mark.parametrize("mode,use_masks", [("off", True), ("on", True), ("on", False)])
def test_trajectory_matches_jax(rng, mode, use_masks):
    jcfg, tcfg, jp, data = setup(mode, rng, use_masks=use_masks)
    if not use_masks:
        data.update(masks=None, masks_eroded=None)
    assert_trajectory_matches_jax(jcfg, tcfg, jp, data)


def assert_trajectory_matches_jax(jcfg, tcfg, jp, data, n=5):
    """n steps of both packages from the same init and data: per-step losses
    and the parameters' updates agree (tolerances in the module docstring)."""
    tx = jstep.make_optimizer(OPTIM, jcfg.max_iter)
    state = jstep.init_train_state(jax.tree.map(jnp.asarray, jp), tx)
    jstate, jm = jstep.make_train_chunk(jstep.make_train_step(jcfg, tx), n, donate=False)(state, to_jax(data))
    g = port_graph(tcfg, jp)
    opt, _ = make_optimizer(g, OPTIM, tcfg.max_iter)
    tm = run_chunk(make_train_step(tcfg, g, opt, to_torch(data)), 0, n)
    for k in ("all", "loss_rgb", "loss_edge", "loss_render", "PSNR", "Homography_Error"):
        np.testing.assert_allclose(tm[k], np.asarray(jm[k]), rtol=1e-3, atol=1e-7, err_msg=k)
    assert tm["finite"].all()
    # the parameters moved the same way: the update vector Δ = final - init
    # agrees in L2 norm
    pairs = [(g.warp.detach().numpy(), np.asarray(jstate.params["warp"]), jp["warp"])]
    for layer, jl, j0 in zip(g.neural_image.layers, jstate.params["neural_image"]["mlp"], jp["neural_image"]["mlp"]):
        pairs.append((layer.weight.detach().numpy().T, np.asarray(jl["w"]), j0["w"]))
        pairs.append((layer.bias.detach().numpy(), np.asarray(jl["b"]), j0["b"]))
    for ours, ref, init in pairs:
        d_ref = ref - init
        assert np.linalg.norm((ours - init) - d_ref) <= 2e-2 * np.linalg.norm(d_ref)


def test_fix_first_pins_warp_zero(rng):
    _, tcfg, jp, data = setup("on", rng)
    g = port_graph(tcfg, jp)
    opt, _ = make_optimizer(g, OPTIM, tcfg.max_iter)
    run_chunk(make_train_step(tcfg, g, opt, to_torch(data)), 0, 3)
    w = g.warp.detach().numpy()
    np.testing.assert_array_equal(w[0], 0.0)
    assert np.abs(w[1:]).max() > 0


def test_lazy_metrics_match_eager(rng):
    """Lazy metrics skip the edge term and Homography_Error on all but the
    chunk-final step; updates and the final row are unchanged."""
    out = {}
    for lazy in ("off", "on"):
        jcfg, tcfg = cfg_pair(fused_step="on", fused_warp="on", lazy_metrics=lazy, alpha_initial=0.3)
        g = port_graph(tcfg, jax_params(jcfg))
        opt, _ = make_optimizer(g, OPTIM, tcfg.max_iter)
        m = run_chunk(make_train_step(tcfg, g, opt, to_torch(fake_data(jcfg, np.random.RandomState(2)))), 0, 4)
        out[lazy] = (m, g)
    (m_e, g_e), (m_l, g_l) = out["off"], out["on"]
    assert torch.equal(g_e.warp, g_l.warp)
    assert np.all(m_l["loss_edge"][:-1] == 0) and np.all(m_e["loss_edge"][:-1] > 0)
    assert np.all(m_l["Homography_Error"][:-1] == 0) and np.all(m_e["Homography_Error"][:-1] > 0)
    for k in ("all", "loss_edge", "Homography_Error", "PSNR"):
        np.testing.assert_array_equal(m_l[k][-1], m_e[k][-1], err_msg=k)
    np.testing.assert_array_equal(m_l["loss_rgb"], m_e["loss_rgb"])


def test_fused_gating():
    cpu = torch.device("cpu")
    on = lambda **kw: cfg_pair(fused_step="on", **kw)[1]
    auto = lambda **kw: cfg_pair(fused_step="auto", **kw)[1]
    assert tplanar.use_fused_step(on(fused_warp="on"), cpu)
    assert not tplanar.use_fused_step(auto(), cpu)  # auto = on under CUDA only
    assert tplanar.use_fused_step(auto(), torch.device("cuda"))
    # fused_warp=off and more than 8 images run K2
    assert tplanar.use_fused_step(on(fused_warp="off"), cpu) and tplanar.use_fused_step(on(batch_size=9), cpu)
    for kw in ({"arch": {"skip": (1,)}}, {"differentiable_edges": True}):
        with pytest.raises(NotImplementedError):
            tplanar.use_fused_step(on(**kw), cpu)
        assert not tplanar.use_fused_step(auto(**kw), torch.device("cuda"))
    # implicit masks take their own fused pipeline (tests/test_torch_implicit.py)
    assert not tplanar.use_fused_step(on(use_implicit_mask=True), cpu)


def test_lr_schedule_fix_mode():
    _, tcfg = cfg_pair()
    g = tplanar.Graph(tcfg)
    sched = {"type": "StepLR", "steps": 2, "gamma": 0.5}
    opt, s = make_optimizer(g, dict(OPTIM, sched=sched), tcfg.max_iter)
    assert s is None  # the reference never steps its scheduler: inert by default
    opt, s = make_optimizer(g, dict(OPTIM, sched=sched, apply_sched=True), tcfg.max_iter)
    lrs = []
    for _ in range(5):
        lrs.append([float(grp["lr"]) for grp in opt.param_groups])  # the rates are tensors, written in place
        opt.step()
        s.step()
    np.testing.assert_allclose([lr[1] for lr in lrs], [2e-3, 2e-3, 1e-3, 1e-3, 5e-4])
    assert chunk_schedule(3000, 20, 100) == 20 and chunk_schedule(60, 20, 30, 45) == 5
