"""The shared-head implicit-mask slice of the PyTorch port against marf_tpu on
the CPU: the Ha-NeRF uv embedding, the mask head and its inputs, the
factoring and the slot0+extras dedup, the parameter carry, graph_loss, the
plain versions of K3 and K4 against the Pallas kernels in interpret mode,
3-step trajectories of the fused dedup step against marf_tpu's dedup step and
against the port's own autograd step, the inert pad columns of the dedup
inputs, Mask_Error, the gating, the optimizer's groups and learning rates
against marf_tpu's optax optimizer, and a tiny `Model` run through the CLI.

Small shapes as in tests/test_fused_mask.py: 16x32 patches, B=3, N_vocab=8,
the 64-wide MLP, and a saturated-pixel mix so that all 8 RGB combos and some
extra dedup columns occur. Tolerances: float32 values rtol=1e-5 (rounding
and summation order of the two frameworks); gradients by relative error to
the max-abs <= 1e-4; trajectories as test_fused_implicit_dedup_matches_autodiff
(tests/test_fused_mask.py:262-288): losses rtol 1e-5, warp and MLP rtol 1e-3,
mask head atol 5e-4 (Adam amplifies reordering noise in near-zero gradient
components).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marf_tpu.engine import step as jstep
from marf_tpu.models import implicit_mask as jim
from marf_tpu.models import planar as jplanar
from marf_tpu.ops.grid import normalized_pixel_grid as jgrid
from marf_tpu.ops.losses import summarize_loss as jsum
from marf_tpu.ops.pallas import fused_mask as jfm
from marf_tpu.ops.posenc import hanerf_pos_embedding as jhanerf
from marf_tpu_torch.engine.step import make_optimizer, make_train_step, run_chunk
from marf_tpu_torch.models import implicit_mask as tim
from marf_tpu_torch.models import planar as tplanar
from marf_tpu_torch.ops.cuda import fused_mask as tfm
from marf_tpu_torch.ops.losses import summarize_loss as tsum
from marf_tpu_torch.ops.posenc import hanerf_pos_embedding
from marf_tpu_torch.utils.params import params_from_jax, params_to_jax
from test_torch_models import cfg_pair, fake_data, jax_params, port_graph, rel_err, to_jax, to_torch

OPTIM = {"lr": 1e-3, "lr_warp": 1e-3, "lr_mask": 1e-3, "algo": "Adam"}


def icfg(**kw):
    """The small implicit-mask config in both packages."""
    return cfg_pair(**dict(dict(use_implicit_mask=True, use_masks=False, N_vocab=8), **kw))


def implicit_data(cfg, rng) -> dict:
    """fake_data with the saturated-pixel mix of tests/test_fused_mask.py."""
    data = fake_data(cfg, rng)
    data["rgb"] = np.where(rng.rand(*data["rgb"].shape) > 0.5, 1.0, data["rgb"]).astype(np.float32)
    return data


def grid_of(jcfg):
    return jgrid(jcfg.grid_spec, crop=jcfg.use_cropped_images)


def test_hanerf_pos_embedding_matches_jax(rng):
    x = (rng.rand(300, 2) * 2 - 1).astype(np.float32)
    ours = hanerf_pos_embedding(torch.from_numpy(x)).numpy()
    assert ours.shape == (300, 42)
    np.testing.assert_allclose(ours, np.asarray(jhanerf(jnp.asarray(x))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("single", [False, True])
def test_mask_head_matches_jax(rng, single):
    """The dense inputs [B, 426, HW] and the head (apply_implicit_mask_cf)."""
    jcfg, tcfg = icfg(build_single_masks=single)
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp)
    data = implicit_data(jcfg, rng)
    grid = grid_of(jcfg)
    jx = jim.mask_head_inputs_cf(jnp.asarray(jp["view_embedding"]), jnp.asarray(data["rgb"]), grid)
    tx = tim.mask_head_inputs_cf(g.view_embedding, torch.from_numpy(data["rgb"]), g.grid)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    ref = jplanar.graph_forward(jax.tree.map(jnp.asarray, jp), to_jax(data), jcfg, jnp.float32(0.2))
    ours = tplanar.graph_forward(g, to_torch(data), tcfg, torch.tensor(0.2))
    assert set(ours) == set(ref)
    for k in ("mask_prediction", "mask_prediction_map"):
        assert tuple(ours[k].shape) == tuple(ref[k].shape), k
        np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_quantized_embedding_truncates():
    """image.long() maps only an exact 1.0 to row 1; quantize_levels > 1 is the fix mode."""
    emb = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    img = torch.tensor([0.0, 0.999, 1.0]).reshape(3, 1, 1).expand(3, 1, 1).contiguous()
    rows = tim.embed_image(emb, img).reshape(3, 128)[:, 0] / 128
    np.testing.assert_array_equal(rows.numpy(), [0, 0, 1])
    rows4 = tim.embed_image(emb, img, quantize_levels=4).reshape(3, 128)[:, 0] / 128
    np.testing.assert_array_equal(rows4.numpy(), [0, 2, 3])
    ref = jim.embed_image(jnp.asarray(emb.numpy()), jnp.asarray(img.numpy()), 4)
    np.testing.assert_array_equal(np.asarray(ref), tim.embed_image(emb, img, quantize_levels=4).numpy())


def test_factoring_and_dedup_match_jax(rng):
    jcfg, tcfg = icfg()
    jp = jax_params(jcfg)
    data = implicit_data(jcfg, rng)
    grid = grid_of(jcfg)
    juv, joh, jtab = jfm.factor_mask_inputs(jnp.asarray(jp["view_embedding"]), jnp.asarray(data["rgb"]), grid)
    tuv, toh, ttab = tfm.factor_mask_inputs(torch.tensor(jp["view_embedding"]), torch.from_numpy(data["rgb"]),
                                            torch.from_numpy(np.asarray(grid)))
    np.testing.assert_array_equal(toh.numpy(), np.asarray(joh))
    np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=1e-5, atol=1e-6)
    # the same numpy inputs give identical dedup arrays (ties, extras order)
    uv, onehot = np.asarray(juv), np.asarray(joh)
    ref = jfm.slot_dedup_inputs(uv, onehot)
    ours = tfm.slot_dedup_inputs(uv, onehot)
    for name, a, b in zip(("X_all", "slot0map", "ext_pix", "extmap", "cnt_all"), ours, ref):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    HW = onehot.shape[2]
    E = ours[2].shape[0]
    assert E > 0 and HW + E < jcfg.batch_size * HW


def test_mask_w_stack_and_unfactor_match_jax(rng):
    jcfg, tcfg = icfg()
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp)
    table = rng.randn(8, 384).astype(np.float32)
    ref = jfm.mask_w_stack(jax.tree.map(jnp.asarray, jp["implicit_mask"]), jnp.asarray(table))
    ours = tfm.mask_w_stack(g.implicit_mask, torch.from_numpy(table))
    for (w, b), jl in zip(ours, ref):
        np.testing.assert_allclose(w.numpy().T, np.asarray(jl["w"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(b.numpy(), np.asarray(jl["b"]))
    dl = [(torch.from_numpy(rng.randn(*w.shape).astype(np.float32)), torch.from_numpy(rng.randn(*b.shape).astype(np.float32)))
          for w, b in ours]
    jref = jfm.unfactor_mask_grads([{"w": jnp.asarray(w.numpy().T), "b": jnp.asarray(b.numpy())} for w, b in dl],
                                   jnp.asarray(table))
    for (w, b), jl in zip(tfm.unfactor_mask_grads(dl, torch.from_numpy(table)), jref["mlp"]):
        np.testing.assert_allclose(w.numpy().T, np.asarray(jl["w"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(b.numpy(), np.asarray(jl["b"]))


@pytest.mark.parametrize("single", [False, True])
def test_params_round_trip_implicit(single):
    jcfg, tcfg = icfg(build_single_masks=single)
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp)
    assert g.view_embedding.shape == (8, 128) and not g.view_embedding.requires_grad
    back = params_to_jax(g.state_dict())
    assert set(back) == set(jp)
    np.testing.assert_array_equal(back["view_embedding"], jp["view_embedding"])
    for a, b in zip(back["implicit_mask"]["mlp"], jp["implicit_mask"]["mlp"]):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])
    assert set(params_from_jax(back)) == set(g.state_dict())


@pytest.mark.parametrize("use_edges,single", [(True, False), (False, False), (True, True)])
def test_graph_loss_and_grads_match_jax(rng, use_edges, single):
    jcfg, tcfg = icfg(use_edges=use_edges, build_single_masks=single, alpha_initial=0.3)
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp)
    data = implicit_data(jcfg, rng)
    jdata, tdata = to_jax(data), to_torch(data)
    step = 7

    def jloss(params):
        out = jplanar.graph_forward(params, jdata, jcfg, jnp.float32(step / jcfg.max_iter))
        loss = jplanar.graph_loss(out, jdata, jcfg, jnp.int32(step))
        return jsum(loss, jcfg.loss_weight), loss

    (jtotal, jterms), jgrads = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, jp))
    out = tplanar.graph_forward(g, tdata, tcfg, torch.tensor(step / tcfg.max_iter, dtype=torch.float32))
    terms = tplanar.graph_loss(out, tdata, tcfg, torch.tensor(step))
    tsum(terms, tcfg.loss_weight).backward()
    for k in jterms:
        np.testing.assert_allclose(terms[k].detach().numpy(), np.asarray(jterms[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    ours = params_to_jax({k: p.grad for k, p in g.named_parameters() if p.grad is not None} | {"view_embedding": g.view_embedding})
    assert rel_err(g.warp.grad.numpy(), jgrads["warp"]) <= 1e-4
    for sub in ("neural_image", "implicit_mask"):
        for a, b in zip(ours[sub]["mlp"], jgrads[sub]["mlp"]):
            assert rel_err(a["w"], b["w"]) <= 1e-4, sub
            assert rel_err(a["b"], b["b"]) <= 1e-4, sub


def dedup_inputs(jcfg, jp, data):
    """marf_tpu's padded dedup inputs (slot_dedup_padded_inputs) and the
    port's unpadded ones, from the same factoring."""
    uv, onehot, table = jfm.factor_mask_inputs(jnp.asarray(jp["view_embedding"]), jnp.asarray(data["rgb"]), grid_of(jcfg))
    dd = jfm.slot_dedup_padded_inputs(np.asarray(uv), np.asarray(onehot), jcfg.arch)
    X, s0, ext_pix, extmap, cnt = tfm.slot_dedup_inputs(np.asarray(uv), np.asarray(onehot))
    return dd, np.asarray(table), (X, s0, ext_pix, extmap, cnt)


def test_mask_kernels_plain_match_pallas(rng):
    """K3's and K4's plain versions against fused_mask_forward and
    fused_mask_backward_dedup (interpret mode), edges on and off."""
    jcfg, tcfg = icfg()
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp)
    dd, table, (X, s0, _, _, cnt) = dedup_inputs(jcfg, jp, implicit_data(jcfg, rng))
    B, HW = s0.shape
    K, Kp = X.shape[1], dd["mask_Xall"].shape[1]
    jstack = jfm.mask_w_stack(jax.tree.map(jnp.asarray, jp["implicit_mask"]), jnp.asarray(table))
    stack = tfm.mask_w_stack(g.implicit_mask, torch.from_numpy(table))
    t = torch.from_numpy

    m_ref = np.asarray(jfm.fused_mask_forward(jstack, jnp.asarray(X)))
    m = tfm.fused_mask_forward(stack, t(X))
    assert m.shape == (1, K)
    np.testing.assert_allclose(m.numpy(), m_ref, rtol=1e-5, atol=1e-7)

    sq = np.abs(rng.randn(B, HW)).astype(np.float32)
    esq = np.abs(rng.randn(B, HW)).astype(np.float32)
    base = (0.01 * cnt + rng.rand(1, K) * 0.1).astype(np.float32)
    abk = np.array([0.7, 0.3, -0.05], np.float32)
    pad = lambda a: np.pad(a, ((0, 0), (0, Kp - a.shape[1])))
    for e in (esq, None):
        ref = jfm.fused_mask_backward_dedup(
            jstack, jnp.asarray(dd["mask_Xall"]), jnp.asarray(dd["mask_slot0map_p"]), jnp.asarray(pad(sq)),
            None if e is None else jnp.asarray(pad(e)), jnp.asarray(pad(base)), jnp.asarray(dd["mask_cntall"]),
            jnp.asarray(abk),
        )
        ours = tfm.fused_mask_backward_dedup(stack, t(X), t(s0), t(sq), None if e is None else t(e), t(base), t(cnt), t(abk))
        for (dw, db), jl in zip(ours, ref):
            assert rel_err(dw.numpy().T, jl["w"]) <= 1e-4
            assert rel_err(db.numpy(), jl["b"]) <= 1e-4


def jax_trajectory(jcfg, jp, data, n, dedup=True):
    jdata = to_jax(data)
    if dedup:
        dd, table, _ = dedup_inputs(jcfg, jp, data)
        jdata.update(mask_table=jnp.asarray(table), **{k: jnp.asarray(v) for k, v in dd.items()})
    tx = jstep.make_optimizer(OPTIM, jcfg.max_iter)
    state = jstep.init_train_state(jax.tree.map(jnp.asarray, jp), tx)
    return jstep.make_train_chunk(jstep.make_train_step(jcfg, tx), n, donate=False)(state, jdata)


def port_trajectory(tcfg, jp, data, n):
    g = port_graph(tcfg, jp)
    opt, _ = make_optimizer(g, OPTIM, tcfg.max_iter)
    return g, run_chunk(make_train_step(tcfg, g, opt, to_torch(data)), 0, n)


def assert_same_trajectory(m_ours, m_ref, p_ours, p_ref, use_edges):
    keys = ["all", "loss_rgb", "loss_mask", "loss_render", "PSNR"] + (["loss_edge"] if use_edges else [])
    for k in keys:
        np.testing.assert_allclose(np.asarray(m_ours[k]), np.asarray(m_ref[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(p_ours["warp"], np.asarray(p_ref["warp"]), rtol=1e-3, atol=1e-6)
    for a, b in zip(p_ours["neural_image"]["mlp"], p_ref["neural_image"]["mlp"]):
        np.testing.assert_allclose(a["w"], np.asarray(b["w"]), rtol=1e-3, atol=1e-6)
    for li, (a, b) in enumerate(zip(p_ours["implicit_mask"]["mlp"], p_ref["implicit_mask"]["mlp"])):
        np.testing.assert_allclose(a["w"], np.asarray(b["w"]), rtol=1e-3, atol=5e-4, err_msg=f"mask head layer {li}")


@pytest.mark.parametrize("use_edges,fused_warp", [(True, "on"), (False, "on"), (True, "off")], ids=["edges_K1", "no_edges_K1", "edges_K2"])
def test_dedup_trajectory_matches_jax(rng, use_edges, fused_warp):
    """3 fused dedup steps of the port (plain K3 -> K1/K2 -> K4) against
    marf_tpu's dedup step (its Pallas kernels in interpret mode)."""
    jcfg, tcfg = icfg(use_edges=use_edges, alpha_initial=0.3, fused_step="on", fused_warp=fused_warp)
    jp = jax_params(jcfg)
    data = implicit_data(jcfg, rng)
    if not use_edges:
        data["edges"] = None
    jstate, jm = jax_trajectory(jcfg, jp, data, 3)
    g, tm = port_trajectory(tcfg, jp, data, 3)
    assert tm["finite"].all()
    assert_same_trajectory(tm, jm, params_to_jax(g.state_dict()), jstate.params, use_edges)


@pytest.mark.parametrize("use_edges", [True, False])
def test_dedup_trajectory_matches_port_autograd(rng, use_edges):
    _, on = icfg(use_edges=use_edges, alpha_initial=0.3, fused_step="on")
    jcfg, off = icfg(use_edges=use_edges, alpha_initial=0.3, fused_step="off")
    jp = jax_params(jcfg)
    data = implicit_data(jcfg, rng)
    if not use_edges:
        data["edges"] = None
    g_on, m_on = port_trajectory(on, jp, data, 3)
    g_off, m_off = port_trajectory(off, jp, data, 3)
    p_off = params_to_jax(g_off.state_dict())
    assert_same_trajectory(m_on, m_off, params_to_jax(g_on.state_dict()), p_off, use_edges)


def one_step_grads(tcfg, jp, data):
    """One fused step of the port: its metrics and the gradients the
    optimizer stepped on."""
    g = port_graph(tcfg, jp)
    opt, _ = make_optimizer(g, OPTIM, tcfg.max_iter)
    grads, adam_step = {}, opt.step

    def step(*args, **kwargs):
        grads.update({n: p.grad.clone() for n, p in g.named_parameters() if p.grad is not None})
        return adam_step(*args, **kwargs)

    opt.step = step
    return make_train_step(tcfg, g, opt, to_torch(data))(), grads


@pytest.mark.parametrize("use_edges", [True, False])
def test_padded_dedup_columns_are_inert(rng, monkeypatch, use_edges):
    """The dedup columns padded with zero columns (X = 0, cnt = 0, so base
    = 0) to a multiple of 4, K3's m cut back to K: the fused dedup step's
    losses and gradients equal the unpadded step's, to the rounding of the
    plain version's sums (a matrix product over 1,348 columns is blocked
    otherwise than one over 1,346: 2e-11 at most on dW0 here, relative to
    the max-abs <= 1e-6)."""
    from marf_tpu_torch.engine import step as tstep

    jcfg, tcfg = icfg(use_edges=use_edges, alpha_initial=0.3, fused_step="on")
    jp = jax_params(jcfg)
    data = implicit_data(jcfg, rng)
    if not use_edges:
        data["edges"] = None
    X_all = tstep.stage_mask_inputs(port_graph(tcfg, jp), torch.from_numpy(data["rgb"]))[0]
    m_pad, g_pad = one_step_grads(tcfg, jp, data)
    monkeypatch.setattr(tstep, "DEDUP_COLUMN_MULTIPLE", 1)
    X = tstep.stage_mask_inputs(port_graph(tcfg, jp), torch.from_numpy(data["rgb"]))[0]
    assert X.shape[1] % 4 and X_all.shape[1] == X.shape[1] + (-X.shape[1] % 4)
    assert not X_all[:, X.shape[1]:].any() and torch.equal(X_all[:, : X.shape[1]], X)
    m, g = one_step_grads(tcfg, jp, data)
    for k in ("all", "loss_rgb", "loss_mask", "loss_render", "loss_edge"):
        np.testing.assert_allclose(m_pad[k].numpy(), m[k].numpy(), rtol=1e-6, atol=0, err_msg=k)
    assert set(g_pad) == set(g) and any(k.startswith("implicit_mask") for k in g)
    for k in g:
        assert rel_err(g_pad[k].numpy(), g[k].numpy()) <= 1e-6, k


@pytest.mark.parametrize("mode", ["on", "off"])
def test_mask_error_matches_jax(rng, mode):
    """use_masks + implicit: Mask_Error of the pre-update mask, fused and
    autograd, against marf_tpu's."""
    jcfg, tcfg = icfg(use_masks=True, fused_step=mode)
    jp = jax_params(jcfg)
    data = implicit_data(jcfg, rng)
    _, jm = jax_trajectory(jcfg, jp, data, 2, dedup=mode == "on")
    _, tm = port_trajectory(tcfg, jp, data, 2)
    np.testing.assert_allclose(tm["Mask_Error"], np.asarray(jm["Mask_Error"]), rtol=1e-5, atol=1e-7)
    assert (tm["Mask_Error"] > 0).all()


def test_implicit_gating(capsys):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    on = lambda **kw: icfg(fused_step="on", **kw)[1]
    auto = lambda **kw: icfg(fused_step="auto", **kw)[1]
    assert tplanar.use_fused_implicit(on(), cpu) and not tplanar.use_fused_step(on(), cpu)
    assert tplanar.use_fused_implicit(on(fused_warp="off"), cpu)
    assert not tplanar.use_fused_implicit(auto(), cpu) and tplanar.use_fused_implicit(auto(), cuda)
    # per-image heads and the shared head without dedup run K5 -> K6
    for kw in ({"build_single_masks": True}, {"fused_dedup": "off"}):
        assert tplanar.use_fused_implicit(on(**kw), cpu) and tplanar.use_fused_implicit(auto(**kw), cuda)
        assert not tplanar.use_fused_dedup(auto(**kw), cuda)
    assert tplanar.use_fused_dedup(auto(), cuda)
    for kw, word in (({"build_single_masks": True, "train_view_embedding": True}, "frozen"),
                     ({"fused_dedup": "off", "mask_quantize_levels": 256}, "quantization"),
                     ({"train_view_embedding": True}, "frozen"), ({"mask_quantize_levels": 256}, "quantization")):
        with pytest.raises(NotImplementedError, match=word):
            tplanar.use_fused_implicit(on(**kw), cpu)
        capsys.readouterr()
        assert not tplanar.use_fused_implicit(auto(**kw), cuda)
        assert word in capsys.readouterr().out


def test_optimizer_groups_implicit():
    _, tcfg = icfg()
    g = tplanar.Graph(tcfg)
    opt, _ = make_optimizer(g, dict(OPTIM, lr_mask=5e-4), tcfg.max_iter)
    assert [grp["lr"] for grp in opt.param_groups] == [1e-3, 1e-3, 5e-4]
    assert not any(p is g.view_embedding for grp in opt.param_groups for p in grp["params"])
    _, tv = icfg(train_view_embedding=True)
    gv = tplanar.Graph(tv)
    opt, _ = make_optimizer(gv, OPTIM, tv.max_iter)
    # the view embedding trains in a group of its own (marf_tpu's "frozen"),
    # after the mask head's
    assert opt.param_groups[2]["params"] == list(gv.implicit_mask.parameters())
    assert len(opt.param_groups) == 4 and opt.param_groups[3]["params"] == [gv.view_embedding]


def _opt_pair(optim: dict, **kw):
    """The port's optimizer on a small implicit-mask graph and marf_tpu's on
    zero parameters of the same shapes (the view embedding where it trains),
    with every parameter the port's optimizer holds set to 0."""
    _, tcfg = icfg(**kw)
    g = tplanar.Graph(tcfg)
    opt, sched = make_optimizer(g, optim, tcfg.max_iter)
    with torch.no_grad():
        for grp in opt.param_groups:
            for p in grp["params"]:
                p.zero_()
    named = {"neural_image": g.neural_image.layers[0].weight, "warp": g.warp,
             "implicit_mask": g.implicit_mask.layers[0].weight}
    if g.view_embedding.requires_grad:
        named["view_embedding"] = g.view_embedding
    jopt = jstep.make_optimizer(optim, tcfg.max_iter)
    jparams = {k: jnp.zeros(tuple(p.shape), jnp.float32) for k, p in named.items()}
    return opt, sched, named, jopt, jparams


def _unit_steps(opt, sched, named, jopt, jparams, n):
    """n Adam steps on unit gradients in both packages; yields each step's
    parameters, {name: (port, marf_tpu)}."""
    import optax

    state = jopt.init(jparams)
    ones = jax.tree.map(jnp.ones_like, jparams)
    for _ in range(n):
        for grp in opt.param_groups:
            for p in grp["params"]:
                p.grad = torch.ones_like(p)
        opt.step()
        if sched is not None:
            sched.step()
        upd, state = jopt.update(ones, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        yield {k: (p.detach().numpy().copy(), np.asarray(jparams[k])) for k, p in named.items()}


def test_view_embedding_lr_stays_constant_under_a_schedule():
    """With optim.train_view_embedding and an applied StepLR (steps=2,
    gamma=0.1), the view embedding keeps lr_mask on every step while the
    mask head's decays, as in marf_tpu: 5 Adam steps on unit gradients give
    optax's parameters."""
    optim = dict(OPTIM, lr_mask=5e-4, sched={"type": "StepLR", "steps": 2, "gamma": 0.1}, apply_sched=True,
                 train_view_embedding=True)
    steps = list(_unit_steps(*_opt_pair(optim, train_view_embedding=True), 5))
    for params in steps:
        for ours, theirs in params.values():
            # float32 rounding of Adam's bias corrections differs between
            # the two frameworks by up to 6.5e-6 of the step
            np.testing.assert_allclose(ours, theirs, rtol=2e-5, atol=0)
    # the embedding moved by lr_mask on each step (Adam's unit-gradient step is lr)
    emb = [params["view_embedding"][0].ravel()[0] for params in steps]
    np.testing.assert_allclose(np.diff(emb, prepend=0.0), -5e-4, rtol=1e-4)


@pytest.mark.parametrize("key,group", [("lr_warp", "warp"), ("lr_mask", "implicit_mask")])
def test_zero_learning_rate_freezes_its_group(key, group):
    """optim.lr_warp=0 or optim.lr_mask=0 leaves that group's parameters
    unchanged by a step, as marf_tpu's optimizer does (0 is not replaced by
    optim.lr); the other groups move as in marf_tpu."""
    (params,) = _unit_steps(*_opt_pair(dict(OPTIM, **{key: 0.0})), 1)
    assert not params[group][0].any() and not params[group][1].any()
    for ours, theirs in params.values():
        np.testing.assert_allclose(ours, theirs, rtol=2e-5, atol=0)
    assert params["neural_image"][0].all()


def test_model_trains_implicit_on_cpu(tmp_path, monkeypatch):
    from marf_tpu_torch.train import main
    from test_torch_trainer import TINY

    monkeypatch.setenv("MARF_YES", "1")
    m = main(["--model=planar", "--yaml=planar", "--cpu", f"--output_root={tmp_path}", "--max_iter=12",
              "--freq.scalar=4", "--freq.vis=4", "--tpu.fused_step=on", "--use_implicit_mask", "--use_masks=false",
              "--N_vocab=8", *TINY])
    assert m.it == 12 and m.device.type == "cpu"
    loss = np.concatenate([h["all"] for h in m.history])
    assert np.isfinite(loss).all() and loss[-1] < loss[0]
    assert np.concatenate([h["loss_mask"] for h in m.history]).min() > 0
