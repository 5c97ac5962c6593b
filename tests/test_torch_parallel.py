"""The port's multi-device training (marf_tpu_torch/parallel/) against
marf_tpu's shard_map mesh step on the CPU.

Two gloo ranks on the CPU run the sharded steps; marf_tpu runs its
`make_fused_sharded_setup` on `make_mesh(2)` of the 8 virtual CPU devices
(its Pallas kernels in interpret mode, as tests/test_parallel.py runs them),
from the same parameters (utils/params.py). Sizes are test_parallel.py's
`mesh_cfg`: 48x64 canvas, 24x32 patches, B = 3 (4 for per-image heads), the
32-wide MLP, posenc L = 4. Tolerances are marf_tpu's own for its mesh:
metrics rtol 2e-5 / atol 1e-7, warp and MLP weights rtol 2e-4 / atol 2e-6,
the mask head by test_parallel.py's mismatch-fraction rule (Adam's first
steps turn reordering noise on near-zero gradients into lr-sized moves):
against the port's own 1-rank step on the weights after 2 steps, against
marf_tpu on the first step's gradients (`grads_agree`: Adam's first step
would turn a single ReLU gate that float32 cannot sign into lr-sized moves
of the weights below it). All sharded cases run in one spawn of the two
ranks (a module fixture), and every spawn carries a timeout.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marf_tpu.engine import step as jstep
from marf_tpu.ops.grid import normalized_pixel_grid as jgrid
from marf_tpu.ops.pallas import fused_mask as jfm
from marf_tpu.parallel import mesh as jmesh
from marf_tpu.parallel import shard_fused as jsf
from marf_tpu_torch.engine.step import make_optimizer, make_train_step, run_chunk
from marf_tpu_torch.ops.cuda import fused_mask as tfm
from marf_tpu_torch.parallel import launch
from marf_tpu_torch.parallel import shard_fused as tsf
from marf_tpu_torch.train import main
from marf_tpu_torch.utils.params import params_from_jax, params_to_jax
from parallel_rank_bodies import fail_on_rank_1
from test_torch_models import cfg_pair, fake_data, jax_params, port_graph, to_jax, to_torch
from test_torch_trainer import TINY

OPTIM = {"lr": 1e-3, "lr_warp": 1e-3, "lr_mask": 1e-3, "algo": "Adam"}
MESH = dict(H=48, W=64, patch_H=24, patch_W=32, batch_size=3, max_iter=100)
MESH_ARCH = dict(layers=(None, 32, 32, 3), posenc_L=4, barf_c2f=(0.0, 0.4))
SPAWN_TIMEOUT_S = 120.0
CPU = torch.device("cpu")
IMPLICIT = dict(use_implicit_mask=True, use_masks=True, alpha_initial=0.3, N_vocab=16, fused_step="on")
# the sharded cases: (id, config overrides, saturated rgb for extra dedup columns)
CASES = [
    ("fixed_K1", dict(fused_step="on", fused_warp="on"), False),
    ("fixed_K2", dict(fused_step="on", fused_warp="off"), False),
    ("dedup_edges", dict(IMPLICIT, fused_dedup="on"), True),
    ("dedup_no_edges", dict(IMPLICIT, fused_dedup="on", use_edges=False), True),
    ("dedup_off", dict(IMPLICIT, fused_dedup="off"), False),
    ("heads", dict(IMPLICIT, build_single_masks=True, batch_size=4), False),
]


def mesh_pair(**kw):
    return cfg_pair(arch=MESH_ARCH, **dict(MESH, **kw))


def case_inputs(kw, saturate):
    jcfg, tcfg = mesh_pair(**kw)
    rng = np.random.RandomState(0)
    data = fake_data(jcfg, rng)
    if saturate:
        data["rgb"] = np.where(rng.rand(*data["rgb"].shape) > 0.5, 1.0, data["rgb"]).astype(np.float32)
    if not jcfg.use_edges:
        data["edges"] = None
    return jcfg, tcfg, jax_params(jcfg), data


@pytest.fixture(scope="module")
def sharded_runs():
    """Every case, 2 sharded steps on 2 gloo ranks, in one spawn: per case
    (rank 0's metrics, rank 0's and rank 1's final state_dicts, rank 0's
    first-step gradients)."""
    calls = []
    for _, kw, sat in CASES:
        _, tcfg, jp, data = case_inputs(kw, sat)
        calls.append((tsf.train_steps, (tcfg, params_from_jax(jp), data, 2, OPTIM)))
    out = launch.spawn(launch.run_each, 2, (calls,), cpu=True, timeout_s=SPAWN_TIMEOUT_S)
    return {cid: (out[0][i][0], out[0][i][1], out[1][i][1], out[0][i][2]) for i, (cid, _, _) in enumerate(CASES)}


# ------------------------------------------------------------ mesh and gating


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kw", [
    {}, dict(fused_warp="off"), dict(batch_size=9), dict(H=60, W=64, patch_H=30, patch_W=32),
    dict(H=30, W=62, patch_H=15, patch_W=31), dict(IMPLICIT), dict(IMPLICIT, fused_dedup="off"),
    dict(IMPLICIT, build_single_masks=True), dict(IMPLICIT, build_single_masks=True, batch_size=4),
    dict(fused_step="off"),
], ids=["fixed", "K2", "B9", "h30", "odd", "dedup", "dedup_off", "heads_B3", "heads_B4", "fused_off"])
def test_fused_shardable_matches_jax(kw, n):
    jcfg, tcfg = mesh_pair(**dict(dict(fused_step="on"), **kw))
    assert tsf.fused_shardable(tcfg, n, CPU) == jsf.fused_shardable(jcfg, n)


@pytest.mark.parametrize("n_devices", [2, 3, 4])
def test_slot_dedup_sharded_inputs_match_jax(n_devices):
    """marf_tpu's arrays bitwise on its K_pad columns; the port's extra pad
    columns (K_pad to a multiple of 4 D) are zero. At B = 3, D = 2 and 4
    start a block inside an image (Nl = B HW / D is no multiple of HW)."""
    jcfg, _, jp, data = case_inputs(dict(IMPLICIT), True)
    uv, onehot, _ = jfm.factor_mask_inputs(jnp.asarray(jp["view_embedding"]), jnp.asarray(data["rgb"]),
                                           jgrid(jcfg.grid_spec, crop=jcfg.use_cropped_images))
    uv, onehot = np.asarray(uv), np.asarray(onehot)
    ref = jfm.slot_dedup_sharded_inputs(uv, onehot, n_devices)
    ours = tfm.slot_dedup_sharded_inputs(uv, onehot, n_devices)
    names = ("X_pad", "slot0map_flat", "cnt_pad", "ext_off", "ext_col", "ext_val")
    for name, a, b in zip(names, ours, ref):
        assert a.dtype == b.dtype, name
        if name in ("X_pad", "cnt_pad"):
            k = b.shape[1]
            assert a.shape[1] % (4 * n_devices) == 0 and a.shape[1] >= k, name
            np.testing.assert_array_equal(a[:, :k], b, err_msg=name)
            assert not a[:, k:].any(), name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours[5].sum() > 0  # extras occur
    B, HW = onehot.shape[0], onehot.shape[2]
    assert ((B * HW // n_devices) % HW != 0) == (n_devices != 3)


# -------------------------------------------------- sharded steps vs marf_tpu


def assert_close(m_ours, m_ref, p_ours, p_ref, keys, mask_head):
    """The mesh tolerances on the metrics and the weights after the run;
    with mask_head, its weights by test_parallel.py's mismatch-fraction
    rule."""
    for k in keys:
        np.testing.assert_allclose(np.asarray(m_ours[k]), np.asarray(m_ref[k]), rtol=2e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(p_ours["warp"], np.asarray(p_ref["warp"]), rtol=2e-4, atol=2e-6)
    for li, (a, b) in enumerate(zip(p_ours["neural_image"]["mlp"], p_ref["neural_image"]["mlp"])):
        np.testing.assert_allclose(a["w"], np.asarray(b["w"]), rtol=2e-4, atol=2e-6, err_msg=f"layer {li}")
    if mask_head:
        for li, (a, b) in enumerate(zip(p_ours["implicit_mask"]["mlp"], p_ref["implicit_mask"]["mlp"])):
            a, b = np.asarray(a["w"]), np.asarray(b["w"])
            bad = np.abs(a - b) > (2e-4 * np.abs(b) + 2e-6)
            assert bad.mean() < 5e-3, f"mask head layer {li}: {bad.sum()}/{bad.size} mismatches"
            assert np.abs(a - b).max() < 3e-3, f"mask head layer {li}: max {np.abs(a - b).max()}"


def grads_agree(ours: dict, ref: dict, what: str):
    """The mask head's first-step gradients by test_parallel.py's
    mismatch-fraction rule, its atol taken relative to each tensor's max-abs
    gradient (2e-5 of it) and its max bound likewise (1e-4): a ReLU gate
    whose pre-activation float32 cannot sign opens in one framework and not
    the other (on the saturated dedup data, layer 2's unit 17 at one column
    sits 2e-8 of its terms' magnitude below 0 in float64) and moves the
    gradients of its unit and the layers below it by up to ~4e-5 of their
    max-abs at a few entries."""
    for li, (a, b) in enumerate(zip(ours["implicit_mask"]["mlp"], ref["implicit_mask"]["mlp"])):
        for k in ("w", "b"):
            x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
            scale = np.abs(y).max()
            bad = np.abs(x - y) > 2e-4 * np.abs(y) + 2e-5 * scale
            tag = f"{what}: mask head layer {li} d{k}"
            assert bad.mean() < 5e-3, f"{tag}: {bad.sum()}/{bad.size} mismatches"
            assert np.abs(x - y).max() < 1e-4 * scale, f"{tag}: max {np.abs(x - y).max() / scale:.2e} of the max-abs"


def capture_first_grads(tx):
    """tx that also keeps the first update's gradients in its state, [1]."""

    def init(params):
        return jnp.zeros((), jnp.int32), jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        n, first, inner = state
        first = jax.tree.map(lambda f, g: jnp.where(n == 0, g, f), first, grads)
        updates, inner = tx.update(grads, inner, params)
        return updates, (n + 1, first, inner)

    return optax.GradientTransformation(init, update)


def grads_to_jax(grads: dict, state_dict: dict) -> dict:
    """Per-parameter gradients of a Graph -> marf_tpu's params tree."""
    return params_to_jax(dict(grads, **{k: v for k, v in state_dict.items() if k not in grads}))


@pytest.mark.parametrize("cid,kw,saturate", CASES, ids=[c[0] for c in CASES])
def test_sharded_step_matches_jax_mesh_and_one_rank(sharded_runs, cid, kw, saturate):
    """2 steps on 2 ranks against marf_tpu's shard_map step on a 2-device
    mesh and against the port's one-rank step; the two ranks' parameters
    and Adam state end bitwise equal. The mask head's first-step gradients
    are held to both by `grads_agree`, its weights after the run to the
    one-rank step's (against marf_tpu's, Adam's first steps amplify the
    gate that float32 cannot sign, see `grads_agree`)."""
    jcfg, tcfg, jp, data = case_inputs(kw, saturate)
    m2, sd0, sd1, g2 = sharded_runs[cid]
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0), "the ranks' parameters differ"
    tx = capture_first_grads(jstep.make_optimizer(OPTIM, jcfg.max_iter))
    state, sharded, chunk = jsf.make_fused_sharded_setup(jcfg, tx, jmesh.make_mesh(2), to_jax(data),
                                                         jax.tree.map(jnp.asarray, jp), n_steps=2, donate=False)
    jstate, jm = chunk(state, sharded)
    g = port_graph(tcfg, jp)
    opt, _ = make_optimizer(g, OPTIM, tcfg.max_iter)
    step_fn = make_train_step(tcfg, g, opt, to_torch(data))
    first = run_chunk(step_fn, 0, 1)
    g1 = {n: p.grad.clone() for n, p in g.named_parameters() if p.grad is not None}
    m1 = {k: np.concatenate([first[k], v]) for k, v in run_chunk(step_fn, 1, 1).items()}
    implicit = bool(kw.get("use_implicit_mask"))
    keys = ["all", "loss_rgb", "PSNR", "Homography_Error"]
    keys += ["loss_mask", "Mask_Error"] if implicit else []
    keys += ["loss_edge"] if tcfg.use_edges else []
    assert m2["finite"].all()
    p2 = params_to_jax(sd0)
    assert_close(m2, jm, p2, jstate.params, keys, False)
    assert_close(m2, m1, p2, params_to_jax(g.state_dict()), keys, implicit)
    if implicit:
        g2 = grads_to_jax(g2, sd0)
        grads_agree(g2, jstate.opt_state[1], "2 ranks vs marf_tpu's mesh")
        grads_agree(g2, grads_to_jax(g1, sd0), "2 ranks vs 1 rank")


@pytest.mark.parametrize("n_ranks", [1, 2, 3, 4])
def test_stage_mask_inputs_split_the_extras_over_ranks(n_ranks):
    """Each rank's dedup inputs: X and the column counts padded to a multiple
    of 4 per rank, its block of slot0, and its extra (position, column)
    pairs, which over the ranks are the extras of slot_dedup_inputs exactly
    once, each with its image. At B = 3 the blocks of 2 and 4 ranks start
    inside an image."""
    from marf_tpu_torch.engine.step import stage_mask_inputs

    _, tcfg, jp, data = case_inputs(dict(IMPLICIT), True)
    graph = port_graph(tcfg, jp)
    images = torch.from_numpy(data["rgb"])
    uv, onehot, _ = tfm.factor_mask_inputs(graph.view_embedding, images, graph.grid)
    X, slot0map, ext_pix, extmap, cnt = tfm.slot_dedup_inputs(uv.numpy(), onehot.numpy())
    B, HW = slot0map.shape
    Nl = B * HW // n_ranks
    want = {(int(b) * HW + int(ext_pix[j]), int(j)) for b, j in zip(*np.nonzero(extmap))}
    got = []
    for r in range(n_ranks):
        X_all, cnt_all, s0, off, img, j, _, K = stage_mask_inputs(graph, images, n_ranks, r)
        assert K == X.shape[1] and X_all.shape[1] % (4 * n_ranks) == 0
        np.testing.assert_array_equal(X_all[:, :K].numpy(), X)
        np.testing.assert_array_equal(cnt_all[:, :K].numpy(), cnt)
        assert not X_all[:, K:].any() and not cnt_all[:, K:].any()
        np.testing.assert_array_equal(s0.numpy(), slot0map.reshape(1, -1)[:, r * Nl : (r + 1) * Nl])
        pos = off + r * Nl
        assert ((off >= 0) & (off < Nl)).all() and torch.equal(img, pos // HW)
        got += [(int(p), int(c)) for p, c in zip(pos, j)]
    assert len(got) == len(want) and set(got) == want and want


def test_unshardable_configs_raise(tmp_path):
    """Per-image heads with B % D != 0 and the autograd step cannot shard:
    they raise NotImplementedError naming the ROADMAP item (marf_tpu falls
    back to its GSPMD step, not ported)."""
    _, heads = mesh_pair(**dict(IMPLICIT, build_single_masks=True))
    _, off = mesh_pair(fused_step="off")
    for cfg in (heads, off):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsf.check_shardable(cfg, 2, CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--model=planar", "--yaml=planar", "--cpu", f"--output_root={tmp_path}", "--max_iter=2",
              "--tpu.n_devices=2", "--tpu.fused_step=on",
              "--use_implicit_mask", "--build_single_masks", "--N_vocab=8", *TINY])


def test_more_ranks_than_cards_raise(monkeypatch):
    """On CUDA the launcher needs a card per rank, unless the ranks share one
    (share_device); without a card it raises before it starts a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA cards, 1 visible"):
        launch.spawn(launch.run_each, 2, ([],), timeout_s=SPAWN_TIMEOUT_S)
    launch.check_cards(2, share_device=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.check_cards(1, share_device=True)


def test_failing_rank_stops_the_launcher():
    """Rank 1 raises at once while rank 0 waits in its first collective: the
    launcher stops rank 0 and raises, well inside its timeout."""
    import time

    _, tcfg, jp, data = case_inputs(dict(fused_step="on"), False)
    calls = [(fail_on_rank_1, ()), (tsf.train_steps, (tcfg, params_from_jax(jp), data, 2, OPTIM))]
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="a rank failed"):
        launch.spawn(launch.run_each, 2, (calls,), cpu=True, timeout_s=SPAWN_TIMEOUT_S)
    assert time.monotonic() - t < SPAWN_TIMEOUT_S / 2


# ------------------------------------------------------- the CLI on 2 ranks


def run_args(root, name, iters, *extra):
    return ["--model=planar", "--yaml=planar", "--cpu", f"--output_root={root}", f"--name={name}",
            f"--max_iter={iters}", "--freq.scalar=10", "--freq.vis=10", "--freq.ckpt=10", "--tpu.fused_step=on",
            *[a for a in TINY if not (a == "--tb=" and any(e.startswith("--tb.") for e in extra))], *extra]


def history(hist) -> dict:
    return {k: np.concatenate([h[k] for h in hist]) for k in hist[0]}


def test_train_main_two_ranks(tmp_path, monkeypatch, request):
    """`train.main --cpu --tpu.n_devices=2`: 20 steps within the mesh
    tolerance of one rank, replicas bitwise equal; rank 0 alone wrote the
    events, frames and checkpoints; a resume from ckpt/10 on 2 ranks
    (MARF_DEVICES=2) bitwise the unbroken 2-rank run (both under
    torch.use_deterministic_algorithms), and on 1 rank within the
    tolerance."""
    monkeypatch.setenv("MARF_YES", "1")
    kw = dict(timeout_s=SPAWN_TIMEOUT_S)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)  # the ranks take it from here
    request.addfinalizer(lambda: torch.use_deterministic_algorithms(before))
    two = main(run_args(tmp_path, "two", 20, "--tpu.n_devices=2", "--tb.num_images=[2,2]"), **kw)
    one = main(run_args(tmp_path, "one", 20))
    assert [r["rank"] for r in two] == [0, 1] and two[0]["digest"] == two[1]["digest"]
    h2, h1 = history(two[0]["history"]), history(one.history)
    for k in ("all", "loss_rgb", "loss_edge", "PSNR", "Homography_Error"):
        np.testing.assert_allclose(h2[k], h1[k], rtol=2e-5, atol=1e-7, err_msg=k)
    run = two[0]["output_path"]
    assert sorted(os.listdir(run)) == sorted(["ckpt", "options.yaml", "vis", "vis.mp4",
                                              *[f for f in os.listdir(run) if f.startswith("events.")]])
    assert len([f for f in os.listdir(run) if f.startswith("events.")]) == 1
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["10", "20"]
    assert sorted(os.listdir(os.path.join(run, "vis"))) == ["0.png", "1.png", "2.png"]

    # resume the 2-rank run from its ckpt/10, on 2 ranks and on 1
    for name in ("resume2", "resume1"):
        shutil.copytree(run, os.path.join(os.path.dirname(run), f"{name}_seed3"))
        shutil.rmtree(os.path.join(os.path.dirname(run), f"{name}_seed3", "ckpt", "20"))
    monkeypatch.setenv("MARF_DEVICES", "2")
    r2 = main(run_args(tmp_path, "resume2", 20, "--resume=10"), **kw)
    monkeypatch.delenv("MARF_DEVICES")
    assert r2[0]["digest"] == r2[1]["digest"] == two[0]["digest"]
    hr = history(r2[0]["history"])
    for k in hr:
        np.testing.assert_array_equal(hr[k], h2[k][10:], err_msg=k)
    r1 = main(run_args(tmp_path, "resume1", 20, "--resume=10"))
    h = history(r1.history)
    for k in ("all", "loss_rgb", "PSNR"):
        np.testing.assert_allclose(h[k], h2[k][10:], rtol=2e-5, atol=1e-7, err_msg=k)
