"""The port's multi-device training (marf_tpu_torch/parallel/) against
marf_tpu's mesh steps on the CPU.

Two gloo ranks on the CPU run the sharded steps; marf_tpu runs its
`make_fused_sharded_setup` (the fused paths, its Pallas kernels in
interpret mode, as tests/test_parallel.py runs them) or its
`make_sharded_train_setup` (the GSPMD-partitioned XLA step, against the
port's partitioned autograd step) on `make_mesh(2)` of the 8 virtual CPU
devices, from the same parameters (utils/params.py); four ranks run the
2 x 2 mesh against `make_mesh_2d(2, 2)`. The fused configs whose kernels
marf_tpu's shard_map cannot run (per-image heads at B % 2 != 0, N odd),
and which the port runs all the same, are held to marf_tpu's fused step on
a 1-device mesh. Sizes are test_parallel.py's `mesh_cfg`: 48x64
canvas, 24x32 patches, B = 3 (4 for per-image heads whole per rank), the
32-wide MLP, posenc L = 4. Tolerances are marf_tpu's own for its mesh:
metrics rtol 2e-5 / atol 1e-7, warp and MLP weights rtol 2e-4 / atol 2e-6,
the mask head by test_parallel.py's mismatch-fraction rule (Adam's first
steps turn reordering noise on near-zero gradients into lr-sized moves):
against the port's own 1-rank step on the weights after 2 steps, against
marf_tpu on the first step's gradients (`grads_agree`: Adam's first step
would turn a single ReLU gate that float32 cannot sign into lr-sized moves
of the weights below it). All 2-rank cases, and two trainer runs, run in
one spawn of the two ranks (a module fixture), the 2-D mesh in one spawn of
four, and every spawn carries a timeout.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

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
from marf_tpu.parallel import sharded as jsh
from marf_tpu_torch.engine.step import head_spans, make_optimizer, make_train_step, run_chunk, step_path
from marf_tpu_torch.ops.cuda import fused_mask as tfm
from marf_tpu_torch.parallel import launch
from marf_tpu_torch.parallel import sharded as tsh
from marf_tpu_torch.parallel.mesh import Mesh, make_mesh_2d
from marf_tpu_torch.train import main
from marf_tpu_torch.utils.config import parse_arguments, set_opt
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
# an odd map height (the whole 15 x W canvas: a cropped patch takes even sides)
UNCROPPED = dict(H=15, patch_H=8, patch_W=16, use_cropped_images=False)
# the fused cases: (id, config overrides, saturated rgb for extra dedup columns)
CASES = [
    ("fixed_K1", dict(fused_step="on", fused_warp="on"), False),
    ("fixed_K2", dict(fused_step="on", fused_warp="off"), False),
    ("dedup_edges", dict(IMPLICIT, fused_dedup="on"), True),
    ("dedup_no_edges", dict(IMPLICIT, fused_dedup="on", use_edges=False), True),
    ("dedup_off", dict(IMPLICIT, fused_dedup="off"), False),
    ("heads", dict(IMPLICIT, build_single_masks=True, batch_size=4), False),
    ("heads_B3", dict(IMPLICIT, build_single_masks=True), False),  # images 0 | 1, 2 on the ranks
    ("fixed_K1_replicated", dict(fused_step="on", fused_warp="on", **UNCROPPED, W=31), False),  # N odd
]
OFF = dict(fused_step="off")
IMPLICIT_OFF = dict(IMPLICIT, fused_step="off")
# the partitioned autograd step's cases: (id, config overrides); marf_tpu
# shards h where it divides over 2, else w, else keeps the data replicated
AUTOGRAD_CASES = [
    ("fixed", OFF),
    ("shared_head", IMPLICIT_OFF),
    ("heads_B3", dict(IMPLICIT_OFF, build_single_masks=True)),  # B % 2 != 0
    ("view_embedding", dict(IMPLICIT_OFF, train_view_embedding=True)),
    ("quantize_256", dict(IMPLICIT_OFF, mask_quantize_levels=256)),
    ("differentiable_edges", dict(OFF, differentiable_edges=True)),
    ("width_axis", dict(OFF, **UNCROPPED, W=32)),  # h odd: marf_tpu shards w
    ("replicated", dict(OFF, **UNCROPPED, W=31)),  # N = 3 x 15 x 31 odd: replicated
]
# trainer runs on 2 ranks, held to 1 rank of the same flags: (id, flags, the path)
TRAINER_RUNS = [
    ("auto", ("--tpu.fused_step=auto",), "autograd"),  # the fused gate is shut on the CPU
    ("heads_B3_on", ("--tpu.fused_step=on", "--use_implicit_mask", "--build_single_masks", "--N_vocab=8"),
     "fused implicit, per-image heads (K5 -> K6)"),
]
TRAINER_ITERS = 20
# cases run 5 steps, the first as a one-step chunk and the rest as
# make_train_chunk's chunks (of 4, and of 2): (steps, chunk length); the
# others run 2 steps
LONG = {"fixed_K1": (5, None), "autograd_fixed": (5, 2)}


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


def optim_for(kw) -> dict:
    return dict(OPTIM, train_view_embedding=True) if kw.get("train_view_embedding") else OPTIM


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """Every 2-rank case in one spawn: the fused and the autograd cases,
    2 steps of `parallel/sharded.py` `train_steps` each (LONG's 5), and the
    trainer runs (`launch.train_rank`, TRAINER_ITERS steps). Returns {id:
    [rank 0's result, rank 1's]}; the trainer runs' ids are
    "trainer_<id>", and "trainer_root" is their output root."""
    root = str(tmp_path_factory.mktemp("trainer"))
    calls, ids = [], []
    for cid, kw, sat in CASES:
        _, tcfg, jp, data = case_inputs(kw, sat)
        n, chunk = LONG.get(cid, (2, None))
        calls.append((tsh.train_steps, (tcfg, params_from_jax(jp), data, n, OPTIM), {"chunk": chunk}))
        ids.append(cid)
    for cid, kw in AUTOGRAD_CASES:
        _, tcfg, jp, data = case_inputs(kw, False)
        n, chunk = LONG.get(f"autograd_{cid}", (2, None))
        calls.append((tsh.train_steps, (tcfg, params_from_jax(jp), data, n, optim_for(kw)), {"chunk": chunk}))
        ids.append(f"autograd_{cid}")
    for cid, extra, _ in TRAINER_RUNS:
        argv = run_args(root, f"{cid}_2ranks", TRAINER_ITERS, "--tpu.n_devices=2", *extra)
        calls.append((launch.train_rank, (argv, set_opt(parse_arguments(argv), interactive=False))))
        ids.append(f"trainer_{cid}")
    out = launch.spawn(launch.run_each, 2, (calls,), cpu=True, timeout_s=SPAWN_TIMEOUT_S)
    return dict({cid: [out[0][i], out[1][i]] for i, cid in enumerate(ids)}, trainer_root=root)


# ------------------------------------------------------------ mesh and gating


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kw", [
    {}, dict(fused_warp="off"), dict(batch_size=9), dict(H=60, W=64, patch_H=30, patch_W=32),
    dict(H=30, W=62, patch_H=15, patch_W=31), dict(IMPLICIT), dict(IMPLICIT, fused_dedup="off"),
    dict(IMPLICIT, build_single_masks=True), dict(IMPLICIT, build_single_masks=True, batch_size=4),
    dict(fused_step="off"),
], ids=["fixed", "K2", "B9", "h30", "odd", "dedup", "dedup_off", "heads_B3", "heads_B4", "fused_off"])
def test_step_path_on_n_ranks_keeps_the_kernels(kw, n):
    """On n ranks a config takes its own 1-rank path (sharded, the dedup step
    backs the mask head with K6 and column counts where one card runs K4),
    sharded when N = B h w divides over n (fused per-image heads: whole
    images, B >= n), else on the whole axis on every rank. Where marf_tpu's
    trainer runs its fused kernels under shard_map (`fused_shardable`) the
    port shards the same kernels; where its trainer turns them off
    (per-image heads at B % n != 0, N % n != 0), the port keeps them."""
    from marf_tpu.models.planar import use_fused_implicit, use_fused_step

    jcfg, tcfg = mesh_pair(**dict(dict(fused_step="on"), **kw))
    h, w = tcfg.map_hw
    path1, _ = step_path(tcfg, CPU)
    path, sharded = step_path(tcfg, CPU, n)
    by_image = tcfg.build_single_masks and path.startswith("fused")
    assert sharded == (tcfg.batch_size >= n if by_image else tcfg.batch_size * h * w % n == 0)
    assert path == (path1.replace("K4", "K6 with column counts") if sharded else path1)
    assert path.startswith("fused") == (use_fused_step(jcfg) or use_fused_implicit(jcfg))
    if jsf.fused_shardable(jcfg, n):
        assert sharded and path.startswith("fused")


@pytest.mark.parametrize("B,D", [(1, 2), (2, 4), (3, 2), (4, 2), (5, 2), (5, 3), (7, 3)])
def test_head_spans_cover_each_rank_block(B, D):
    """`head_spans` (the partitioned step's per-image heads) on each rank's
    block of B images of HW positions: consecutive heads whose spans tile
    the block in order, each image's positions covered exactly once over
    the ranks, one whole head per span where B % D == 0."""
    HW = 6
    Nl = B * HW // D
    covered = []
    for r in range(D):
        cols = slice(r * Nl, (r + 1) * Nl)
        spans = head_spans(cols, HW)
        assert spans[0][1] == 0 and spans[-1][2] == Nl
        assert all(a[2] == b[1] and b[0] == a[0] + 1 for a, b in zip(spans, spans[1:]))
        for head, lo, hi in spans:
            covered += [(head, n - head * HW) for n in range(cols.start + lo, cols.start + hi)]
            assert B % D or hi - lo == HW
    assert sorted(covered) == [(b, i) for b in range(B) for i in range(HW)]


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
    """2 steps on 2 ranks (LONG: 5, the rest one chunk of 4) against
    marf_tpu's shard_map chunk of as many steps on a 2-device mesh (on 1
    device where its trainer would turn the kernels off: B % 2 != 0, whose
    per-image heads the port splits 1 | 2 images, and N odd) and against
    the port's one-rank step; the chunks eager on the CPU; the two ranks'
    parameters and Adam state end bitwise equal.
    Where marf_tpu runs on 1 device, its mask-head gradients are the
    single-card parity of tests/test_torch_implicit.py, not a mesh's: on
    heads_B3 one ReLU unit of head 1 (layer 1, unit 170) opens differently
    in the two frameworks, for the port's 1 rank as for its 2 ranks, while
    the port's autograd and fused steps agree; so the 2 ranks' gradients
    are held to the port's 1 rank there. The mask head's first-step gradients
    are held to both by `grads_agree`, its weights after the run to the
    one-rank step's (against marf_tpu's, Adam's first steps amplify the
    gate that float32 cannot sign, see `grads_agree`)."""
    jcfg, tcfg, jp, data = case_inputs(kw, saturate)
    r0, r1 = sharded_runs[cid]
    m2, sd0, g2 = r0["metrics"], r0["state_dict"], r0["grads"]
    assert r0["digest"] == r1["digest"], "the ranks' parameters or Adam state differ"
    layout = "replicated on 2 ranks" if cid.endswith("replicated") else "sharded over 2 ranks"
    assert r0["path"] == step_path(tcfg, CPU, 2)[0] and r0["path"].startswith("fused")
    assert r0["layout"].startswith(layout) and r0["mode"] == "eager (gloo)"
    n_steps = len(m2["all"])
    assert n_steps == LONG.get(cid, (2,))[0]
    tx = capture_first_grads(jstep.make_optimizer(OPTIM, jcfg.max_iter))
    n_jax = 2 if jsf.fused_shardable(jcfg, 2) else 1  # marf_tpu's shard_map runs the others on 1 device only
    state, sharded, chunk = jsf.make_fused_sharded_setup(jcfg, tx, jmesh.make_mesh(n_jax), to_jax(data),
                                                         jax.tree.map(jnp.asarray, jp), n_steps=n_steps, donate=False)
    jstate, jm = chunk(state, sharded)
    m1, p1, g1 = one_rank(tcfg, jp, data, OPTIM, n_steps)
    implicit = bool(kw.get("use_implicit_mask"))
    keys = metric_keys(tcfg)
    assert m2["finite"].all()
    p2 = params_to_jax(sd0)
    assert_close(m2, jm, p2, jstate.params, keys, False)
    assert_close(m2, m1, p2, p1, keys, implicit)
    if implicit:
        g2 = grads_to_jax(g2, sd0)
        if n_jax == 2:
            grads_agree(g2, jstate.opt_state[1], "2 ranks vs marf_tpu's mesh")
        grads_agree(g2, grads_to_jax(g1, sd0), "2 ranks vs 1 rank")


def one_rank(tcfg, jp, data, optim, n_steps=2):
    """The port's 1-rank step from marf_tpu's parameters: (metrics, final
    params in marf_tpu's tree, first-step gradients, final state_dict)."""
    g = port_graph(tcfg, jp)
    opt, _ = make_optimizer(g, optim, tcfg.max_iter)
    step_fn = make_train_step(tcfg, g, opt, to_torch(data))
    first = run_chunk(step_fn, 0, 1)
    g1 = {n: p.grad.clone() for n, p in g.named_parameters() if p.grad is not None}
    m1 = {k: np.concatenate([first[k], v]) for k, v in run_chunk(step_fn, 1, n_steps - 1).items()}
    return m1, params_to_jax(g.state_dict()), g1


def metric_keys(tcfg) -> list:
    keys = ["all", "loss_rgb", "PSNR", "Homography_Error"]
    keys += ["loss_mask", "Mask_Error"] if tcfg.use_implicit_mask else []
    return keys + (["loss_edge"] if tcfg.use_edges else [])


def jax_mesh_run(jcfg, jp, data, optim, mesh, n_steps):
    """marf_tpu's GSPMD step (`make_sharded_train_setup`) on `mesh`, a chunk
    of n_steps: (metrics, final state, first-step gradients)."""
    tx = capture_first_grads(jstep.make_optimizer(optim, jcfg.max_iter))
    state, sharded, chunk = jsh.make_sharded_train_setup(jcfg, tx, mesh, to_jax(data), jax.tree.map(jnp.asarray, jp),
                                                         n_steps=n_steps, donate=False)
    jstate, jm = chunk(state, sharded)
    return jm, jstate, jstate.opt_state[1]


def check_autograd_run(ranks, tcfg, jcfg, jp, data, optim, jmesh_, layout):
    """A partitioned autograd run's ranks against marf_tpu's GSPMD chunk of
    as many steps on `jmesh_` and the port's 1 rank: the path, layout and
    (eager) chunk mode each rank reports, no kernel launched, replicas
    bitwise, the mesh tolerances."""
    r0 = ranks[0]
    for r in ranks:
        assert r["path"] == "autograd" and r["layout"].startswith(layout), (r["path"], r["layout"])
        assert r["launches"] == {} and r["digest"] == r0["digest"] and r["mode"] == "eager (gloo)"
    m2, p2 = r0["metrics"], params_to_jax(r0["state_dict"])
    assert m2["finite"].all()
    n_steps = len(m2["all"])
    jm, jstate, jg = jax_mesh_run(jcfg, jp, data, optim, jmesh_, n_steps)
    m1, p1, g1 = one_rank(tcfg, jp, data, optim, n_steps)
    keys = metric_keys(tcfg)
    assert_close(m2, jm, p2, jstate.params, keys, False)
    assert_close(m2, m1, p2, p1, keys, tcfg.use_implicit_mask)
    if tcfg.use_implicit_mask:
        g2 = grads_to_jax(r0["grads"], r0["state_dict"])
        grads_agree(g2, jg, "2 ranks vs marf_tpu's mesh")
        grads_agree(g2, grads_to_jax(g1, r0["state_dict"]), "2 ranks vs 1 rank")
    if tcfg.train_view_embedding:
        for ref in (jstate.params, p1):
            np.testing.assert_allclose(p2["view_embedding"], np.asarray(ref["view_embedding"]), rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("cid,kw", AUTOGRAD_CASES, ids=[c[0] for c in AUTOGRAD_CASES])
def test_autograd_step_matches_jax_gspmd_mesh_and_one_rank(sharded_runs, cid, kw):
    """2 steps of the partitioned autograd step on 2 ranks (LONG: 5, the
    rest in chunks of 2) against marf_tpu's
    GSPMD-partitioned step on make_mesh(2) (`make_sharded_train_setup`) and
    against the port's 1 rank: metrics, warp and MLP weights at the mesh
    tolerances, the mask heads' first-step gradients by `grads_agree`,
    replicas bitwise, no kernel launched. N odd runs replicated."""
    jcfg, tcfg, jp, data = case_inputs(kw, False)
    layout = "replicated on 2 ranks" if cid == "replicated" else "sharded over 2 ranks"
    check_autograd_run(sharded_runs[f"autograd_{cid}"], tcfg, jcfg, jp, data, optim_for(kw), jmesh.make_mesh(2),
                       layout)


def test_2d_mesh_matches_jax_mesh_2d():
    """Four ranks as a 2 x 2 mesh (images x pixels, parallel/sharded.py
    `train_steps` with mesh_shape=(2, 2)) at B = 2, the twin of
    tests/test_parallel.py `test_2d_mesh_batch_x_pixel`: laid out as 4 ranks
    of the 1-D mesh, against marf_tpu's `make_mesh_2d(2, 2)` and the port's
    1 rank, replicas bitwise."""
    jcfg, tcfg, jp, data = case_inputs(dict(OFF, batch_size=2), False)
    ranks = launch.spawn(tsh.train_steps, 4, (tcfg, params_from_jax(jp), data, 2, OPTIM, True, (2, 2)), cpu=True,
                         timeout_s=SPAWN_TIMEOUT_S)
    assert [r["layout"].split(" on ")[0] for r in ranks] == [f"sharded over 4 ranks (gloo), rank {r}" for r in range(4)]
    check_autograd_run(ranks, tcfg, jcfg, jp, data, OPTIM, jmesh.make_mesh_2d(2, 2), "sharded over 4 ranks")


@pytest.mark.parametrize("cid,extra,path", TRAINER_RUNS, ids=[c[0] for c in TRAINER_RUNS])
def test_train_main_on_two_ranks_matches_one_rank(sharded_runs, cid, extra, path):
    """`train.main --cpu --tpu.n_devices=2` at fused_step=auto (the fused
    gate is shut on the CPU: the partitioned autograd step) and per-image
    heads at B = 3 with fused_step=on (K5 -> K6 on 1 | 2 whole images per
    rank; marf_tpu's trainer would turn these kernels off): each rank
    reports its config's own path, replicas bitwise, and the curves match 1
    rank of the same flags within marf_tpu's
    `test_trainer_multichip_equals_single_device` bound, max abs < 5e-3 per
    TB tag, and the first 10 steps within the mesh tolerance."""
    ranks = sharded_runs[f"trainer_{cid}"]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for r in ranks:
        assert r["path"] == path and r["layout"].startswith("sharded over 2 ranks")
        assert r["chunk_modes"] == ["eager (gloo)"]
    one = main(run_args(sharded_runs["trainer_root"], f"{cid}_1rank", TRAINER_ITERS, *extra))
    h2, h1 = history(ranks[0]["history"]), history(one.history)
    keys = [k for k in h1 if k.startswith("loss_") or k in ("PSNR", "Homography_Error", "Mask_Error")]
    assert "Mask_Error" in keys if cid == "heads_B3_on" else "loss_edge" in keys
    for k in keys:
        assert np.abs(h2[k] - h1[k]).max() < 5e-3, k
        np.testing.assert_allclose(h2[k][:10], h1[k][:10], rtol=2e-5, atol=1e-7, err_msg=k)


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


@pytest.mark.parametrize("world,n_batch,n_pixel,B,error", [
    (4, 2, 2, 2, None), (4, 2, 2, 4, None), (4, 1, 4, 3, None), (4, 4, 1, 4, None), (8, 2, 4, 2, None),
    (8, 4, 2, 4, None), (6, 3, 2, 3, None), (4, 2, 3, 4, "needs 6 ranks"), (4, 2, 2, 3, "B = 3 images"),
    (6, 3, 2, 4, "B = 4 images"),
])
def test_make_mesh_2d_keeps_the_1d_layout(world, n_batch, n_pixel, B, error):
    """`make_mesh_2d` needs n_batch x n_pixel ranks and B divisible by
    n_batch, and returns each rank's 1-D mesh: rank r holds as many
    positions of the flat axis as rank (r // n_pixel, r % n_pixel) of
    marf_tpu's `make_mesh_2d` under its data sharding (images on `batch`,
    rows on `data`), the same positions when each batch block is one
    image."""
    meshes = [Mesh(r, world, CPU, "gloo") for r in range(world)]
    if error:
        with pytest.raises(ValueError, match=error):
            make_mesh_2d(meshes[0], n_batch, n_pixel, B)
        return
    assert all(make_mesh_2d(m, n_batch, n_pixel, B) is m for m in meshes)
    h, w = 4 * n_pixel, 3
    N = B * h * w
    index = jax.sharding.NamedSharding(jmesh.make_mesh_2d(n_batch, n_pixel), jmesh._spatial_spec(2, True))
    by_device = index.devices_indices_map((B, 3, h, w))
    devices = np.asarray(jax.devices()[:world]).reshape(n_batch, n_pixel)
    flat = np.arange(N).reshape(B, 1, h, w)
    for r in range(world):
        theirs = set(flat[by_device[devices[divmod(r, n_pixel)]]].ravel())
        ours = set(range(r * N // world, (r + 1) * N // world))
        assert len(theirs) == len(ours)
        if B == n_batch:
            assert theirs == ours


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
    calls = [(fail_on_rank_1, ()), (tsh.train_steps, (tcfg, params_from_jax(jp), data, 2, OPTIM))]
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="a rank failed"):
        launch.spawn(launch.run_each, 2, (calls,), cpu=True, timeout_s=SPAWN_TIMEOUT_S)
    assert time.monotonic() - t < SPAWN_TIMEOUT_S / 2


# ------------------------------------------------------- the CLI on 2 ranks


def run_args(root, name, iters, *extra):
    """The CLI of a tiny run; --tpu.fused_step=on unless `extra` sets it."""
    fused = [] if any(e.startswith("--tpu.fused_step=") for e in extra) else ["--tpu.fused_step=on"]
    return ["--model=planar", "--yaml=planar", "--cpu", f"--output_root={root}", f"--name={name}",
            f"--max_iter={iters}", "--freq.scalar=10", "--freq.vis=10", "--freq.ckpt=10", *fused,
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
