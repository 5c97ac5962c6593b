"""The port's compute_dtype = bfloat16 path against marf_tpu's on the CPU.

Small shapes as the JAX suite's bf16 tests (tests/test_fused_step.py,
tests/test_fused_mask.py): layers (None, 64, 64, 3), L=4, c2f (0, 0.4);
the mask head at its real width. Parameters come from marf_tpu's init,
inputs from numpy seeds; marf_tpu's Pallas kernels run in interpret mode,
as its own tests run them.

Tolerances. Every bf16 x bf16 product is exact in float32 and both sides
round to bf16 at the same points (round to nearest even), so only the order
of the float32 sums differs: values agree to rtol 1e-5, gradients to 1e-4
of their max-abs, as in float32 (tests/test_torch_models.py). A bf16
rounding flips only where that order moves a value across a rounding
boundary; at these sizes none does (measured: every difference below 1e-6
of the max-abs). The 5-step trajectories take the float32 trajectories'
tolerances (tests/test_torch_train_step.py, tests/test_torch_implicit.py).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marf_tpu.models import neural_image as jni
from marf_tpu.ops.pallas import fused_mask as jfm
from marf_tpu.ops.warp import warp_grid_cf_flat as jwarp
from marf_tpu.ops.pallas.fused_step import fused_train_kernel as jax_kernel_coords
from marf_tpu.ops.pallas.fused_step import fused_train_kernel_warp as jax_kernel
from marf_tpu_torch.ops.cuda import LAUNCHES
from marf_tpu_torch.ops.cuda import fused_implicit as tfi
from marf_tpu_torch.ops.cuda import fused_mask as tfm
from marf_tpu_torch.ops.cuda import fused_step as fs
from marf_tpu_torch.utils.params import params_to_jax
from test_torch_fused_step import compare, compare_coords, k1_inputs
from test_torch_implicit import (
    dedup_inputs,
    grid_of,
    icfg,
    implicit_data,
    jax_trajectory,
    port_trajectory,
)
from test_torch_implicit_heads import CW, DATA_SEED, G2C, head_inputs
from test_torch_models import cfg_pair, jax_params, port_graph, rel_err
from test_torch_train_step import assert_trajectory_matches_jax, setup

BF16 = {"compute_dtype": "bfloat16"}


def test_neural_image_matches_jax_in_bfloat16(rng):
    """The autograd path's neural image at bf16 against
    apply_neural_image_cf: values, and its gradients against jax.grad (both
    round each cotangent to bf16 where it crosses a cast)."""
    jcfg, tcfg = cfg_pair(arch=BF16)
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp)
    coords = (rng.rand(2, 500) * 2 - 1).astype(np.float32)
    cot = rng.rand(3, 500).astype(np.float32)
    for progress in (0.05, 0.25):
        ref = np.asarray(jni.apply_neural_image_cf(jp["neural_image"], jnp.asarray(coords), jcfg.arch,
                                                   jnp.float32(progress)))
        g.neural_image.zero_grad()
        ours = g.neural_image(torch.from_numpy(coords), torch.tensor(progress, dtype=torch.float32))
        assert ours.dtype == torch.float32 and ours.shape == (3, 500)
        np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=1e-5, atol=1e-7)
        jgrad = jax.grad(lambda p: jnp.sum(jni.apply_neural_image_cf(p, jnp.asarray(coords), jcfg.arch,
                                                                      jnp.float32(progress)) * cot))
        jg = jgrad(jax.tree.map(jnp.asarray, jp["neural_image"]))
        (ours * torch.from_numpy(cot)).sum().backward()
        for layer, jl in zip(g.neural_image.layers, jg["mlp"]):
            assert rel_err(layer.weight.grad.numpy().T, jl["w"]) <= 1e-4
            assert rel_err(layer.bias.grad.numpy(), jl["b"]) <= 1e-4


def test_bfloat16_differs_from_float32(rng):
    """The bf16 path really rounds: its rgb and gradients are not float32's."""
    jcfg, tcfg = cfg_pair(arch=BF16)
    _, t32 = cfg_pair()
    jp = jax_params(jcfg)
    coords = torch.from_numpy((rng.rand(2, 500) * 2 - 1).astype(np.float32))
    a = port_graph(tcfg, jp).neural_image(coords, torch.tensor(0.25))
    b = port_graph(t32, jp).neural_image(coords, torch.tensor(0.25))
    assert 1e-4 < rel_err(a.detach().numpy(), b.detach().numpy()) < 5e-2


@pytest.mark.parametrize("use_masks", [True, False], ids=["masks", "no_masks"])
def test_k1_plain_matches_pallas_interpret_in_bfloat16(rng, use_masks):
    """K1's bf16 plain version against fused_train_kernel_warp at
    compute_dtype = bfloat16."""
    jcfg, tcfg = cfg_pair(arch=BF16)
    jp, grid_b, H, targets, masks = k1_inputs(jcfg, rng, use_masks)
    g = port_graph(tcfg, jp)
    cw = np.array([1.0, 0.8, 0.3, 0.0], np.float32)
    inv_sum3 = np.float32(1.0 / (masks.sum() * 3.0))
    ref = jax_kernel(
        jax.tree.map(jnp.asarray, jp["neural_image"]), jnp.asarray(grid_b), jnp.asarray(H), jnp.asarray(cw),
        jnp.asarray(targets), jnp.asarray(masks), jnp.float32(1.7), jnp.float32(inv_sum3), jcfg.arch,
    )
    t = torch.from_numpy
    ours = fs.fused_train_kernel_warp(g.neural_image, t(grid_b), t(H), t(cw), t(targets), t(masks),
                                      torch.tensor(1.7), torch.tensor(inv_sum3))
    compare(ours, ref)


@pytest.mark.parametrize("use_masks", [True, False], ids=["masks", "no_masks"])
def test_k2_plain_matches_pallas_interpret_in_bfloat16(rng, use_masks):
    """K2's bf16 plain version against fused_train_kernel at compute_dtype =
    bfloat16, on warped coordinates."""
    jcfg, tcfg = cfg_pair(arch=BF16)
    jp, _, _, targets, masks = k1_inputs(jcfg, rng, use_masks)
    g = port_graph(tcfg, jp)
    coords = (rng.rand(2, targets.shape[1]) * 2.2 - 1.1).astype(np.float32)
    cw = np.array([1.0, 0.8, 0.3, 0.0], np.float32)
    inv_sum3 = np.float32(1.0 / (masks.sum() * 3.0))
    ref = jax_kernel_coords(
        jax.tree.map(jnp.asarray, jp["neural_image"]), jnp.asarray(coords), jnp.asarray(cw), jnp.asarray(targets),
        jnp.asarray(masks), jnp.float32(1.7), jnp.float32(inv_sum3), jcfg.arch,
    )
    t = torch.from_numpy
    ours = fs.fused_train_kernel(g.neural_image, t(coords), t(cw), t(targets), t(masks), torch.tensor(1.7),
                                 torch.tensor(inv_sum3), "bfloat16")
    compare_coords(ours, ref)


@pytest.mark.parametrize("use_edges", [True, False], ids=["edges", "no_edges"])
def test_mask_kernels_plain_match_pallas_in_bfloat16(rng, use_edges):
    """K3's and K4's bf16 plain versions against fused_mask_forward(...,
    "bfloat16") and fused_mask_backward_dedup(..., compute_dtype="bfloat16")."""
    jcfg, tcfg = icfg(arch=BF16)
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp)
    dd, table, (X, s0, _, _, cnt) = dedup_inputs(jcfg, jp, implicit_data(jcfg, rng))
    B, HW = s0.shape
    K, Kp = X.shape[1], dd["mask_Xall"].shape[1]
    jstack = jfm.mask_w_stack(jax.tree.map(jnp.asarray, jp["implicit_mask"]), jnp.asarray(table))
    stack = tfm.mask_w_stack(g.implicit_mask, torch.from_numpy(table))
    t = torch.from_numpy

    m_ref = np.asarray(jfm.fused_mask_forward(jstack, jnp.asarray(X), "bfloat16"))
    m = tfm.fused_mask_forward(stack, t(X), "bfloat16")
    assert m.shape == (1, K)
    np.testing.assert_allclose(m.numpy(), m_ref, rtol=1e-5, atol=1e-7)

    sq = np.abs(rng.randn(B, HW)).astype(np.float32)
    esq = np.abs(rng.randn(B, HW)).astype(np.float32) if use_edges else None
    base = (0.01 * cnt + rng.rand(1, K) * 0.1).astype(np.float32)
    abk = np.array([0.7, 0.3, -0.05], np.float32)
    pad = lambda a: np.pad(a, ((0, 0), (0, Kp - a.shape[1])))
    ref = jfm.fused_mask_backward_dedup(
        jstack, jnp.asarray(dd["mask_Xall"]), jnp.asarray(dd["mask_slot0map_p"]), jnp.asarray(pad(sq)),
        None if esq is None else jnp.asarray(pad(esq)), jnp.asarray(pad(base)), jnp.asarray(dd["mask_cntall"]),
        jnp.asarray(abk), compute_dtype="bfloat16",
    )
    ours = tfm.fused_mask_backward_dedup(stack, t(X), t(s0), t(sq), None if esq is None else t(esq), t(base), t(cnt),
                                         t(abk), compute_dtype="bfloat16")
    for (dw, db), jl in zip(ours, ref):
        assert rel_err(dw.numpy().T, jl["w"]) <= 1e-4
        assert rel_err(db.numpy(), jl["b"]) <= 1e-4


@pytest.mark.parametrize("mode", ["on", "off"], ids=["fused", "autograd"])
def test_canonical_trajectory_matches_jax_in_bfloat16(rng, mode):
    """5 canonical steps at bf16 against marf_tpu's at compute_dtype =
    bfloat16: fused (the port's plain K1 against the Pallas kernel) and
    autograd, with test_torch_train_step.py's float32 trajectory tolerances
    (Adam turns a rounding difference of a near-zero gradient component
    into a step difference of up to lr)."""
    jcfg, tcfg, jp, data = setup(mode, rng, arch=BF16)
    assert_trajectory_matches_jax(jcfg, tcfg, jp, data)


@pytest.mark.parametrize("fused_warp", ["on", "off"], ids=["K1", "K2"])
def test_dedup_trajectory_matches_jax_in_bfloat16(rng, fused_warp):
    """5 fused implicit-dedup steps at bf16 (plain K3 -> K1 or K2 -> K4)
    against marf_tpu's dedup step at compute_dtype = bfloat16. The per-step
    losses agree to rtol 1e-3, as the canonical trajectories' (float32
    dedup: 1e-5): every step rounds the updated weights to bf16 again, and
    a weight whose two float32 updates straddle a bf16 rounding boundary
    rounds to neighbouring bf16 values, 2^-8 of it apart. The mask head
    has 211k weights, so about one such flip a step; the mask loss, which
    falls six-fold in five steps, moves by 1.8e-4 of itself at step 5
    (measured; the rgb loss by 1.3e-5). The parameters are held as
    test_torch_train_step.py holds them: each one's update over the five
    steps within 2e-2 of marf_tpu's in L2 norm (a flipped rounding can turn
    a near-zero gradient component's Adam step of lr around: 4 of the mask
    head's 109k first-layer weights end 1.3e-3 apart)."""
    jcfg, tcfg = icfg(arch=BF16, use_edges=True, alpha_initial=0.3, fused_step="on", fused_warp=fused_warp)
    jp = jax_params(jcfg)
    data = implicit_data(jcfg, rng)
    jstate, jm = jax_trajectory(jcfg, jp, data, 5)
    g, tm = port_trajectory(tcfg, jp, data, 5)
    assert_bf16_trajectory(tm, jm, g, jstate, jp)


def assert_bf16_trajectory(tm, jm, g, jstate, jp):
    """The bf16 trajectories' tolerances (test_dedup_trajectory_matches_jax_in_bfloat16)."""
    assert tm["finite"].all()
    for k in ("all", "loss_rgb", "loss_mask", "loss_render", "loss_edge", "PSNR"):
        np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jm[k]), rtol=1e-3, atol=1e-7, err_msg=k)
    ours, ref = params_to_jax(g.state_dict()), jax.tree.map(np.asarray, jstate.params)
    for name in ("warp", "neural_image", "implicit_mask"):
        for o, r, i in zip(jax.tree.leaves(ours[name]), jax.tree.leaves(ref[name]), jax.tree.leaves(jp[name])):
            assert np.linalg.norm((o - i) - (r - i)) <= 2e-2 * np.linalg.norm(r - i), name


@pytest.mark.parametrize("kw", [{"build_single_masks": True}, {"fused_dedup": "off"}], ids=["single", "dedup_off"])
def test_heads_trajectory_matches_jax_in_bfloat16(kw, capsys):
    """5 fused K5 -> K6 steps at bf16 (their plain versions), per-image heads
    and the shared head without dedup, against marf_tpu's
    `_fused_implicit_grads` at compute_dtype = bfloat16 (its Pallas kernels
    in interpret mode), with the dedup bf16 trajectory's tolerances. The
    step is made at bf16 and says so; it does not fall back to float32."""
    jcfg, tcfg = icfg(arch=BF16, use_edges=True, alpha_initial=0.3, fused_step="on", **kw)
    jp = jax_params(jcfg)
    data = implicit_data(jcfg, np.random.RandomState(DATA_SEED))
    jstate, jm = jax_trajectory(jcfg, jp, data, 5, dedup=False)
    g, tm = port_trajectory(tcfg, jp, data, 5)
    out = capsys.readouterr().out
    assert "(K5 -> K6), bfloat16" in out
    assert_bf16_trajectory(tm, jm, g, jstate, jp)


@pytest.mark.parametrize("n_heads", [1, 3], ids=["shared", "per_image"])
def test_implicit_train_plain_matches_pallas_in_bfloat16(rng, n_heads):
    """K5's bf16 plain version against marf_tpu's fused_implicit_train_kernel
    at compute_dtype = bfloat16 (interpret mode), all seven outputs, with
    test_torch_implicit_heads.py's float32 tolerances."""
    jcfg, jp, g, jstacks, stacks, X, data = head_inputs(n_heads, rng, arch=BF16)
    N = X.shape[1]
    coords = np.asarray(jwarp(grid_of(jcfg), jnp.asarray(jp["warp"])))
    targets = np.ascontiguousarray(data["rgb"].transpose(1, 0, 2, 3).reshape(3, N))
    ref = jfm.fused_implicit_train_kernel(
        jax.tree.map(jnp.asarray, jp["neural_image"]), jstacks, jnp.asarray(coords), jnp.asarray(X), jnp.asarray(CW),
        jnp.asarray(targets), jnp.float32(G2C), jcfg.arch, n_heads,
    )
    t = torch.from_numpy
    rgb, m, sq, dcoords, msum, loss, dmlp = tfi.fused_implicit_train_kernel(  # the net's own dtype: bfloat16
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
@pytest.mark.parametrize("streams", [True, False], ids=["esq_cnt", "no_esq_ones"])
def test_mask_backward_g_plain_matches_pallas_in_bfloat16(rng, n_heads, streams):
    """K6's bf16 plain version against marf_tpu's fused_mask_backward_g(...,
    "bfloat16", n_heads) (interpret mode), with esq and cnt and without
    either: every head's dW/db of every effective layer."""
    _, _, _, jstacks, stacks, X, _ = head_inputs(n_heads, rng, arch=BF16)
    N = X.shape[1]
    sq = np.abs(rng.randn(1, N)).astype(np.float32)
    esq = np.abs(rng.randn(1, N)).astype(np.float32) if streams else None
    cnt = rng.randint(1, 5, (1, N)).astype(np.float32) if streams else None
    a, b, c, k = 0.7, 0.3, -0.2, 0.05
    ref = jfm.fused_mask_backward_g(
        jstacks, jnp.asarray(X), jnp.asarray(sq), None if esq is None else jnp.asarray(esq),
        jnp.asarray([a, b, c, k], jnp.float32), "bfloat16", n_heads, cnt_cf=None if cnt is None else jnp.asarray(cnt),
    )
    t = lambda x: None if x is None else torch.from_numpy(x)
    ours = tfm.fused_mask_backward_g(stacks, t(X), t(sq), t(esq), torch.tensor([a, b, k]), c, t(cnt), "bfloat16")
    assert len(ours) == n_heads
    for h, grads in enumerate(ours):
        for li, ((dw, db), jl) in enumerate(zip(grads, ref)):
            assert rel_err(dw.numpy().T, np.asarray(jl["w"])[h]) <= 1e-4, (h, li)
            assert rel_err(db.numpy(), np.asarray(jl["b"])[h]) <= 1e-4, (h, li)


def test_wrappers_refuse_other_dtypes_and_do_not_count_on_cpu(rng):
    """The kernel wrappers take float32 and bfloat16 only; on CPU tensors
    they run the plain version of the dtype asked for, without counting."""
    jcfg, tcfg = cfg_pair(arch=BF16)
    jp, grid_b, H, targets, masks = k1_inputs(jcfg, rng)
    g = port_graph(tcfg, jp)
    t = torch.from_numpy
    args = (g.neural_image, t(grid_b), t(H), None, t(targets), t(masks), 1.0, torch.tensor(0.01))
    before = dict(LAUNCHES)
    a = fs.fused_train_kernel_warp(*args)  # the net's own dtype: bfloat16
    b = fs.fused_train_kernel_warp_reference(*args, "bfloat16")
    c = fs.fused_train_kernel_warp(*args, compute_dtype="float32")
    assert LAUNCHES == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[3], b[3]) and not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="float16"):
        fs.fused_train_kernel_warp(*args, compute_dtype="float16")
    with pytest.raises(ValueError, match="float16"):
        fs.fused_train_kernel(g.neural_image, t(grid_b[:2].copy()), None, t(targets), t(masks), 1.0,
                              torch.tensor(0.01), "float16")
    X = torch.rand(56, 40)
    layers = [(torch.randn(8, 56), torch.zeros(8)), (torch.randn(1, 8), torch.zeros(1))]
    with pytest.raises(ValueError, match="float16"):
        tfm.fused_mask_forward(layers, X, "float16")
    with pytest.raises(ValueError, match="float16"):
        tfm.fused_mask_backward_dedup(layers, X, torch.ones(1, 40), torch.ones(1, 40), None, torch.ones(1, 40),
                                      torch.ones(1, 40), torch.ones(3), compute_dtype="float16")


def test_heads_wrappers_refuse_float16_and_do_not_count_on_cpu(rng):
    """K5's and K6's wrappers take float32 and bfloat16 only; on CPU tensors
    they run the bf16 plain version, without counting a launch."""
    jcfg, jp, g, _, stacks, X, data = head_inputs(3, rng, arch=BF16)
    N = X.shape[1]
    t = torch.from_numpy
    coords = t(np.asarray(jwarp(grid_of(jcfg), jnp.asarray(jp["warp"]))))
    targets = t(np.ascontiguousarray(data["rgb"].transpose(1, 0, 2, 3).reshape(3, N)))
    k5 = (g.neural_image, stacks, coords, t(X), t(CW), targets, 2.0)
    sq = t(np.abs(rng.randn(1, N)).astype(np.float32))
    k6 = (stacks, t(X), sq, None, torch.tensor([0.7, 0.3, 0.05]), -0.2)
    before = dict(LAUNCHES)
    a, b = tfi.fused_implicit_train_kernel(*k5), tfi.fused_implicit_train_kernel_reference(*k5, "bfloat16")
    a32 = tfi.fused_implicit_train_kernel(*k5, "float32")
    c, d = tfm.fused_mask_backward_g(*k6, compute_dtype="bfloat16"), tfm.fused_mask_backward_g_reference(*k6, None, "bfloat16")
    c32 = tfm.fused_mask_backward_g(*k6)
    assert LAUNCHES == before
    assert all(torch.equal(x, y) for x, y in zip(a[:6], b[:6])) and not torch.equal(a[0], a32[0])
    assert all(torch.equal(x[0][0], y[0][0]) for x, y in zip(c, d)) and not torch.equal(c[0][0][0], c32[0][0][0])
    with pytest.raises(ValueError, match="float16"):
        tfi.fused_implicit_train_kernel(*k5, "float16")
    with pytest.raises(ValueError, match="float16"):
        tfm.fused_mask_backward_g(*k6, compute_dtype="float16")
