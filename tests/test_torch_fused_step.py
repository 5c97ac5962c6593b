"""The fused train step (K1, K2) of the PyTorch port, and the card tests of
the mask kernels (K3, K4) and of K5 and K6, each at float32 (on the 3xTF32
tensor-core engine) and at bfloat16 (on the bf16 engine; the engines alone
are tested in tests/test_torch_tc_gemm.py).

On the CPU each wrapper runs its plain PyTorch version, which is held against
marf_tpu's `fused_train_kernel_warp` / `fused_train_kernel` (the Pallas
kernels, in interpret mode off-TPU) and against the port's own autograd step.
The CUDA kernels against their plain versions run only on a card (marker
`cuda`).

Tolerances: float32 values (rgb, sq, loss) rtol=1e-5; gradients by relative
error to the max-abs <= 1e-4 (different summation order).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marf_tpu.ops.grid import GridSpec, normalized_pixel_grid
from marf_tpu.ops.lie import sl3_to_SL3 as jsl3
from marf_tpu.ops.pallas.fused_step import build_grid_b, fused_train_kernel as jax_kernel_coords
from marf_tpu.ops.pallas.fused_step import fused_train_kernel_warp as jax_kernel
from marf_tpu_torch.ops.cuda import LAUNCHES
from marf_tpu_torch.ops.cuda import fused_step as fs
from test_torch_models import cfg_pair, fake_data, jax_params, port_graph, rel_err, to_torch


def k1_inputs(jcfg, rng, use_masks=True):
    """The kernel's inputs as numpy: (u, v, b) grid, H, targets, masks."""
    jp = jax_params(jcfg)
    B = jcfg.batch_size
    grid = normalized_pixel_grid(GridSpec(jcfg.H, jcfg.W, jcfg.patch_H, jcfg.patch_W), crop=True)
    grid_b = np.array(build_grid_b(grid, B))
    N = grid_b.shape[1]
    H = np.array(jsl3(jnp.asarray(jp["warp"])))
    targets = rng.rand(3, N).astype(np.float32)
    masks = (rng.rand(1, N) > 0.3).astype(np.float32) if use_masks else np.ones((1, N), np.float32)
    return jp, grid_b, H, targets, masks


def compare(ours, ref):
    rgb, loss, dparams, dH, sq = ours
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(sq.numpy(), np.asarray(ref[4]), rtol=1e-5, atol=1e-7)
    assert rel_err(dH.numpy(), ref[3]) <= 1e-4
    for (dw, db), jl in zip(dparams, ref[2]["mlp"]):
        assert rel_err(dw.numpy().T, jl["w"]) <= 1e-4
        assert rel_err(db.numpy(), jl["b"]) <= 1e-4


@pytest.mark.parametrize(
    "use_masks,arch",
    [(True, {}), (False, {}), (True, {"posenc_L": None, "barf_c2f": None}), (True, {"barf_c2f": None})],
    ids=["masks_c2f", "no_masks", "no_posenc", "no_c2f"],
)
def test_plain_matches_pallas_interpret(rng, use_masks, arch):
    jcfg, tcfg = cfg_pair(arch=arch)
    jp, grid_b, H, targets, masks = k1_inputs(jcfg, rng, use_masks)
    g = port_graph(tcfg, jp)
    L = jcfg.arch.posenc_L
    cw = None if jcfg.arch.barf_c2f is None else np.array([1.0, 0.8, 0.3, 0.0], np.float32)
    inv_sum3 = np.float32(1.0 / (masks.sum() * 3.0))
    ref = jax_kernel(
        jax.tree.map(jnp.asarray, jp["neural_image"]), jnp.asarray(grid_b), jnp.asarray(H),
        None if cw is None else jnp.asarray(cw), jnp.asarray(targets), jnp.asarray(masks),
        jnp.float32(1.7), jnp.float32(inv_sum3), jcfg.arch,
    )
    t = torch.from_numpy
    ours = fs.fused_train_kernel_warp(
        g.neural_image, t(grid_b), t(H), None if cw is None else t(cw), t(targets), t(masks),
        torch.tensor(1.7), torch.tensor(inv_sum3),
    )
    assert L is None or ours[0].shape == (3, grid_b.shape[1])
    compare(ours, ref)


def test_wrapper_runs_plain_version_on_cpu_without_counting(rng):
    jcfg, tcfg = cfg_pair()
    jp, grid_b, H, targets, masks = k1_inputs(jcfg, rng)
    g = port_graph(tcfg, jp)
    t = torch.from_numpy
    before = dict(LAUNCHES)
    args = (g.neural_image, t(grid_b), t(H), None, t(targets), t(masks), 1.0, torch.tensor(0.01))
    a = fs.fused_train_kernel_warp(*args)
    b = fs.fused_train_kernel_warp_reference(*args)
    cargs = (g.neural_image, t(grid_b[:2].copy()), None, t(targets), t(masks), 1.0, torch.tensor(0.01))
    c = fs.fused_train_kernel(*cargs)
    d = fs.fused_train_kernel_reference(*cargs)
    assert LAUNCHES == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[3], b[3])
    assert torch.equal(c[0], d[0]) and torch.equal(c[3], d[3])


def compare_coords(ours, ref):
    rgb, loss, dparams, dcoords, sq = ours
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(sq.numpy(), np.asarray(ref[4]), rtol=1e-5, atol=1e-7)
    assert rel_err(dcoords.numpy(), ref[3]) <= 1e-4
    for (dw, db), jl in zip(dparams, ref[2]["mlp"]):
        assert rel_err(dw.numpy().T, jl["w"]) <= 1e-4
        assert rel_err(db.numpy(), jl["b"]) <= 1e-4


@pytest.mark.parametrize(
    "use_masks,arch",
    [(True, {}), (False, {}), (True, {"posenc_L": None, "barf_c2f": None})],
    ids=["masks_c2f", "no_masks", "no_posenc"],
)
def test_coords_plain_matches_pallas_interpret(rng, use_masks, arch):
    """K2's plain version against marf_tpu's `fused_train_kernel` (the
    Pallas `_kernel`, interpret mode) on warped coordinates."""
    jcfg, tcfg = cfg_pair(arch=arch)
    jp, _, _, targets, masks = k1_inputs(jcfg, rng, use_masks)
    g = port_graph(tcfg, jp)
    coords = (rng.rand(2, targets.shape[1]) * 2.2 - 1.1).astype(np.float32)
    cw = None if jcfg.arch.barf_c2f is None else np.array([1.0, 0.8, 0.3, 0.0], np.float32)
    inv_sum3 = np.float32(1.0 / (masks.sum() * 3.0))
    ref = jax_kernel_coords(
        jax.tree.map(jnp.asarray, jp["neural_image"]), jnp.asarray(coords), None if cw is None else jnp.asarray(cw),
        jnp.asarray(targets), jnp.asarray(masks), jnp.float32(1.7), jnp.float32(inv_sum3), jcfg.arch,
    )
    t = torch.from_numpy
    ours = fs.fused_train_kernel(g.neural_image, t(coords), None if cw is None else t(cw), t(targets), t(masks),
                                 torch.tensor(1.7), torch.tensor(inv_sum3))
    assert ours[3].shape == (2, coords.shape[1])
    compare_coords(ours, ref)


def test_padding_columns_are_inert(rng):
    """Columns whose image index lies outside [0, B) (marf_tpu pads with
    b = -1) add nothing to the loss or the gradients when their mask is 0."""
    jcfg, tcfg = cfg_pair()
    jp, grid_b, H, targets, masks = k1_inputs(jcfg, rng)
    g = port_graph(tcfg, jp)
    pad = 64
    grid_p = np.concatenate([grid_b, np.stack([np.zeros(pad), np.zeros(pad), -np.ones(pad)]).astype(np.float32)], 1)
    t = torch.from_numpy
    inv = torch.tensor(1.0 / (masks.sum() * 3.0), dtype=torch.float32)
    a = fs.fused_train_kernel_warp(g.neural_image, t(grid_b), t(H), None, t(targets), t(masks), 1.0, inv)
    b = fs.fused_train_kernel_warp(
        g.neural_image, t(grid_p), t(H), None, t(np.pad(targets, ((0, 0), (0, pad)))),
        t(np.pad(masks, ((0, 0), (0, pad)))), 1.0, inv,
    )
    np.testing.assert_allclose(b[1].numpy(), a[1].numpy(), rtol=1e-6)
    assert rel_err(b[3].numpy(), a[3].numpy()) <= 1e-6
    for (dw_b, _), (dw_a, _) in zip(b[2], a[2]):
        assert rel_err(dw_b.numpy(), dw_a.numpy()) <= 1e-6


@pytest.mark.parametrize("use_masks", [True, False])
def test_plain_matches_port_autograd_step(rng, use_masks):
    """The fused step's gradients (plain K1 + autograd through the expm
    only) equal the port's autograd step's, at one step, every parameter."""
    from marf_tpu_torch.engine.step import make_optimizer, make_train_step

    grads = {}
    for mode in ("off", "on"):
        jcfg, tcfg = cfg_pair(use_masks=use_masks, fused_step=mode, fused_warp="on", alpha_initial=0.3)
        g = port_graph(tcfg, jax_params(jcfg))
        data = to_torch(fake_data(jcfg, np.random.RandomState(5)))
        if not use_masks:
            data.update(masks=None, masks_eroded=None)
        opt, _ = make_optimizer(g, {"lr": 0.0, "lr_warp": 0.0}, tcfg.max_iter)
        step_fn = make_train_step(tcfg, g, opt, data)
        step_fn.set_step(3)
        step_fn()
        grads[mode] = {k: p.grad.clone() for k, p in g.named_parameters()}
    for k, ref in grads["off"].items():
        assert rel_err(grads["on"][k].numpy(), ref.numpy()) <= 1e-4, k


@pytest.mark.parametrize("kw", [{"fused_warp": "off"}, {"batch_size": 9}], ids=["fused_warp_off", "B9"])
def test_coords_step_matches_port_autograd_step(rng, kw):
    """The K2 branch of the fused step (warp under autograd, plain K2, dcoords
    pulled back to the warp) equals the autograd step, every parameter."""
    from marf_tpu_torch.engine.step import make_optimizer, make_train_step

    grads = {}
    for mode in ("off", "on"):
        jcfg, tcfg = cfg_pair(fused_step=mode, alpha_initial=0.3, **kw)
        g = port_graph(tcfg, jax_params(jcfg))
        opt, _ = make_optimizer(g, {"lr": 0.0, "lr_warp": 0.0}, tcfg.max_iter)
        step_fn = make_train_step(tcfg, g, opt, to_torch(fake_data(jcfg, np.random.RandomState(5))))
        step_fn.set_step(3)
        step_fn()
        grads[mode] = {k: p.grad.clone() for k, p in g.named_parameters()}
    for k, ref in grads["off"].items():
        assert rel_err(grads["on"][k].numpy(), ref.numpy()) <= 1e-4, k


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the card: python -m pytest tests/test_torch_fused_step.py -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def hold_to_plain_on_card(kernel, plain, args, name, value_tol=1e-5, grad_tol=1e-4, geo_tol=1e-4):
    """A K1 or K2 wrapper against its plain version on the card: values
    (rgb, loss, sq) 1e-5, dH or dcoords and every dW, db 1e-4 of the max-abs
    (unless given), one count per launch, bitwise-equal relaunch."""
    before = LAUNCHES[name]
    out = kernel(*args)
    out2 = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2
    for a, b, tol in [(out[0], ref[0], value_tol), (out[1], ref[1], value_tol), (out[4], ref[4], value_tol),
                      (out[3], ref[3], geo_tol)]:
        assert rel_err(a.cpu().numpy(), b.cpu().numpy()) <= tol
    for (dw, db), (rw, rb) in zip(out[2], ref[2]):
        assert rel_err(dw.cpu().numpy(), rw.cpu().numpy()) <= grad_tol
        assert rel_err(db.cpu().numpy(), rb.cpu().numpy()) <= grad_tol
    # no float atomics: two launches on the same inputs are bitwise equal
    assert torch.equal(out[3], out2[3]) and all(torch.equal(a[0], b[0]) for a, b in zip(out[2], out2[2]))


def k2_args(g, targets, masks, rng, device):
    """K2's arguments: random warped coordinates over the grid's range."""
    d = lambda x: torch.from_numpy(x).to(device)
    coords = (rng.rand(2, targets.shape[1]) * 2.2 - 1.1).astype(np.float32)
    inv_sum3 = torch.tensor(1.0 / (masks.sum() * 3.0), dtype=torch.float32, device=device)
    return (g.neural_image, d(coords), torch.tensor([1.0, 0.8, 0.3, 0.0], device=device), d(targets), d(masks),
            torch.tensor(1.7, device=device), inv_sum3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [{}, {"posenc_L": None, "barf_c2f": None}], ids=["c2f", "no_posenc"])
def test_kernel_matches_plain_on_card(rng, cuda_device, arch):
    jcfg, tcfg = cfg_pair(arch=arch)
    jp, grid_b, H, targets, masks = k1_inputs(jcfg, rng)
    g = port_graph(tcfg, jp).to(cuda_device)
    cw = None if jcfg.arch.barf_c2f is None else torch.tensor([1.0, 0.8, 0.3, 0.0], device=cuda_device)
    d = lambda x: torch.from_numpy(x).to(cuda_device)
    args = (g.neural_image, d(grid_b), d(H), cw, d(targets), d(masks), torch.tensor(1.7, device=cuda_device),
            torch.tensor(1.0 / (masks.sum() * 3.0), dtype=torch.float32, device=cuda_device))
    hold_to_plain_on_card(fs.fused_train_kernel_warp, fs.fused_train_kernel_warp_reference, args,
                          "fused_train_kernel_warp")


@pytest.mark.cuda
def test_coords_kernel_matches_plain_on_card(rng, cuda_device):
    """K2 against its plain version: values 1e-5, grads 1e-4, bitwise relaunch."""
    jcfg, tcfg = cfg_pair()
    jp, _, _, targets, masks = k1_inputs(jcfg, rng)
    g = port_graph(tcfg, jp).to(cuda_device)
    hold_to_plain_on_card(fs.fused_train_kernel, fs.fused_train_kernel_reference,
                          k2_args(g, targets, masks, rng, cuda_device), "fused_train_kernel")


@pytest.mark.cuda
def test_kernels_at_eight_images_and_ragged_points_on_card(rng, cuda_device):
    """K1 and K2 at B = 8 images (the most K1 takes) of 14 x 30 points, N =
    3,360, a multiple of no 128-point tile: values 1e-5, grads, dH and
    dcoords 1e-4, bitwise relaunch."""
    jcfg, tcfg = cfg_pair(batch_size=8, patch_H=14, patch_W=30)
    jp, grid_b, H, targets, masks = k1_inputs(jcfg, rng)
    assert H.shape[0] == fs.MAX_IMAGES and grid_b.shape[1] == 3360
    g = port_graph(tcfg, jp).to(cuda_device)
    d = lambda x: torch.from_numpy(x).to(cuda_device)
    args = (g.neural_image, d(grid_b), d(H), torch.tensor([1.0, 0.8, 0.3, 0.0], device=cuda_device), d(targets),
            d(masks), torch.tensor(1.7, device=cuda_device),
            torch.tensor(1.0 / (masks.sum() * 3.0), dtype=torch.float32, device=cuda_device))
    hold_to_plain_on_card(fs.fused_train_kernel_warp, fs.fused_train_kernel_warp_reference, args,
                          "fused_train_kernel_warp")
    hold_to_plain_on_card(fs.fused_train_kernel, fs.fused_train_kernel_reference,
                          k2_args(g, targets, masks, rng, cuda_device), "fused_train_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("use_edges,HW", [(True, 512), (False, 512), (True, 1541)],
                         ids=["edges", "no_edges", "edges_odd_K"])
def test_mask_kernels_match_plain_on_card(rng, cuda_device, use_edges, HW):
    """K3 and K4 against their plain versions on dedup columns with extras:
    values 1e-5, grads 1e-4, bitwise relaunch. HW = 1,541 gives K = 2,683
    columns, odd and not a multiple of 4 as the trainer's are, so X [56, K]
    takes the engine's 4-byte copies in the layer-0 forward and dW."""
    from marf_tpu_torch.models.implicit_mask import ImplicitMask
    from marf_tpu_torch.ops.cuda import fused_mask as fm

    B = 3
    combo = np.where(rng.rand(B, HW) > 0.7, rng.randint(0, 8, (B, HW)), 0)
    onehot = np.eye(8, dtype=np.float32)[combo].transpose(0, 2, 1)
    X, s0, _, _, cnt = fm.slot_dedup_inputs(rng.randn(42, HW).astype(np.float32), onehot)
    K = X.shape[1]
    assert K > HW and (HW == 512 or K % 4 == 3)
    d = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(cuda_device)
    gen = torch.Generator().manual_seed(0)
    stack = fm.mask_w_stack(ImplicitMask(gen).to(cuda_device), d(rng.randn(8, 384)))
    args = (stack, d(X), d(s0), d(np.abs(rng.randn(B, HW))), d(np.abs(rng.randn(B, HW))) if use_edges else None,
            d(0.01 * cnt + rng.rand(1, K) * 0.1), d(cnt), d([0.7, 0.3, -0.05]))
    before = dict(LAUNCHES)
    m, m2, m_ref = fm.fused_mask_forward(stack, args[1]), fm.fused_mask_forward(stack, args[1]), fm.fused_mask_forward_reference(stack, args[1])
    g, g2, g_ref = fm.fused_mask_backward_dedup(*args), fm.fused_mask_backward_dedup(*args), fm.fused_mask_backward_dedup_reference(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_mask_forward"] == before["fused_mask_forward"] + 2
    assert LAUNCHES["fused_mask_backward_dedup"] == before["fused_mask_backward_dedup"] + 2
    assert rel_err(m.cpu().numpy(), m_ref.cpu().numpy()) <= 1e-5 and torch.equal(m, m2)
    for (dw, db), (rw, rb), (dw2, _) in zip(g, g_ref, g2):
        assert rel_err(dw.cpu().numpy(), rw.cpu().numpy()) <= 1e-4
        assert rel_err(db.cpu().numpy(), rb.cpu().numpy()) <= 1e-4
        assert torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_heads,cols", [(1, None), (3, None), (5, 1537)],
                         ids=["shared", "per_image", "per_image_5x1537"])
def test_heads_kernels_match_plain_on_card(rng, cuda_device, n_heads, cols):
    """K5 and K6 against their plain versions on head-blocked columns, each
    head with its own weights and its own uv block (5 heads of 1,537 columns,
    a multiple of no tile, so that a wrong head offset in the grouped
    launches shows): values 1e-5, gradients 1e-4, dcoords 1e-3 (float32
    cancellation of the posenc VJP, see tests/test_torch_implicit_heads.py),
    bitwise relaunch."""
    from marf_tpu_torch.models.implicit_mask import ImplicitMask
    from marf_tpu_torch.ops.cuda import fused_implicit as fi
    from marf_tpu_torch.ops.cuda import fused_mask as fm

    jcfg, tcfg = cfg_pair()
    jp, _, _, targets, _ = k1_inputs(jcfg, rng)
    g = port_graph(tcfg, jp).to(cuda_device)
    if cols is not None:
        targets = rng.rand(3, n_heads * cols).astype(np.float32)
    N = targets.shape[1]
    d = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(cuda_device)
    X = np.concatenate([rng.randn(42, N), np.eye(8)[rng.randint(0, 8, N)].T, np.zeros((6, N))])
    gen = torch.Generator().manual_seed(0)
    stacks = [fm.mask_w_stack(ImplicitMask(gen).to(cuda_device), d(rng.randn(8, 384))) for _ in range(n_heads)]
    k5 = (g.neural_image, stacks, d(rng.rand(2, N) * 2.2 - 1.1), d(X), torch.tensor([1.0, 0.8, 0.3, 0.0], device=cuda_device),
          d(targets), torch.tensor(1.7, device=cuda_device))
    k6 = (stacks, d(X), d(np.abs(rng.randn(1, N))), d(np.abs(rng.randn(1, N))), d([0.7, 0.3, 0.05]), -0.2,
          d(rng.randint(1, 5, (1, N))))
    before = dict(LAUNCHES)
    out, out2, ref = fi.fused_implicit_train_kernel(*k5), fi.fused_implicit_train_kernel(*k5), fi.fused_implicit_train_kernel_reference(*k5)
    gk, gk2, gref = fm.fused_mask_backward_g(*k6), fm.fused_mask_backward_g(*k6), fm.fused_mask_backward_g_reference(*k6)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_implicit_train_kernel"] == before["fused_implicit_train_kernel"] + 2
    assert LAUNCHES["fused_mask_backward_g"] == before["fused_mask_backward_g"] + 2
    c = lambda x: x.cpu().numpy()
    for i in (0, 1, 2, 4, 5):  # rgb, m, sq, msum, loss
        assert rel_err(c(out[i]), c(ref[i])) <= 1e-5, i
    assert rel_err(c(out[3]), c(ref[3])) <= 1e-3
    for (dw, db), (rw, rb) in zip(out[6], ref[6]):
        assert rel_err(c(dw), c(rw)) <= 1e-4 and rel_err(c(db), c(rb)) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(out[:6], out2[:6]))
    assert len(gk) == n_heads
    for grads, grads2, refs in zip(gk, gk2, gref):
        for (dw, db), (dw2, _), (rw, rb) in zip(grads, grads2, refs):
            assert rel_err(c(dw), c(rw)) <= 1e-4 and rel_err(c(db), c(rb)) <= 1e-4
            assert torch.equal(dw, dw2)


# bf16 (compute_dtype = bfloat16) kernels against their bf16 plain versions.
# Products are exact in float32 on both sides; a float32 sum taken in another
# order can land on the other side of a bf16 rounding boundary, and that one
# activation or dz then differs by a bf16 ulp (2^-8 of itself). Measured on
# an H100 at the main path's shapes (PERF.md): rgb and m within 1.6e-4 of
# their max-abs, gradients and dH within 2.3e-4. Hence values and gradients
# 1e-3, and K2's dcoords (a difference of posenc terms up to 2^k pi larger
# than itself: float32 alone loses ~4e-2 of its max-abs at a few points of
# the main path) 1e-2 at these sizes.
BF16_TOL = dict(value_tol=1e-3, grad_tol=1e-3)
# K6's bf16 gradients at these sizes: the uv rows of X are drawn from a
# normal distribution, so the first layer's dW is a sum with much
# cancellation over a few thousand columns, where the flips of a sum
# order weigh more than over the main path's 216,000 (4.4e-5 there).
# Measured on an H100 over two seeds and five shapes (1 to 17 heads, 1,536
# to 20,000 columns): at most 2.0e-3, while the float32 plain version is
# 1.4e-2 or more from the bf16 one.
K6_BF16_GRAD_TOL = 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("images", ["canonical", "eight"], ids=["B3", "B8_N3360"])
def test_bf16_rgb_kernels_match_plain_on_card(rng, cuda_device, images):
    """K1 and K2 at compute_dtype = bfloat16 against their bf16 plain
    versions, also at B = 8 images of 14 x 30 points (N = 3,360, a multiple
    of no tile): tolerances above, bitwise relaunch, the bf16 counts."""
    kw = {"batch_size": 8, "patch_H": 14, "patch_W": 30} if images == "eight" else {}
    jcfg, tcfg = cfg_pair(arch={"compute_dtype": "bfloat16"}, **kw)
    jp, grid_b, H, targets, masks = k1_inputs(jcfg, rng)
    g = port_graph(tcfg, jp).to(cuda_device)
    d = lambda x: torch.from_numpy(x).to(cuda_device)
    args = (g.neural_image, d(grid_b), d(H), torch.tensor([1.0, 0.8, 0.3, 0.0], device=cuda_device), d(targets),
            d(masks), torch.tensor(1.7, device=cuda_device),
            torch.tensor(1.0 / (masks.sum() * 3.0), dtype=torch.float32, device=cuda_device))
    hold_to_plain_on_card(fs.fused_train_kernel_warp, fs.fused_train_kernel_warp_reference, args,
                          "fused_train_kernel_warp_bf16", geo_tol=1e-3, **BF16_TOL)
    hold_to_plain_on_card(fs.fused_train_kernel, fs.fused_train_kernel_reference,
                          k2_args(g, targets, masks, rng, cuda_device), "fused_train_kernel_bf16", geo_tol=1e-2,
                          **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("HW", [512, 1541], ids=["K_even", "K_odd_2683"])
def test_bf16_mask_kernels_match_plain_on_card(rng, cuda_device, HW):
    """K3 and K4 at compute_dtype = bfloat16 against their bf16 plain
    versions on dedup columns with extras, also at an odd K = 2,683 (X
    [56, K] converted to bf16 rows padded to 16 bytes in the call):
    tolerances above, bitwise relaunch, the bf16 counts."""
    from marf_tpu_torch.models.implicit_mask import ImplicitMask
    from marf_tpu_torch.ops.cuda import fused_mask as fm

    B = 3
    combo = np.where(rng.rand(B, HW) > 0.7, rng.randint(0, 8, (B, HW)), 0)
    onehot = np.eye(8, dtype=np.float32)[combo].transpose(0, 2, 1)
    X, s0, _, _, cnt = fm.slot_dedup_inputs(rng.randn(42, HW).astype(np.float32), onehot)
    K = X.shape[1]
    assert K > HW and (HW == 512 or K == 2683)
    d = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(cuda_device)
    gen = torch.Generator().manual_seed(0)
    stack = fm.mask_w_stack(ImplicitMask(gen).to(cuda_device), d(rng.randn(8, 384)))
    args = (stack, d(X), d(s0), d(np.abs(rng.randn(B, HW))), d(np.abs(rng.randn(B, HW))),
            d(0.01 * cnt + rng.rand(1, K) * 0.1), d(cnt), d([0.7, 0.3, -0.05]))
    before = dict(LAUNCHES)
    fwd = lambda f: f(stack, args[1], "bfloat16")
    m, m2, m_ref = fwd(fm.fused_mask_forward), fwd(fm.fused_mask_forward), fwd(fm.fused_mask_forward_reference)
    bwd = lambda f: f(*args, compute_dtype="bfloat16")
    g, g2 = bwd(fm.fused_mask_backward_dedup), bwd(fm.fused_mask_backward_dedup)
    g_ref = bwd(fm.fused_mask_backward_dedup_reference)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_mask_forward_bf16"] == before["fused_mask_forward_bf16"] + 2
    assert LAUNCHES["fused_mask_backward_dedup_bf16"] == before["fused_mask_backward_dedup_bf16"] + 2
    assert LAUNCHES["fused_mask_forward"] == before["fused_mask_forward"]
    assert rel_err(m.cpu().numpy(), m_ref.cpu().numpy()) <= BF16_TOL["value_tol"] and torch.equal(m, m2)
    for (dw, db), (rw, rb), (dw2, _) in zip(g, g_ref, g2):
        assert rel_err(dw.cpu().numpy(), rw.cpu().numpy()) <= BF16_TOL["grad_tol"]
        assert rel_err(db.cpu().numpy(), rb.cpu().numpy()) <= BF16_TOL["grad_tol"]
        assert torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_heads,cols", [(1, None), (3, 1117), (17, 203)],
                         ids=["shared", "per_image_3x1117", "heads_17x203"])
def test_bf16_heads_kernels_match_plain_on_card(rng, cuda_device, n_heads, cols):
    """K5 and K6 at compute_dtype = bfloat16 against their bf16 plain
    versions on head-blocked columns, each head with its own weights and uv
    block: 3 heads of 1,117 columns (no multiple of 8, so each head's bf16
    X block starts on its own 16-byte boundary) and 17 heads of 203 (more
    than MAX_GROUP = 16, so the heads run in two groups). Tolerances above
    (K5's dcoords as K2's, K6's gradients K6_BF16_GRAD_TOL), bitwise
    relaunch, the bf16 counts and no float32 launch."""
    from marf_tpu_torch.models.implicit_mask import ImplicitMask
    from marf_tpu_torch.ops.cuda import fused_implicit as fi
    from marf_tpu_torch.ops.cuda import fused_mask as fm

    jcfg, tcfg = cfg_pair(arch={"compute_dtype": "bfloat16"})
    jp, _, _, targets, _ = k1_inputs(jcfg, rng)
    g = port_graph(tcfg, jp).to(cuda_device)
    if cols is not None:
        targets = rng.rand(3, n_heads * cols).astype(np.float32)
    N = targets.shape[1]
    d = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(cuda_device)
    X = np.concatenate([rng.randn(42, N), np.eye(8)[rng.randint(0, 8, N)].T, np.zeros((6, N))])
    gen = torch.Generator().manual_seed(0)
    stacks = [fm.mask_w_stack(ImplicitMask(gen).to(cuda_device), d(rng.randn(8, 384))) for _ in range(n_heads)]
    k5 = (g.neural_image, stacks, d(rng.rand(2, N) * 2.2 - 1.1), d(X), torch.tensor([1.0, 0.8, 0.3, 0.0], device=cuda_device),
          d(targets), torch.tensor(1.7, device=cuda_device))
    k6 = (stacks, d(X), d(np.abs(rng.randn(1, N))), d(np.abs(rng.randn(1, N))), d([0.7, 0.3, 0.05]), -0.2,
          d(rng.randint(1, 5, (1, N))))
    before = dict(LAUNCHES)
    out, out2, ref = fi.fused_implicit_train_kernel(*k5), fi.fused_implicit_train_kernel(*k5), fi.fused_implicit_train_kernel_reference(*k5)
    bwd = lambda f: f(*k6, compute_dtype="bfloat16")
    gk, gk2, gref = bwd(fm.fused_mask_backward_g), bwd(fm.fused_mask_backward_g), bwd(fm.fused_mask_backward_g_reference)
    torch.cuda.synchronize()
    for name in ("fused_implicit_train_kernel", "fused_mask_backward_g"):
        assert LAUNCHES[name + "_bf16"] == before[name + "_bf16"] + 2 and LAUNCHES[name] == before[name]
    c = lambda x: x.cpu().numpy()
    for i in (0, 1, 2, 4, 5):  # rgb, m, sq, msum, loss
        assert rel_err(c(out[i]), c(ref[i])) <= BF16_TOL["value_tol"], i
    assert rel_err(c(out[3]), c(ref[3])) <= 1e-2
    for (dw, db), (rw, rb) in zip(out[6], ref[6]):
        assert rel_err(c(dw), c(rw)) <= BF16_TOL["grad_tol"] and rel_err(c(db), c(rb)) <= BF16_TOL["grad_tol"]
    assert all(torch.equal(a, b) for a, b in zip(out[:6], out2[:6]))
    assert len(gk) == n_heads
    for grads, grads2, refs in zip(gk, gk2, gref):
        for (dw, db), (dw2, _), (rw, rb) in zip(grads, grads2, refs):
            assert rel_err(c(dw), c(rw)) <= K6_BF16_GRAD_TOL and rel_err(c(db), c(rb)) <= K6_BF16_GRAD_TOL
            assert torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("HW", [512, 1541], ids=["K_even", "K_odd_2683"])
def test_bf16_mask_plan_of_one_head_is_k3s_on_card(rng, cuda_device, HW):
    """The bf16 mask plan over nh heads leaves the one-head plan as K3 and
    K4 run it: K5 at one head runs K3's forward launches on the same plan,
    so its m is bitwise K3's bf16 m, also at an odd column count."""
    from marf_tpu_torch.models.implicit_mask import ImplicitMask
    from marf_tpu_torch.ops.cuda import fused_implicit as fi
    from marf_tpu_torch.ops.cuda import fused_mask as fm

    jcfg, tcfg = cfg_pair(arch={"compute_dtype": "bfloat16"})
    g = port_graph(tcfg, jax_params(jcfg)).to(cuda_device)
    B = 3
    combo = np.where(rng.rand(B, HW) > 0.7, rng.randint(0, 8, (B, HW)), 0)
    onehot = np.eye(8, dtype=np.float32)[combo].transpose(0, 2, 1)
    X = fm.slot_dedup_inputs(rng.randn(42, HW).astype(np.float32), onehot)[0]
    K = X.shape[1]
    d = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(cuda_device)
    stack = fm.mask_w_stack(ImplicitMask(torch.Generator().manual_seed(0)).to(cuda_device), d(rng.randn(8, 384)))
    m3 = fm.fused_mask_forward(stack, d(X), "bfloat16")
    m5 = fi.fused_implicit_train_kernel(g.neural_image, [stack], d(rng.rand(2, K) * 2.2 - 1.1), d(X), None,
                                        d(rng.rand(3, K)), torch.tensor(1.7, device=cuda_device))[1]
    torch.cuda.synchronize()
    assert torch.equal(m3, m5)
