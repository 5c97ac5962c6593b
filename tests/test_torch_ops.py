"""Ops of the PyTorch port against their marf_tpu twins on the CPU.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: float32 values rtol=1e-5 (the two frameworks round elementwise
ops and small contractions differently); gradients by relative error to the
max-abs <= 1e-4 (different summation order); the expm value and VJP by
relative error to the max-abs <= 1e-6 (the same Pade numerics, LU solve
rounding apart) when no squaring runs, which covers the warps training
meets; with n squarings 1e-5 * 2^n, since each squaring R -> R @ R doubles
the relative rounding difference the Pade solve leaves in R and in its
cotangent (measured up to 1.2e-5 at n = 2 over three seeds); filters against cv2's
float64 at the tolerances of tests/test_filters.py (float32 against float64).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marf_tpu.ops import filters as jfilters
from marf_tpu.ops import grid as jgrid
from marf_tpu.ops import homography as jhom
from marf_tpu.ops import lie as jlie
from marf_tpu.ops import losses as jlosses
from marf_tpu.ops import posenc as jposenc
from marf_tpu.ops import warp as jwarp
from marf_tpu_torch.models.neural_image import encode_coords_cf
from marf_tpu_torch.ops import filters, grid, homography, lie, losses, posenc, warp


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize("crop", [True, False])
def test_grid_matches_jax(crop):
    spec_j = jgrid.GridSpec(H=32, W=64, patch_H=16, patch_W=32)
    spec_t = grid.GridSpec(H=32, W=64, patch_H=16, patch_W=32)
    ours = grid.normalized_pixel_grid(spec_t, crop=crop).numpy()
    ref = np.asarray(jgrid.normalized_pixel_grid(spec_j, crop=crop))
    assert ours.shape == ref.shape == ((16 * 32 if crop else 32 * 64), 2)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)


def test_sl3_generator_matches_jax(rng):
    h = rng.randn(5, 8).astype(np.float32)
    np.testing.assert_array_equal(lie.sl3_generator(t(h)).numpy(), np.asarray(jlie.sl3_generator(jnp.asarray(h))))


# scales that walk the float32 Pade orders (1-norm bands split at 0.426 /
# 1.88) and the squaring counts (1-norm above 3.93), as tests/test_lie.py does
@pytest.mark.parametrize("scale", [1e-3, 0.05, 0.3, 1.0, 3.0, 10.0])
def test_expm_value_and_vjp_match_jax(rng, scale):
    h = rng.randn(6, 8).astype(np.float32) * scale
    ct = rng.randn(6, 3, 3).astype(np.float32)
    A_j = jlie.sl3_generator(jnp.asarray(h))

    @jax.jit  # the train step always runs the expm jitted
    def f_ref(A, c):
        out, vjp = jax.vjp(jlie.expm_pade_static, A)
        return out, vjp(c)[0]

    ref, g_ref = f_ref(A_j, jnp.asarray(ct))
    A_t = lie.sl3_generator(t(h)).requires_grad_(True)
    ours = lie.expm_pade_static(A_t)
    (g_ours,) = torch.autograd.grad(ours, A_t, t(ct))
    n_sq = int(torch.clamp(torch.floor(torch.log2(A_t.detach().abs().sum(-2).amax(-1) / 3.925724783138660)), min=0).max())
    assert np.isfinite(ours.detach().numpy()).all()
    tol = 1e-6 if n_sq == 0 else 1e-5 * 2**n_sq
    assert rel_err(ours.detach().numpy(), ref) <= tol
    assert rel_err(g_ours.numpy(), g_ref) <= tol


def test_expm_cases_span_pade_orders_and_squarings(rng):
    """The scales above reach Pade orders 3, 5, 7 and 0..n squarings."""
    orders, squarings = set(), set()
    for scale in (1e-3, 0.05, 0.3, 1.0, 3.0, 10.0):
        A = lie.sl3_generator(t(rng.randn(6, 8) * scale))
        norm = A.abs().sum(-2).amax(-1)
        orders |= set(((norm >= 0.4258730016922831).int() + (norm >= 1.880152677804762).int()).tolist())
        squarings |= set(torch.clamp(torch.floor(torch.log2(norm / 3.925724783138660)), min=0).int().tolist())
    assert orders == {0, 1, 2}
    assert {0, 1, 2} <= squarings


def test_expm_nan_guard_and_identity():
    assert torch.isnan(lie.expm_pade_static(torch.eye(3)[None] * 1e7)).all()
    np.testing.assert_array_equal(lie.sl3_to_SL3(torch.zeros(2, 8)).numpy(), np.broadcast_to(np.eye(3), (2, 3, 3)))
    # the zero warp has a finite gradient (the squaring count is piecewise constant)
    w = torch.zeros(2, 8, requires_grad=True)
    lie.sl3_to_SL3(w).sum().backward()
    assert torch.isfinite(w.grad).all()


def test_homography_normalize_matches_jax(rng):
    M = (np.eye(3) + rng.randn(4, 3, 3) * 0.05).astype(np.float32)
    ours = homography.normalize_homography(t(M), (480, 360), (480, 360)).numpy()
    ref = np.asarray(jhom.normalize_homography(jnp.asarray(M), (480, 360), (480, 360)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_warp_grid_value_and_vjp_match_jax(rng):
    xy = np.asarray(jgrid.normalized_pixel_grid(jgrid.GridSpec(32, 64, 16, 32), crop=True))
    w = (rng.randn(3, 8) * 0.05).astype(np.float32)
    ct = rng.randn(2, 3 * 16 * 32).astype(np.float32)
    ref, vjp = jax.vjp(lambda wp: jwarp.warp_grid_cf_flat(jnp.asarray(xy), wp), jnp.asarray(w))
    (g_ref,) = vjp(jnp.asarray(ct))
    w_t = t(w).requires_grad_(True)
    ours = warp.warp_grid_cf_flat(t(xy), w_t)
    (g_ours,) = torch.autograd.grad(ours, w_t, t(ct))
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    assert rel_err(g_ours.numpy(), g_ref) <= 1e-4


@pytest.mark.parametrize("c2f", [None, (0.0, 0.4), (0.1, 0.7)])
def test_posenc_with_c2f_matches_jax(rng, c2f):
    from marf_tpu.models.neural_image import NeuralImageConfig, encode_coords_cf as jencode

    L = 4
    coords = (rng.rand(2, 300) * 2 - 1).astype(np.float32)
    for progress in (0.0, 0.13, 0.3, 0.9):
        cfg = NeuralImageConfig(layers=(None, 8, 3), posenc_L=L, barf_c2f=c2f)
        ref = np.asarray(jencode(jnp.asarray(coords), cfg, jnp.float32(progress)))
        cw = None if c2f is None else posenc.barf_c2f_weights(torch.tensor(progress), c2f, L)
        ours = encode_coords_cf(t(coords), L, cw).numpy()
        assert ours.shape == (2 + 4 * L, 300)
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
        if c2f is not None:
            np.testing.assert_allclose(
                cw.numpy(), np.asarray(jposenc.barf_c2f_weights(jnp.float32(progress), c2f, L)), rtol=1e-5, atol=1e-7
            )


def _loss_case(name, rng):
    pred = rng.rand(3, 3, 8, 8).astype(np.float32)
    lab = rng.rand(3, 3, 8, 8).astype(np.float32)
    m = (rng.rand(3, 1, 8, 8) > 0.4).astype(np.float32)
    if name == "mse":
        return losses.mse(t(pred), t(lab)), jlosses.mse(jnp.asarray(pred), jnp.asarray(lab))
    if name == "mse_masked":
        return losses.mse(t(pred), t(lab), t(m)), jlosses.mse(jnp.asarray(pred), jnp.asarray(lab), jnp.asarray(m))
    if name == "alpha":
        s = np.arange(0, 3001, 37)
        return (losses.alpha_schedule(torch.from_numpy(s), 3000, 0.2, 0.9),
                jlosses.alpha_schedule(jnp.asarray(s), 3000, 0.2, 0.9))
    if name == "render":
        return (losses.render_loss(t(0.3), t(0.2), t(0.1), t(0.4)),
                jlosses.render_loss(jnp.float32(0.3), jnp.float32(0.2), jnp.float32(0.1), jnp.float32(0.4)))
    if name == "summarize":
        terms = {"render": 0.3, "rgb": 0.2, "edge": 0.1, "mask": 0.05}
        wts = {"render": 0.0, "rgb": -1.0, "edge": None, "mask": 0.5}
        return (losses.summarize_loss({k: t(v) for k, v in terms.items()}, wts),
                jlosses.summarize_loss({k: jnp.float32(v) for k, v in terms.items()}, wts))
    if name == "psnr":
        return losses.psnr_from_rgb_loss(t(0.0123)), jlosses.psnr_from_rgb_loss(jnp.float32(0.0123))
    if name == "homography_error":
        a = rng.randn(5, 3, 3).astype(np.float32)
        b = rng.randn(5, 3, 3).astype(np.float32)
        return losses.homography_error(t(a), t(b)), jlosses.homography_error(jnp.asarray(a), jnp.asarray(b))
    if name == "check_finite":
        d = {"a": 1.0, "b": np.inf}
        return (losses.check_finite({k: t(v) for k, v in d.items()}),
                jlosses.check_finite({k: jnp.float32(v) for k, v in d.items()}))
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["mse", "mse_masked", "alpha", "render", "summarize", "psnr", "homography_error", "check_finite"]
)
def test_losses_match_jax(rng, name):
    ours, ref = _loss_case(name, rng)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)


def _cv2_edges(images):
    out = []
    for image in images:
        i = np.transpose(image, (1, 2, 0)).astype(np.float64)
        sx = cv2.Sobel(i, cv2.CV_64F, 1, 0, ksize=3)
        sy = cv2.Sobel(i, cv2.CV_64F, 0, 1, ksize=3)
        i = cv2.GaussianBlur(np.sqrt(sx**2 + sy**2), (5, 5), 0)
        out.append((i[:, :, None] if i.ndim == 2 else i).transpose(2, 0, 1))
    return np.stack(out)


@pytest.mark.parametrize("oracle", ["jax", "cv2_sobel", "cv2_gauss", "cv2_edges"])
def test_filters_match_jax_and_cv2(rng, oracle):
    images = rng.rand(3, 3, 20, 28).astype(np.float32)
    if oracle == "jax":
        ref = np.asarray(jfilters.compute_edges(jnp.asarray(images)))
        np.testing.assert_allclose(filters.compute_edges(t(images)).numpy(), ref, rtol=1e-5, atol=1e-6)
    elif oracle == "cv2_sobel":
        ours = filters.sobel_edges(t(images)).numpy()
        for b in range(3):
            i = np.transpose(images[b], (1, 2, 0)).astype(np.float64)
            sx = cv2.Sobel(i, cv2.CV_64F, 1, 0, ksize=3)
            sy = cv2.Sobel(i, cv2.CV_64F, 0, 1, ksize=3)
            np.testing.assert_allclose(ours[b], np.sqrt(sx**2 + sy**2).transpose(2, 0, 1), rtol=1e-4, atol=1e-5)
    elif oracle == "cv2_gauss":
        ours = filters.gaussian_blur_5x5(t(images[:, :1])).numpy()
        for b in range(3):
            expected = cv2.GaussianBlur(images[b, 0].astype(np.float64), (5, 5), 0)[None]
            np.testing.assert_allclose(ours[b], expected, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(filters.compute_edges(t(images)).numpy(), _cv2_edges(images), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("differentiable", [False, True])
def test_edges_gradient_blocking(rng, differentiable):
    x = t(rng.rand(1, 3, 12, 12)).requires_grad_(True)
    out = filters.compute_edges(x, differentiable=differentiable)
    assert out.requires_grad == differentiable
    if differentiable:
        out.sum().backward()
        assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
