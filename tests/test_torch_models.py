"""Models of the PyTorch port against marf_tpu on the CPU: parameter
transfer, the neural image, graph_forward and graph_loss.

Small shapes as in tests/test_fused_step.py: H=32, W=64, patch 16x32, B=3,
layers (None, 64, 64, 3), L=4, c2f (0, 0.4). Parameters come from marf_tpu's
init and cross with `params_from_jax`; data is made with numpy from a seed.
Tolerances: float32 values rtol=1e-5 (elementwise rounding and summation
order of the two frameworks); gradients by relative error to the max-abs
<= 1e-4 (summation order).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marf_tpu.models import neural_image as jni
from marf_tpu.models import planar as jplanar
from marf_tpu_torch.models import neural_image as tni
from marf_tpu_torch.models import planar as tplanar
from marf_tpu_torch.utils.params import params_from_jax, params_to_jax

SMALL = dict(H=32, W=64, patch_H=16, patch_W=32, batch_size=3, max_iter=100)
ARCH = dict(layers=(None, 64, 64, 3), posenc_L=4, barf_c2f=(0.0, 0.4))


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def cfg_pair(arch=None, **kw):
    """The same small config in both packages (kw: PlanarConfig fields)."""
    arch = dict(ARCH, **(arch or {}))
    base = dict(SMALL, **kw)
    jcfg = jplanar.PlanarConfig(**base, arch=jni.NeuralImageConfig(**arch))
    tcfg = tplanar.PlanarConfig(**{k: v for k, v in base.items() if k in {f.name for f in dataclasses.fields(tplanar.PlanarConfig)}},
                                arch=tni.NeuralImageConfig(**arch))
    return jcfg, tcfg


def jax_params(jcfg, seed=0, warp_scale=0.05):
    """marf_tpu's init with a nonzero warp (warp 0 stays pinned), as numpy."""
    p = jax.tree.map(np.asarray, jplanar.init_graph_params(jax.random.PRNGKey(seed), jcfg))
    p["warp"] = (np.random.RandomState(seed + 1).randn(*p["warp"].shape) * warp_scale).astype(np.float32)
    p["warp"][0] = 0.0
    return p


def port_graph(tcfg, jparams) -> tplanar.Graph:
    g = tplanar.Graph(tcfg)
    g.load_state_dict(params_from_jax(jparams))
    return g


def fake_data(cfg, rng) -> dict:
    """numpy twin of tests/test_models.fake_data."""
    h, w = cfg.map_hw
    B = cfg.batch_size
    return {
        "rgb": rng.rand(B, 3, h, w).astype(np.float32),
        "masks": (rng.rand(B, 1, h, w) > 0.3).astype(np.float32),
        "masks_eroded": (rng.rand(B, 1, h, w) > 0.5).astype(np.float32),
        "edges": rng.rand(B, 1, h, w).astype(np.float32),
        "gt_hom": np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy(),
    }


def to_jax(d):
    return {k: None if v is None else jnp.asarray(v) for k, v in d.items()}


def to_torch(d):
    return {k: None if v is None else torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_params_round_trip():
    jcfg, tcfg = cfg_pair()
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp)
    assert g.neural_image.layers[0].weight.shape == (64, 2 + 4 * 4)  # nn.Linear [out, in]
    back = params_to_jax(g.state_dict())
    np.testing.assert_array_equal(back["warp"], jp["warp"])
    for a, b in zip(back["neural_image"]["mlp"], jp["neural_image"]["mlp"]):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])


def test_neural_image_init_distribution():
    """nn.Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the first layer
    rescaled by sqrt(in/2) under c2f; the generator fixes the draw."""
    cfg = tni.NeuralImageConfig(layers=(None, 4096, 3), posenc_L=8, barf_c2f=(0.0, 0.4))
    net = tni.NeuralImage(cfg, generator=torch.Generator().manual_seed(0))
    w0 = net.layers[0].weight.detach().numpy()
    bound = 1.0 / np.sqrt(34) * np.sqrt(34 / 2.0)
    assert w0.max() <= bound and w0.max() > 0.99 * bound and abs(w0.mean()) < 0.01 * bound
    w1 = net.layers[1].weight.detach().numpy()
    assert w1.max() <= 1.0 / np.sqrt(4096)
    again = tni.NeuralImage(cfg, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.layers[0].weight, net.layers[0].weight)
    # float32 and bfloat16 (marf_tpu's tpu.compute_dtype) are taken; any other dtype is refused
    with pytest.raises(NotImplementedError, match="float16"):
        tni.NeuralImageConfig(compute_dtype="float16")
    assert tni.NeuralImageConfig(compute_dtype="bfloat16").compute_dtype == "bfloat16"


@pytest.mark.parametrize(
    "arch",
    [{}, {"barf_c2f": None}, {"posenc_L": None, "barf_c2f": None}, {"skip": (1,)}],
    ids=["c2f", "no_c2f", "no_posenc", "skip"],
)
def test_neural_image_matches_jax_apply_neural_image_cf(rng, arch):
    jcfg, tcfg = cfg_pair(arch=arch)
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp)
    coords = (rng.rand(2, 500) * 2 - 1).astype(np.float32)
    for progress in (0.05, 0.25):
        ref = np.asarray(jni.apply_neural_image_cf(jp["neural_image"], jnp.asarray(coords), jcfg.arch, jnp.float32(progress)))
        ours = g.neural_image(torch.from_numpy(coords), torch.tensor(progress, dtype=torch.float32))
        assert ours.shape == (3, 500)
        np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("crop,use_edges", [(True, True), (True, False), (False, True)])
def test_graph_forward_matches_jax(rng, crop, use_edges):
    kw = dict(use_cropped_images=crop, use_edges=use_edges)
    if not crop:
        kw.update(H=16, W=32)
    jcfg, tcfg = cfg_pair(**kw)
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp)
    data = fake_data(jcfg, rng)
    ref = jplanar.graph_forward(jax.tree.map(jnp.asarray, jp), to_jax(data), jcfg, jnp.float32(0.2))
    ours = tplanar.graph_forward(g, to_torch(data), tcfg, torch.tensor(0.2))
    assert set(ours) == set(ref)
    for k in ref:
        assert tuple(ours[k].shape) == tuple(ref[k].shape), k
        np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("use_masks,use_edges", [(True, True), (False, True), (True, False)])
def test_graph_loss_and_grads_match_jax(rng, use_masks, use_edges):
    from marf_tpu.ops.losses import summarize_loss as jsum
    from marf_tpu_torch.ops.losses import summarize_loss as tsum

    jcfg, tcfg = cfg_pair(use_masks=use_masks, use_edges=use_edges, alpha_initial=0.3)
    jp = jax_params(jcfg)
    g = port_graph(tcfg, jp)
    data = fake_data(jcfg, rng)
    if not use_masks:
        data.update(masks=None, masks_eroded=None)
    jdata, tdata = to_jax(data), to_torch(data)
    step = 7

    def jloss(params):
        out = jplanar.graph_forward(params, jdata, jcfg, jnp.float32(step / jcfg.max_iter))
        loss = jplanar.graph_loss(out, jdata, jcfg, jnp.int32(step))
        return jsum(loss, jcfg.loss_weight), loss

    (jtotal, jterms), jgrads = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, jp))
    out = tplanar.graph_forward(g, tdata, tcfg, torch.tensor(step / tcfg.max_iter, dtype=torch.float32))
    terms = tplanar.graph_loss(out, tdata, tcfg, torch.tensor(step))
    total = tsum(terms, tcfg.loss_weight)
    total.backward()
    for k in jterms:
        np.testing.assert_allclose(terms[k].detach().numpy(), np.asarray(jterms[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(total.detach().numpy(), np.asarray(jtotal), rtol=1e-5)
    assert rel_err(g.warp.grad.numpy(), jgrads["warp"]) <= 1e-4
    for layer, jl in zip(g.neural_image.layers, jgrads["neural_image"]["mlp"]):
        assert rel_err(layer.weight.grad.numpy().T, jl["w"]) <= 1e-4
        assert rel_err(layer.bias.grad.numpy(), jl["b"]) <= 1e-4
