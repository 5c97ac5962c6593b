"""Torch-init transplant loader (parity tool, utils/torch_init.py).

Oracle: a real torch module tree with the reference's state_dict naming
(reference model/planar.py:296-327, 402-426, 477-484) dumped to .npz the same
way the refshims' MARF_DUMP_INIT hook does.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from marf_tpu.models.neural_image import NeuralImageConfig
from marf_tpu.models.planar import PlanarConfig, init_graph_params
from marf_tpu.utils.torch_init import load_torch_init


def _dump_ref_style_npz(path, layers, batch_size, with_mask=False, n_vocab=6):
    """Build a torch module with the reference's naming and dump its state_dict."""
    g = torch.nn.Module()
    g.neural_image = torch.nn.Module()
    g.neural_image.mlp = torch.nn.ModuleList(
        [torch.nn.Linear(k_in, k_out) for k_in, k_out in zip(layers[:-1], layers[1:])]
    )
    g.neural_image.progress = torch.nn.Parameter(torch.tensor(0.0))
    g.warp_param = torch.nn.Embedding(batch_size, 8)
    torch.nn.init.zeros_(g.warp_param.weight)
    if with_mask:
        g.implicit_mask = torch.nn.Module()
        g.implicit_mask.mask_mapping = torch.nn.Sequential(
            torch.nn.Linear(3 * 128 + 42, 16), torch.nn.ReLU(True),
            torch.nn.Linear(16, 16), torch.nn.ReLU(True),
            torch.nn.Linear(16, 16), torch.nn.ReLU(True),
            torch.nn.Linear(16, 16), torch.nn.ReLU(True),
            torch.nn.Linear(16, 1), torch.nn.Sigmoid(),
        )
        g.embedding_view = torch.nn.Embedding(n_vocab, 128)
    sd = {k: v.detach().cpu().numpy() for k, v in g.state_dict().items()}
    np.savez(path, **sd)
    return sd


def _cfg(with_mask=False):
    return PlanarConfig(
        H=16, W=16, patch_H=8, patch_W=8, batch_size=3, max_iter=10,
        use_implicit_mask=with_mask, N_vocab=6,
        arch=NeuralImageConfig(layers=(None, 32, 32, 3), barf_c2f=(0, 0.4)),
    )


def test_transplant_maps_all_tensors(tmp_path):
    cfg = _cfg()
    params = init_graph_params(jax.random.PRNGKey(0), cfg)
    layers = [2 + 4 * 8] + [32, 32, 3]
    path = str(tmp_path / "init.npz")
    sd = _dump_ref_style_npz(path, layers, cfg.batch_size)

    out = load_torch_init(params, path)
    for i in range(3):
        np.testing.assert_array_equal(
            np.asarray(out["neural_image"]["mlp"][i]["w"]),
            sd[f"neural_image.mlp.{i}.weight"].T,
        )
        np.testing.assert_array_equal(
            np.asarray(out["neural_image"]["mlp"][i]["b"]),
            sd[f"neural_image.mlp.{i}.bias"],
        )
    np.testing.assert_array_equal(np.asarray(out["warp"]), sd["warp_param.weight"])
    # original untouched (loader returns a copy)
    assert not np.array_equal(
        np.asarray(params["neural_image"]["mlp"][0]["w"]),
        np.asarray(out["neural_image"]["mlp"][0]["w"]),
    )


def test_transplant_implicit_mask_and_view_embedding(tmp_path, monkeypatch):
    import marf_tpu.models.implicit_mask as im

    monkeypatch.setattr(im, "MASK_MLP_WIDTH", 16)
    cfg = _cfg(with_mask=True)
    params = init_graph_params(jax.random.PRNGKey(0), cfg)
    layers = [2 + 4 * 8] + [32, 32, 3]
    path = str(tmp_path / "init.npz")
    sd = _dump_ref_style_npz(path, layers, cfg.batch_size, with_mask=True)

    out = load_torch_init(params, path)
    for i in range(5):
        np.testing.assert_array_equal(
            np.asarray(out["implicit_mask"]["mlp"][i]["w"]),
            sd[f"implicit_mask.mask_mapping.{2 * i}.weight"].T,
        )
    np.testing.assert_array_equal(
        np.asarray(out["view_embedding"]), sd["embedding_view.weight"]
    )


def test_transplant_shape_mismatch_raises(tmp_path):
    cfg = _cfg()
    params = init_graph_params(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / "init.npz")
    _dump_ref_style_npz(path, [34, 64, 64, 3], cfg.batch_size)  # wrong width
    with pytest.raises(ValueError, match="shape mismatch"):
        load_torch_init(params, path)


def test_transplant_forward_matches_torch_oracle(tmp_path):
    """End-to-end: transplanted marf MLP == the torch module it came from."""
    from marf_tpu.models.neural_image import apply_neural_image

    cfg = _cfg()
    params = init_graph_params(jax.random.PRNGKey(0), cfg)
    layers = [2 + 4 * 8] + [32, 32, 3]
    path = str(tmp_path / "init.npz")
    _dump_ref_style_npz(path, layers, cfg.batch_size)
    out = load_torch_init(params, path)

    coords = np.random.RandomState(0).uniform(-1, 1, (7, 2)).astype(np.float32)
    got = apply_neural_image(
        out["neural_image"], jnp.asarray(coords), cfg.arch, progress=jnp.float32(1.0)
    )

    # torch oracle: posenc (all bands on at progress=1) + the dumped linears
    d = np.load(path)
    x = torch.from_numpy(coords)
    freqs = 2.0 ** torch.arange(8, dtype=torch.float32) * np.pi
    spectrum = x[..., None] * freqs  # [N, 2, L]
    enc = torch.cat([spectrum.sin(), spectrum.cos()], dim=-1).reshape(7, -1)
    feat = torch.cat([x, enc], dim=-1)
    for i in range(3):
        w = torch.from_numpy(d[f"neural_image.mlp.{i}.weight"])
        b = torch.from_numpy(d[f"neural_image.mlp.{i}.bias"])
        feat = feat @ w.T + b
        feat = torch.relu(feat) if i < 2 else torch.sigmoid(feat)
    np.testing.assert_allclose(np.asarray(got), feat.numpy(), rtol=1e-4, atol=1e-5)
