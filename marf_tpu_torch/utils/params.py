"""Carry parameters between marf_tpu's pytree and the port's `Graph`.

The name map is marf_tpu/utils/torch_init.py's, reversed:
  params.neural_image.mlp[i].w [in, out]  <-> neural_image.layers.{i}.weight [out, in] (transposed)
  params.neural_image.mlp[i].b [out]      <-> neural_image.layers.{i}.bias [out]
  params.warp [B, 8]                      <-> warp [B, 8]
  params.implicit_mask.mlp[i].w [in, out] <-> implicit_mask.layers.{i}.weight [out, in] (transposed)
  params.implicit_mask.mlp[i].b [out]     <-> implicit_mask.layers.{i}.bias [out]
  params.view_embedding [N_vocab, 128]    <-> view_embedding [N_vocab, 128]
Per-image mask heads (build_single_masks) carry a leading [B] axis on the JAX
side and are `implicit_mask.{b}.layers.{i}.*` here. Leaves on the JAX side are
numpy arrays (np.asarray of the jax arrays), so neither side needs the other
framework.
"""

from __future__ import annotations

import numpy as np
import torch


def _mlp_from_jax(mlp: list, prefix: str, sd: dict) -> None:
    for i, layer in enumerate(mlp):
        sd[f"{prefix}.layers.{i}.weight"] = torch.from_numpy(np.array(np.asarray(layer["w"], np.float32).T, order="C"))
        sd[f"{prefix}.layers.{i}.bias"] = torch.from_numpy(np.array(layer["b"], np.float32))


def _mlp_to_jax(state_dict: dict, prefix: str) -> list:
    n_layers = len([k for k in state_dict if k.startswith(f"{prefix}.layers.") and k.endswith(".weight")])
    return [
        {
            "w": state_dict[f"{prefix}.layers.{i}.weight"].detach().cpu().numpy().T.copy(),
            "b": state_dict[f"{prefix}.layers.{i}.bias"].detach().cpu().numpy().copy(),
        }
        for i in range(n_layers)
    ]


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """marf_tpu params tree (numpy leaves) -> a `Graph` state_dict (CPU
    float32 tensors) for `graph.load_state_dict`."""
    sd = {}
    _mlp_from_jax(tree["neural_image"]["mlp"], "neural_image", sd)
    sd["warp"] = torch.from_numpy(np.array(tree["warp"], np.float32))
    if "implicit_mask" in tree:
        mlp = tree["implicit_mask"]["mlp"]
        if np.ndim(mlp[0]["b"]) == 2:  # per-image heads: leaves [B, ...]
            for b in range(np.shape(mlp[0]["b"])[0]):
                _mlp_from_jax([{k: np.asarray(v)[b] for k, v in layer.items()} for layer in mlp], f"implicit_mask.{b}", sd)
        else:
            _mlp_from_jax(mlp, "implicit_mask", sd)
        sd["view_embedding"] = torch.from_numpy(np.array(tree["view_embedding"], np.float32))
    return sd


def params_to_jax(state_dict: dict) -> dict:
    """`Graph` state_dict -> marf_tpu params tree with numpy leaves."""
    tree = {"neural_image": {"mlp": _mlp_to_jax(state_dict, "neural_image")},
            "warp": state_dict["warp"].detach().cpu().numpy().copy()}
    if "view_embedding" in state_dict:
        if "implicit_mask.layers.0.weight" in state_dict:
            tree["implicit_mask"] = {"mlp": _mlp_to_jax(state_dict, "implicit_mask")}
        else:
            heads = []
            while f"implicit_mask.{len(heads)}.layers.0.weight" in state_dict:
                heads.append(_mlp_to_jax(state_dict, f"implicit_mask.{len(heads)}"))
            tree["implicit_mask"] = {"mlp": [{k: np.stack([h[i][k] for h in heads]) for k in ("w", "b")}
                                             for i in range(len(heads[0]))]}
        tree["view_embedding"] = state_dict["view_embedding"].detach().cpu().numpy().copy()
    return tree
