"""Carry parameters between marf_tpu's pytree and the port's `Graph`.

The name map is marf_tpu/utils/torch_init.py's, reversed:
  params.neural_image.mlp[i].w [in, out] <-> neural_image.layers.{i}.weight [out, in] (transposed)
  params.neural_image.mlp[i].b [out]     <-> neural_image.layers.{i}.bias [out]
  params.warp [B, 8]                     <-> warp [B, 8]
Leaves on the JAX side are numpy arrays (np.asarray of the jax arrays), so
neither side needs the other framework.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """marf_tpu params tree (numpy leaves) -> a `Graph` state_dict (CPU
    float32 tensors) for `graph.load_state_dict`."""
    if "implicit_mask" in tree or "view_embedding" in tree:
        raise NotImplementedError("implicit-mask parameters are not ported yet (ROADMAP.md Queue 1, slice 2)")
    sd = {}
    for i, layer in enumerate(tree["neural_image"]["mlp"]):
        sd[f"neural_image.layers.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(layer["w"], np.float32).T))
        sd[f"neural_image.layers.{i}.bias"] = torch.from_numpy(np.array(layer["b"], np.float32))
    sd["warp"] = torch.from_numpy(np.array(tree["warp"], np.float32))
    return sd


def params_to_jax(state_dict: dict) -> dict:
    """`Graph` state_dict -> marf_tpu params tree with numpy leaves."""
    n_layers = len([k for k in state_dict if k.startswith("neural_image.layers.") and k.endswith(".weight")])
    mlp = []
    for i in range(n_layers):
        mlp.append({
            "w": state_dict[f"neural_image.layers.{i}.weight"].detach().cpu().numpy().T.copy(),
            "b": state_dict[f"neural_image.layers.{i}.bias"].detach().cpu().numpy().copy(),
        })
    return {"neural_image": {"mlp": mlp}, "warp": state_dict["warp"].detach().cpu().numpy().copy()}
