"""Load a reference (PyTorch) initial state_dict into the port's `Graph`
(twin of marf_tpu/utils/torch_init.py).

Parity tool: the reference Graph's initial `state_dict()` (reference
model/planar.py:84, right after build_networks), saved as an .npz, is copied
onto the port's parameters so that a run starts from the reference's initial
point. The port stores weights as [out, in], as torch does, so nothing is
transposed.

Name map (npz name -> Graph parameter):
  neural_image.mlp.{i}.weight [out, in]   -> neural_image.layers.{i}.weight
  neural_image.mlp.{i}.bias   [out]       -> neural_image.layers.{i}.bias
  warp_param.weight           [B, 8]      -> warp
  implicit_mask.mask_mapping.{2i}.weight  -> implicit_mask.layers.{i}.weight
  implicit_mask.mask_mapping.{2i}.bias    -> implicit_mask.layers.{i}.bias
  embedding_view.weight       [N_vocab, 128] -> view_embedding
  neural_image.progress       (scalar)    -> ignored (progress is passed per call)

The reference's per-image heads (`build_single_masks`) live in a plain
python dict (reference model/planar.py:322-324), so they never appear in its
state_dict and cannot be loaded.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from marf_tpu_torch.utils.console import log


def load_torch_init(graph: nn.Module, npz_path: str) -> nn.Module:
    """Copy the tensors of a torch-init .npz into `graph` in place; raises
    ValueError on a shape mismatch, warns about npz tensors left unmapped."""
    d = np.load(npz_path)
    used = {"neural_image.progress"}
    pairs = []
    for i, layer in enumerate(graph.neural_image.layers):
        pairs += [(f"neural_image.mlp.{i}.weight", layer.weight), (f"neural_image.mlp.{i}.bias", layer.bias)]
    if "warp_param.weight" in d.files:
        pairs.append(("warp_param.weight", graph.warp))
    if hasattr(graph, "implicit_mask") and "implicit_mask.mask_mapping.0.weight" in d.files:
        if isinstance(graph.implicit_mask, nn.ModuleList):
            raise ValueError("torch-init shape mismatch for implicit_mask.mask_mapping.0.weight: the npz holds one "
                             "shared mask head, the graph one head per image (build_single_masks)")
        for i, layer in enumerate(graph.implicit_mask.layers):
            pairs += [(f"implicit_mask.mask_mapping.{2 * i}.weight", layer.weight),
                      (f"implicit_mask.mask_mapping.{2 * i}.bias", layer.bias)]
    if hasattr(graph, "view_embedding") and "embedding_view.weight" in d.files:
        pairs.append(("embedding_view.weight", graph.view_embedding))
    for name, param in pairs:
        if d[name].shape != tuple(param.shape):
            raise ValueError(f"torch-init shape mismatch for {name}: npz {d[name].shape} vs params {tuple(param.shape)}")
    with torch.no_grad():
        for name, param in pairs:
            param.copy_(torch.from_numpy(d[name]))
            used.add(name)
    unused = sorted(set(d.files) - used)
    if unused:
        log.warn(f"torch-init: {len(unused)} npz tensors not mapped: {unused}")
    log.info(f"torch-init: transplanted {len(used) - 1} tensors from {npz_path}")
    return graph
