"""The initial parameters from the seed, made on the device in two calls,
and the one naming of the model's leaves that the harness, the check and
the reference share.

Leaves: `mlp.<i>.weight` [out, in] and `mlp.<i>.bias` of the neural image;
`warp` [B, 8]; `mask.<h>.<i>.weight` and `.bias` of mask head h (one per
image, or h = 0 for a shared head); `embedding` [N_vocab, 128], the frozen
view embedding. The distributions are the published model's: nn.Linear's
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases, BARF's first
layer scaled by sqrt(input_dim / 2) under coarse-to-fine, warps zero,
Embedding's N(0, 1).
"""

from __future__ import annotations

import math

import torch

from benchmark import counts

MASK_DIMS = [426, 256, 256, 256, 256, 1]  # 3 x 128 embedded RGB + 42 uv
EMBED_DIM = 128


def shapes(options: dict) -> dict:
    """{leaf: (shape, U bound or None)}: every leaf of the configuration."""
    out = {}
    rgb = counts.rgb_dims(options)
    c2f_scale = math.sqrt(rgb[0][0] / 2.0) if options.get("barf_c2f") and options["arch"].get("posenc") else 1.0
    for i, (k_in, k_out) in enumerate(rgb):
        bound = (c2f_scale if i == 0 else 1.0) / math.sqrt(k_in)
        out[f"mlp.{i}.weight"] = ((k_out, k_in), bound)
        out[f"mlp.{i}.bias"] = ((k_out,), bound)
    out["warp"] = ((int(options["batch_size"]), 8), None)
    if options.get("use_implicit_mask"):
        heads = int(options["batch_size"]) if options.get("build_single_masks") else 1
        for h in range(heads):
            for i, (k_in, k_out) in enumerate(zip(MASK_DIMS[:-1], MASK_DIMS[1:])):
                out[f"mask.{h}.{i}.weight"] = ((k_out, k_in), 1.0 / math.sqrt(k_in))
                out[f"mask.{h}.{i}.bias"] = ((k_out,), 1.0 / math.sqrt(k_in))
        out["embedding"] = ((int(options["N_vocab"]), EMBED_DIM), None)
    return out


def make_init(options: dict, seed: int, device) -> dict:
    """{leaf: float32 tensor on `device`} from the seed: one uniform draw for
    every linear leaf, one normal draw for the embedding."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    spec = shapes(options)
    uniform = [k for k, (_, b) in spec.items() if b is not None]
    sizes = [math.prod(spec[k][0]) for k in uniform]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for k, part in zip(uniform, torch.split(flat, sizes)):
        out[k] = (part * spec[k][1]).reshape(spec[k][0])
    out["warp"] = torch.zeros(spec["warp"][0], device=device)
    if "embedding" in spec:
        out["embedding"] = torch.randn(spec["embedding"][0], generator=gen, device=device)
    return {k: out[k] for k in spec}


def program_leaves(graph) -> dict:
    """{leaf: the port's Parameter} of a `Graph`, by the names above."""
    out = {}
    for i, layer in enumerate(graph.neural_image.layers):
        out[f"mlp.{i}.weight"], out[f"mlp.{i}.bias"] = layer.weight, layer.bias
    out["warp"] = graph.warp
    if hasattr(graph, "implicit_mask"):
        heads = graph.implicit_mask if isinstance(graph.implicit_mask, torch.nn.ModuleList) else [graph.implicit_mask]
        for h, head in enumerate(heads):
            for i, layer in enumerate(head.layers):
                out[f"mask.{h}.{i}.weight"], out[f"mask.{h}.{i}.bias"] = layer.weight, layer.bias
        out["embedding"] = graph.view_embedding
    return out


def write_by_name(graph, values: dict) -> None:
    """Write the given leaves into the port's Graph in place."""
    leaves = program_leaves(graph)
    with torch.no_grad():
        for k, v in values.items():
            leaves[k].copy_(v)


def check_leaves(graph, init: dict) -> None:
    """Raise unless the Graph holds exactly the seed's leaves."""
    leaves = program_leaves(graph)
    if set(leaves) != set(init):
        raise ValueError(f"the program's leaves {sorted(set(leaves) ^ set(init))} differ from the configuration's")
    bad = [k for k, p in leaves.items() if not torch.equal(p.detach(), init[k])]
    if bad:
        raise RuntimeError(f"the program's initial parameters differ from the seed's: {bad}")
