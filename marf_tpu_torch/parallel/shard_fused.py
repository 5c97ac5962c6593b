"""Which configs train pixel-sharded, and a sharded run's rank body (twin of
marf_tpu/parallel/shard_fused.py).

The sharded step itself is engine/step.py `make_train_step` given a `Mesh`:
every rank runs the single-card kernels on its contiguous block of the flat
pixel axis N = B*HW, with the sums over that axis taken over the ranks. A
config runs sharded when its fused pipeline does and its blocks divide:
the flat pixel axis over the ranks, and per-image heads whole per rank.
marf_tpu runs the other configs on its GSPMD-partitioned XLA step, which is
not ported: here they raise NotImplementedError.
"""

from __future__ import annotations

import torch

from marf_tpu_torch.models.planar import Graph, PlanarConfig, use_fused_implicit, use_fused_step

ROADMAP_ITEM = "ROADMAP.md Queue 1, the GSPMD/autograd twin of marf_tpu/parallel/sharded.py"


def fused_shardable(cfg: PlanarConfig, n_devices: int, device: torch.device) -> bool:
    """Whether a fused pipeline runs pixel-sharded over n_devices ranks: the
    flat pixel axis must divide over them, and per-image heads need whole
    heads per rank (B % n_devices == 0)."""
    h, w = cfg.map_hw
    if use_fused_implicit(cfg, device):
        if cfg.build_single_masks:
            return cfg.batch_size % n_devices == 0
        return (cfg.batch_size * h * w) % n_devices == 0
    return use_fused_step(cfg, device) and (cfg.batch_size * h * w) % n_devices == 0


def check_shardable(cfg: PlanarConfig, n_devices: int, device: torch.device) -> None:
    """Raise NotImplementedError for a config that cannot run sharded (marf_tpu
    runs it on its GSPMD-partitioned XLA step, which is not ported)."""
    if cfg.fused_step == "off":
        raise NotImplementedError(f"{n_devices} ranks with tpu.fused_step=off need the autograd step sharded "
                                  f"({ROADMAP_ITEM}); not ported yet")
    if not fused_shardable(cfg, n_devices, device):
        h, w = cfg.map_hw
        raise NotImplementedError(
            f"this config does not shard over {n_devices} ranks (B={cfg.batch_size}, {h}x{w} patches, "
            f"per-image heads {cfg.build_single_masks}, fused path on {device.type}); marf_tpu runs it on its "
            f"GSPMD step ({ROADMAP_ITEM}), not ported yet")


def train_steps(mesh, cfg: PlanarConfig, state_dict: dict, data: dict, n_steps: int, optim_opt: dict,
                use_homographies: bool = True):
    """n_steps sharded steps from a Graph state_dict on a dataset dict
    (numpy or tensors, the whole dataset on every rank), the twin of marf_tpu's
    `make_fused_sharded_setup` and its chunk. Returns ({metric: [n_steps]
    array}, the final state_dict, the first step's gradients {parameter
    name: tensor}, all on the CPU)."""
    import numpy as np

    from marf_tpu_torch.data.planar import to_device
    from marf_tpu_torch.engine.step import make_optimizer, make_train_step, run_chunk

    graph = Graph(cfg).to(mesh.device)
    graph.load_state_dict(state_dict)
    optimizer, scheduler = make_optimizer(graph, optim_opt, cfg.max_iter)
    step_fn = make_train_step(cfg, graph, optimizer, to_device(data, mesh.device), scheduler, use_homographies, mesh)
    first = run_chunk(step_fn, 0, 1)
    grads = {n: p.grad.cpu().clone() for n, p in graph.named_parameters() if p.grad is not None}
    rest = run_chunk(step_fn, 1, n_steps - 1)
    metrics = {k: np.concatenate([first[k], rest[k]]) for k in first}
    return metrics, {k: v.cpu() for k, v in graph.state_dict().items()}, grads
