"""A sharded run's rank body on a 1-D or 2-D mesh (twin of
marf_tpu/parallel/sharded.py `make_sharded_train_setup` and of
shard_fused.py `make_fused_sharded_setup`, with their chunks).

The step is engine/step.py `make_train_step` given the rank's `Mesh`: a
fused config's kernels on the rank's block of the flat pixel axis, any
other config's partitioned autograd step. A 2-D mesh is checked and laid
out as the 1-D one (parallel/mesh.py `make_mesh_2d`). Its chunks are
engine/step.py `make_train_chunk`'s: on a card, captured in segments split
at the step's collectives (marf_tpu's jit(shard_map(scan(step)))).
"""

from __future__ import annotations

import time

import numpy as np

from marf_tpu_torch.models.planar import Graph, PlanarConfig


def train_steps(mesh, cfg: PlanarConfig, state_dict: dict, data: dict, n_steps: int, optim_opt: dict,
                use_homographies: bool = True, mesh_shape: tuple[int, int] | None = None, capture: bool | None = None,
                chunk: int | None = None) -> dict:
    """n_steps steps from a Graph state_dict on a dataset dict (numpy or
    tensors, the whole dataset on every rank); with mesh_shape (n_batch,
    n_pixel), checked as that 2-D layout of the ranks (parallel/mesh.py
    `make_mesh_2d`). Step 1 runs as an eager one-step chunk (`run_chunk`),
    whose gradients are kept; the rest as chunks of `chunk` steps (None:
    one chunk) through `make_train_chunk` with `capture` (None: captured
    on a card, eager on the CPU; False: eager). The kernel launch counts
    are set to 0 when the step is made. Returns {"metrics": {metric:
    [n_steps] array}, "state_dict": the final one, "grads": the first
    step's {parameter name: tensor}, all on the CPU; "path" and "layout":
    the step's (its log line); "mode": its chunks' (`TrainChunk.mode`);
    "launches": {wrapper: launches}; "digest" of the parameters and
    optimizer state; "host_ms" (the dispatch) and "steps_per_sec" (to the
    metrics' read) per step over the chunks after the first of the rest,
    None with one such chunk}."""
    from marf_tpu_torch.data.planar import to_device
    from marf_tpu_torch.engine.step import make_optimizer, make_train_chunk, make_train_step, run_chunk
    from marf_tpu_torch.ops.cuda import LAUNCHES
    from marf_tpu_torch.parallel.launch import state_digest
    from marf_tpu_torch.parallel.mesh import make_mesh_2d

    if mesh_shape is not None:
        mesh = make_mesh_2d(mesh, *mesh_shape, cfg.batch_size)
    device = mesh.device
    graph = Graph(cfg).to(device)
    graph.load_state_dict(state_dict)
    optimizer, scheduler = make_optimizer(graph, optim_opt, cfg.max_iter)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    step_fn = make_train_step(cfg, graph, optimizer, to_device(data, device), scheduler, use_homographies, mesh)
    rows = [run_chunk(step_fn, 0, 1)]
    grads = {n: p.grad.cpu().clone() for n, p in graph.named_parameters() if p.grad is not None}
    c = chunk or max(n_steps - 1, 1)
    chunks = {}  # by length, as the trainer keeps them
    host = wall = 0.0
    timed = 0
    for i, start in enumerate(range(1, n_steps, c)):
        n = min(c, n_steps - start)
        if n not in chunks:
            chunks[n] = make_train_chunk(step_fn, n, capture)
        t0 = time.perf_counter()
        handle = chunks[n]()
        t1 = time.perf_counter()
        rows.append(handle.result())
        if i:
            host += t1 - t0
            wall += time.perf_counter() - t0
            timed += n
    return {
        "metrics": {k: np.concatenate([r[k] for r in rows]) for k in rows[0]},
        "state_dict": {k: v.cpu() for k, v in graph.state_dict().items()},
        "grads": grads,
        "path": step_fn.path,
        "layout": step_fn.layout,
        "mode": next(iter(chunks.values())).mode if chunks else None,
        "launches": {k: v for k, v in LAUNCHES.items() if v},
        "digest": state_digest(graph.state_dict(), optimizer.state_dict()),
        "host_ms": host * 1e3 / timed if timed else None,
        "steps_per_sec": timed / wall if timed else None,
    }
