"""Training entry point of the port (the reference CLI, same flags as the
repository's train.py):

    python -m marf_tpu_torch.train --group=<GROUP> --model=planar --yaml=planar \
        --name=<NAME> --seed=3 --barf_c2f=[0,0.4] --dataset=synthetic

Runs on CUDA device 0, the step captured as CUDA graphs and replayed
(engine/step.py `make_train_chunk`; a rank's step in segments split at its
collectives); `--cpu` runs on the CPU instead, eagerly.
`main(argv, capture=False)` runs the card's step eagerly (the oracle). With
`--tpu.n_devices=N` (or MARF_DEVICES=N) and N > 1 it starts N ranks, one
process each, that train pixel-sharded (marf_tpu_torch/parallel/): rank r on
`cuda:r` over NCCL, or all on the CPU over gloo under `--cpu`. Under
`torchrun --nproc_per_node=N -m marf_tpu_torch.train ...` each process
joins the world torchrun set.
"""

import os
import sys

from marf_tpu_torch.utils.console import log


def main(argv=None, mesh=None, opt=None, capture=None, **launch_options):
    """Train with the options of `argv` (default sys.argv[1:]) and return the
    Model; `capture` is the Model's (None: captured on a card, False:
    eager). Without `mesh`, a run of N > 1 devices starts its ranks here and
    returns their results (parallel/launch.py `spawn` with `launch_options`:
    share_device, timeout_s; `train_rank`), or, under
    torchrun, joins its world and trains this rank. A spawned rank passes
    its `mesh` and the launcher's resolved `opt` (one run name for all
    ranks)."""
    from marf_tpu_torch.engine.trainer import Model, resolve_n_devices
    from marf_tpu_torch.utils.config import parse_arguments, save_options_file, seed_rngs, set_opt

    argv = sys.argv[1:] if argv is None else list(argv)
    log.process(os.getpid())
    log.title("[marf_tpu_torch.train] (PyTorch/CUDA planar bundle-adjusting NeRF)")
    if opt is None:
        opt = set_opt(opt_cmd=parse_arguments(argv))
    elif opt.get("seed") is not None:
        seed_rngs(opt.seed)
    if opt.model != "planar":
        raise ValueError(f"unknown model {opt.model!r} (available: planar)")
    n_dev = resolve_n_devices(opt)
    if n_dev > 1 and mesh is None:
        return _start_ranks(opt, argv, n_dev, launch_options)
    if mesh is None or mesh.rank == 0:
        save_options_file(opt)
    m = Model(opt, mesh, capture)
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    m.setup_visualizer()
    m.train()
    return m


def _start_ranks(opt, argv: list, n_dev: int, launch_options: dict):
    """Spawn the n_dev ranks, or join torchrun's world as one of them."""
    from marf_tpu_torch.parallel import launch

    cpu = bool(opt.get("cpu"))
    world = launch.env_world()
    if world is None:
        return launch.spawn(launch.train_rank, n_dev, (argv, opt), cpu=cpu, **launch_options)
    rank, size, local = world
    if size != n_dev:
        raise RuntimeError(f"{n_dev} devices asked for, but torchrun started {size} processes")
    import torch.distributed as dist

    from marf_tpu_torch.parallel.mesh import barrier, init_mesh

    if not cpu:
        launch.check_cards(size, False)
    log.quiet = rank != 0
    mesh = init_mesh(rank, size, *launch.rank_device(local, cpu))
    try:
        names = [opt.name, opt.output_path]  # one run directory: rank 0's (a seedless name is random)
        dist.broadcast_object_list(names, src=0)
        opt.name, opt.output_path = names
        if not cpu:
            if local == 0:
                launch.build_kernels()  # once per machine, before any rank loads a library
            barrier(mesh)
        return main(argv, mesh=mesh, opt=opt)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
