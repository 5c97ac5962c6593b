"""Start the ranks of a pixel-sharded run.

`spawn(fn, n, args)` starts n processes (start method `spawn`, so no CUDA
state crosses a fork), joins them into one process group over a file-store
rendezvous in a temporary directory and runs `fn(mesh, *args)` in each; it
returns each rank's result, in rank order. On the CPU the ranks talk over
gloo; on CUDA rank r takes `cuda:r` over NCCL, and n greater than the number
of cards raises, unless `share_device=True` puts every rank on `cuda:0` over
gloo (NCCL refuses two ranks on one card): a check of the sharded path on a
one-card machine, not a scaling run. The kernel libraries are built in the
parent before the ranks start, so no two ranks run nvcc into the same build
directory.

A rank that raises exits non-zero; the launcher then stops the other ranks
(which would wait in their next collective) and raises. Each rank leaves
the process group in a `finally`.

`python -m marf_tpu_torch.train --tpu.n_devices=2 ...` comes here through
`train_rank`; under `torchrun --nproc_per_node=2 -m marf_tpu_torch.train
...` each process joins the world torchrun set (`env_world`).
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time

import torch

from marf_tpu_torch.parallel.mesh import Mesh, init_mesh


def env_world() -> tuple[int, int, int] | None:
    """(rank, world size, local rank) of a torchrun launch, or None."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", 0))


def rank_device(local_rank: int, cpu: bool, share_device: bool = False) -> tuple[torch.device, str]:
    """A rank's (device, backend): the CPU over gloo, `cuda:0` over gloo
    when the ranks share one card, else `cuda:<local rank>` over NCCL."""
    if cpu:
        return torch.device("cpu"), "gloo"
    if share_device:
        return torch.device("cuda", 0), "gloo"
    return torch.device("cuda", local_rank), "nccl"


def check_cards(world_size: int, share_device: bool) -> None:
    """Raise unless the machine has a card for each rank (or one to share)."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards == 0:
        raise RuntimeError("no CUDA device is available; pass --cpu to run the ranks on the CPU")
    if world_size > n_cards and not share_device:
        raise RuntimeError(f"{world_size} ranks need {world_size} CUDA cards, {n_cards} visible")


def build_kernels() -> None:
    """Compile every kernel library the train step loads (once per source)."""
    from marf_tpu_torch.ops.cuda import _build, fused_implicit, fused_mask, fused_step

    _build.build_libraries({"fused_step": fused_step.SOURCES, "fused_mask": fused_mask.SOURCES,
                            "fused_implicit": fused_implicit.SOURCES})


def _rank_entry(rank, world_size, fn, args, store, cpu, share_device, deterministic, result_path):
    from marf_tpu_torch.utils.console import log

    import torch.distributed as dist

    log.quiet = rank != 0
    torch.use_deterministic_algorithms(deterministic)
    if cpu and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(1)  # as torchrun: one thread per rank unless asked otherwise
    device, backend = rank_device(rank, cpu, share_device)
    mesh = init_mesh(rank, world_size, device, backend, f"file://{store}")
    try:
        result = fn(mesh, *args)
        torch.save(result, result_path)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), *, cpu: bool = False, share_device: bool = False,
          timeout_s: float | None = None) -> list:
    """Run fn(mesh, *args) in `world_size` new processes, one rank each, and
    return their results in rank order. `fn` must be importable (a module
    function); its result is passed back through `torch.save`.

    cpu: every rank on the CPU over gloo. share_device: every rank on
    `cuda:0` over gloo. timeout_s: the ranks are stopped and this raises
    when they have not all ended by then (None: no limit). Each rank takes
    the caller's `torch.use_deterministic_algorithms` setting.

    Raises RuntimeError when a rank exits non-zero or the time runs out;
    the other ranks are stopped first."""
    if not cpu:
        check_cards(world_size, share_device)
        build_kernels()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="marf_ranks_") as tmp:
        paths = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_entry, name=f"rank{r}",
                             args=(r, world_size, fn, args, os.path.join(tmp, "store"), cpu, share_device,
                                   torch.are_deterministic_algorithms_enabled(), paths[r]))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        timed_out = False
        try:
            while True:
                codes = [p.exitcode for p in procs]
                live = [p.sentinel for p, c in zip(procs, codes) if c is None]
                if not live or any(c not in (None, 0) for c in codes):
                    break
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    timed_out = True
                    break
                multiprocessing.connection.wait(live, timeout=None if left is None else min(left, 1.0))
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.exitcode is None:
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if timed_out:
            raise RuntimeError(f"the {world_size} ranks did not end within {timeout_s} s (exit codes {codes})")
        if any(c != 0 for c in codes):
            raise RuntimeError(f"a rank failed: exit codes {codes} (rank order)")
        return [torch.load(path, weights_only=False) for path in paths]


def run_each(mesh: Mesh, calls: list) -> list:
    """Rank body of several jobs in one spawn: [fn(mesh, *args, **kwargs)
    for (fn, args) or (fn, args, kwargs) in calls]."""
    return [fn(mesh, *args, **(kw[0] if kw else {})) for fn, args, *kw in calls]


def state_digest(*state_dicts) -> str:
    """sha256 of the tensors of state dicts (nested dicts and lists walked in
    order): equal digests on two ranks mean bitwise-equal replicas."""
    import hashlib

    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            h.update(repr(x).encode())

    for sd in state_dicts:
        walk(sd)
    return h.hexdigest()


def train_rank(mesh: Mesh, argv: list, opt) -> dict:
    """One rank of `marf_tpu_torch.train.main(argv)` with the launcher's
    resolved options: its trainer's metric history, the kernel launches of
    this run (the counts are set to 0 first), steps/s, its step's path and
    layout and its chunks' modes (engine/step.py `make_train_step`,
    `make_train_chunk`) and the digest of its parameters and optimizer
    state."""
    from marf_tpu_torch.ops.cuda import LAUNCHES
    from marf_tpu_torch.train import main

    for k in LAUNCHES:
        LAUNCHES[k] = 0  # this run's launches only, when a rank runs several
    m = main(argv, mesh=mesh, opt=opt)
    return {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend, "it": m.it,
            "history": m.history, "launches": {k: v for k, v in LAUNCHES.items() if v},
            "steps_per_sec": m.steps_per_sec, "output_path": m.opt.output_path, "path": m.step.path,
            "layout": m.step.layout, "chunk_modes": sorted({c.mode for c in m.chunks.values()}),
            "digest": state_digest(m.graph.state_dict(), m.optimizer.state_dict())}
