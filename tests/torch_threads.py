"""The CPU thread budget of the port's tests (not a test module): imported
first by every tests/test_torch_*.py, it sizes this process's torch, BLAS and
OpenMP pools to the CPUs it may use divided by the pytest-xdist workers that
share them (xdist sets PYTEST_XDIST_WORKER_COUNT in each worker).

Each pool otherwise starts one thread per CPU in every worker, so the workers'
threads outnumber the cores many times over and a CPU-bound test runs many
times slower than alone. A file run without xdist keeps every CPU. The ranks
that the multi-rank tests spawn size their own pool (parallel/launch.py)."""

import os

import torch


def budget(cpus: int, workers: int) -> int:
    """Threads per process for `workers` processes sharing `cpus` CPUs."""
    return max(1, cpus // workers)


THREADS = budget(len(os.sched_getaffinity(0)), int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

torch.set_num_threads(THREADS)
try:
    from threadpoolctl import threadpool_limits
except ImportError:  # not on every machine: torch's pool alone
    pass
else:
    threadpool_limits(limits=THREADS)
