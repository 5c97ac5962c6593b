"""The port's test thread budget (tests/torch_threads.py): its arithmetic, and
the pools of the process running this test."""

import os

import pytest
import torch

import torch_threads


@pytest.mark.parametrize("cpus, workers, threads", [(8, 1, 8), (8, 6, 1), (8, 16, 1)])
def test_budget_divides_the_cpus_over_the_workers(cpus, workers, threads):
    assert torch_threads.budget(cpus, workers) == threads


def test_this_worker_runs_at_its_budget():
    """torch's pool, and the pools of numpy's BLAS and torch's OpenMP (the
    libraries loaded when the budget is set), hold the budget of this
    process: its CPUs over the xdist workers (1 without xdist)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    expected = torch_threads.budget(len(os.sched_getaffinity(0)), workers)
    assert torch_threads.THREADS == expected
    assert torch.get_num_threads() == expected
    try:
        import threadpoolctl
    except ImportError:  # the budget then sizes torch's pool alone
        return
    pools = [p for p in threadpoolctl.threadpool_info()
             if p["user_api"] in ("blas", "openmp") and ("/numpy" in p["filepath"] or "/torch/" in p["filepath"])]
    assert pools and all(p["num_threads"] == expected for p in pools), pools
