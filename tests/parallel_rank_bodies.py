"""Rank bodies for tests/test_torch_parallel.py that live outside it: a
spawned rank imports the module of the function it runs, and this one
imports neither pytest nor JAX, so the ranks start as fast as the
package's own bodies do."""


def fail_on_rank_1(mesh):
    """Raise on rank 1; return None on the others."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
