"""The benchmark of the port (`marf_tpu_torch`) on NVIDIA cards: `python3
benchmark/run.py` (BENCHMARK.json at the repository's root names the cells)."""
