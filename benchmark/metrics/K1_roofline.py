"""`K1_roofline`: K1's bound time (the larger of its FLOPs over the peak and
its bytes over 3.35 TB/s, counted from shapes in `benchmark/counts.py`)
over its device time per call in the traced eager chunk."""

from benchmark import counts


def read(run):
    k1 = (run.record.attribution or {}).get("K1")
    if not k1 or k1["us"] <= 0:
        return None
    return 100.0 * counts.k1_bound_s(run.options) / (k1["us"] / 1e6 / k1["calls"])
