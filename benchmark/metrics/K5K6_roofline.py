"""`K5K6_roofline`: the bound time of the work K5 and K6 do together (the
rgb MLP and the mask heads, forward and backward, each counted once, so
that moving the forward recompute out of K6 leaves the count as it is;
`benchmark/counts.py`) over K5 + K6 device time per step in the traced
eager chunk."""

from benchmark import counts


def read(run):
    a = run.record.attribution or {}
    if "K5" not in a or "K6" not in a or a["K5"]["us"] + a["K6"]["us"] <= 0:
        return None
    per_step = (a["K5"]["us"] + a["K6"]["us"]) / 1e6 / run.record.attribution_steps
    return 100.0 * counts.k5k6_bound_s(run.options) / per_step
