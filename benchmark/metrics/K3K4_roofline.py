"""`K3K4_roofline`: the bound time of the shared mask head's forward (K3)
and backward (K4), counted at the HW columns every exact dedup has
(`benchmark/counts_shared.py`), over K3 + K4 device time per step in the
traced eager chunk. None where K3 or K4 did not run (a fallback off the
dedup path shows as a missing metric)."""

from benchmark import counts_shared


def read(run):
    a = run.record.attribution or {}
    if "K3" not in a or "K4" not in a or a["K3"]["us"] + a["K4"]["us"] <= 0:
        return None
    per_step = (a["K3"]["us"] + a["K4"]["us"]) / 1e6 / run.record.attribution_steps
    return 100.0 * counts_shared.k3k4_bound_s(run.options) / per_step
