"""`idle_share.steady`: 1 - (the union of the device's operations / the
window), in %, over the traced window of captured chunks. Steady loop only."""


def read(run):
    w = run.record.traced
    if run.loop != "steady" or w is None or w.busy_us <= 0:
        return None
    return 100.0 * w.idle_share
