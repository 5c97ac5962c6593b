"""`idle_share.trainer`: 1 - (the union of the device's operations / the
window), in %, over the traced whole segments of the trainer loop (steps,
metric reads, frames and TensorBoard writes). Trainer loop only."""


def read(run):
    w = run.record.traced
    if run.loop != "trainer" or w is None or w.busy_us <= 0:
        return None
    return 100.0 * w.idle_share
