"""`ops_device_ms`: device milliseconds per step outside the hand-written
kernels K1-K6 (the expm and its VJP, the edges, Adam, the glue): all
device operations of the traced eager chunk minus those inside the kernel
wrappers' ranges, per step."""

from benchmark.program import KERNELS


def read(run):
    a = run.record.attribution
    if not a or a["device_us"] <= 0:
        return None
    kernels = sum(a[tag]["us"] for tag, _, _ in KERNELS if tag in a)
    return (a["device_us"] - kernels) / run.record.attribution_steps / 1e3
