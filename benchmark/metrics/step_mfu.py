"""`step_mfu`: the whole step's share of the card's peak: the model FLOPs
of a step (the MLP and the mask heads, forward and backward, no recompute;
`benchmark/counts.py`) times `steps_per_s` of the run's untraced window,
over the peak of the configuration's operand type (495 TFLOP/s TF32 for
float32)."""

from benchmark import counts


def read(run):
    rate = run.record.e2e.get("steps_per_s")
    if rate is None:
        return None
    return 100.0 * counts.step_flops(run.options) * rate / counts.peak_flops(run.options)
