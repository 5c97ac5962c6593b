"""`vis_ms`: the mean host time of a `Model.visualize` call in the window
(the frame's render and PNG, and the TensorBoard panels), from the
harness's span around each call. Trainer loop only."""


def read(run):
    t0, t1 = run.record.window
    ms = [d * 1e3 for d in run.spans.durations("visualize", t0, t1)]
    return sum(ms) / len(ms) if ms else None
