"""`step_host_ms.steady`: host time to dispatch a chunk (on a card, the
replays of its captured graphs and the metric rows' copy), per step, the
mean over the window's chunks, from the harness's span around each
dispatch. Steady loop only."""


def read(run):
    if run.loop != "steady":
        return None
    t0, t1 = run.record.window
    spans = run.spans.durations("dispatch", t0, t1)
    return sum(spans) / len(spans) / run.record.steps_per_chunk * 1e3 if spans else None
