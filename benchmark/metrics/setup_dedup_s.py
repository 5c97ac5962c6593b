"""`setup_dedup_s`: the seconds of the program's `setup.dedup` spans (the
shared head's dedup staging on the host: the factoring, the slot0 and
extra columns and their move to the device, inside `setup.make_step`)
begun in the set-up. None where the program has no such span."""

from benchmark.program_spans import before_window


def read(run):
    spans = before_window(run, "setup.dedup")
    return sum(s.end - s.start for s in spans) if spans else None
