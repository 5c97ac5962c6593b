"""`setup_port_s`: the seconds of the port's set-up phases (the program's
`setup.*` spans: load_dataset, build_networks, optimizer, visualizer,
make_step) begun in the set-up; the imports, the scene, the
first chunk and the checked steps are not in it."""

from benchmark.program_spans import before_window

PHASES = ("setup.load_dataset", "setup.build_networks", "setup.optimizer", "setup.visualizer", "setup.make_step")


def read(run):
    spans = [s for name in PHASES for s in before_window(run, name)]
    return sum(s.end - s.start for s in spans) if spans else None
