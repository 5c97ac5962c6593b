"""Loop kinds: how a traffic file drives the port. A traffic file names its
kind under `loop`; `benchmark/loops/<loop>.py` runs it with `run(ctx) ->
Record`. Everything else about a mix is data in its traffic file."""

from __future__ import annotations

import dataclasses
import math
import subprocess
import time


@dataclasses.dataclass
class Context:
    """What a loop is handed: the run's options (the configuration's with
    the traffic's on top), the traffic file, the seed, the window's seconds,
    whether to trace, the device ("cuda" or "cpu"), the initial parameters,
    the run's directory and the scene's root, the harness's spans, and the
    host clock's reading when the process started; `marks` the set-up's
    points on that clock."""

    options: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    init: dict
    run_dir: str
    data_root: str
    spans: object
    t_start: float
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, label: str) -> None:
        """A point of the set-up on the host clock, for the set-up's breakdown."""
        self.marks.append((label, time.perf_counter()))


@dataclasses.dataclass
class Record:
    """What a loop measured. `e2e`: end-to-end metrics by name; `window`:
    its (start, end) on the host clock; `attempted` and `failed`: steps in
    the window and those whose loss was not finite; `first_steps`: the
    program's readings of the three checked steps (`program.first_steps`); `frame`: for
    the trainer, (png path, the neural image's leaves on the host, the
    iteration) of the last frame of the window; `traced`: the traced
    window (`trace.Window`), `attribution` (`trace.attribute`, steady) with
    its step count; `notes`: lines for standard error; `release`: frees the
    program's state on the device."""

    e2e: dict
    window: tuple
    attempted: int
    failed: int
    first_steps: dict
    steps_per_chunk: int
    frame: tuple | None = None
    traced: object = None
    attribution: dict | None = None
    attribution_steps: int = 0
    notes: list = dataclasses.field(default_factory=list)
    release: object = None


def smi(device: str) -> str:
    """The card's name, power limit and draw, SM clock and temperature."""
    if device != "cuda":
        return "cpu"
    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi failed"


def percentiles(values: list) -> str:
    """p50 and p95 (nearest rank) of a sample, with its count."""
    if not values:
        return "no samples"
    v = sorted(values)
    pick = lambda q: v[max(0, math.ceil(q * len(v)) - 1)]  # noqa: E731
    return f"p50 {pick(0.5) * 1e3:.3f} ms, p95 {pick(0.95) * 1e3:.3f} ms over {len(v)}"
