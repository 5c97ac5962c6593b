"""Console log with the reference's call surface (reference util.py:44-67):
`log.process/title/info/warn/options`, plain text; the EMA iteration timer
(util.py:69-79) and `colorcode_to_number` (util.py:110-115), as in
marf_tpu/utils/console.py."""

from __future__ import annotations

import time


class Log:
    """`quiet` silences everything but warnings (the ranks other than 0 of a
    sharded run)."""

    quiet = False

    def process(self, pid):
        if not self.quiet:
            print(f"Process ID: {pid}", flush=True)

    def title(self, message):
        if not self.quiet:
            print(message, flush=True)

    def info(self, message):
        if not self.quiet:
            print(message, flush=True)

    def warn(self, message):
        print(f"WARNING: {message}", flush=True)

    def options(self, opt, level=0):
        if self.quiet:
            return
        for key, value in sorted(opt.items()):
            if isinstance(value, dict):
                print("   " * level + f"* {key}:")
                self.options(value, level + 1)
            else:
                print("   " * level + f"* {key}: {value}")


log = Log()


class IterTimer:
    """EMA iteration timer (reference util.py:69-79, momentum 0.99) with a
    steps/sec readout; `toc(n_steps)` takes a chunk of steps, so the per-step
    mean stays comparable to the reference's."""

    def __init__(self, momentum: float = 0.99):
        self.momentum = momentum
        self.it_mean = None
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self, n_steps: int = 1) -> float:
        """Seconds per step of the chunk since `tic`."""
        dt = (time.perf_counter() - self._t0) / max(n_steps, 1)
        self.it_mean = dt if self.it_mean is None else self.it_mean * self.momentum + dt * (1 - self.momentum)
        return dt

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.it_mean if self.it_mean else 0.0


def colorcode_to_number(code: str):
    """'#RRGGBB' hex color -> (r, g, b) ints (reference util.py:110-115)."""
    code = code.lstrip("#")
    return tuple(int(code[i : i + 2], 16) for i in (0, 2, 4))
