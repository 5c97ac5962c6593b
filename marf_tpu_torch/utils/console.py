"""Console log with the reference's call surface (reference util.py:44-67):
`log.process/title/info/warn/options`, plain text."""

from __future__ import annotations


class Log:
    def process(self, pid):
        print(f"Process ID: {pid}", flush=True)

    def title(self, message):
        print(message, flush=True)

    def info(self, message):
        print(message, flush=True)

    def warn(self, message):
        print(f"WARNING: {message}", flush=True)

    def options(self, opt, level=0):
        for key, value in sorted(opt.items()):
            if isinstance(value, dict):
                print("   " * level + f"* {key}:")
                self.options(value, level + 1)
            else:
                print("   " * level + f"* {key}: {value}")


log = Log()
