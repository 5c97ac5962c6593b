"""The trainer's writer thread: the frame boundary's host work and every
TensorBoard write, run in the order they are handed off, while the training
loop goes on dispatching to the card.

`frame(job, it)` hands off one frame's host work (its PNG and TB panels:
numpy, PIL and TB calls on host arrays, never the device). It first waits,
in a `vis.wait` span, until the frame handed off before it has been
written, so the writer holds at most one frame beyond the one being drawn
and a writer that cannot keep up slows the loop instead of piling up work.
`vis_handoffs` counts every hand-off, `vis_waits` those that found the frame
before still being written. The writer runs a frame's job in a `vis.write`
span carrying the frame's `it`. `put(job)` queues a job that waits for no
frame (a scalar write); the FIFO keeps the event file's order that of the
calls.

The thread starts at the first job. An exception in a job is kept, the jobs
queued after it until the next `drain` are skipped, and it is raised once on
the caller's thread, at the next hand-off or at `drain`. `drain()` waits for
every job handed off and stops the thread; a later job starts it again.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

from marf_tpu_torch.utils import trace

THREAD_NAME = "marf-frame-writer"


class FrameWriter:
    def __init__(self):
        self._jobs: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._written: threading.Event | None = None  # set when the last frame handed off is written
        self._error: Exception | None = None  # the first a job raised; the writer skips the jobs after it
        self._raised = False  # whether the caller's thread has raised it

    def put(self, job: Callable[[], None]) -> None:
        """Queue `job` behind every job handed off before it."""
        self._raise()
        self._queue(job, None, None)

    def frame(self, job: Callable[[], None], it: int) -> None:
        """Hand off a frame's host work, once the frame before is written."""
        with trace.span("vis.wait"):
            busy = self._written is not None and not self._written.is_set()
            if busy:
                self._written.wait()
        trace.count("vis_handoffs")
        if busy:
            trace.count("vis_waits")
        self._raise()
        self._written = threading.Event()
        self._queue(job, it, self._written)

    def drain(self) -> None:
        """Wait for every job handed off, stop the thread, and raise what a
        job raised."""
        if self._thread is not None:
            self._jobs.put(None)
            self._thread.join()
            self._thread = None
        try:
            self._raise()
        finally:
            self._error, self._raised = None, False

    def _queue(self, job: Callable[[], None], it: int | None, done: threading.Event | None) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name=THREAD_NAME, daemon=True)
            self._thread.start()
        self._jobs.put((job, it, done))

    def _raise(self) -> None:
        if self._error is not None and not self._raised:
            self._raised = True
            raise self._error

    def _run(self) -> None:
        while (item := self._jobs.get()) is not None:
            job, it, done = item
            try:
                if self._error is None:
                    if done is None:
                        job()
                    else:
                        with trace.span("vis.write", it=it):
                            job()
            except Exception as e:  # noqa: BLE001 - kept, and raised on the caller's thread
                self._error = e
            finally:
                if done is not None:
                    done.set()
