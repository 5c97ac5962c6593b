"""TensorBoard scalar writer with the `torch.utils.tensorboard.SummaryWriter`
calls the trainer makes (`add_scalar`, `flush`, `close`), on tensorboard's
own event-file writer. tensorboard is imported when a writer is made, so the
port runs without it while `--tb=` is empty."""

from __future__ import annotations

import time


class SummaryWriter:
    def __init__(self, log_dir: str, flush_secs: int = 10):
        from tensorboard.summary.writer.event_file_writer import EventFileWriter

        self._writer = EventFileWriter(log_dir, flush_secs=flush_secs)

    def add_scalar(self, tag: str, value, step: int) -> None:
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary

        summary = Summary(value=[Summary.Value(tag=tag, simple_value=float(value))])
        self._writer.add_event(Event(wall_time=time.time(), step=int(step), summary=summary))

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()
