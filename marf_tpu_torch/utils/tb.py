"""TensorBoard writer with the `torch.utils.tensorboard.SummaryWriter` calls
the trainer makes (`add_scalar`, `add_image`, `flush`, `close`), on
tensorboard's own event-file writer (twin of marf_tpu/utils/tb.py).
tensorboard is imported when a writer is made, so the port runs without it
while `--tb=` is empty. Each event written adds to the tracer's `tb_events`
and its encoded size to `tb_bytes`; an image is a `tb.image` span
(utils/trace.py)."""

from __future__ import annotations

import io
import time

import numpy as np

from marf_tpu_torch.utils import trace


class SummaryWriter:
    def __init__(self, log_dir: str, flush_secs: int = 10):
        from tensorboard.summary.writer.event_file_writer import EventFileWriter

        self._writer = EventFileWriter(log_dir, flush_secs=flush_secs)

    def add_scalar(self, tag: str, value, step: int) -> None:
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary

        summary = Summary(value=[Summary.Value(tag=tag, simple_value=float(value))])
        self._add(Event(wall_time=time.time(), step=int(step), summary=summary))

    def add_image(self, tag: str, image, step: int) -> None:
        """image: [C, H, W] float array in [0, 1] (C in {1, 3, 4}), written
        as a PNG image summary."""
        from PIL import Image
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary

        with trace.span("tb.image", tag=tag):
            arr = np.asarray(image)
            if arr.ndim == 2:
                arr = arr[None]
            chw = np.clip(arr, 0.0, 1.0)
            hwc = (np.transpose(chw, (1, 2, 0)) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(hwc[..., 0] if hwc.shape[-1] == 1 else hwc).save(buf, format="PNG")
            img = Summary.Image(height=chw.shape[1], width=chw.shape[2], colorspace=chw.shape[0],
                                encoded_image_string=buf.getvalue())
            summary = Summary(value=[Summary.Value(tag=tag, image=img)])
            self._add(Event(wall_time=time.time(), step=int(step), summary=summary))

    def _add(self, event) -> None:
        self._writer.add_event(event)
        trace.count("tb_events")
        trace.count("tb_bytes", event.ByteSize())

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()
