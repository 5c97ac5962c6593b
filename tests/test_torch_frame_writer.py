"""The trainer's frame writer (marf_tpu_torch/utils/frame_writer.py): the
frame boundary's host part and every TensorBoard write on one thread, one
frame deep, beside the training loop.

CPU: a tiny `Model.train()` writes the same PNGs and TB events, in the same
order, as the host part run in line on the same host arrays; a job that
raises surfaces on the training thread at the next hand-off or at the drain;
a frame hook that ends `train()` by raising leaves every frame handed off on
disk and no writer thread; a slow frame makes the next hand-off wait; and
the tracer keeps spans from several threads apart.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import copy
import os
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from marf_tpu_torch.utils import trace
from marf_tpu_torch.utils.attrdict import AttrDict
from marf_tpu_torch.utils.frame_writer import THREAD_NAME, FrameWriter
from marf_tpu_torch.utils.trace import Tracer

from test_torch_trace import make_opt

HEADS = dict(use_implicit_mask=True, use_masks=False, build_single_masks=True,
             tb=AttrDict(num_images=[4, 8], show_edges=True, show_corners=True))


def _model(opt, cls=None):
    from marf_tpu_torch.engine.trainer import Model

    m = (cls or Model)(opt)
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    m.setup_visualizer()
    return m


def _writer_alive() -> bool:
    return any(t.name == THREAD_NAME and t.is_alive() for t in threading.enumerate())


def _pixels(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


def _events(run_dir: str) -> list:
    """(step, tag, scalar value or encoded image) of every summary value in
    the run's event files, in file order."""
    from tensorboard.backend.event_processing.event_file_loader import RawEventFileLoader
    from tensorboard.compat.proto.event_pb2 import Event

    out = []
    for name in sorted(f for f in os.listdir(run_dir) if f.startswith("events.")):
        for record in RawEventFileLoader(os.path.join(run_dir, name)).Load():
            e = Event.FromString(record)
            for v in e.summary.value:
                out.append((e.step, v.tag, v.image.encoded_image_string if v.HasField("image") else v.simple_value))
    return out


@pytest.mark.parametrize("extra", [{}, HEADS], ids=["fixed_masks", "heads_edges_corners"])
def test_train_writes_what_the_host_part_writes_in_line(tmp_path, monkeypatch, extra):
    """Every job handed to the writer is recorded (its host arrays copied);
    run again in line, in hand-off order, into a second event file and
    frame directory, they give the same events in the same order and the
    same PNG bytes. The frames decode to the renders handed off, and the
    (tag, step) order is that of the `log_scalars` and `visualize` calls."""
    from marf_tpu_torch.utils.tb import SummaryWriter

    handed, calls = [], []
    real_frame, real_put = FrameWriter.frame, FrameWriter.put

    def frame(self, job, it):
        handed.append(("frame", job.func.__name__, copy.deepcopy(job.args)))
        real_frame(self, job, it)

    def put(self, job):
        handed.append(("put", job.func.__name__, copy.deepcopy(job.args)))
        real_put(self, job)

    monkeypatch.setattr(FrameWriter, "frame", frame)
    monkeypatch.setattr(FrameWriter, "put", put)
    m = _model(make_opt(tmp_path, **extra))
    real_vis, real_scalars = m.visualize, m.log_scalars

    def visualize(step=0, split="train"):
        calls.append(("vis", max(step, 1)))
        real_vis(step, split)

    def log_scalars(row, step, split="train"):
        calls.append(("scalars", step))
        real_scalars(row, step, split)

    m.visualize, m.log_scalars = visualize, log_scalars
    m.train()
    assert not _writer_alive()
    run = m.opt.output_path
    threaded = _events(run)
    frames = [args for kind, _, args in handed if kind == "frame"]
    assert len(frames) == m.vis_it == len(os.listdir(m.vis_path)) == 4
    assert [kind for kind, _, _ in handed] == ["frame" if c == "vis" else "put" for c, _ in calls]

    # the same jobs in line, into another event file and frame directory
    sync = tmp_path / "sync"
    os.makedirs(sync / "vis")
    m.tb = SummaryWriter(log_dir=str(sync))
    for kind, fn, args in handed:
        if kind == "frame":
            frame_arr, path, panels, tag_step, split = args
            getattr(m, fn)(frame_arr, str(sync / "vis" / os.path.basename(path)), panels, tag_step, split)
        else:
            getattr(m, fn)(*args)
    m.tb.close()
    assert threaded == _events(str(sync))
    for frame_arr, path, *_ in frames:
        with open(path, "rb") as a, open(sync / "vis" / os.path.basename(path), "rb") as b:
            assert a.read() == b.read(), path
        want = (np.clip(frame_arr, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
        np.testing.assert_array_equal(_pixels(path), want)

    # events in the order of the calls: a frame's panels at max(step, 1), a row's scalars at its step
    order = []
    for step, _, value in threaded:
        key = ("vis" if isinstance(value, bytes) else "scalars", step)
        if not order or order[-1] != key:
            order.append(key)
    assert order == calls
    tags = {tag.split("/")[1] for _, tag, v in threaded if isinstance(v, bytes)}
    want = {"input_images", "predicted_image"} | ({"implicit_masks", "predicted_edges", "warp_corners"} if extra
                                                  else {"input_masks"})
    assert tags == want


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("where", ["hand_off", "drain"])
def test_a_job_that_raises_surfaces_on_the_training_thread(tmp_path, monkeypatch, where):
    """The first frame's host part raises: `train` raises it at the next
    frame's hand-off (step 4). The last frame's raises: `train` raises it
    at the drain, once every step has run. The same on the writer alone."""
    from marf_tpu_torch.engine.trainer import Model

    real = Model._write_frame
    bad_path = "0.png" if where == "hand_off" else "3.png"

    def write_frame(self, frame, path, *args):
        if path.endswith(bad_path):
            raise _Boom(path)
        real(self, frame, path, *args)

    monkeypatch.setattr(Model, "_write_frame", write_frame)
    m = _model(make_opt(tmp_path, save_checkpoint=False, freq=AttrDict(scalar=2, vis=4, ckpt=None)))
    with pytest.raises(_Boom, match=bad_path):
        m.train()
    assert m.it == (4 if where == "hand_off" else 12)
    assert not _writer_alive()

    w = FrameWriter()
    w.frame(_raise_boom, it=0)
    if where == "hand_off":
        with pytest.raises(_Boom):
            w.frame(lambda: None, it=1)
        w.drain()  # raised once
    else:
        with pytest.raises(_Boom):
            w.drain()
    assert not _writer_alive()
    w.frame(lambda: None, it=2)  # a later job starts the thread again
    w.drain()


def _raise_boom():
    raise _Boom("stand-in")


def test_a_hook_that_ends_train_leaves_every_frame_on_disk(tmp_path, monkeypatch):
    """A hook after `visualize` raises at step 8, as the benchmark's window
    does, while that frame is still being written (its host part slowed):
    every frame handed off is on disk when `train` has raised, and no
    writer thread is left."""
    from marf_tpu_torch.engine.trainer import Model

    class Stop(Exception):
        pass

    class Hooked(Model):
        def visualize(self, step=0, split="train"):
            super().visualize(step, split)
            if step == 8:
                raise Stop

    real = Model._write_frame

    def slow(self, *args):
        time.sleep(0.3)
        real(self, *args)

    monkeypatch.setattr(Model, "_write_frame", slow)
    m = _model(make_opt(tmp_path, save_checkpoint=False, freq=AttrDict(scalar=2, vis=4, ckpt=None)), Hooked)
    with pytest.raises(Stop):
        m.train()
    assert m.vis_it == 3 and sorted(os.listdir(m.vis_path)) == ["0.png", "1.png", "2.png"]
    assert all(_pixels(os.path.join(m.vis_path, f)).shape == (m.cfg.H, m.cfg.W, 3) for f in os.listdir(m.vis_path))
    assert not _writer_alive()


@pytest.mark.parametrize("job", ["slow", "fast"])
def test_a_slow_frame_makes_the_next_hand_off_wait(job):
    t0, counters = time.perf_counter(), dict(trace.COUNTERS)
    w = FrameWriter()
    if job == "slow":
        w.frame(lambda: time.sleep(0.2), it=0)
        w.frame(lambda: None, it=1)
        n = 2
    else:
        n, written = 3, threading.Event()
        for k in range(n):
            w.frame(lambda: None, it=k)
            w.put(written.set)  # behind the frame: when it runs, the frame is written
            assert written.wait(5)
            written.clear()
    w.drain()
    grown = {k: trace.COUNTERS.get(k, 0) - counters.get(k, 0) for k in ("vis_handoffs", "vis_waits")}
    waits = [s.end - s.start for s in trace.spans("vis.wait", t0)]
    writes = trace.spans("vis.write", t0)
    assert len(waits) == len(writes) == grown["vis_handoffs"] == n
    assert [s.attrs["it"] for s in writes] == list(range(n))
    if job == "slow":
        assert grown["vis_waits"] == 1 and waits[1] > 0.1
    else:
        assert grown["vis_waits"] == 0 and max(waits) < 0.1


def test_spans_from_many_threads_keep_their_parents_and_totals():
    """Threads opening nested spans and counting at once, the interpreter
    switching threads as often as it can: every index once, each inner
    span's parent the outer span of its own thread, exact totals and
    counters."""
    t = Tracer()
    n_threads, n_iter = 8, 300
    interval = sys.getswitchinterval()

    def work(k):
        for i in range(n_iter):
            with t.span("outer", thread=k, steps=2):
                with t.span("inner", thread=k):
                    t.count("hits")
                t.count("bytes", 3)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    records = list(t.records)
    assert sorted(s.index for s in records) == list(range(2 * n_threads * n_iter))
    by_index = {s.index: s for s in records}
    for s in records:
        if s.name == "inner":
            parent = by_index[s.parent]
            assert parent.name == "outer" and s.attrs["thread"] == parent.attrs["thread"]
            assert parent.start <= s.start <= s.end <= parent.end
        else:
            assert s.parent is None
    assert t.totals["outer"][0] == t.totals["inner"][0] == n_threads * n_iter
    assert t.totals["outer"][2] == 2 * n_threads * n_iter
    assert t.counters == {"hits": n_threads * n_iter, "bytes": 3 * n_threads * n_iter}
