"""The system under test: the port's trainer (`marf_tpu_torch`), built as
`python -m marf_tpu_torch.train` builds it, and the harness's spans around
the calls into it.

`build` gives the port the run's options, points `data.root` at the scene
the harness wrote, writes the initial parameters from the seed into the
port's `Graph` by parameter name, and makes the step once. `BenchModel` is the port's `Model`
with the harness's spans around its calls (each span a host-clock interval
and a `record_function` range named `bench.<name>` for the profiler) and a
hook after each `visualize`; it changes nothing the trainer computes.
`first_steps` drives the step from the seed's state through three steps on
the window's own chunks (captured on a card), from the step counter
`check_start` part-way through the schedule, and reads what the reference
is held to.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time

import numpy as np
import torch

from benchmark import params as params_lib
from marf_tpu_torch.engine.trainer import Model
from marf_tpu_torch.ops.cuda import LAUNCHES, fused_implicit, fused_mask, fused_step
from marf_tpu_torch.ops.cuda._build import BUILD_SECONDS
from marf_tpu_torch.utils.attrdict import AttrDict

# (tag, module, entry point): the hand-written kernels' wrappers
KERNELS = [
    ("K1", fused_step, "fused_train_kernel_warp"),
    ("K2", fused_step, "fused_train_kernel"),
    ("K3", fused_mask, "fused_mask_forward"),
    ("K4", fused_mask, "fused_mask_backward_dedup"),
    ("K5", fused_implicit, "fused_implicit_train_kernel"),
    ("K6", fused_mask, "fused_mask_backward_g"),
]
CHECK_STEPS = 3


def check_start(options: dict) -> int:
    """The step counter at which the checked steps start: where BARF's last
    posenc band is half on and every earlier band fully on (progress
    c2f_start + (L - 1/2) / L of the coarse-to-fine range; 3/8 of max_iter
    without it), so that every band's sin/cos, its c2f weight and the edge
    term's alpha (there 0.375) reach the loss and the gradients. At counter
    0 every band weight is 0 and alpha is 0: a wrong frequency or c2f weight
    would go unseen."""
    posenc = (options["arch"].get("posenc") or {}).get("L_2D")
    c2f = options.get("barf_c2f")
    progress = c2f[0] + (posenc - 0.5) / posenc * (c2f[1] - c2f[0]) if posenc and c2f else 0.375
    return round(progress * int(options["max_iter"]))


class Spans:
    """The harness's spans, kept in memory: (name, start, end) on the host
    clock; each also a `record_function` range `bench.<name>`."""

    def __init__(self):
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function(f"bench.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.records.append((name, t0, time.perf_counter()))

    def durations(self, name: str, t0: float, t1: float) -> list[float]:
        """Seconds of each `name` span that began inside [t0, t1]."""
        return [e - s for n, s, e in self.records if n == name and t0 <= s <= t1]


def _ranged(tag: str, fn):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(f"bench.{tag}"):
            return fn(*args, **kwargs)

    wrapper.bench_wrapped = fn
    return wrapper


def range_kernels() -> None:
    """Put a profiler range `bench.K<i>` around each kernel wrapper, before
    a step is made (the step binds them when it is made). A replayed graph
    runs no wrapper: only eager steps show the ranges."""
    for tag, mod, name in KERNELS:
        fn = getattr(mod, name)
        if not hasattr(fn, "bench_wrapped"):
            setattr(mod, name, _ranged(tag, fn))


class _Pending:
    def __init__(self, handle, spans: Spans):
        self.handle, self.spans = handle, spans

    def result(self) -> dict:
        with self.spans("metrics_read"):
            return self.handle.result()


class SpannedChunk:
    """A `TrainChunk` whose dispatch and metric read are spans."""

    def __init__(self, chunk, spans: Spans):
        self.chunk, self.spans, self.n = chunk, spans, chunk.n

    def __call__(self) -> _Pending:
        with self.spans("dispatch"):
            return _Pending(self.chunk(), self.spans)


class BenchModel(Model):
    """The port's Model with the harness's spans and a hook after each frame.
    `make_step` returns the step the harness made (so `train` runs the step
    whose first steps were checked and whose chunks are captured)."""

    spans: Spans = None
    bench_step = None
    on_frame = None

    def make_step(self):
        return self.bench_step if self.bench_step is not None else super().make_step()

    def chunk(self, step, n: int):
        return SpannedChunk(super().chunk(step, n), self.spans)

    def visualize(self, step: int = 0, split: str = "train"):
        with self.spans("visualize"):
            super().visualize(step, split)
        if self.on_frame is not None:
            self.on_frame(self, step)

    def predict_entire_image(self):
        with self.spans("render"):
            return super().predict_entire_image()

    def log_scalars(self, row: dict, step: int, split: str = "train"):
        with self.spans("tb_scalars"):
            super().log_scalars(row, step, split)


def build(options: dict, seed: int, init: dict, run_dir: str, data_root: str, device: str, spans: Spans,
          visualizer: bool):
    """(BenchModel, its step): the port's five phases up to the step, on the
    run's options, the scene under `data_root` and the seed's parameters."""
    opt = AttrDict(copy.deepcopy(options))
    opt.update(AttrDict(seed=int(seed), output_path=os.path.join(run_dir, "out"), cpu=device == "cpu",
                        data=AttrDict(root=data_root), load=None, resume=False))
    range_kernels()
    m = BenchModel(opt)
    m.spans = spans
    m.load_dataset()
    m.build_networks()
    params_lib.write_by_name(m.graph, init)
    params_lib.check_leaves(m.graph, init)
    m.setup_optimizer()
    if visualizer:
        m.setup_visualizer()
    step = m.bench_step = m.make_step()
    return m, step


def reset(m: Model, step, init: dict, start: int) -> None:
    """The seed's state again, in place (a captured step keeps its storage):
    parameters, Adam's moments and step count; the step counter at `start`."""
    params_lib.write_by_name(m.graph, init)
    with torch.no_grad():
        for state in m.optimizer.state.values():
            for t in state.values():
                if isinstance(t, torch.Tensor):
                    t.zero_()
    step.set_step(start)


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.detach().double())) for k, t in tensors.items()}


def first_steps(m: Model, step, init: dict, capacity: int) -> dict:
    """From the seed's state, three steps through the window's own chunks
    (step 1 a chunk of 1, the heavy graph; steps 2-3 a chunk of 2, light
    then heavy), the counter starting at `check_start`. Returns {"start":
    that counter, "losses": per step {"rgb", "all", "heavy"}, "grads":
    {leaf: the norm of step 1's gradient as Adam holds it, exp_avg / (1 -
    beta1)}, "change": {leaf: the norm of the change after step 3}}; host
    numbers only."""
    start = check_start(m.opt)
    reset(m, step, init, start)
    leaves = {k: p for k, p in params_lib.program_leaves(m.graph).items() if p.requires_grad}
    rows = [(m.chunk(step, 1)().result(), [True])]
    beta1 = {id(p): g["betas"][0] for g in m.optimizer.param_groups for p in g["params"]}
    # a leaf the optimizer never stepped holds no moment: its gradient reads 0
    grads = _norms({k: m.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - beta1[id(p)])
                    for k, p in leaves.items()})
    if capacity >= 2:
        rows.append((m.chunk(step, 2)().result(), [False, True]))
    else:
        rows += [(m.chunk(step, 1)().result(), [True]) for _ in range(CHECK_STEPS - 1)]
    losses = []
    for md, heavy in rows:
        for i, h in enumerate(heavy):
            losses.append({"rgb": float(md["loss_rgb"][i]), "all": float(md["all"][i]), "heavy": h,
                           "finite": bool(md["finite"][i])})
    change = _norms({k: p.detach() - init[k] for k, p in leaves.items()})
    return {"start": start, "losses": losses, "grads": grads, "change": change}


def neural_image_params(m: Model) -> dict:
    """A host copy of the neural image's leaves, by the harness's names."""
    return {k: p.detach().cpu().clone() for k, p in params_lib.program_leaves(m.graph).items() if k.startswith("mlp.")}


def launches_per_step(steps: int) -> dict:
    return {k: v / steps for k, v in LAUNCHES.items() if v}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_seconds() -> dict:
    return dict(BUILD_SECONDS)


def finite_failures(history: list) -> int:
    return int(sum(int(np.sum(~md["finite"].astype(bool))) for md in history))
