"""Trainer lifecycle around the train step (twin of marf_tpu/engine/trainer.py).

Same five phases as the reference `Model` (reference train.py:24-31,
model/planar.py:31-292): load_dataset -> build_networks -> setup_optimizer ->
setup_visualizer -> train. The loop runs `gcd(freq.scalar, freq.vis)` steps
per chunk and reads each chunk's metrics (every step's finite flag, the
chunk-final scalars) back in one copy; TensorBoard gets the reference's
scalar tags `train/loss_*`, `train/PSNR`, `train/Homography_Error` and, for
implicit masks with premade masks, `train/Mask_Error` at `freq.scalar`. The
step's constants (the flat streams, the mask-head inputs and their dedup
structures) are built once when `train` makes the step.

Not ported yet (each logs one line when its config asks for it): vis frames
and the mp4, checkpoint save/resume, `load_torch_init`.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from marf_tpu_torch.data.planar import synthesize_planar_dataset, to_device
from marf_tpu_torch.engine.step import chunk_schedule, make_optimizer, make_train_step, run_chunk
from marf_tpu_torch.models.planar import Graph, PlanarConfig
from marf_tpu_torch.utils.config import resolve_device
from marf_tpu_torch.utils.console import log


class Model:
    """Planar bundle-adjustment trainer (the reference Model's lifecycle)."""

    def __init__(self, opt):
        self.opt = opt
        self.cfg = PlanarConfig.from_options(opt)
        n_dev = (opt.get("tpu") or {}).get("n_devices", "auto")
        if n_dev not in (None, "", "auto", 1) or os.environ.get("MARF_DEVICES") not in (None, "", "1"):
            raise NotImplementedError("multi-device training is not ported yet (ROADMAP.md Queue 1, slice 5)")
        self.device = resolve_device(bool(opt.get("cpu")))
        self.dataset = opt.get("dataset")
        os.makedirs(opt.output_path, exist_ok=True)
        self.use_homographies = bool(opt.get("use_homographies", False))
        self.data = None
        self.graph = None
        self.optimizer = None
        self.scheduler = None
        self.tb = None
        self.it = 0
        self.chunk_times = []  # (steps, seconds) per chunk, device work included
        self.history = []  # per chunk: {metric: [steps] array}

    # ---------------------------------------------------------------- phases

    def load_dataset(self):
        """Phase 1: build the dataset on the host once and move it to the device."""
        log.info("loading dataset...")
        if self.dataset != "synthetic":
            raise NotImplementedError(
                f"dataset {self.dataset!r}: the port loads --dataset=synthetic only; the on-disk loader "
                "is queued in ROADMAP.md"
            )
        raw = synthesize_planar_dataset(self.cfg, seed=int(self.opt.get("seed") or 0))
        if not self.cfg.use_masks:
            raw = dict(raw, masks=None, masks_eroded=None)
        if raw.get("gt_hom") is None:
            self.use_homographies = False
        self.data = to_device(raw, self.device)

    def build_networks(self):
        """Phase 2: init parameters from an explicit generator seeded by --seed."""
        log.info("building networks...")
        if self.opt.get("load_torch_init"):
            log.warn("load_torch_init is not ported yet (ROADMAP.md); using the seeded init")
        gen = torch.Generator().manual_seed(int(self.opt.get("seed") or 0))
        self.graph = Graph(self.cfg, generator=gen).to(self.device)

    def setup_optimizer(self):
        """Phase 3: per-group optimizer (reference model/planar.py:86-104)."""
        log.info("setting up optimizers...")
        self.optimizer, self.scheduler = make_optimizer(self.graph, dict(self.opt.optim), self.cfg.max_iter)
        if self.opt.get("load") or self.opt.get("resume"):
            log.warn("checkpoint load/resume is not ported yet (ROADMAP.md); starting from step 0")

    def setup_visualizer(self):
        """Phase 4: the TensorBoard writer when `tb` is configured."""
        log.info("setting up visualizers...")
        if self.opt.get("tb") is not None:
            from marf_tpu_torch.utils.tb import SummaryWriter

            self.tb = SummaryWriter(log_dir=self.opt.output_path, flush_secs=10)

    # ------------------------------------------------------------------ train

    def train(self):
        """Phase 5: the chunked training loop (reference model/planar.py:136-170)."""
        log.title("TRAINING START")
        freq = self.opt.freq
        if freq.get("vis"):
            log.info("vis frames and the vis.mp4 are not ported yet (ROADMAP.md); skipping them")
        if freq.get("ckpt") or self.opt.get("save_checkpoint", True):
            log.info("checkpoints are not ported yet (ROADMAP.md); no checkpoint is written")
        step_fn = make_train_step(
            self.cfg, self.graph, self.optimizer, self.data, self.scheduler, use_homographies=self.use_homographies
        )
        max_iter = int(self.cfg.max_iter)
        c = chunk_schedule(max_iter, freq.scalar, freq.vis, freq.get("ckpt"))
        while self.it < max_iter:
            n = min(c, max_iter - self.it)
            t0 = time.perf_counter()
            md = run_chunk(step_fn, self.it, n)  # returns after the chunk's device work
            self.chunk_times.append((n, time.perf_counter() - t0))
            self.it += n
            self.history.append(md)
            finite = md["finite"]
            if not finite.all():
                first_bad = self.it - n + int(np.argmin(finite)) + 1
                raise FloatingPointError(f"non-finite loss at iteration {first_bad}")
            if self.it % freq.scalar == 0:
                row = {k: float(v[-1]) for k, v in md.items() if k != "finite"}
                if self.tb:
                    self.log_scalars(row, step=self.it)
                log.info(
                    f"it {self.it}/{max_iter}  loss {row['all']:.5f}  PSNR {row['PSNR']:.3f}"
                    f"  {self.steps_per_sec:.1f} steps/s"
                )
        if self.tb:
            self.tb.flush()
            self.tb.close()
        log.info(f"mean steps/sec: {self.steps_per_sec:.2f}")
        log.title("TRAINING DONE")

    @property
    def steps_per_sec(self) -> float:
        """Steps per second over every chunk after the first (the first one
        carries the kernel build and warm-up); over the first chunk alone
        while it is the only one."""
        timed = self.chunk_times[1:] or self.chunk_times
        n = sum(k for k, _ in timed)
        t = sum(s for _, s in timed)
        return n / t if t > 0 else 0.0

    def log_scalars(self, row: dict, step: int, split: str = "train"):
        """Publish the reference's scalar tags (model/planar.py:226-254)."""
        for key in ("render", "rgb", "mask", "edge"):
            if self.cfg.loss_weight.get(key) is not None and f"loss_{key}" in row:
                self.tb.add_scalar(f"{split}/loss_{key}", row[f"loss_{key}"], step)
        for key in ("Homography_Error", "Mask_Error"):
            if key in row:
                self.tb.add_scalar(f"{split}/{key}", row[key], step)
        self.tb.add_scalar(f"{split}/PSNR", row["PSNR"], step)
