"""Trainer lifecycle around the train step (twin of marf_tpu/engine/trainer.py).

Same five phases as the reference `Model` (reference train.py:24-31,
model/planar.py:31-292): load_dataset -> build_networks -> setup_optimizer ->
setup_visualizer -> train. The data is the on-disk `data/planar/<set>`
layout or `--dataset=synthetic`; `load_torch_init` copies a reference init
into the graph; `load` / `resume` restore a checkpoint (engine/checkpoint.py)
and carry its step. The loop runs `gcd(freq.scalar, freq.vis, freq.ckpt)`
steps per chunk (engine/step.py `make_train_chunk`: on a card the step is
captured as CUDA graphs after the first chunk, and replayed; chunks are kept
by length, as marf_tpu's `_chunk` keeps its compiled programs) and reads each
chunk's metrics (every step's finite flag, the chunk-final scalars) back in
one copy. The loop runs one chunk deep, as marf_tpu's `_train_loop` does:
chunk k + 1 is dispatched before chunk k's metrics are read, and the
pipeline drains before a vis frame, a checkpoint, the end and the profiler
window's edges, so what the run writes is that of the unpipelined loop, and
a non-finite loss raises one chunk late, naming its step. TensorBoard gets
the reference's scalar tags `train/loss_*`, `train/PSNR`, `train/Homography_Error` and, for
implicit masks with premade masks, `train/Mask_Error` at `freq.scalar`. At
step 0 and every `freq.vis` boundary a full-canvas render is written to
`vis/<n>.png` with the image panels; a checkpoint at every `freq.ckpt`
boundary and at the end (unless `save_checkpoint: false`); `vis.mp4` from the
frames at the end. The step's constants (the flat streams, the mask-head
inputs and their dedup structures) are built once when `train` makes the
step.

A frame boundary has a device part and a host part. `visualize` runs the
device part before the next chunk is dispatched: the render, the panels'
forward and every array the panels show, copied to the host. The host part
(the PNG, the TB panels) and every TB scalar write run on one writer thread
(utils/frame_writer.py), in call order, one frame deep, while the card trains
the next segment; `train` drains it at its end, before the final checkpoint,
vis.mp4 and the event file's close, so the files are those the loop wrote
in line. Outside `train`, `visualize` and `log_scalars` return once written.

With more than one device (`tpu.n_devices` or MARF_DEVICES, `resolve_n_devices`)
the Model is one rank of a pixel-sharded run (marf_tpu_torch/parallel/): it is
given its `Mesh`, every rank loads or synthesizes the same dataset, takes rank
0's initial parameters and trains its block of the pixel axis
(engine/step.py `make_train_step` with the mesh): a fused config with its
kernels on the rank's block (marf_tpu's trainer turns off the ones its
shard_map cannot run; the port runs every fused config's kernels), any
other on the partitioned autograd step. Rank 0 alone writes the TB events, vis frames, the
mp4 and the checkpoints; the ranks meet at a barrier after each checkpoint
write and before a restore. The checkpoint is the single-card one, so a run
resumes on another number of ranks.
"""

from __future__ import annotations

import functools
import os
import shutil
import subprocess

import numpy as np
import torch
import tqdm

from marf_tpu_torch.data.planar import load_planar_dataset, synthesize_planar_dataset, to_device
from marf_tpu_torch.engine.checkpoint import resolve_restore_path, restore_checkpoint, save_checkpoint
from marf_tpu_torch.engine.step import chunk_schedule, make_optimizer, make_train_chunk, make_train_step
from marf_tpu_torch.models.planar import Graph, PlanarConfig, graph_forward
from marf_tpu_torch.ops.grid import crop_corners, normalized_pixel_grid
from marf_tpu_torch.ops.warp import warp_corners
from marf_tpu_torch.parallel.mesh import barrier
from marf_tpu_torch.utils import trace
from marf_tpu_torch.utils import vis as vis_lib
from marf_tpu_torch.utils.config import resolve_device
from marf_tpu_torch.utils.console import IterTimer, colorcode_to_number, log
from marf_tpu_torch.utils.frame_writer import FrameWriter


def resolve_n_devices(opt) -> int:
    """Number of ranks: env MARF_DEVICES > --tpu.n_devices > 'auto' (twin of
    marf_tpu's `_resolve_n_devices`). 'auto' is the world a torchrun launch
    set (WORLD_SIZE), else 1; marf_tpu's takes every chip of a TPU slice."""
    raw = os.environ.get("MARF_DEVICES")
    if raw is None:
        raw = (opt.get("tpu") or {}).get("n_devices", "auto")
    if raw in (None, "", "auto"):
        return int(os.environ.get("WORLD_SIZE", 1))
    n = int(raw)
    if n < 1:
        raise ValueError(f"tpu.n_devices={n}: need at least 1")
    return n


class Model:
    """Planar bundle-adjustment trainer (the reference Model's lifecycle);
    with `mesh`, one rank of a pixel-sharded run. `capture` is
    `make_train_chunk`'s: None captures the step on a card (a rank's step
    in segments split at its collectives), False runs it eagerly (the
    oracle)."""

    def __init__(self, opt, mesh=None, capture: bool | None = None):
        self.opt = opt
        self.capture = capture
        self.cfg = PlanarConfig.from_options(opt)
        n_dev = resolve_n_devices(opt)
        if (mesh.world_size if mesh else 1) != n_dev:
            raise RuntimeError(f"{n_dev} devices asked for, {mesh.world_size if mesh else 1} rank(s) given: start the "
                               "ranks through marf_tpu_torch.train.main or torchrun")
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        self.device = resolve_device(bool(opt.get("cpu"))) if mesh is None else mesh.device
        self.dataset = opt.get("dataset")
        os.makedirs(opt.output_path, exist_ok=True)
        self.use_homographies = bool(opt.get("use_homographies", False))
        self.data = None
        self.graph = None
        self.optimizer = None
        self.scheduler = None
        self.tb = None
        self.writer = FrameWriter()  # its thread starts at the first frame or TB write
        self._in_train = False  # inside `train`, which drains the writer at its end
        self.box_colors = None
        self.vis_path = None
        self.video_fname = None
        self.timer = None
        self.it = 0
        self.vis_it = 0
        self._saved_at = None  # the step of the last checkpoint this run wrote
        self._full_grid = None
        self._trace_base = trace.snapshot()  # what the tracer held before this Model: the summary subtracts it
        self._iter_marks = None  # the tracer's train.iter totals when `train` began and after its first chunk
        self.history = []  # per chunk: {metric: [steps] array}
        self.step = None  # the step `train` runs (engine/step.py `TrainStep`)
        self.chunks = {}  # make_train_chunk's chunks of the step `train` runs, by length

    # ---------------------------------------------------------------- phases

    def load_dataset(self):
        """Phase 1: load or synthesize the dataset on the host once and move
        it to the device (reference model/planar.py:59-78)."""
        with trace.span("setup.load_dataset"):
            log.info("loading dataset...")
            if self.dataset == "synthetic":
                raw = synthesize_planar_dataset(self.cfg, seed=int(self.opt.get("seed") or 0))
                if not self.cfg.use_masks:
                    raw = dict(raw, masks=None, masks_eroded=None)
            else:
                raw = load_planar_dataset(
                    self.cfg,
                    self.dataset,
                    root=(self.opt.get("data") or {}).get("root"),
                    use_masks=self.cfg.use_masks or self.cfg.use_implicit_mask,
                    use_homographies=self.use_homographies,
                    use_edges=self.cfg.use_edges,
                )
            if raw.get("gt_hom") is None:
                self.use_homographies = False
            self.data = to_device(raw, self.device)

    def build_networks(self):
        """Phase 2: init parameters from an explicit generator seeded by --seed."""
        with trace.span("setup.build_networks"):
            log.info("building networks...")
            gen = torch.Generator().manual_seed(int(self.opt.get("seed") or 0))
            self.graph = Graph(self.cfg, generator=gen).to(self.device)
            torch_init = self.opt.get("load_torch_init")
            if torch_init:
                from marf_tpu_torch.utils.torch_init import load_torch_init

                load_torch_init(self.graph, torch_init)
            if self.mesh is not None:
                from marf_tpu_torch.parallel.mesh import broadcast_module

                broadcast_module(self.graph)

    def setup_optimizer(self):
        """Phase 3: per-group optimizer (reference model/planar.py:86-104),
        then the checkpoint that `load` or `resume` names, whose step the run
        continues from. A requested restore that finds nothing raises."""
        with trace.span("setup.optimizer"):
            log.info("setting up optimizers...")
            self.optimizer, self.scheduler = make_optimizer(self.graph, dict(self.opt.optim), self.cfg.max_iter)
            load, resume = self.opt.get("load"), self.opt.get("resume")
            restore = resolve_restore_path(self.opt.output_path, load, resume)
            if restore is None and (load or resume):
                raise FileNotFoundError(f"no checkpoint to restore (load={load!r}, resume={resume!r}) "
                                        f"under {self.opt.output_path}")
            if restore:
                barrier(self.mesh)  # a checkpoint another rank is writing is whole before any rank reads it
                log.info(f"restoring checkpoint from {restore}")
                self.it = restore_checkpoint(restore, self.graph, self.optimizer, self.scheduler, self.device)

    def setup_visualizer(self):
        """Phase 4: the TensorBoard writer when `tb` is configured, the vis
        directory and the per-image border colors (reference
        model/planar.py:106-134)."""
        with trace.span("setup.visualizer"):
            log.info("setting up visualizers...")
            if self.opt.get("tb") is not None and self.is_main:
                from marf_tpu_torch.utils.tb import SummaryWriter

                self.tb = SummaryWriter(log_dir=self.opt.output_path, flush_secs=10)
            colors = [colorcode_to_number(c) for c in vis_lib.BOX_COLORS[: self.cfg.batch_size]]
            self.box_colors = np.array(colors).astype(int)
            self.vis_path = f"{self.opt.output_path}/vis"
            if self.is_main:
                os.makedirs(self.vis_path, exist_ok=True)
            self.video_fname = f"{self.opt.output_path}/vis.mp4"

    # ------------------------------------------------------------------ train

    def make_step(self):
        """The train step `train` runs (engine/step.py `make_train_step` on
        this Model's graph, optimizer, data and mesh; twin of marf_tpu's
        `_build_compiled`). Its constants are built here, once."""
        with trace.span("setup.make_step"):
            return make_train_step(
                self.cfg, self.graph, self.optimizer, self.data, self.scheduler,
                use_homographies=self.use_homographies, mesh=self.mesh,
            )

    def chunk(self, step, n: int):
        """The chunk of n steps of `step` (`make_train_chunk`, this Model's
        `capture`), kept by length."""
        if n not in self.chunks:
            self.chunks[n] = make_train_chunk(step, n, self.capture)
        return self.chunks[n]

    def train(self):
        """Phase 5: the chunked training loop (reference model/planar.py:136-170),
        one chunk deep (module docstring).

        `--profile=N` traces chunks [1, 1 + N) of this loop (chunk 0 carries
        the kernels' build, warm-up and the capture) with torch.profiler, CPU
        activity and CUDA activity on a card, written by
        `tensorboard_trace_handler` as one `<worker>.<ns>.pt.trace.json` under
        `<output_path>/profile` (view: tensorboard --logdir <run>/profile, or
        chrome://tracing). A pure overlay: the cadences and the metrics are
        those of the run without it. Under a mesh, rank 0 alone traces.

        Every chunk is a `train.iter` span (utils/trace.py) holding its
        dispatch and the metric reads it waits for; the frame, checkpoint
        and video boundaries are spans of their own. The run ends with the
        tracer's summary of this Model's spans and counters. The writer
        thread is drained in the loop's `finally`, so a hook that ends the
        loop by raising still leaves every frame handed off on disk."""
        log.title("TRAINING START")
        self.timer = IterTimer()
        self._iter_marks = [trace.total("train.iter")]
        freq = self.opt.freq
        step = self.step = self.make_step()
        step.set_step(self.it)
        max_iter = int(self.cfg.max_iter)
        ckpt_freq = freq.get("ckpt")
        c = chunk_schedule(max_iter, freq.scalar, freq.vis, ckpt_freq)
        profile_chunks = int(self.opt.get("profile") or 0) if self.is_main else 0
        profiler = None
        pbar = tqdm.tqdm(total=max_iter, desc="Training", leave=False, initial=self.it, disable=not self.is_main)
        postfix = {}
        pending = None  # (it after the chunk, its steps, its ChunkMetrics), dispatched and not yet read

        def consume(p):
            """Read a chunk's metrics: every step's finite flag, then the
            scalars at the freq.scalar cadence."""
            nonlocal postfix
            it_k, n_k, handle = p
            with trace.span("train.read", it=it_k, steps=n_k):
                md = handle.result()
                self.history.append(md)
                finite = md["finite"]
                if not finite.all():
                    first_bad = it_k - n_k + int(np.argmin(finite)) + 1
                    raise FloatingPointError(f"non-finite loss at iteration {first_bad}")
                if it_k % freq.scalar == 0:
                    with trace.span("train.scalars"):
                        row = {k: float(v[-1]) for k, v in md.items() if k != "finite"}
                        if self.tb:
                            self.log_scalars(row, step=it_k)
                        postfix = dict(it=it_k, loss=f"{row['all']:.3f}",
                                       it_per_sec=f"{self.timer.steps_per_sec:.1f}")
                        log.info(f"it {it_k}/{max_iter}  loss {row['all']:.5f}  PSNR {row['PSNR']:.3f}"
                                 f"  {self.steps_per_sec:.1f} steps/s")
                pbar.update(n_k)
                pbar.set_postfix(**postfix)

        chunk_idx = 0
        self._in_train = True
        try:
            if self.is_main:
                self.visualize(step=0)  # reference model/planar.py:152-153
            while self.it < max_iter:
                n = min(c, max_iter - self.it)
                if profile_chunks and chunk_idx == 1:
                    if pending is not None:
                        consume(pending)
                        pending = None
                    profiler = self._start_profiler()
                self.timer.tic()
                with trace.span("train.iter", it=self.it + n, steps=n):
                    with trace.span("train.dispatch", steps=n):
                        handle = self.chunk(step, n)()
                    self.it += n
                    needs_state = (self.it % freq.vis == 0 or (ckpt_freq and self.it % ckpt_freq == 0)
                                   or self.it >= max_iter or profiler is not None)
                    if pending is not None:
                        consume(pending)  # waits for chunk k while chunk k + 1 runs
                    pending = (self.it, n, handle)
                    if needs_state:
                        consume(pending)
                        pending = None
                self.timer.toc(n)
                if chunk_idx == 0:
                    self._iter_marks.append(trace.total("train.iter"))
                chunk_idx += 1
                if profiler is not None and chunk_idx >= 1 + profile_chunks:
                    self._stop_profiler(profiler)
                    profiler = None
                if self.it % freq.vis == 0 and self.is_main:
                    self.visualize(step=self.it)
                if ckpt_freq and self.it % ckpt_freq == 0:
                    self.save_checkpoint()
        finally:
            pbar.close()
            if profiler is not None:
                self._stop_profiler(profiler)
            self._in_train = False
            self.writer.drain()
        if self.opt.get("save_checkpoint", True) and self._saved_at != self.it:
            self.save_checkpoint()
        if self.is_main:
            with trace.span("train.video"):
                self._mux_video()
        if self.tb:
            self.tb.flush()
            self.tb.close()
        log.info(f"mean steps/sec: {self.steps_per_sec:.2f}")
        for line in trace.summary(self._trace_base):
            log.info(line)
        log.title("TRAINING DONE")

    def _start_profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        handler = torch.profiler.tensorboard_trace_handler(f"{self.opt.output_path}/profile")
        profiler = torch.profiler.profile(activities=acts, on_trace_ready=handler)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        profiler.stop()  # writes the trace
        log.info(f"profiler trace written to {self.opt.output_path}/profile")

    def save_checkpoint(self) -> str | None:
        """The training state at `self.it` under `<output_path>/ckpt/<it>`,
        written by rank 0; every rank waits for it."""
        self._saved_at = self.it
        path = None
        with trace.span("train.ckpt", it=self.it):
            if self.is_main:
                path = save_checkpoint(self.opt.output_path, self.it, self.graph, self.optimizer, self.scheduler)
            barrier(self.mesh)
        return path

    @property
    def steps_per_sec(self) -> float:
        """Steps per second over the `train.iter` spans (a chunk's dispatch
        and the metric reads it waits for, device work included) of every
        chunk of the last `train` after the first (the first one carries the
        kernel build and warm-up); over the first chunk alone while it is the
        only one. Read from the tracer's totals, which never drop."""
        if self._iter_marks is None:
            return 0.0
        now = trace.total("train.iter")
        base = self._iter_marks[-1] if now[0] > self._iter_marks[-1][0] else self._iter_marks[0]
        _, seconds, steps = (a - b for a, b in zip(now, base))
        return steps / seconds if seconds > 0 else 0.0

    def log_scalars(self, row: dict, step: int, split: str = "train"):
        """Publish the reference's scalar tags (model/planar.py:226-254), on
        the writer thread behind every TB write handed off before."""
        self.writer.put(functools.partial(self._write_scalars, dict(row), step, split))
        if not self._in_train:
            self.writer.drain()

    def _write_scalars(self, row: dict, step: int, split: str) -> None:
        for key in ("render", "rgb", "mask", "edge"):
            if self.cfg.loss_weight.get(key) is not None and f"loss_{key}" in row:
                self.tb.add_scalar(f"{split}/loss_{key}", row[f"loss_{key}"], step)
        for key in ("Homography_Error", "Mask_Error"):
            if key in row:
                self.tb.add_scalar(f"{split}/{key}", row[key], step)
        self.tb.add_scalar(f"{split}/PSNR", row["PSNR"], step)

    def predict_entire_image(self) -> np.ndarray:
        """[3, H, W] full-canvas render of the neural image at progress
        max(it - 1, 0) / max_iter (reference model/planar.py:211-217)."""
        if self._full_grid is None:
            self._full_grid = normalized_pixel_grid(self.cfg.grid_spec, crop=False, device=self.device).T.contiguous()
        progress = torch.tensor(max(self.it - 1, 0) / self.cfg.max_iter, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            rgb = self.graph.neural_image(self._full_grid, progress)
        return rgb.reshape(3, self.cfg.H, self.cfg.W).cpu().numpy()

    def visualize(self, step: int = 0, split: str = "train"):
        """The frame `vis/<n>.png` and the TB image panels (reference
        model/planar.py:256-292): the input images and masks on the first
        call, the predicted image, the implicit masks, and the predicted
        edges and warped patch corners under their `tb` flags. Panels land on
        step max(step, 1), as the reference tags it + 1. The device part runs
        here, in one `train.vis` span holding `vis.render`,
        `vis.panel_forward` and the hand-off's `vis.wait`; it ends by handing
        the host part (`_write_frame`) to the writer thread and opens no
        device work after it (module docstring)."""
        with trace.span("train.vis", it=self.it):
            with trace.span("vis.render"):
                frame = self.predict_entire_image()
            panels = self._panel_arrays() if self.tb else None
            path = f"{self.vis_path}/{self.vis_it}.png"
            self.vis_it += 1
            self.writer.frame(functools.partial(self._write_frame, frame, path, panels, max(step, 1), split),
                              it=self.it)
        if not self._in_train:
            self.writer.drain()

    def _panel_arrays(self) -> dict:
        """What the TB panels show besides the frame, copied to the host: the
        input images and masks on the first call, the panels' forward maps,
        the warped patch corners."""
        host = {}
        if self.vis_it == 0:
            host["rgb"] = self.data["rgb"].cpu().numpy()
            if self.cfg.use_masks and self.data.get("masks") is not None:
                host["masks"] = self.data["masks"].cpu().numpy()
        tb_opt = self.opt.get("tb") or {}
        show_edges = bool(tb_opt.get("show_edges")) and self.cfg.use_edges
        if self.cfg.use_implicit_mask or show_edges:
            with trace.span("vis.panel_forward"):  # the forward and its maps' copy to the host
                progress = torch.tensor(max(self.it - 1, 0) / self.cfg.max_iter, dtype=torch.float32,
                                        device=self.device)
                with torch.no_grad():
                    out = graph_forward(self.graph, self.data, self.cfg, progress)
                shown = ["mask_prediction"] * self.cfg.use_implicit_mask + ["edge_prediction"] * show_edges
                host.update({k: out[k].cpu().numpy() for k in shown})
        if bool(tb_opt.get("show_corners")):
            with torch.no_grad():
                host["corners"] = warp_corners(crop_corners(self.cfg.grid_spec, self.device),
                                               self.graph.warp).cpu().numpy()  # [B, 4, 2]
        return host

    def _write_frame(self, frame: np.ndarray, path: str, panels: dict | None, tag_step: int, split: str) -> None:
        """`visualize`'s host part, on the writer thread: numpy, PIL and TB
        calls on host arrays."""
        from PIL import Image

        with trace.span("vis.png"):
            Image.fromarray((np.clip(frame, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)).save(path)
            trace.count("frames")
            trace.count("frame_bytes", os.path.getsize(path))
        if panels is not None:
            with trace.span("vis.panels"):
                self._tb_panels(frame, panels, tag_step, split)

    def _tb_panels(self, frame: np.ndarray, host: dict, tag_step: int, split: str) -> None:
        """The TB image panels of a frame, from `_panel_arrays`' host arrays."""
        colors = self.box_colors
        if "rgb" in host:
            vis_lib.tb_image(self.opt, self.tb, tag_step, split, "input_images",
                             vis_lib.color_border(host["rgb"], colors))
        if "masks" in host:
            vis_lib.tb_image(self.opt, self.tb, tag_step, split, "input_masks",
                             vis_lib.color_border(host["masks"], colors))
        vis_lib.tb_image(self.opt, self.tb, tag_step, split, "predicted_image", frame[None])
        if "mask_prediction" in host:
            h, w = self.cfg.map_hw
            mask = host["mask_prediction"].reshape(self.cfg.batch_size, h, w, 1).transpose(0, 3, 1, 2)
            vis_lib.tb_image(self.opt, self.tb, tag_step, split, "implicit_masks",
                             vis_lib.color_border(mask, colors, width=1, depth=1))
        if "edge_prediction" in host:
            # the reference ships this panel commented out (model/planar.py:288-292)
            vis_lib.tb_image(self.opt, self.tb, tag_step, split, "predicted_edges", host["edge_prediction"])
        if "corners" in host:
            # the current warped patch windows on the canvas (the reference's
            # warp_corners, warp.py:83-93, is never called)
            spec, cn = self.cfg.grid_spec, host["corners"]
            px = np.empty_like(cn)
            px[..., 0] = (cn[..., 0] / spec.norm_w + 1) / 2 * self.cfg.W - 0.5
            px[..., 1] = (cn[..., 1] / spec.norm_h + 1) / 2 * self.cfg.H - 0.5
            overlay = vis_lib.draw_corner_boxes(np.clip(frame, 0, 1), px, colors)
            vis_lib.tb_image(self.opt, self.tb, tag_step, split, "warp_corners", overlay[None])

    def _mux_video(self):
        """vis.mp4 from the frames (reference model/planar.py:163-165): ffmpeg
        when it is on PATH (the reference's invocation), else a cv2
        VideoWriter mp4v; the frames stay in vis/ either way. Only the
        `<int>.png` frames are muxed, unreadable or odd-sized ones are
        skipped, and a mux failure warns instead of failing a finished run."""
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg:
            subprocess.run(
                [ffmpeg, "-y", "-framerate", "30", "-i", f"{self.vis_path}/%d.png", "-pix_fmt", "yuv420p",
                 self.video_fname],
                check=False,
                capture_output=True,
            )
            return
        try:
            import cv2
        except ImportError:
            log.warn("neither ffmpeg nor cv2 found; skipping vis.mp4 mux (frames kept in vis/)")
            return
        try:
            frames = sorted(
                (f for f in os.listdir(self.vis_path) if f.endswith(".png") and f[: -len(".png")].isdigit()),
                key=lambda f: int(f.split(".")[0]),
            )
            first = None
            for f in frames:
                first = cv2.imread(os.path.join(self.vis_path, f))
                if first is not None:
                    break
            if first is None:
                return
            h, w = first.shape[:2]
            writer = cv2.VideoWriter(self.video_fname, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
            if not writer.isOpened():
                log.warn("cv2 VideoWriter failed to open; skipping vis.mp4 mux")
                return
            written = 0
            for f in frames:
                img = cv2.imread(os.path.join(self.vis_path, f))
                if img is not None and img.shape[:2] == (h, w):
                    writer.write(img)
                    written += 1
            writer.release()
            log.info(f"muxed {written} frames -> {self.video_fname} (cv2 mp4v)")
        except Exception as e:  # noqa: BLE001 - a finished run must not fail on its video
            log.warn(f"vis.mp4 mux failed ({e}); frames kept in {self.vis_path}")
