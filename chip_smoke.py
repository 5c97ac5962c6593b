"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero:
  1. device: a CUDA card is required; its name and power limit (nvidia-smi).
  2. build: compile the fused train-step kernel (K1) from
     marf_tpu_torch/csrc/ with nvcc for sm_90a.
  3. kernel: K1 against its plain PyTorch version at the canonical shape
     (N = 216,000 points, B = 5, L = 8, c2f mid-schedule, synthetic masks, a
     nonzero warp), both also against a float64 run of the plain version;
     two launches on the same inputs must be bitwise equal; time per call.
  4. main path: the port's trainer (`marf_tpu_torch.engine.trainer.Model`)
     on the canonical config (planar.yaml + barf_c2f=[0,0.4]) with synthetic
     data, seed 3, 60 steps, first on the fused path (K1 must launch once per
     step), then on the autograd path (fused_step=off) from the same init.
Then a JSON line with each kernel's numbers, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ITERS = 60
# float32 tolerances, relative to the max-abs of the plain version's output:
# elementwise outputs (rgb, sq) and the loss agree to float32 rounding;
# gradients are sums over 216,000 points taken in different orders (the
# kernel's fixed split-K blocks against cuBLAS's), hence the looser bound.
# Measured on an H100: at most 8.3e-5 against the plain version and 1.2e-4
# against float64, both on dH.
VALUE_TOL = 1e-5
GRAD_TOL = 1e-3
# the fused and autograd trainers start from the same init and differ only
# in float32 summation order; their per-step rgb losses over the first 10
# steps agree to this relative tolerance
TRAJ_TOL = 1e-3


def fail(msg: str):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvidia-smi: {smi}", flush=True)
    return smi


def phase_build():
    from marf_tpu_torch.ops.cuda import _build
    from marf_tpu_torch.ops.cuda import fused_step as fs

    t0 = time.perf_counter()
    fs._library()
    print(f"[build] fused_step.cu: nvcc {_build.BUILD_SECONDS['fused_step']:.2f} s "
          f"(load incl. {time.perf_counter() - t0:.2f} s) -> {_build.BUILD_DIR}", flush=True)


def canonical_inputs(device):
    """K1's inputs at the canonical shape from the port's own modules."""
    from marf_tpu_torch.data.planar import synthesize_planar_dataset
    from marf_tpu_torch.models.neural_image import NeuralImage, NeuralImageConfig
    from marf_tpu_torch.models.planar import PlanarConfig
    from marf_tpu_torch.ops.grid import normalized_pixel_grid
    from marf_tpu_torch.ops.lie import sl3_to_SL3
    from marf_tpu_torch.ops.posenc import barf_c2f_weights

    cfg = PlanarConfig(arch=NeuralImageConfig(barf_c2f=(0.0, 0.4)))
    h, w = cfg.map_hw
    B, HW = cfg.batch_size, h * w
    N = B * HW
    data = synthesize_planar_dataset(cfg, seed=3)
    gen = torch.Generator().manual_seed(3)
    net = NeuralImage(cfg.arch, generator=gen).to(device)
    warp = (torch.randn(B, 8, generator=gen) * 0.05).to(device)
    warp[0] = 0.0
    H = sl3_to_SL3(warp).contiguous()
    grid = normalized_pixel_grid(cfg.grid_spec, crop=True, device=device)
    grid_b = torch.cat([grid.T.repeat(1, B), torch.arange(B, dtype=torch.float32, device=device).repeat_interleave(HW)[None]]).contiguous()
    targets = torch.as_tensor(data["rgb"]).permute(1, 0, 2, 3).reshape(3, N).contiguous().to(device)
    masks = torch.as_tensor(data["masks"]).permute(1, 0, 2, 3).reshape(1, N).contiguous().to(device)
    progress = torch.tensor(0.23, device=device)  # alpha = 4.6 bands: w = [1,1,1,1,0.65,0,0,0]
    cw = barf_c2f_weights(progress, (0.0, 0.4), 8).contiguous()
    g_loss_scale = 1.0 + (1.0 - progress)  # render (1 - alpha) + rgb, alpha = progress here
    inv_sum3 = 1.0 / (masks.sum() * 3.0)
    return net, (grid_b, H, cw, targets, masks, g_loss_scale, inv_sum3)


def _flat(out):
    rgb, loss, dparams, dH, sq = out
    named = {"rgb": rgb, "sq": sq, "loss": loss, "dH": dH}
    for li, (dw, db) in enumerate(dparams):
        named[f"dW{li}"] = dw
        named[f"db{li}"] = db
    return named


def _rel(a, b):
    return ((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30)).item()


def _time_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def phase_kernel(device):
    from marf_tpu_torch.ops.cuda import fused_step as fs

    net, args = canonical_inputs(device)
    grid_b, H, cw, targets, masks, g, inv_sum3 = args
    out = _flat(fs.fused_train_kernel_warp(net, *args))
    out2 = _flat(fs.fused_train_kernel_warp(net, *args))
    ref = _flat(fs.fused_train_kernel_warp_reference(net, *args))
    net64 = copy.deepcopy(net).double()
    ref64 = _flat(fs.fused_train_kernel_warp_reference(
        net64, grid_b.double(), H.double(), cw.double(), targets.double(), masks.double(), g.double(), inv_sum3.double()))
    torch.cuda.synchronize()

    errs = {k: _rel(out[k], ref[k]) for k in out}
    errs64 = {k: _rel(out[k], ref64[k]) for k in out}
    plain64 = {k: _rel(ref[k], ref64[k]) for k in out}
    max_abs = max((out[k] - ref[k]).abs().max().item() for k in out)
    for name, e in {"kernel vs plain": errs, "kernel vs float64": errs64}.items():
        for k, v in e.items():
            tol = VALUE_TOL if k in ("rgb", "sq", "loss") else GRAD_TOL
            if not v <= tol:
                fail(f"{name}: {k} relative error {v:.3e} > {tol:.0e}")
    for k in out:
        if tuple(out[k].shape) != tuple(ref[k].shape) or not torch.isfinite(out[k]).all():
            fail(f"kernel output {k}: shape {tuple(out[k].shape)} or non-finite values")
    bitwise = all(torch.equal(out[k], out2[k]) for k in out)
    if not bitwise:
        fail("two launches on the same inputs differ")
    ms = _time_ms(lambda: fs.fused_train_kernel_warp(net, *args))
    plain_ms = _time_ms(lambda: fs.fused_train_kernel_warp_reference(net, *args))
    fmt = lambda e: " ".join(f"{k}={v:.2e}" for k, v in e.items())
    print(f"[kernel] N={grid_b.shape[1]} max rel err vs plain (tol values {VALUE_TOL:.0e}, grads {GRAD_TOL:.0e}): {fmt(errs)}", flush=True)
    print(f"[kernel] kernel vs float64: {fmt(errs64)}", flush=True)
    print(f"[kernel] plain float32 vs float64: {fmt(plain64)}", flush=True)
    print(f"[kernel] bitwise equal across two launches: {bitwise}; {ms:.3f} ms/call kernel, {plain_ms:.3f} ms/call plain "
          f"(TF32 off); max abs err {max_abs:.3e}", flush=True)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def canonical_options(out_root: str, fused_step: str):
    """The canonical config through the port's config path."""
    from marf_tpu_torch.utils.config import parse_arguments, set_opt

    args = [
        "--model=planar", "--yaml=planar", "--group=smoke", f"--name=canonical_{fused_step}", "--seed=3",
        "--barf_c2f=[0,0.4]", "--dataset=synthetic", f"--max_iter={ITERS}", "--freq.scalar=20",
        f"--tpu.fused_step={fused_step}", f"--output_root={out_root}", "--tb=",
    ]
    return set_opt(parse_arguments(args), interactive=False)


def run_model(opt):
    from marf_tpu_torch.engine.trainer import Model

    m = Model(opt)
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    m.setup_visualizer()
    m.train()
    torch.cuda.synchronize()
    hist = {k: torch.cat([torch.as_tensor(h[k]) for h in m.history]) for k in m.history[0]}
    return m, hist


def phase_main_path(out_root: str):
    from marf_tpu_torch.ops.cuda import fused_step as fs

    fs.LAUNCHES = 0
    m_f, h_f = run_model(canonical_options(out_root, "on"))
    launches = fs.LAUNCHES
    if launches != ITERS or m_f.it != ITERS:
        fail(f"K1 launched {launches} times in {m_f.it} fused steps (expected {ITERS})")
    m_a, h_a = run_model(canonical_options(out_root, "off"))
    if fs.LAUNCHES != launches:
        fail("the autograd path launched K1")
    for name, h in (("fused", h_f), ("autograd", h_a)):
        for k in ("loss_rgb", "loss_render", "all", "finite"):
            if not torch.isfinite(h[k]).all() or (k == "finite" and not bool((h[k] == 1).all())):
                fail(f"{name} path: non-finite {k}")
        if not h["loss_rgb"][-1] < h["loss_rgb"][0]:
            fail(f"{name} path: rgb loss did not decrease ({h['loss_rgb'][0]:.5f} -> {h['loss_rgb'][-1]:.5f})")
    traj = ((h_f["loss_rgb"][:10] - h_a["loss_rgb"][:10]).abs() / h_a["loss_rgb"][:10]).max().item()
    if not traj <= TRAJ_TOL:
        fail(f"fused and autograd rgb losses differ by {traj:.2e} over the first 10 steps (tol {TRAJ_TOL:.0e})")
    rgb = m_f.graph.neural_image(m_f.graph.grid.T.contiguous(), torch.tensor(1.0, device=m_f.device))
    if tuple(rgb.shape) != (3, m_f.cfg.patch_H * m_f.cfg.patch_W) or not torch.isfinite(rgb).all():
        fail("rendered patch has the wrong shape or non-finite values")
    print(f"[main] fused: {m_f.steps_per_sec:.2f} steps/s, K1 launches {launches}/{ITERS} steps, "
          f"rgb loss {h_f['loss_rgb'][0]:.5f} -> {h_f['loss_rgb'][-1]:.5f}, PSNR {h_f['PSNR'][-1]:.3f}", flush=True)
    print(f"[main] autograd (TF32 off): {m_a.steps_per_sec:.2f} steps/s, "
          f"rgb loss {h_a['loss_rgb'][0]:.5f} -> {h_a['loss_rgb'][-1]:.5f}, PSNR {h_a['PSNR'][-1]:.3f}; "
          f"first-10-step rgb loss rel diff fused vs autograd {traj:.2e}", flush=True)
    return launches


def main():
    smi = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    k1 = phase_kernel(device)
    torch.cuda.synchronize()
    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output")
    os.makedirs(out_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_root) as tmp:
        launches = phase_main_path(tmp)
    print(json.dumps({"kernels": [{
        "name": "fused_train_kernel_warp",
        "route": "cuda",
        "source": "marf_tpu_torch/csrc/fused_step.cu",
        "replaces": "marf_tpu/ops/pallas/fused_step.py:272",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
