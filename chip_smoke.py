"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero:
  1. device: a CUDA card is required; its name and power limit (nvidia-smi).
  2. build: compile the kernel sources of marf_tpu_torch/csrc/ with nvcc for
     sm_90a, one nvcc process per library, all started together.
  3. kernels, each against its plain PyTorch version and against a float64
     run of the plain version (K2's and K5's per-point dcoords: each point's
     error over its own float32 error scale, the backward taken in absolute
     values), with a bitwise-equal relaunch, its time per call beside the
     plain version's and the least time the card could take (FLOPs at the
     card's float32-accurate tensor-core rate, 165 TFLOP/s, or bytes at 3.35
     TB/s), and the GEMM engine it runs on (every kernel on the 3xTF32
     tensor cores):
     - K1 (fused_train_kernel_warp) and K2 (fused_train_kernel) at the
       canonical shape (N = 216,000 points, B = 5, L = 8, c2f mid-schedule,
       synthetic masks, a nonzero warp);
     - K3 (fused_mask_forward) and K4 (fused_mask_backward_dedup) on the dedup
       columns of the canonical synthetic batch with a few saturated pixels,
       so that extra columns occur (E > 0);
     - K5 (fused_implicit_train_kernel) and K6 (fused_mask_backward_g) on all
       N = 216,000 columns of that batch, with 5 per-image heads and with
       one shared head;
     - K1-K6 at compute_dtype = bfloat16 (their bf16 entry points, on the
       bf16 tensor-core engine) on the same inputs, each against its bf16
       plain version and a float64 run that rounds to bf16 at the same cast
       points, by the same rule with the bf16 tolerances below, and bounded
       at the card's dense bf16 rate (989 TFLOP/s); K5 and K6 with 5
       per-image heads (the JSON line's numbers), then with the shared head
       on all N columns, the shape fused_dedup=off gives them;
     - K1 at float32 and bf16 at the noposenc bench case's shape (posenc
       off: L = 0, input_dim 2; c2f off; N = 216,000): printed rows, held
       as K1's;
     - K6 with column counts at the sharded dedup step's shapes (one head on
       rank 0's Klp dedup columns of 2 ranks, cnt from
       slot_dedup_sharded_inputs), at float32 and bf16: printed rows, held
       as K6's; likewise K1 and K2 on rank 1's block, and K5 and K6 on
       rank 1's calls (1 x 108,000; per-image heads 2 x 43,200 at B = 4,
       and 3 x 43,200 at B = 5).
  4. main path: the port's trainer (`marf_tpu_torch.engine.trainer.Model`),
     its step captured as CUDA graphs after the first chunk and replayed,
     one chunk deep (the default on a card), synthetic data, seed 3, each
     run with the launch counts set to 0 just before it and read just after
     (a replay adds the launches its graph recorded):
     - canonical config (planar.yaml + barf_c2f=[0,0.4]), fused (K1 once per
       step) then autograd (no kernel) from the same init;
     - the `implicit` config (+ --use_implicit_mask --use_masks=false), fused
       (K3, K1, K4 once per step, K2 never) then autograd from the same init,
       per-step rgb and mask losses within 1e-3 over the first 10 steps;
     - `implicit` with fused_warp=off (K3, K2, K4 once per step, K1 never),
       per-step rgb and mask losses within 1e-3 of the K1 run's over the
       first 10 steps;
     - `implicit_single` (+ --build_single_masks: per-image heads), fused (K5,
       K6 once per step, K1-K4 never) then autograd, per-step rgb and mask
       losses within 1e-3 over the first 10 steps;
     - `implicit` with fused_dedup=off (K5, K6 once per step), per-step rgb
       and mask losses within 1e-3 of the dedup K1 run's;
     - canonical, `implicit` and `implicit_single` at
       --tpu.compute_dtype=bfloat16, fused (the bf16 K1; K3, K1, K4; K5, K6;
       each once per step) and autograd, and `implicit` fused with
       fused_warp=off (the bf16 K3, K2, K4) and with fused_dedup=off (the
       bf16 K5, K6): finite, falling losses, each fused run's first-step
       loss within 2e-2 of its float32 twin's (the JAX suite's bound), the
       K2 run's per-step losses within 1e-3 of the K1 run's over the first
       10 steps, the fused_dedup=off run's first-step losses within 1e-3 of
       the dedup run's (its 10-step gap printed); the fused and autograd
       bf16 paths round differently (PERF.md), so their gap is printed, not
       held.
  5. lifecycle, through `marf_tpu_torch.train.main` on an on-disk fixture
     (the port's synthetic scene at 360x480, 5 photos, written in the
     `data/planar/<set>` layout by `save_planar_dataset`), each run with the
     launch counts set to 0 just before it and read just after:
     - canonical, 60 fused steps with --freq.vis=20 --freq.ckpt=30 and
       TensorBoard on: K1 60 times, frames 0.png-3.png, the TB image panels
       (input images and masks at step 1, the predicted image at 1, 20, 40,
       60) beside the scalar tags, vis.mp4 with 4 frames (read back with
       cv2), ckpt/30 and ckpt/60; then the same config on the synthetic
       scene, for its steps/s beside the fixture run's;
     - a copy of that run resumed from ckpt/30 (--resume=30): K1 30 times,
       its ckpt/60 (parameters and Adam state) and its last 30 steps'
       metrics bitwise the unbroken run's (its first chunk eager, the
       unbroken run's replayed);
     - the shared-head implicit config, 20 steps with --freq.vis=20: K3, K1
       and K4 20 times each, the train/implicit_masks panel at 1 and 20;
     - 20 fused canonical steps in chunks of 10 each with --optim.algo=Adam,
       AdamW, SGD and RMSprop under a StepLR schedule applied on the device
       (steps 5, gamma 0.5): finite losses, K1 20 times each, the second
       chunk replayed, the learning rate 1e-3 x 0.5^4 after it;
     and the host ms of each vis frame, checkpoint save and restore.
  6. sharded, through the launcher (`marf_tpu_torch.parallel.launch.spawn`,
     each rank running `marf_tpu_torch.train.main`) on 2 ranks: NCCL with
     rank r on cuda:r where the machine has two cards, else both on cuda:0
     over gloo (share_device: correctness, not scaling). Synthetic data,
     seed 3, B = 5 patches of 180x240 (108,000 of 216,000 positions per
     rank): canonical (K1) 60 steps with TB and --freq.ckpt=30, fused_warp=off
     (K2) 20, implicit dedup (K3 -> K1 -> K6 with cnt) 60 and at bf16 20,
     fused_dedup=off (K5 -> K6) 20, per-image heads at B = 4 (K5 -> K6, two
     heads per rank) 20, per-image heads at B = 5 (whole images, 2 | 3 per
     rank: K5 -> K6 once per rank and step) 20; then on the partitioned
     autograd step (no kernel):
     canonical with --tpu.fused_step=off 20, beside 1 rank captured and 1
     rank eager. Each rank
     runs the trainer's default on a card, its step captured in segments
     split at its collectives ("captured (2 ranks, gloo: 2 segments light,
     2 heavy)" on canonical: one more graph than collectives, the
     collectives run between the replays), reports its step's path (fused,
     or autograd) sharded over 2 ranks, and launches each kernel of its
     path once per step, counted through the replays (none on the autograd
     step); the ranks' parameters and Adam state are bitwise equal;
     each float32 run's first 10 steps' losses and PSNR are within 2e-5 of 1
     rank of the same config (bf16 printed); rank 0 alone wrote one events
     file and ckpt/30, ckpt/60; the 2-rank ckpt/30 resumed on 1 rank is
     within 2e-5 of the 2-rank run over steps 31-40; steps/s at 1 and 2
     ranks.
  7. bench, the measurement entry points: `marf_tpu_torch.bench.run_case`
     for the six cases of bench.py at float32 and default knobs, and for
     implicit and implicit_single at bf16, 300 steps each (one warm-up chunk
     of 100, two timed): a finite steps/s > 0 and final PSNR, the case's
     kernels once per timed step and no other (K1; K3, K1, K4; K5, K6; their
     bf16 entry points at bf16), the golden skipped off cat_batch3; one
     `python -m marf_tpu_torch.bench` process (canonical) held the same way
     from its one stdout line; one `marf_tpu_torch.train.main` run with
     --profile=1 (60 steps in chunks of 20): one trace file under
     `<run>/profile` whose device kernels include K1's (encode_kernel,
     tc_presplit_kernel, tc_gemm_kernel, head_kernel, encode_bwd_kernel),
     run in a replayed graph.
  8. capture: on 9 paths (canonical float32 and bf16, canonical autograd,
     implicit dedup float32 and bf16, implicit with fused_warp=off,
     implicit_single float32 and bf16, implicit with fused_dedup=off), the
     captured chunk (`make_train_chunk`) against the eager one from the same
     init, 100 steps in chunks of 20 at full width: every step's metrics,
     the parameters and the optimizer state bitwise equal, each kernel of
     the path once per step counted through the replays, and host ms per
     step (the dispatch), device ms per step (the kernels of one traced
     chunk) and steps/s, captured beside eager; then the sharded twins, 2
     ranks over gloo on cuda:0 through the rank body
     (`marf_tpu_torch.parallel.sharded.train_steps`, one spawn): canonical
     (K1), implicit dedup (K3 -> K1 -> K6 with counts), per-image heads at
     B = 5 (K5 -> K6, 2 | 3 images) and the partitioned autograd step, each
     captured in segments against eager from the same init, 100 steps in
     chunks of 20: every step's metrics and the parameters and optimizer
     state bitwise equal on both ranks, each kernel once per rank and step
     through the replays, the segments per light and heavy step, host ms
     per step and steps/s, captured beside eager beside 1 rank captured.
Then a JSON line with each kernel's numbers (launches: phases 4 to 8, summed
over the ranks; phase 7's bench runs count their timed steps; phase 8 its
captured runs, both ranks of the sharded ones), the
nvidia-smi line, and last
`{"ok": true, "device": {...}}`.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ITERS = 60
# float32 tolerances, relative to the max-abs of the plain version's output:
# elementwise outputs (rgb, sq, m) and the loss agree to float32 rounding;
# gradients are sums over up to 216,000 points taken in different orders
# (the kernels' fixed split-K blocks against cuBLAS's), hence the looser
# bound. Measured on an H100 for K1: at most 8.3e-5 against the plain version
# and 1.2e-4 against float64, both on dH.
VALUE_TOL = 1e-5
GRAD_TOL = 1e-3
# the fused and autograd trainers start from the same init and differ only
# in float32 summation order; their per-step losses over the first 10 steps
# agree to this relative tolerance
TRAJ_TOL = 1e-3
# K2's and K5's per-point dcoords, each point's error over its own float32
# error scale (dcoords_error_scale; the plain version's reading on an H100 is
# in PERF.md): a product kept to ~3 decimal digits (single-pass TF32, 2^-11)
# would not pass
POINT_TOL = 1e-4
# bf16 (compute_dtype = bfloat16) tolerances, relative to the max-abs of the
# bf16 plain version's output. Products are exact in float32 on both sides;
# a float32 sum taken in another order can land on the other side of a bf16
# rounding boundary, and that activation or dz then differs by one bf16 ulp
# (2^-8 of itself) and carries the difference on. Measured on an H100 at
# these shapes: rgb and m within 1.6e-4, gradients and dH within 2.3e-4.
# K2's bf16 dcoords per point are held to float32's POINT_TOL (measured
# 1.7e-5 against the plain version, 3.0e-5 against float64).
BF16_VALUE_TOL = 1e-3
BF16_GRAD_TOL = 1e-3
# the first-step loss of a fused bf16 run against the fused float32 run's
# (marf_tpu's tests/test_fused_step.py test_fused_step_bfloat16)
BF16_LOSS_RTOL = 2e-2
# H100 SXM peaks (NVIDIA's data sheet). The bound takes the card's
# float32-accurate rate on the tensor cores: 3xTF32 does three TF32 products
# per float32 product (hi*hi + hi*lo + lo*hi of the split operands), so 495
# TFLOP/s dense TF32 gives 165 TFLOP/s of float32 products; a bf16 kernel's
# products run at the dense bf16 rate. HBM3 at 3.35 TB/s.
PEAK_FP32_ACCURATE_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# saturated pixels in the K3/K4 inputs: each channel is set to 1.0 with this
# probability, which gives some 1.3k extra columns beside the 43,200 of slot0
SATURATED = 0.002
# the GEMM engines the kernels run on (csrc/tc_gemm.cuh): float32 on 3xTF32,
# compute_dtype = bfloat16 on the bf16 engine
ENGINE = "3xtf32"
ENGINE_NOTE = ("3xtf32 (tc_gemm.cuh, wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32, A from registers, 3 per k8 "
               "step; the rgb pipeline's weights (K1, K2, K5) and the dedup mask head's hidden weights (K3, K4) split "
               "once per call and their B tiles loaded by cp.async.bulk on mbarriers)")
ENGINE_BF16 = "bf16"
ENGINE_BF16_NOTE = ("bf16 (tc_gemm.cuh TbEngine, wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16, A from registers, "
                    "1 per k16 step, B tiles landed by cp.async in core matrices, K- or MN-major; the hidden weights "
                    "converted to bf16 once per call and loaded by cp.async.bulk on mbarriers)")
BF16 = {"tols": (BF16_VALUE_TOL, BF16_GRAD_TOL, POINT_TOL), "peak": PEAK_BF16_FLOPS,
        "engine": (ENGINE_BF16, ENGINE_BF16_NOTE)}


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
    from marf_tpu_torch.ops.cuda import fused_implicit as fi
    from marf_tpu_torch.ops.cuda import fused_mask as fm
    from marf_tpu_torch.ops.cuda import fused_step as fs
    from marf_tpu_torch.parallel.launch import build_kernels

    t0 = time.perf_counter()
    build_kernels()
    fs._library()
    fm._library()
    fi._library()
    secs = ", ".join(f"{name}: nvcc {s:.2f} s" for name, s in _build.BUILD_SECONDS.items())
    print(f"[build] {secs} (in parallel; build + load {time.perf_counter() - t0:.2f} s) -> {_build.BUILD_DIR}", flush=True)


def canonical_inputs(device):
    """K1's and K2's inputs at the canonical shape from the port's own modules."""
    from marf_tpu_torch.data.planar import synthesize_planar_dataset
    from marf_tpu_torch.models.neural_image import NeuralImage, NeuralImageConfig
    from marf_tpu_torch.models.planar import PlanarConfig
    from marf_tpu_torch.ops.grid import normalized_pixel_grid
    from marf_tpu_torch.ops.lie import sl3_to_SL3
    from marf_tpu_torch.ops.posenc import barf_c2f_weights
    from marf_tpu_torch.ops.warp import warp_grid_cf_flat

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
    coords = warp_grid_cf_flat(grid, warp).contiguous()
    targets = torch.as_tensor(data["rgb"]).permute(1, 0, 2, 3).reshape(3, N).contiguous().to(device)
    masks = torch.as_tensor(data["masks"]).permute(1, 0, 2, 3).reshape(1, N).contiguous().to(device)
    progress = torch.tensor(0.23, device=device)  # alpha = 4.6 bands: w = [1,1,1,1,0.65,0,0,0]
    cw = barf_c2f_weights(progress, (0.0, 0.4), 8).contiguous()
    g_loss_scale = 1.0 + (1.0 - progress)  # render (1 - alpha) + rgb, alpha = progress here
    inv_sum3 = 1.0 / (masks.sum() * 3.0)
    return cfg, data, net, (grid_b, H, coords, cw, targets, masks, g_loss_scale, inv_sum3)


def factored_batch(cfg, data, device, n_heads=1):
    """The synthetic batch with a few saturated pixels, factored for the mask
    head, and `n_heads` seeded heads: (rng, heads, uv, onehot, table)."""
    from marf_tpu_torch.models.implicit_mask import ImplicitMask, init_view_embedding
    from marf_tpu_torch.ops.cuda import fused_mask as fm
    from marf_tpu_torch.ops.grid import normalized_pixel_grid

    rng = np.random.RandomState(3)
    rgb = np.where(rng.rand(*data["rgb"].shape) < SATURATED, 1.0, data["rgb"]).astype(np.float32)
    gen = torch.Generator().manual_seed(3)
    heads = [ImplicitMask(gen).to(device) for _ in range(n_heads)]
    view = init_view_embedding(cfg.N_vocab, gen)
    grid = normalized_pixel_grid(cfg.grid_spec, crop=True)
    uv, onehot, table = fm.factor_mask_inputs(view, torch.from_numpy(rgb), grid)
    return rng, heads, uv, onehot, table.to(device)


def mask_inputs(cfg, data, device):
    """K3's and K4's inputs: the K dedup columns of the synthetic batch with
    a few saturated pixels, padded as the trainer pads them (zero columns to
    a multiple of DEDUP_COLUMN_MULTIPLE), a seeded mask head, and
    per-position streams. Returns (K, inputs)."""
    from marf_tpu_torch.engine.step import DEDUP_COLUMN_MULTIPLE
    from marf_tpu_torch.ops.cuda import fused_mask as fm

    rng, (head,), uv, onehot, table = factored_batch(cfg, data, device)
    X, s0map, _, _, cnt = fm.slot_dedup_inputs(uv.numpy(), onehot.numpy())
    B, HW = s0map.shape
    K = X.shape[1]
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    dp = lambda a: d(np.pad(a, ((0, 0), (0, -K % DEDUP_COLUMN_MULTIPLE))))
    layers = fm.mask_w_stack(head, table)
    # a plausible cotangent: sq, esq of a half-fitted image, c = 2 C_m / N
    sq_b, esq_b = d(rng.rand(B, HW) * 0.05), d(rng.rand(B, HW) * 0.5)
    base = cnt * (2.0 * 0.5 / (B * HW)) + np.pad(rng.rand(1, K - HW) * 1e-5, ((0, 0), (HW, 0)))
    abk = d([2.0 / (3 * 0.7 * B * HW), 1e-6, -1e-5])
    return K, (layers, dp(X), d(s0map), sq_b, esq_b, dp(base), dp(cnt), abk)


def heads_inputs(cfg, data, device, n_heads):
    """K5's and K6's inputs without dedup: X [56, N] of the same batch
    (build_mask_x; per image for n_heads = B, head h on columns h HW ..
    (h+1) HW - 1), the heads' effective layers, and [1, N] streams for K6
    with the cotangent scalars of a mid-run step (a, b, k on the device, c =
    2 C_m / N)."""
    from marf_tpu_torch.ops.cuda import fused_mask as fm

    rng, heads, uv, onehot, table = factored_batch(cfg, data, device, n_heads)
    X = fm.build_mask_x(uv, onehot, n_heads > 1)
    if n_heads > 1:
        X = X.transpose(0, 1).reshape(X.shape[1], -1)
    N = X.shape[1]
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    stacks = [fm.mask_w_stack(head, table) for head in heads]
    sq, esq = d(rng.rand(1, N) * 0.05), d(rng.rand(1, N) * 0.5)
    abk = d([2.0 / (3 * 0.7 * N), 1e-6, -1e-5])
    return stacks, X.contiguous().to(device), sq, esq, abk, 2.0 * 1.5 / N


def _rel(a, b):
    return ((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30)).item()


def _rel_pt(a, b, scale):
    """The largest error of any point over that point's own scale."""
    return ((a.double() - b.double()).abs() / scale.clamp_min(1e-30 * scale.max().item())).max().item()


def dcoords_error_scale(net64, coords64, cw64, targets64, m64, dscale):
    """Per point and coordinate [2, N], float64: the scale of float32's error
    in dcoords, the backward of the loss (cotangent dscale (rgb - t) m^2)
    taken again with every term replaced by its absolute value (|W|^T
    through the layers, gated as the float64 forward gates, then for band k
    w_k 2^k pi (a_sin |cos| + a_cos |sin|) in the posenc VJP). Each sum of
    the backward is within some multiple of eps of the sum of its |terms|
    whatever its order, so float32 determines dcoords to eps times this
    scale; dcoords itself, a difference of those terms, can be far smaller."""
    from marf_tpu_torch.models.neural_image import encode_coords_cf

    L = net64.cfg.posenc_L
    layers = [(layer.weight.detach(), layer.bias.detach()) for layer in net64.layers]
    with torch.no_grad():
        z, gates = encode_coords_cf(coords64, L, cw64), []
        for w, b in layers[:-1]:
            z = torch.relu(torch.addmm(b[:, None], w, z))
            gates.append(z > 0)
        rgb = torch.sigmoid(torch.addmm(layers[-1][1][:, None], layers[-1][0], z))
        a = (dscale * (rgb - targets64) * m64 * m64).abs() * rgb * (1.0 - rgb)
        for li in range(len(layers) - 1, -1, -1):
            a = layers[li][0].abs().T @ a
            if li > 0:
                a = a * gates[li - 1]
        freq = (2.0 ** torch.arange(L, dtype=torch.float64, device=a.device) * float(np.float32(np.pi)))[:, None]
        band = cw64[:, None] * freq
        scale = a[:2].clone()
        for c in range(2):
            spec = coords64[c : c + 1] * freq
            a_sin, a_cos = a[2 + 2 * c * L : 2 + (2 * c + 1) * L], a[2 + (2 * c + 1) * L : 2 + (2 * c + 2) * L]
            scale[c] += (band * (a_sin * torch.cos(spec).abs() + a_cos * torch.sin(spec).abs())).sum(0)
    return scale


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


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def mask_grads_rounded_forward(stacks64, X64, cot, seed=0, terms=False):
    """The mask heads' gradients in float64 (head h on its column block of
    X64, cotangent cot(cols, m) of dL/dm) with each pre-activation z of the
    forward moved by u 2^-23 times |z| (or, with terms, times the sum of
    its terms' magnitudes, |W| |x| + |b|: the scale of float32's rounding
    of that sum), u uniform in [-1, 1]: how far the gradients move when the
    forward is rounded as float32 rounds it (a ReLU flips on an activation
    near 0), with no error in any sum."""
    gen = torch.Generator(device=X64.device).manual_seed(seed)
    HW = X64.shape[1] // len(stacks64)
    out = []
    for h, layers in enumerate(stacks64):
        cols = slice(h * HW, (h + 1) * HW)
        with torch.enable_grad():
            params = [(w.detach().requires_grad_(True), b.detach().requires_grad_(True)) for w, b in layers]
            z = X64[:, cols]
            for li, (w, b) in enumerate(params):
                u = 2.0**-23 * (2.0 * torch.rand((w.shape[0], z.shape[1]), generator=gen, device=z.device,
                                                 dtype=z.dtype) - 1.0)
                if terms:
                    with torch.no_grad():
                        size = torch.addmm(b.abs()[:, None], w.abs(), z.abs())
                    z = torch.addmm(b[:, None], w, z) + u * size
                else:
                    z = torch.addmm(b[:, None], w, z) * (1.0 + u)
                z = torch.relu(z) if li + 1 < len(params) else torch.sigmoid(z)
            grads = torch.autograd.grad(z, [t for wb in params for t in wb], cot(cols, z.detach()))
        out.append(list(zip(grads[0::2], grads[1::2])))
    return out


def check_kernel(tag, launch, plain, plain64, value_keys, flops, nbytes, per_point=None,
                 tols=(VALUE_TOL, GRAD_TOL, POINT_TOL), peak=PEAK_FP32_ACCURATE_FLOPS, engine=(ENGINE, ENGINE_NOTE)):
    """Hold a kernel (launch() -> {name: tensor}) against its plain version
    and a float64 run of it; a relaunch must be bitwise equal. Time both and
    compute the bound: the larger of flops over `peak` (the float32-accurate
    tensor-core rate, or the bf16 rate for a bf16 kernel) and bytes over the
    memory rate. per_point: {name: fn(float64 outputs) -> per-point scale}:
    that output is held against the plain version point by point over the
    scale (to the point tolerance, as against float64), in place of the
    max-abs error. tols: (values, gradients, per point)."""
    per_point = per_point or {}
    value_tol, grad_tol, point_tol = tols
    out, out2, ref, ref64 = launch(), launch(), plain(), plain64()
    torch.cuda.synchronize()
    for k in out:
        if tuple(out[k].shape) != tuple(ref[k].shape) or not torch.isfinite(out[k]).all():
            fail(f"{tag} output {k}: shape {tuple(out[k].shape)} or non-finite values")
    errs = {k: _rel(out[k], ref[k]) for k in out}
    errs64 = {k: _rel(out[k], ref64[k]) for k in out}
    plain_errs64 = {k: _rel(ref[k], ref64[k]) for k in out}
    fmt = lambda e: " ".join(f"{k}={v:.2e}" for k, v in e.items())
    print(f"[kernel] {tag} rel err vs plain (tol values {value_tol:.0e}, grads {grad_tol:.0e}): {fmt(errs)}", flush=True)
    print(f"[kernel] {tag} kernel vs float64: {fmt(errs64)}", flush=True)
    print(f"[kernel] {tag} plain float32 vs float64: {fmt(plain_errs64)}", flush=True)
    for k in out:
        tol = value_tol if k in value_keys else grad_tol
        if k in per_point:
            scale = per_point[k](ref64)
            pt = {"kernel vs plain": _rel_pt(out[k], ref[k], scale), "kernel vs float64": _rel_pt(out[k], ref64[k], scale),
                  "plain vs float64": _rel_pt(ref[k], ref64[k], scale)}
            print(f"[kernel] {tag} {k} per point over its float32 error scale (tol {point_tol:.1e}): "
                  + ", ".join(f"{n} {v:.2e}" for n, v in pt.items()), flush=True)
            for n in ("kernel vs plain", "kernel vs float64"):
                if not pt[n] <= point_tol:
                    fail(f"{tag} {n}: {k} per-point error {pt[n]:.3e} > {point_tol:.1e}")
        elif not errs[k] <= tol:
            fail(f"{tag} kernel vs plain: {k} relative error {errs[k]:.3e} > {tol:.0e}")
        # against float64, the kernel may be as far off as twice the plain
        # float32 version where that one is itself off by more than tol: the
        # per-point dcoords of K2 and K5 are differences of posenc terms up to
        # 2^k pi larger than their result, and float32 loses some 4e-2 of
        # their max-abs there whatever the order of the sums (K5 on an H100:
        # plain version 4.16e-2 from float64, kernel 3.82e-2)
        tol64 = max(tol, 2.0 * plain_errs64[k])
        if not errs64[k] <= tol64:
            fail(f"{tag} kernel vs float64: {k} relative error {errs64[k]:.3e} > {tol64:.2e}")
    if not all(torch.equal(out[k], out2[k]) for k in out):
        fail(f"{tag}: two launches on the same inputs differ")
    max_abs = max((out[k] - ref[k]).abs().max().item() for k in out)
    ms = _time_ms(launch)
    plain_ms = _time_ms(plain)
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    print(f"[kernel] {tag} bitwise equal across two launches: True; {ms:.3f} ms/call kernel, {plain_ms:.3f} ms/call "
          f"plain (TF32 off); bound {bound_ms:.3f} ms ({flops / 1e9:.1f} GFLOP at {peak / 1e12:.0f} TFLOP/s, "
          f"{nbytes / 1e6:.1f} MB, {bound_by}); max abs err {max_abs:.3e}; engine {engine[1]}", flush=True)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "engine": engine[0], "bound_flops_per_s": peak}


def _named(rgb, loss, dparams, dgeo, sq, geo_name):
    named = {"rgb": rgb, "sq": sq, "loss": loss, geo_name: dgeo}
    for li, (dw, db) in enumerate(dparams):
        named[f"dW{li}"] = dw
        named[f"db{li}"] = db
    return named


def _mlp_flops(N, dims, dx_layers):
    """2 N (in out) per layer for the forward and the dW products, and for the
    dX products of `dx_layers` (counted from the last layer down)."""
    macs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    return 2 * N * (2 * sum(macs) + sum(macs[len(macs) - dx_layers:]))


def phase_kernels(device):
    from marf_tpu_torch.models.neural_image import NeuralImage, NeuralImageConfig
    from marf_tpu_torch.ops.cuda import fused_implicit as fi
    from marf_tpu_torch.ops.cuda import fused_mask as fm
    from marf_tpu_torch.ops.cuda import fused_step as fs

    cfg, data, net, (grid_b, H, coords, cw, targets, masks, g, inv_sum3) = canonical_inputs(device)
    N = grid_b.shape[1]
    net64 = copy.deepcopy(net).double()
    dims = [net.cfg.input_dim] + [layer.out_features for layer in net.layers]
    weights = [t for layer in net.layers for t in (layer.weight, layer.bias)]
    rgb_flops = _mlp_flops(N, dims, len(dims) - 1)  # dX of every layer, down to d(encoding)
    out_bytes = (3 + 1) * N * 4 + _nbytes(*weights)  # rgb, sq, dW, db
    results = {}

    k1 = (grid_b, H, cw, targets, masks, g, inv_sum3)
    k1_64 = tuple(t.double() for t in k1)
    results["K1"] = check_kernel(
        f"K1 fused_train_kernel_warp N={N}",
        lambda: _named(*fs.fused_train_kernel_warp(net, *k1), "dH"),
        lambda: _named(*fs.fused_train_kernel_warp_reference(net, *k1), "dH"),
        lambda: _named(*fs.fused_train_kernel_warp_reference(net64, *k1_64), "dH"),
        ("rgb", "sq", "loss"), rgb_flops, _nbytes(grid_b, H, cw, targets, masks, *weights) + out_bytes + _nbytes(H),
    )
    k2 = (coords, cw, targets, masks, g, inv_sum3)
    k2_64 = tuple(t.double() for t in k2)
    results["K2"] = check_kernel(
        f"K2 fused_train_kernel N={N}",
        lambda: _named(*fs.fused_train_kernel(net, *k2), "dcoords"),
        lambda: _named(*fs.fused_train_kernel_reference(net, *k2), "dcoords"),
        lambda: _named(*fs.fused_train_kernel_reference(net64, *k2_64), "dcoords"),
        ("rgb", "sq", "loss"), rgb_flops, _nbytes(coords, cw, targets, masks, *weights) + out_bytes + _nbytes(coords),
        # float32 determines dcoords only to ~4e-2 of their max-abs at a few
        # points, and the tensor cores and cuBLAS lose it differently: held
        # point by point, as K5's (below)
        per_point={"dcoords": lambda r64: dcoords_error_scale(net64, *k2_64[:4], 2.0 * k2_64[4] * k2_64[5])},
    )

    K, (layers, X, s0map, sq_b, esq_b, base, cnt, abk) = mask_inputs(cfg, data, device)
    Kp, HW = X.shape[1], s0map.shape[1]
    print(f"[kernel] mask-head dedup columns: K={K} (HW={HW}, E={K - HW}; padded to {Kp}) for N={N} positions",
          flush=True)
    if K <= HW:
        fail("the K3/K4 inputs have no extra dedup columns")
    layers64 = [(w.double(), b.double()) for w, b in layers]
    mdims = [X.shape[0]] + [w.shape[0] for w, _ in layers]
    mweights = [t for wb in layers for t in wb]
    results["K3"] = check_kernel(
        f"K3 fused_mask_forward K={K}",
        lambda: {"m": fm.fused_mask_forward(layers, X)},
        lambda: {"m": fm.fused_mask_forward_reference(layers, X)},
        lambda: {"m": fm.fused_mask_forward_reference(layers64, X.double())},
        ("m",), 2 * K * sum(a * b for a, b in zip(mdims[:-1], mdims[1:])), _nbytes(X, *mweights) + K * 4,
    )
    k4 = (X, s0map, sq_b, esq_b, base, cnt, abk)
    k4_64 = tuple(t.double() for t in k4)

    def named4(grads):
        return {f"d{p}{li}": t for li, (dw, db) in enumerate(grads) for p, t in (("W", dw), ("b", db))}

    results["K4"] = check_kernel(
        f"K4 fused_mask_backward_dedup K={K}",
        lambda: named4(fm.fused_mask_backward_dedup(layers, *k4)),
        lambda: named4(fm.fused_mask_backward_dedup_reference(layers, *k4)),
        lambda: named4(fm.fused_mask_backward_dedup_reference(layers64, *k4_64)),
        (), _mlp_flops(K, mdims, len(mdims) - 2), _nbytes(*k4, *mweights) + _nbytes(*mweights),
    )

    # what float32 can determine of K4's gradients (as K6's, below), with the
    # forward rounded at 2^-23 of each pre-activation and of its sum of terms
    X64, s0map64, sq64, esq64, base64, cnt64, abk64 = k4_64
    seg = base64 + torch.nn.functional.pad(
        (abk64[0] * (s0map64 * sq64).sum(0) + abk64[1] * (s0map64 * esq64).sum(0))[None], (0, Kp - HW))
    ref64 = named4(fm.fused_mask_backward_dedup_reference(layers64, *k4_64))
    for terms, how in ((False, "each pre-activation"), (True, "each pre-activation's sum of |terms|")):
        (rounded,) = mask_grads_rounded_forward([layers64], X64, lambda cols, m: seg * m + abk64[2] * cnt64,
                                                terms=terms)
        print(f"[kernel] K4 fused_mask_backward_dedup K={K} float64 with the forward rounded at 2^-23 of {how} "
              "vs float64: " + " ".join(f"{k}={_rel(v, ref64[k]):.2e}" for k, v in named4(rounded).items()),
              flush=True)

    # the same calls on X read in place at its K columns (a row stride that
    # is no multiple of 4): the engine's layer-0 forward (A = X) and dW (B =
    # X) then take its 4-byte copies, the padded X its 16-byte ones
    if Kp != K:
        cut = lambda t: t[:, :K].contiguous()
        k4k = (cut(X), s0map, sq_b, esq_b, cut(base), cut(cnt), abk)
        t = [_time_ms(lambda: fm.fused_mask_forward(layers, k4k[0])),
             _time_ms(lambda: fm.fused_mask_forward(layers, X)),
             _time_ms(lambda: fm.fused_mask_backward_dedup(layers, *k4k)),
             _time_ms(lambda: fm.fused_mask_backward_dedup(layers, *k4))]
        print(f"[kernel] X in place (K={K}, 4-byte copies) vs padded (K={Kp}, 16-byte copies), ms/call: K3 "
              f"{t[0]:.3f} vs {t[1]:.3f}, K4 {t[2]:.3f} vs {t[3]:.3f}", flush=True)

    # K1-K4 at compute_dtype = bfloat16 on the same inputs: each against its
    # bf16 plain version and a float64 run that rounds to bf16 where they do
    bf = "bfloat16"
    results["K1 bf16"] = check_kernel(
        f"K1 bf16 fused_train_kernel_warp N={N}",
        lambda: _named(*fs.fused_train_kernel_warp(net, *k1, compute_dtype=bf), "dH"),
        lambda: _named(*fs.fused_train_kernel_warp_reference(net, *k1, bf), "dH"),
        lambda: _named(*fs.fused_train_kernel_warp_reference(net64, *k1_64, bf), "dH"),
        ("rgb", "sq", "loss"), rgb_flops, _nbytes(grid_b, H, cw, targets, masks, *weights) + out_bytes + _nbytes(H),
        **BF16,
    )
    results["K2 bf16"] = check_kernel(
        f"K2 bf16 fused_train_kernel N={N}",
        lambda: _named(*fs.fused_train_kernel(net, *k2, compute_dtype=bf), "dcoords"),
        lambda: _named(*fs.fused_train_kernel_reference(net, *k2, bf), "dcoords"),
        lambda: _named(*fs.fused_train_kernel_reference(net64, *k2_64, bf), "dcoords"),
        ("rgb", "sq", "loss"), rgb_flops, _nbytes(coords, cw, targets, masks, *weights) + out_bytes + _nbytes(coords),
        per_point={"dcoords": lambda r64: dcoords_error_scale(net64, *k2_64[:4], 2.0 * k2_64[4] * k2_64[5])},
        **BF16,
    )
    results["K3 bf16"] = check_kernel(
        f"K3 bf16 fused_mask_forward K={K}",
        lambda: {"m": fm.fused_mask_forward(layers, X, bf)},
        lambda: {"m": fm.fused_mask_forward_reference(layers, X, bf)},
        lambda: {"m": fm.fused_mask_forward_reference(layers64, X.double(), bf)},
        ("m",), 2 * K * sum(a * b for a, b in zip(mdims[:-1], mdims[1:])), _nbytes(X, *mweights) + K * 4, **BF16,
    )
    results["K4 bf16"] = check_kernel(
        f"K4 bf16 fused_mask_backward_dedup K={K}",
        lambda: named4(fm.fused_mask_backward_dedup(layers, *k4, compute_dtype=bf)),
        lambda: named4(fm.fused_mask_backward_dedup_reference(layers, *k4, compute_dtype=bf)),
        lambda: named4(fm.fused_mask_backward_dedup_reference(layers64, *k4_64, compute_dtype=bf)),
        (), _mlp_flops(K, mdims, len(mdims) - 2), _nbytes(*k4, *mweights) + _nbytes(*mweights), **BF16,
    )

    # K5 and K6 on all N columns: per-image heads (the JSON line's numbers), then the shared head
    for n_heads, tag in ((cfg.batch_size, ""), (1, " shared")):
        stacks, Xn, sq, esq, abk, c = heads_inputs(cfg, data, device, n_heads)
        stacks64 = [[(w.double(), b.double()) for w, b in layers] for layers in stacks]
        hweights = [t for layers in stacks for wb in layers for t in wb]
        g2C = 2.0 * (1.0 + (1.0 - 0.23))  # 2 C_r at progress 0.23, as K1's inputs
        g2C_t = torch.tensor(g2C, device=device)  # the kernel takes it on the device
        k5 = (coords, Xn, cw, targets)
        k5_64 = tuple(t.double() for t in k5)

        def named5(out):
            rgb, m, sq5, dcoords, msum, loss, dmlp = out
            return {"m": m, "msum": msum, **_named(rgb, loss, dmlp, dcoords, sq5, "dcoords")}

        # K5's dcoords on the tensor cores come out closer to float64 than the
        # plain version's at some points (in max-abs terms 2.90e-2 against
        # 4.16e-2 on an H100), so the two differ there by float32's own
        # 4e-2: they are compared point by point, each over its float32
        # error scale
        results["K5" + tag] = check_kernel(
            f"K5 fused_implicit_train_kernel N={N} heads={n_heads}",
            lambda: named5(fi.fused_implicit_train_kernel(net, stacks, *k5, g2C_t)),
            lambda: named5(fi.fused_implicit_train_kernel_reference(net, stacks, *k5, g2C_t)),
            lambda: named5(fi.fused_implicit_train_kernel_reference(net64, stacks64, *k5_64, g2C)),
            ("rgb", "sq", "loss", "m", "msum"), rgb_flops + 2 * N * sum(a * b for a, b in zip(mdims[:-1], mdims[1:])),
            _nbytes(*k5, *weights, *hweights) + out_bytes + N * 4 * (1 + 2) + 8,  # + m, dcoords, msum, loss
            per_point={"dcoords": lambda r64: dcoords_error_scale(net64, k5_64[0], k5_64[2], k5_64[3], r64["m"], g2C)},
        )
        k6 = (Xn, sq, esq, abk)
        k6_64 = tuple(t.double() for t in k6)

        def named6(grads):
            return {f"h{h}.{k}": t for h, hg in enumerate(grads) for k, t in named4(hg).items()}

        results["K6" + tag] = check_kernel(
            f"K6 fused_mask_backward_g N={N} heads={n_heads}",
            lambda: named6(fm.fused_mask_backward_g(stacks, *k6, c)),
            lambda: named6(fm.fused_mask_backward_g_reference(stacks, *k6, c)),
            lambda: named6(fm.fused_mask_backward_g_reference(stacks64, *k6_64, c)),
            (), _mlp_flops(N, mdims, len(mdims) - 2), _nbytes(*k6, *hweights) + _nbytes(*hweights),
        )
        # K5 and K6 at compute_dtype = bfloat16 on the same inputs, as K1-K4's
        results["K5 bf16" + tag] = check_kernel(
            f"K5 bf16 fused_implicit_train_kernel N={N} heads={n_heads}",
            lambda: named5(fi.fused_implicit_train_kernel(net, stacks, *k5, g2C_t, bf)),
            lambda: named5(fi.fused_implicit_train_kernel_reference(net, stacks, *k5, g2C_t, bf)),
            lambda: named5(fi.fused_implicit_train_kernel_reference(net64, stacks64, *k5_64, g2C, bf)),
            ("rgb", "sq", "loss", "m", "msum"), rgb_flops + 2 * N * sum(a * b for a, b in zip(mdims[:-1], mdims[1:])),
            _nbytes(*k5, *weights, *hweights) + out_bytes + N * 4 * (1 + 2) + 8,
            per_point={"dcoords": lambda r64: dcoords_error_scale(net64, k5_64[0], k5_64[2], k5_64[3], r64["m"], g2C)},
            **BF16,
        )
        results["K6 bf16" + tag] = check_kernel(
            f"K6 bf16 fused_mask_backward_g N={N} heads={n_heads}",
            lambda: named6(fm.fused_mask_backward_g(stacks, *k6, c, compute_dtype=bf)),
            lambda: named6(fm.fused_mask_backward_g_reference(stacks, *k6, c, compute_dtype=bf)),
            lambda: named6(fm.fused_mask_backward_g_reference(stacks64, *k6_64, c, compute_dtype=bf)),
            (), _mlp_flops(N, mdims, len(mdims) - 2), _nbytes(*k6, *hweights) + _nbytes(*hweights), **BF16,
        )
        # what float32 can determine of K6's gradients: float64 with the
        # forward rounded to float32's size, against float64
        ref64 = named6(fm.fused_mask_backward_g_reference(stacks64, *k6_64, c))
        sq64, esq64, abk64 = k6_64[1:]
        cot6 = lambda cols, m: (abk64[0] * sq64[:, cols] + abk64[1] * esq64[:, cols] + c) * m + abk64[2]
        moved = {k: _rel(v, ref64[k]) for k, v in named6(mask_grads_rounded_forward(stacks64, k6_64[0], cot6)).items()}
        print(f"[kernel] K6 fused_mask_backward_g N={N} heads={n_heads} float64 with the forward rounded at 2^-23 "
              "vs float64: " + " ".join(f"{k}={v:.2e}" for k, v in moved.items()), flush=True)

    # K1 at the noposenc bench case's shapes (phase 7): arch.posenc off (L =
    # 0, input_dim 2, the first layer's K = 2) and barf_c2f None, on all N
    # positions. Printed rows; the JSON line keeps the canonical shape's.
    net0 = NeuralImage(NeuralImageConfig(posenc_L=None, barf_c2f=None), generator=torch.Generator().manual_seed(4))
    net0 = net0.to(device)
    net0_64 = copy.deepcopy(net0).double()
    w0 = [t for layer in net0.layers for t in (layer.weight, layer.bias)]
    dims0 = [net0.cfg.input_dim] + [layer.out_features for layer in net0.layers]
    k1n = (grid_b, H, None, targets, masks, g, inv_sum3)
    k1n_64 = tuple(None if t is None else t.double() for t in k1n)
    for dt, extra in (("float32", {}), ("bfloat16", BF16)):
        check_kernel(
            f"K1{' bf16' if extra else ''} fused_train_kernel_warp, posenc off (L=0, input_dim {dims0[0]}), "
            f"c2f off: N={N}",
            lambda: _named(*fs.fused_train_kernel_warp(net0, *k1n, compute_dtype=dt), "dH"),
            lambda: _named(*fs.fused_train_kernel_warp_reference(net0, *k1n, dt), "dH"),
            lambda: _named(*fs.fused_train_kernel_warp_reference(net0_64, *k1n_64, dt), "dH"),
            ("rgb", "sq", "loss"), _mlp_flops(N, dims0, len(dims0) - 1),
            _nbytes(grid_b, H, targets, masks, *w0) + (3 + 1) * N * 4 + _nbytes(*w0) + _nbytes(H), **extra,
        )

    # the kernels at phase 6's shapes (2 ranks), each held as at full shape:
    # K1 and K2 on rank 1's block of the positions (it starts 21,600 pixels
    # into image 2); K3 and K6 with the column counts (cnt from
    # slot_dedup_sharded_inputs) on each rank's block of the dedup columns
    # (rank 1's ends in the pad columns); K5 and K6 on rank 1's block with 1
    # head (fused_dedup=off), and on its whole images' heads of HW columns
    # (per-image heads: 2 at B = 4, 3 at B = 5). Printed rows; the JSON
    # line keeps the full shapes' numbers.
    ranks = SHARD_RANKS
    Nl = N // ranks
    blk = lambda t: t[:, N - Nl :].contiguous()  # noqa: E731
    k1r = (blk(grid_b), H, cw, blk(targets), blk(masks), g, inv_sum3)
    k1r_64 = tuple(t.double() for t in k1r)
    for dt, extra in (("float32", {}), (bf, BF16)):
        check_kernel(
            f"K1{' bf16' if extra else ''} fused_train_kernel_warp, rank 1 of {ranks}: N={Nl}",
            lambda: _named(*fs.fused_train_kernel_warp(net, *k1r, compute_dtype=dt), "dH"),
            lambda: _named(*fs.fused_train_kernel_warp_reference(net, *k1r, dt), "dH"),
            lambda: _named(*fs.fused_train_kernel_warp_reference(net64, *k1r_64, dt), "dH"),
            ("rgb", "sq", "loss"), _mlp_flops(Nl, dims, len(dims) - 1),
            _nbytes(*k1r, *weights) + (3 + 1) * Nl * 4 + _nbytes(*weights) + _nbytes(H), **extra,
        )
    k2r = (blk(coords), cw, blk(targets), blk(masks), g, inv_sum3)
    k2r_64 = tuple(t.double() for t in k2r)
    check_kernel(
        f"K2 fused_train_kernel, rank 1 of {ranks}: N={Nl}",
        lambda: _named(*fs.fused_train_kernel(net, *k2r), "dcoords"),
        lambda: _named(*fs.fused_train_kernel_reference(net, *k2r), "dcoords"),
        lambda: _named(*fs.fused_train_kernel_reference(net64, *k2r_64), "dcoords"),
        ("rgb", "sq", "loss"), _mlp_flops(Nl, dims, len(dims) - 1),
        _nbytes(*k2r, *weights) + (3 + 1) * Nl * 4 + _nbytes(*weights) + _nbytes(k2r[0]),
        per_point={"dcoords": lambda r64: dcoords_error_scale(net64, *k2r_64[:4], 2.0 * k2r_64[4] * k2r_64[5])},
    )
    for rank in range(ranks):
        (layers, Xc, cnt_c, seg_sq, seg_esq, abk_c, c_c), Klp = sharded_dedup_inputs(cfg, data, device, ranks, rank)
        layers64 = [(w.double(), b.double()) for w, b in layers]
        hw6 = [t for wb in layers for t in wb]
        k6c = (Xc, seg_sq, seg_esq, abk_c)
        k6c_64 = tuple(t.double() for t in k6c)
        for dt, extra in (("float32", {}), (bf, BF16)):
            bft, where = " bf16" if extra else "", f"rank {rank} of {ranks}: dedup columns Klp={Klp}"
            check_kernel(
                f"K3{bft} fused_mask_forward, {where}",
                lambda: {"m": fm.fused_mask_forward(layers, Xc, dt)},
                lambda: {"m": fm.fused_mask_forward_reference(layers, Xc, dt)},
                lambda: {"m": fm.fused_mask_forward_reference(layers64, Xc.double(), dt)},
                ("m",), 2 * Klp * sum(a * b for a, b in zip(mdims[:-1], mdims[1:])), _nbytes(Xc, *hw6) + Klp * 4,
                **extra,
            )
            check_kernel(
                f"K6{bft} fused_mask_backward_g with cnt, {where} heads=1",
                lambda: named6(fm.fused_mask_backward_g([layers], *k6c, c_c, cnt_c, dt)),
                lambda: named6(fm.fused_mask_backward_g_reference([layers], *k6c, c_c, cnt_c, dt)),
                lambda: named6(fm.fused_mask_backward_g_reference([layers64], *k6c_64, c_c, cnt_c.double(), dt)),
                (), _mlp_flops(Klp, mdims, len(mdims) - 2), _nbytes(*k6c, cnt_c, *hw6) + _nbytes(*hw6),
                **extra,
            )
    # K5 -> K6 on rank 1's block: the shared head on its Nl columns, and the
    # per-image heads of images 2-3 (B = 4) and 2-4 (B = 5: 2 | 3 images)
    HWc = N // cfg.batch_size
    for n_heads, cols, own in ((1, slice(N - Nl, N), slice(0, 1)), (cfg.batch_size, slice(2 * HWc, 4 * HWc), slice(2, 4)),
                               (cfg.batch_size, slice(2 * HWc, 5 * HWc), slice(2, 5))):
        stacks, Xn, sq, esq, abk, c = heads_inputs(cfg, data, device, n_heads)
        stacks = stacks[own]
        n = cols.stop - cols.start
        cut = lambda t: t[:, cols].contiguous()  # noqa: E731
        stacks64 = [[(w.double(), b.double()) for w, b in layers] for layers in stacks]
        hweights = [t for layers in stacks for wb in layers for t in wb]
        g2C = 2.0 * (1.0 + (1.0 - 0.23))
        g2C_t = torch.tensor(g2C, device=device)
        k5 = (cut(coords), cut(Xn), cw, cut(targets))
        k5_64 = tuple(t.double() for t in k5)
        tag = f"rank 1 of {ranks}: N={n} heads={len(stacks)}"
        check_kernel(
            f"K5 fused_implicit_train_kernel, {tag}",
            lambda: named5(fi.fused_implicit_train_kernel(net, stacks, *k5, g2C_t)),
            lambda: named5(fi.fused_implicit_train_kernel_reference(net, stacks, *k5, g2C_t)),
            lambda: named5(fi.fused_implicit_train_kernel_reference(net64, stacks64, *k5_64, g2C)),
            ("rgb", "sq", "loss", "m", "msum"), _mlp_flops(n, dims, len(dims) - 1)
            + 2 * n * sum(a * b for a, b in zip(mdims[:-1], mdims[1:])),
            _nbytes(*k5, *weights, *hweights) + (3 + 1) * n * 4 + _nbytes(*weights) + n * 4 * (1 + 2) + 8,
            per_point={"dcoords": lambda r64: dcoords_error_scale(net64, k5_64[0], k5_64[2], k5_64[3], r64["m"], g2C)},
        )
        k6 = (cut(Xn), cut(sq), cut(esq), abk)
        k6_64 = tuple(t.double() for t in k6)
        check_kernel(
            f"K6 fused_mask_backward_g, {tag}",
            lambda: named6(fm.fused_mask_backward_g(stacks, *k6, c)),
            lambda: named6(fm.fused_mask_backward_g_reference(stacks, *k6, c)),
            lambda: named6(fm.fused_mask_backward_g_reference(stacks64, *k6_64, c)),
            (), _mlp_flops(n, mdims, len(mdims) - 2), _nbytes(*k6, *hweights) + _nbytes(*hweights),
        )
    return results


def sharded_dedup_inputs(cfg, data, device, n_ranks, rank):
    """K3's and K6's inputs on one rank of the sharded dedup step (phase 6):
    the dedup columns of the synthetic batch with a few saturated pixels,
    laid out by slot_dedup_sharded_inputs for n_ranks, the rank's Klp
    columns of X and of the column counts, segment sums of a plausible sq
    and esq (a column's sum over its cnt positions), the cotangent scalars.
    Returns ((layers, X, cnt, Ssq, Sesq, abk, c), Klp)."""
    from marf_tpu_torch.ops.cuda import fused_mask as fm

    rng, (head,), uv, onehot, table = factored_batch(cfg, data, device)
    X_pad, _, cnt_pad, _, _, _ = fm.slot_dedup_sharded_inputs(uv.numpy(), onehot.numpy(), n_ranks)
    Klp = X_pad.shape[1] // n_ranks
    cols = slice(rank * Klp, (rank + 1) * Klp)
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    cnt = cnt_pad[:, cols]
    N = onehot.shape[0] * onehot.shape[2]
    abk = d([2.0 / (3 * 0.7 * N), 1e-6, -1e-5])
    return (fm.mask_w_stack(head, table), d(X_pad[:, cols]), d(cnt), d(rng.rand(1, Klp) * 0.05 * cnt),
            d(rng.rand(1, Klp) * 0.5 * cnt), abk, 2.0 * 1.5 / N), Klp


def options(out_root: str, name: str, iters: int, *extra):
    """A config through the port's config path."""
    from marf_tpu_torch.utils.config import parse_arguments, set_opt

    args = [
        "--model=planar", "--yaml=planar", "--group=smoke", f"--name={name}", "--seed=3",
        "--barf_c2f=[0,0.4]", "--dataset=synthetic", f"--max_iter={iters}", "--freq.scalar=20",
        f"--output_root={out_root}", "--tb=", *extra,
    ]
    return set_opt(parse_arguments(args), interactive=False)


def run_model(opt, expect: dict):
    """Train with every launch count set to 0 just before and read just
    after; each kernel must have launched exactly `expect[name]` times (0
    when absent)."""
    from marf_tpu_torch.engine.trainer import Model
    from marf_tpu_torch.ops.cuda import LAUNCHES

    m = Model(opt)
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    m.setup_visualizer()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    m.train()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    want = {k: expect.get(k, 0) for k in LAUNCHES}
    if counts != want or m.it != opt.max_iter:
        fail(f"{opt.name}: launches {counts} in {m.it} steps, expected {want}")
    hist = {k: torch.cat([torch.as_tensor(h[k]) for h in m.history]) for k in m.history[0]}
    for k in ("loss_rgb", "loss_render", "all", "finite"):
        if not torch.isfinite(hist[k]).all() or (k == "finite" and not bool((hist[k] == 1).all())):
            fail(f"{opt.name}: non-finite {k}")
    if not hist["loss_rgb"][-1] < hist["loss_rgb"][0]:
        fail(f"{opt.name}: rgb loss did not decrease ({hist['loss_rgb'][0]:.5f} -> {hist['loss_rgb'][-1]:.5f})")
    print(f"[main] {opt.name}: {m.steps_per_sec:.2f} steps/s, launches {counts}, rgb loss "
          f"{hist['loss_rgb'][0]:.5f} -> {hist['loss_rgb'][-1]:.5f}, mask loss {hist['loss_mask'][-1]:.5f}, "
          f"PSNR {hist['PSNR'][-1]:.3f}", flush=True)
    return m, hist, counts


def _traj(h_f, h_a, key):
    return ((h_f[key][:10] - h_a[key][:10]).abs() / h_a[key][:10].abs().clamp_min(1e-30)).max().item()


def check_outputs(m):
    """The trained implicit-mask model's rendered patches and masks: finite,
    of the expected shape."""
    from marf_tpu_torch.models.planar import graph_forward

    with torch.no_grad():
        out = graph_forward(m.graph, m.data, m.cfg, torch.tensor(1.0, device=m.device))
    B, (h, w) = m.cfg.batch_size, m.cfg.map_hw
    for k, shape in (("rgb_prediction_map", (B, 3, h, w)), ("mask_prediction_map", (B, 1, h, w))):
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            fail(f"{m.opt.name}: {k} has the wrong shape or non-finite values")


def phase_main_path(out_root: str):
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    implicit = ("--use_implicit_mask", "--use_masks=false")
    m_f, h_f, c = run_model(options(out_root, "canonical_fused", ITERS, "--tpu.fused_step=on"),
                            {"fused_train_kernel_warp": ITERS})
    add(c)
    _, h_a, _ = run_model(options(out_root, "canonical_autograd", ITERS, "--tpu.fused_step=off"), {})
    traj = _traj(h_f, h_a, "loss_rgb")
    if not traj <= TRAJ_TOL:
        fail(f"canonical: fused and autograd rgb losses differ by {traj:.2e} over the first 10 steps (tol {TRAJ_TOL:.0e})")
    rgb = m_f.graph.neural_image(m_f.graph.grid.T.contiguous(), torch.tensor(1.0, device=m_f.device))
    if tuple(rgb.shape) != (3, m_f.cfg.patch_H * m_f.cfg.patch_W) or not torch.isfinite(rgb).all():
        fail("rendered patch has the wrong shape or non-finite values")
    print(f"[main] canonical: first-10-step rgb loss rel diff fused vs autograd {traj:.2e}", flush=True)

    m_i, h_i, c = run_model(
        options(out_root, "implicit_fused", ITERS, "--tpu.fused_step=on", *implicit),
        {"fused_mask_forward": ITERS, "fused_train_kernel_warp": ITERS, "fused_mask_backward_dedup": ITERS},
    )
    add(c)
    _, h_ia, _ = run_model(options(out_root, "implicit_autograd", ITERS, "--tpu.fused_step=off", *implicit), {})
    trajs = {k: _traj(h_i, h_ia, k) for k in ("loss_rgb", "loss_mask")}
    if not max(trajs.values()) <= TRAJ_TOL:
        fail(f"implicit: fused and autograd losses differ over the first 10 steps: {trajs} (tol {TRAJ_TOL:.0e})")
    check_outputs(m_i)
    print(f"[main] implicit: first-10-step loss rel diff fused vs autograd "
          + " ".join(f"{k}={v:.2e}" for k, v in trajs.items()), flush=True)

    _, h_k2, c = run_model(
        options(out_root, "implicit_fused_warp_off", ITERS, "--tpu.fused_step=on", "--tpu.fused_warp=off", *implicit),
        {"fused_mask_forward": ITERS, "fused_train_kernel": ITERS, "fused_mask_backward_dedup": ITERS},
    )
    add(c)
    trajs = {k: _traj(h_k2, h_i, k) for k in ("loss_rgb", "loss_mask")}
    if not max(trajs.values()) <= TRAJ_TOL:
        fail(f"implicit: the K2 and K1 runs' losses differ over the first 10 steps: {trajs} (tol {TRAJ_TOL:.0e})")
    print(f"[main] implicit: first-10-step loss rel diff K2 vs K1 "
          + " ".join(f"{k}={v:.2e}" for k, v in trajs.items()), flush=True)

    heads = {"fused_implicit_train_kernel": ITERS, "fused_mask_backward_g": ITERS}
    single = (*implicit, "--build_single_masks")
    m_s, h_s, c = run_model(options(out_root, "implicit_single_fused", ITERS, "--tpu.fused_step=on", *single), heads)
    add(c)
    check_outputs(m_s)
    _, h_sa, _ = run_model(options(out_root, "implicit_single_autograd", ITERS, "--tpu.fused_step=off", *single), {})
    trajs = {k: _traj(h_s, h_sa, k) for k in ("loss_rgb", "loss_mask")}
    if not max(trajs.values()) <= TRAJ_TOL:
        fail(f"implicit_single: fused and autograd losses differ over the first 10 steps: {trajs} (tol {TRAJ_TOL:.0e})")
    print(f"[main] implicit_single: first-10-step loss rel diff fused vs autograd "
          + " ".join(f"{k}={v:.2e}" for k, v in trajs.items()), flush=True)

    _, h_nd, c = run_model(
        options(out_root, "implicit_fused_dedup_off", ITERS, "--tpu.fused_step=on", "--tpu.fused_dedup=off", *implicit), heads
    )
    add(c)
    trajs = {k: _traj(h_nd, h_i, k) for k in ("loss_rgb", "loss_mask")}
    if not max(trajs.values()) <= TRAJ_TOL:
        fail(f"implicit: the fused_dedup=off and dedup runs' losses differ over the first 10 steps: {trajs} "
             f"(tol {TRAJ_TOL:.0e})")
    print(f"[main] implicit: first-10-step loss rel diff fused_dedup=off (K5, K6) vs dedup (K3, K1, K4) "
          + " ".join(f"{k}={v:.2e}" for k, v in trajs.items()), flush=True)

    # compute_dtype = bfloat16: the bf16 kernels on the fused path (K2's
    # under fused_warp=off), the neural image's bf16 casts on the autograd path
    bf16 = "--tpu.compute_dtype=bfloat16"
    dedup = {"fused_mask_forward_bf16": ITERS, "fused_mask_backward_dedup_bf16": ITERS}
    heads_bf16 = {"fused_implicit_train_kernel_bf16": ITERS, "fused_mask_backward_g_bf16": ITERS}
    h_bf16 = {}
    for name, extra, h32, expect, autograd in (
        ("canonical", (), h_f, {"fused_train_kernel_warp_bf16": ITERS}, True),
        ("implicit", implicit, h_i, {**dedup, "fused_train_kernel_warp_bf16": ITERS}, True),
        ("implicit_warp_off", (*implicit, "--tpu.fused_warp=off"), h_k2, {**dedup, "fused_train_kernel_bf16": ITERS},
         False),
        ("implicit_single", single, h_s, heads_bf16, True),
        ("implicit_dedup_off", (*implicit, "--tpu.fused_dedup=off"), h_nd, heads_bf16, False),
    ):
        m_b, h_b, c = run_model(options(out_root, f"{name}_fused_bf16", ITERS, "--tpu.fused_step=on", bf16, *extra),
                                expect)
        add(c)
        h_bf16[name] = h_b
        first = abs(h_b["all"][0] - h32["all"][0]).item() / abs(h32["all"][0]).item()
        if not first <= BF16_LOSS_RTOL:
            fail(f"{name}: the fused bf16 run's first-step loss is {first:.2e} from the float32 run's "
                 f"(tol {BF16_LOSS_RTOL:.0e})")
        if extra:
            check_outputs(m_b)
        line = (f"[main] {name} bf16: first-step loss rel diff bf16 vs float32 (fused) {first:.2e} "
                f"(tol {BF16_LOSS_RTOL:.0e})")
        if autograd:
            _, h_ba, _ = run_model(options(out_root, f"{name}_autograd_bf16", ITERS, "--tpu.fused_step=off", bf16,
                                           *extra), {})
            gap = {k: _traj(h_b, h_ba, k) for k in ("loss_rgb", "loss_mask")}
            line += ("; first-10-step loss rel diff fused vs autograd (not held: they round differently) "
                     + " ".join(f"{k}={v:.2e}" for k, v in gap.items()))
        print(line, flush=True)
    trajs = {k: _traj(h_bf16["implicit_warp_off"], h_bf16["implicit"], k) for k in ("loss_rgb", "loss_mask")}
    if not max(trajs.values()) <= TRAJ_TOL:
        fail(f"implicit bf16: the K2 and K1 runs' losses differ over the first 10 steps: {trajs} (tol {TRAJ_TOL:.0e})")
    print(f"[main] implicit bf16: first-10-step loss rel diff K2 vs K1 "
          + " ".join(f"{k}={v:.2e}" for k, v in trajs.items()), flush=True)
    h_nd16, h_i16 = h_bf16["implicit_dedup_off"], h_bf16["implicit"]
    first = {k: abs(h_nd16[k][0] - h_i16[k][0]).item() / abs(h_i16[k][0]).item() for k in ("loss_rgb", "loss_mask")}
    if not max(first.values()) <= TRAJ_TOL:
        fail(f"implicit bf16: the fused_dedup=off and dedup runs' first-step losses differ: {first} (tol {TRAJ_TOL:.0e})")
    trajs = {k: _traj(h_nd16, h_i16, k) for k in ("loss_rgb", "loss_mask")}
    print(f"[main] implicit bf16: first-step loss rel diff fused_dedup=off (K5, K6) vs dedup (K3, K1, K4) "
          + " ".join(f"{k}={v:.2e}" for k, v in first.items()) + f" (tol {TRAJ_TOL:.0e}); first-10-step (not held) "
          + " ".join(f"{k}={v:.2e}" for k, v in trajs.items()), flush=True)
    return total


LIFE_ITERS = 60


def _launch_counts(fn):
    """Run fn with every launch count set to 0 just before; its result and
    the counts just after."""
    from marf_tpu_torch.ops.cuda import LAUNCHES

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in LAUNCHES.items() if v}


def _train_cli(out_root: str, name: str, iters: int, *extra):
    """A run through the user's entry point, `marf_tpu_torch.train.main`."""
    from marf_tpu_torch.train import main as train_main

    args = ["--model=planar", "--yaml=planar", "--group=life", f"--name={name}", "--seed=3", "--barf_c2f=[0,0.4]",
            f"--max_iter={iters}", f"--output_root={out_root}", "--tpu.fused_step=on", *extra]
    return train_main(args)


def _expect(name, m, counts, expect, iters):
    if counts != expect or m.it != iters:
        fail(f"{name}: launches {counts} in {m.it} steps, expected {expect} in {iters}")
    hist = {k: np.concatenate([h[k] for h in m.history]) for k in m.history[0]}
    if not (np.isfinite(hist["all"]).all() and (hist["finite"] == 1).all()):
        fail(f"{name}: non-finite loss")
    return hist


def _image_steps(run_dir: str) -> tuple:
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    ea = EventAccumulator(run_dir, size_guidance={"images": 0, "scalars": 0})
    ea.Reload()
    return {t: [e.step for e in ea.Images(t)] for t in ea.Tags()["images"]}, set(ea.Tags()["scalars"])


def _state_diff(a_dir: str, b_dir: str) -> tuple:
    """(bitwise equal, max-abs difference) of two checkpoints' parameters and
    optimizer state tensors."""
    a, b = (torch.load(os.path.join(d, "state.pt"), map_location="cpu", weights_only=True) for d in (a_dir, b_dir))
    pairs = [(a["graph"][k], b["graph"][k]) for k in a["graph"]]
    pairs += [(v, b["optimizer"]["state"][i][k]) for i, st in a["optimizer"]["state"].items() for k, v in st.items()]
    equal = a["step"] == b["step"] and a["graph"].keys() == b["graph"].keys() and all(torch.equal(x, y) for x, y in pairs)
    return equal, max((x.double() - y.double()).abs().max().item() for x, y in pairs)


def _vis_breakdown(m, reps: int = 5) -> dict:
    """Median host ms of the pieces of one `visualize` call on a trained
    model: the render with its copy to the host, the PNG frame, the
    predicted_image panel (grid and PNG encode into a TB event)."""
    from PIL import Image

    from marf_tpu_torch.utils import vis as vis_lib
    from marf_tpu_torch.utils.tb import SummaryWriter

    def clock(fn):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return out, float(np.median(times))

    ms = {}
    frame, ms["render"] = clock(m.predict_entire_image)
    u8 = (np.clip(frame, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    with tempfile.TemporaryDirectory() as d:
        _, ms["frame PNG"] = clock(lambda: Image.fromarray(u8).save(os.path.join(d, "frame.png")))
        writer = SummaryWriter(d)
        _, ms["predicted_image panel"] = clock(
            lambda: vis_lib.tb_image(m.opt, writer, 1, "train", "predicted_image", frame[None]))
        writer.close()
    return ms


def phase_lifecycle(out_root: str):
    """The single-card lifecycle through `marf_tpu_torch.train.main` on an
    on-disk fixture (the port's synthetic scene at the canonical size, 5
    photos of 360x480, written by `save_planar_dataset`): frames, TB image
    panels, vis.mp4, checkpoints, a resume from the middle checkpoint held
    bitwise to the unbroken run, the shared-head implicit config, and AdamW,
    SGD and RMSprop. Returns the launch counts of its runs."""
    import shutil

    import cv2

    from marf_tpu_torch.data.planar import save_planar_dataset, synthesize_planar_dataset
    from marf_tpu_torch.engine import trainer
    from marf_tpu_torch.models.planar import PlanarConfig

    t0 = time.perf_counter()
    os.environ["MARF_YES"] = "1"
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    full = PlanarConfig(use_cropped_images=False)
    data_root = os.path.join(out_root, "planar")
    save_planar_dataset(synthesize_planar_dataset(full, seed=3), os.path.join(data_root, "fixture"), full.H, full.W)
    fixture = ("--dataset=fixture", f"--data.root={data_root}")
    k1 = "fused_train_kernel_warp"
    cadence = ("--freq.scalar=20", "--freq.vis=20", "--freq.ckpt=30")

    # the host time of each vis frame, checkpoint save and restore, timed in
    # the runs below (each call ends in a host copy or a file write)
    times = {"visualize": [], "save_checkpoint": [], "restore_checkpoint": []}

    def timed(name, fn):
        def call(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    originals = (trainer.Model.visualize, trainer.Model.save_checkpoint, trainer.restore_checkpoint)
    trainer.Model.visualize = timed("visualize", trainer.Model.visualize)
    trainer.Model.save_checkpoint = timed("save_checkpoint", trainer.Model.save_checkpoint)
    trainer.restore_checkpoint = timed("restore_checkpoint", trainer.restore_checkpoint)
    try:
        m, c = _launch_counts(lambda: _train_cli(out_root, "canonical", LIFE_ITERS, *fixture, *cadence))
        add(c)
        _expect("lifecycle canonical", m, c, {k1: LIFE_ITERS}, LIFE_ITERS)
        vis_ms, save_ms = list(times["visualize"]), list(times["save_checkpoint"])
        run = m.opt.output_path
        frames = sorted(os.listdir(os.path.join(run, "vis")), key=lambda f: int(f.split(".")[0]))
        if frames != [f"{i}.png" for i in range(4)]:
            fail(f"lifecycle canonical: frames {frames}, expected 0.png to 3.png")
        images, scalars = _image_steps(run)
        want = {"train/input_images": [1], "train/input_masks": [1], "train/predicted_image": [1, 20, 40, 60]}
        if images != want or not {"train/PSNR", "train/loss_render", "train/Homography_Error"} <= scalars:
            fail(f"lifecycle canonical: TB images {images}, scalars {sorted(scalars)}; expected images {want}")
        cap = cv2.VideoCapture(os.path.join(run, "vis.mp4"))
        n_frames = 0
        while cap.read()[0]:
            n_frames += 1
        cap.release()
        if n_frames != len(frames):
            fail(f"lifecycle canonical: vis.mp4 holds {n_frames} frames, expected {len(frames)}")
        ckpts = sorted(os.listdir(os.path.join(run, "ckpt")), key=int)
        if ckpts != ["30", "60"]:
            fail(f"lifecycle canonical: checkpoints {ckpts}, expected 30 and 60")
        print(f"[life] canonical on the fixture: {m.steps_per_sec:.2f} steps/s, launches {c}, frames {len(frames)}, "
              f"vis.mp4 {n_frames} frames, TB images {images}, checkpoints {ckpts}", flush=True)
        vis_parts = _vis_breakdown(m)

        # the same config on the synthetic scene, for the steps/s beside the fixture run's
        m_s, c = _launch_counts(lambda: _train_cli(out_root, "canonical_synthetic", LIFE_ITERS, "--dataset=synthetic",
                                                   *cadence))
        add(c)
        _expect("lifecycle canonical synthetic", m_s, c, {k1: LIFE_ITERS}, LIFE_ITERS)
        print(f"[life] steps/s on the fixture {m.steps_per_sec:.2f}, on the synthetic scene {m_s.steps_per_sec:.2f} "
              f"(same config, same call)", flush=True)

        # resume a copy of the run from ckpt/30 for the last 30 steps
        resumed_dir = os.path.join(os.path.dirname(run), "canonical_resume_seed3")
        shutil.copytree(run, resumed_dir)
        shutil.rmtree(os.path.join(resumed_dir, "ckpt", "60"))
        m_r, c = _launch_counts(lambda: _train_cli(out_root, "canonical_resume", LIFE_ITERS, *fixture, *cadence,
                                                   "--resume=30"))
        add(c)
        _expect("lifecycle resume", m_r, c, {k1: LIFE_ITERS // 2}, LIFE_ITERS)
        equal, diff = _state_diff(os.path.join(run, "ckpt", "60"), os.path.join(resumed_dir, "ckpt", "60"))
        losses_equal = all(np.array_equal(a[k], b[k]) for a, b in zip(m_r.history, m.history[-len(m_r.history):])
                           for k in a)
        print(f"[life] resume from ckpt/30: launches {c}, step-60 parameters and Adam state bitwise equal to the "
              f"unbroken run's: {equal} (max-abs difference {diff:.3e}); last 30 steps' metrics bitwise: "
              f"{losses_equal}", flush=True)
        if not equal or not losses_equal:
            fail("lifecycle resume: the resumed run is not bitwise the unbroken run")
        restore_ms = list(times["restore_checkpoint"])

        # the shared-head implicit config on the fixture: K3 -> K1 -> K4
        m_i, c = _launch_counts(lambda: _train_cli(out_root, "implicit", 20, *fixture, "--freq.scalar=20", "--freq.vis=20",
                                                   "--use_implicit_mask", "--use_masks=false"))
        add(c)
        _expect("lifecycle implicit", m_i, c,
                {"fused_mask_forward": 20, k1: 20, "fused_mask_backward_dedup": 20}, 20)
        images, _ = _image_steps(m_i.opt.output_path)
        if images.get("train/implicit_masks") != [1, 20]:
            fail(f"lifecycle implicit: TB images {images}, expected train/implicit_masks at steps 1 and 20")
        print(f"[life] implicit on the fixture: launches {c}, TB images {images}", flush=True)

        # each optimizer under a StepLR schedule on the device, 20 fused
        # canonical steps each in chunks of 10 (the second chunk replayed)
        sched = ("--optim.sched.type=StepLR", "--optim.sched.steps=5", "--optim.sched.gamma=0.5", "--optim.apply_sched")
        for algo in ("Adam", "AdamW", "SGD", "RMSprop"):
            m_o, c = _launch_counts(lambda: _train_cli(out_root, f"canonical_{algo}", 20, *fixture, "--freq.scalar=10",
                                                       "--freq.vis=10", "--tb=", f"--optim.algo={algo}", *sched))
            add(c)
            hist = _expect(f"lifecycle {algo}", m_o, c, {k1: 20}, 20)
            lr = float(m_o.optimizer.param_groups[0]["lr"])
            modes = sorted(ch.mode for ch in m_o.chunks.values())
            if abs(lr - 1e-3 * 0.5**4) > 1e-9 or not modes[0].startswith("captured"):
                fail(f"lifecycle {algo}: learning rate {lr:.4e} after 20 steps (expected 6.25e-5), chunks {modes}")
            print(f"[life] {algo} ({type(m_o.optimizer).__name__}, StepLR): launches {c}, rgb loss "
                  f"{hist['loss_rgb'][0]:.5f} -> {hist['loss_rgb'][-1]:.5f}, lr {lr:.4e} after 20 steps, chunks "
                  f"{modes}", flush=True)
    finally:
        trainer.Model.visualize, trainer.Model.save_checkpoint, trainer.restore_checkpoint = originals
    print(f"[life] visualize ms per call (canonical, 360x480 render, PNG frame and TB panels; the first with the "
          f"input panels): {' '.join(f'{t:.2f}' for t in vis_ms)}; its parts, median of 5: "
          + ", ".join(f"{k} {v:.2f}" for k, v in vis_parts.items()), flush=True)
    print(f"[life] save_checkpoint ms per call (canonical): {' '.join(f'{t:.2f}' for t in save_ms)}; "
          f"restore ms: {' '.join(f'{t:.2f}' for t in restore_ms)}", flush=True)
    print(f"[life] lifecycle phase {time.perf_counter() - t0:.1f} s", flush=True)
    return total


# phase 6: per-step losses and PSNR of a float32 run on 2 ranks against
# 1 rank of the same config over its first 10 steps (marf_tpu's mesh
# tolerance, tests/test_parallel.py)
SHARD_RTOL = 2e-5
SHARD_RANKS = 2


def _sharded_runs(implicit, single, bf16):
    """Phase 6's 2-rank runs: (name, extra flags, steps, launches per rank
    per step, launches per step of 1 rank, held to 1 rank, CUDA graphs per
    light and per heavy step: one more than the step's collectives, as
    tests/test_torch_sharded_chunk.py counts them, without Mask_Error:
    these configs have no premade masks). The sharded dedup step runs K6
    with column counts where 1 rank runs K4; per-image heads at B = 5 run
    on 2 | 3 whole images per rank. The run that launches no kernel runs
    the partitioned autograd step (fused_step=off)."""
    k1, k6 = "fused_train_kernel_warp", "fused_mask_backward_g"
    dedup = {"fused_mask_forward": 1, k1: 1, k6: 1}
    dedup1 = {"fused_mask_forward": 1, k1: 1, "fused_mask_backward_dedup": 1}
    heads = {"fused_implicit_train_kernel": 1, k6: 1}
    bf = lambda d: {f"{k}_bf16": v for k, v in d.items()}
    return [
        ("canonical", ("--freq.ckpt=30", "--tb.num_images=[4,8]"), 60, {k1: 1}, {k1: 1}, True, (2, 2)),
        ("warp_off", ("--tpu.fused_warp=off",), 20, {"fused_train_kernel": 1}, {"fused_train_kernel": 1}, True,
         (2, 2)),
        ("implicit", implicit, 60, dedup, dedup1, True, (5, 5)),
        ("implicit_bf16", (*implicit, bf16), 20, bf(dedup), bf(dedup1), False, (5, 5)),
        ("implicit_dedup_off", (*implicit, "--tpu.fused_dedup=off"), 20, heads, heads, True, (4, 4)),
        ("implicit_single_B4", (*single, "--batch_size=4"), 20, heads, heads, True, (4, 4)),
        ("implicit_single_B5", single, 20, heads, heads, True, (4, 4)),
        ("autograd", ("--tpu.fused_step=off",), 20, {}, {}, True, (3, 3)),
    ]


def phase_sharded(out_root: str, smi: str):
    """Phase 6: pixel-sharded training on 2 ranks through the launcher
    (marf_tpu_torch.parallel.launch.spawn, each rank running
    marf_tpu_torch.train.main): NCCL with rank r on cuda:r on a machine with
    two cards, else both ranks on cuda:0 over gloo (share_device). Each run
    beside 1 rank of the same config; the replicas' digests, each rank's
    launches, rank 0's outputs, and a 1-rank resume of the 2-rank ckpt/30.
    Returns the launches of its runs (the 2-rank runs' summed over the
    ranks)."""
    import shutil

    from marf_tpu_torch.parallel.launch import run_each, spawn, train_rank
    from marf_tpu_torch.train import main as train_main
    from marf_tpu_torch.utils.config import parse_arguments, set_opt

    t0 = time.perf_counter()
    os.environ["MARF_YES"] = "1"
    share = torch.cuda.device_count() < SHARD_RANKS
    implicit = ("--use_implicit_mask", "--use_masks=false")
    runs = _sharded_runs(implicit, (*implicit, "--build_single_masks"), "--tpu.compute_dtype=bfloat16")

    def args(name, iters, *extra):
        return ["--model=planar", "--yaml=planar", "--group=sharded", f"--name={name}", "--seed=3",
                "--barf_c2f=[0,0.4]", "--dataset=synthetic", f"--max_iter={iters}", f"--freq.scalar={min(iters, 20) // 2}",
                f"--freq.vis={iters}", f"--output_root={out_root}",
                *([] if any(e.startswith("--tpu.fused_step=") for e in extra) else ["--tpu.fused_step=on"]),
                *([] if any(e.startswith("--tb.") for e in extra) else ["--tb="]), *extra]

    calls = []
    for name, extra, iters, *_ in runs:
        argv = args(f"{name}_2ranks", iters, f"--tpu.n_devices={SHARD_RANKS}", *extra)
        calls.append((train_rank, (argv, set_opt(parse_arguments(argv), interactive=False))))
    layout = (f"{SHARD_RANKS} ranks sharing cuda:0 over gloo (share_device; this machine has "
              f"{torch.cuda.device_count()} card): correctness, not scaling" if share else
              f"{SHARD_RANKS} ranks over NCCL, one card each")
    print(f"[sharded] {layout}; {len(runs)} runs in one spawn of the ranks", flush=True)
    t_spawn = time.perf_counter()
    per_rank = spawn(run_each, SHARD_RANKS, (calls,), share_device=share, timeout_s=600)
    t_spawn = time.perf_counter() - t_spawn
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    print(f"[sharded] rank -> device: " + ", ".join(f"{r[0]['rank']} -> {r[0]['device']} ({r[0]['backend']})"
                                                     for r in per_rank), flush=True)
    for i, (name, extra, iters, per_step, per_step1, held, segments) in enumerate(runs):
        ranks = [r[i] for r in per_rank]
        want = {k: v * iters for k, v in per_step.items()}
        mode = f"captured ({SHARD_RANKS} ranks, {ranks[0]['backend']}: {segments[0]} segments light, {segments[1]} heavy)"
        for r in ranks:
            if r["launches"] != want or r["it"] != iters:
                fail(f"sharded {name}: rank {r['rank']} launched {r['launches']} in {r['it']} steps, expected {want}")
            if (r["path"] == "autograd") != (not per_step) or not r["layout"].startswith(f"sharded over {SHARD_RANKS}"):
                fail(f"sharded {name}: rank {r['rank']} ran `{r['path']}, {r['layout']}`")
            if r["chunk_modes"] != [mode]:
                fail(f"sharded {name}: rank {r['rank']} ran chunks {r['chunk_modes']}, expected {mode}")
            add(r["launches"])
        if len({r["digest"] for r in ranks}) != 1:
            fail(f"sharded {name}: the ranks' parameters and optimizer state differ (digests "
                 f"{[r['digest'][:12] for r in ranks]})")
        h2 = {k: np.concatenate([h[k] for h in ranks[0]["history"]]) for k in ranks[0]["history"][0]}
        if not (np.isfinite(h2["all"]).all() and (h2["finite"] == 1).all()):
            fail(f"sharded {name}: non-finite loss")
        m1, c1 = _launch_counts(lambda: train_main(args(f"{name}_1rank", iters, *extra)))
        h1 = _expect(f"sharded {name} on 1 rank", m1, c1, {k: v * iters for k, v in per_step1.items()}, iters)
        add(c1)
        gaps = {k: float(np.max(np.abs(h2[k][:10] - h1[k][:10]) / np.abs(h1[k][:10]))) for k in ("loss_rgb", "all", "PSNR")}
        line = (f"[sharded] {name}: {ranks[0]['path']}, chunks {ranks[0]['chunk_modes']}, launches per rank {ranks[0]['launches']}, replicas bitwise equal, steps/s "
                f"{SHARD_RANKS} ranks {ranks[0]['steps_per_sec']:.2f} vs 1 rank {m1.steps_per_sec:.2f}; "
                f"first-10-step rel diff vs 1 rank " + " ".join(f"{k}={v:.2e}" for k, v in gaps.items()))
        if held:
            print(line + f" (tol {SHARD_RTOL:.0e})", flush=True)
            if not max(gaps.values()) <= SHARD_RTOL:
                fail(f"sharded {name}: {SHARD_RANKS} ranks vs 1 rank over the first 10 steps: {gaps} > {SHARD_RTOL:.0e}")
        else:
            print(line + " (bf16: printed, not held)", flush=True)
        if not per_step:
            # 1 rank eager, the 2 ranks' own mode: the partitioned step's cost beside the captured step's gain
            m_e, c_e = _launch_counts(lambda: train_main(args(f"{name}_1rank_eager", iters, *extra), capture=False))
            _expect(f"sharded {name} on 1 rank, eager", m_e, c_e, {}, iters)
            modes = sorted({c.mode for c in m_e.chunks.values()})
            print(f"[sharded] {name}: steps/s {SHARD_RANKS} ranks {ranks[0]['steps_per_sec']:.2f} vs 1 rank eager "
                  f"{m_e.steps_per_sec:.2f} (chunks {modes}) = {ranks[0]['steps_per_sec'] / m_e.steps_per_sec:.2f}x",
                  flush=True)
        if name == "canonical":
            run = ranks[0]["output_path"]
            events = [f for f in os.listdir(run) if f.startswith("events.")]
            ckpts = sorted(os.listdir(os.path.join(run, "ckpt")), key=int)
            if len(events) != 1 or ckpts != ["30", "60"]:
                fail(f"sharded canonical: events {events}, checkpoints {ckpts}; expected one events file, 30 and 60")
            # the 2-rank ckpt/30 resumed on 1 rank
            resumed = os.path.join(os.path.dirname(run), "canonical_resume1_seed3")
            shutil.copytree(run, resumed)
            shutil.rmtree(os.path.join(resumed, "ckpt", "60"))
            m_r, c_r = _launch_counts(lambda: train_main(args("canonical_resume1", iters, *extra, "--resume=30")))
            h_r = _expect("sharded resume on 1 rank", m_r, c_r, {k: v * 30 for k, v in per_step.items()}, iters)
            add(c_r)
            gap = {k: float(np.max(np.abs(h_r[k][:10] - h2[k][30:40]) / np.abs(h2[k][30:40])))
                   for k in ("loss_rgb", "all", "PSNR")}
            print(f"[sharded] canonical: rank 0 wrote {events[0]} and ckpt {ckpts}; ckpt/30 of {SHARD_RANKS} ranks "
                  f"resumed on 1 rank: steps 31-40 rel diff " + " ".join(f"{k}={v:.2e}" for k, v in gap.items())
                  + f" (tol {SHARD_RTOL:.0e})", flush=True)
            if not max(gap.values()) <= SHARD_RTOL:
                fail(f"sharded resume on 1 rank: {gap} > {SHARD_RTOL:.0e}")
    print(f"[sharded] phase 6 {time.perf_counter() - t0:.1f} s ({SHARD_RANKS}-rank spawn {t_spawn:.1f} s); "
          f"{layout}; steps/s above on {smi}", flush=True)
    return total


# phase 7: the bench entry at 300 iterations (one warm-up chunk of 100, two
# timed); each case's kernels at default knobs, each once per timed step
BENCH_ITERS = 300
BENCH_RGB = ("fused_train_kernel_warp",)
BENCH_PATHS = {
    "canonical": BENCH_RGB, "fullposenc": BENCH_RGB, "noposenc": BENCH_RGB, "edges_only": BENCH_RGB,
    "implicit": ("fused_mask_forward", "fused_train_kernel_warp", "fused_mask_backward_dedup"),
    "implicit_single": ("fused_implicit_train_kernel", "fused_mask_backward_g"),
}
# K1's device kernels, as step_profile lists them (csrc/fused_step.cuh, tc_gemm.cuh)
K1_DEVICE_KERNELS = ("encode_kernel", "tc_presplit_kernel", "tc_gemm_kernel", "head_kernel", "encode_bwd_kernel")


def _check_bench(tag: str, r: dict, case: str, dtype: str):
    """A bench line: a finite steps/s > 0 and final PSNR, the case's kernels
    once per timed step and no other, the golden skipped off cat_batch3."""
    from marf_tpu_torch.ops.cuda import LAUNCHES

    x = r["extra"]
    if not (r["value"] is not None and np.isfinite(r["value"]) and r["value"] > 0 and np.isfinite(x["final_psnr_db"])):
        fail(f"bench {tag}: steps/s {r['value']}, final PSNR {x['final_psnr_db']}")
    suffix = "_bf16" if dtype == "bfloat16" else ""
    want = {k: float(k in {p + suffix for p in BENCH_PATHS[case]}) for k in LAUNCHES}
    if x["launches"] != want:
        fail(f"bench {tag}: launches per timed step {x['launches']}, expected {want}")
    if x["dataset"] != "cat_batch3" and "skipped" not in x["golden"]:
        fail(f"bench {tag}: golden {x['golden']} on dataset {x['dataset']}, expected skipped")
    if (x["case"], x["compute_dtype"], x["iters_timed"]) != (case, dtype, BENCH_ITERS - 100):
        fail(f"bench {tag}: case {x['case']}, dtype {x['compute_dtype']}, {x['iters_timed']} timed steps")
    ran = ", ".join(k for k, v in x["launches"].items() if v) or "none"
    print(f"[bench] {tag}: {r['value']:.2f} steps/s, final PSNR {x['final_psnr_db']:.3f} dB, kernels per step 1 x "
          f"{ran}, golden {x['golden']}, dataset {x['dataset']}, device {x['device']}", flush=True)


def phase_bench(out_root: str):
    """Phase 7: the bench entry. `run_case` in-process for the six cases at
    float32 and for implicit and implicit_single at bf16; one
    `python -m marf_tpu_torch.bench` process (canonical); one
    `train.main` run with --profile=1 whose trace must name K1's device
    kernels. Returns the launch counts (the timed steps' for the bench
    runs)."""
    from marf_tpu_torch.bench import CASES, run_case

    t0 = time.perf_counter()
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    runs = [(case, "float32") for case in CASES] + [("implicit", "bfloat16"), ("implicit_single", "bfloat16")]
    for case, dtype in runs:
        (r, _), counts = _launch_counts(lambda: run_case(case, BENCH_ITERS, dtype=dtype))
        _check_bench(f"{case} {dtype}", r, case, dtype)
        add(counts)
    env = dict(os.environ, MARF_BENCH_CASE="canonical", MARF_BENCH_ITERS=str(BENCH_ITERS))
    proc = subprocess.run([sys.executable, "-m", "marf_tpu_torch.bench"], env=env, capture_output=True, text=True,
                          timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"python -m marf_tpu_torch.bench: rc {proc.returncode}, stdout {proc.stdout[-1000:]!r}, "
             f"stderr {proc.stderr[-2000:]!r}")
    r = json.loads(lines[-1])
    _check_bench("canonical float32 (python -m marf_tpu_torch.bench)", r, "canonical", "float32")
    add({k: round(v * r["extra"]["iters_timed"]) for k, v in r["extra"]["launches"].items() if v})

    # --profile=1: chunk 1 of 3 (steps 20-40) traced into <run>/profile
    m, counts = _launch_counts(lambda: _train_cli(out_root, "profiled", 60, "--dataset=synthetic", "--freq.scalar=20",
                                                   "--freq.vis=60", "--tb=", "--profile=1"))
    _expect("profiled", m, counts, {"fused_train_kernel_warp": 60}, 60)
    add(counts)
    prof_dir = os.path.join(m.opt.output_path, "profile")
    files = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")] if os.path.isdir(prof_dir) else []
    if len(files) != 1:
        fail(f"--profile=1: trace files {files} under {prof_dir}, expected one")
    with open(os.path.join(prof_dir, files[0])) as f:
        trace = json.load(f)
    kernels = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    found = {k: sum(f"{k}<" in n or f"{k}(" in n for n in kernels) for k in K1_DEVICE_KERNELS}
    if not all(found.values()):
        fail(f"--profile=1: the trace names K1's device kernels {found} times ({len(kernels)} kernel events)")
    size = os.path.getsize(os.path.join(prof_dir, files[0])) / 2**20
    print(f"[bench] --profile=1 (chunk 1 of 3, 20 steps): {files[0]} {size:.1f} MiB, {len(kernels)} kernel events; "
          f"K1's device kernels " + ", ".join(f"{k} x{v}" for k, v in found.items()), flush=True)
    print(f"[bench] phase 7 {time.perf_counter() - t0:.1f} s", flush=True)
    return total


# phase 8: each path's captured chunk against its eager oracle, from the same
# init at full width, CAPTURE_ITERS steps in chunks of CAPTURE_CHUNK: chunk 0
# (the captured run's warm-up and capture), three timed, one traced
CAPTURE_ITERS = 100
CAPTURE_CHUNK = 20


def _capture_paths(implicit, single, bf16):
    """Phase 8's paths: (name, extra flags, each kernel's launches per step)."""
    k1, k6 = "fused_train_kernel_warp", "fused_mask_backward_g"
    dedup = {"fused_mask_forward": 1, k1: 1, "fused_mask_backward_dedup": 1}
    heads = {"fused_implicit_train_kernel": 1, k6: 1}
    bf = lambda d: {f"{k}_bf16": v for k, v in d.items()}
    return [
        ("canonical", (), {k1: 1}),
        ("canonical bf16", (bf16,), bf({k1: 1})),
        ("canonical autograd", ("--tpu.fused_step=off",), {}),
        ("implicit", implicit, dedup),
        ("implicit bf16", (*implicit, bf16), bf(dedup)),
        ("implicit fused_warp=off", (*implicit, "--tpu.fused_warp=off"),
         {"fused_mask_forward": 1, "fused_train_kernel": 1, "fused_mask_backward_dedup": 1}),
        ("implicit_single", single, heads),
        ("implicit_single bf16", (*single, bf16), bf(heads)),
        ("implicit fused_dedup=off", (*implicit, "--tpu.fused_dedup=off"), heads),
    ]


def _chunk_run(opt, capture: bool) -> dict:
    """CAPTURE_ITERS steps of the config's step through `make_train_chunk`,
    with the launch counts set to 0 just before: every step's metrics, the
    state after, the launches, and the times of chunks 1-3 (host: the
    dispatch; wall: to the metric read) and of chunk 4's device kernels."""
    from marf_tpu_torch.engine.step import make_train_chunk
    from marf_tpu_torch.engine.trainer import Model
    from marf_tpu_torch.ops.cuda import LAUNCHES
    from marf_tpu_torch.step_profile import device_kernels

    m = Model(opt, capture=capture)
    m.load_dataset()
    m.build_networks()
    m.setup_optimizer()
    step = m.make_step()
    chunk = make_train_chunk(step, CAPTURE_CHUNK, capture)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    rows = [chunk().result()]
    host = wall = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        handle = chunk()
        t1 = time.perf_counter()
        rows.append(handle.result())
        host += t1 - t0
        wall += time.perf_counter() - t0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        rows.append(chunk().result())
        torch.cuda.synchronize()
    device_ms = sum(ms for ms, _ in device_kernels(prof)[0]) / CAPTURE_CHUNK
    timed = 3 * CAPTURE_CHUNK
    tensors = list(m.graph.state_dict().values())
    tensors += [v for st in m.optimizer.state_dict()["state"].values() for v in st.values()]
    return {"rows": rows, "state": tensors, "launches": {k: v for k, v in LAUNCHES.items() if v},
            "host_ms": host * 1e3 / timed, "steps_per_sec": timed / wall, "device_ms": device_ms,
            "mode": chunk.mode}


def _sharded_capture_paths(implicit, single):
    """Phase 8's sharded paths on 2 ranks: (name, extra flags, each
    kernel's launches per rank and step, phase 8's 1-rank path beside it,
    CUDA graphs per light and per heavy step)."""
    k1, k6 = "fused_train_kernel_warp", "fused_mask_backward_g"
    return [
        ("canonical", (), {k1: 1}, "canonical", (2, 2)),
        ("implicit dedup", implicit, {"fused_mask_forward": 1, k1: 1, k6: 1}, "implicit", (5, 5)),
        ("implicit_single B5", single, {"fused_implicit_train_kernel": 1, k6: 1}, "implicit_single", (4, 4)),
        ("partitioned autograd", ("--tpu.fused_step=off",), {}, "canonical autograd", (3, 3)),
    ]


def _rank_inputs(opt):
    """What `train_steps` takes for a config: (cfg, initial state_dict,
    data, optimizer options, use_homographies), on the CPU, from the
    trainer's own phases (seed 3, synthetic data)."""
    from marf_tpu_torch.engine.trainer import Model

    m = Model(opt)
    m.load_dataset()
    m.build_networks()
    data = {k: None if v is None else v.cpu() for k, v in m.data.items()}
    return m.cfg, {k: v.cpu() for k, v in m.graph.state_dict().items()}, data, dict(opt.optim), m.use_homographies


def phase_capture_sharded(out_root: str, smi: str, one_rank: dict):
    """Phase 8's sharded twins: 2 ranks over gloo on cuda:0 (share_device),
    each path's rank body (`parallel/sharded.py` `train_steps`: step 1 as
    an eager one-step chunk, then chunks of CAPTURE_CHUNK) captured in
    segments against eager from the same init, CAPTURE_ITERS steps, one
    spawn for all: every step's metrics and the digest of the parameters
    and optimizer state bitwise equal, captured against eager and rank
    against rank; each kernel of the path once per rank and step, counted
    through the replays; the segments per light and heavy step; host ms
    per step and steps/s captured beside eager beside 1 rank captured
    (`one_rank`: phase 8's runs). Returns the captured runs' launches,
    summed over the ranks."""
    from marf_tpu_torch.parallel.launch import run_each, spawn
    from marf_tpu_torch.parallel.sharded import train_steps

    t0 = time.perf_counter()
    implicit = ("--use_implicit_mask", "--use_masks=false")
    paths = _sharded_capture_paths(implicit, (*implicit, "--build_single_masks"))
    calls = []
    for name, extra, *_ in paths:
        cfg, state, data, optim, use_homographies = _rank_inputs(
            options(out_root, f"capture_2ranks_{name.replace(' ', '_')}", CAPTURE_ITERS, *extra))
        calls += [(train_steps, (cfg, state, data, CAPTURE_ITERS, optim, use_homographies),
                   {"capture": capture, "chunk": CAPTURE_CHUNK}) for capture in (None, False)]
    per_rank = spawn(run_each, SHARD_RANKS, (calls,), share_device=True, timeout_s=600)
    total = {}
    for i, (name, _, per_step, one_name, segments) in enumerate(paths):
        cap, eag = ([r[2 * i + j] for r in per_rank] for j in (0, 1))
        want = {k: v * CAPTURE_ITERS for k, v in per_step.items()}
        mode = f"captured ({SHARD_RANKS} ranks, gloo: {segments[0]} segments light, {segments[1]} heavy)"
        for runs, expect in ((cap, mode), (eag, "eager (capture=False)")):
            for r in runs:
                if r["launches"] != want or r["mode"] != expect or not r["layout"].startswith(f"sharded over {SHARD_RANKS}"):
                    fail(f"capture 2 ranks {name}: a rank ran {r['mode']!r}, {r['layout']!r}, launches "
                         f"{r['launches']}; expected {expect!r}, sharded, {want}")
        for rank, (c, e) in enumerate(zip(cap, eag)):
            rows_equal = c["metrics"].keys() == e["metrics"].keys() and all(
                np.array_equal(c["metrics"][k], e["metrics"][k]) for k in c["metrics"])
            if not (rows_equal and c["digest"] == e["digest"] == cap[0]["digest"]):
                fail(f"capture 2 ranks {name}: rank {rank} captured vs eager metrics bitwise {rows_equal}, digests "
                     f"{c['digest'][:12]} / {e['digest'][:12]} (rank 0 captured {cap[0]['digest'][:12]})")
            if not (np.isfinite(c["metrics"]["all"]).all() and (c["metrics"]["finite"] == 1).all()):
                fail(f"capture 2 ranks {name}: non-finite loss on rank {rank}")
        for r in cap:
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        one = one_rank[one_name]
        for rank, (c, e) in enumerate(zip(cap, eag)):
            print(f"[capture] 2 ranks {name}, rank {rank}: {CAPTURE_ITERS} steps, metrics, parameters and optimizer "
                  f"state bitwise equal captured vs eager and across ranks; {segments[0]} segments light, "
                  f"{segments[1]} heavy; launches {c['launches'] or 'none'}; captured {c['steps_per_sec']:.2f} steps/s, "
                  f"host {c['host_ms']:.3f} ms/step; eager {e['steps_per_sec']:.2f} steps/s, host {e['host_ms']:.3f} "
                  f"ms/step; 1 rank captured ({one_name}) {one['steps_per_sec']:.2f} steps/s, host "
                  f"{one['host_ms']:.3f} ms/step: 2 ranks captured {c['steps_per_sec'] / one['steps_per_sec']:.2f}x, "
                  f"eager {e['steps_per_sec'] / one['steps_per_sec']:.2f}x of 1 rank; {smi}", flush=True)
    print(f"[capture] 2 ranks sharing cuda:0 over gloo: {time.perf_counter() - t0:.1f} s", flush=True)
    return total


def phase_capture(out_root: str, smi: str):
    """Phase 8: on every path, the captured chunk against the eager one from
    the same init: every step's metrics, the parameters and the optimizer
    state bitwise equal, each kernel of the path launched once per step
    (counted through the replays), and host ms, device ms and steps/s side
    by side; then the sharded twins (`phase_capture_sharded`). Returns the
    launches of the captured runs."""
    t0 = time.perf_counter()
    implicit = ("--use_implicit_mask", "--use_masks=false")
    total = {}
    one_rank = {}
    for name, extra, per_step in _capture_paths(implicit, (*implicit, "--build_single_masks"),
                                                "--tpu.compute_dtype=bfloat16"):
        opt = options(out_root, f"capture_{name.replace(' ', '_')}", CAPTURE_ITERS, *extra)
        t_path = time.perf_counter()
        runs = {capture: _chunk_run(copy.deepcopy(opt), capture) for capture in (True, False)}
        t_path = time.perf_counter() - t_path
        cap, eag = runs[True], runs[False]
        want = {k: v * CAPTURE_ITERS for k, v in per_step.items()}
        for capture, r in runs.items():
            if r["launches"] != want:
                fail(f"capture {name} ({r['mode']}): launches {r['launches']}, expected {want}")
        if not cap["mode"].startswith("captured") or not eag["mode"].startswith("eager"):
            fail(f"capture {name}: chunk modes {cap['mode']!r}, {eag['mode']!r}")
        for k, v in cap["launches"].items():
            total[k] = total.get(k, 0) + v
        rows_equal = all(a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
                         for a, b in zip(cap["rows"], eag["rows"]))
        state_equal = len(cap["state"]) == len(eag["state"]) and all(
            torch.equal(a, b) for a, b in zip(cap["state"], eag["state"]))
        if not (rows_equal and state_equal):
            diff = max((a.double() - b.double()).abs().max().item() for a, b in zip(cap["state"], eag["state"]))
            fail(f"capture {name}: captured vs eager metrics bitwise {rows_equal}, state bitwise {state_equal} "
                 f"(max-abs state difference {diff:.3e})")
        print(f"[capture] {name}: {CAPTURE_ITERS} steps, metrics, parameters and optimizer state bitwise equal "
              f"captured vs eager; launches {cap['launches'] or 'none'}; captured {cap['steps_per_sec']:.2f} steps/s, "
              f"host {cap['host_ms']:.3f} ms/step, device {cap['device_ms']:.3f} ms/step, busy share "
              f"{cap['device_ms'] * cap['steps_per_sec'] / 1e3:.3f}; eager {eag['steps_per_sec']:.2f} steps/s, host "
              f"{eag['host_ms']:.3f} ms/step, device {eag['device_ms']:.3f} ms/step, busy share "
              f"{eag['device_ms'] * eag['steps_per_sec'] / 1e3:.3f}; {smi}; both runs {t_path:.1f} s", flush=True)
        one_rank[name] = cap
    for k, v in phase_capture_sharded(out_root, smi, one_rank).items():
        total[k] = total.get(k, 0) + v
    print(f"[capture] phase 8 {time.perf_counter() - t0:.1f} s", flush=True)
    return total


KERNELS = [
    ("K1", "fused_train_kernel_warp", "marf_tpu_torch/csrc/fused_step.cu", "marf_tpu/ops/pallas/fused_step.py:272"),
    ("K2", "fused_train_kernel", "marf_tpu_torch/csrc/fused_step.cu", "marf_tpu/ops/pallas/fused_step.py:208"),
    ("K3", "fused_mask_forward", "marf_tpu_torch/csrc/fused_mask.cu", "marf_tpu/ops/pallas/fused_mask.py:252"),
    ("K4", "fused_mask_backward_dedup", "marf_tpu_torch/csrc/fused_mask.cu", "marf_tpu/ops/pallas/fused_mask.py:837"),
    ("K5", "fused_implicit_train_kernel", "marf_tpu_torch/csrc/fused_implicit.cu", "marf_tpu/ops/pallas/fused_mask.py:434"),
    ("K6", "fused_mask_backward_g", "marf_tpu_torch/csrc/fused_mask.cu", "marf_tpu/ops/pallas/fused_mask.py:510"),
    # the same Pallas kernels' bodies at cdtype = bfloat16
    ("K1 bf16", "fused_train_kernel_warp_bf16", "marf_tpu_torch/csrc/fused_step.cu",
     "marf_tpu/ops/pallas/fused_step.py:272"),
    ("K2 bf16", "fused_train_kernel_bf16", "marf_tpu_torch/csrc/fused_step.cu", "marf_tpu/ops/pallas/fused_step.py:208"),
    ("K3 bf16", "fused_mask_forward_bf16", "marf_tpu_torch/csrc/fused_mask.cu", "marf_tpu/ops/pallas/fused_mask.py:252"),
    ("K4 bf16", "fused_mask_backward_dedup_bf16", "marf_tpu_torch/csrc/fused_mask.cu",
     "marf_tpu/ops/pallas/fused_mask.py:837"),
    ("K5 bf16", "fused_implicit_train_kernel_bf16", "marf_tpu_torch/csrc/fused_implicit.cu",
     "marf_tpu/ops/pallas/fused_mask.py:434"),
    ("K6 bf16", "fused_mask_backward_g_bf16", "marf_tpu_torch/csrc/fused_mask.cu", "marf_tpu/ops/pallas/fused_mask.py:510"),
]


def main():
    t0 = time.perf_counter()
    smi = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    results = phase_kernels(device)
    torch.cuda.synchronize()
    t_kernels = time.perf_counter() - t0
    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output")
    os.makedirs(out_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_root) as tmp:
        launches = phase_main_path(tmp)
        t_main = time.perf_counter() - t0 - t_kernels
        for k, v in phase_lifecycle(tmp).items():
            launches[k] = launches.get(k, 0) + v
        t_life = time.perf_counter() - t0 - t_kernels - t_main
        for k, v in phase_sharded(tmp, smi).items():
            launches[k] = launches.get(k, 0) + v
        t_shard = time.perf_counter() - t0 - t_kernels - t_main - t_life
        for k, v in phase_bench(tmp).items():
            launches[k] = launches.get(k, 0) + v
        t_bench = time.perf_counter() - t0 - t_kernels - t_main - t_life - t_shard
        for k, v in phase_capture(tmp, smi).items():
            launches[k] = launches.get(k, 0) + v
    print(f"[time] build and kernels {t_kernels:.1f} s, main path {t_main:.1f} s, lifecycle {t_life:.1f} s, sharded "
          f"{t_shard:.1f} s, bench {t_bench:.1f} s, capture "
          f"{time.perf_counter() - t0 - t_kernels - t_main - t_life - t_shard - t_bench:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches[name],
         **results[kid], "library_ms": None}
        for kid, name, source, replaces in KERNELS
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
