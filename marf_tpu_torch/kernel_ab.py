"""Compare the kernels of two checkouts of the port on one card: their
times and the bits of their outputs.

    python3 marf_tpu_torch/kernel_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout: this one (`.`), or another commit
unpacked by `git archive` into a directory that .gitignore lists. Each
ROOT runs in a process of its own, in the order given (give two checkouts
in turns, parent, change, change, parent, so that drift shows), which
imports ROOT's marf_tpu_torch and builds ROOT's kernels into ROOT/build/.
The inputs are chip_smoke.py's phase-3 inputs, built by this checkout's
chip_smoke.py: the canonical shape (N = 216,000 points), the dedup
columns of that batch, and 5 per-image heads on its N columns. Every
kernel that ROOT's wrappers offer runs at float32 and, where its wrapper
takes compute_dtype, at bfloat16; each prints its ms per call (CUDA
events over 20 calls after one warm-up) and a sha256 of its outputs'
bytes, beside one of all the inputs' bytes (the inputs come from seeds,
but some are products on the card). Last comes a table of each kernel's ms
per ROOT and whether every ROOT gave the same bits.
"""

import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tensors(x):
    if hasattr(x, "data_ptr"):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _sha256(x) -> str:
    h = hashlib.sha256()
    for t in _tensors(x):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run_root(root: str) -> dict:
    """Time and digest every kernel of the checkout at `root`: {"inputs":
    sha256, "kernels": {name: {"ms", "sha256"}}}."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import marf_tpu_torch

    if not os.path.abspath(marf_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {marf_tpu_torch.__file__}, not the checkout at {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from marf_tpu_torch.ops.cuda import fused_implicit as fi
    from marf_tpu_torch.ops.cuda import fused_mask as fm
    from marf_tpu_torch.ops.cuda import fused_step as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.phase_build()
    cfg, data, net, (grid_b, H, coords, cw, targets, masks, g, inv_sum3) = cs.canonical_inputs(device)
    _, (layers, X, s0map, sq_b, esq_b, base, cnt, abk) = cs.mask_inputs(cfg, data, device)
    stacks, Xn, sq, esq, abk6, c = cs.heads_inputs(cfg, data, device, cfg.batch_size)
    g2C = torch.tensor(2.0 * (1.0 + (1.0 - 0.23)), device=device)  # as chip_smoke.py's K5 inputs, on the device
    inputs = _sha256([list(net.parameters()), grid_b, H, coords, cw, targets, masks, g, inv_sum3, layers, X, s0map,
                      sq_b, esq_b, base, cnt, abk, stacks, Xn, sq, esq, abk6])
    print(f"[ab] {root}: inputs sha256 {inputs}", flush=True)
    calls = {
        "K1": (fs.fused_train_kernel_warp, lambda **kw: fs.fused_train_kernel_warp(
            net, grid_b, H, cw, targets, masks, g, inv_sum3, **kw)),
        "K2": (fs.fused_train_kernel, lambda **kw: fs.fused_train_kernel(
            net, coords, cw, targets, masks, g, inv_sum3, **kw)),
        "K3": (fm.fused_mask_forward, lambda **kw: fm.fused_mask_forward(layers, X, **kw)),
        "K4": (fm.fused_mask_backward_dedup, lambda **kw: fm.fused_mask_backward_dedup(
            layers, X, s0map, sq_b, esq_b, base, cnt, abk, **kw)),
        "K5": (fi.fused_implicit_train_kernel, lambda **kw: fi.fused_implicit_train_kernel(
            net, stacks, coords, Xn, cw, targets, g2C, **kw)),
        "K6": (fm.fused_mask_backward_g, lambda **kw: fm.fused_mask_backward_g(stacks, Xn, sq, esq, abk6, c, **kw)),
    }
    out = {}
    for kid, (wrapper, call) in calls.items():
        dtypes = ["float32"] + (["bfloat16"] if "compute_dtype" in inspect.signature(wrapper).parameters else [])
        for dt in dtypes:
            run = (lambda: call(compute_dtype=dt)) if dt == "bfloat16" else call
            sha = _sha256(run())
            name = kid if dt == "float32" else f"{kid} bf16"
            out[name] = {"ms": cs._time_ms(run), "sha256": sha}
            print(f"[ab] {root}: {name} {out[name]['ms']:.3f} ms/call, outputs sha256 {out[name]['sha256']}",
                  flush=True)
    return {"inputs": inputs, "kernels": out}


def main(argv: list) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(run_root(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__)
        return 2
    runs = []
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], capture_output=True,
                              text=True)
        sys.stdout.write(proc.stdout[: proc.stdout.rstrip().rfind("\n") + 1])
        if proc.returncode != 0:
            sys.stdout.write(proc.stderr)
            print(f"FAILED: {root} exited with {proc.returncode}")
            return 1
        runs.append(json.loads(proc.stdout.rstrip().splitlines()[-1]))
    inputs = {r["inputs"] for r in runs}
    runs = [r["kernels"] for r in runs]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[ab] {smi}; ms per call in the order run: " + ", ".join(argv))
    print(f"[ab] inputs bitwise equal across the runs: {len(inputs) == 1}")
    for name in dict.fromkeys(k for r in runs for k in r):
        have = [r[name] for r in runs if name in r]
        same = len({r["sha256"] for r in have}) == 1
        print(f"[ab] {name}: " + ", ".join(f"{r[name]['ms']:.3f}" if name in r else "-" for r in runs)
              + (f"; outputs bitwise equal across the runs: {same}" if len(have) == len(runs) else
                 f"; not in every checkout (outputs bitwise equal where run: {same})"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
