"""The 3xTF32 tensor-core GEMM engine of K5 and K6 (csrc/tc_gemm.cuh), through
its own C entry point (csrc/tc_gemm.cu), beside its plain PyTorch version.

It exists so that each operand layout and epilogue of the engine can be held
to `torch.matmul` on the card apart from the kernels that use it
(tests/test_torch_tc_gemm.py); nothing on the train step calls it. The split
arithmetic itself (hi = tf32(x), lo = tf32(x - hi), three TF32 products per
float32 product) is emulated in numpy by the CPU tests in that file.

Layouts name how A [M, K] and B [K, N] lie in memory, as the kernels' products
do: "mk" / "km" for A, "kn" / "nk" for B:
  "mk,nk": a forward layer (activations [pts, in], W [out, in]);
  "mk,kn": a dz product (dz [pts, out], W [out, in] read as B [out, in]);
  "km,kn": a dW product over points (dz [pts, out], x_in [pts, in]);
  "km,nk": the mask's first layer (X [56, pts] channels-first), forward and dW.
"""

from __future__ import annotations

import ctypes

import torch

from marf_tpu_torch.ops.cuda import LAUNCHES
from marf_tpu_torch.ops.cuda.fused_step import check_tensor

SOURCES = ["tc_gemm.cu"]
LAYOUTS = {"mk,nk": (True, False), "mk,kn": (True, True), "km,kn": (False, True), "km,nk": (False, False)}
EPILOGUES = {"store": 0, "bias_relu": 1, "gate": 2}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.marf_tc_gemm_workspace.argtypes = [i, i, i, i, i]
    lib.marf_tc_gemm_workspace.restype = ctypes.c_longlong
    lib.marf_tc_gemm.argtypes = [i, i, i, i, i, i, p, i, p, i, p, i, p, p, i, i, p, p, p]
    lib.marf_tc_gemm.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind the engine's test library."""
    from marf_tpu_torch.ops.cuda._build import load_library

    return load_library("tc_gemm", SOURCES, _bind)


def _dims(a: torch.Tensor, b: torch.Tensor, layout: str):
    if layout not in LAYOUTS:
        raise ValueError(f"tc_gemm: unknown layout {layout!r} (one of {sorted(LAYOUTS)})")
    a_k, b_n = LAYOUTS[layout]
    M, K = a.shape if a_k else a.shape[::-1]
    Kb, N = b.shape if b_n else b.shape[::-1]
    if K != Kb:
        raise ValueError(f"tc_gemm: depths differ (A {tuple(a.shape)}, B {tuple(b.shape)}, layout {layout})")
    return a_k, b_n, M, N, K


def tc_gemm(a, b, layout: str, epilogue: str = "store", bias=None, gate=None, splits: int = 1, rowsum: bool = False):
    """C = epilogue(A B) on the tensor cores in 3xTF32.

    Args:
      a: A as it lies: [M, K] ("mk") or [K, M] ("km"); b: [K, N] ("kn") or
        [N, K] ("nk"). 2-d float32 with unit stride in the last dimension;
        the row stride may be larger (a view of a wider tensor).
      layout: "<A>,<B>" (module docstring).
      epilogue: "store", "bias_relu" (bias [N]) or "gate" (C zeroed where
        gate [M, N] <= 0).
      splits: split-K partials summed in a fixed order (store only; with A
        "km" a depth over 2,048 also takes partials, one per 2,048 deep of
        a split; with A "mk" such a depth is refused).
      rowsum: also return A's row sums over k (A "km" only), folded into the
        product as the dW products fold db.

    Returns C [M, N] (and the row sums [M] when rowsum). CPU tensors run
    `tc_gemm_reference`.
    """
    if a.device.type == "cpu":
        return tc_gemm_reference(a, b, layout, epilogue, bias, gate, splits, rowsum)
    if a.device.type != "cuda":
        raise ValueError(f"tc_gemm: unsupported device {a.device}")
    a_k, b_n, M, N, K = _dims(a, b, layout)
    device = a.device
    for name, t in (("a", a), ("b", b)):
        if t.device != device or t.dtype != torch.float32 or t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"tc_gemm: {name} must be a 2-d float32 tensor on {device} with unit column stride")
    if (epilogue not in EPILOGUES or (epilogue == "bias_relu") != (bias is not None)
            or (epilogue == "gate") != (gate is not None)):
        raise ValueError(f"tc_gemm: epilogue {epilogue!r} with bias={bias is not None}, gate={gate is not None}")
    if splits < 1 or ((splits > 1 or rowsum) and epilogue != "store") or (rowsum and a_k):
        raise ValueError(f"tc_gemm: splits={splits}, rowsum={rowsum} need the store epilogue (and A 'km' for rowsum)")
    if bias is not None:
        check_tensor("tc_gemm", "bias", bias, (N,), device)
    if gate is not None:
        check_tensor("tc_gemm", "gate", gate, (M, N), device)
    lib = _library()
    c = torch.empty((M, N), dtype=torch.float32, device=device)
    rs = torch.empty((M,), dtype=torch.float32, device=device) if rowsum else None
    ws = torch.empty(max(1, lib.marf_tc_gemm_workspace(M, N, K, splits, int(rowsum))), dtype=torch.float32,
                     device=device)
    rc = lib.marf_tc_gemm(
        int(a_k), int(b_n), EPILOGUES[epilogue], M, N, K, a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        c.data_ptr(), N, None if bias is None else bias.data_ptr(), None if gate is None else gate.data_ptr(), N,
        splits, None if rs is None else rs.data_ptr(), ws.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"tc_gemm kernel launch failed: CUDA error {rc}")
    LAUNCHES["tc_gemm"] += 1
    return (c, rs) if rowsum else c


def tc_gemm_reference(a, b, layout: str, epilogue: str = "store", bias=None, gate=None, splits: int = 1,
                      rowsum: bool = False):
    """Plain PyTorch version of `tc_gemm` (torch.matmul plus the epilogue);
    `splits` does not change the function."""
    a_k, b_n, *_ = _dims(a, b, layout)
    A = a if a_k else a.T
    c = A @ (b if b_n else b.T)
    if epilogue == "bias_relu":
        c = torch.relu(c + bias)
    elif epilogue == "gate":
        c = torch.where(gate > 0, c, torch.zeros_like(c))
    return (c, A.sum(dim=1)) if rowsum else c

