"""The tensor-core GEMM engines of K1-K6 (csrc/tc_gemm.cuh), through their own
C entry points (csrc/tc_gemm.cu), beside their plain PyTorch versions: the
3xTF32 engine (float32 operands) and the bf16 engine (bfloat16 operands,
float32 products and sums; compute_dtype = bfloat16).

It exists so that each operand layout and epilogue of the engine, and the
weights' pre-split, can be held to their plain versions on the card apart
from the kernels that use them (tests/test_torch_tc_gemm.py); nothing on the
train step calls it. The split arithmetic itself (hi = tf32(x), lo = tf32(x -
hi), three TF32 products per float32 product) is emulated in numpy by the
CPU tests in that file.

The pre-split B (`presplit`): a weight W [rows, cols] split once into TF32 hi
and lo, laid out as the kernel's split pass lays out a B tile in shared
memory (64 columns by 32 deep, K-major 8 x 4 core matrices of 128 bytes,
element (n, k) of a tile at (n // 8) 256 + (k // 4) 32 + (n % 8) 4 + k % 4),
tiles ordered [n-tile][k-tile][hi | lo], zeros past the edges; once as the B
of the forward product ("mk,nk": B(k, n) = W[n, k]) and once as the B of the
dz product ("mk,kn": B(k, n) = W[k, n]). The rgb pipeline (K1, K2, K5) and
the mask heads (K3-K6) write it once per call and stream each tile into shared
memory with one bulk copy; `presplit_table` pre-splits a table of weights in
one launch, as the mask heads pre-split every head's hidden layers.

The bf16 engine's pre-split (`presplit_bf16`) converts W to bf16 and lays it
out in tiles of 64 columns by 64 deep, K-major 8 x 8 core matrices of 128
bytes (element (n, k) of a tile at (n // 8) 512 + (k // 8) 64 + (n % 8) 8 +
k % 8), tiles ordered [n-tile][k-tile], zeros past the edges: nothing is
split. `tc_gemm` takes bf16 operands on the bf16 engine; every bf16 row must
start on 16 bytes (a leading dimension that is a multiple of 8).

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
from marf_tpu_torch.ops.cuda.fused_step import check_tensor, ptr_array

SOURCES = ["tc_gemm.cu"]
PRE_BN, BK = 64, 32  # a pre-split tile's width and depth (TC_PRE_BN, TC_BK in csrc/tc_gemm.cuh)
BK_BF16 = 64  # the bf16 engine's k-tile depth (TB_BK)
LAYOUTS = {"mk,nk": (True, False), "mk,kn": (True, True), "km,kn": (False, True), "km,nk": (False, False)}
EPILOGUES = {"store": 0, "bias_relu": 1, "gate": 2}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.marf_tc_gemm_workspace.argtypes = [i, i, i, i, i]
    lib.marf_tc_gemm_workspace.restype = ctypes.c_longlong
    lib.marf_tc_gemm.argtypes = [i, i, i, i, i, i, i, p, i, p, i, p, i, p, p, i, i, p, p, p]
    lib.marf_tc_gemm.restype = ctypes.c_int
    lib.marf_tc_presplit_floats.argtypes = [i, i]
    lib.marf_tc_presplit_floats.restype = ctypes.c_longlong
    lib.marf_tc_presplit.argtypes = [i, p, p, p, p, p, p]
    lib.marf_tc_presplit.restype = ctypes.c_int
    ll = ctypes.c_longlong
    lib.marf_tc_gemm_presplit_groups.argtypes = [i, i, i, i, i, p, i, ll, p, ll, p, i, ll, p, p, i, ll, p]
    lib.marf_tc_gemm_presplit_groups.restype = ctypes.c_int
    lib.marf_tb_gemm_workspace.argtypes = [i, i, i, i, i]
    lib.marf_tb_gemm_workspace.restype = ctypes.c_longlong
    lib.marf_tb_gemm.argtypes = [i, i, i, i, i, i, i, p, i, p, i, p, i, p, p, i, i, p, p, p]
    lib.marf_tb_gemm.restype = ctypes.c_int
    lib.marf_tb_presplit_floats.argtypes = [i, i]
    lib.marf_tb_presplit_floats.restype = ctypes.c_longlong
    lib.marf_tb_presplit.argtypes = [i, p, p, p, p, p, p]
    lib.marf_tb_presplit.restype = ctypes.c_int


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


def tc_gemm(a, b, layout: str, epilogue: str = "store", bias=None, gate=None, splits: int = 1, rowsum: bool = False,
            presplit_b: bool = False):
    """C = epilogue(A B) on the tensor cores: in 3xTF32 for float32 operands,
    on the bf16 engine for bfloat16 ones.

    Args:
      a: A as it lies: [M, K] ("mk") or [K, M] ("km"); b: [K, N] ("kn") or
        [N, K] ("nk"). 2-d float32 (or both bfloat16, row strides multiples
        of 8, 16-byte aligned) with unit stride in the last dimension; the
        row stride may be larger (a view of a wider tensor).
      layout: "<A>,<B>" (module docstring).
      epilogue: "store", "bias_relu" (bias [N]) or "gate" (C zeroed where
        gate [M, N] <= 0).
      splits: split-K partials summed in a fixed order (store only; with A
        "km" a depth over 2,048 also takes partials, one per 2,048 deep of
        a split; with A "mk" such a depth is refused).
      rowsum: also return A's row sums over k (A "km" only), folded into the
        product as the dW products fold db.
      presplit_b: B (contiguous, depth at most 2,048) pre-split by
        `presplit` (bf16: converted by `presplit_bf16`, B given as float32)
        and streamed by bulk copies, as the rgb pipeline's forward ("mk,nk")
        and dz ("mk,kn") products read their weights; no splits, no rowsum.

    Returns C [M, N] (and the row sums [M] when rowsum): float32, or on the
    bf16 engine bfloat16 after bias_relu and gate. CPU tensors run
    `tc_gemm_reference`.
    """
    if a.device.type == "cpu":
        return tc_gemm_reference(a, b, layout, epilogue, bias, gate, splits, rowsum)
    if a.device.type != "cuda":
        raise ValueError(f"tc_gemm: unsupported device {a.device}")
    a_k, b_n, M, N, K = _dims(a, b, layout)
    device = a.device
    bf16 = a.dtype == torch.bfloat16
    for name, t in (("a", a), ("b", b)):
        # a pre-split B is the float32 weight as the wrapper keeps it
        dtype = torch.bfloat16 if bf16 and not (presplit_b and name == "b") else torch.float32
        if t.device != device or t.dtype != dtype or t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"tc_gemm: {name} must be a 2-d {dtype} tensor on {device} with unit column stride")
        if dtype == torch.bfloat16 and (t.stride(0) % 8 or t.data_ptr() % 16):
            raise ValueError(f"tc_gemm: bf16 {name} needs a row stride that is a multiple of 8 and 16-byte alignment")
    if (epilogue not in EPILOGUES or (epilogue == "bias_relu") != (bias is not None)
            or (epilogue == "gate") != (gate is not None)):
        raise ValueError(f"tc_gemm: epilogue {epilogue!r} with bias={bias is not None}, gate={gate is not None}")
    if splits < 1 or ((splits > 1 or rowsum) and epilogue != "store") or (rowsum and a_k):
        raise ValueError(f"tc_gemm: splits={splits}, rowsum={rowsum} need the store epilogue (and A 'km' for rowsum)")
    if presplit_b and (layout not in ("mk,nk", "mk,kn") or splits > 1 or rowsum or K > 2048
                       or not b.is_contiguous()):
        raise ValueError(f"tc_gemm: a pre-split B takes layout 'mk,nk' or 'mk,kn', a contiguous B of depth at most "
                         f"2,048, no splits and no rowsum (got {layout}, {tuple(b.shape)}, splits={splits})")
    if bias is not None:
        check_tensor("tc_gemm", "bias", bias, (N,), device)
    if gate is not None and bf16:
        if gate.dtype != torch.bfloat16 or tuple(gate.shape) != (M, N) or not gate.is_contiguous():
            raise ValueError(f"tc_gemm: gate must be a contiguous bfloat16 {(M, N)} tensor")
    elif gate is not None:
        check_tensor("tc_gemm", "gate", gate, (M, N), device)
    lib = _library()
    out_dtype = torch.bfloat16 if bf16 and epilogue != "store" else torch.float32
    c = torch.empty((M, N), dtype=out_dtype, device=device)
    rs = torch.empty((M,), dtype=torch.float32, device=device) if rowsum else None
    workspace = lib.marf_tb_gemm_workspace if bf16 else lib.marf_tc_gemm_workspace
    ws = torch.empty(max(1, workspace(M, N, K, splits, int(rowsum))), dtype=torch.float32, device=device)
    b_ptr, ldb = b.data_ptr(), b.stride(0)
    if presplit_b:
        fwd, dz = (presplit_bf16 if bf16 else presplit)(b)
        b_ptr, ldb = (fwd if layout == "mk,nk" else dz).data_ptr(), 0
    rc = (lib.marf_tb_gemm if bf16 else lib.marf_tc_gemm)(
        int(a_k), int(b_n), int(presplit_b), EPILOGUES[epilogue], M, N, K, a.data_ptr(), a.stride(0), b_ptr, ldb,
        c.data_ptr(), N, None if bias is None else bias.data_ptr(), None if gate is None else gate.data_ptr(), N,
        splits, None if rs is None else rs.data_ptr(), ws.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"tc_gemm kernel launch failed: CUDA error {rc}")
    LAUNCHES["tc_gemm_bf16" if bf16 else "tc_gemm"] += 1
    return (c, rs) if rowsum else c


def tc_gemm_groups(a, w, layout: str, epilogue: str = "store", bias=None, gate=None):
    """`tc_gemm` with a pre-split B over G operand sets in one launch (the
    mask heads' grouped form of the forward and dz products): a [G, M, K],
    w [G, rows, cols] (each group's weight, pre-split by `presplit`), bias
    [G, N], gate [G, M, N], all contiguous float32; layout "mk,nk" (the
    forward, B(k, n) = w[g, n, k]) or "mk,kn" (the dz product). Returns C
    [G, M, N]. CPU tensors run `tc_gemm_reference` per group."""
    if a.device.type == "cpu":
        return torch.stack([tc_gemm_reference(a[g], w[g], layout, epilogue, None if bias is None else bias[g],
                                              None if gate is None else gate[g]) for g in range(a.shape[0])])
    if a.device.type != "cuda":
        raise ValueError(f"tc_gemm_groups: unsupported device {a.device}")
    if layout not in ("mk,nk", "mk,kn") or a.dim() != 3 or w.dim() != 3 or a.shape[0] != w.shape[0]:
        raise ValueError(f"tc_gemm_groups: layout 'mk,nk' or 'mk,kn', A [G, M, K], W [G, rows, cols] "
                         f"(got {layout}, {tuple(a.shape)}, {tuple(w.shape)})")
    G, M = a.shape[:2]
    _, _, _, N, K = _dims(a[0], w[0], layout)
    device = a.device
    for name, t in (("a", a), ("w", w)):
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"tc_gemm_groups: {name} must be a contiguous float32 tensor on {device}")
    if (epilogue not in EPILOGUES or (epilogue == "bias_relu") != (bias is not None)
            or (epilogue == "gate") != (gate is not None)):
        raise ValueError(f"tc_gemm_groups: epilogue {epilogue!r} with bias={bias is not None}, "
                         f"gate={gate is not None}")
    if bias is not None:
        check_tensor("tc_gemm_groups", "bias", bias, (G, N), device)
    if gate is not None:
        check_tensor("tc_gemm_groups", "gate", gate, (G, M, N), device)
    lib = _library()
    b = torch.stack([pre[0 if layout == "mk,nk" else 1] for pre in presplit_table(list(w))])
    c = torch.empty((G, M, N), dtype=torch.float32, device=device)
    rc = lib.marf_tc_gemm_presplit_groups(
        EPILOGUES[epilogue], G, M, N, K, a.data_ptr(), K, M * K, b.data_ptr(), b.shape[1], c.data_ptr(), N, M * N,
        None if bias is None else bias.data_ptr(), None if gate is None else gate.data_ptr(), N, M * N,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"tc_gemm_groups kernel launch failed: CUDA error {rc}")
    LAUNCHES["tc_gemm"] += 1
    return c


def tc_gemm_reference(a, b, layout: str, epilogue: str = "store", bias=None, gate=None, splits: int = 1,
                      rowsum: bool = False):
    """Plain PyTorch version of `tc_gemm` (torch.matmul plus the epilogue);
    neither `splits` nor a pre-split B changes the function. bfloat16
    operands: the product of their float32 values (exact per term), a
    pre-split B rounded to bf16, and a bfloat16 C after bias_relu or gate."""
    a_k, b_n, *_ = _dims(a, b, layout)
    bf16 = a.dtype == torch.bfloat16
    A, Bm = (a if a_k else a.T), (b if b_n else b.T)
    if bf16:
        A, Bm = A.float(), Bm.to(torch.bfloat16).float()
    c = A @ Bm
    if epilogue == "bias_relu":
        c = torch.relu(c + bias)
    elif epilogue == "gate":
        c = torch.where(gate.float() > 0, c, torch.zeros_like(c))
    if bf16 and epilogue != "store":
        c = c.to(torch.bfloat16)
    return (c, A.sum(dim=1)) if rowsum else c


def presplit_floats(n: int, k: int) -> int:
    """Floats of the pre-split B of a product of n columns and depth k."""
    return -(-n // PRE_BN) * -(-k // BK) * 2 * PRE_BN * BK


def presplit(w: torch.Tensor):
    """W [rows, cols] (contiguous float32) pre-split as the B of its forward
    and of its dz product (module docstring): (fwd [presplit_floats(rows,
    cols)], dz [presplit_floats(cols, rows)]). CPU tensors run
    `presplit_reference`."""
    return presplit_table([w])[0]


PRESPLIT_MAX = 64  # weights per launch of the pre-split (csrc/tc_gemm.cuh)


def presplit_table(ws: list, bf16: bool = False) -> list:
    """Each weight of `ws` (at most PRESPLIT_MAX, contiguous 2-d float32, of
    any shapes) pre-split as `presplit` lays out one (bf16: converted as
    `presplit_bf16` does), all in one launch, as the mask heads pre-split
    every head's hidden layers: [(fwd, dz)]. CPU tensors run the plain
    version of each weight."""
    name = "presplit_bf16" if bf16 else "presplit"
    if ws[0].device.type == "cpu":
        ref = presplit_bf16_reference if bf16 else presplit_reference
        return [ref(w) for w in ws]
    device = ws[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if len(ws) > PRESPLIT_MAX:
        raise ValueError(f"{name}: at most {PRESPLIT_MAX} weights a launch, got {len(ws)}")
    for w in ws:
        if w.device != device or w.dtype != torch.float32 or w.dim() != 2 or not w.is_contiguous():
            raise ValueError(f"{name}: W must be a contiguous 2-d float32 tensor on {device}, "
                             f"got {w.dtype} {tuple(w.shape)} on {w.device}")
    lib = _library()
    floats = lib.marf_tb_presplit_floats if bf16 else lib.marf_tc_presplit_floats
    out = [(torch.empty(floats(*w.shape), dtype=torch.float32, device=device),
            torch.empty(floats(*w.shape[::-1]), dtype=torch.float32, device=device)) for w in ws]
    ints = lambda xs: (ctypes.c_int * len(xs))(*xs)
    rc = (lib.marf_tb_presplit if bf16 else lib.marf_tc_presplit)(
        len(ws), ptr_array(ws), ints([w.shape[0] for w in ws]), ints([w.shape[1] for w in ws]),
        ptr_array([f for f, _ in out]), ptr_array([d for _, d in out]), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES["tc_presplit_bf16" if bf16 else "tc_presplit"] += 1
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as the engine's tf32_rna: to nearest, ties
    away from zero, the low 13 bits cleared (finite inputs)."""
    u = (x.contiguous().view(torch.int32).to(torch.int64) + 0x1000) & 0xFFFFE000
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)


def _presplit_one(bt: torch.Tensor) -> torch.Tensor:
    """Bt [N, K] (Bt[n, k] = B(k, n)) -> its pre-split, flat."""
    N, K = bt.shape
    nt, kt = -(-N // PRE_BN), -(-K // BK)
    x = torch.zeros(nt * PRE_BN, kt * BK, dtype=torch.float32, device=bt.device)
    x[:N, :K] = bt
    hi = tf32(x)
    lo = tf32(x - hi)
    # [n-tile, n // 8, n % 8, k-tile, k // 4, k % 4] -> [n-tile, k-tile, n // 8, k // 4, n % 8, k % 4]
    lay = lambda t: t.reshape(nt, PRE_BN // 8, 8, kt, BK // 4, 4).permute(0, 3, 1, 4, 2, 5)
    return torch.stack([lay(hi), lay(lo)], dim=2).reshape(-1)


def presplit_reference(w: torch.Tensor):
    """Plain PyTorch version of `presplit`: (fwd, dz)."""
    return _presplit_one(w), _presplit_one(w.T)


def presplit_bf16_floats(n: int, k: int) -> int:
    """Floats of the bf16 engine's pre-converted B of n columns and depth k."""
    return -(-n // PRE_BN) * -(-k // BK_BF16) * PRE_BN * BK_BF16 // 2


def presplit_bf16(w: torch.Tensor):
    """W [rows, cols] (contiguous float32) converted to bf16 tiles as the B of
    its forward and of its dz product (module docstring): (fwd, dz), float32
    tensors of presplit_bf16_floats(rows, cols) and (cols, rows) floats
    holding the bf16 values. CPU tensors run `presplit_bf16_reference`."""
    return presplit_table([w], bf16=True)[0]


def _presplit_bf16_one(bt: torch.Tensor) -> torch.Tensor:
    """Bt [N, K] (Bt[n, k] = B(k, n)) -> its bf16 tiles, flat, as float32 words."""
    N, K = bt.shape
    nt, kt = -(-N // PRE_BN), -(-K // BK_BF16)
    x = torch.zeros(nt * PRE_BN, kt * BK_BF16, dtype=torch.bfloat16, device=bt.device)
    x[:N, :K] = bt
    # [n-tile, n // 8, n % 8, k-tile, k // 8, k % 8] -> [n-tile, k-tile, n // 8, k // 8, n % 8, k % 8]
    t = x.reshape(nt, PRE_BN // 8, 8, kt, BK_BF16 // 8, 8).permute(0, 3, 1, 4, 2, 5)
    return t.contiguous().reshape(-1).view(torch.float32)


def presplit_bf16_reference(w: torch.Tensor):
    """Plain PyTorch version of `presplit_bf16`: (fwd, dz)."""
    return _presplit_bf16_one(w), _presplit_bf16_one(w.T)
