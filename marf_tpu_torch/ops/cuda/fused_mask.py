"""The shared-head implicit-mask head on deduplicated columns: the host-side
factoring and dedup (copies of marf_tpu/ops/pallas/fused_mask.py:68-89,
108-166, 290-308), and the mask-head forward and backward as CUDA kernels
(csrc/fused_mask.cu) beside their plain PyTorch versions.

Factoring. `image.long()` truncates the [0, 1] photo to {0, 1}, so each
pixel's 384-wide embedded RGB is one of 8 rows of `table` (the {0,1}^3 combos
of view-embedding rows 0 and 1). The 426-wide head input becomes a constant
56-row input X = [uv embedding (42); one-hot of the combo (8); zeros (6)],
and the first layer an effective [256, 56] one (`mask_w_stack`); its
gradients map back with `unfactor_mask_grads`. With the view embedding
frozen, X is constant across training.

Dedup (`slot_dedup_inputs`, numpy at setup). The shared head sees the N =
B*HW columns as (pixel, combo) pairs, and most pixels have one combo in every
image, so only K = HW + E columns are distinct: slot0 (each pixel's majority
combo, in pixel order, aligned with the per-position [B, HW] streams) and E
extras (the other (pixel, combo) pairs, combo-major). The per-position mask
is slot0map * m[:HW] plus an E-sized index_add of the extras; each position
has exactly one nonzero term, so the order of the adds cannot change the
result. The backward's segment sums are a fixed-order sum over B for slot0
(inside K4) and E-sized gathers for the extras (in `base`); no float
scatter-add, so the step stays bitwise reproducible.

The fused dedup step (engine/step.py) lays the columns out per rank of a
pixel-sharded run (`slot_dedup_sharded_inputs`; one rank on one card): the
dedup columns split into contiguous blocks apart from the positions, the
extras grouped by the rank that owns their position.

Without dedup (per-image heads, or the shared head under fused_dedup=off)
the head sees all N columns of X = `build_mask_x`, head h its column block
[h HW, (h+1) HW).

`fused_mask_forward` replaces fused_mask.py `fused_mask_forward` (K3);
`fused_mask_backward_dedup` replaces `fused_mask_backward_dedup` (K4);
`fused_mask_backward_g` replaces `fused_mask_backward_g` (K6). Each
dispatches on the device of its inputs: CUDA tensors launch the kernel (or
raise), CPU tensors run its `*_reference` plain version. Effective layers are
lists of (W [out, in], b [out]) tensors, nn.Linear's layout; a head-blocked
kernel takes one such list per head. Each also takes compute_dtype =
"bfloat16" (marf_tpu's arch.compute_dtype): X, the hidden activations and
the weights of every product in bf16, the cotangent through the sigmoid and
each ReLU-gated dz rounded to bf16 before they feed a product, every product
and sum, the bias and the cotangent's own arithmetic float32
(fused_mask.py _mask_fwd_tile, _mask_bwd_dedup_kernel, _mask_bwd_g_kernel).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from marf_tpu_torch.ops.cuda import LAUNCHES, count_presplit
from marf_tpu_torch.ops.cuda.fused_step import bf16_round, bind_bf16, check_compute_dtype, check_tensor, ptr_array
from marf_tpu_torch.ops.posenc import hanerf_pos_embedding

N_COMBOS = 8  # {0,1}^3 RGB index combinations (the faithful quantization)
UV_DIM = 42
X_ROWS = 56  # 42 uv + 8 one-hot + 6 zero rows (marf_tpu's layout)
SOURCES = ["fused_mask.cu"]


def factor_mask_inputs(view_embedding: torch.Tensor, images: torch.Tensor, xy_grid: torch.Tensor):
    """Factor the mask-head inputs (reference model/planar.py:340-349).

    Args:
      view_embedding: [N_vocab, 128]; images: [B, 3, H, W] in [0, 1];
      xy_grid: [HW, 2] unwarped normalized grid.

    Returns:
      (uv [42, HW], onehot [B, 8, HW], table [8, 384]); table row c =
      concat(emb[bit2 c], emb[bit1 c], emb[bit0 c]), the dense input's
      [emb_r, emb_g, emb_b] order.
    """
    B = images.shape[0]
    idx = images.long()  # truncation on [0, 1] -> {0, 1}
    combo = (idx[:, 0] * 4 + idx[:, 1] * 2 + idx[:, 2]).reshape(B, -1)  # [B, HW]
    uv = hanerf_pos_embedding(xy_grid).T.contiguous()  # [42, HW]
    bits = torch.tensor([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(N_COMBOS)], device=view_embedding.device)
    table = view_embedding[bits].reshape(N_COMBOS, -1)  # [8, 384]
    onehot = (combo[:, None, :] == torch.arange(N_COMBOS, device=combo.device)[None, :, None]).to(torch.float32)
    return uv, onehot, table


def build_mask_x(uv: torch.Tensor, onehot: torch.Tensor, single: bool) -> torch.Tensor:
    """The factored mask-head input X (copy of fused_mask.py `build_mask_x`).

    Shared head: [56, B*HW], column b*HW + i (the flat rgb streams' order).
    Per-image heads: [B, 56, HW].
    """
    B, _, HW = onehot.shape
    if single:
        pad = torch.zeros((B, X_ROWS - UV_DIM - N_COMBOS, HW), dtype=torch.float32, device=uv.device)
        return torch.cat([uv[None].expand(B, -1, -1), onehot, pad], dim=1)
    oh_flat = onehot.transpose(0, 1).reshape(N_COMBOS, B * HW)
    pad = torch.zeros((X_ROWS - UV_DIM - N_COMBOS, B * HW), dtype=torch.float32, device=uv.device)
    return torch.cat([uv.repeat(1, B), oh_flat, pad], dim=0)


def slot_dedup_inputs(uv: np.ndarray, onehot: np.ndarray):
    """Deduplicate the shared-head input columns (host, setup time).

    Args:
      uv: [42, HW]; onehot: [B, 8, HW] (factor_mask_inputs, as numpy).

    Returns:
      (X_all [56, HW+E] slot0 columns then extras,
       slot0map [B, HW] 1 where image b's combo at p is the slot0 one,
       ext_pix [E] int32 pixel of each extra column,
       extmap [B, E] 1 where image b's combo at ext_pix[j] is extra j,
       cnt_all [1, HW+E] position count per column), float32 unless noted.
    """
    uv = np.asarray(uv)
    onehot = np.asarray(onehot)
    B, _, HW = onehot.shape
    combo = np.argmax(onehot, axis=1)  # [B, HW]
    counts = np.zeros((N_COMBOS, HW), np.int32)
    np.add.at(counts, (combo, np.arange(HW)[None].repeat(B, 0)), 1)
    slot0 = np.argmax(counts, axis=0)  # [HW] majority combo (ties -> smallest)
    slot0map = (combo == slot0[None]).astype(np.float32)  # [B, HW]
    present = counts > 0
    present[slot0, np.arange(HW)] = False
    cmb_e, pix_e = np.nonzero(present)  # extras, combo-major order
    E = len(pix_e)
    eye = np.eye(N_COMBOS, dtype=np.float32)
    pad0 = np.zeros((X_ROWS - UV_DIM - N_COMBOS, HW), dtype=np.float32)
    X0 = np.concatenate([uv, eye[:, slot0], pad0], axis=0)
    pad_e = np.zeros((X_ROWS - UV_DIM - N_COMBOS, E), dtype=np.float32)
    Xe = np.concatenate([uv[:, pix_e], eye[:, cmb_e], pad_e], axis=0)
    X_all = np.concatenate([X0, Xe], axis=1).astype(np.float32)
    extmap = (combo[:, pix_e] == cmb_e[None]).astype(np.float32)  # [B, E]
    cnt_all = np.concatenate([slot0map.sum(0), extmap.sum(0)])[None].astype(np.float32)
    return X_all, slot0map, pix_e.astype(np.int32), extmap, cnt_all


def slot_dedup_sharded_inputs(uv: np.ndarray, onehot: np.ndarray, n_devices: int, column_multiple: int = 4):
    """Per-rank dedup structures of the pixel-sharded step (copy of
    marf_tpu/ops/pallas/fused_mask.py `slot_dedup_sharded_inputs`).

    The position axis N = B*HW is sharded contiguously (rank d owns
    [d Nl, (d+1) Nl)); the dedup column axis K = HW + E is padded and sharded
    independently. slot0 stays dense per rank (p = n mod HW is affine over a
    contiguous block); the extras' (position, column) pairs are grouped by
    the rank that owns the position, so a step's gathers are Eloc-sized.

    One difference from marf_tpu: K is padded to a multiple of
    column_multiple D, not D, so each rank's Klp = K_pad / D columns stay on
    the multiple of 4 floats that the kernels' 16-byte X reads need
    (engine/step.py DEDUP_COLUMN_MULTIPLE). The extra columns have X = 0 and
    cnt = 0; on marf_tpu's own K_pad columns every array equals marf_tpu's.

    Args:
      uv: [42, HW]; onehot: [B, 8, HW] (factor_mask_inputs, as numpy).
      n_devices: the world size D (N % D == 0).
      column_multiple: K_pad is a multiple of this times D.

    Returns:
      (X_pad [56, K_pad], slot0map_flat [1, N] f32, cnt_pad [1, K_pad] f32,
       ext_off [D, Eloc] i32 position offsets within the owning rank's block,
       ext_col [D, Eloc] i32 global column (>= HW),
       ext_val [D, Eloc] f32 1 for a real pair, 0 for padding).
    """
    X_all, slot0map, ext_pix, extmap, cnt_all = slot_dedup_inputs(uv, onehot)
    B, HW = slot0map.shape
    N = B * HW
    D = int(n_devices)
    if N % D:
        raise ValueError(f"position axis {N} must divide over {D} ranks")
    Nl = N // D
    K = X_all.shape[1]
    K_pad = column_multiple * D * (-(-K // (column_multiple * D)))
    X_pad = np.pad(X_all, ((0, 0), (0, K_pad - K))).astype(np.float32)
    cnt_pad = np.pad(cnt_all, ((0, 0), (0, K_pad - K))).astype(np.float32)
    slot0map_flat = slot0map.reshape(1, N).astype(np.float32)

    bb, jj = np.nonzero(extmap)  # each pair covers exactly one position
    n_pos = bb * HW + ext_pix[jj]
    dev = n_pos // Nl
    per_dev = [np.flatnonzero(dev == d) for d in range(D)]
    Eloc = max((len(s) for s in per_dev), default=0)
    ext_off = np.zeros((D, Eloc), np.int32)
    ext_col = np.zeros((D, Eloc), np.int32)
    ext_val = np.zeros((D, Eloc), np.float32)
    for d, sel in enumerate(per_dev):
        k = len(sel)
        ext_off[d, :k] = n_pos[sel] - d * Nl
        ext_col[d, :k] = HW + jj[sel]
        ext_val[d, :k] = 1.0
    return X_pad, slot0map_flat, cnt_pad, ext_off, ext_col, ext_val


def mask_w_stack(head, table: torch.Tensor) -> list:
    """Effective layers of the factored input: the first layer's [256, 426]
    weights become [256, 56] = [W_uv (cols 384:426) | W_emb (cols 0:384) @
    table^T | zeros]; later layers pass through. Detached."""
    layers = [(layer.weight.detach(), layer.bias.detach()) for layer in head.layers]
    w1, b1 = layers[0]
    pad = torch.zeros((w1.shape[0], X_ROWS - UV_DIM - N_COMBOS), dtype=w1.dtype, device=w1.device)
    w1_eff = torch.cat([w1[:, 384:426], w1[:, :384] @ table.T, pad], dim=1).contiguous()
    return [(w1_eff, b1)] + layers[1:]


def unfactor_mask_grads(dlayers: list, table: torch.Tensor) -> list:
    """Effective-layer grads -> the head's own layout: dW1 [256, 426] =
    [dW_onehot @ table | dW_uv]."""
    dw1_eff, db1 = dlayers[0]
    dw1 = torch.cat([dw1_eff[:, UV_DIM : UV_DIM + N_COMBOS] @ table, dw1_eff[:, :UV_DIM]], dim=1)
    return [(dw1, db1)] + list(dlayers[1:])


def _bind(lib: ctypes.CDLL) -> None:
    p, i, pi, pp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    lib.marf_mask_forward_workspace.argtypes = [i, i, pi]
    lib.marf_mask_forward_workspace.restype = ctypes.c_longlong
    lib.marf_mask_backward_workspace.argtypes = [i, i, pi]
    lib.marf_mask_backward_workspace.restype = ctypes.c_longlong
    lib.marf_mask_backward_g_workspace.argtypes = [i, i, i, pi]
    lib.marf_mask_backward_g_workspace.restype = ctypes.c_longlong
    lib.marf_mask_forward.argtypes = [i, i, pi, p, pp, pp, p, p, p]
    lib.marf_mask_forward.restype = ctypes.c_int
    lib.marf_mask_backward_dedup.argtypes = [i, i, i, i, pi, p, p, p, p, p, p, p, pp, pp, pp, pp, p, p]
    lib.marf_mask_backward_dedup.restype = ctypes.c_int
    lib.marf_mask_backward_g.argtypes = [i, i, i, pi, p, p, p, p, p, ctypes.c_float, pp, pp, pp, pp, p, p]
    lib.marf_mask_backward_g.restype = ctypes.c_int
    bind_bf16(lib, ["marf_mask_forward", "marf_mask_forward_workspace", "marf_mask_backward_dedup",
                    "marf_mask_backward_workspace", "marf_mask_backward_g", "marf_mask_backward_g_workspace"])


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    from marf_tpu_torch.ops.cuda._build import load_library

    return load_library("fused_mask", SOURCES, _bind)


def _checked_layers(fn: str, layers: list, x_cf: torch.Tensor, cols: int | None = None):
    """Check X [rows, K] and one head's effective layers; `cols` is the
    columns the head sees (all K by default). Returns (dims, C dims array)."""
    device = x_cf.device
    cols = x_cf.shape[1] if cols is None else cols
    dims = [x_cf.shape[0]] + [w.shape[0] for w, _ in layers]
    if len(layers) < 2 or dims[-1] != 1 or dims[-2] > 1024 or cols < 1:
        raise ValueError(f"{fn}: unsupported shape (dims={dims}, columns={cols})")
    check_tensor(fn, "x_cf", x_cf, (dims[0], x_cf.shape[1]), device)
    for li, (w, b) in enumerate(layers):
        check_tensor(fn, f"weight[{li}]", w, (dims[li + 1], dims[li]), device)
        check_tensor(fn, f"bias[{li}]", b, (dims[li + 1],), device)
    return dims, (ctypes.c_int * len(dims))(*dims)


def checked_stacks(fn: str, stacks: list, x_cf: torch.Tensor):
    """Check X [rows, N] and every head's effective layers (one shape for
    all heads; N splits into len(stacks) column blocks). Returns (HW, dims,
    C dims array)."""
    n_heads, N = len(stacks), x_cf.shape[1]
    if n_heads < 1 or N % n_heads:
        raise ValueError(f"{fn}: {N} columns do not split into {n_heads} heads")
    HW = N // n_heads
    dims, c_dims = _checked_layers(fn, stacks[0], x_cf, HW)
    if any(_checked_layers(fn, layers, x_cf, HW)[0] != dims for layers in stacks[1:]):
        raise ValueError(f"{fn}: the heads' effective layers differ in shape")
    return HW, dims, c_dims


def fused_mask_forward(layers: list, x_cf: torch.Tensor, compute_dtype: str = "float32") -> torch.Tensor:
    """Mask-head forward on the K factored columns (K3): X [56, K] -> m [1, K]."""
    fn = "fused_mask_forward"
    check_compute_dtype(fn, compute_dtype)
    if x_cf.device.type == "cpu":
        return fused_mask_forward_reference(layers, x_cf, compute_dtype)
    if x_cf.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x_cf.device}")
    dims, c_dims = _checked_layers(fn, layers, x_cf)
    lib = _library()
    sfx = "_bf16" if compute_dtype == "bfloat16" else ""
    K = x_cf.shape[1]
    m = torch.empty((1, K), dtype=torch.float32, device=x_cf.device)
    ws = torch.empty(getattr(lib, f"marf_mask_forward{sfx}_workspace")(K, len(layers), c_dims), dtype=torch.float32,
                     device=x_cf.device)
    rc = getattr(lib, f"marf_mask_forward{sfx}")(K, len(layers), c_dims, x_cf.data_ptr(),
                                                 ptr_array([w for w, _ in layers]), ptr_array([b for _, b in layers]),
                                                 m.data_ptr(), ws.data_ptr(),
                                                 torch.cuda.current_stream(x_cf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} ({compute_dtype}) kernel launch failed: CUDA error {rc}")
    LAUNCHES[fn + sfx] += 1
    if not sfx:
        count_presplit("K3", dims)
    return m


def fused_mask_backward_dedup(layers: list, x_cf, s0map, sq_b, esq_b, base, cnt, abk,
                              compute_dtype: str = "float32") -> list:
    """Mask-head backward on the K dedup columns with the slot0 segment sum
    and the cotangent in the kernel (K4).

    Args:
      layers: effective layers [(W [out, in], b [out])] (mask_w_stack).
      x_cf: [56, K] factored columns, slot0 block first (K = HW + E).
      s0map: [B, HW] slot0 indicator; sq_b: [B, HW] per-position rgb squared
        error; esq_b: [B, HW] per-position edge squared error, or None.
      base: [1, K] c*cnt plus the extras' segment sums a*Ssq + b*Sesq.
      cnt: [1, K] positions per column.
      abk: [3] (a, b, k) of dL/dm = (a Ssq + b Sesq + c cnt) m + k cnt.
      compute_dtype: "float32" or "bfloat16" (module docstring).

    Returns the effective-layer grads [(dW [out, in], db [out])]
    (unfactor_mask_grads maps them back).
    """
    fn = "fused_mask_backward_dedup"
    check_compute_dtype(fn, compute_dtype)
    if x_cf.device.type == "cpu":
        return fused_mask_backward_dedup_reference(layers, x_cf, s0map, sq_b, esq_b, base, cnt, abk, compute_dtype)
    if x_cf.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x_cf.device}")
    dims, c_dims = _checked_layers(fn, layers, x_cf)
    device = x_cf.device
    K = x_cf.shape[1]
    B, HW = s0map.shape
    if HW > K:
        raise ValueError(f"{fn}: the slot0 block ({HW} columns) is wider than K={K}")
    for name, t, shape in (("s0map", s0map, (B, HW)), ("sq_b", sq_b, (B, HW)), ("esq_b", esq_b, (B, HW)),
                           ("base", base, (1, K)), ("cnt", cnt, (1, K)), ("abk", abk, (3,))):
        if t is not None:
            check_tensor(fn, name, t, shape, device)
    lib = _library()
    sfx = "_bf16" if compute_dtype == "bfloat16" else ""
    dws = [torch.empty_like(w) for w, _ in layers]
    dbs = [torch.empty_like(b) for _, b in layers]
    ws = torch.empty(getattr(lib, f"marf_mask_backward{sfx}_workspace")(K, len(layers), c_dims), dtype=torch.float32,
                     device=device)
    rc = getattr(lib, f"marf_mask_backward_dedup{sfx}")(
        K, HW, B, len(layers), c_dims, x_cf.data_ptr(), s0map.data_ptr(), sq_b.data_ptr(),
        None if esq_b is None else esq_b.data_ptr(), base.data_ptr(), cnt.data_ptr(), abk.data_ptr(),
        ptr_array([w for w, _ in layers]), ptr_array([b for _, b in layers]), ptr_array(dws), ptr_array(dbs),
        ws.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{fn} ({compute_dtype}) kernel launch failed: CUDA error {rc}")
    LAUNCHES[fn + sfx] += 1
    if not sfx:
        count_presplit("K4", dims)
    return list(zip(dws, dbs))


def fused_mask_backward_g(stacks: list, x_cf, sq, esq, abk, c: float, cnt=None,
                          compute_dtype: str = "float32") -> list:
    """Head-blocked mask-head backward with the cotangent in the kernel (K6).

    Args:
      stacks: per head, its effective layers [(W [out, in], b [out])]
        (mask_w_stack); one list for the shared head, B for per-image heads.
      x_cf: [56, N] factored columns, N = n_heads * HW; head h owns columns
        [h HW, (h+1) HW).
      sq: [1, N] per-column rgb squared error; esq: [1, N] edge squared
        error, or None.
      abk: [3] (a, b, k) on the device; c: float; of the cotangent
        dL/dm = (a sq + b esq + c cnt) m + k cnt.
      cnt: [1, N] column counts, or None (ones).
      compute_dtype: "float32" or "bfloat16" (module docstring).

    Returns, per head, the effective-layer grads [(dW [out, in], db [out])]
    (unfactor_mask_grads maps them back).
    """
    fn = "fused_mask_backward_g"
    check_compute_dtype(fn, compute_dtype)
    if x_cf.device.type == "cpu":
        return fused_mask_backward_g_reference(stacks, x_cf, sq, esq, abk, c, cnt, compute_dtype)
    if x_cf.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x_cf.device}")
    device = x_cf.device
    n_heads, N = len(stacks), x_cf.shape[1]
    _, dims, c_dims = checked_stacks(fn, stacks, x_cf)
    for name, t, shape in (("sq", sq, (1, N)), ("esq", esq, (1, N)), ("cnt", cnt, (1, N)), ("abk", abk, (3,))):
        if t is not None:
            check_tensor(fn, name, t, shape, device)
    lib = _library()
    sfx = "_bf16" if compute_dtype == "bfloat16" else ""
    flat = [wb for layers in stacks for wb in layers]
    dws = [torch.empty_like(w) for w, _ in flat]
    dbs = [torch.empty_like(b) for _, b in flat]
    # the workspace spans all N columns (every head's activations at once, up to 16 heads)
    ws = torch.empty(getattr(lib, f"marf_mask_backward_g{sfx}_workspace")(N, n_heads, len(stacks[0]), c_dims),
                     dtype=torch.float32, device=device)
    rc = getattr(lib, f"marf_mask_backward_g{sfx}")(
        N, n_heads, len(stacks[0]), c_dims, x_cf.data_ptr(), sq.data_ptr(), None if esq is None else esq.data_ptr(),
        None if cnt is None else cnt.data_ptr(), abk.data_ptr(), float(c), ptr_array([w for w, _ in flat]),
        ptr_array([b for _, b in flat]), ptr_array(dws), ptr_array(dbs), ws.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{fn} ({compute_dtype}) kernel launch failed: CUDA error {rc}")
    LAUNCHES[fn + sfx] += 1
    if not sfx:
        count_presplit("K6", dims, n_heads)
    n = len(stacks[0])
    return [list(zip(dws[h * n : (h + 1) * n], dbs[h * n : (h + 1) * n])) for h in range(n_heads)]


def _mask_mlp(layers: list, x_cf: torch.Tensor) -> torch.Tensor:
    feat = x_cf
    last = len(layers) - 1
    for li, (w, b) in enumerate(layers):
        feat = torch.addmm(b[:, None], w, feat)
        feat = torch.relu(feat) if li != last else torch.sigmoid(feat)
    return feat


def _mask_mlp_bf16(layers: list, x_cf: torch.Tensor):
    """`_mask_mlp` at compute_dtype = bfloat16: (m [1, K], the layers' inputs
    rounded to bf16, X first)."""
    acts = [bf16_round(x_cf)]
    last = len(layers) - 1
    for li, (w, b) in enumerate(layers):
        z = torch.addmm(b[:, None], bf16_round(w), acts[li])
        if li != last:
            acts.append(bf16_round(torch.relu(z)))
    return torch.sigmoid(z), acts


def fused_mask_forward_reference(layers: list, x_cf: torch.Tensor, compute_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of `fused_mask_forward`."""
    if compute_dtype == "bfloat16":
        return _mask_mlp_bf16(layers, x_cf)[0]
    return _mask_mlp(layers, x_cf)


def fused_mask_backward_dedup_reference(layers: list, x_cf, s0map, sq_b, esq_b, base, cnt, abk,
                                        compute_dtype: str = "float32") -> list:
    """Plain PyTorch version of `fused_mask_backward_dedup`: the forward under
    autograd, pulled back from m with the cotangent (seg m + k cnt), seg =
    a Ssq + b Sesq + base with the slot0 sums over B on the first HW columns.
    In bfloat16 the backward is written out as the kernel rounds it (each d
    rounded to bf16 before it feeds a product)."""
    seg = _slot0_pad(abk[0] * torch.sum(s0map * sq_b, dim=0), base) + base
    if esq_b is not None:
        seg = seg + _slot0_pad(abk[1] * torch.sum(s0map * esq_b, dim=0), base)
    if compute_dtype == "bfloat16":
        return _mask_backward_bf16(layers, x_cf, lambda m: seg * m + abk[2] * cnt)
    with torch.enable_grad():
        params = [(w.detach().requires_grad_(True), b.detach().requires_grad_(True)) for w, b in layers]
        m = _mask_mlp(params, x_cf)
        g = seg * m.detach() + abk[2] * cnt
        grads = torch.autograd.grad(m, [t for wb in params for t in wb], g)
    return list(zip(grads[0::2], grads[1::2]))


def _mask_backward_bf16(layers: list, x_cf, cot) -> list:
    """The mask head's backward as the bf16 kernels round it, from the
    cotangent cot(m) of dL/dm: d = g m (1 - m) rounded to bf16, dW and db
    summed from the rounded d, each ReLU-gated dz rounded to bf16 before it
    feeds a product."""
    layers = [(w.detach(), b.detach()) for w, b in layers]
    m, acts = _mask_mlp_bf16(layers, x_cf)
    d = bf16_round(cot(m) * m * (1.0 - m))
    grads = [None] * len(layers)
    for li in range(len(layers) - 1, -1, -1):
        grads[li] = (d @ acts[li].T, torch.sum(d, dim=1))
        if li > 0:
            d = bf16_round((bf16_round(layers[li][0]).T @ d) * (acts[li] > 0))
    return grads


def _slot0_pad(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[HW] -> [1, K] with zeros past the slot0 block."""
    return torch.nn.functional.pad(v[None], (0, like.shape[1] - v.shape[0]))


def fused_mask_backward_g_reference(stacks: list, x_cf, sq, esq, abk, c: float, cnt=None,
                                    compute_dtype: str = "float32") -> list:
    """Plain PyTorch version of `fused_mask_backward_g`: per head, the
    forward on its column block under autograd, pulled back from m with the
    cotangent (a sq + b esq + c cnt) m + k cnt. In bfloat16 the backward is
    written out as the kernel rounds it (`_mask_backward_bf16`)."""
    HW = x_cf.shape[1] // len(stacks)
    out = []
    for h, layers in enumerate(stacks):
        cols = slice(h * HW, (h + 1) * HW)
        n = 1.0 if cnt is None else cnt[:, cols]
        s = abk[0] * sq[:, cols]
        if esq is not None:
            s = s + abk[1] * esq[:, cols]
        cot = lambda m: (s + c * n) * m + abk[2] * n
        if compute_dtype == "bfloat16":
            out.append(_mask_backward_bf16(layers, x_cf[:, cols], cot))
            continue
        with torch.enable_grad():
            params = [(w.detach().requires_grad_(True), b.detach().requires_grad_(True)) for w, b in layers]
            m = _mask_mlp(params, x_cf[:, cols])
            grads = torch.autograd.grad(m, [t for wb in params for t in wb], cot(m.detach()))
        out.append(list(zip(grads[0::2], grads[1::2])))
    return out
