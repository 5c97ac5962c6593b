"""The 3xTF32 tensor-core GEMM engine of K1-K6 (csrc/tc_gemm.cuh).

On the CPU: a numpy emulation of the engine's arithmetic (each float32
operand split into hi = tf32(x) and lo = tf32(x - hi), tf32 rounding to
nearest with ties away from zero; per k-tile of 32 along K the products
lo_a hi_b, hi_a lo_b, hi_a hi_b summed into a fresh accumulator, which one
float32 add takes into the running sum; a partial per 64 k-tiles of each
split, the partials summed pairwise; the folded row sums in the kernel's
order) at the engine's shapes, and at K6's and K4's real dW splits with
operands shaped as their dz, activations and X: its error against float64
stays within twice float32 torch's own, while single-pass TF32 (hi_a hi_b
only) does not, which is why the engine never uses it. This covers the split
arithmetic only: the kernel itself runs on a card.

On the CPU also the weights' pre-split (`presplit`, the B operand of the
forward and dz products of the rgb pipeline and of K3's and K4's hidden
layers, split once per call): its plain version against the core-matrix
layout formula, written out here, for W and W^T.

The bf16 engine (compute_dtype = bfloat16; bf16 operands, float32 products
and sums): on the CPU its weight conversion's plain version against the
core-matrix layout formula; on a card every operand layout and epilogue,
depths, split-K with the row sums and the pre-converted B, as below.

On a card (marker `cuda`): `tc_gemm` against its plain version and float64,
for every operand layout and epilogue, at ragged sizes and depths, with
split-K and the folded row sums, from misaligned views (4-byte copies), and
at K6's real dW split (within twice the plain version's distance from
float64); the pre-split kernel bitwise equal to its plain version; the
forward and dz products with B pre-split (the warp-specialised kernel) at
the main path's sizes, one group or two, against the plain version and
float64, and bitwise equal to a relaunch and to the same products with B
split in shared memory.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import numpy as np
import pytest
import torch

from marf_tpu_torch.ops.cuda import LAUNCHES
from marf_tpu_torch.ops.cuda import tc_gemm as tg


def tf32(x: np.ndarray) -> np.ndarray:
    """Round float32 to TF32 as PTX cvt.rna.tf32.f32 does on finite inputs."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def split_tf32(x: np.ndarray):
    hi = tf32(x)
    return hi, tf32(np.asarray(x, np.float32) - hi)


FLUSH = 64  # k-tiles per partial (TC_FLUSH in csrc/tc_gemm.cuh)


def pairwise(parts: list) -> np.ndarray:
    """The partials' sum in reduce_tree_group_kernel's order (a binary counter)."""
    stack = []
    for z, v in enumerate(parts):
        while z & 1:
            v = stack.pop() + v
            z >>= 1
        stack.append(v)
    s = stack.pop()
    while stack:
        s = stack.pop() + s
    return s


def _partials(K: int, chunk: int):
    """(split start, split end, partial start) of every partial the engine
    writes, a short last split padded with empty ones."""
    subs = -(-(-(-chunk // 32)) // FLUSH)
    for k0 in range(0, K, chunk):
        k1 = min(K, k0 + chunk)
        for j in range(subs):
            yield k0, k1, k0 + j * 32 * FLUSH


def emulate(a: np.ndarray, b: np.ndarray, chunk: int | None = None, passes: int = 3) -> np.ndarray:
    """A [M, K] @ B [K, N] as the engine computes it (module docstring): the
    TF32 products are exact, so the float64 sum of a k-tile's terms over its
    32-deep slice, rounded to float32 and added to the float32 running sum
    of its partial, models it. passes=1 is single-pass TF32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    K = a.shape[1]
    parts = []
    for _, k1, p0 in _partials(K, chunk or -(-K // 32) * 32):
        acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for k in range(p0, min(k1, p0 + 32 * FLUSH), 32):
            s = slice(k, min(k1, k + 32))
            acc = acc + sum(x[:, s].astype(np.float64) @ y[s].astype(np.float64) for x, y in terms).astype(np.float32)
        parts.append(acc)
    return pairwise(parts)


def emulate_rowsum(a: np.ndarray, chunk: int) -> np.ndarray:
    """The row sums of A [M, K] folded into a dW product, in the kernel's
    order: lane l of a row's four adds k = 8q + l and 8q + l + 4 of each
    k-tile into the tile's sum, then that into its partial's; the four lanes
    meet by an xor tree; the partials are summed pairwise."""
    K = a.shape[1]
    parts = []
    for _, k1, p0 in _partials(K, chunk):
        rs = np.zeros((a.shape[0], 4), np.float32)
        for t in range(p0, min(k1, p0 + 32 * FLUSH), 32):
            tile = np.zeros_like(rs)
            for k in range(t, t + 32, 8):
                for off in (0, 4):
                    idx = np.arange(k + off, k + off + 4)
                    tile = tile + np.where(idx < k1, a[:, np.minimum(idx, K - 1)], np.float32(0))
            rs = rs + tile
        parts.append((rs[:, 0] + rs[:, 1]) + (rs[:, 2] + rs[:, 3]))
    return pairwise(parts)


def dw_chunk(points: int, out: int, inp: int, groups: int = 1) -> int:
    """The points per split of a dW product over `groups` heads
    (TcEngine::dw_split in csrc/tc_gemm.cuh: one wave of 132 blocks of
    128 x 128, or 264 of 128 x 64 for a layer at most 64 wide; BK = 32)."""
    cdiv = lambda a, b: -(-a // b)
    bn, wave = (64, 264) if inp <= 64 else (128, 132)
    s = max(1, wave // (groups * cdiv(out, 128) * cdiv(inp, bn)))
    return cdiv(cdiv(points, s), 32) * 32


# K6's 256-wide dW products at the main path's shape: five heads of 43,200
# columns, split as the engine splits them (7,200 points, six splits a head)
K6_POINTS = 43_200
K6_CHUNK = dw_chunk(K6_POINTS, 256, 256, groups=5)


def k6_operands(rng, points: int = K6_POINTS, out: int = 256, inp: int = 256):
    """A dW product's operands as K6's top hidden layer makes them: dz [pts,
    out] = d_p w_j on the units a point keeps (about half), d_p of either
    sign with a common bias (most points push the same way), and the layer
    input, ReLU activations [pts, in]."""
    d = 1e-5 * (rng.randn(points) + 0.5)
    dz = (d[:, None] * rng.randn(out)[None] * (rng.rand(points, out) > 0.5)).astype(np.float32)
    x = np.maximum(rng.randn(points, inp), 0.0).astype(np.float32)
    return dz, x


def rel(x, ref) -> float:
    return float(np.abs(np.asarray(x, np.float64) - ref).max() / np.abs(ref).max())


# (M, K, N, chunk): forward layers at depths 34 (rgb input), 56 (mask input)
# and 256 (hidden); a dz product into the 34-wide encoding; dW reductions
# over 4,096 points into 34-, 56- and 256-wide layers, split as the engine splits
SHAPES = [
    (512, 34, 256, None), (512, 56, 256, None), (512, 256, 256, None), (512, 256, 34, None),
    (256, 4096, 34, dw_chunk(4096, 256, 34)), (256, 4096, 56, dw_chunk(4096, 256, 56)),
    (256, 4096, 256, dw_chunk(4096, 256, 256)),
]
IDS = ["fwd34", "fwd56", "fwd256", "dz34", "dw34", "dw56", "dw256"]


def _case(rng, M, K, N):
    a = rng.randn(M, K).astype(np.float32)
    b = rng.randn(K, N).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    err32 = rel((torch.from_numpy(a) @ torch.from_numpy(b)).numpy(), ref)
    return a, b, ref, err32


def test_split_rounds_to_nearest_ties_away():
    x = np.array([1.0, 1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-11 - 2.0**-23, 3.14159265, -2.5e-7], np.float32)
    hi, lo = split_tf32(x)
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0) and np.all(lo.view(np.uint32) & 0x1FFF == 0)
    # a tie (half a TF32 ulp) rounds away from zero, just below it rounds down
    assert hi[1] == np.float32(1.0 + 2.0**-10) and hi[2] == -np.float32(1.0 + 2.0**-10) and hi[3] == 1.0
    # hi + lo keeps x to 2^-22 of its size; hi alone to 2^-11
    x64 = x.astype(np.float64)
    assert np.all(np.abs(hi.astype(np.float64) + lo - x64) <= 2.0**-22 * np.abs(x64))
    assert np.all(np.abs(hi.astype(np.float64) - x64) <= 2.0**-11 * np.abs(x64))


@pytest.mark.parametrize("M,K,N,chunk", SHAPES, ids=IDS)
def test_3xtf32_is_float32_accurate(rng, M, K, N, chunk):
    a, b, ref, err32 = _case(rng, M, K, N)
    assert rel(emulate(a, b, chunk), ref) <= 2.0 * err32


@pytest.mark.parametrize("M,K,N,chunk", SHAPES[:3] + SHAPES[-1:], ids=IDS[:3] + IDS[-1:])
def test_single_pass_tf32_is_not(rng, M, K, N, chunk):
    a, b, ref, err32 = _case(rng, M, K, N)
    assert rel(emulate(a, b, chunk, passes=1), ref) > 100.0 * err32


def test_3xtf32_at_k6_dw_split(rng):
    """dW and the folded db at K6's real split, from K6-like operands: the
    emulated engine within twice float32 torch's distance from float64."""
    assert K6_CHUNK == 7200
    dz, x = k6_operands(rng)
    ref = dz.T.astype(np.float64) @ x.astype(np.float64)
    err32 = rel((torch.from_numpy(dz).T @ torch.from_numpy(x)).numpy(), ref)
    assert rel(emulate(dz.T, x, K6_CHUNK), ref) <= 2.0 * err32
    ref_db = dz.astype(np.float64).sum(0)
    assert rel(emulate_rowsum(dz.T, K6_CHUNK), ref_db) <= 2.0 * rel(torch.from_numpy(dz).sum(0).numpy(), ref_db)


# K4's dW products at the main path's shape: one head on the K = 46,271
# dedup columns of chip_smoke.py's inputs, split as the engine splits them
K4_POINTS = 46_271


def x_operand(rng, points: int = K4_POINTS) -> np.ndarray:
    """K4's layer-0 input as its dW product reads it, X^T [points, 56]: 42
    uv embedding rows (sines and cosines), a one-hot of the 8 combos, 6
    zero rows."""
    uv = np.sin(rng.rand(points, 42) * 2.0 * np.pi)
    onehot = np.eye(8)[rng.randint(0, 8, points)]
    return np.concatenate([uv, onehot, np.zeros((points, 6))], axis=1).astype(np.float32)


@pytest.mark.parametrize("inp,chunk,splits", [(256, 1408, 33), (56, 352, 132)], ids=["hidden", "layer0"])
def test_3xtf32_at_k4_dw_split(rng, inp, chunk, splits):
    """dW and the folded db of K4's [256, 256] hidden layers (33 splits of
    1,408 points) and of its [256, 56] first layer (132 splits of 352),
    from K4-like operands: the emulated engine within twice float32 torch's
    distance from float64."""
    assert dw_chunk(K4_POINTS, 256, inp) == chunk and -(-K4_POINTS // chunk) == splits
    dz, x = k6_operands(rng, K4_POINTS, 256, inp)
    if inp == 56:
        x = x_operand(rng)
    ref = dz.T.astype(np.float64) @ x.astype(np.float64)
    err32 = rel((torch.from_numpy(dz).T @ torch.from_numpy(x)).numpy(), ref)
    assert rel(emulate(dz.T, x, chunk), ref) <= 2.0 * err32
    ref_db = dz.astype(np.float64).sum(0)
    assert rel(emulate_rowsum(dz.T, chunk), ref_db) <= 2.0 * rel(torch.from_numpy(dz).sum(0).numpy(), ref_db)


def test_pairwise_sum_order():
    parts = [np.float32(v) for v in (1.0, 2.0**-24, 2.0**-24, 2.0**-24, 2.0**-24)]
    # ((1 + e) + (e + e)) + e: the early pair keeps what a running sum drops
    assert pairwise(parts) == np.float32(1.0) + np.float32(2.0**-22)
    assert pairwise([np.float32(3.0)]) == 3.0


def test_wrapper_runs_plain_version_on_cpu_without_counting(rng):
    a = torch.from_numpy(rng.randn(37, 19).astype(np.float32))
    b = torch.from_numpy(rng.randn(23, 19).astype(np.float32))
    before = dict(LAUNCHES)
    c = tg.tc_gemm(a, b, "mk,nk", "bias_relu", bias=torch.ones(23))
    assert LAUNCHES == before
    torch.testing.assert_close(c, torch.relu(a @ b.T + 1.0), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tg.tc_gemm(a, b, "mk,kn")


# the rgb MLP's layers W [out, in]: 34 -> 256 (a ragged k-tile in the
# forward, a ragged n-tile in the dz product) and 256 -> 256
PRESPLIT_SHAPES = [(256, 34), (256, 256)]


def presplit_offsets(N: int, K: int):
    """The core-matrix layout, written out: the float offset of (n, k) in
    part p (0 hi, 1 lo) of a pre-split B of N columns and depth K, for every
    n and k of the padded tiles."""
    kt = -(-K // tg.BK)
    n, k, p = np.meshgrid(np.arange(-(-N // tg.PRE_BN) * tg.PRE_BN), np.arange(kt * tg.BK), np.arange(2),
                          indexing="ij")
    tile = (n // tg.PRE_BN) * kt + k // tg.BK
    r, kk = n % tg.PRE_BN, k % tg.BK
    core = (r // 8) * 256 + (kk // 4) * 32 + (r % 8) * 4 + kk % 4  # within the tile's hi or lo part
    return n, k, p, (2 * tile + p) * tg.PRE_BN * tg.BK + core


@pytest.mark.parametrize("rows,cols", PRESPLIT_SHAPES, ids=["34to256", "256to256"])
def test_presplit_plain_layout(rng, rows, cols):
    """The plain pre-split of W [rows, cols], for the forward (B(k, n) =
    W[n, k]) and the dz product (B(k, n) = W[k, n]): every float of the
    buffer is one (n, k, part) of the layout formula, hi is tf32(B), hi + lo
    keeps B to 2^-22 of its size, zeros past the edges."""
    w = (rng.randn(rows, cols) * 10.0 ** rng.randint(-3, 3, (rows, cols))).astype(np.float32)
    for buf, bt in zip(tg.presplit_reference(torch.from_numpy(w)), (w, w.T)):
        buf = buf.numpy()
        N, K = bt.shape
        n, k, p, off = presplit_offsets(N, K)
        assert buf.shape == (tg.presplit_floats(N, K),)
        assert np.array_equal(np.sort(off.ravel()), np.arange(buf.size))  # a permutation
        inside = (n < N) & (k < K)
        x = np.where(inside[..., 0], bt[np.minimum(n[..., 0], N - 1), np.minimum(k[..., 0], K - 1)], np.float32(0))
        hi, lo = buf[off[..., 0]], buf[off[..., 1]]
        assert np.array_equal(hi.view(np.uint32), tf32(x).view(np.uint32))
        assert np.array_equal(lo.view(np.uint32), tf32(x - hi).view(np.uint32))
        assert np.all(hi.view(np.uint32) & 0x1FFF == 0) and np.all(lo.view(np.uint32) & 0x1FFF == 0)
        x64 = x.astype(np.float64)
        assert np.all(np.abs(hi.astype(np.float64) + lo - x64) <= 2.0**-22 * np.abs(x64))
        assert not buf[off[..., 0][~inside[..., 0]]].any() and not buf[off[..., 1][~inside[..., 0]]].any()


def presplit_bf16_offsets(N: int, K: int):
    """The bf16 core-matrix layout, written out: the bf16 offset of (n, k) in
    a pre-converted B of N columns and depth K, for every n and k of the
    padded tiles (64 x 64, 8 x 8 core matrices of 128 bytes, K-major)."""
    kt = -(-K // tg.BK_BF16)
    n, k = np.meshgrid(np.arange(-(-N // tg.PRE_BN) * tg.PRE_BN), np.arange(kt * tg.BK_BF16), indexing="ij")
    tile = (n // tg.PRE_BN) * kt + k // tg.BK_BF16
    r, kk = n % tg.PRE_BN, k % tg.BK_BF16
    return n, k, tile * tg.PRE_BN * tg.BK_BF16 + (r // 8) * 512 + (kk // 8) * 64 + (r % 8) * 8 + kk % 8


@pytest.mark.parametrize("rows,cols", PRESPLIT_SHAPES, ids=["34to256", "256to256"])
def test_presplit_bf16_plain_layout(rng, rows, cols):
    """The bf16 engine's plain weight conversion of W [rows, cols], for the
    forward and the dz product: every bf16 of the buffer is one (n, k) of
    the layout formula, bf16(B) rounded to nearest even, zeros past the
    edges."""
    w = (rng.randn(rows, cols) * 10.0 ** rng.randint(-3, 3, (rows, cols))).astype(np.float32)
    for buf, bt in zip(tg.presplit_bf16_reference(torch.from_numpy(w)), (w, w.T)):
        N, K = bt.shape
        assert buf.dtype == torch.float32 and buf.shape == (tg.presplit_bf16_floats(N, K),)
        vals = buf.view(torch.bfloat16).float().numpy()
        n, k, off = presplit_bf16_offsets(N, K)
        assert np.array_equal(np.sort(off.ravel()), np.arange(vals.size))  # a permutation
        inside = (n < N) & (k < K)
        x = torch.from_numpy(np.where(inside, bt[np.minimum(n, N - 1), np.minimum(k, K - 1)], np.float32(0)))
        assert np.array_equal(vals[off], x.to(torch.bfloat16).float().numpy())
        assert not vals[off[~inside]].any()


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
def test_presplit_table_plain_layout(rng, bf16):
    """The plain version of the pre-split of a table of weights of mixed
    shapes (a mask head's hidden layers beside an rgb layer and a ragged
    one): each entry's buffers are that weight's own plain pre-split, whose
    layout the tests above hold to the formula, at that weight's sizes."""
    shapes = [(256, 256)] * 3 + [(256, 34), (130, 77)]
    ws = [torch.from_numpy(rng.randn(r, c).astype(np.float32)) for r, c in shapes]
    out = tg.presplit_table(ws, bf16=bf16)
    ref, floats = ((tg.presplit_bf16_reference, tg.presplit_bf16_floats) if bf16
                   else (tg.presplit_reference, tg.presplit_floats))
    assert len(out) == len(ws)
    for (fwd, dz), w in zip(out, ws):
        assert fwd.shape == (floats(*w.shape),) and dz.shape == (floats(*w.shape[::-1]),)
        for o, r in zip((fwd, dz), ref(w)):
            assert torch.equal(o.view(torch.int32), r.view(torch.int32))


def test_port_tf32_matches_emulation(rng):
    edges = [1.0 + 2.0**-11, -(1.0 + 2.0**-11), 0.0, -0.0, 3e38, -3e38]
    x = np.concatenate([rng.randn(4096), edges]).astype(np.float32)
    assert np.array_equal(tg.tf32(torch.from_numpy(x)).numpy().view(np.uint32), tf32(x).view(np.uint32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (on the card: python -m pytest tests/test_torch_tc_gemm.py -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _operands(rng, layout, M, N, K, device, offset=0):
    """A and B as the layout lays them out, from views `offset` floats into
    wider rows when offset > 0 (misaligned pointers and row strides)."""
    a_k, b_n = tg.LAYOUTS[layout]
    shape_a = (M, K) if a_k else (K, M)
    shape_b = (K, N) if b_n else (N, K)
    wide = lambda s: torch.from_numpy(rng.randn(s[0], s[1] + offset).astype(np.float32)).to(device)[:, offset:]
    return wide(shape_a), wide(shape_b)


def _check(out, ref, ref64, floor=1e-6):
    err, err64, plain64 = (rel(out.cpu().numpy(), ref.cpu().double().numpy()), rel(out.cpu().numpy(), ref64),
                           rel(ref.cpu().numpy(), ref64))
    assert err <= 1e-5, err
    assert err64 <= max(2.0 * plain64, floor), (err64, plain64)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["store", "bias_relu", "gate"])
@pytest.mark.parametrize("layout", sorted(tg.LAYOUTS))
def test_tc_gemm_matches_plain_on_card(rng, cuda_device, layout, epilogue):
    """Every layout and epilogue at ragged M, N, K (no multiple of any tile):
    within 1e-5 of the plain float32 version, within twice its error of
    float64, bitwise-equal relaunch."""
    M, N, K = 1537, 203, 61
    a, b = _operands(rng, layout, M, N, K, cuda_device)
    kw = {}
    if epilogue == "bias_relu":
        kw["bias"] = torch.from_numpy(rng.randn(N).astype(np.float32)).to(cuda_device)
    if epilogue == "gate":
        kw["gate"] = torch.from_numpy(rng.randn(M, N).astype(np.float32)).to(cuda_device)
    before = LAUNCHES["tc_gemm"]
    out, out2 = tg.tc_gemm(a, b, layout, epilogue, **kw), tg.tc_gemm(a, b, layout, epilogue, **kw)
    ref = tg.tc_gemm_reference(a, b, layout, epilogue, **kw)
    ref64 = tg.tc_gemm_reference(a.double(), b.double(), layout, epilogue,
                                 **{k: v.double() for k, v in kw.items()}).cpu().numpy()
    torch.cuda.synchronize()
    assert LAUNCHES["tc_gemm"] == before + 2
    _check(out, ref, ref64)
    assert torch.equal(out, out2)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 32, 256, 257])
@pytest.mark.parametrize("layout", ["mk,kn", "mk,nk"])
def test_tc_gemm_depths_on_card(rng, cuda_device, layout, K):
    """The forward and dz layouts (A K-major) at depths of part of one
    32-deep k-tile, one whole, the hidden layers' eight and a ragged ninth,
    with the ReLU gate: against the plain version and float64, bitwise-equal
    relaunch."""
    M, N = 1537, 130
    a, b = _operands(rng, layout, M, N, K, cuda_device)
    gate = torch.from_numpy(rng.randn(M, N).astype(np.float32)).to(cuda_device)
    out, out2 = tg.tc_gemm(a, b, layout, "gate", gate=gate), tg.tc_gemm(a, b, layout, "gate", gate=gate)
    ref = tg.tc_gemm_reference(a, b, layout, "gate", gate=gate)
    ref64 = tg.tc_gemm_reference(a.double(), b.double(), layout, "gate", gate=gate.double()).cpu().numpy()
    torch.cuda.synchronize()
    _check(out, ref, ref64)
    assert torch.equal(out, out2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["km,kn", "km,nk"])
def test_tc_gemm_split_k_and_row_sums_on_card(rng, cuda_device, layout):
    """The dW products' form: K = 4,099 points split 9 ways, the fixed-order
    sum, and the folded row sums of A (db) against A's sums."""
    M, N, K = 256, 57, 4099
    a, b = _operands(rng, layout, M, N, K, cuda_device)
    out, rs = tg.tc_gemm(a, b, layout, splits=9, rowsum=True)
    out2, rs2 = tg.tc_gemm(a, b, layout, splits=9, rowsum=True)
    ref, rs_ref = tg.tc_gemm_reference(a, b, layout, rowsum=True)
    ref64, rs64 = tg.tc_gemm_reference(a.double(), b.double(), layout, rowsum=True)
    torch.cuda.synchronize()
    _check(out, ref, ref64.cpu().numpy())
    _check(rs, rs_ref, rs64.cpu().numpy())
    assert torch.equal(out, out2) and torch.equal(rs, rs2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(tg.LAYOUTS))
def test_tc_gemm_misaligned_views_on_card(rng, cuda_device, layout):
    """Views one float into wider rows (pointers and row strides not 16-byte
    aligned) take the 4-byte copies and give the same products."""
    M, N, K = 300, 130, 77
    a, b = _operands(rng, layout, M, N, K, cuda_device, offset=1)
    out = tg.tc_gemm(a, b, layout)
    ref = tg.tc_gemm_reference(a, b, layout)
    ref64 = tg.tc_gemm_reference(a.double(), b.double(), layout).cpu().numpy()
    torch.cuda.synchronize()
    _check(out, ref, ref64)


@pytest.mark.cuda
def test_tc_gemm_at_k6_dw_split_on_card(rng, cuda_device):
    """K6's 256-wide dW product at its real split (43,200 points of K6-like
    operands, 7,200 a split, a partial per 2,048) with the folded row sums:
    within twice the plain version's distance from float64, no floor."""
    dz, x = (torch.from_numpy(t).to(cuda_device) for t in k6_operands(rng))
    out, rs = tg.tc_gemm(dz, x, "km,kn", splits=K6_POINTS // K6_CHUNK, rowsum=True)
    out2, rs2 = tg.tc_gemm(dz, x, "km,kn", splits=K6_POINTS // K6_CHUNK, rowsum=True)
    ref, rs_ref = tg.tc_gemm_reference(dz, x, "km,kn", rowsum=True)
    ref64, rs64 = tg.tc_gemm_reference(dz.double(), x.double(), "km,kn", rowsum=True)
    torch.cuda.synchronize()
    _check(out, ref, ref64.cpu().numpy(), floor=0.0)
    _check(rs, rs_ref, rs64.cpu().numpy(), floor=0.0)
    assert torch.equal(out, out2) and torch.equal(rs, rs2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", PRESPLIT_SHAPES, ids=["34to256", "256to256"])
def test_presplit_matches_plain_on_card(rng, cuda_device, rows, cols):
    """The pre-split kernel's buffers, for W and W^T, bitwise equal to the
    plain version's."""
    w = torch.from_numpy(rng.randn(rows, cols).astype(np.float32)).to(cuda_device)
    before = LAUNCHES["tc_presplit"]
    out = tg.presplit(w)
    ref = tg.presplit_reference(w)
    torch.cuda.synchronize()
    assert LAUNCHES["tc_presplit"] == before + 1
    for o, r in zip(out, ref):
        assert torch.equal(o.view(torch.int32), r.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
def test_presplit_table_matches_plain_on_card(rng, cuda_device, bf16):
    """The pre-split of a table of weights in one launch, as the per-image
    mask heads pre-split theirs (5 heads x 3 hidden layers of 256 x 256),
    and a table of mixed shapes: each entry's buffers, for W and W^T,
    bitwise equal to that weight's plain pre-split."""
    ref = tg.presplit_bf16_reference if bf16 else tg.presplit_reference
    key = "tc_presplit_bf16" if bf16 else "tc_presplit"
    for shapes in ([(256, 256)] * 15, [(256, 256), (256, 34), (130, 77), (3, 256)]):
        ws = [torch.from_numpy(rng.randn(r, c).astype(np.float32)).to(cuda_device) for r, c in shapes]
        before = LAUNCHES[key]
        out = tg.presplit_table(ws, bf16=bf16)
        torch.cuda.synchronize()
        assert LAUNCHES[key] == before + 1
        for (fwd, dz), w in zip(out, ws):
            for o, r in zip((fwd, dz), ref(w)):
                assert torch.equal(o.view(torch.int32), r.view(torch.int32))


# (points, groups) of the pre-split products: the rgb pipeline's and the
# shared head's at one group or two, and the per-image heads' five groups of
# 43,200 columns and of a ragged 8,641
PRESPLIT_M_GROUPS = [(M, g) for M in (1537, 44573, 216000) for g in (1, 2)] + [(43200, 5), (8641, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,groups", PRESPLIT_M_GROUPS, ids=[f"M{M}-groups{g}" for M, g in PRESPLIT_M_GROUPS])
@pytest.mark.parametrize("rows,cols", PRESPLIT_SHAPES, ids=["34to256", "256to256"])
@pytest.mark.parametrize("layout,epilogue", [("mk,nk", "bias_relu"), ("mk,kn", "gate"), ("mk,kn", "store")],
                         ids=["forward", "dz_gated", "dz_store"])
def test_tc_gemm_presplit_on_card(rng, cuda_device, rows, cols, layout, epilogue, M, groups):
    """The forward and dz products with the weight W [rows, cols] pre-split
    and streamed by bulk copies, on the warp-specialised kernel: at M =
    1,537 points (fewer tiles than blocks), the shared head's ragged dedup
    column count 44,573 and the main path's 216,000 (every block walks many
    tiles, both consumers, the ring's phases wrapping), N and K of 256 and
    34, one group or two in one launch; and the per-image mask heads' own
    grouped products, five groups of 43,200 columns (26 blocks a group) and
    of a ragged 8,641: within 1e-5 of the plain version, within twice its
    error of float64, bitwise equal to a relaunch and to the same product
    with B split in shared memory."""
    w = torch.from_numpy(rng.randn(groups, rows, cols).astype(np.float32)).to(cuda_device)
    N, K = (rows, cols) if layout == "mk,nk" else (cols, rows)
    a = torch.from_numpy(rng.randn(groups, M, K).astype(np.float32)).to(cuda_device)
    kw = {}
    if epilogue == "bias_relu":
        kw["bias"] = torch.from_numpy(rng.randn(groups, N).astype(np.float32)).to(cuda_device)
    if epilogue == "gate":
        kw["gate"] = torch.from_numpy(rng.randn(groups, M, N).astype(np.float32)).to(cuda_device)
    if groups == 1:
        one = {k: v[0] for k, v in kw.items()}
        run = lambda: tg.tc_gemm(a[0], w[0], layout, epilogue, presplit_b=True, **one)[None]
    else:
        run = lambda: tg.tc_gemm_groups(a, w, layout, epilogue, **kw)
    out, out2 = run(), run()
    for g in range(groups):
        one = {k: v[g] for k, v in kw.items()}
        streamed = tg.tc_gemm(a[g], w[g], layout, epilogue, **one)
        ref = tg.tc_gemm_reference(a[g], w[g], layout, epilogue, **one)
        ref64 = tg.tc_gemm_reference(a[g].double(), w[g].double(), layout, epilogue,
                                     **{k: v.double() for k, v in one.items()}).cpu().numpy()
        torch.cuda.synchronize()
        _check(out[g], ref, ref64)
        assert torch.equal(out[g], streamed)
    assert torch.equal(out, out2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,epilogue", [("mk,nk", "bias_relu"), ("mk,kn", "gate"), ("mk,kn", "store")],
                         ids=["forward", "dz_gated", "dz_store"])
def test_tc_gemm_presplit_misaligned_on_card(rng, cuda_device, layout, epilogue):
    """The pre-split kernel's 4-byte copies of A: a view one float into
    wider rows (odd row stride, pointer off 16 bytes), ragged K (zeros past
    it) and N (a 128-wide tile over one pre-split tile and part of another):
    within 1e-5 of the plain version, within twice its error of float64,
    bitwise equal to the same product with B split in shared memory."""
    M, rows, cols = 1537, 130, 77
    w = torch.from_numpy(rng.randn(rows, cols).astype(np.float32)).to(cuda_device)
    N, K = (rows, cols) if layout == "mk,nk" else (cols, rows)
    a = _operands(rng, "mk,nk", M, N, K, cuda_device, offset=1)[0]
    kw = {}
    if epilogue == "bias_relu":
        kw["bias"] = torch.from_numpy(rng.randn(N).astype(np.float32)).to(cuda_device)
    if epilogue == "gate":
        kw["gate"] = torch.from_numpy(rng.randn(M, N).astype(np.float32)).to(cuda_device)
    out = tg.tc_gemm(a, w, layout, epilogue, presplit_b=True, **kw)
    streamed = tg.tc_gemm(a, w, layout, epilogue, **kw)
    ref = tg.tc_gemm_reference(a, w, layout, epilogue, **kw)
    ref64 = tg.tc_gemm_reference(a.double(), w.double(), layout, epilogue,
                                 **{k: v.double() for k, v in kw.items()}).cpu().numpy()
    torch.cuda.synchronize()
    _check(out, ref, ref64)
    assert torch.equal(out, streamed)


# ---- the bf16 engine on a card. bf16 operands are given as views whose rows
# start on 16 bytes (a row stride that is a multiple of 8, as the kernels
# lay their operands out). A float32 output (the store epilogue) is held as
# the 3xTF32 engine's (_check): the products are exact, only the sums'
# order differs. A bf16 output (bias + ReLU, gate) is held element by
# element to the plain version's bf16 or a neighbour of it: the two float32
# sums may round to either side of a bf16 rounding boundary.


def _bf16_view(x: np.ndarray, device) -> torch.Tensor:
    """x [r, c] as a bf16 view of rows padded to a multiple of 8."""
    r, c = x.shape
    buf = torch.zeros(r, -(-c // 8) * 8, dtype=torch.bfloat16, device=device)
    buf[:, :c] = torch.from_numpy(x.astype(np.float32)).to(device)
    return buf[:, :c]


def _bf16_operands(rng, layout, M, N, K, device):
    a_k, b_n = tg.LAYOUTS[layout]
    return (_bf16_view(rng.randn(*((M, K) if a_k else (K, M))), device),
            _bf16_view(rng.randn(*((K, N) if b_n else (N, K))), device))


def _check_bf16(out, ref, ref64):
    if out.dtype == torch.float32:
        return _check(out, ref, ref64)
    assert out.dtype == torch.bfloat16 and ref.dtype == torch.bfloat16
    o, r = out.float().cpu().numpy(), ref.float().cpu().numpy()
    assert np.all(np.abs(o - r) <= 2.0**-7 * np.abs(r) + 1e-6 * np.abs(r).max()), np.abs(o - r).max()


def _bf16_case(rng, layout, epilogue, M, N, K, device):
    a, b = _bf16_operands(rng, layout, M, N, K, device)
    kw = {}
    if epilogue == "bias_relu":
        kw["bias"] = torch.from_numpy(rng.randn(N).astype(np.float32)).to(device)
    if epilogue == "gate":
        kw["gate"] = torch.from_numpy(rng.randn(M, N).astype(np.float32)).to(device).to(torch.bfloat16)
    out, out2 = tg.tc_gemm(a, b, layout, epilogue, **kw), tg.tc_gemm(a, b, layout, epilogue, **kw)
    ref = tg.tc_gemm_reference(a, b, layout, epilogue, **kw)
    ref64 = tg.tc_gemm_reference(a.double(), b.double(), layout, epilogue,
                                 **{k: v.double() for k, v in kw.items()}).cpu().numpy()
    torch.cuda.synchronize()
    _check_bf16(out, ref, ref64)
    assert torch.equal(out, out2)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["store", "bias_relu", "gate"])
@pytest.mark.parametrize("layout", sorted(tg.LAYOUTS))
def test_bf16_gemm_matches_plain_on_card(rng, cuda_device, layout, epilogue):
    """The bf16 engine, every layout and epilogue at ragged M, N, K (a
    multiple of no tile): as held above, bitwise-equal relaunch, counted as
    the bf16 engine's launches."""
    before = dict(LAUNCHES)
    _bf16_case(rng, layout, epilogue, 1544, 200, 72, cuda_device)
    assert LAUNCHES["tc_gemm_bf16"] == before["tc_gemm_bf16"] + 2 and LAUNCHES["tc_gemm"] == before["tc_gemm"]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 64, 256, 264])
@pytest.mark.parametrize("layout", ["mk,kn", "mk,nk", "km,nk"])
def test_bf16_gemm_depths_on_card(rng, cuda_device, layout, K):
    """The forward and dz layouts, and the mask head's first layer, at
    depths of part of one 64-deep k-tile, one whole, the hidden layers' four
    and a ragged fifth, with the ReLU gate."""
    _bf16_case(rng, layout, "gate", 1544, 136, K, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["km,kn", "km,nk"])
def test_bf16_gemm_split_k_and_row_sums_on_card(rng, cuda_device, layout):
    """The dW products' form in bf16: K = 4,104 points split 9 ways (a
    partial per 2,048 points of a split), the fixed-order sum, and the
    folded row sums of A (db)."""
    M, N, K = 256, 56, 4104
    a, b = _bf16_operands(rng, layout, M, N, K, cuda_device)
    out, rs = tg.tc_gemm(a, b, layout, splits=9, rowsum=True)
    out2, rs2 = tg.tc_gemm(a, b, layout, splits=9, rowsum=True)
    ref, rs_ref = tg.tc_gemm_reference(a, b, layout, rowsum=True)
    ref64, rs64 = tg.tc_gemm_reference(a.double(), b.double(), layout, rowsum=True)
    torch.cuda.synchronize()
    _check(out, ref, ref64.cpu().numpy())
    _check(rs, rs_ref, rs64.cpu().numpy())
    assert torch.equal(out, out2) and torch.equal(rs, rs2)


@pytest.mark.cuda
def test_bf16_gemm_refuses_unaligned_rows(rng, cuda_device):
    """A bf16 operand whose rows do not start on 16 bytes is refused (the
    engine copies 16 bytes at a time), not read wrong."""
    a = torch.zeros(64, 30, dtype=torch.bfloat16, device=cuda_device)
    b = torch.zeros(30, 64, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        tg.tc_gemm(a, b, "mk,kn")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", PRESPLIT_SHAPES, ids=["34to256", "256to256"])
def test_presplit_bf16_matches_plain_on_card(rng, cuda_device, rows, cols):
    """The bf16 weight conversion's buffers, for W and W^T, bitwise equal to
    the plain version's."""
    w = torch.from_numpy(rng.randn(rows, cols).astype(np.float32)).to(cuda_device)
    before = LAUNCHES["tc_presplit_bf16"]
    out = tg.presplit_bf16(w)
    ref = tg.presplit_bf16_reference(w)
    torch.cuda.synchronize()
    assert LAUNCHES["tc_presplit_bf16"] == before + 1
    for o, r in zip(out, ref):
        assert torch.equal(o.view(torch.int32), r.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", PRESPLIT_SHAPES, ids=["34to256", "256to256"])
@pytest.mark.parametrize("layout,epilogue", [("mk,nk", "bias_relu"), ("mk,kn", "gate"), ("mk,kn", "store")],
                         ids=["forward", "dz_gated", "dz_store"])
def test_bf16_gemm_presplit_on_card(rng, cuda_device, rows, cols, layout, epilogue):
    """The forward and dz products in bf16 with the float32 weight W [rows,
    cols] converted once and streamed by bulk copies (M = 1,537): as held
    above, and bitwise equal to the same product with bf16(W) streamed by
    cp.async."""
    M = 1537
    w = torch.from_numpy(rng.randn(rows, cols).astype(np.float32)).to(cuda_device)
    N, K = (rows, cols) if layout == "mk,nk" else (cols, rows)
    a = _bf16_view(rng.randn(M, K), cuda_device)
    kw = {}
    if epilogue == "bias_relu":
        kw["bias"] = torch.from_numpy(rng.randn(N).astype(np.float32)).to(cuda_device)
    if epilogue == "gate":
        kw["gate"] = torch.from_numpy(rng.randn(M, N).astype(np.float32)).to(cuda_device).to(torch.bfloat16)
    out = tg.tc_gemm(a, w, layout, epilogue, presplit_b=True, **kw)
    streamed = tg.tc_gemm(a, _bf16_view(w.cpu().numpy(), cuda_device), layout, epilogue, **kw)
    ref = tg.tc_gemm_reference(a, w, layout, epilogue, **kw)
    ref64 = tg.tc_gemm_reference(a.double(), w.to(torch.bfloat16).double(), layout, epilogue,
                                 **{k: v.double() for k, v in kw.items()}).cpu().numpy()
    torch.cuda.synchronize()
    _check_bf16(out, ref, ref64)
    assert torch.equal(out, streamed)
