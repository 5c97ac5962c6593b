// The factored implicit-mask head's building blocks for Hopper (sm_90a),
// shared by fused_mask.cu (K3, K4, K6) and fused_implicit.cu (K5), every
// product on a tensor-core engine (tc_gemm.cuh) and grouped over heads.
// T is the storage type of the activations: float32 on the 3xTF32 engine,
// or bf16 on the bf16 engine (compute_dtype = bfloat16; K3-K6), which
// rounds where the Pallas kernels' cdtype does (marf_tpu/ops/pallas/
// fused_mask.py _mask_fwd_tile, _mask_bwd_dedup_kernel, _mask_bwd_g_kernel):
// X and every hidden activation stored in bf16 (X converted once per
// call, each head's block on its own 16-byte boundary), every weight read
// as bf16, the cotangent through the sigmoid and each ReLU-gated dz
// rounded to bf16; the bias, the cotangent's own arithmetic and every sum
// float32. One call runs `nh` heads (nh <=
// MAX_GROUP), head h on the column block [h HW, (h+1) HW) of X, each GEMM
// launch covering every head's block (the per-head operands in the
// GemmCall's pointer tables):
//   - hidden_forward: the hidden layers' GEMMs over X [56, ldx] read in place
//     (X points at head 0's block, rows are ldx apart), with the weights of
//     every head's hidden layers 1.. pre-split once per call, in one launch
//     (split into TF32 hi and lo in float32, converted to bf16 tiles in
//     bf16), for their forward and dz products on the engine's pre-split
//     kernel;
//   - mask_head_fwd_kernel: the 256 -> 1 sigmoid layer, one warp per column;
//   - mask_backward: forward recompute, the head pass with the in-kernel
//     cotangent (a functor: DedupCot for K4, ColumnCot for K6) and the
//     backward chain into dW/db of every effective layer.
// Layouts: weights are nn.Linear's [out, in], row-major, in head-major
// tables W[h * n_layers + l]; X is channels-first; activations are
// point-major [nh HW, width], head h's block at row h HW.

#pragma once

#include "tc_gemm.cuh"

namespace {

// m[h HW + p] = sigmoid(W_h X[h HW + p] + b_h) for the last layer (F -> 1),
// one warp per point, head h = blockIdx.y; W read as T.
template <class T>
__global__ void __launch_bounds__(ELEM_THREADS)
mask_head_fwd_kernel(int K, int F, const T* __restrict__ X, GroupConstPtrs W, GroupConstPtrs bias,
                     float* __restrict__ m) {
  __shared__ float Ws[HEAD_MAX_K];
  const int h = blockIdx.y;
  const float* __restrict__ Wh = pick(W, h);
  for (int i = threadIdx.x; i < F; i += ELEM_THREADS) Ws[i] = round_to<T>(Wh[i]);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * HEAD_POINTS + threadIdx.x / 32;
  if (p >= K) return;
  const long long q = (long long)h * K + p;
  const float z = row_dot(X + q * F, Ws, F, lane);
  if (lane == 0) m[q] = sigmoidf_(z + pick(bias, h)[0]);
}

// K4's cotangent of column p: g = seg m + kk cnt[p] with
//   seg = a sum_b s0map[b,p] sq[b,p] + b sum_b s0map[b,p] esq[b,p] + base[p]
// (the slot0 segment sums, a fixed-order loop over b, exist only for p < HW:
// the extras carry theirs in base). abk = (a, b, kk) on the device.
struct DedupCot {
  int HW, B;
  const float *s0map, *sq, *esq, *base, *cnt, *abk;
  __device__ float operator()(int p, float m) const {
    float seg = base[p];
    if (p < HW) {
      float s = 0.0f;
      for (int b = 0; b < B; ++b) s += s0map[(long long)b * HW + p] * sq[(long long)b * HW + p];
      seg = abk[0] * s + seg;
      if (esq) {
        float se = 0.0f;
        for (int b = 0; b < B; ++b) se += s0map[(long long)b * HW + p] * esq[(long long)b * HW + p];
        seg += abk[1] * se;
      }
    }
    return seg * m + abk[2] * cnt[p];
  }
};

// K6's cotangent of column p, all per column: g = (a sq + b esq + c n) m + k n
// with n = cnt[p] (1 when cnt is null); esq null drops its term.
// abk = (a, b, k) on the device, c on the host.
struct ColumnCot {
  const float *sq, *esq, *cnt, *abk;
  float c;
  __device__ float operator()(int p, float m) const {
    const float n = cnt ? cnt[p] : 1.0f;
    float s = abk[0] * sq[p];
    if (esq) s += abk[1] * esq[p];
    return (s + c * n) * m + abk[2] * n;
  }
};

// The last layer's backward with the in-kernel cotangent, per chunk of
// columns of head h = blockIdx.y (one warp per column, tiles of
// HEAD_POINTS); q = h K + p is the column's index across the heads:
//   m = sigmoid(W_h X[q] + b_h) (bitwise as mask_head_fwd_kernel);
//   d = cot(q, m) m (1 - m);
//   dX[q, f] = d W_h[f] (X[q, f] > 0);
//   partial [dW (F) | db (1)] of head h = sum_p d X[q], sum_p d.
// With T = bf16, W is read as bf16 and d and dX are rounded to bf16.
template <class T, class Cot>
__global__ void __launch_bounds__(ELEM_THREADS)
mask_head_bwd_kernel(int K, int F, int chunk, const T* __restrict__ X, GroupConstPtrs W, GroupConstPtrs bias,
                     Cot cot, T* __restrict__ dX, float* __restrict__ part, int part_stride,
                     long long part_gstride) {
  __shared__ float Ws[HEAD_MAX_K];
  __shared__ float ds[HEAD_POINTS];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wid = tid / 32;
  const int h = blockIdx.y;
  const float* __restrict__ Wh = pick(W, h);
  for (int i = tid; i < F; i += ELEM_THREADS) Ws[i] = round_to<T>(Wh[i]);
  const float b0 = pick(bias, h)[0];
  const long long q0 = (long long)h * K;
  X += q0 * F;
  dX += q0 * F;
  const int p_begin = blockIdx.x * chunk;
  const int p_end = min(K, p_begin + chunk);

  constexpr int MAXJ = HEAD_MAX_K / ELEM_THREADS;
  float acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) acc[j] = 0.0f;
  float dbias = 0.0f;
  __syncthreads();

  for (int t0 = p_begin; t0 < p_end; t0 += HEAD_POINTS) {
    const int p = t0 + wid;
    if (p < p_end) {
      const float z = row_dot(X + (long long)p * F, Ws, F, lane);
      if (lane == 0) {
        const float m = sigmoidf_(z + b0);
        ds[wid] = round_to<T>(cot(q0 + p, m) * m * (1.0f - m));
      }
    } else if (lane == 0) {
      ds[wid] = 0.0f;
    }
    __syncthreads();
    // backward into the last hidden layer: one thread per feature
    const int np = min(HEAD_POINTS, p_end - t0);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int f = tid + j * ELEM_THREADS;
      if (f < F) {
        const float w = Ws[f];
        for (int q = 0; q < np; ++q) {
          const long long idx = (long long)(t0 + q) * F + f;
          const float xv = to_f(X[idx]);
          dX[idx] = from_f<T>(xv > 0.0f ? ds[q] * w : 0.0f);
          acc[j] = fmaf(xv, ds[q], acc[j]);
        }
      }
    }
    if (tid == 0) {
      for (int q = 0; q < np; ++q) dbias += ds[q];
    }
    __syncthreads();
  }

  float* out = part + h * part_gstride + (long long)blockIdx.x * part_stride;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int f = tid + j * ELEM_THREADS;
    if (f < F) out[f] = acc[j];
  }
  if (tid == 0) out[F] = dbias;
}

// Offsets (floats) into the workspace of one call on nh heads of HW columns;
// dw_gs, col_gs, head_gs: one head's share of dw_part, col_part, head_part.
// wsplit[h][l] holds head h's hidden layer l (l >= 1) as the pre-split B of
// its forward [0] and dz [1] products. In bf16, xb holds X
// [dims[0], ldxb] converted to bf16, head h's columns from h xhs on (xhs =
// round8(HW), so every head's block starts on 16 bytes whatever HW), and
// w0b each head's first-layer W [dims[1], ldw0b], rows padded to 16 bytes,
// head h's from h w0hs on (xhs, w0hs in bf16 values).
struct MaskPlan {
  int nh, HW, head_blocks, head_chunk, head_stride, ldxb, xhs, ldw0b;
  long long acts[MAX_LAYERS], dz[2], dw_part, col_part, head_part, dw_gs, col_gs, head_gs, xb, w0b, w0hs, total;
  long long wsplit[MAX_GROUP][MAX_LAYERS][2];
};

// dims[0..n_layers]: effective layer widths, dims[0] = X rows, dims[n_layers]
// = 1. col_part holds the db partials, the folded row sums per head and
// partial. T: the activations' storage type.
template <class T>
MaskPlan make_mask_plan(int HW, int nh, int n_layers, const int* dims, bool backward) {
  using Eng = typename EngineOf<T>::type;
  constexpr bool BF16 = sizeof(T) == 2;
  MaskPlan P{};
  P.nh = nh;
  P.HW = HW;
  Arena a;
  const long long cols = (long long)nh * HW;
  int widest = 1;
  for (int l = 0; l + 1 < n_layers; ++l) {
    P.acts[l] = a.take_of<T>(cols * dims[l + 1]);
    widest = dims[l + 1] > widest ? dims[l + 1] : widest;
  }
  for (int h = 0; h < nh; ++h) {
    for (int l = 1; l + 1 < n_layers; ++l) {
      P.wsplit[h][l][0] = a.take(Eng::weight_floats(dims[l + 1], dims[l]));
      P.wsplit[h][l][1] = a.take(Eng::weight_floats(dims[l], dims[l + 1]));
    }
  }
  if (BF16) {
    P.xhs = round8(HW);
    P.ldxb = nh * P.xhs;
    P.ldw0b = round8(dims[0]);
    P.w0hs = (long long)dims[1] * P.ldw0b;
    P.xb = a.take_of<T>((long long)dims[0] * P.ldxb);
    P.w0b = a.take_of<T>(nh * P.w0hs);
  }
  if (backward) {
    P.dz[0] = a.take_of<T>(cols * widest);
    P.dz[1] = a.take_of<T>(cols * widest);
    long long dw_max = 0, db_max = 0;
    for (int l = 0; l + 1 < n_layers; ++l) {
      int splits, chunk;
      Eng::dw_split(HW, dims[l + 1], dims[l], nh, splits, chunk);
      const long long parts = Eng::dw_parts(splits, chunk);
      const long long n = parts * dims[l + 1] * dims[l];
      dw_max = n > dw_max ? n : dw_max;
      db_max = parts * dims[l + 1] > db_max ? parts * dims[l + 1] : db_max;
    }
    P.dw_gs = (dw_max + 3) / 4 * 4;
    P.dw_part = a.take(nh * P.dw_gs);
    P.col_gs = (db_max + 3) / 4 * 4;
    P.col_part = a.take(nh * P.col_gs);
    P.head_blocks = cdiv(HW, 64) < 1024 ? cdiv(HW, 64) : 1024;
    P.head_chunk = cdiv(cdiv(HW, P.head_blocks), HEAD_POINTS) * HEAD_POINTS;
    P.head_blocks = cdiv(HW, P.head_chunk);
    P.head_stride = dims[n_layers - 1] + 4;
    P.head_gs = (long long)P.head_blocks * P.head_stride;
    P.head_part = a.take(nh * P.head_gs);
  }
  P.total = a.off;
  return P;
}

bool valid_mask_dims(int K, int n_layers, const int* dims) {
  return K >= 1 && n_layers >= 2 && n_layers <= MAX_LAYERS && dims[n_layers] == 1 &&
         dims[n_layers - 1] <= HEAD_MAX_K;
}

// Layer l's pointers of each head: W[h * n_layers + l] -> out.p[h]
template <class T, class Ptrs>
Ptrs layer_ptrs(int nh, int n_layers, int l, T* const* table) {
  Ptrs out{};
  for (int h = 0; h < nh; ++h) out.p[h] = table[h * n_layers + l];
  return out;
}

// Head h's activations of layer l (nh HW rows of dims[l + 1])
template <class T>
T* mask_act(const MaskPlan& P, float* ws, int l, const int* dims, int h) {
  return reinterpret_cast<T*>(ws + P.acts[l]) + (long long)h * P.HW * dims[l + 1];
}

// Head h's block of X as layer 0 reads it: float32 in place (rows ldx
// apart), or its bf16 copy in xb (rows P.ldxb apart)
template <class T>
const void* mask_x(const MaskPlan& P, float* ws, const float* X, int h) {
  if (sizeof(T) == 2) return reinterpret_cast<const bf16*>(ws + P.xb) + (long long)h * P.xhs;
  return X + (long long)h * P.HW;
}

// The hidden layers' forward on nh heads of HW columns: acts[l] =
// relu(W_h[l] x + b_h[l]), x = X (channels-first, rows ldx apart, head h at
// column h HW) for l = 0. The weights of every head's layers 1.. are first
// pre-split into wsplit, in one launch (a table of nh (n_layers - 2)
// weights; both orientations, so mask_backward's dz products read them
// too), and their products read B pre-split; layer 0 (A = X point-major)
// streams its B. In bf16, every head's block of X and its first layer's W
// are first converted into xb and w0b (one launch each), and layer 0 reads
// those; the bf16 pre-split converts the hidden weights to bf16 tiles, as
// the bf16 engine reads them.
template <class T>
int hidden_forward(cudaStream_t st, const MaskPlan& P, int ldx, int n_layers, const int* dims, const float* X,
                   const float* const* W, const float* const* bias, float* ws) {
  using Eng = typename EngineOf<T>::type;
  constexpr bool BF16 = sizeof(T) == 2;
  if (BF16) {
    GroupConstPtrs xs{}, w0s{};
    for (int h = 0; h < P.nh; ++h) xs.p[h] = X + (long long)h * P.HW, w0s.p[h] = W[h * n_layers];
    cast_bf16(st, P.nh, xs, dims[0], P.HW, ldx, reinterpret_cast<bf16*>(ws + P.xb), P.ldxb, P.xhs);
    MARF_CHECK_LAUNCH();
    cast_bf16(st, P.nh, w0s, dims[1], dims[0], dims[0], reinterpret_cast<bf16*>(ws + P.w0b), P.ldw0b, P.w0hs);
    MARF_CHECK_LAUNCH();
  }
  // one launch for every head's hidden weights (another per PRESPLIT_MAX more)
  PresplitTable t{};
  for (int h = 0; h < P.nh; ++h) {
    for (int l = 1; l + 1 < n_layers; ++l) {
      presplit_add(t, W[h * n_layers + l], dims[l + 1], dims[l], ws + P.wsplit[h][l][0], ws + P.wsplit[h][l][1]);
      if (t.n == PRESPLIT_MAX || (h + 1 == P.nh && l + 2 == n_layers)) {
        const int rc = Eng::presplit(st, t);
        if (rc) return rc;
        t.n = 0;
      }
    }
  }
  for (int l = 0; l + 1 < n_layers; ++l) {
    GemmCall c = gemm_call(P.HW, dims[l + 1], dims[l], nullptr, l == 0 ? (BF16 ? P.ldxb : ldx) : dims[l], nullptr,
                           l == 0 && BF16 ? P.ldw0b : dims[l], nullptr, dims[l + 1]);
    c.groups = P.nh;
    for (int h = 0; h < P.nh; ++h) {
      c.A[h] = l > 0 ? mask_act<T>(P, ws, l - 1, dims, h) : mask_x<T>(P, ws, X, h);
      if (l > 0) c.B[h] = ws + P.wsplit[h][l][0];
      else if (BF16) c.B[h] = reinterpret_cast<const bf16*>(ws + P.w0b) + h * P.w0hs;
      else c.B[h] = W[h * n_layers + l];
      c.C[h] = mask_act<T>(P, ws, l, dims, h);
      c.bias[h] = bias[h * n_layers + l];
    }
    const int rc = l == 0 ? Eng::template run<false, false, EPI_BIAS_RELU>(st, c)
                          : Eng::template run_presplit<EPI_BIAS_RELU>(st, c);
    if (rc) return rc;
  }
  return 0;
}

// The last layer's forward on the heads: m [nh HW] (head h at h HW).
template <class T>
int mask_head_forward(cudaStream_t st, const MaskPlan& P, int n_layers, const int* dims, const float* const* W,
                      const float* const* bias, float* ws, float* m) {
  const int last = n_layers - 1;
  mask_head_fwd_kernel<T><<<dim3(cdiv(P.HW, HEAD_POINTS), P.nh), ELEM_THREADS, 0, st>>>(
      P.HW, dims[last], mask_act<T>(P, ws, last - 1, dims, 0),
      layer_ptrs<const float, GroupConstPtrs>(P.nh, n_layers, last, W),
      layer_ptrs<const float, GroupConstPtrs>(P.nh, n_layers, last, bias), m);
  MARF_CHECK_LAUNCH();
  return 0;
}

// The heads' backward on nh heads of HW columns (X as in hidden_forward):
// the forward recompute, the head pass with the cotangent `cot` (indexed by
// the column across the heads, h HW + p), then dW/db of every layer
// through the hidden layers (ReLU-gated dX, B pre-split;
// split-K dW products with db folded in and a fixed-order sum; no dX for
// X). dW, db: head-major tables like W, bias.
template <class T, class Cot>
int mask_backward(cudaStream_t st, const MaskPlan& P, int ldx, int n_layers, const int* dims, const float* X,
                  const float* const* W, const float* const* bias, Cot cot, float* const* dW, float* const* db,
                  float* ws) {
  using Eng = typename EngineOf<T>::type;
  constexpr bool BF16 = sizeof(T) == 2;
  int rc = hidden_forward<T>(st, P, ldx, n_layers, dims, X, W, bias, ws);
  if (rc) return rc;
  const int nh = P.nh;
  const long long HW = P.HW;
  auto dz = [&](int i, int h, int width) { return reinterpret_cast<T*>(ws + P.dz[i]) + h * HW * width; };

  // ---- head: cotangent, dz of the last hidden layer, dW/db of the last layer
  const int last = n_layers - 1;
  const int F = dims[last];
  mask_head_bwd_kernel<T, Cot><<<dim3(P.head_blocks, nh), ELEM_THREADS, 0, st>>>(
      P.HW, F, P.head_chunk, mask_act<T>(P, ws, last - 1, dims, 0),
      layer_ptrs<const float, GroupConstPtrs>(nh, n_layers, last, W),
      layer_ptrs<const float, GroupConstPtrs>(nh, n_layers, last, bias), cot, dz(0, 0, F), ws + P.head_part,
      P.head_stride, P.head_gs);
  MARF_CHECK_LAUNCH();
  reduce_group(st, nh, P.head_blocks, F, P.head_stride, ws + P.head_part, P.head_gs,
               layer_ptrs<float, GroupPtrs>(nh, n_layers, last, dW));
  MARF_CHECK_LAUNCH();
  reduce_group(st, nh, P.head_blocks, 1, P.head_stride, ws + P.head_part + F, P.head_gs,
               layer_ptrs<float, GroupPtrs>(nh, n_layers, last, db));
  MARF_CHECK_LAUNCH();

  // ---- backward through the hidden layers
  int cur = 0;
  for (int l = last - 1; l >= 0; --l) {
    const int out = dims[l + 1], in = dims[l];
    // dW[l] = dz^T x_in, split over columns, then a fixed-order sum of the
    // partials; db, the row sums of dz, folded into the same product
    int splits, chunk;
    Eng::dw_split(P.HW, out, in, nh, splits, chunk);
    const int parts = Eng::dw_parts(splits, chunk);
    GemmCall c = gemm_call(out, in, P.HW, nullptr, out, nullptr, l == 0 ? (BF16 ? P.ldxb : ldx) : in, nullptr, in);
    c.groups = nh, c.splits = splits, c.k_chunk = chunk, c.c_split_stride = (long long)out * in;
    for (int h = 0; h < nh; ++h) {
      c.A[h] = dz(cur, h, out);
      c.B[h] = l > 0 ? mask_act<T>(P, ws, l - 1, dims, h) : mask_x<T>(P, ws, X, h);
      c.C[h] = ws + P.dw_part + h * P.dw_gs;
      c.rsum[h] = ws + P.col_part + h * P.col_gs;
    }
    // x_in = X, channels-first [in, ldx], for l = 0
    rc = l == 0 ? Eng::template run<false, false, EPI_STORE>(st, c) : Eng::template run<false, true, EPI_STORE>(st, c);
    if (rc) return rc;
    Eng::reduce_parts(st, nh, parts, out * in, (long long)out * in, ws + P.dw_part, P.dw_gs,
                      layer_ptrs<float, GroupPtrs>(nh, n_layers, l, dW));
    MARF_CHECK_LAUNCH();
    Eng::reduce_parts(st, nh, parts, out, out, ws + P.col_part, P.col_gs,
                      layer_ptrs<float, GroupPtrs>(nh, n_layers, l, db));
    MARF_CHECK_LAUNCH();
    if (l > 0) {  // dz of the layer below, ReLU-gated by its activation
      GemmCall d = gemm_call(P.HW, in, out, nullptr, out, nullptr, in, nullptr, in);
      d.groups = nh, d.ldg = in;
      for (int h = 0; h < nh; ++h) {
        d.A[h] = dz(cur, h, out);
        d.B[h] = ws + P.wsplit[h][l][1];
        d.C[h] = dz(cur ^ 1, h, in);
        d.gate[h] = mask_act<T>(P, ws, l - 1, dims, h);
      }
      rc = Eng::template run_presplit<EPI_GATE>(st, d);
      if (rc) return rc;
      cur ^= 1;
    }
  }
  return 0;
}

}  // namespace
