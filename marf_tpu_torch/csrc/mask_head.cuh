// The factored implicit-mask head's building blocks for Hopper (sm_90a),
// float32, shared by fused_mask.cu (K3, K4, K6) and fused_implicit.cu (K5):
//   - hidden_forward: the hidden layers' SGEMMs over one block of columns of
//     X [56, ldx] (the column block starts at X, rows are ldx apart), so a
//     head's block of a wider X is read in place;
//   - mask_head_fwd_kernel: the 256 -> 1 sigmoid layer, one warp per column;
//   - mask_backward: forward recompute, the head pass with the in-kernel
//     cotangent (a functor: DedupCot for K4, ColumnCot for K6) and the
//     backward chain into dW/db of every effective layer.
// Layouts: weights are nn.Linear's [out, in], row-major; X is channels-first;
// activations are column-major over points [K, width].

#pragma once

#include "mlp_kernels.cuh"

namespace {

// m[p] = sigmoid(W X[p] + b) for the last layer (F -> 1), one warp per point.
__global__ void __launch_bounds__(ELEM_THREADS)
mask_head_fwd_kernel(int K, int F, const float* __restrict__ X, const float* __restrict__ W,
                     const float* __restrict__ bias, float* __restrict__ m) {
  __shared__ float Ws[HEAD_MAX_K];
  for (int i = threadIdx.x; i < F; i += ELEM_THREADS) Ws[i] = W[i];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * HEAD_POINTS + threadIdx.x / 32;
  if (p >= K) return;
  const float z = row_dot(X + (long long)p * F, Ws, F, lane);
  if (lane == 0) m[p] = sigmoidf_(z + bias[0]);
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
// columns (one warp per column, tiles of HEAD_POINTS):
//   m = sigmoid(W X[p] + b) (bitwise as mask_head_fwd_kernel);
//   d = cot(p, m) m (1 - m);
//   dX[p, f] = d W[f] (X[p, f] > 0);
//   partial [dW (F) | db (1)] = sum_p d X[p], sum_p d.
template <class Cot>
__global__ void __launch_bounds__(ELEM_THREADS)
mask_head_bwd_kernel(int K, int F, int chunk, const float* __restrict__ X, const float* __restrict__ W,
                     const float* __restrict__ bias, Cot cot, float* __restrict__ dX, float* __restrict__ part,
                     int part_stride) {
  __shared__ float Ws[HEAD_MAX_K];
  __shared__ float ds[HEAD_POINTS];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wid = tid / 32;
  for (int i = tid; i < F; i += ELEM_THREADS) Ws[i] = W[i];
  const float b0 = bias[0];
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
        ds[wid] = cot(p, m) * m * (1.0f - m);
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
          const float xv = X[idx];
          dX[idx] = xv > 0.0f ? ds[q] * w : 0.0f;
          acc[j] = fmaf(xv, ds[q], acc[j]);
        }
      }
    }
    if (tid == 0) {
      for (int q = 0; q < np; ++q) dbias += ds[q];
    }
    __syncthreads();
  }

  float* out = part + (long long)blockIdx.x * part_stride;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int f = tid + j * ELEM_THREADS;
    if (f < F) out[f] = acc[j];
  }
  if (tid == 0) out[F] = dbias;
}

struct MaskPlan {
  int head_blocks, head_chunk, head_stride, colsum_chunk;
  long long acts[MAX_LAYERS], dz[2], dw_part, col_part, head_part, total;
};

// The workspace of one block of K columns. dims[0..n_layers]: effective layer
// widths, dims[0] = X rows, dims[n_layers] = 1.
MaskPlan make_mask_plan(int K, int n_layers, const int* dims, bool backward) {
  MaskPlan P{};
  Arena a;
  int widest = 1;
  for (int l = 0; l + 1 < n_layers; ++l) {
    P.acts[l] = a.take((long long)K * dims[l + 1]);
    widest = dims[l + 1] > widest ? dims[l + 1] : widest;
  }
  if (backward) {
    P.dz[0] = a.take((long long)K * widest);
    P.dz[1] = a.take((long long)K * widest);
    long long dw_max = 0;
    for (int l = 0; l + 1 < n_layers; ++l) {
      int splits, chunk;
      dw_split(K, dims[l + 1], dims[l], splits, chunk);
      long long n = (long long)splits * dims[l + 1] * dims[l];
      dw_max = n > dw_max ? n : dw_max;
    }
    P.dw_part = a.take(dw_max);
    P.colsum_chunk = cdiv(K, COLSUM_SPLITS);
    P.col_part = a.take((long long)COLSUM_SPLITS * widest);
    P.head_blocks = cdiv(K, 64) < 1024 ? cdiv(K, 64) : 1024;
    P.head_chunk = cdiv(cdiv(K, P.head_blocks), HEAD_POINTS) * HEAD_POINTS;
    P.head_blocks = cdiv(K, P.head_chunk);
    P.head_stride = dims[n_layers - 1] + 4;
    P.head_part = a.take((long long)P.head_blocks * P.head_stride);
  }
  P.total = a.off;
  return P;
}

bool valid_mask_dims(int K, int n_layers, const int* dims) {
  return K >= 1 && n_layers >= 2 && n_layers <= MAX_LAYERS && dims[n_layers] == 1 &&
         dims[n_layers - 1] <= HEAD_MAX_K;
}

// The hidden layers' forward on K columns: acts[l] = relu(W[l] x + b[l]),
// x = X (channels-first, rows ldx apart) for l = 0.
int hidden_forward(cudaStream_t st, const MaskPlan& P, int K, int ldx, int n_layers, const int* dims, const float* X,
                   const float* const* W, const float* const* bias, float* ws) {
  for (int l = 0; l + 1 < n_layers; ++l) {
    if (l == 0) {
      gemm<false, false, EPI_BIAS_RELU>(st, K, dims[1], dims[0], X, ldx, W[0], dims[0], ws + P.acts[0], dims[1],
                                        bias[0], nullptr, 0, 1, dims[0], 0);
    } else {
      gemm<true, false, EPI_BIAS_RELU>(st, K, dims[l + 1], dims[l], ws + P.acts[l - 1], dims[l], W[l], dims[l],
                                       ws + P.acts[l], dims[l + 1], bias[l], nullptr, 0, 1, dims[l], 0);
    }
    MARF_CHECK_LAUNCH();
  }
  return 0;
}

// The head's backward on K columns (X as in hidden_forward): the forward
// recompute, the head pass with the cotangent `cot`, then dW/db of every
// layer through the hidden layers (ReLU-gated dX, split-K dW products with
// a fixed-order sum, two-stage column sums for db; no dX for X).
template <class Cot>
int mask_backward(cudaStream_t st, const MaskPlan& P, int K, int ldx, int n_layers, const int* dims, const float* X,
                  const float* const* W, const float* const* bias, Cot cot, float* const* dW, float* const* db,
                  float* ws) {
  int rc = hidden_forward(st, P, K, ldx, n_layers, dims, X, W, bias, ws);
  if (rc) return rc;

  // ---- head: cotangent, dz of the last hidden layer, dW/db of the last layer
  const int last = n_layers - 1;
  const int F = dims[last];
  mask_head_bwd_kernel<Cot><<<P.head_blocks, ELEM_THREADS, 0, st>>>(
      K, F, P.head_chunk, ws + P.acts[last - 1], W[last], bias[last], cot, ws + P.dz[0], ws + P.head_part,
      P.head_stride);
  MARF_CHECK_LAUNCH();
  reduce(st, P.head_blocks, F, P.head_stride, ws + P.head_part, dW[last]);
  MARF_CHECK_LAUNCH();
  reduce(st, P.head_blocks, 1, P.head_stride, ws + P.head_part + F, db[last]);
  MARF_CHECK_LAUNCH();

  // ---- backward through the hidden layers
  int cur = 0;
  for (int l = last - 1; l >= 0; --l) {
    const int out = dims[l + 1], in = dims[l];
    const float* dz_cur = ws + P.dz[cur];
    // dW[l] = dz^T x_in, split over columns, then a fixed-order sum
    int splits, chunk;
    dw_split(K, out, in, splits, chunk);
    if (l == 0) {  // x_in = X, channels-first [in, ldx]
      gemm<false, false, EPI_STORE>(st, out, in, K, dz_cur, out, X, ldx, ws + P.dw_part, in, nullptr, nullptr, 0,
                                    splits, chunk, (long long)out * in);
    } else {
      gemm<false, true, EPI_STORE>(st, out, in, K, dz_cur, out, ws + P.acts[l - 1], in, ws + P.dw_part, in, nullptr,
                                   nullptr, 0, splits, chunk, (long long)out * in);
    }
    MARF_CHECK_LAUNCH();
    reduce(st, splits, out * in, (long long)out * in, ws + P.dw_part, dW[l]);
    MARF_CHECK_LAUNCH();
    colsum(st, K, out, P.colsum_chunk, dz_cur, ws + P.col_part, db[l]);
    MARF_CHECK_LAUNCH();
    if (l > 0) {  // dz of the layer below, ReLU-gated by its activation
      gemm<true, true, EPI_GATE>(st, K, in, out, dz_cur, out, W[l], in, ws + P.dz[cur ^ 1], in, nullptr,
                                 ws + P.acts[l - 1], in, 1, out, 0);
      MARF_CHECK_LAUNCH();
      cur ^= 1;
    }
  }
  return 0;
}

}  // namespace
