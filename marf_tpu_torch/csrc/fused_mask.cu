// Shared-head implicit-mask kernels for Hopper (sm_90a), float32.
//
// marf_mask_forward replaces marf_tpu/ops/pallas/fused_mask.py:
// _mask_fwd_only_kernel (K3, wrapper fused_mask_forward): the factored mask
// head, effective layers 56 -> 256 x4 -> 1 with a sigmoid, over the K
// deduplicated input columns X [56, K] -> m [K].
//
// marf_mask_backward_dedup replaces fused_mask.py:_mask_bwd_dedup_kernel
// (K4, wrapper fused_mask_backward_dedup). It recomputes the forward, keeping
// the activations in the workspace, then per column k
//   seg = a sum_b s0map[b,k] sq[b,k] + b sum_b s0map[b,k] esq[b,k] + base[k]
//         (the slot0 segment sums exist only for k < HW: columns past the
//          slot0 block, the extras, carry theirs in base),
//   g   = seg m + kk cnt[k],   d = g m (1 - m)   (through the sigmoid),
// and runs the head's backward: dW, db of every effective layer, through the
// four hidden layers with ReLU-gated dX and split-K dW products.
//
// What bounds them: float32 FLOPs. K3 needs 2 K (56*256 + 3*256*256 + 256)
// = 2 K 211,200 FLOP (18 GFLOP at K = 43,200, 0.27 ms at 67 TFLOP/s); K4
// recomputes that and adds the dW and dX products, about 2 K (211,200 +
// 211,200 + 196,864) FLOP. Their streamed bytes (X, the [B, HW] streams) are
// a few MB. Design: the hidden layers are the tiled SIMT SGEMMs of
// mlp_kernels.cuh; the 56-wide first layer reads X channels-first through the
// GEMM's transposed-A loader, and its dW product reads X through the
// transposed-B loader, so X is never relaid. The 256 -> 1 head would waste a
// 128-wide GEMM tile, so it runs as a warp-per-point pass (row_dot), which in
// K4 also forms the cotangent and the first backward step. Every reduction
// over columns (the dW splits, the db column sums, the head's partials) runs
// in two fixed-order stages: no float atomics, bitwise-equal relaunches. The
// slot0 segment sum over b runs in a fixed order inside the head pass.
//
// Layouts: weights are nn.Linear's [out, in], row-major; X is [56, K]
// channels-first; activations are column-major over points [K, width];
// s0map, sq, esq are [B, HW].

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

// The last layer's backward with the in-kernel cotangent, per chunk of
// columns (one warp per column, tiles of HEAD_POINTS):
//   m = sigmoid(W X[p] + b) (bitwise as mask_head_fwd_kernel);
//   d = (seg m + kk cnt[p]) m (1 - m), seg as in the file note;
//   dX[p, f] = d W[f] (X[p, f] > 0);
//   partial [dW (F) | db (1)] = sum_p d X[p], sum_p d.
// abk = (a, b, kk) on the device.
__global__ void __launch_bounds__(ELEM_THREADS)
mask_head_bwd_kernel(int K, int F, int HW, int B, int chunk, const float* __restrict__ X,
                     const float* __restrict__ W, const float* __restrict__ bias, const float* __restrict__ s0map,
                     const float* __restrict__ sq, const float* __restrict__ esq, const float* __restrict__ base,
                     const float* __restrict__ cnt, const float* __restrict__ abk, float* __restrict__ dX,
                     float* __restrict__ part, int part_stride) {
  __shared__ float Ws[HEAD_MAX_K];
  __shared__ float ds[HEAD_POINTS];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wid = tid / 32;
  for (int i = tid; i < F; i += ELEM_THREADS) Ws[i] = W[i];
  const float b0 = bias[0];
  const float a_s = abk[0], b_s = abk[1], k_s = abk[2];
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
        float seg = base[p];
        if (p < HW) {
          float s = 0.0f;
          for (int b = 0; b < B; ++b) s += s0map[(long long)b * HW + p] * sq[(long long)b * HW + p];
          seg = a_s * s + seg;
          if (esq) {
            float se = 0.0f;
            for (int b = 0; b < B; ++b) se += s0map[(long long)b * HW + p] * esq[(long long)b * HW + p];
            seg += b_s * se;
          }
        }
        const float g = seg * m + k_s * cnt[p];
        ds[wid] = g * m * (1.0f - m);
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

// dims[0..n_layers]: effective layer widths, dims[0] = X rows, dims[n_layers] = 1.
MaskPlan make_plan(int K, int n_layers, const int* dims, bool backward) {
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

bool valid_dims(int K, int n_layers, const int* dims) {
  return K >= 1 && n_layers >= 2 && n_layers <= MAX_LAYERS && dims[n_layers] == 1 &&
         dims[n_layers - 1] <= HEAD_MAX_K;
}

// The hidden layers' forward: acts[l] = relu(W[l] x + b[l]), x = X (channels-first) for l = 0.
int hidden_forward(cudaStream_t st, const MaskPlan& P, int K, int n_layers, const int* dims, const float* X,
                   const float* const* W, const float* const* bias, float* ws) {
  for (int l = 0; l + 1 < n_layers; ++l) {
    if (l == 0) {
      gemm<false, false, EPI_BIAS_RELU>(st, K, dims[1], dims[0], X, K, W[0], dims[0], ws + P.acts[0], dims[1],
                                        bias[0], nullptr, 0, 1, dims[0], 0);
    } else {
      gemm<true, false, EPI_BIAS_RELU>(st, K, dims[l + 1], dims[l], ws + P.acts[l - 1], dims[l], W[l], dims[l],
                                       ws + P.acts[l], dims[l + 1], bias[l], nullptr, 0, 1, dims[l], 0);
    }
    MARF_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace

extern "C" {

// Floats of workspace one call needs (the wrapper allocates it).
long long marf_mask_forward_workspace(int K, int n_layers, const int* dims) {
  return make_plan(K, n_layers, dims, false).total;
}

long long marf_mask_backward_workspace(int K, int n_layers, const int* dims) {
  return make_plan(K, n_layers, dims, true).total;
}

// K3. Returns 0, or the CUDA error code of the first launch that failed.
// X [dims[0], K]; W[l] [dims[l+1], dims[l]]; bias[l] [dims[l+1]]; m [K].
int marf_mask_forward(int K, int n_layers, const int* dims, const float* X, const float* const* W,
                      const float* const* bias, float* m, float* ws, void* stream) {
  if (!valid_dims(K, n_layers, dims)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const MaskPlan P = make_plan(K, n_layers, dims, false);
  int rc = hidden_forward(st, P, K, n_layers, dims, X, W, bias, ws);
  if (rc) return rc;
  const int last = n_layers - 1;
  mask_head_fwd_kernel<<<cdiv(K, HEAD_POINTS), ELEM_THREADS, 0, st>>>(K, dims[last], ws + P.acts[last - 1], W[last],
                                                                      bias[last], m);
  MARF_CHECK_LAUNCH();
  return 0;
}

// K4. s0map, sq [B, HW] and esq [B, HW] (nullptr without edges) are the
// per-position streams; base, cnt [K]; abk [3] = (a, b, kk); dW/db like W/bias.
int marf_mask_backward_dedup(int K, int HW, int B, int n_layers, const int* dims, const float* X,
                             const float* s0map, const float* sq, const float* esq, const float* base,
                             const float* cnt, const float* abk, const float* const* W, const float* const* bias,
                             float* const* dW, float* const* db, float* ws, void* stream) {
  if (!valid_dims(K, n_layers, dims) || HW < 0 || HW > K || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const MaskPlan P = make_plan(K, n_layers, dims, true);
  int rc = hidden_forward(st, P, K, n_layers, dims, X, W, bias, ws);
  if (rc) return rc;

  // ---- head: cotangent, dz of the last hidden layer, dW/db of the last layer
  const int last = n_layers - 1;
  const int F = dims[last];
  mask_head_bwd_kernel<<<P.head_blocks, ELEM_THREADS, 0, st>>>(
      K, F, HW, B, P.head_chunk, ws + P.acts[last - 1], W[last], bias[last], s0map, sq, esq, base, cnt, abk,
      ws + P.dz[0], ws + P.head_part, P.head_stride);
  MARF_CHECK_LAUNCH();
  reduce(st, P.head_blocks, F, P.head_stride, ws + P.head_part, dW[last]);
  MARF_CHECK_LAUNCH();
  reduce(st, P.head_blocks, 1, P.head_stride, ws + P.head_part + F, db[last]);
  MARF_CHECK_LAUNCH();

  // ---- backward through the hidden layers (no dX for the input X)
  int cur = 0;
  for (int l = last - 1; l >= 0; --l) {
    const int out = dims[l + 1], in = dims[l];
    const float* dz_cur = ws + P.dz[cur];
    // dW[l] = dz^T x_in, split over columns, then a fixed-order sum
    int splits, chunk;
    dw_split(K, out, in, splits, chunk);
    if (l == 0) {  // x_in = X, channels-first [in, K]
      gemm<false, false, EPI_STORE>(st, out, in, K, dz_cur, out, X, K, ws + P.dw_part, in, nullptr, nullptr, 0,
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

}  // extern "C"
