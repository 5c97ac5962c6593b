// Implicit-mask head kernels for Hopper (sm_90a), float32.
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
// marf_mask_backward_g replaces fused_mask.py:_mask_bwd_g_kernel (K6,
// wrapper fused_mask_backward_g): the same backward for per-image heads
// (n_heads = B) or the shared head without dedup (n_heads = 1) on all N =
// n_heads HW columns, head h on the column block [h HW, (h+1) HW) of X
// [56, N] and with its own layers and gradients, and the cotangent formed
// per column from the [N] streams:
//   g = (a sq + b esq + c cnt) m + k cnt   (cnt = 1 when absent).
// One workspace sized for HW columns serves the heads in turn on the stream
// (177 MB of activations per head at HW = 43,200, not 885 MB for N).
//
// What bounds them: float32 FLOPs. K3 needs 2 K (56*256 + 3*256*256 + 256)
// = 2 K 211,200 FLOP (18 GFLOP at K = 43,200, 0.27 ms at 67 TFLOP/s); K4
// recomputes that and adds the dW and dX products, about 2 K (211,200 +
// 211,200 + 196,864) FLOP; K6 the same over N = 216,000 columns (268 GFLOP,
// 3.99 ms). Their streamed bytes (X, the [B, HW] or [N] streams) are tens of
// MB at most. Design: the hidden layers are the tiled SIMT SGEMMs of
// mlp_kernels.cuh; the 56-wide first layer reads X channels-first through the
// GEMM's transposed-A loader (forward) and transposed-B loader (dW), with
// lda = the row stride of X, so X and a head's block of it are never relaid.
// The 256 -> 1 head would waste a 128-wide GEMM tile, so it runs as a
// warp-per-point pass (row_dot), which in K4 and K6 also forms the cotangent
// and the first backward step (mask_head.cuh). Every reduction over columns
// (the dW splits, the db column sums, the head's partials) runs in two
// fixed-order stages: no float atomics, bitwise-equal relaunches. The slot0
// segment sum over b runs in a fixed order inside the head pass.
//
// Layouts: weights are nn.Linear's [out, in], row-major; X is [56, K] or
// [56, N] channels-first; activations are column-major over points
// [K, width]; s0map, sq, esq are [B, HW] for K4 and [N] for K6.

#include "mask_head.cuh"

extern "C" {

// Floats of workspace one call needs (the wrapper allocates it); K6 passes
// K = HW, the columns of one head.
long long marf_mask_forward_workspace(int K, int n_layers, const int* dims) {
  return make_mask_plan(K, n_layers, dims, false).total;
}

long long marf_mask_backward_workspace(int K, int n_layers, const int* dims) {
  return make_mask_plan(K, n_layers, dims, true).total;
}

// K3. Returns 0, or the CUDA error code of the first launch that failed.
// X [dims[0], K]; W[l] [dims[l+1], dims[l]]; bias[l] [dims[l+1]]; m [K].
int marf_mask_forward(int K, int n_layers, const int* dims, const float* X, const float* const* W,
                      const float* const* bias, float* m, float* ws, void* stream) {
  if (!valid_mask_dims(K, n_layers, dims)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const MaskPlan P = make_mask_plan(K, n_layers, dims, false);
  int rc = hidden_forward(st, P, K, K, n_layers, dims, X, W, bias, ws);
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
  if (!valid_mask_dims(K, n_layers, dims) || HW < 0 || HW > K || B < 1) return (int)cudaErrorInvalidValue;
  const MaskPlan P = make_mask_plan(K, n_layers, dims, true);
  return mask_backward((cudaStream_t)stream, P, K, K, n_layers, dims, X, W, bias,
                       DedupCot{HW, B, s0map, sq, esq, base, cnt, abk}, dW, db, ws);
}

// K6. X [dims[0], N] with N = n_heads HW; sq [N], esq [N] (nullptr without
// edges), cnt [N] (nullptr: ones); abk [3] = (a, b, k) on the device, c on
// the host. W, bias, dW, db hold n_heads x n_layers pointers, head-major.
// ws: marf_mask_backward_workspace(HW, ...) floats.
int marf_mask_backward_g(int N, int n_heads, int n_layers, const int* dims, const float* X, const float* sq,
                         const float* esq, const float* cnt, const float* abk, float c, const float* const* W,
                         const float* const* bias, float* const* dW, float* const* db, float* ws, void* stream) {
  if (n_heads < 1 || N % n_heads != 0) return (int)cudaErrorInvalidValue;
  const int HW = N / n_heads;
  if (!valid_mask_dims(HW, n_layers, dims)) return (int)cudaErrorInvalidValue;
  const MaskPlan P = make_mask_plan(HW, n_layers, dims, true);
  for (int h = 0; h < n_heads; ++h) {
    const long long o = (long long)h * HW;
    const ColumnCot cot{sq + o, esq ? esq + o : nullptr, cnt ? cnt + o : nullptr, abk, c};
    const int k = h * n_layers;
    int rc = mask_backward((cudaStream_t)stream, P, HW, N, n_layers, dims, X + o, W + k, bias + k, cot, dW + k,
                           db + k, ws);
    if (rc) return rc;
  }
  return 0;
}

}  // extern "C"
