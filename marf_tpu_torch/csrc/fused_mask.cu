// Implicit-mask head kernels for Hopper (sm_90a), K3, K4 and K6, each in
// float32 and in bf16.
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
//
// What bounds them: their FLOPs. K3 needs 2 K (56*256 + 3*256*256 + 256)
// = 2 K 211,200 FLOP (19.5 GFLOP at K = 46,271); K4 recomputes that and adds
// the dW and dX products, about 2 K (211,200 + 211,200 + 196,864) FLOP (57
// GFLOP); K6 the same over N = 216,000 columns (267.5 GFLOP). At 165 TFLOP/s,
// the card's float32-accurate tensor-core rate (3xTF32, 495 / 3): K3 0.118
// ms, K4 0.347 ms, K6 1.62 ms; in bf16 at 989 TFLOP/s, the dense bf16 rate:
// K3 0.020 ms, K4 0.058 ms, K6 0.270 ms. Their streamed bytes (X, the
// [B, HW] or [N] streams) are tens of MB at most.
//
// Design: every product on the 3xTF32 tensor-core engine (tc_gemm.cuh,
// wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32 with A from registers
// for all of them: the dW products take dz as A and the layer input (or X)
// as B, both point-major, B transposed into K-major hi/lo tiles by the
// split pass; the dz products dz K-major and W [out, in] as it lies; the
// forward activations and weights K-major and X point-major). The 56-wide
// first layer reads X channels-first in place (lda = the row stride of X),
// in the forward as A and in its dW as B, so X is never relaid.
// The weights of hidden layers 1..3 are the same B for every block and
// k-tile of their products, so each call splits every head's into TF32 hi
// and lo once, in one launch (presplit_kernel over a table of weights, both
// orientations, 3 MB a head), and their forward and ReLU-gated dz products
// run on the engine's warp-specialised pre-split kernel, as the rgb
// pipeline's do; in bf16 the same launch converts them to bf16 tiles. K3
// and K4 run one head. K4's forward recompute runs the same launches as K3,
// so its m is bitwise K3's (the Pallas kernel recomputes it too).
// K6 runs all heads in one launch per product: the head is part of the
// block index (blockIdx.z = head * splits + split, as the TPU grid's g //
// T), its W, bias and partial buffers come from the GemmCall's pointer
// table (passed by value), and the dW partials are per head, each head's
// reduce a fixed-order sum (one launch for all heads). db is folded into
// the dW product (the row sums of dz over each split, from the same
// fragment reads), so no column-sum pass re-reads dz. The head pass and its
// reduces run once over all heads too.
// K6's workspace spans all N columns (up to MAX_GROUP heads at a time):
// four 256-wide activations and two dz buffers, 6 x 256 x 4 B = 6 KB per
// column, 1.33 GB at N = 216,000 in float32, half that in bf16 (the
// head-by-head design this replaces
// reused one head's 177 MB in turn, at the cost of five launches of every
// product).
// The 256 -> 1 head would waste a 128-wide GEMM tile, so it runs as a
// warp-per-point pass (row_dot), which in K4 and K6 also forms the cotangent
// and the first backward step (mask_head.cuh). Every reduction over columns
// (the dW splits, the db sums, the head's partials) runs in two fixed-order
// stages: no float atomics, bitwise-equal relaunches. The slot0 segment sum
// over b runs in a fixed order inside the head pass.
//
// marf_mask_forward_bf16, marf_mask_backward_dedup_bf16 and
// marf_mask_backward_g_bf16 are K3's, K4's and K6's bodies at cdtype =
// bfloat16 (compute_dtype, marf_tpu/engine/step.py:555, 611, 629, 724): X
// converted to bf16 once per call (56 x K, or each head's 56 x HW block,
// rows padded to 16 bytes and every head's block starting on 16 bytes)
// with each head's first-layer weights, the hidden weights converted to
// bf16 tiles once per call (both orientations, every head), every product
// on the bf16 tensor-core engine (tc_gemm.cuh TbEngine). K6 in bf16 rounds
// where _mask_bwd_g_kernel does (fused_mask.py:558, 570, 575, 778-785): d =
// g m (1 - m) in bf16, db the float32 sum of that rounded d, each
// ReLU-gated dz in bf16, the weights of the dz products bf16. K4's forward
// recompute runs K3's launches, so its m is bitwise K3's here too.
//
// Layouts: weights are nn.Linear's [out, in], row-major; X is [56, K] or
// [56, N] channels-first; activations are column-major over points
// [K, width]; s0map, sq, esq are [B, HW] for K4 and [N] for K6.

#include "mask_head.cuh"

namespace {

// K6's plan: the workspace of up to MAX_GROUP heads, reused by each group,
// every head's hidden weights pre-split
template <class T>
MaskPlan g_plan(int HW, int n_heads, int n_layers, const int* dims) {
  return make_mask_plan<T>(HW, n_heads < MAX_GROUP ? n_heads : MAX_GROUP, n_layers, dims, true);
}

// K6 at storage type T (the entry points below): the heads in groups of up
// to MAX_GROUP, each group's backward in one launch per product
template <class T>
int mask_backward_g(int N, int n_heads, int n_layers, const int* dims, const float* X, const float* sq,
                    const float* esq, const float* cnt, const float* abk, float c, const float* const* W,
                    const float* const* bias, float* const* dW, float* const* db, float* ws, cudaStream_t st) {
  if (n_heads < 1 || N % n_heads != 0) return (int)cudaErrorInvalidValue;
  const int HW = N / n_heads;
  if (!valid_mask_dims(HW, n_layers, dims)) return (int)cudaErrorInvalidValue;
  const MaskPlan P0 = g_plan<T>(HW, n_heads, n_layers, dims);
  for (int h0 = 0; h0 < n_heads; h0 += P0.nh) {  // all heads at once up to MAX_GROUP of them
    MaskPlan P = P0;
    P.nh = n_heads - h0 < P.nh ? n_heads - h0 : P.nh;
    const long long o = (long long)h0 * HW;
    const ColumnCot cot{sq + o, esq ? esq + o : nullptr, cnt ? cnt + o : nullptr, abk, c};
    const int k = h0 * n_layers;
    int rc = mask_backward<T>(st, P, N, n_layers, dims, X + o, W + k, bias + k, cot, dW + k, db + k, ws);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

// Floats of workspace one call needs (the wrapper allocates it).
long long marf_mask_forward_workspace(int K, int n_layers, const int* dims) {
  return make_mask_plan<float>(K, 1, n_layers, dims, false).total;
}

long long marf_mask_backward_workspace(int K, int n_layers, const int* dims) {
  return make_mask_plan<float>(K, 1, n_layers, dims, true).total;
}

long long marf_mask_backward_g_workspace(int N, int n_heads, int n_layers, const int* dims) {
  return g_plan<float>(N / n_heads, n_heads, n_layers, dims).total;
}

// K3. Returns 0, or the CUDA error code of the first launch that failed.
// X [dims[0], K]; W[l] [dims[l+1], dims[l]]; bias[l] [dims[l+1]]; m [K].
int marf_mask_forward(int K, int n_layers, const int* dims, const float* X, const float* const* W,
                      const float* const* bias, float* m, float* ws, void* stream) {
  if (!valid_mask_dims(K, n_layers, dims)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const MaskPlan P = make_mask_plan<float>(K, 1, n_layers, dims, false);
  int rc = hidden_forward<float>(st, P, K, n_layers, dims, X, W, bias, ws);
  if (rc) return rc;
  return mask_head_forward<float>(st, P, n_layers, dims, W, bias, ws, m);
}

// K4. s0map, sq [B, HW] and esq [B, HW] (nullptr without edges) are the
// per-position streams; base, cnt [K]; abk [3] = (a, b, kk); dW/db like W/bias.
int marf_mask_backward_dedup(int K, int HW, int B, int n_layers, const int* dims, const float* X,
                             const float* s0map, const float* sq, const float* esq, const float* base,
                             const float* cnt, const float* abk, const float* const* W, const float* const* bias,
                             float* const* dW, float* const* db, float* ws, void* stream) {
  if (!valid_mask_dims(K, n_layers, dims) || HW < 0 || HW > K || B < 1) return (int)cudaErrorInvalidValue;
  const MaskPlan P = make_mask_plan<float>(K, 1, n_layers, dims, true);
  return mask_backward<float>((cudaStream_t)stream, P, K, n_layers, dims, X, W, bias,
                              DedupCot{HW, B, s0map, sq, esq, base, cnt, abk}, dW, db, ws);
}

// K6. X [dims[0], N] with N = n_heads HW; sq [N], esq [N] (nullptr without
// edges), cnt [N] (nullptr: ones); abk [3] = (a, b, k) on the device, c on
// the host. W, bias, dW, db hold n_heads x n_layers pointers, head-major.
// ws: marf_mask_backward_g_workspace(N, n_heads, ...) floats.
int marf_mask_backward_g(int N, int n_heads, int n_layers, const int* dims, const float* X, const float* sq,
                         const float* esq, const float* cnt, const float* abk, float c, const float* const* W,
                         const float* const* bias, float* const* dW, float* const* db, float* ws, void* stream) {
  return mask_backward_g<float>(N, n_heads, n_layers, dims, X, sq, esq, cnt, abk, c, W, bias, dW, db, ws,
                                (cudaStream_t)stream);
}

// K3, K4 and K6 at compute_dtype = bfloat16: the arguments, layouts and
// outputs of marf_mask_forward, marf_mask_backward_dedup and
// marf_mask_backward_g (X and the weights float32, as the wrapper keeps
// them; converted to bf16 in the call).
long long marf_mask_forward_bf16_workspace(int K, int n_layers, const int* dims) {
  return make_mask_plan<bf16>(K, 1, n_layers, dims, false).total;
}

long long marf_mask_backward_bf16_workspace(int K, int n_layers, const int* dims) {
  return make_mask_plan<bf16>(K, 1, n_layers, dims, true).total;
}

int marf_mask_forward_bf16(int K, int n_layers, const int* dims, const float* X, const float* const* W,
                           const float* const* bias, float* m, float* ws, void* stream) {
  if (!valid_mask_dims(K, n_layers, dims)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const MaskPlan P = make_mask_plan<bf16>(K, 1, n_layers, dims, false);
  int rc = hidden_forward<bf16>(st, P, K, n_layers, dims, X, W, bias, ws);
  if (rc) return rc;
  return mask_head_forward<bf16>(st, P, n_layers, dims, W, bias, ws, m);
}

int marf_mask_backward_dedup_bf16(int K, int HW, int B, int n_layers, const int* dims, const float* X,
                                  const float* s0map, const float* sq, const float* esq, const float* base,
                                  const float* cnt, const float* abk, const float* const* W, const float* const* bias,
                                  float* const* dW, float* const* db, float* ws, void* stream) {
  if (!valid_mask_dims(K, n_layers, dims) || HW < 0 || HW > K || B < 1) return (int)cudaErrorInvalidValue;
  const MaskPlan P = make_mask_plan<bf16>(K, 1, n_layers, dims, true);
  return mask_backward<bf16>((cudaStream_t)stream, P, K, n_layers, dims, X, W, bias,
                             DedupCot{HW, B, s0map, sq, esq, base, cnt, abk}, dW, db, ws);
}

long long marf_mask_backward_g_bf16_workspace(int N, int n_heads, int n_layers, const int* dims) {
  return g_plan<bf16>(N / n_heads, n_heads, n_layers, dims).total;
}

int marf_mask_backward_g_bf16(int N, int n_heads, int n_layers, const int* dims, const float* X, const float* sq,
                              const float* esq, const float* cnt, const float* abk, float c, const float* const* W,
                              const float* const* bias, float* const* dW, float* const* db, float* ws, void* stream) {
  return mask_backward_g<bf16>(N, n_heads, n_layers, dims, X, sq, esq, cnt, abk, c, W, bias, dW, db, ws,
                               (cudaStream_t)stream);
}

}  // extern "C"
