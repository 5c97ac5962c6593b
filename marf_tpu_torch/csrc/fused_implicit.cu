// The fused implicit-mask train kernel for Hopper (sm_90a), in float32 and
// in bf16.
//
// marf_implicit_train replaces marf_tpu/ops/pallas/fused_mask.py:
// _implicit_kernel (K5, "kernel A", wrapper fused_implicit_train_kernel), the
// first half of the implicit-mask step without column dedup: per-image mask
// heads (n_heads = B) or the shared head on all N columns (n_heads = 1). One
// call runs, on one stream:
//   1. the factored mask heads' forward, head h on the column block
//      [h HW, (h+1) HW) of X [56, N] (hidden_forward reads the blocks in
//      place, lda = N), and the sigmoid head pass -> m [N];
//   2. msum = sum(m), a two-stage fixed-order sum;
//   3. the rgb pipeline of K2 (fused_step.cuh) on the warped coords with
//      masks = m and scalars (2 C_r, 1): rgb, sq, dcoords and dW/db with the
//      UNNORMALIZED cotangent 2 C_r (rgb - t) m^2, and loss = sum(m^2 sq).
// The masked-MSE normalization 1 / (3 msum) needs msum, which only this
// call produces; the rgb backward is linear in its cotangent scale, so the
// caller multiplies dcoords, dW/db and the loss by it afterwards (marf_tpu's
// contract, kept output for output).
// marf_implicit_train_bf16 is the same body at cdtype = bfloat16
// (compute_dtype; marf_tpu/engine/step.py:462): the `<bf16>` instances of
// the mask forward and of K2's pipeline, rounding where _implicit_kernel
// rounds (fused_mask.py:354, 362, 495, 635): X, the mask and rgb weights,
// the encoding and every hidden activation in bf16, m the float32 sigmoid,
// the rgb cotangent through the sigmoid rounded to bf16 before the
// backward, every sum float32.
//
// What bounds it: its FLOPs, some 358.3 GFLOP at the main path's shape
// (the rgb step's 267 GFLOP plus the mask forward on N = 216,000 columns,
// 91 GFLOP): in float32 2.17 ms at 165 TFLOP/s, the card's float32-accurate
// tensor-core rate (3xTF32: three TF32 products per float32 product, 495 /
// 3); in bf16 0.362 ms at 989 TFLOP/s, the dense bf16 rate. Its streamed
// inputs and outputs (coords, X, targets; rgb, m, sq, dcoords) are some 65
// MB, 0.02 ms at 3.35 TB/s.
// Design: every product runs on a tensor-core engine (tc_gemm.cuh): in
// float32 the 3xTF32 engine (wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32
// .tf32, A split into registers from the landed tile in either layout, B
// split into K-major hi/lo tiles in shared memory, transposed there where it
// lies point-major), in bf16 the bf16 engine (TbEngine, m64nNk16.f32.bf16
// .bf16, B landed by cp.async in core matrices K- or MN-major): the mask's
// first layer reads X channels-first (A MN-major; in bf16 X's per-head
// blocks and the first-layer weights converted once per call), its hidden
// layers read activations K-major and every head's weights pre-split once
// per call in one launch (split into TF32 hi and lo, or converted to bf16
// tiles), on the pre-split kernel, the rgb forward and dz products
// read their weights pre-split once per call (W and W^T as core-matrix
// tiles in device memory, the pre-split kernel; fused_step.cu), and the
// rgb dW products read dz and the layer input point-major, with db folded
// into the dW product (the row sums of dz over each split, no column-sum
// pass).
// The mask forward runs all heads in one launch per layer (the head is part
// of the block index, as the TPU grid's g // T; the heads' weights and
// biases come from the GemmCall's pointer table, passed by value), then one
// launch of the 256 -> 1 head pass over all heads. The non-GEMM stages
// (posenc, the rgb head with the loss, the posenc VJP, the two-stage sums)
// are K2's. The mask activations (nh HW columns, 885 MB at 5 heads of
// 43,200 in float32, half in bf16) are dead once m is written, so the rgb
// pipeline's workspace reuses theirs.

#include "fused_step.cuh"
#include "mask_head.cuh"
#include "tc_gemm.cuh"

namespace {

struct ImplicitPlan {
  MaskPlan mask;  // up to MAX_GROUP heads' columns, reused by each group of heads
  long long msum_part, total;
};

// T: the activations' storage type. The mask plan pre-splits every head's
// hidden weights (split into TF32 hi and lo, or converted to bf16 tiles);
// its pre-split, like its activations, is read only before the rgb stage,
// which reuses the same workspace from offset 0.
template <class T>
ImplicitPlan make_implicit_plan(int N, int n_heads, int L, int n_rgb, const int* rgb_dims, int n_mask,
                                const int* mask_dims) {
  ImplicitPlan I{};
  const int nh = n_heads < MAX_GROUP ? n_heads : MAX_GROUP;
  I.mask = make_mask_plan<T>(N / n_heads, nh, n_mask, mask_dims, false);
  const long long rgb_total = make_plan<T>(N, 0, L, n_rgb, rgb_dims).total;
  Arena a;
  a.take(I.mask.total > rgb_total ? I.mask.total : rgb_total);  // both stages start at offset 0
  I.msum_part = a.take(COLSUM_SPLITS);
  I.total = a.off;
  return I;
}

// K5 at storage type T (the entry points below)
template <class T>
int implicit_train(int N, int n_heads, int L, int n_rgb, const int* rgb_dims, int n_mask, const int* mask_dims,
                   const float* coords, const float* X, const float* cw, const float* tgt, const float* scal,
                   const float* const* mW, const float* const* mb, const float* const* W, const float* const* bias,
                   float* rgb, float* m, float* sq, float* dcoords, float* msum, float* loss, float* const* dW,
                   float* const* db, float* ws, cudaStream_t st) {
  if (n_heads < 1 || N % n_heads != 0) return (int)cudaErrorInvalidValue;
  const int HW = N / n_heads;
  if (!valid_mask_dims(HW, n_mask, mask_dims) || !valid_rgb_dims(L, n_rgb, rgb_dims)) {
    return (int)cudaErrorInvalidValue;
  }
  const ImplicitPlan I = make_implicit_plan<T>(N, n_heads, L, n_rgb, rgb_dims, n_mask, mask_dims);

  // ---- 1. the mask forward, all heads (up to MAX_GROUP) per launch
  for (int h0 = 0; h0 < n_heads; h0 += I.mask.nh) {
    MaskPlan P = I.mask;
    P.nh = n_heads - h0 < P.nh ? n_heads - h0 : P.nh;
    const long long o = (long long)h0 * HW;
    int rc = hidden_forward<T>(st, P, N, n_mask, mask_dims, X + o, mW + h0 * n_mask, mb + h0 * n_mask, ws);
    if (rc) return rc;
    rc = mask_head_forward<T>(st, P, n_mask, mask_dims, mW + h0 * n_mask, mb + h0 * n_mask, ws, m + o);
    if (rc) return rc;
  }

  // ---- 2. msum, in two fixed-order stages
  colsum(st, N, 1, cdiv(N, COLSUM_SPLITS), m, ws + I.msum_part, msum);
  MARF_CHECK_LAUNCH();

  // ---- 3. K2's pipeline masked by m with the unnormalized scalars, on the tensor cores
  return fused_step<T>(N, 0, L, n_rgb, rgb_dims, nullptr, nullptr, coords, cw, tgt, m, scal, W, bias, rgb, sq, loss,
                       dW, db, nullptr, dcoords, ws, st);
}

}  // namespace

extern "C" {

// Floats of workspace one call needs (the wrapper allocates it).
long long marf_implicit_train_workspace(int N, int n_heads, int L, int n_rgb, const int* rgb_dims, int n_mask,
                                        const int* mask_dims) {
  return make_implicit_plan<float>(N, n_heads, L, n_rgb, rgb_dims, n_mask, mask_dims).total;
}

// K5. Returns 0, or the CUDA error code of the first launch that failed.
// rgb_dims[0..n_rgb] as K2's; mask_dims[0..n_mask] the effective mask layers
// (56 in, 1 out); coords [2, N]; X [56, N], head h's columns h HW .. (h+1) HW - 1
// with HW = N / n_heads; cw [L]; tgt [3, N]; scal [2] = (2 C_r, 1) on the
// device; mW/mb n_heads x n_mask pointers, head-major; W/bias the rgb layers.
// Out: rgb [3, N], m, sq [N], dcoords [2, N], msum [1], loss [1] = sum(m^2 sq),
// dW/db like W/bias (dcoords, dW, db unnormalized).
int marf_implicit_train(int N, int n_heads, int L, int n_rgb, const int* rgb_dims, int n_mask, const int* mask_dims,
                        const float* coords, const float* X, const float* cw, const float* tgt, const float* scal,
                        const float* const* mW, const float* const* mb, const float* const* W,
                        const float* const* bias, float* rgb, float* m, float* sq, float* dcoords, float* msum,
                        float* loss, float* const* dW, float* const* db, float* ws, void* stream) {
  return implicit_train<float>(N, n_heads, L, n_rgb, rgb_dims, n_mask, mask_dims, coords, X, cw, tgt, scal, mW, mb, W,
                               bias, rgb, m, sq, dcoords, msum, loss, dW, db, ws, (cudaStream_t)stream);
}

// K5 at compute_dtype = bfloat16: the arguments, layouts and outputs of
// marf_implicit_train (X and the weights float32, as the wrapper keeps
// them; converted to bf16 in the call).
long long marf_implicit_train_bf16_workspace(int N, int n_heads, int L, int n_rgb, const int* rgb_dims, int n_mask,
                                             const int* mask_dims) {
  return make_implicit_plan<bf16>(N, n_heads, L, n_rgb, rgb_dims, n_mask, mask_dims).total;
}

int marf_implicit_train_bf16(int N, int n_heads, int L, int n_rgb, const int* rgb_dims, int n_mask,
                             const int* mask_dims, const float* coords, const float* X, const float* cw,
                             const float* tgt, const float* scal, const float* const* mW, const float* const* mb,
                             const float* const* W, const float* const* bias, float* rgb, float* m, float* sq,
                             float* dcoords, float* msum, float* loss, float* const* dW, float* const* db, float* ws,
                             void* stream) {
  return implicit_train<bf16>(N, n_heads, L, n_rgb, rgb_dims, n_mask, mask_dims, coords, X, cw, tgt, scal, mW, mb, W,
                              bias, rgb, m, sq, dcoords, msum, loss, dW, db, ws, (cudaStream_t)stream);
}

}  // extern "C"
