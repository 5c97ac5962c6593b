// The fused implicit-mask train kernel for Hopper (sm_90a), float32.
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
//
// What bounds it: float32 FLOPs, some 358 GFLOP at the main path's shape (the
// rgb step's 267 GFLOP plus the mask forward on N = 216,000 columns, 91
// GFLOP): 2.17 ms at 165 TFLOP/s, the card's float32-accurate tensor-core
// rate (3xTF32: three TF32 products per float32 product, 495 / 3). Its
// streamed inputs and outputs (coords, X, targets; rgb, m, sq, dcoords) are
// some 65 MB, 0.02 ms at 3.35 TB/s.
// Design: every product runs on the 3xTF32 tensor-core engine (tc_gemm.cuh,
// wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32, A split into
// registers from the landed tile in either layout, B split into K-major
// hi/lo tiles in shared memory, transposed there where it lies point-major):
// the mask's first layer reads X channels-first (A MN-major), its hidden
// layers read activations and weights K-major, the rgb forward and dz
// products read their weights pre-split once per call (W and W^T as hi/lo
// core-matrix tiles in device memory, one bulk copy per tile; fused_step.cu),
// and the rgb dW products read dz and the layer input point-major, with db
// folded into the dW product (the row sums of dz over each split, no
// column-sum pass).
// The mask forward runs all heads in one launch per layer (the head is part
// of the block index, as the TPU grid's g // T; the heads' weights and
// biases come from the GemmCall's pointer table, passed by value), then one
// launch of the 256 -> 1 head pass over all heads. The non-GEMM stages
// (posenc, the rgb head with the loss, the posenc VJP, the two-stage sums)
// are K2's. The mask activations (nh HW columns, 885 MB at 5 heads of
// 43,200) are dead once m is written, so the rgb pipeline's workspace
// reuses theirs.

#include "fused_step.cuh"
#include "mask_head.cuh"
#include "tc_gemm.cuh"

namespace {

struct ImplicitPlan {
  MaskPlan mask;  // up to MAX_GROUP heads' columns, reused by each group of heads
  long long msum_part, total;
};

ImplicitPlan make_implicit_plan(int N, int n_heads, int L, int n_rgb, const int* rgb_dims, int n_mask,
                                const int* mask_dims) {
  ImplicitPlan I{};
  const int nh = n_heads < MAX_GROUP ? n_heads : MAX_GROUP;
  I.mask = make_mask_plan<float>(N / n_heads, nh, n_mask, mask_dims, false, false);
  const long long rgb_total = make_plan<float>(N, 0, L, n_rgb, rgb_dims).total;
  Arena a;
  a.take(I.mask.total > rgb_total ? I.mask.total : rgb_total);  // both stages start at offset 0
  I.msum_part = a.take(COLSUM_SPLITS);
  I.total = a.off;
  return I;
}

}  // namespace

extern "C" {

// Floats of workspace one call needs (the wrapper allocates it).
long long marf_implicit_train_workspace(int N, int n_heads, int L, int n_rgb, const int* rgb_dims, int n_mask,
                                        const int* mask_dims) {
  return make_implicit_plan(N, n_heads, L, n_rgb, rgb_dims, n_mask, mask_dims).total;
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
  if (n_heads < 1 || N % n_heads != 0) return (int)cudaErrorInvalidValue;
  const int HW = N / n_heads;
  if (!valid_mask_dims(HW, n_mask, mask_dims) || !valid_rgb_dims(L, n_rgb, rgb_dims)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const ImplicitPlan I = make_implicit_plan(N, n_heads, L, n_rgb, rgb_dims, n_mask, mask_dims);

  // ---- 1. the mask forward, all heads (up to MAX_GROUP) per launch
  for (int h0 = 0; h0 < n_heads; h0 += I.mask.nh) {
    MaskPlan P = I.mask;
    P.nh = n_heads - h0 < P.nh ? n_heads - h0 : P.nh;
    const long long o = (long long)h0 * HW;
    int rc = hidden_forward<float>(st, P, N, n_mask, mask_dims, X + o, mW + h0 * n_mask, mb + h0 * n_mask, ws);
    if (rc) return rc;
    rc = mask_head_forward<float>(st, P, n_mask, mask_dims, mW + h0 * n_mask, mb + h0 * n_mask, ws, m + o);
    if (rc) return rc;
  }

  // ---- 2. msum, in two fixed-order stages
  colsum(st, N, 1, cdiv(N, COLSUM_SPLITS), m, ws + I.msum_part, msum);
  MARF_CHECK_LAUNCH();

  // ---- 3. K2's pipeline masked by m with the unnormalized scalars, on the tensor cores
  return fused_step<float>(N, 0, L, n_rgb, rgb_dims, nullptr, nullptr, coords, cw, tgt, m, scal, W, bias, rgb, sq,
                           loss, dW, db, nullptr, dcoords, ws, st);
}

}  // extern "C"
