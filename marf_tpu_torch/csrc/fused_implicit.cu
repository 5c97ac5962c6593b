// The fused implicit-mask train kernel for Hopper (sm_90a), float32.
//
// marf_implicit_train replaces marf_tpu/ops/pallas/fused_mask.py:
// _implicit_kernel (K5, "kernel A", wrapper fused_implicit_train_kernel), the
// first half of the implicit-mask step without column dedup: per-image mask
// heads (n_heads = B) or the shared head on all N columns (n_heads = 1). One
// call runs, on one stream:
//   1. per head h, the factored mask head's forward on the column block
//      [h HW, (h+1) HW) of X [56, N] (hidden_forward reads the block in place,
//      lda = N) and the sigmoid head pass -> m [N];
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
// GFLOP): 5.35 ms at 67 TFLOP/s. Its streamed inputs and outputs (coords,
// X, targets; rgb, m, sq, dcoords) are some 65 MB, 0.02 ms at 3.35 TB/s.
// Design: no new kernel code; the stages are the K2 and K3 building blocks in
// order. On the TPU the mask forward and the rgb chain were interleaved in
// one tile to keep the matrix unit busy; on the card each stage's SGEMMs
// fill the SMs on their own. The mask activations are dead once m is
// written, so the rgb pipeline's workspace reuses theirs.

#include "fused_step.cuh"
#include "mask_head.cuh"

namespace {

struct ImplicitPlan {
  MaskPlan mask;  // one head's HW columns, reused by every head
  long long msum_part, total;
};

ImplicitPlan make_implicit_plan(int N, int n_heads, int L, int n_rgb, const int* rgb_dims, int n_mask,
                                const int* mask_dims) {
  ImplicitPlan I{};
  I.mask = make_mask_plan(N / n_heads, n_mask, mask_dims, false);
  const long long rgb_total = make_plan(N, 0, L, n_rgb, rgb_dims).total;
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

  // ---- 1. the mask forward, head by head on its column block
  const int last = n_mask - 1;
  for (int h = 0; h < n_heads; ++h) {
    const long long o = (long long)h * HW;
    const float* const* hW = mW + h * n_mask;
    const float* const* hb = mb + h * n_mask;
    int rc = hidden_forward(st, I.mask, HW, N, n_mask, mask_dims, X + o, hW, hb, ws);
    if (rc) return rc;
    mask_head_fwd_kernel<<<cdiv(HW, HEAD_POINTS), ELEM_THREADS, 0, st>>>(
        HW, mask_dims[last], ws + I.mask.acts[last - 1], hW[last], hb[last], m + o);
    MARF_CHECK_LAUNCH();
  }

  // ---- 2. msum, in two fixed-order stages
  colsum(st, N, 1, cdiv(N, COLSUM_SPLITS), m, ws + I.msum_part, msum);
  MARF_CHECK_LAUNCH();

  // ---- 3. K2's pipeline masked by m with the unnormalized scalars
  return fused_step(N, 0, L, n_rgb, rgb_dims, nullptr, nullptr, coords, cw, tgt, m, scal, W, bias, rgb, sq, loss, dW,
                    db, nullptr, dcoords, ws, st);
}

}  // extern "C"
