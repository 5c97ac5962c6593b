// Fused planar train step for Hopper (sm_90a): two entry points over one
// pipeline, each in float32 and in bf16.
//
// marf_fused_step_warp replaces marf_tpu/ops/pallas/fused_step.py:_kernel_warp
// (K1, wrapper fused_train_kernel_warp); marf_fused_step_coords replaces
// fused_step.py:_kernel (K2, wrapper fused_train_kernel), which is K1 given
// the warped coordinates. The pipeline itself (what one call computes) is
// `fused_step` in fused_step.cuh, which K5 (fused_implicit.cu) runs too.
// marf_fused_step_warp_bf16 and marf_fused_step_coords_bf16 are the same
// kernels' bodies at cdtype = bfloat16 (compute_dtype, fused_step.py:405,
// 547): the encoding and activations stored in bf16, the weights read as
// bf16, every product on the bf16 tensor-core engine (tc_gemm.cuh
// TbEngine: 989 TFLOP/s dense, so the canonical step's 267 GFLOP bound
// 0.27 ms, and half the activation bytes).
//
// What bounds it: float32 FLOPs. The canonical step (N = 216,000, MLP
// 34->256x4->3) needs about 267 GFLOP (forward, dX and dW products) against
// about 1 GB of activation traffic, so it sits far above the card's float32
// balance point: 1.62 ms at 165 TFLOP/s, the card's float32-accurate
// tensor-core rate (3xTF32: 495 / 3). The design spends its effort on the
// products: each dense layer runs on the 3xTF32 tensor-core engine
// (tc_gemm.cuh, wgmma), with bias+ReLU, the ReLU gate and the split-K
// partials fused into its epilogue and db folded into the dW product. The
// forward and dz products take their weights split into TF32 hi and lo
// once per call (presplit_kernel, W and W^T, 3.4 MB at the canonical
// size), brought into shared memory by bulk copies, so no block splits a
// weight tile again; they run on the engine's warp-specialised pre-split
// kernel (a producer warpgroup, two consumer warpgroups on a 128 x 128
// tile). The elementwise stages (warp + posenc,
// the 256->3 head with the loss, the posenc/warp VJP) are memory-bound
// passes of their own.
//
// The TPU kernel carried dW/db/dH/loss across a sequential grid in scratch.
// CUDA blocks run in parallel in no order, so every reduction over points
// runs in two deterministic stages: per-block (or per-split) partials into a
// workspace, then a fixed-order sum. There are no float atomics: two calls on
// the same inputs give bitwise-equal outputs. A 256x256 float32 layer is
// 256 KB, more than a block's shared memory, so the GEMMs stream weight tiles
// from global memory (all weights together sit in L2) and the activations of
// all points go to a global workspace (about 1.4 GB at the canonical size).
//
// Layouts: weights are nn.Linear's [out, in], row-major; activations are
// point-major [N, width]; grid, coords, targets, rgb, dcoords are
// channels-first [C, N].

#include "fused_step.cuh"

extern "C" {

// Floats of workspace one call needs (the wrapper allocates it).
long long marf_fused_step_warp_workspace(int Np, int B, int L, int n_layers, const int* dims) {
  return make_plan<float>(Np, B, L, n_layers, dims).total;
}

// K1. Returns 0, or the CUDA error code of the first launch that failed.
// dims[0..n_layers]: layer widths, dims[0] = 2 + 4L, dims[n_layers] = 3.
// W[l]: [dims[l+1], dims[l]]; bias[l]: [dims[l+1]]; dW/db the same shapes.
// grid [3, Np] rows (u, v, b); H [B, 9]; cw [L]; tgt/rgb [3, Np]; msk/sq [Np];
// scal [2] = (dscale, lscale); loss [1]; dH [B, 9].
int marf_fused_step_warp(int Np, int B, int L, int n_layers, const int* dims, const float* grid, const float* H,
                         const float* cw, const float* tgt, const float* msk, const float* scal,
                         const float* const* W, const float* const* bias, float* rgb, float* sq, float* loss,
                         float* const* dW, float* const* db, float* dH, float* ws, void* stream) {
  if (B < 1 || B > MAX_IMAGES) return (int)cudaErrorInvalidValue;
  return fused_step<float>(Np, B, L, n_layers, dims, grid, H, nullptr, cw, tgt, msk, scal, W, bias, rgb, sq, loss, dW,
                           db, dH, nullptr, ws, (cudaStream_t)stream);
}

long long marf_fused_step_coords_workspace(int Np, int L, int n_layers, const int* dims) {
  return make_plan<float>(Np, 0, L, n_layers, dims).total;
}

// K2: as K1 with coords [2, Np] (warped coordinates) in place of grid and H,
// and dcoords [2, Np] in place of dH.
int marf_fused_step_coords(int Np, int L, int n_layers, const int* dims, const float* coords, const float* cw,
                           const float* tgt, const float* msk, const float* scal, const float* const* W,
                           const float* const* bias, float* rgb, float* sq, float* loss, float* const* dW,
                           float* const* db, float* dcoords, float* ws, void* stream) {
  return fused_step<float>(Np, 0, L, n_layers, dims, nullptr, nullptr, coords, cw, tgt, msk, scal, W, bias, rgb, sq,
                           loss, dW, db, nullptr, dcoords, ws, (cudaStream_t)stream);
}

// K1 and K2 at compute_dtype = bfloat16: the arguments, layouts and
// outputs of marf_fused_step_warp and marf_fused_step_coords (the weights
// float32, as the wrapper keeps them; converted to bf16 in the call).
long long marf_fused_step_warp_bf16_workspace(int Np, int B, int L, int n_layers, const int* dims) {
  return make_plan<bf16>(Np, B, L, n_layers, dims).total;
}

int marf_fused_step_warp_bf16(int Np, int B, int L, int n_layers, const int* dims, const float* grid, const float* H,
                              const float* cw, const float* tgt, const float* msk, const float* scal,
                              const float* const* W, const float* const* bias, float* rgb, float* sq, float* loss,
                              float* const* dW, float* const* db, float* dH, float* ws, void* stream) {
  if (B < 1 || B > MAX_IMAGES) return (int)cudaErrorInvalidValue;
  return fused_step<bf16>(Np, B, L, n_layers, dims, grid, H, nullptr, cw, tgt, msk, scal, W, bias, rgb, sq, loss, dW,
                          db, dH, nullptr, ws, (cudaStream_t)stream);
}

long long marf_fused_step_coords_bf16_workspace(int Np, int L, int n_layers, const int* dims) {
  return make_plan<bf16>(Np, 0, L, n_layers, dims).total;
}

int marf_fused_step_coords_bf16(int Np, int L, int n_layers, const int* dims, const float* coords, const float* cw,
                                const float* tgt, const float* msk, const float* scal, const float* const* W,
                                const float* const* bias, float* rgb, float* sq, float* loss, float* const* dW,
                                float* const* db, float* dcoords, float* ws, void* stream) {
  return fused_step<bf16>(Np, 0, L, n_layers, dims, nullptr, nullptr, coords, cw, tgt, msk, scal, W, bias, rgb, sq,
                          loss, dW, db, nullptr, dcoords, ws, (cudaStream_t)stream);
}

}  // extern "C"
