// The fused rgb train-step pipeline for Hopper (sm_90a), shared by
// fused_step.cu (K1, K2) and fused_implicit.cu (K5, which runs it with the
// predicted mask as `msk`). `fused_step<T>` computes, for Np points:
//   K1: the per-point homography warp of the constant (u, v, b) grid with
//       H[b] and the +1e-8 perspective divide; K2: reads coords [2, Np];
//   the BARF posenc with c2f band weights;
//   the MLP forward (ReLU hidden layers, sigmoid rgb);
//   the masked-MSE loss partial and the per-point squared error;
//   the analytic rgb cotangent dscale*(rgb-t)*m*m chained through the sigmoid;
//   the full backward (dW, db of every layer);
//   the analytic posenc VJP, then K1: the warp VJP reduced to dH[b] per
//   image; K2: dcoords [2, Np] per point (no limit on the number of images).
// T is the storage type of the encoding and the activations: float32 (every
// product on the 3xTF32 tensor-core engine) or bf16 (compute_dtype =
// bfloat16, every product on the bf16 engine; tc_gemm.cuh's EngineOf). In
// bf16 the pipeline rounds where the Pallas kernels' cdtype does
// (marf_tpu/ops/pallas/fused_step.py _stack_fwd, _stack_bwd): the encoding
// (x and y among it) and every hidden activation are stored in bf16, every
// weight is read as bf16, the output cotangent through the sigmoid and each
// ReLU-gated dz are rounded to bf16 before they feed a product; the bias,
// the loss, d(encoding), the posenc and warp VJPs and every sum (dW, db)
// stay float32. The engine folds each db into its dW product.
// Design, bound and layouts: see fused_step.cu and fused_implicit.cu.

#pragma once

#include "tc_gemm.cuh"

namespace {

constexpr int MAX_IMAGES = 8;
constexpr int MAX_L = 16;
constexpr float PI_F = 3.14159265358979323846f;

// Per-point warp: (x, y) = H[b] (u, v, 1) with the perspective divide.
__device__ __forceinline__ void warp_point(const float* __restrict__ grid, const float* __restrict__ H, int B,
                                           int Np, int p, float& u, float& v, int& b, float h[9],
                                           float& rden, float& x, float& y) {
  u = grid[p];
  v = grid[Np + p];
  b = (int)grid[2 * (long long)Np + p];
  const bool valid = b >= 0 && b < B;
#pragma unroll
  for (int j = 0; j < 9; ++j) h[j] = valid ? H[b * 9 + j] : 0.0f;
  rden = 1.0f / (((h[8] + h[6] * u) + h[7] * v) + 1e-8f);
  x = ((h[0] * u + h[1] * v) + h[2]) * rden;
  y = ((h[3] * u + h[4] * v) + h[5]) * rden;
  if (!valid) b = -1;
}

// The point's coordinates: warped from the grid (coords == nullptr, K1) or
// read from coords [2, Np] (K2).
__device__ __forceinline__ void point_xy(const float* __restrict__ grid, const float* __restrict__ H,
                                         const float* __restrict__ coords, int B, int Np, int p, float& x, float& y) {
  if (coords) {
    x = coords[p];
    y = coords[Np + p];
  } else {
    float u, v, h[9], rden;
    int b;
    warp_point(grid, H, B, Np, p, u, v, b, h, rden, x, y);
  }
}

// enc[p] = [x, y, sin(x f_k) w_k, cos(x f_k) w_k, sin(y f_k) w_k,
// cos(y f_k) w_k] (the reference row order, 2 + 4L wide), stored as T in
// rows of ldE (zeros past 2 + 4L).
template <class T>
__global__ void encode_kernel(int Np, int B, int L, int ldE, const float* __restrict__ grid,
                              const float* __restrict__ H, const float* __restrict__ coords,
                              const float* __restrict__ cw, T* __restrict__ enc) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= Np) return;
  const int E = 2 + 4 * L;
  float x, y;
  point_xy(grid, H, coords, B, Np, p, x, y);
  T* e = enc + (long long)p * ldE;
  e[0] = from_f<T>(x);
  e[1] = from_f<T>(y);
  for (int k = 0; k < L; ++k) {
    const float f = ldexpf(PI_F, k);
    const float w = cw[k];
    float sx, cx, sy, cy;
    sincosf(x * f, &sx, &cx);
    sincosf(y * f, &sy, &cy);
    e[2 + k] = from_f<T>(sx * w);
    e[2 + L + k] = from_f<T>(cx * w);
    e[2 + 2 * L + k] = from_f<T>(sy * w);
    e[2 + 3 * L + k] = from_f<T>(cy * w);
  }
  for (int k = E; k < ldE; ++k) e[k] = from_f<T>(0.0f);
}

// Posenc VJP of one point: d = d(encoding) row, returns dx, dy:
//   dx = d_x + sum_k f_k (cos(x f_k) w_k dsin_k - sin(x f_k) w_k dcos_k), same for y.
__device__ __forceinline__ void posenc_vjp(float x, float y, int L, const float* __restrict__ cw,
                                           const float* __restrict__ d, float& dx, float& dy) {
  float sx_acc = 0.0f, sy_acc = 0.0f;
  for (int k = 0; k < L; ++k) {
    const float f = ldexpf(PI_F, k);
    const float w = cw[k];
    float sx, cx, sy, cy;
    sincosf(x * f, &sx, &cx);
    sincosf(y * f, &sy, &cy);
    sx_acc += f * ((cx * w) * d[2 + k] - (sx * w) * d[2 + L + k]);
    sy_acc += f * ((cy * w) * d[2 + 2 * L + k] - (sy * w) * d[2 + 3 * L + k]);
  }
  dx = d[0] + sx_acc;
  dy = d[1] + sy_acc;
}

// The last layer (K -> 3, sigmoid) with the loss and the first backward
// step, per chunk of points:
//   rgb = sigmoid(W X + b); sq = sum_c (rgb - t)^2;
//   loss partial = lscale * sum ((rgb - t) m)^2;
//   dz = dscale (rgb - t) m m rgb (1 - rgb);
//   dX[p, f] = (sum_c dz_c W[c, f]) * (X[p, f] > 0)  (the previous layer's ReLU gate);
//   dW partial [3, K] = sum_p dz X, db partial [3] = sum_p dz.
// With T = bf16, W is read as bf16 and dz and dX are rounded to bf16 (the
// Pallas kernel's cdtype), sums and the loss float32.
template <class T>
__global__ void __launch_bounds__(ELEM_THREADS)
head_kernel(int Np, int K, int chunk, const T* __restrict__ X, const float* __restrict__ W,
            const float* __restrict__ bias, const float* __restrict__ tgt, const float* __restrict__ msk,
            const float* __restrict__ scal, float* __restrict__ rgb, float* __restrict__ sq,
            T* __restrict__ dX, float* __restrict__ part, int part_stride) {
  __shared__ float Ws[3][HEAD_MAX_K];
  __shared__ float dzs[HEAD_POINTS][3];
  __shared__ float warp_loss[HEAD_POINTS];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wid = tid / 32;
  for (int i = tid; i < 3 * K; i += ELEM_THREADS) Ws[i / K][i % K] = round_to<T>(W[i]);
  const float b0 = bias[0], b1 = bias[1], b2 = bias[2];
  const float dscale = scal[0], lscale = scal[1];
  const int p_begin = blockIdx.x * chunk;
  const int p_end = min(Np, p_begin + chunk);

  constexpr int MAXJ = HEAD_MAX_K / ELEM_THREADS;
  float acc[MAXJ][3];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.0f;
  float db0 = 0.0f, db1 = 0.0f, db2 = 0.0f;
  float lacc = 0.0f;  // per-warp loss sum (lane 0)
  __syncthreads();

  for (int t0 = p_begin; t0 < p_end; t0 += HEAD_POINTS) {
    // forward + loss + output cotangent: one warp per point
    const int p = t0 + wid;
    if (p < p_end) {
      const T* xr = X + (long long)p * K;
      float z0 = 0.0f, z1 = 0.0f, z2 = 0.0f;
      for (int f = lane; f < K; f += 32) {
        const float xv = to_f(xr[f]);
        z0 = fmaf(xv, Ws[0][f], z0);
        z1 = fmaf(xv, Ws[1][f], z1);
        z2 = fmaf(xv, Ws[2][f], z2);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        z0 += __shfl_xor_sync(0xffffffffu, z0, off);
        z1 += __shfl_xor_sync(0xffffffffu, z1, off);
        z2 += __shfl_xor_sync(0xffffffffu, z2, off);
      }
      if (lane == 0) {
        const float m = msk[p];
        const float zz[3] = {z0 + b0, z1 + b1, z2 + b2};
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float r = 1.0f / (1.0f + expf(-zz[c]));
          rgb[(long long)c * Np + p] = r;
          const float diff = r - tgt[(long long)c * Np + p];
          s += diff * diff;
          const float dm = diff * m;
          lacc += dm * dm;
          dzs[wid][c] = round_to<T>(dscale * dm * m * (r * (1.0f - r)));
        }
        sq[p] = s;
      }
    } else if (lane == 0) {
      dzs[wid][0] = dzs[wid][1] = dzs[wid][2] = 0.0f;
    }
    __syncthreads();
    // backward into the last hidden layer: one thread per feature
    const int np = min(HEAD_POINTS, p_end - t0);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int f = tid + j * ELEM_THREADS;
      if (f < K) {
        const float w0 = Ws[0][f], w1 = Ws[1][f], w2 = Ws[2][f];
        for (int q = 0; q < np; ++q) {
          const long long idx = (long long)(t0 + q) * K + f;
          const float xv = to_f(X[idx]);
          const float d0 = dzs[q][0], d1 = dzs[q][1], d2 = dzs[q][2];
          const float g = d0 * w0 + d1 * w1 + d2 * w2;
          dX[idx] = from_f<T>(xv > 0.0f ? g : 0.0f);
          acc[j][0] = fmaf(xv, d0, acc[j][0]);
          acc[j][1] = fmaf(xv, d1, acc[j][1]);
          acc[j][2] = fmaf(xv, d2, acc[j][2]);
        }
      }
    }
    if (tid == 0) {
      for (int q = 0; q < np; ++q) {
        db0 += dzs[q][0];
        db1 += dzs[q][1];
        db2 += dzs[q][2];
      }
    }
    __syncthreads();
  }

  // partial layout per block: [dW (3K) | db (3) | loss (1)]
  float* out = part + (long long)blockIdx.x * part_stride;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int f = tid + j * ELEM_THREADS;
    if (f < K) {
      out[f] = acc[j][0];
      out[K + f] = acc[j][1];
      out[2 * K + f] = acc[j][2];
    }
  }
  if (lane == 0) warp_loss[wid] = lacc;
  __syncthreads();
  if (tid == 0) {
    float l = 0.0f;
    for (int w = 0; w < HEAD_POINTS; ++w) l += warp_loss[w];
    out[3 * K] = db0;
    out[3 * K + 1] = db1;
    out[3 * K + 2] = db2;
    out[3 * K + 3] = l * lscale;
  }
}

// K1: posenc VJP + warp VJP per point, reduced per image within the block:
//   dH[b] rows = [dxh u, dxh v, dxh, dyh u, dyh v, dyh, dw u, dw v, dw]
//   with dxh = dx rden, dyh = dy rden, dw = -(dx x + dy y) rden.
__global__ void __launch_bounds__(ELEM_THREADS)
encode_bwd_kernel(int Np, int B, int L, int chunk, const float* __restrict__ grid, const float* __restrict__ H,
                  const float* __restrict__ cw, const float* __restrict__ denc, float* __restrict__ part) {
  __shared__ float red[9][ELEM_THREADS];
  const int tid = threadIdx.x;
  const int E = 2 + 4 * L;
  const int p_begin = blockIdx.x * chunk;
  const int p_end = min(Np, p_begin + chunk);
  float acc[MAX_IMAGES][9];
#pragma unroll
  for (int i = 0; i < MAX_IMAGES; ++i)
#pragma unroll
    for (int j = 0; j < 9; ++j) acc[i][j] = 0.0f;

  for (int p = p_begin + tid; p < p_end; p += ELEM_THREADS) {
    float u, v, h[9], rden, x, y, dx, dy;
    int b;
    warp_point(grid, H, B, Np, p, u, v, b, h, rden, x, y);
    posenc_vjp(x, y, L, cw, denc + (long long)p * E, dx, dy);
    const float dxh = dx * rden, dyh = dy * rden;
    const float dw = -(dx * x + dy * y) * rden;
    const float rows[9] = {dxh * u, dxh * v, dxh, dyh * u, dyh * v, dyh, dw * u, dw * v, dw};
#pragma unroll
    for (int i = 0; i < MAX_IMAGES; ++i) {
      if (i == b) {
#pragma unroll
        for (int j = 0; j < 9; ++j) acc[i][j] += rows[j];
      }
    }
  }

  // fixed-order tree reduction over the block, one image at a time
#pragma unroll
  for (int i = 0; i < MAX_IMAGES; ++i) {
    if (i >= B) break;
#pragma unroll
    for (int j = 0; j < 9; ++j) red[j][tid] = acc[i][j];
    __syncthreads();
    for (int s = ELEM_THREADS / 2; s > 0; s >>= 1) {
      if (tid < s) {
#pragma unroll
        for (int j = 0; j < 9; ++j) red[j][tid] += red[j][tid + s];
      }
      __syncthreads();
    }
    if (tid < 9) part[(long long)blockIdx.x * B * 9 + i * 9 + tid] = red[tid][0];
    __syncthreads();
  }
}

// K2: posenc VJP per point -> dcoords [2, Np].
__global__ void coords_bwd_kernel(int Np, int L, const float* __restrict__ coords, const float* __restrict__ cw,
                                  const float* __restrict__ denc, float* __restrict__ dcoords) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= Np) return;
  float dx, dy;
  posenc_vjp(coords[p], coords[Np + p], L, cw, denc + (long long)p * (2 + 4 * L), dx, dy);
  dcoords[p] = dx;
  dcoords[Np + p] = dy;
}

struct Plan {
  int E, ldE, widest, head_blocks, head_chunk, head_stride, bwd_blocks, bwd_chunk;
  long long enc, acts[MAX_LAYERS], dz[2], dw_part, col_part, head_part, dh_part, total;
  long long wsplit[MAX_LAYERS][2];  // hidden layer l's weights pre-split for its forward [0] and dz [1] products
};

// B = 0 for K2 and K5 (no dH partials). col_part holds the db partials,
// the dW products' row sums. T: the storage type of the encoding and the
// activations (the encoding's rows padded to 16 bytes in bf16, as the bf16
// engine reads them); d(encoding), float32, takes the dz buffer not in use.
template <class T>
Plan make_plan(int Np, int B, int L, int n_layers, const int* dims) {
  using Eng = typename EngineOf<T>::type;
  Plan P{};
  P.E = 2 + 4 * L;
  P.ldE = sizeof(T) == 2 ? round8(P.E) : P.E;
  P.widest = P.E;
  for (int l = 1; l <= n_layers; ++l) P.widest = dims[l] > P.widest ? dims[l] : P.widest;
  Arena a;
  P.enc = a.take_of<T>((long long)Np * P.ldE);
  for (int l = 0; l + 1 < n_layers; ++l) {
    P.acts[l] = a.take_of<T>((long long)Np * dims[l + 1]);
    P.wsplit[l][0] = a.take(Eng::weight_floats(dims[l + 1], dims[l]));
    P.wsplit[l][1] = a.take(Eng::weight_floats(dims[l], dims[l + 1]));
  }
  const long long dz_n = (long long)Np * P.widest * (long long)sizeof(T) / 4;
  P.dz[0] = a.take(dz_n > (long long)Np * P.E ? dz_n : (long long)Np * P.E);
  P.dz[1] = a.take(dz_n > (long long)Np * P.E ? dz_n : (long long)Np * P.E);
  long long dw_max = 0, db_max = 0;
  for (int l = 0; l + 1 < n_layers; ++l) {
    int splits, chunk;
    Eng::dw_split(Np, dims[l + 1], dims[l], 1, splits, chunk);
    const long long parts = Eng::dw_parts(splits, chunk);
    const long long n = parts * dims[l + 1] * dims[l];
    dw_max = n > dw_max ? n : dw_max;
    db_max = parts * dims[l + 1] > db_max ? parts * dims[l + 1] : db_max;
  }
  P.dw_part = a.take(dw_max);
  P.col_part = a.take(db_max);
  const int K = dims[n_layers - 1];
  P.head_blocks = cdiv(Np, 64) < 1024 ? cdiv(Np, 64) : 1024;
  P.head_chunk = cdiv(cdiv(Np, P.head_blocks), HEAD_POINTS) * HEAD_POINTS;
  P.head_blocks = cdiv(Np, P.head_chunk);
  P.head_stride = 3 * K + 4;
  P.head_part = a.take((long long)P.head_blocks * P.head_stride);
  P.bwd_blocks = cdiv(Np, 1024) < 1024 ? cdiv(Np, 1024) : 1024;
  P.bwd_chunk = cdiv(Np, P.bwd_blocks);
  P.bwd_blocks = cdiv(Np, P.bwd_chunk);
  P.dh_part = a.take((long long)P.bwd_blocks * B * 9);
  P.total = a.off;
  return P;
}

// dims[0..n_layers]: the rgb MLP's widths, 2 + 4L in, 3 out
bool valid_rgb_dims(int L, int n_layers, const int* dims) {
  return n_layers >= 2 && n_layers <= MAX_LAYERS && L >= 0 && L <= MAX_L && dims[0] == 2 + 4 * L &&
         dims[n_layers] == 3 && dims[n_layers - 1] <= HEAD_MAX_K;
}

// The shared pipeline. K1: grid/H given, coords == nullptr, writes dH.
// K2 and K5: coords given, grid/H unused, writes dcoords. T: the storage
// type (float32, or bf16 under compute_dtype = bfloat16).
template <class T>
int fused_step(int Np, int B, int L, int n_layers, const int* dims, const float* grid, const float* H,
               const float* coords, const float* cw, const float* tgt, const float* msk, const float* scal,
               const float* const* W, const float* const* bias, float* rgb, float* sq, float* loss,
               float* const* dW, float* const* db, float* dH, float* dcoords, float* ws, cudaStream_t st) {
  using Eng = typename EngineOf<T>::type;
  if (!valid_rgb_dims(L, n_layers, dims)) return (int)cudaErrorInvalidValue;
  const Plan P = make_plan<T>(Np, B, L, n_layers, dims);
  const int last = n_layers - 1;
  T* enc = reinterpret_cast<T*>(ws + P.enc);
  auto act = [&](int l) { return reinterpret_cast<T*>(ws + P.acts[l]); };

  // ---- the hidden layers' weights, split into TF32 hi and lo (or
  // converted to bf16) once for every block of their forward and dz products
  for (int l = 0; l < last; ++l) {
    const int rc = presplit_one<Eng>(st, W[l], dims[l + 1], dims[l], ws + P.wsplit[l][0], ws + P.wsplit[l][1]);
    if (rc) return rc;
  }

  // ---- forward
  encode_kernel<T><<<cdiv(Np, ELEM_THREADS), ELEM_THREADS, 0, st>>>(Np, B, L, P.ldE, grid, H, coords, cw, enc);
  MARF_CHECK_LAUNCH();
  for (int l = 0; l < last; ++l) {
    const T* in = l == 0 ? enc : act(l - 1);
    GemmCall c = gemm_call(Np, dims[l + 1], dims[l], in, l == 0 ? P.ldE : dims[l], ws + P.wsplit[l][0], 0, act(l),
                           dims[l + 1]);
    c.bias[0] = bias[l];
    const int rc = Eng::template run_presplit<EPI_BIAS_RELU>(st, c);
    if (rc) return rc;
  }

  // ---- head: rgb, sq, loss, dz of the last hidden layer, dW/db of the last layer
  const int K = dims[last];
  T* dz_cur = reinterpret_cast<T*>(ws + P.dz[0]);
  head_kernel<T><<<P.head_blocks, ELEM_THREADS, 0, st>>>(Np, K, P.head_chunk, act(last - 1), W[last], bias[last],
                                                          tgt, msk, scal, rgb, sq, dz_cur, ws + P.head_part,
                                                          P.head_stride);
  MARF_CHECK_LAUNCH();
  reduce(st, P.head_blocks, 3 * K, P.head_stride, ws + P.head_part, dW[last]);
  MARF_CHECK_LAUNCH();
  reduce(st, P.head_blocks, 3, P.head_stride, ws + P.head_part + 3 * K, db[last]);
  MARF_CHECK_LAUNCH();
  reduce(st, P.head_blocks, 1, P.head_stride, ws + P.head_part + 3 * K + 3, loss);
  MARF_CHECK_LAUNCH();

  // ---- backward through the hidden layers
  int cur = 0;
  for (int l = last - 1; l >= 0; --l) {
    const int out = dims[l + 1], in = dims[l];
    const T* x_in = l == 0 ? enc : act(l - 1);
    dz_cur = reinterpret_cast<T*>(ws + P.dz[cur]);
    // dW[l] = dz^T x_in, split over points, then a fixed-order sum of the
    // partials (db: the row sums of dz folded into this product)
    int splits, chunk;
    Eng::dw_split(Np, out, in, 1, splits, chunk);
    const int parts = Eng::dw_parts(splits, chunk);
    GemmCall c = gemm_call(out, in, Np, dz_cur, out, x_in, l == 0 ? P.ldE : in, ws + P.dw_part, in);
    c.splits = splits, c.k_chunk = chunk, c.c_split_stride = (long long)out * in;
    c.rsum[0] = ws + P.col_part;
    int rc = Eng::template run<false, true, EPI_STORE>(st, c);
    if (rc) return rc;
    Eng::reduce_parts(st, 1, parts, out * in, (long long)out * in, ws + P.dw_part, 0, one_ptr(dW[l]));
    MARF_CHECK_LAUNCH();
    Eng::reduce_parts(st, 1, parts, out, out, ws + P.col_part, 0, one_ptr(db[l]));
    MARF_CHECK_LAUNCH();
    // dz of the layer below (ReLU-gated by its activation, stored as T), or
    // d(encoding) (float32)
    void* dz_next = ws + P.dz[cur ^ 1];
    GemmCall d = gemm_call(Np, in, out, dz_cur, out, ws + P.wsplit[l][1], 0, dz_next, in);
    if (l > 0) {
      d.gate[0] = act(l - 1), d.ldg = in;
      rc = Eng::template run_presplit<EPI_GATE>(st, d);
    } else {
      rc = Eng::template run_presplit<EPI_STORE>(st, d);
    }
    if (rc) return rc;
    cur ^= 1;
  }

  // ---- posenc VJP -> dcoords (K2), or posenc + warp VJP -> dH (K1)
  if (coords) {
    coords_bwd_kernel<<<cdiv(Np, ELEM_THREADS), ELEM_THREADS, 0, st>>>(Np, L, coords, cw, ws + P.dz[cur], dcoords);
    MARF_CHECK_LAUNCH();
    return 0;
  }
  encode_bwd_kernel<<<P.bwd_blocks, ELEM_THREADS, 0, st>>>(Np, B, L, P.bwd_chunk, grid, H, cw, ws + P.dz[cur],
                                                            ws + P.dh_part);
  MARF_CHECK_LAUNCH();
  reduce(st, P.bwd_blocks, B * 9, (long long)B * 9, ws + P.dh_part, dH);
  MARF_CHECK_LAUNCH();
  return 0;
}

}  // namespace
