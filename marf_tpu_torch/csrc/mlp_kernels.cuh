// Building blocks shared by the port's MLP kernels (fused_step.cu,
// fused_mask.cu, fused_implicit.cu), float32, sm_90a:
//   - sgemm_kernel: tiled SIMT SGEMM (128x128 block tile, 8x8 outputs per
//     thread, double-buffered shared memory, fmaf with float32 accumulation;
//     no TF32, no library GEMM) with bias+ReLU, ReLU-gate or plain-store
//     epilogues and split-K partials; the engine of K3 and K4 (SimtEngine);
//   - GemmCall: one product shape over up to MAX_GROUP operand sets (one per
//     mask head), the argument of both engines' `run` (SimtEngine here,
//     TcEngine in tc_gemm.cuh), so the pipelines are templates over the engine;
//   - colsum_kernel, reduce_kernel, reduce_group_kernel and
//     reduce_tree_group_kernel: the stages of every reduction over points.
//     Partials go to a workspace and are summed in a fixed order (in
//     sequence, or pairwise for the tensor-core engine's many dW partials),
//     so there are no float atomics and two calls on the same inputs give
//     bitwise-equal outputs;
//   - row_dot: one warp's dot product of a point's row with a weight row,
//     reduced by a fixed shuffle tree (the 256->1 and 256->3 head layers,
//     which would waste a 128-wide GEMM tile).
// Layouts: weights are nn.Linear's [out, in], row-major; activations are
// point-major [N, width] unless a GEMM's layout flags say otherwise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // GEMM block tile rows
constexpr int BN = 128;  // GEMM block tile columns
constexpr int BK = 8;    // GEMM depth per stage
constexpr int PADS = 4;  // shared-memory row padding (bank spread, keeps float4 alignment)
constexpr int GEMM_THREADS = 256;
constexpr int ELEM_THREADS = 256;
constexpr int HEAD_POINTS = 8;   // points per head-kernel tile (one per warp)
constexpr int HEAD_MAX_K = 1024; // widest last hidden layer a head kernel takes
constexpr int MAX_LAYERS = 16;
constexpr int SPLIT_TARGET_BLOCKS = 264;  // 2 blocks per SM on 132 SMs
constexpr int COLSUM_SPLITS = 128;
constexpr int MAX_GROUP = 16;  // operand sets (mask heads) per grouped launch

enum Epilogue { EPI_STORE = 0, EPI_BIAS_RELU = 1, EPI_GATE = 2 };

// C[M, N] (+)= A[M, K] * B[K, N] over k in this block's split.
// A(m, k) = A_K_CONTIG ? A[m*lda + k] : A[k*lda + m]
// B(k, n) = B_N_CONTIG ? B[k*ldb + n] : B[n*ldb + k]
// blockIdx.z selects a split of K of length k_chunk; its output goes to
// C + z*c_split_stride (the split-K partials of the dW products).
// Two blocks per SM: at more than 128 registers a thread only one fits.
template <bool A_K_CONTIG, bool B_N_CONTIG, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
sgemm_kernel(int M, int N, int K,
             const float* __restrict__ A, int lda,
             const float* __restrict__ B, int ldb,
             float* __restrict__ C, int ldc,
             const float* __restrict__ bias,
             const float* __restrict__ gate, int ldg,
             int k_chunk, long long c_split_stride) {
  __shared__ __align__(16) float As[2][BK][BM + PADS];
  __shared__ __align__(16) float Bs[2][BK][BN + PADS];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k0 = blockIdx.z * k_chunk;
  const int k1 = min(K, k0 + k_chunk);
  C += (long long)blockIdx.z * c_split_stride;

  float ra[4], rb[4];
  auto load_tiles = [&](int kt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * GEMM_THREADS;
      int mm, kk;
      if (A_K_CONTIG) { kk = e % BK; mm = e / BK; } else { mm = e % BM; kk = e / BM; }
      const int m = m0 + mm, k = kt + kk;
      ra[r] = (m < M && k < k1) ? (A_K_CONTIG ? A[(long long)m * lda + k] : A[(long long)k * lda + m]) : 0.0f;
      int nn;
      if (B_N_CONTIG) { nn = e % BN; kk = e / BN; } else { kk = e % BK; nn = e / BK; }
      const int n = n0 + nn, k2 = kt + kk;
      rb[r] = (n < N && k2 < k1) ? (B_N_CONTIG ? B[(long long)k2 * ldb + n] : B[(long long)n * ldb + k2]) : 0.0f;
    }
  };
  auto store_tiles = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * GEMM_THREADS;
      int mm, kk;
      if (A_K_CONTIG) { kk = e % BK; mm = e / BK; } else { mm = e % BM; kk = e / BM; }
      As[buf][kk][mm] = ra[r];
      int nn;
      if (B_N_CONTIG) { nn = e % BN; kk = e / BN; } else { kk = e % BK; nn = e / BK; }
      Bs[buf][kk][nn] = rb[r];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (k0 < k1) {
    load_tiles(k0);
    store_tiles(0);
  }
  __syncthreads();
  int buf = 0;
  for (int kt = k0; kt < k1; kt += BK) {
    const bool has_next = kt + BK < k1;
    if (has_next) load_tiles(kt + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (has_next) store_tiles(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n >= N) continue;
      float v = acc[i][j];
      if (EPI == EPI_BIAS_RELU) v = fmaxf(v + bias[n], 0.0f);
      if (EPI == EPI_GATE) v = gate[(long long)m * ldg + n] > 0.0f ? v : 0.0f;
      C[(long long)m * ldc + n] = v;
    }
  }
}

// Column sums of D [Np, ncol] over one split of points -> part[split][ncol].
__global__ void colsum_kernel(int Np, int ncol, int chunk, const float* __restrict__ D, float* __restrict__ part) {
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const int p_begin = blockIdx.x * chunk;
  const int p_end = min(Np, p_begin + chunk);
  float s = 0.0f;
  for (int p = p_begin; p < p_end; ++p) s += D[(long long)p * ncol + col];
  part[(long long)blockIdx.x * ncol + col] = s;
}

// out[i] = sum_{z < S} part[z*stride + i], in fixed order of z.
__global__ void reduce_kernel(int S, int count, long long stride, const float* __restrict__ part,
                              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.0f;
  for (int z = 0; z < S; ++z) s += part[(long long)z * stride + i];
  out[i] = s;
}

// One pointer per group (mask head), passed by value.
struct GroupPtrs {
  float* p[MAX_GROUP];
};
struct GroupConstPtrs {
  const float* p[MAX_GROUP];
};

// a[h] of a kernel parameter's pointer table for a block-uniform h.
// Indexing a parameter array at run time makes the compiler copy it to
// local memory in every thread (an 8x slower head pass on an H100);
// constant-index selects keep it in parameter space.
template <class T>
__device__ __forceinline__ T pick(const T (&a)[MAX_GROUP], int h) {
  T r = a[0];
#pragma unroll
  for (int i = 1; i < MAX_GROUP; ++i) r = i == h ? a[i] : r;
  return r;
}

template <class Ptrs>
__device__ __forceinline__ auto pick(const Ptrs& t, int h) -> decltype(+t.p[0]) {
  return pick(t.p, h);
}

// reduce_kernel per group g = blockIdx.y: out.p[g][i] = sum_z part[g*gstride + z*stride + i]
// (the same fixed order, so one group gives reduce_kernel's bits).
__global__ void reduce_group_kernel(int S, int count, long long stride, const float* __restrict__ part,
                                    long long gstride, GroupPtrs out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float* q = part + (long long)blockIdx.y * gstride;
  float s = 0.0f;
  for (int z = 0; z < S; ++z) s += q[(long long)z * stride + i];
  pick(out, blockIdx.y)[i] = s;
}

// reduce_group_kernel's sums taken pairwise: part z goes onto a stack of
// sums of 2^j consecutive parts, merging equal sizes as a binary counter
// does ((p0 + p1) + (p2 + p3)) + ...; a fixed order whose rounding error
// grows with log2(S), not with S. Eight parts are loaded at a time (their
// three levels of the tree in registers), so eight loads are in flight.
__global__ void reduce_tree_group_kernel(int S, int count, long long stride, const float* __restrict__ part,
                                         long long gstride, GroupPtrs out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float* q = part + (long long)blockIdx.y * gstride + i;
  float st[32];
  int n = 0;
  int z = 0;
  for (; z + 8 <= S; z += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = q[(long long)(z + j) * stride];
    float s = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
    for (int b = (z + 7) >> 3; b & 1; b >>= 1) s = st[--n] + s;
    st[n++] = s;
  }
  for (; z < S; ++z) {
    float s = q[(long long)z * stride];
    for (int b = z; b & 1; b >>= 1) s = st[--n] + s;
    st[n++] = s;
  }
  float s = st[--n];
  while (n > 0) s = st[--n] + s;
  pick(out, blockIdx.y)[i] = s;
}

// One warp: dot(x[0:F], w[0:F]) with lane-strided partial sums and a fixed
// xor-shuffle tree; lane 0's value is the one callers use.
__device__ __forceinline__ float row_dot(const float* __restrict__ x, const float* w, int F, int lane) {
  float z = 0.0f;
  for (int f = lane; f < F; f += 32) z = fmaf(x[f], w[f], z);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
  return z;
}

__device__ __forceinline__ float sigmoidf_(float z) { return 1.0f / (1.0f + expf(-z)); }

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// split-K layout of the dW products of `groups` layers [out, in] over Np
// points each (SimtEngine's; TcEngine has its own)
inline void simt_dw_split(int Np, int out, int in, int groups, int& splits, int& chunk) {
  const int tiles = groups * cdiv(out, BM) * cdiv(in, BN);
  int s = cdiv(SPLIT_TARGET_BLOCKS, tiles);
  chunk = cdiv(cdiv(Np, s), BK) * BK;
  splits = cdiv(Np, chunk);
}

// float offsets of one call's workspace, each aligned to 4 floats
struct Arena {
  long long off = 0;
  long long take(long long n) {
    long long o = off;
    off += (n + 3) / 4 * 4;
    return o;
  }
};

// One product shape C[M, N] (+)= A[M, K] B[K, N] for `groups` operand sets
// (the layouts are the engines' template flags, as sgemm_kernel's). Split z
// of K (length k_chunk) writes its partials from C[g] + z*c_split_stride on
// (one per split; TcEngine: E::dw_parts(splits, k_chunk) / splits of them);
// rsum[g], where set, gets the row sums of A likewise, M apart (TcEngine
// only: the db of a dW product, folded into it).
struct GemmCall {
  int groups, M, N, K, lda, ldb, ldc, ldg, splits, k_chunk;
  long long c_split_stride;
  const float* A[MAX_GROUP];
  const float* B[MAX_GROUP];
  float* C[MAX_GROUP];
  const float* bias[MAX_GROUP];
  const float* gate[MAX_GROUP];
  float* rsum[MAX_GROUP];
};

// A one-group call, no split; the caller fills in what else it needs.
inline GemmCall gemm_call(int M, int N, int K, const float* A, int lda, const float* B, int ldb, float* C, int ldc) {
  GemmCall c{};
  c.groups = 1;
  c.M = M, c.N = N, c.K = K, c.lda = lda, c.ldb = ldb, c.ldc = ldc;
  c.splits = 1, c.k_chunk = K;
  c.A[0] = A, c.B[0] = B, c.C[0] = C;
  return c;
}

void reduce(cudaStream_t st, int S, int count, long long stride, const float* part, float* out) {
  reduce_kernel<<<cdiv(count, ELEM_THREADS), ELEM_THREADS, 0, st>>>(S, count, stride, part, out);
}

// reduce() for `groups` partial blocks gstride apart, into out.p[g]
void reduce_group(cudaStream_t st, int groups, int S, int count, long long stride, const float* part,
                  long long gstride, const GroupPtrs& out) {
  reduce_group_kernel<<<dim3(cdiv(count, ELEM_THREADS), groups), ELEM_THREADS, 0, st>>>(S, count, stride, part,
                                                                                         gstride, out);
}

// GroupPtrs holding one pointer
inline GroupPtrs one_ptr(float* p) {
  GroupPtrs g{};
  g.p[0] = p;
  return g;
}

// The SIMT float32 engine: one sgemm_kernel launch on one operand set (its
// pipelines, K3 and K4, run one head); no folded db (the pipelines take the
// column sums with colsum). A dW product writes one partial per split,
// summed in sequence.
struct SimtEngine {
  static constexpr bool kFoldDb = false;
  static void dw_split(int Np, int out, int in, int groups, int& splits, int& chunk) {
    simt_dw_split(Np, out, in, groups, splits, chunk);
  }
  static int dw_parts(int splits, int /*chunk*/) { return splits; }
  static void reduce_parts(cudaStream_t st, int groups, int S, int count, long long stride, const float* part,
                           long long gstride, const GroupPtrs& out) {
    reduce_group(st, groups, S, count, stride, part, gstride, out);
  }
  template <bool AK, bool BNC, int EPI>
  static int run(cudaStream_t st, const GemmCall& c) {
    if (c.groups != 1 || c.rsum[0]) return (int)cudaErrorInvalidValue;
    dim3 grid(cdiv(c.M, BM), cdiv(c.N, BN), c.splits);
    sgemm_kernel<AK, BNC, EPI><<<grid, GEMM_THREADS, 0, st>>>(c.M, c.N, c.K, c.A[0], c.lda, c.B[0], c.ldb, c.C[0],
                                                             c.ldc, c.bias[0], c.gate[0], c.ldg, c.k_chunk,
                                                             c.c_split_stride);
    return (int)cudaGetLastError();
  }
};

// db = column sums of dz [Np, out], in two fixed-order stages
void colsum(cudaStream_t st, int Np, int out, int chunk, const float* dz, float* part, float* db) {
  dim3 cgrid(cdiv(Np, chunk), cdiv(out, ELEM_THREADS));
  colsum_kernel<<<cgrid, ELEM_THREADS, 0, st>>>(Np, out, chunk, dz, part);
  reduce(st, cdiv(Np, chunk), out, out, part, db);
}

}  // namespace

#define MARF_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)
