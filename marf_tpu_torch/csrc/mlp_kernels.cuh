// Building blocks shared by the port's MLP kernels (fused_step.cu,
// fused_mask.cu, fused_implicit.cu), sm_90a, beside the GEMM engines of
// tc_gemm.cuh:
//   - GemmCall: one product shape over up to MAX_GROUP operand sets (one per
//     mask head), the argument of the engine's `run`;
//   - colsum_kernel, reduce_group_kernel and
//     reduce_tree_group_kernel: the stages of every reduction over points.
//     Partials go to a workspace and are summed in a fixed order (in
//     sequence, or pairwise for the engine's many dW partials), so there
//     are no float atomics and two calls on the same inputs give
//     bitwise-equal outputs;
//   - row_dot: one warp's dot product of a point's row with a weight row,
//     reduced by a fixed shuffle tree (the 256->1 and 256->3 head layers,
//     which would waste a 128-wide GEMM tile);
//   - the storage types: activations are float32, or bf16 under
//     compute_dtype = bfloat16 (to_f, from_f, round_to); every sum is float32.
// Layouts: weights are nn.Linear's [out, in], row-major; activations are
// point-major [N, width] unless a GEMM's layout flags say otherwise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ELEM_THREADS = 256;
constexpr int HEAD_POINTS = 8;   // points per head-kernel tile (one per warp)
constexpr int HEAD_MAX_K = 1024; // widest last hidden layer a head kernel takes
constexpr int MAX_LAYERS = 16;
constexpr int COLSUM_SPLITS = 128;
constexpr int MAX_GROUP = 16;  // operand sets (mask heads) per grouped launch

enum Epilogue { EPI_STORE = 0, EPI_BIAS_RELU = 1, EPI_GATE = 2 };

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

// Per group g = blockIdx.y: out.p[g][i] = sum_{z < S} part[g*gstride + z*stride + i], in fixed
// order of z.
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

// A stored value as float32, and a float32 value stored as T (bf16: round to
// nearest even, as JAX's astype and torch's .to(torch.bfloat16)).
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
// x rounded to T, as a float (a float32 weight as a T-typed product reads it)
template <class T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// One warp: dot(x[0:F], w[0:F]) with lane-strided partial sums and a fixed
// xor-shuffle tree; lane 0's value is the one callers use.
template <class T>
__device__ __forceinline__ float row_dot(const T* __restrict__ x, const float* w, int F, int lane) {
  float z = 0.0f;
  for (int f = lane; f < F; f += 32) z = fmaf(to_f(x[f]), w[f], z);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
  return z;
}

__device__ __forceinline__ float sigmoidf_(float z) { return 1.0f / (1.0f + expf(-z)); }

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// float offsets of one call's workspace, each aligned to 4 floats (16 bytes)
struct Arena {
  long long off = 0;
  long long take(long long n) {
    long long o = off;
    off += (n + 3) / 4 * 4;
    return o;
  }
  // room for n values of type T
  template <class T>
  long long take_of(long long n) {
    return take((n * (long long)sizeof(T) + 3) / 4);
  }
};

// n rounded up to a multiple of 8: the row stride of a bf16 operand (16 bytes)
__host__ __device__ inline int round8(int n) { return (n + 7) / 8 * 8; }

// One product shape C[M, N] (+)= A[M, K] B[K, N] for `groups` operand sets
// (the layouts are the engine's template flags, tc_gemm_kernel's). A, B,
// C and gate lie as the engine reads them: float32 on the 3xTF32 engine; on
// the bf16 engine A, B and gate bf16, C float32 for a plain store and bf16
// after bias + ReLU or the gate. Split z
// of K (length k_chunk) writes its partials from C[g] + z*c_split_stride on
// (TcEngine::dw_parts(splits, k_chunk) / splits of them); rsum[g], where
// set, gets the row sums of A likewise, M apart (the db of a dW product,
// folded into it).
struct GemmCall {
  int groups, M, N, K, lda, ldb, ldc, ldg, splits, k_chunk;
  long long c_split_stride;
  const void* A[MAX_GROUP];
  const void* B[MAX_GROUP];
  void* C[MAX_GROUP];
  const float* bias[MAX_GROUP];
  const void* gate[MAX_GROUP];
  float* rsum[MAX_GROUP];
};

// A one-group call, no split; the caller fills in what else it needs.
inline GemmCall gemm_call(int M, int N, int K, const void* A, int lda, const void* B, int ldb, void* C, int ldc) {
  GemmCall c{};
  c.groups = 1;
  c.M = M, c.N = N, c.K = K, c.lda = lda, c.ldb = ldb, c.ldc = ldc;
  c.splits = 1, c.k_chunk = K;
  c.A[0] = A, c.B[0] = B, c.C[0] = C;
  return c;
}

// `groups` blocks of S partials gstride apart, each summed into out.p[g]
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

// out[i] = sum_{z < S} part[z*stride + i], in fixed order of z: reduce_group at one group
void reduce(cudaStream_t st, int S, int count, long long stride, const float* part, float* out) {
  reduce_group(st, 1, S, count, stride, part, 0, one_ptr(out));
}

// the column sums of D [Np, ncol] (K5's sum of m), in two fixed-order stages
void colsum(cudaStream_t st, int Np, int ncol, int chunk, const float* D, float* part, float* sums) {
  dim3 cgrid(cdiv(Np, chunk), cdiv(ncol, ELEM_THREADS));
  colsum_kernel<<<cgrid, ELEM_THREADS, 0, st>>>(Np, ncol, chunk, D, part);
  reduce(st, cdiv(Np, chunk), ncol, ncol, part, sums);
}

}  // namespace

#define MARF_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)
