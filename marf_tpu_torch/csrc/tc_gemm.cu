// C entry points to the tensor-core GEMM engines (tc_gemm.cuh), the 3xTF32
// one (marf_tc_*) and the bf16 one (marf_tb_*), so that every operand
// layout and epilogue, and the weights' pre-split, can be held to their
// plain versions on the card (tests/test_torch_tc_gemm.py) apart from the
// kernels that use them. No kernel of the train step calls them.

#include "tc_gemm.cuh"

namespace {

template <class Eng, bool AK, bool BNC>
int run_epi(cudaStream_t st, int epi, const GemmCall& c) {
  switch (epi) {
    case EPI_STORE: return Eng::template run<AK, BNC, EPI_STORE>(st, c);
    case EPI_BIAS_RELU: return Eng::template run<AK, BNC, EPI_BIAS_RELU>(st, c);
    case EPI_GATE: return Eng::template run<AK, BNC, EPI_GATE>(st, c);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class Eng>
int run_presplit_epi(cudaStream_t st, int epi, const GemmCall& c) {
  switch (epi) {
    case EPI_STORE: return Eng::template run_presplit<EPI_STORE>(st, c);
    case EPI_BIAS_RELU: return Eng::template run_presplit<EPI_BIAS_RELU>(st, c);
    case EPI_GATE: return Eng::template run_presplit<EPI_GATE>(st, c);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The split-K layout of K into `splits` (at most) chunks aligned to Eng's k-tile.
// n (1 to PRESPLIT_MAX) weights W[e] [rows[e], cols[e]] pre-split on engine
// Eng in one launch, each into fwd[e] and dz[e].
template <class Eng>
int presplit_table(int n, const float* const* W, const int* rows, const int* cols, float* const* fwd,
                   float* const* dz, void* stream) {
  if (n < 1 || n > PRESPLIT_MAX) return (int)cudaErrorInvalidValue;
  PresplitTable t{};
  for (int e = 0; e < n; ++e) {
    if (rows[e] < 1 || cols[e] < 1) return (int)cudaErrorInvalidValue;
    presplit_add(t, W[e], rows[e], cols[e], fwd[e], dz[e]);
  }
  return Eng::presplit((cudaStream_t)stream, t);
}

template <class Eng>
void split_k(int K, int splits, int& n, int& chunk) {
  chunk = cdiv(cdiv(K, splits), Eng::k_tile) * Eng::k_tile;
  n = cdiv(K, chunk);
}

// Floats of workspace a product needs on engine Eng: the partials and their
// row sums (0 when the product writes C directly).
template <class Eng>
long long gemm_workspace(int M, int N, int K, int splits, int rowsum) {
  int n, chunk;
  split_k<Eng>(K, splits, n, chunk);
  const long long parts = Eng::dw_parts(n, chunk);
  return parts > 1 || rowsum ? parts * M * N + parts * M : 0;
}

// One product on engine Eng (marf_tc_gemm's contract; C float32 where the
// product is staged, else Eng's output type for the epilogue).
template <class Eng>
int gemm(int a_k_contig, int b_n_contig, int b_split, int epi, int M, int N, int K, const void* A, int lda,
         const void* B, int ldb, void* C, int ldc, const float* bias, const void* gate, int ldg, int splits,
         float* rsum, float* ws, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || (rsum && a_k_contig)) return (int)cudaErrorInvalidValue;
  if (b_split && (!a_k_contig || splits > 1 || rsum)) return (int)cudaErrorInvalidValue;
  int n, chunk;
  split_k<Eng>(K, splits, n, chunk);
  const int parts = Eng::dw_parts(n, chunk);
  const bool staged = parts > 1 || rsum;
  if (staged && (epi != EPI_STORE || ldc != N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  GemmCall c = gemm_call(M, N, K, A, lda, B, ldb, staged ? ws : C, ldc);
  c.bias[0] = bias, c.gate[0] = gate, c.ldg = ldg;
  if (staged) {
    c.splits = n, c.k_chunk = chunk;
    c.c_split_stride = (long long)M * N;
    if (rsum) c.rsum[0] = ws + (long long)parts * M * N;
  }
  int rc = b_split      ? run_presplit_epi<Eng>(st, epi, c)
           : a_k_contig ? (b_n_contig ? run_epi<Eng, true, true>(st, epi, c) : run_epi<Eng, true, false>(st, epi, c))
                        : (b_n_contig ? run_epi<Eng, false, true>(st, epi, c) : run_epi<Eng, false, false>(st, epi, c));
  if (rc || !staged) return rc;
  Eng::reduce_parts(st, 1, parts, M * N, (long long)M * N, ws, 0, one_ptr(static_cast<float*>(C)));  // fixed order
  MARF_CHECK_LAUNCH();
  if (rsum) {
    Eng::reduce_parts(st, 1, parts, M, M, c.rsum[0], 0, one_ptr(rsum));
    MARF_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace

extern "C" {

long long marf_tc_gemm_workspace(int M, int N, int K, int splits, int rowsum) {
  return gemm_workspace<TcEngine>(M, N, K, splits, rowsum);
}

// C[M, N] = epi(A B) on the tensor cores; A(m, k) = a_k_contig ? A[m*lda + k]
// : A[k*lda + m], B(k, n) = b_n_contig ? B[k*ldb + n] : B[n*ldb + k];
// epi 0 store, 1 bias + ReLU (bias [N]), 2 ReLU gate (gate [M, ldg]).
// splits > 1, or K over 2,048 (store only, ldc = N; beyond one split,
// A point-major only): split-K partials in ws, one per 2,048 deep of each
// split, then their pairwise sum.
// rsum [M] (nullptr: none; A point-major only): the row sums of A, folded
// into the product as in the dW products.
// b_split: B is pre-split (marf_tc_presplit's output for this product, ldb
// unused; A K-major only, depth at most 2,048, no splits, no row sums).
int marf_tc_gemm(int a_k_contig, int b_n_contig, int b_split, int epi, int M, int N, int K, const float* A, int lda,
                 const float* B, int ldb, float* C, int ldc, const float* bias, const float* gate, int ldg, int splits,
                 float* rsum, float* ws, void* stream) {
  return gemm<TcEngine>(a_k_contig, b_n_contig, b_split, epi, M, N, K, A, lda, B, ldb, C, ldc, bias, gate, ldg, splits,
                        rsum, ws, stream);
}

// The pre-split product (marf_tc_gemm with b_split: layout "mk,nk" or
// "mk,kn", no splits, no row sums) over `groups` operand sets in one launch,
// as the mask heads' grouped products: group g's A at A + g a_gs, its
// pre-split B at B + g b_gs, C at C + g c_gs, bias at bias + g N, gate at
// gate + g g_gs.
int marf_tc_gemm_presplit_groups(int epi, int groups, int M, int N, int K, const float* A, int lda, long long a_gs,
                                 const float* B, long long b_gs, float* C, int ldc, long long c_gs, const float* bias,
                                 const float* gate, int ldg, long long g_gs, void* stream) {
  if (groups < 1 || groups > MAX_GROUP || M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  GemmCall c = gemm_call(M, N, K, A, lda, B, 0, C, ldc);
  c.groups = groups, c.ldg = ldg;
  for (int g = 0; g < groups; ++g) {
    c.A[g] = A + g * a_gs, c.B[g] = B + g * b_gs, c.C[g] = C + g * c_gs;
    c.bias[g] = bias ? bias + (long long)g * N : nullptr;
    c.gate[g] = gate ? gate + g * g_gs : nullptr;
  }
  return run_presplit_epi<TcEngine>((cudaStream_t)stream, epi, c);
}

// Floats of the pre-split B of a product of N columns and depth K.
long long marf_tc_presplit_floats(int N, int K) { return presplit_floats(N, K); }

// Each of n weights W[e] [rows[e], cols[e]] (row-major) pre-split as the B
// of its forward product ("mk,nk", N = rows, K = cols) into fwd[e] and of
// its dz product ("mk,kn", N = cols, K = rows) into dz[e], in one launch.
int marf_tc_presplit(int n, const float* const* W, const int* rows, const int* cols, float* const* fwd,
                     float* const* dz, void* stream) {
  return presplit_table<TcEngine>(n, W, rows, cols, fwd, dz, stream);
}

// The bf16 engine (TbEngine), marf_tc_gemm's contract with A, B and gate
// bf16 (every row 16-byte aligned: leading dimensions multiples of 8) and C
// float32 for the store epilogue (and every staged product), bf16 after
// bias + ReLU or the gate; b_split: B is marf_tb_presplit's output.
long long marf_tb_gemm_workspace(int M, int N, int K, int splits, int rowsum) {
  return gemm_workspace<TbEngine>(M, N, K, splits, rowsum);
}

int marf_tb_gemm(int a_k_contig, int b_n_contig, int b_split, int epi, int M, int N, int K, const void* A, int lda,
                 const void* B, int ldb, void* C, int ldc, const float* bias, const void* gate, int ldg, int splits,
                 float* rsum, float* ws, void* stream) {
  return gemm<TbEngine>(a_k_contig, b_n_contig, b_split, epi, M, N, K, A, lda, B, ldb, C, ldc, bias, gate, ldg, splits,
                        rsum, ws, stream);
}

// Floats of the bf16 pre-converted B of a product of N columns and depth K.
long long marf_tb_presplit_floats(int N, int K) { return presplit_bf16_floats(N, K); }

// Each of n weights W[e] (row-major float32) converted to bf16 tiles as the
// B of its forward product into fwd[e] and of its dz product into dz[e], in
// one launch.
int marf_tb_presplit(int n, const float* const* W, const int* rows, const int* cols, float* const* fwd,
                     float* const* dz, void* stream) {
  return presplit_table<TbEngine>(n, W, rows, cols, fwd, dz, stream);
}

}  // extern "C"
