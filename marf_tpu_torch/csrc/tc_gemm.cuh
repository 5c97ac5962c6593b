// The tensor-core GEMM engines for Hopper (sm_90a). The 3xTF32 engine
// (TcEngine, described first): float32-accurate products, the float32 GEMM
// engine of K1 and K2 (fused_step.cu), K3, K4 and K6 (fused_mask.cu) and K5
// (fused_implicit.cu). The bf16 engine (TbEngine, below TB_BK): bf16
// operands with float32 products and sums, the GEMM engine of K1-K4 at
// compute_dtype = bfloat16. EngineOf<T> names a pipeline's engine by the
// storage type of its activations.
//
// Arithmetic. Each float32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), tf32() rounding to nearest with ties away from zero and the
// low 13 mantissa bits cleared (what PTX cvt.rna.tf32.f32 gives; tf32_rna
// below computes it with two integer operations, bit for bit the same on
// finite inputs). Each k8 step takes lo_a hi_b, then hi_a lo_b, then
// hi_a hi_b (small terms first); lo_a lo_b, some 2^-22 of the product, is
// dropped. The tensor cores truncate when they accumulate, so a sum kept
// inside them over thousands of points (a dW split) drifts by about an ulp
// of the running sum per step (2.7e-6 of the max-abs over 480 points, 14x
// cuBLAS's float32 error, on an H100): each k-tile's 12 products go into a
// fresh accumulator, which one float32 add (round to nearest) per element
// then takes into the running sum. A long serial float32 sum loses accuracy
// too: a dW product (and the row sums folded into it) writes a partial per
// TC_FLUSH k-tiles of its split, and reduce_tree_group_kernel adds the
// partials pairwise. At K6's real dW split (43,200 points, 7,200 a split)
// the product and its row sums are within twice float32 torch's distance
// from float64 (tests/test_torch_tc_gemm.py: a numpy emulation of this
// arithmetic on the CPU, the kernel on a card). K6's own gradients can sit
// farther from float64 than its plain version's on some layers: a ReLU that
// flips on an activation near 0 moves them by ~1e-5 of their max-abs, as a
// forward perturbed by float32 rounding does (PERF.md). A single TF32
// product keeps ~3 decimal digits and is not used anywhere.
//
// Instruction: wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32 (N = 128,
// or 64), three per k8 step, A from registers, B from shared memory. The
// TF32 form of wgmma reads a shared-memory operand only K-major, while half
// of the engine's products have a point-major (MN-major) operand (the dW
// products over points, the channels-first X of the mask's first layer), so
// no operand is read by wgmma as it lies:
//   - A: each thread reads its fragment of the landed tile (the m16n8k8
//     layout per warp, conflict-free in either raw layout) and splits it in
//     registers;
//   - B: a split pass rewrites the landed tile as hi and lo K-major core
//     matrices (8 rows x 4 k, 128 contiguous bytes, no swizzle; the
//     descriptor's leading byte offset 128 B between k chunks, stride byte
//     offset 1024 B between row groups), transposing a point-major tile on
//     the way; it runs while the tensor cores work on the previous tile.
//   - B pre-split (the forward and dz products of the rgb pipeline and of
//     every mask head's hidden layers (K3-K6), whose B is a weight matrix,
//     the same for every block and k-tile of the call): presplit_kernel
//     writes W's hi and lo once per call into device memory (a table of
//     weights in one launch: every head's hidden layers), in both
//     orientations (W for the forward, W^T for the dz product), laid out as
//     the split pass lays out
//     a tile and ordered [n-tile][k-tile][hi | lo], so one (n, k) tile is 16
//     contiguous KB, which bulk copies (cp.async.bulk ...
//     mbarrier::complete_tx::bytes) bring into shared memory. There is no
//     split pass and no raw B tile; the bits the tensor cores read are the
//     split pass's, so the products are bitwise those of the streaming mode.
//     These products run their own kernel, tc_presplit_kernel: see "The
//     pre-split product" below.
// (An mma.sync.m16n8k8 form of the same engine, every operand split in
// registers, was no faster on the forward products and slower on the dW
// products; PERF.md.)
//
// Shape (the streaming products, tc_gemm_kernel): block tile 128 x BN, two
// warpgroups of 64 rows; BK = 32; raw tiles through a cp.async ring (three
// stages for A, two for B; 16-byte copies where the operand's pointer and
// row stride allow, 4-byte copies otherwise, zero fill past every ragged
// edge), split B tiles double-buffered. BN = 128 (one block per SM, 154 KB
// of shared memory) for the products with a point-major A, BN = 64 (two
// blocks per SM, 107 KB) for the others, which stream a K-major A. Blocks
// are persistent over the (m, n) tiles of their group and split, n fastest,
// so the blocks that share an A tile run together; a block loads its next
// tile's first stages before it stores the current one. Epilogues: plain
// store, bias + ReLU, ReLU gate; split-K partials summed in a fixed
// (pairwise) order; and the folded db: in a dW product (A = dz,
// point-major) the blocks of the first column tile also sum A's rows from
// the same fragment reads, per k-tile then per partial, in a fixed order,
// so db needs no pass of its own over dz. No float atomics: two launches on
// the same inputs give bitwise-equal outputs.
//
// The pre-split product (tc_presplit_kernel; A K-major, B pre-split, one
// split): persistent and warp-specialised, one block of three warpgroups
// per SM, no __syncthreads in its k-loop.
//   - The producer warpgroup (40 registers after setmaxnreg) walks the
//     block's output tiles in order and keeps a ring of pp_ring k-tile
//     stages full, each landing on the stage's `full` mbarrier: B's tile as
//     bulk copies of the pre-split's 8 KB hi and lo halves (two pre-split
//     tiles side by side for a 128-wide block tile); A's raw 128 x 32 tile
//     by a bulk copy of each row's 128 bytes where K is whole k-tiles and
//     the rows 16-byte aligned, else by cp.async of 8 or 4 bytes (the
//     34-wide encoding: 8), zero fill past K (B is zero there too: the k8
//     steps past K add exact zeros, so every k8 step is issued, with no
//     branch). The consumers release a stage on its `empty` mbarrier.
//   - Two consumer warpgroups (232 registers) share each block tile, rows
//     [0, 64) and [64, 128), both on every stage, so neither can wait on a
//     barrier phase more than one ahead of it. Each issues its k-tile's 12
//     wgmmas, m64n128k8 (m64n64k8 where N <= 64), waits, releases the
//     stage and adds the fresh accumulator into its running sum; the other
//     warpgroup's wgmmas keep the tensor cores busy meanwhile. The
//     epilogue stages each warpgroup's 64 rows in shared memory and writes
//     them back as whole rows: 16-byte reads of the gate and stores of C,
//     a warp a row, where the fragments' 8-byte accesses would touch eight
//     rows at once.
//   - The arithmetic is the streaming mode's, bit for bit: A split in
//     registers, lo_a hi_b, hi_a lo_b, hi_a hi_b per k8 step into a fresh
//     accumulator per k-tile, added into the running float32 sum in k-tile
//     order (m64n128k8 gives each column m64n64k8's bits; checked against
//     the streaming mode on the card).
//   - Not ping-pong (each consumer its own tiles in turn, CUTLASS's other
//     schedule), tried first and measured on the card (PERF.md): with one
//     ring, a slot's fills alternate between the consumers, so their
//     mainloops must take turns (a parity wait holds only one phase ahead),
//     and ptxas serialises a consumer's wgmmas when it reads one group's
//     accumulator with another in flight (C7514), so each consumer drains
//     alone: no faster than the streaming kernel. A 128 x 128 tile shared
//     by both also reads 25% fewer bytes from L2 than two 128 x 64 ones.
// It adapts to the call's M, N, K and groups alone: the block tile's width
// to N, the copies of A to its alignment and K; a shape with fewer tiles
// than blocks (M under one wave) runs one tile a block.
//
// Groups: one launch runs the same product for up to MAX_GROUP operand sets
// (mask heads), blockIdx.z = group * splits + split, the per-group pointers
// passed by value in the GemmCall parameter struct.

#pragma once

#include "mlp_kernels.cuh"

namespace {

constexpr int TC_BM = 128;
constexpr int TC_BK = 32;
constexpr int TC_THREADS = 256;      // two warpgroups: block rows [0, 64) and [64, 128)
constexpr int TC_WAVE_BLOCKS = 132;  // one block per SM on 132 SMs
constexpr int TC_K_STRIDE = TC_BK + 4;  // K-major raw tile [rows][BK + 4]: 4 mod 32 banks per row
constexpr int TC_FLUSH = 64;  // k-tiles (2,048 points) per partial of a dW product
constexpr int TC_PRE_BN = 64;  // a pre-split B's tile width (the K-major-A products' BN)
constexpr int TC_PRE_TILE = 2 * TC_PRE_BN * TC_BK;  // floats of one pre-split (n, k) tile: hi | lo
constexpr int PP_THREADS = 384;  // the pre-split product: a producer and two consumer warpgroups
constexpr int PP_A_FL = TC_BM * TC_K_STRIDE;  // floats of a stage's raw A tile

// the pre-split product's ring: k-tile stages, each a B tile and a raw
// 128-row A tile, as many as fit beside the output staging
__host__ __device__ constexpr int pp_ring(int bn) { return bn == 128 ? 3 : 4; }
// its output staging, per consumer: 64 rows of bn + 8 floats (8 mod 32
// banks a row: the fragments' 8-byte writes take two wavefronts a warp)
__host__ __device__ constexpr int pp_stage_c(int bn) { return 64 * (bn + 8); }
__host__ __device__ constexpr int pp_smem_bytes(int bn) {
  return (pp_ring(bn) * (2 * bn * TC_BK + PP_A_FL) + 2 * pp_stage_c(bn)) * 4 + 2 * pp_ring(bn) * 8;
}

// floats of one raw tile of `rows` rows: K-major [rows][BK + 4], or
// MN-major [BK][rows + 8] (8 mod 32 banks per k row)
__host__ __device__ constexpr int tc_tile_floats(bool kmajor, int rows) {
  return kmajor ? rows * TC_K_STRIDE : TC_BK * (rows + 8);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory, completed on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// tf32(x): round to nearest, ties away from zero, low 13 bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Copy one operand's tile (ROWS rows from r0, depth BK from k0) into shared
// memory as it lies in device memory: KMAJOR g[r*ld + k] -> s[r][k], else
// g[k*ld + r] -> s[k][r]. Zero fill at r >= r_lim and k >= k_lim.
template <bool KMAJOR, int ROWS>
__device__ __forceinline__ void tc_load_tile(float* s, const float* __restrict__ g, int ld, int r0, int r_lim, int k0,
                                             int k_lim, bool vec) {
  constexpr int MN_STRIDE = ROWS + 8;
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < ROWS * TC_BK / 4 / TC_THREADS; ++i) {
      const int e = tid + i * TC_THREADS;
      int r, k, n;
      const float* src;
      float* dst;
      if (KMAJOR) {
        r = e / (TC_BK / 4), k = (e % (TC_BK / 4)) * 4;
        n = r0 + r < r_lim ? min(4, max(0, k_lim - (k0 + k))) : 0;
        src = g + (long long)(r0 + r) * ld + (k0 + k);
        dst = s + r * TC_K_STRIDE + k;
      } else {
        k = e / (ROWS / 4), r = (e % (ROWS / 4)) * 4;
        n = k0 + k < k_lim ? min(4, max(0, r_lim - (r0 + r))) : 0;
        src = g + (long long)(k0 + k) * ld + (r0 + r);
        dst = s + k * MN_STRIDE + r;
      }
      cp_async16(dst, n > 0 ? src : g, 4 * n);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ROWS * TC_BK / TC_THREADS; ++i) {
      const int e = tid + i * TC_THREADS;
      int r, k;
      float* dst;
      if (KMAJOR) {
        r = e / TC_BK, k = e % TC_BK;
        dst = s + r * TC_K_STRIDE + k;
      } else {
        k = e / ROWS, r = e % ROWS;
        dst = s + k * MN_STRIDE + r;
      }
      const bool ok = r0 + r < r_lim && k0 + k < k_lim;
      const float* src = KMAJOR ? g + (long long)(r0 + r) * ld + (k0 + k) : g + (long long)(k0 + k) * ld + (r0 + r);
      cp_async4(dst, ok ? src : g, ok ? 4 : 0);
    }
  }
}

// d (+)= A B for one m64n128k8 TF32 step, A from registers (this thread's
// four values of its warp's 16 x 8 slice, as mma.m16n8k8 holds them), B from
// shared memory; scale_d = 0 gives d = A B.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A B for one m64n64k8 TF32 step, A from registers (this thread's
// four values of its warp's 16 x 8 slice, as mma.m16n8k8 holds them), B from
// shared memory; scale_d = 0 gives d = A B.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Split B tiles: R rows x BK k of hi or lo, in wgmma's K-major core
// matrices without swizzle (8 rows x 4 k, 128 contiguous bytes each): the
// float offset of (r, 4-k chunk c) is (r / 8) 256 + c 32 + (r % 8) 4.
__device__ __forceinline__ int cm_off(int r, int c) { return (r >> 3) * 256 + c * 32 + (r & 7) * 4; }

// shared-memory matrix descriptor: no swizzle, leading byte offset 128 (k
// chunks), stride byte offset 1024 (8-row groups)
__device__ __forceinline__ uint64_t wg_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// keep the compiler from moving accesses of an asynchronous wgmma's
// accumulator or register operand across its issue and wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void keep_alive(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// v = B(k .. k + 3, n) -> hi and lo at a split tile's float offset `off`
__device__ __forceinline__ void split_store4(const float (&v)[4], float* hi, float* lo, int off) {
  uint4 h, l;
  split_tf32(v[0], h.x, l.x);
  split_tf32(v[1], h.y, l.y);
  split_tf32(v[2], h.z, l.z);
  split_tf32(v[3], h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// One landed B tile (as tc_load_tile wrote it, ROWS rows) -> its hi and lo
// split tiles. Thread units run row-fastest, so the reads of either raw
// layout and the 16-byte writes are free of bank conflicts.
template <bool KMAJOR, int ROWS>
__device__ __forceinline__ void tc_split_tile(const float* raw, float* hi, float* lo) {
  constexpr int MN_STRIDE = ROWS + 8;
#pragma unroll
  for (int i = 0; i < ROWS * (TC_BK / 4) / TC_THREADS; ++i) {
    const int u = threadIdx.x + i * TC_THREADS;
    const int r = u % ROWS, c = u / ROWS;
    float v[4];
    if (KMAJOR) {
      const float4 q = *reinterpret_cast<const float4*>(raw + r * TC_K_STRIDE + 4 * c);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = raw[(4 * c + k) * MN_STRIDE + r];
    }
    split_store4(v, hi, lo, cm_off(r, c));
  }
}

// floats of a pre-split B of N columns and depth K
inline long long presplit_floats(int N, int K) { return (long long)cdiv(N, TC_PRE_BN) * cdiv(K, TC_BK) * TC_PRE_TILE; }

// A table of weights pre-split in one launch: entry e's W [rows[e],
// cols[e]] (row-major, nn.Linear's [out, in]) into fwd[e] and dz[e]. The
// mask heads put every head's hidden layers into one table; a pipeline with
// one weight per layer gives a table of one. Read by the kernels as a
// __grid_constant__ parameter, so indexing it by blockIdx.z copies nothing
// to local memory.
constexpr int PRESPLIT_MAX = 64;  // entries per launch (2 KB of parameters): 16 heads x 4 hidden layers
struct PresplitTable {
  int n;
  int rows[PRESPLIT_MAX], cols[PRESPLIT_MAX];
  const float* W[PRESPLIT_MAX];
  float* fwd[PRESPLIT_MAX];
  float* dz[PRESPLIT_MAX];
};

inline void presplit_add(PresplitTable& t, const float* W, int rows, int cols, float* fwd, float* dz) {
  t.rows[t.n] = rows, t.cols[t.n] = cols, t.W[t.n] = W, t.fwd[t.n] = fwd, t.dz[t.n] = dz;
  ++t.n;
}

// The grid of a table's pre-split: blockIdx.z the entry, blockIdx.y the
// orientation, `per_thread` floats of the larger one written by a thread
dim3 presplit_grid(const PresplitTable& t, long long (*floats)(int, int), int per_thread) {
  long long units = 0;
  for (int e = 0; e < t.n; ++e) {
    const long long f = floats(t.rows[e], t.cols[e]), d = floats(t.cols[e], t.rows[e]);
    units = f > units ? f : units;
    units = d > units ? d : units;
  }
  return dim3(cdiv(units / per_thread, ELEM_THREADS), 2, t.n);
}

// Entry e = blockIdx.z of the table as the pre-split B of the two products
// that read its W, blockIdx.y = 0: B(k, n) = W[n, k] (the forward, N = rows,
// K = cols) into fwd; 1: B(k, n) = W[k, n] (the dz product, N = cols, K =
// rows) into dz. Tile (n / 64, k / 32) starts at ((n / 64) ktiles + k / 32)
// TC_PRE_TILE, its hi part then its lo part, each as tc_split_tile writes
// one (cm_off), zeros past N and K. One thread per row and 4-k chunk,
// row-fastest as tc_split_tile.
__global__ void presplit_kernel(const __grid_constant__ PresplitTable t) {
  const int e = blockIdx.z;
  const float* __restrict__ W = t.W[e];
  const int rows = t.rows[e], cols = t.cols[e];
  const bool tr = blockIdx.y == 1;
  const int N = tr ? cols : rows, K = tr ? rows : cols;
  const int ktiles = (K + TC_BK - 1) / TC_BK;
  constexpr int UNITS = TC_PRE_BN * (TC_BK / 4);  // per tile
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= (long long)((N + TC_PRE_BN - 1) / TC_PRE_BN) * ktiles * UNITS) return;
  const int tile = (int)(u / UNITS), r = (int)(u % TC_PRE_BN), c = (int)(u % UNITS / TC_PRE_BN);
  const int n = tile / ktiles * TC_PRE_BN + r, k0 = tile % ktiles * TC_BK + 4 * c;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + j;
    v[j] = n < N && k < K ? (tr ? W[(long long)k * cols + n] : W[(long long)n * cols + k]) : 0.0f;
  }
  float* o = (tr ? t.dz[e] : t.fwd[e]) + (long long)tile * TC_PRE_TILE;
  split_store4(v, o, o + TC_PRE_TILE / 2, cm_off(r, c));
}

// C[M, N] (+)= A[M, K] B[K, N] per group and split (GemmCall):
// A(m, k) = A_K_CONTIG ? A[m*lda + k] : A[k*lda + m],
// B(k, n) = B_N_CONTIG ? B[k*ldb + n] : B[n*ldb + k]. a_vec / b_vec:
// 16-byte copies allowed for A / B (every group's pointer 16-byte aligned,
// leading dimension a multiple of 4). The design is at the top of this file.
template <bool A_K_CONTIG, bool B_N_CONTIG, int EPI, int BN>
__global__ void __launch_bounds__(TC_THREADS, BN == 64 ? 2 : 1) tc_gemm_kernel(const GemmCall c, int a_vec,
                                                                              int b_vec) {
  constexpr bool A_KM = A_K_CONTIG;
  constexpr bool B_KM = !B_N_CONTIG;
  constexpr int A_FL = tc_tile_floats(A_KM, TC_BM);
  constexpr int B_FL = tc_tile_floats(B_KM, BN);
  constexpr int SB = BN * TC_BK;
  constexpr int NACC = BN / 2;
  constexpr int RAW = 3;    // A of tile kt is read when its wgmmas are issued
  constexpr int RAW_B = 2;  // B of tile kt + 1 is split during tile kt
  constexpr int SPLIT = 2;  // split B tiles, double-buffered
  // a dW product (A point-major, plain store) writes a partial per
  // TC_FLUSH k-tiles; every other product one per split
  constexpr bool PARTS = !A_K_CONTIG && EPI == EPI_STORE;
  extern __shared__ __align__(128) float tc_smem[];
  float* split = tc_smem;  // [SPLIT][B hi | B lo]
  float* rawA = split + SPLIT * 2 * SB;
  float* rawB = rawA + RAW * A_FL;

  const int tid = threadIdx.x;
  const int g = blockIdx.z / c.splits;
  const int z = blockIdx.z % c.splits;
  const float* __restrict__ A = static_cast<const float*>(pick(c.A, g));
  const float* __restrict__ B = static_cast<const float*>(pick(c.B, g));
  const float* __restrict__ bias = pick(c.bias, g);
  const float* __restrict__ gate = static_cast<const float*>(pick(c.gate, g));
  const int k0 = z * c.k_chunk;
  const int k1 = min(c.K, k0 + c.k_chunk);
  const int ktiles = k1 > k0 ? (k1 - k0 + TC_BK - 1) / TC_BK : 0;
  float* rsum = A_K_CONTIG ? nullptr : pick(c.rsum, g);
  // partials per split: one per TC_FLUSH k-tiles of a whole split
  const int subs = PARTS ? ((c.k_chunk + TC_BK - 1) / TC_BK + TC_FLUSH - 1) / TC_FLUSH : 1;
  const int wg = tid / 128, lane = tid & 31, w = (tid >> 5) & 3, gq = lane >> 2, tq = lane & 3;
  const int mr = wg * 64 + w * 16 + gq;  // this thread's rows in the block tile: mr, mr + 8
  // output tiles, n fastest (the blocks of one row of tiles share A, and
  // run together, so A comes from L2 after its first read)
  const int ntn = (c.N + BN - 1) / BN;
  const int tiles = (c.M + TC_BM - 1) / TC_BM * ntn;

  auto load_stage = [&](int t, int kt) {
    const int kb = k0 + kt * TC_BK;
    tc_load_tile<A_KM, TC_BM>(rawA + kt % RAW * A_FL, A, c.lda, t / ntn * TC_BM, c.M, kb, k1, a_vec);
    tc_load_tile<B_KM, BN>(rawB + kt % RAW_B * B_FL, B, c.ldb, t % ntn * BN, c.N, kb, k1, b_vec);
  };
  auto split_b = [&](int kt) {
    float* s = split + (kt % 2) * 2 * SB;
    tc_split_tile<B_KM, BN>(rawB + kt % RAW_B * B_FL, s, s + SB);
  };

  int t = blockIdx.x;
  if (t < tiles && ktiles > 0) load_stage(t, 0);
  cp_async_commit();
  if (t < tiles && ktiles > 1) load_stage(t, 1);
  cp_async_commit();

  // persistent: this block's tiles t, t + gridDim.x, ...; the next tile's
  // first two stages load while this one's epilogue stores
  for (; t < tiles; t += gridDim.x) {
    const int m0 = t / ntn * TC_BM, n0 = t % ntn * BN;
    const bool do_rsum = rsum != nullptr && n0 == 0;
    cp_async_wait<1>();
    __syncthreads();
    if (ktiles > 0) split_b(0);
    fence_proxy_async();
    __syncthreads();
    if (ktiles > 2) load_stage(t, 2);
    cp_async_commit();

    float acc[NACC], fr[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f, fr[i] = 0.0f;
    float rs0 = 0.0f, rs1 = 0.0f;
    // acc (and the row sums) -> partial s of this split, then zeroed
    auto store = [&](int s) {
      const long long slot = (long long)z * subs + s;
      float* C = static_cast<float*>(pick(c.C, g)) + slot * c.c_split_stride;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mr + h * 8;
        if (m >= c.M) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + j * 8 + tq * 2 + e;
            if (n >= c.N) continue;
            float v = acc[4 * j + 2 * h + e];
            if (EPI == EPI_BIAS_RELU) v = fmaxf(v + bias[n], 0.0f);
            if (EPI == EPI_GATE) v = gate[(long long)m * c.ldg + n] > 0.0f ? v : 0.0f;
            C[(long long)m * c.ldc + n] = v;
          }
        }
      }
      if (do_rsum) {  // the four lanes of a row, by a fixed xor tree
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
        if (tq == 0 && m0 + mr < c.M) rsum[slot * c.M + m0 + mr] = rs0;
        if (tq == 0 && m0 + mr + 8 < c.M) rsum[slot * c.M + m0 + mr + 8] = rs1;
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
      rs0 = 0.0f, rs1 = 0.0f;
    };

    for (int kt = 0; kt < ktiles; ++kt) {
      const float* as = rawA + (kt % RAW) * A_FL;
      auto a_at = [&](int m, int k) { return A_KM ? as[m * TC_K_STRIDE + k] : as[k * (TC_BM + 8) + m]; };
      const int nk8 = min(TC_BK / 8, (k1 - (k0 + kt * TC_BK) + 7) / 8);
      uint32_t ah[TC_BK / 8][4], al[TC_BK / 8][4];
      float t0 = 0.0f, t1 = 0.0f;  // this k-tile's row sums
#pragma unroll
      for (int q = 0; q < TC_BK / 8; ++q) {
        const int k = q * 8 + tq;
        const float x0 = a_at(mr, k), x1 = a_at(mr + 8, k), x2 = a_at(mr, k + 4), x3 = a_at(mr + 8, k + 4);
        split_tf32(x0, ah[q][0], al[q][0]);
        split_tf32(x1, ah[q][1], al[q][1]);
        split_tf32(x2, ah[q][2], al[q][2]);
        split_tf32(x3, ah[q][3], al[q][3]);
        if (!A_K_CONTIG && do_rsum && q < nk8) {  // past nk8 the tile holds zeros anyway
          t0 += x0, t0 += x2;
          t1 += x1, t1 += x3;
        }
      }
      rs0 += t0, rs1 += t1;
      const float* bh = split + (kt % SPLIT) * 2 * SB;
      const float* bl = bh + SB;
      reg_fence(fr);
      wg_fence();
#pragma unroll
      for (int q = 0; q < TC_BK / 8; ++q) {
        if (q < nk8) {
          const int o = 64 * q;  // two 4-k chunks per k8 step
          if constexpr (BN == 128) {
            wgmma_m64n128k8(*reinterpret_cast<float(*)[64]>(fr), al[q], wg_desc(bh + o), q);
            wgmma_m64n128k8(*reinterpret_cast<float(*)[64]>(fr), ah[q], wg_desc(bl + o), 1);
            wgmma_m64n128k8(*reinterpret_cast<float(*)[64]>(fr), ah[q], wg_desc(bh + o), 1);
          } else {
            wgmma_m64n64k8(*reinterpret_cast<float(*)[32]>(fr), al[q], wg_desc(bh + o), q);
            wgmma_m64n64k8(*reinterpret_cast<float(*)[32]>(fr), ah[q], wg_desc(bl + o), 1);
            wgmma_m64n64k8(*reinterpret_cast<float(*)[32]>(fr), ah[q], wg_desc(bh + o), 1);
          }
        }
      }
      wg_commit();
      if (kt + 1 < ktiles) {  // split the next B tile while the tensor cores work
        cp_async_wait<1>();
        __syncthreads();
        split_b(kt + 1);
        fence_proxy_async();
      }
      wg_wait0();
      reg_fence(fr);
#pragma unroll
      for (int q = 0; q < TC_BK / 8; ++q) keep_alive(ah[q]), keep_alive(al[q]);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += fr[i];
      if constexpr (PARTS) {
        if ((kt + 1) % TC_FLUSH == 0 && kt + 1 < ktiles) store(kt / TC_FLUSH);
      }
      __syncthreads();  // A slot kt % 3, split tile kt and raw B slot (kt + 1) % 2 are free
      if (kt + 3 < ktiles) load_stage(t, kt + 3);
      cp_async_commit();
    }

    const int tn = t + gridDim.x;  // the next tile's first stages, before this one's stores
    if (tn < tiles && ktiles > 0) load_stage(tn, 0);
    cp_async_commit();
    if (tn < tiles && ktiles > 1) load_stage(tn, 1);
    cp_async_commit();

    // the last partial, then zeros in those a short (last) split leaves
    const int done = PARTS && ktiles > 0 ? (ktiles - 1) / TC_FLUSH : 0;
    for (int s = done; s < subs; ++s) store(s);
  }
  cp_async_wait<0>();
}

template <bool AK, bool BNC, int EPI, int BN>
int tc_launch(cudaStream_t st, const GemmCall& c, bool a_vec, bool b_vec) {
  constexpr int floats = 4 * BN * TC_BK + 3 * tc_tile_floats(AK, TC_BM) + 2 * tc_tile_floats(!BNC, BN);
  constexpr int smem = floats * (int)sizeof(float);
  // once per template instance: a host API call per launch would add to the
  // enqueue time that paces the train step
  static const cudaError_t attr = cudaFuncSetAttribute(tc_gemm_kernel<AK, BNC, EPI, BN>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  // persistent over the (m, n) tiles of each group and split: one wave
  const int tiles = cdiv(c.M, TC_BM) * cdiv(c.N, BN), zs = c.groups * c.splits;
  const int wave = TC_WAVE_BLOCKS * (BN == 64 ? 2 : 1);
  const int per = wave / zs > 1 ? wave / zs : 1;
  dim3 grid(tiles < per ? tiles : per, 1, zs);
  tc_gemm_kernel<AK, BNC, EPI, BN><<<grid, TC_THREADS, smem, st>>>(c, a_vec, b_vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The pre-split product (the design is at the top of this file, "The
// pre-split product"): C[M, N] = epi(A B) for each group g = blockIdx.z, A
// K-major (A(m, k) = A[m*lda + k]), B pre-split (presplit_kernel: fwd or dz
// of the product's weight), one split. a_vec: how A's row pieces come (8:
// a bulk copy a row; 2 or 1: cp.async of that many floats); c_vec:
// 16-byte stores of C and reads of the gate (pointers 16-byte aligned, ldc
// and ldg multiples of 4).

// The waits and arrivals in tc_presplit_kernel's consumer loop: a branch
// there (a spin loop, one lane's arrival) is a divergent path to ptxas,
// which then serialises the loop's wgmmas (C7520), so the loop and the
// lane's predicate live inside the asm.
// until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait_spin(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nPP_WAIT:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@!p bra PP_WAIT;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one arrival on `bar` from the threads where `pred` holds
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
                   smem_u32(bar)),
               "r"((int)pred)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread has issued so far has
// landed (the arrival is one of the phase's expected count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until at most N of this warpgroup's wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

// The producer warpgroup's share of one stage's raw A tile: rows r0 ..
// r0 + 127 below M, depth k0 .. k0 + 32, into s[r][k] (row stride
// TC_K_STRIDE), zeros at k >= K (B's pre-split is zero there too, so the
// k8 steps past K add exact zeros). Rows at or past M keep what they held:
// their outputs are not stored. VEC floats a copy (2: 8 bytes, sixteen
// threads a row; 1: 4 bytes, a warp a row).
template <int VEC>
__device__ __forceinline__ void pp_load_a(float* s, const float* __restrict__ A, int lda, int r0, int M, int k0, int K,
                                          int pt) {
  constexpr int PER_ROW = TC_BK / VEC;
#pragma unroll 4  // the producer has 40 registers: four copies' addresses at a time
  for (int i = 0; i < TC_BM * PER_ROW / 128; ++i) {
    const int e = pt + i * 128, r = e / PER_ROW, k = e % PER_ROW * VEC;
    if (r0 + r < M) {
      const int n = min(VEC, max(0, K - (k0 + k)));
      const float* src = n > 0 ? A + (long long)(r0 + r) * lda + (k0 + k) : A;
      if (VEC == 2) cp_async8(s + r * TC_K_STRIDE + k, src, 4 * n);
      else cp_async4(s + r * TC_K_STRIDE + k, src, 4 * n);
    }
  }
}

template <int EPI, int BN>
__global__ void __launch_bounds__(PP_THREADS, 1) tc_presplit_kernel(const GemmCall c, int a_vec, int c_vec) {
  constexpr int PP_RING = pp_ring(BN);
  constexpr int B_FL = 2 * BN * TC_BK;  // floats of a stage's B: hi [BN rows], then lo
  constexpr int NACC = BN / 2;          // accumulator floats a thread holds of its warpgroup's 64 x BN
  constexpr int SUBS = BN / TC_PRE_BN;  // pre-split (n, k) tiles a stage's B takes
  constexpr int CS = BN + 8;            // the output staging's row stride
  extern __shared__ __align__(128) float tc_smem[];
  float* sB = tc_smem;                        // [PP_RING][hi | lo]
  float* sA = sB + PP_RING * B_FL;            // [PP_RING][TC_BM][TC_K_STRIDE]
  float* sC = sA + PP_RING * PP_A_FL;         // [2][64][CS]: each consumer's rows of the tile
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + 2 * pp_stage_c(BN));
  uint64_t* empty = full + PP_RING;
  const int g = blockIdx.z;
  const int ntn = (c.N + BN - 1) / BN;
  const int nsub = (c.N + TC_PRE_BN - 1) / TC_PRE_BN;  // the pre-split's n-tiles
  const int tiles = (c.M + TC_BM - 1) / TC_BM * ntn;   // n fastest, as tc_gemm_kernel's
  const int ktiles = (c.K + TC_BK - 1) / TC_BK;
  // Stage p (counted over the block's tiles in order, k-tile fastest) is
  // ring slot p % PP_RING in its fill p / PP_RING: `full` completes that
  // fill's phase when the producer's 129 arrivals (each thread's once its
  // cp.async copies have landed, thread 0's with the bytes its bulk copies
  // bring) and those bytes are in, `empty` when the eight consumer warps
  // have released it.
  // Both consumers wait on every fill, so neither can wait on a phase more
  // than one ahead of its barrier.
  if (threadIdx.x == 0) {
    for (int s = 0; s < PP_RING; ++s) mbar_init(&full[s], 128 + 1), mbar_init(&empty[s], 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup, warp-uniform as ptxas can see (a role it cannot prove
  // uniform is a divergent path, where it serialises the wgmmas)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (role == 0) {  // ---- the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const float* __restrict__ A = static_cast<const float*>(pick(c.A, g));
    const float* __restrict__ B = static_cast<const float*>(pick(c.B, g));
    int p = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int r0 = t / ntn * TC_BM, n64 = t % ntn * SUBS;
      const int subs = min(SUBS, nsub - n64);  // the pre-split tiles that exist (zeros past N)
      const int rows = min(TC_BM, c.M - r0);
      for (int kt = 0; kt < ktiles; ++kt, ++p) {
        const int s = p % PP_RING;
        mbar_wait_spin(&empty[s], ((p / PP_RING) & 1) ^ 1);  // the fill before has been released
        if (threadIdx.x == 0) {  // per pre-split tile: its hi rows, its lo rows
          mbar_expect_tx(&full[s], subs * TC_PRE_TILE * sizeof(float) + (a_vec == 8 ? rows * TC_BK * 4 : 0));
          for (int u = 0; u < subs; ++u) {
            const float* src = B + ((long long)(n64 + u) * ktiles + kt) * TC_PRE_TILE;
            float* dst = sB + s * B_FL + u * (TC_PRE_TILE / 2);
            bulk_load(dst, src, TC_PRE_TILE / 2 * sizeof(float), &full[s]);
            bulk_load(dst + BN * TC_BK, src + TC_PRE_TILE / 2, TC_PRE_TILE / 2 * sizeof(float), &full[s]);
          }
        }
        float* sa = sA + s * PP_A_FL;
        if (a_vec == 8) {  // whole k-tiles: each thread's row piece, 128 bytes, in one bulk copy
          if ((int)threadIdx.x < rows)
            bulk_load(sa + threadIdx.x * TC_K_STRIDE, A + (long long)(r0 + threadIdx.x) * c.lda + kt * TC_BK,
                      TC_BK * 4, &full[s]);
        } else if (a_vec == 2) pp_load_a<2>(sa, A, c.lda, r0, c.M, kt * TC_BK, c.K, threadIdx.x);
        else pp_load_a<1>(sa, A, c.lda, r0, c.M, kt * TC_BK, c.K, threadIdx.x);
        cp_async_mbar_arrive(&full[s]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {  // ---- the consumer warpgroups: rows [64 h, 64 h + 64) of every tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int h = role - 1;
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, gq = lane >> 2, tq = lane & 3;
    const int mr = h * 64 + w * 16 + gq;  // this thread's rows in the block tile: mr, mr + 8
    float* __restrict__ C = static_cast<float*>(pick(c.C, g));
    const float* __restrict__ bias = pick(c.bias, g);
    const float* __restrict__ gate = static_cast<const float*>(pick(c.gate, g));
    int p = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / ntn * TC_BM, n0 = t % ntn * BN;
      float acc[NACC], fr[NACC];
      uint32_t ah[TC_BK / 8][4], al[TC_BK / 8][4];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.0f, fr[i] = 0.0f;
      for (int kt = 0; kt < ktiles; ++kt, ++p) {
        const int s = p % PP_RING;
        mbar_wait_spin(&full[s], (p / PP_RING) & 1);
        const float* a = sA + s * PP_A_FL + mr * TC_K_STRIDE + tq;
        const float* bh = sB + s * B_FL;
        const float* bl = bh + BN * TC_BK;
#pragma unroll
        for (int q = 0; q < TC_BK / 8; ++q) {
          split_tf32(a[q * 8], ah[q][0], al[q][0]);
          split_tf32(a[q * 8 + 8 * TC_K_STRIDE], ah[q][1], al[q][1]);
          split_tf32(a[q * 8 + 4], ah[q][2], al[q][2]);
          split_tf32(a[q * 8 + 8 * TC_K_STRIDE + 4], ah[q][3], al[q][3]);
        }
        reg_fence(fr);
        wg_fence();
        // every k8 step, past K too (A and B zero there: each product adds
        // an exact +0, which leaves the sum's bits as they are)
#pragma unroll
        for (int q = 0; q < TC_BK / 8; ++q) {
          const int o = 64 * q;  // two 4-k chunks per k8 step
          if constexpr (BN == 128) {
            wgmma_m64n128k8(fr, al[q], wg_desc(bh + o), q);
            wgmma_m64n128k8(fr, ah[q], wg_desc(bl + o), 1);
            wgmma_m64n128k8(fr, ah[q], wg_desc(bh + o), 1);
          } else {
            wgmma_m64n64k8(fr, al[q], wg_desc(bh + o), q);
            wgmma_m64n64k8(fr, ah[q], wg_desc(bl + o), 1);
            wgmma_m64n64k8(fr, ah[q], wg_desc(bh + o), 1);
          }
        }
        wg_commit();
        wg_wait<0>();
        mbar_arrive_if(&empty[s], lane == 0);  // stage p's A and B are read
        reg_fence(fr);
#pragma unroll
        for (int q = 0; q < TC_BK / 8; ++q) keep_alive(ah[q]), keep_alive(al[q]);
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] += fr[i];
      }

      // the epilogue, while the producer fills the next tile's first
      // stages: the fragments into this consumer's staging rows (thread
      // (w, gq, tq) holds rows w 16 + gq + 8 hh, columns 8 jn + 2 tq + e in
      // acc[4 jn + 2 hh + e]), then each warp takes 16 whole rows with
      // 16-byte reads, gate reads and stores, BN / 4 lanes a row. The gate
      // and bias reads go first, in flight across the staging.
      constexpr int LPR = BN / 4, RPI = 32 / LPR;  // lanes a row, rows an iteration
      const int n = n0 + (lane % LPR) * 4;
      float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // this lane's columns' bias, the same for every row
      if constexpr (EPI == EPI_BIAS_RELU) {
#pragma unroll
        for (int e = 0; e < 4; ++e) bv[e] = n + e < c.N ? bias[n + e] : 0.0f;
      }
      constexpr int ROWS = 16 / RPI;  // iterations over this warp's 16 rows
      // the gate's rows first, every read in flight before the first use
      float gx[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) gx[i][e] = 0.0f;
        if constexpr (EPI == EPI_GATE) {
          const int m = m0 + h * 64 + w * 16 + i * RPI + lane / LPR;
          const float* grow = gate + (long long)m * c.ldg + n;
          if (m < c.M && c_vec && n + 3 < c.N) {
            const float4 gv = *reinterpret_cast<const float4*>(grow);
            gx[i][0] = gv.x, gx[i][1] = gv.y, gx[i][2] = gv.z, gx[i][3] = gv.w;
          } else if (m < c.M) {
#pragma unroll
            for (int e = 0; e < 4; ++e) gx[i][e] = n + e < c.N ? grow[e] : 0.0f;
          }
        }
      }
      float* stg = sC + h * pp_stage_c(BN);
      const int bar = 1 + h;  // named barrier of this warpgroup's 128 threads
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");  // the last tile's rows are out
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          *reinterpret_cast<float2*>(stg + (w * 16 + gq + hh * 8) * CS + jn * 8 + tq * 2) =
              make_float2(acc[4 * jn + 2 * hh], acc[4 * jn + 2 * hh + 1]);
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = w * 16 + i * RPI + lane / LPR;
        const int m = m0 + h * 64 + r;
        if (m >= c.M) continue;
        const float4 v = *reinterpret_cast<const float4*>(stg + r * CS + (lane % LPR) * 4);
        float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (EPI == EPI_BIAS_RELU) x[e] = fmaxf(x[e] + bv[e], 0.0f);
          if (EPI == EPI_GATE) x[e] = gx[i][e] > 0.0f ? x[e] : 0.0f;
        }
        float* crow = C + (long long)m * c.ldc + n;
        if (c_vec && n + 3 < c.N) {
          *reinterpret_cast<float4*>(crow) = make_float4(x[0], x[1], x[2], x[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (n + e < c.N) crow[e] = x[e];
          }
        }
      }
    }
  }
}

template <int EPI, int BN>
int tc_presplit_launch(cudaStream_t st, const GemmCall& c, int a_vec, bool c_vec) {
  constexpr int smem = pp_smem_bytes(BN);
  static const cudaError_t attr =
      cudaFuncSetAttribute(tc_presplit_kernel<EPI, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  // one block per SM, persistent over the (m, n) tiles of its group
  const int tiles = cdiv(c.M, TC_BM) * cdiv(c.N, BN);
  const int per = TC_WAVE_BLOCKS / c.groups > 1 ? TC_WAVE_BLOCKS / c.groups : 1;
  dim3 grid(tiles < per ? tiles : per, 1, c.groups);
  tc_presplit_kernel<EPI, BN><<<grid, PP_THREADS, smem, st>>>(c, a_vec, c_vec);
  return (int)cudaGetLastError();
}

// What both engines share: the block tile's width, the split-K of the dW
// products over points and their partials, for a k-tile BK deep and a
// partial per FLUSH k-tiles (2,048 points for both engines).
template <int BK, int FLUSH>
struct EngineShape {
  static constexpr int k_tile = BK;
  // the block tile's width: 64 where A is K-major or N is narrow, else 128
  static int tile_n(bool a_k_contig, int N) { return a_k_contig || N <= 64 ? 64 : 128; }
  // split-K of `groups` dW products [out, in] over Np points (A point-major):
  // as many splits as fill one wave and no more (a second, partial wave
  // would cost a whole block's time)
  static void dw_split(int Np, int out, int in, int groups, int& splits, int& chunk) {
    const int bn = tile_n(false, in);
    const int tiles = groups * cdiv(out, TC_BM) * cdiv(in, bn);
    const int wave = TC_WAVE_BLOCKS * (bn == 64 ? 2 : 1);
    const int s = wave / tiles > 1 ? wave / tiles : 1;
    chunk = cdiv(cdiv(Np, s), BK) * BK;
    splits = cdiv(Np, chunk);
  }
  // partials a dW product writes per group: one per FLUSH k-tiles of each
  // split, so no serial float32 sum in the kernel runs over more than
  // 2,048 points
  static int dw_parts(int splits, int chunk) { return splits * cdiv(cdiv(chunk, BK), FLUSH); }
  // their sum, pairwise (reduce_tree_group_kernel)
  static void reduce_parts(cudaStream_t st, int groups, int S, int count, long long stride, const float* part,
                           long long gstride, const GroupPtrs& out) {
    reduce_tree_group_kernel<<<dim3(cdiv(count, ELEM_THREADS), groups), ELEM_THREADS, 0, st>>>(S, count, stride,
                                                                                              part, gstride, out);
  }
  // the GemmCall checks both engines make: groups, split alignment, and more
  // than one partial per split only for dW products (A point-major, plain
  // store, split stride set)
  static bool valid_call(const GemmCall& c, bool a_k_contig, int epi) {
    return c.groups >= 1 && c.groups <= MAX_GROUP && (c.splits <= 1 || c.k_chunk % BK == 0) &&
           !(dw_parts(c.splits, c.k_chunk) > c.splits && (a_k_contig || epi != EPI_STORE || c.c_split_stride == 0));
  }
};

// The 3xTF32 tensor-core engine (see the top of this file).
struct TcEngine : EngineShape<TC_BK, TC_FLUSH> {
  // floats of a weight's pre-split for a product of N columns and depth K
  static long long weight_floats(int N, int K) { return presplit_floats(N, K); }
  template <bool AK, bool BNC, int EPI>
  static int run(cudaStream_t st, const GemmCall& c) {
    if (!valid_call(c, AK, EPI)) return (int)cudaErrorInvalidValue;
    bool a_vec = c.lda % 4 == 0, b_vec = c.ldb % 4 == 0;
    for (int g = 0; g < c.groups; ++g) {
      a_vec = a_vec && (uintptr_t)c.A[g] % 16 == 0;
      b_vec = b_vec && (uintptr_t)c.B[g] % 16 == 0;
      if (AK && c.rsum[g]) return (int)cudaErrorInvalidValue;  // row sums need A point-major
    }
    if constexpr (!AK) {
      if (tile_n(AK, c.N) == 128) return tc_launch<AK, BNC, EPI, 128>(st, c, a_vec, b_vec);
    }
    return tc_launch<AK, BNC, EPI, 64>(st, c, a_vec, b_vec);
  }
  // Each W [rows, cols] of the table as the pre-split B of its forward
  // product (fwd, presplit_floats(rows, cols) floats) and of its dz product
  // (dz, presplit_floats(cols, rows)), in one launch
  static int presplit(cudaStream_t st, const PresplitTable& t) {
    if (t.n < 1 || t.n > PRESPLIT_MAX) return (int)cudaErrorInvalidValue;
    // a thread per 4 k of a row, hi and lo
    presplit_kernel<<<presplit_grid(t, presplit_floats, 8), ELEM_THREADS, 0, st>>>(t);
    return (int)cudaGetLastError();
  }
  // run<true, *, EPI> with every group's B pre-split (presplit's fwd or dz
  // for this product; ldb unused), on tc_presplit_kernel; one split
  template <int EPI>
  static int run_presplit(cudaStream_t st, const GemmCall& c) {
    if (!valid_call(c, true, EPI) || c.splits != 1) return (int)cudaErrorInvalidValue;
    // how A's row pieces come: 8, one bulk copy a row (whole k-tiles, every
    // row 16-byte aligned); else cp.async of 2 floats (rows 8-byte aligned)
    // or 1
    int a_vec = c.K % TC_BK == 0 && c.lda % 4 == 0 ? 8 : c.lda % 2 == 0 ? 2 : 1;
    bool c_vec = c.ldc % 4 == 0 && (EPI != EPI_GATE || c.ldg % 4 == 0);
    for (int g = 0; g < c.groups; ++g) {
      if (a_vec == 8 && (uintptr_t)c.A[g] % 16) a_vec = 2;
      if (a_vec == 2 && (uintptr_t)c.A[g] % 8) a_vec = 1;
      c_vec = c_vec && (uintptr_t)c.C[g] % 16 == 0 && (EPI != EPI_GATE || (uintptr_t)c.gate[g] % 16 == 0);
      if ((uintptr_t)c.B[g] % 16 != 0 || c.rsum[g]) return (int)cudaErrorInvalidValue;  // bulk copies: 16 B
    }
    // the block tile's width: 128 (m64n128k8), or 64 for a narrow product
    return c.N > TC_PRE_BN ? tc_presplit_launch<EPI, 128>(st, c, a_vec, c_vec)
                           : tc_presplit_launch<EPI, TC_PRE_BN>(st, c, a_vec, c_vec);
  }
};

// ---------------------------------------------------------------------------
// The bf16 tensor-core engine (TbEngine), for compute_dtype = bfloat16: the
// Pallas kernels' mxu_dot, bf16 operands with float32 products and sums.
// Every bf16 x bf16 product is exact in float32, so only the order of the
// float32 sums differs from the TPU's. Design, as the 3xTF32 engine's above
// where nothing is said:
//   - instruction: wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16 (N =
//     128 or 64), one per k16 step, A from registers (the m16n8k16 fragment
//     of each warp, read from the landed tile: 32-bit loads from a K-major
//     tile, two 16-bit loads packed from a point-major one), B from shared
//     memory. No split: a third of the 3xTF32 engine's instructions and
//     half its operand bytes;
//   - 16-bit wgmma reads a shared-memory operand K-major or MN-major
//     (imm-trans-b), so every B tile lands by cp.async directly in wgmma's
//     core matrices (8 rows of 16 bytes, 128 contiguous bytes, no swizzle),
//     as it lies in device memory: no split or transpose pass. K-major
//     (B(k, n) = B[n ldb + k]): leading byte offset 128 (k groups), stride
//     byte offset 1024 (8-row groups of n); MN-major (B(k, n) = B[k ldb +
//     n]): core matrices of 8 k rows of 8 n, leading byte offset 16 BN (k
//     groups), stride byte offset 128 (n groups);
//   - k-tiles 64 deep (128 bytes a row, as the 3xTF32 engine's 32 floats),
//     A and B in one three-stage cp.async ring, two stages in flight, one
//     barrier per k-tile; each k-tile's four k16 products go into a fresh
//     accumulator that one float32 add takes into the running sum (the
//     tensor cores truncate as they accumulate); a dW product writes a
//     partial per 32 k-tiles (2,048 points), summed pairwise;
//   - B pre-converted (the template flag B_PRE; the hidden weights of the
//     rgb pipeline and of every mask head): presplit_bf16_kernel writes
//     W and W^T once per call (a table of weights in one launch) as bf16 tiles of 64 n by 64 k in the K-major
//     core-matrix layout, ordered [n-tile][k-tile], 8 KB a tile, each
//     loaded by one cp.async.bulk on an mbarrier;
//   - operands: bf16, every row 16-byte aligned (leading dimensions that
//     are multiples of 8; copies of 16 bytes, zero fill past the edges);
//     C float32 for a plain store (dW partials, d(encoding)), bf16 after
//     bias + ReLU and after the gate (the activations and the ReLU-gated dz,
//     which the Pallas kernels store in cdtype); bias, row sums and the
//     epilogue's arithmetic float32.

constexpr int TB_BK = 64;                    // k-tile depth (bf16)
constexpr int TB_K_STRIDE = TB_BK + 8;       // K-major raw A tile [rows][BK + 8]: 144 bytes a row
constexpr int TB_STAGES = 3;                 // A and B tiles in the ring
constexpr int TB_FLUSH = 32;                 // k-tiles (2,048 points) per partial of a dW product
constexpr int TB_PRE_TILE = TC_PRE_BN * TB_BK;  // bf16 values of one pre-converted (n, k) weight tile

template <bool F>
struct TbOut {
  using type = bf16;
};
template <>
struct TbOut<true> {
  using type = float;
};

__device__ __forceinline__ uint32_t ld_b32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// two bf16 in one 32-bit register, lo in the low half (the lower k)
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// element offset of B(k, n) in a landed B tile of BN columns, wgmma's core
// matrices without swizzle: K-major (n / 8) 512 + (k / 8) 64 + (n % 8) 8 +
// k % 8; MN-major (k / 8) 8 BN + (n / 8) 64 + (k % 8) 8 + n % 8
template <bool KMAJOR, int BN>
__device__ __forceinline__ int tb_core_off(int n, int k) {
  return KMAJOR ? (n >> 3) * 512 + (k >> 3) * 64 + (n & 7) * 8 + (k & 7)
                : (k >> 3) * 8 * BN + (n >> 3) * 64 + (k & 7) * 8 + (n & 7);
}

// Copy one bf16 operand tile (ROWS rows from r0, depth TB_BK from k0) into
// shared memory with 16-byte cp.async, zeros at r >= r_lim and k >= k_lim.
// CORE = false (A): as it lies, KMAJOR g[r ld + k] -> s[r TB_K_STRIDE + k],
// else g[k ld + r] -> s[k (ROWS + 8) + r]; eight consecutive threads copy a
// row's 128 contiguous bytes. CORE = true (B, ROWS = BN): into
// tb_core_off's core matrices; eight consecutive threads copy one 16-byte
// chunk of eight rows (eight k of a point-major B), the 128 bytes of one
// core matrix, so no two of them write the same banks.
template <bool KMAJOR, int ROWS, bool CORE>
__device__ __forceinline__ void tb_load_tile(bf16* s, const bf16* __restrict__ g, int ld, int r0, int r_lim, int k0,
                                             int k_lim) {
  constexpr int RC = ROWS / 8, KC = TB_BK / 8;  // 16-byte chunks across the rows, along k
#pragma unroll
  for (int i = 0; i < ROWS * KC / TC_THREADS; ++i) {
    const int e = threadIdx.x + i * TC_THREADS;
    int r, k;
    if (!CORE) {
      if (KMAJOR) r = e / KC, k = e % KC * 8;
      else k = e / RC, r = e % RC * 8;
    } else {
      if (KMAJOR) r = (e >> 6) * 8 + (e & 7), k = ((e >> 3) & 7) * 8;  // 8 rows, then 8 k chunks
      else k = (e >> 3) / RC * 8 + (e & 7), r = (e >> 3) % RC * 8;     // 8 k, then the n chunks
    }
    int n;
    const bf16* src;
    if (KMAJOR) {
      n = r0 + r < r_lim ? min(8, max(0, k_lim - (k0 + k))) : 0;
      src = g + (long long)(r0 + r) * ld + (k0 + k);
    } else {
      n = k0 + k < k_lim ? min(8, max(0, r_lim - (r0 + r))) : 0;
      src = g + (long long)(k0 + k) * ld + (r0 + r);
    }
    bf16* dst = CORE ? s + tb_core_off<KMAJOR, ROWS>(r, k) : KMAJOR ? s + r * TB_K_STRIDE + k : s + k * (ROWS + 8) + r;
    cp_async16(dst, n > 0 ? src : g, 2 * n);
  }
}

// shared-memory matrix descriptor, no swizzle: leading and stride byte offsets
__device__ __forceinline__ uint64_t tb_desc(const bf16* p, unsigned lbo, unsigned sbo) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d (+)= A B for one m64n128k16 bf16 step, A from registers (this thread's
// four registers of its warp's 16 x 16 slice, as mma.m16n8k16 holds them),
// B from shared memory, MN-major when TNSP_B; scale_d = 0 gives d = A B.
template <int TNSP_B>
__device__ __forceinline__ void wgmma_bf16_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TNSP_B));
}

// as wgmma_bf16_m64n128k16, 64 columns
template <int TNSP_B>
__device__ __forceinline__ void wgmma_bf16_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TNSP_B));
}

// floats of the pre-converted bf16 B of N columns and depth K
inline long long presplit_bf16_floats(int N, int K) {
  return (long long)cdiv(N, TC_PRE_BN) * cdiv(K, TB_BK) * (TB_PRE_TILE / 2);
}

// Entry e = blockIdx.z of the table (float32 W, row-major, nn.Linear's
// [out, in]) as the bf16 B of the two products that read it, blockIdx.y =
// 0: B(k, n) = W[n, k] (the forward) into fwd; 1: B(k, n) = W[k, n] (the dz
// product) into dz. Tile (n / 64, k / 64) starts at ((n / 64) ktiles + k /
// 64) TB_PRE_TILE, in tb_core_off's K-major layout, zeros past N and K. One
// thread per row and 8-k chunk, 16 bytes written.
__global__ void presplit_bf16_kernel(const __grid_constant__ PresplitTable t) {
  const int e = blockIdx.z;
  const float* __restrict__ W = t.W[e];
  const int rows = t.rows[e], cols = t.cols[e];
  const bool tr = blockIdx.y == 1;
  const int N = tr ? cols : rows, K = tr ? rows : cols;
  const int ktiles = (K + TB_BK - 1) / TB_BK;
  constexpr int UNITS = TC_PRE_BN * (TB_BK / 8);  // per tile
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= (long long)((N + TC_PRE_BN - 1) / TC_PRE_BN) * ktiles * UNITS) return;
  const int tile = (int)(u / UNITS), r = (int)(u % TC_PRE_BN), c = (int)(u % UNITS / TC_PRE_BN);
  const int n = tile / ktiles * TC_PRE_BN + r, k0 = tile % ktiles * TB_BK + 8 * c;
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float x[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 2 * j + h;
      x[h] = n < N && k < K ? (tr ? W[(long long)k * cols + n] : W[(long long)n * cols + k]) : 0.0f;
    }
    v[j] = pack_bf16(__float2bfloat16_rn(x[0]), __float2bfloat16_rn(x[1]));
  }
  bf16* o = reinterpret_cast<bf16*>(tr ? t.dz[e] : t.fwd[e]) + (long long)tile * TB_PRE_TILE +
            tb_core_off<true, TC_PRE_BN>(r, 8 * c);
  *reinterpret_cast<uint4*>(o) = make_uint4(v[0], v[1], v[2], v[3]);
}

// Per group h = blockIdx.y: dst + h dhs [rows, ldd] = bf16(src.p[h] [rows,
// lds]) on the first cols columns, zeros from there to round8(cols) (a
// float32 operand as the bf16 engine reads it: the mask heads' X, each
// head's block starting on 16 bytes, and their first layers' weights). One
// thread per row and 8 columns, one 16-byte store (ldd and dhs multiples
// of 8, dst 16-byte aligned).
__global__ void cast_bf16_kernel(GroupConstPtrs src, int rows, int cols, int lds, bf16* __restrict__ dst, int ldd,
                                 long long dhs) {
  const int chunks = round8(cols) / 8;
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= rows * chunks) return;
  const int r = u / chunks, c0 = u % chunks * 8;
  const float* __restrict__ s = pick(src, blockIdx.y) + (long long)r * lds;
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 2 * j;
    const float lo = c < cols ? s[c] : 0.0f, hi = c + 1 < cols ? s[c + 1] : 0.0f;
    v[j] = pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  }
  *reinterpret_cast<uint4*>(dst + blockIdx.y * dhs + (long long)r * ldd + c0) = make_uint4(v[0], v[1], v[2], v[3]);
}

void cast_bf16(cudaStream_t st, int groups, const GroupConstPtrs& src, int rows, int cols, int lds, bf16* dst, int ldd,
               long long dhs) {
  cast_bf16_kernel<<<dim3(cdiv((long long)rows * (round8(cols) / 8), ELEM_THREADS), groups), ELEM_THREADS, 0, st>>>(
      src, rows, cols, lds, dst, ldd, dhs);
}

// C[M, N] (+)= A[M, K] B[K, N] in bf16 per group and split (GemmCall), the
// layouts as tc_gemm_kernel's; with B_PRE, B is presplit_bf16_kernel's
// output (ldb unused). The design is above TB_BK.
template <bool A_K_CONTIG, bool B_N_CONTIG, int EPI, int BN, bool B_PRE>
__global__ void __launch_bounds__(TC_THREADS, BN == 64 ? 2 : 1) tb_gemm_kernel(const GemmCall c) {
  static_assert(!B_PRE || (A_K_CONTIG && BN == TC_PRE_BN), "a pre-converted B: the K-major-A products, 64 wide");
  using OutT = typename TbOut<EPI == EPI_STORE>::type;
  constexpr int A_EL = A_K_CONTIG ? TC_BM * TB_K_STRIDE : TB_BK * (TC_BM + 8);
  constexpr int B_EL = BN * TB_BK;
  constexpr int NACC = BN / 2;
  constexpr bool PARTS = !A_K_CONTIG && EPI == EPI_STORE;  // a dW product: a partial per TB_FLUSH k-tiles
  extern __shared__ __align__(128) unsigned char tb_smem[];
  bf16* sB = reinterpret_cast<bf16*>(tb_smem);  // [TB_STAGES][B_EL], core matrices
  bf16* sA = sB + TB_STAGES * B_EL;             // [TB_STAGES][A_EL], as A lies
  uint64_t* bar = reinterpret_cast<uint64_t*>(sA + TB_STAGES * A_EL);  // B_PRE: one per stage

  const int tid = threadIdx.x;
  const int g = blockIdx.z / c.splits;
  const int z = blockIdx.z % c.splits;
  const bf16* __restrict__ A = static_cast<const bf16*>(pick(c.A, g));
  const bf16* __restrict__ B = static_cast<const bf16*>(pick(c.B, g));
  const float* __restrict__ bias = pick(c.bias, g);
  const bf16* __restrict__ gate = static_cast<const bf16*>(pick(c.gate, g));
  const int k0 = z * c.k_chunk;
  const int k1 = min(c.K, k0 + c.k_chunk);
  const int ktiles = k1 > k0 ? (k1 - k0 + TB_BK - 1) / TB_BK : 0;
  float* rsum = A_K_CONTIG ? nullptr : pick(c.rsum, g);
  const int subs = PARTS ? ((c.k_chunk + TB_BK - 1) / TB_BK + TB_FLUSH - 1) / TB_FLUSH : 1;
  const int wg = tid / 128, lane = tid & 31, w = (tid >> 5) & 3, gq = lane >> 2, tq = lane & 3;
  const int mr = wg * 64 + w * 16 + gq;  // this thread's rows in the block tile: mr, mr + 8
  const int ntn = (c.N + BN - 1) / BN;
  const int tiles = (c.M + TC_BM - 1) / TC_BM * ntn;
  const int kt_all = (c.K + TB_BK - 1) / TB_BK;  // a pre-converted B's k-tiles
  unsigned phase = 0;  // B_PRE: bit s, the parity of stage s's next fill

  if constexpr (B_PRE) {
    if (tid == 0) {
      for (int s = 0; s < TB_STAGES; ++s) mbar_init(&bar[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  auto load_stage = [&](int t, int kt) {
    const int kb = k0 + kt * TB_BK, s = kt % TB_STAGES;
    tb_load_tile<A_K_CONTIG, TC_BM, false>(sA + s * A_EL, A, c.lda, t / ntn * TC_BM, c.M, kb, k1);
    if constexpr (B_PRE) {
      if (tid == 0) {  // the whole (n, k) tile in one bulk copy
        mbar_expect_tx(&bar[s], TB_PRE_TILE * sizeof(bf16));
        bulk_load(sB + s * B_EL, B + ((long long)(t % ntn) * kt_all + kb / TB_BK) * TB_PRE_TILE,
                  TB_PRE_TILE * sizeof(bf16), &bar[s]);
      }
    } else {
      tb_load_tile<!B_N_CONTIG, BN, true>(sB + s * B_EL, B, c.ldb, t % ntn * BN, c.N, kb, k1);
    }
  };

  int t = blockIdx.x;
  if (t < tiles && ktiles > 0) load_stage(t, 0);
  cp_async_commit();
  if (t < tiles && ktiles > 1) load_stage(t, 1);
  cp_async_commit();

  // persistent: this block's tiles t, t + gridDim.x, ...; the next tile's
  // first two stages load while this one's epilogue stores
  for (; t < tiles; t += gridDim.x) {
    const int m0 = t / ntn * TC_BM, n0 = t % ntn * BN;
    const bool do_rsum = rsum != nullptr && n0 == 0;
    float acc[NACC], fr[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f, fr[i] = 0.0f;
    float rs0 = 0.0f, rs1 = 0.0f;
    // acc (and the row sums) -> partial s of this split, then zeroed
    auto store = [&](int s) {
      const long long slot = (long long)z * subs + s;
      OutT* C = static_cast<OutT*>(pick(c.C, g)) + slot * c.c_split_stride;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mr + h * 8;
        if (m >= c.M) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + j * 8 + tq * 2;
          float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n + e >= c.N) continue;
            if (EPI == EPI_BIAS_RELU) v[e] = fmaxf(v[e] + bias[n + e], 0.0f);
            if (EPI == EPI_GATE) v[e] = to_f(gate[(long long)m * c.ldg + n + e]) > 0.0f ? v[e] : 0.0f;
          }
          OutT* o = C + (long long)m * c.ldc + n;
          if constexpr (EPI == EPI_STORE) {
            if (n < c.N) o[0] = v[0];
            if (n + 1 < c.N) o[1] = v[1];
          } else if (n + 1 < c.N) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0], v[1]);
          } else if (n < c.N) {
            o[0] = __float2bfloat16_rn(v[0]);
          }
        }
      }
      if (do_rsum) {  // the four lanes of a row, by a fixed xor tree
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
        if (tq == 0 && m0 + mr < c.M) rsum[slot * c.M + m0 + mr] = rs0;
        if (tq == 0 && m0 + mr + 8 < c.M) rsum[slot * c.M + m0 + mr + 8] = rs1;
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
      rs0 = 0.0f, rs1 = 0.0f;
    };

    for (int kt = 0; kt < ktiles; ++kt) {
      cp_async_wait<1>();  // this thread's copies of stage kt have landed
      fence_proxy_async();  // ... visible to the tensor cores' (async) reads
      __syncthreads();      // everyone's; and stage kt - 1 is free
      if (kt + 2 < ktiles) load_stage(t, kt + 2);
      cp_async_commit();
      const int s = kt % TB_STAGES;
      const bf16* as = sA + s * A_EL;
      const int nk16 = min(TB_BK / 16, (k1 - (k0 + kt * TB_BK) + 15) / 16);
      uint32_t af[TB_BK / 16][4];
      float t0 = 0.0f, t1 = 0.0f;  // this k-tile's row sums
#pragma unroll
      for (int q = 0; q < TB_BK / 16; ++q) {
        const int k = q * 16 + 2 * tq;
        if constexpr (A_K_CONTIG) {
          const bf16* p = as + mr * TB_K_STRIDE + k;
          af[q][0] = ld_b32(p);
          af[q][1] = ld_b32(p + 8 * TB_K_STRIDE);
          af[q][2] = ld_b32(p + 8);
          af[q][3] = ld_b32(p + 8 * TB_K_STRIDE + 8);
        } else {
          constexpr int S = TC_BM + 8;
          const bf16* p = as + k * S + mr;
          // (mr, k), (mr, k + 1), (mr + 8, k), (mr + 8, k + 1), then k + 8, k + 9
          const bf16 x0 = p[0], x1 = p[S], x2 = p[8], x3 = p[S + 8];
          const bf16 y0 = p[8 * S], y1 = p[9 * S], y2 = p[8 * S + 8], y3 = p[9 * S + 8];
          af[q][0] = pack_bf16(x0, x1);
          af[q][1] = pack_bf16(x2, x3);
          af[q][2] = pack_bf16(y0, y1);
          af[q][3] = pack_bf16(y2, y3);
          if (do_rsum && q < nk16) {  // past nk16 the tile holds zeros anyway
            t0 += to_f(x0), t0 += to_f(x1), t0 += to_f(y0), t0 += to_f(y1);
            t1 += to_f(x2), t1 += to_f(x3), t1 += to_f(y2), t1 += to_f(y3);
          }
        }
      }
      rs0 += t0, rs1 += t1;
      const bf16* bs = sB + s * B_EL;
      if constexpr (B_PRE) {  // stage kt's bulk copy has landed
        mbar_wait(&bar[s], (phase >> s) & 1u);
        phase ^= 1u << s;
      }
      reg_fence(fr);
      wg_fence();
#pragma unroll
      for (int q = 0; q < TB_BK / 16; ++q) {
        if (q < nk16) {
          // k groups 2q and 2q + 1 of the core-matrix tile
          const uint64_t db = B_N_CONTIG ? tb_desc(bs + q * 16 * BN, 16 * BN, 128) : tb_desc(bs + q * 128, 128, 1024);
          if constexpr (BN == 128) {
            wgmma_bf16_m64n128k16<B_N_CONTIG ? 1 : 0>(*reinterpret_cast<float(*)[64]>(fr), af[q], db, q);
          } else {
            wgmma_bf16_m64n64k16<B_N_CONTIG ? 1 : 0>(*reinterpret_cast<float(*)[32]>(fr), af[q], db, q);
          }
        }
      }
      wg_commit();
      wg_wait0();
      reg_fence(fr);
#pragma unroll
      for (int q = 0; q < TB_BK / 16; ++q) keep_alive(af[q]);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += fr[i];
      if constexpr (PARTS) {
        if ((kt + 1) % TB_FLUSH == 0 && kt + 1 < ktiles) store(kt / TB_FLUSH);
      }
    }

    __syncthreads();  // every thread is done with this tile's stages
    const int tn = t + gridDim.x;  // the next tile's first stages, before this one's stores
    if (tn < tiles && ktiles > 0) load_stage(tn, 0);
    cp_async_commit();
    if (tn < tiles && ktiles > 1) load_stage(tn, 1);
    cp_async_commit();

    // the last partial, then zeros in those a short (last) split leaves
    const int done = PARTS && ktiles > 0 ? (ktiles - 1) / TB_FLUSH : 0;
    for (int s = done; s < subs; ++s) store(s);
  }
  cp_async_wait<0>();
}

template <bool AK, bool BNC, int EPI, int BN, bool B_PRE = false>
int tb_launch(cudaStream_t st, const GemmCall& c) {
  constexpr int a_el = AK ? TC_BM * TB_K_STRIDE : TB_BK * (TC_BM + 8);
  constexpr int smem = TB_STAGES * (BN * TB_BK + a_el) * (int)sizeof(bf16) + TB_STAGES * (int)sizeof(uint64_t);
  // once per template instance, as tc_launch
  static const cudaError_t attr = cudaFuncSetAttribute(tb_gemm_kernel<AK, BNC, EPI, BN, B_PRE>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = cdiv(c.M, TC_BM) * cdiv(c.N, BN), zs = c.groups * c.splits;
  const int wave = TC_WAVE_BLOCKS * (BN == 64 ? 2 : 1);
  const int per = wave / zs > 1 ? wave / zs : 1;
  dim3 grid(tiles < per ? tiles : per, 1, zs);
  tb_gemm_kernel<AK, BNC, EPI, BN, B_PRE><<<grid, TC_THREADS, smem, st>>>(c);
  return (int)cudaGetLastError();
}

// The bf16 tensor-core engine (see above TB_BK), with TcEngine's interface.
struct TbEngine : EngineShape<TB_BK, TB_FLUSH> {
  static long long weight_floats(int N, int K) { return presplit_bf16_floats(N, K); }
  // every operand's rows 16-byte aligned; a bf16 C written in pairs
  static bool aligned(const GemmCall& c, int epi, bool b_pre) {
    if (c.lda % 8 != 0 || (!b_pre && c.ldb % 8 != 0) || (epi != EPI_STORE && c.ldc % 2 != 0)) return false;
    for (int g = 0; g < c.groups; ++g) {
      if ((uintptr_t)c.A[g] % 16 != 0 || (uintptr_t)c.B[g] % 16 != 0 || (uintptr_t)c.C[g] % 4 != 0) return false;
    }
    return true;
  }
  template <bool AK, bool BNC, int EPI>
  static int run(cudaStream_t st, const GemmCall& c) {
    if (!valid_call(c, AK, EPI) || !aligned(c, EPI, false)) return (int)cudaErrorInvalidValue;
    for (int g = 0; g < c.groups; ++g) {
      if (AK && c.rsum[g]) return (int)cudaErrorInvalidValue;  // row sums need A point-major
    }
    if constexpr (!AK) {
      if (tile_n(AK, c.N) == 128) return tb_launch<AK, BNC, EPI, 128>(st, c);
    }
    return tb_launch<AK, BNC, EPI, 64>(st, c);
  }
  // Each float32 W [rows, cols] of the table as the bf16 B of its forward
  // product (fwd, presplit_bf16_floats(rows, cols) floats) and of its dz
  // product (dz, presplit_bf16_floats(cols, rows)), in one launch:
  // converted, not split
  static int presplit(cudaStream_t st, const PresplitTable& t) {
    if (t.n < 1 || t.n > PRESPLIT_MAX) return (int)cudaErrorInvalidValue;
    // a thread per 8 k of a row
    presplit_bf16_kernel<<<presplit_grid(t, presplit_bf16_floats, 4), ELEM_THREADS, 0, st>>>(t);
    return (int)cudaGetLastError();
  }
  // run<true, *, EPI> with every group's B pre-converted (presplit's fwd or
  // dz for this product); ldb unused
  template <int EPI>
  static int run_presplit(cudaStream_t st, const GemmCall& c) {
    if (!valid_call(c, true, EPI) || !aligned(c, EPI, true)) return (int)cudaErrorInvalidValue;
    for (int g = 0; g < c.groups; ++g) {
      if (c.rsum[g]) return (int)cudaErrorInvalidValue;
    }
    return tb_launch<true, false, EPI, TC_PRE_BN, true>(st, c);
  }
};

// One weight W [rows, cols] pre-split on engine Eng (a table of one)
template <class Eng>
int presplit_one(cudaStream_t st, const float* W, int rows, int cols, float* fwd, float* dz) {
  PresplitTable t{};
  presplit_add(t, W, rows, cols, fwd, dz);
  return Eng::presplit(st, t);
}

// The engine of a pipeline whose activations are stored as T
template <class T>
struct EngineOf {
  using type = TcEngine;
};
template <>
struct EngineOf<bf16> {
  using type = TbEngine;
};

}  // namespace
