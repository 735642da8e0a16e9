// The float64 product tile of assign_argmin.cu and d2_block.cu (their
// float64 forms), on the FP64 tensor cores.
//
// Serves the TPU kernels `_pl_argmin` and `_pl_d2_block`
// (spark_rapids_ml_tpu/ops/distance.py) with float64 inputs and fast=False.
//
// One CTA of THREADS threads computes the BM x BN tile of dot products
//     acc = a_row(m0 + r) . b_row(n0 + j)
// of two row-major float64 operands a [na, d] and b [nb, d] over the whole
// depth d, then calls the caller's epilogue with its accumulators.
//
// What bounds it on an H100: operations. 2*B*k*d FLOP over the FP64
// tensor-core rate (67 TFLOP/s): at B1's Lloyd tile (32768 x 1000 x 3000)
// 196.6 GFLOP = 2.93 ms against 0.8 GB moved (0.24 ms), at B3's kNN tile
// (4096 x 16,384 x 3000) 402.7 GFLOP = 6.01 ms against 1.0 GB (0.31 ms).
// The FP64 CUDA cores give half that rate, and Hopper's `wgmma` has no
// float64 form, so the products go through `mma.sync` with .f64 operands
// (DMMA). What the design does about it:
//   * DMMA shape m16n8k4 (on an H100 it ran 2-5% faster than m16n8k8 and
//     m16n8k16, and m8n8k4 1.7x slower; PERF.md). Fragments are read from
//     shared memory by hand: ldmatrix has no 64-bit form.
//   * A 128 x 128 CTA tile of 8 warps, each warp a 32 x 64 sub-tile: 64
//     float64 accumulators per thread, as many as the register file allows
//     at 256 threads, so each operand byte read from shared memory feeds
//     the most products (16 FLOP per byte of L2 traffic).
//   * Operands are read straight from the caller's rows, with no staging
//     copy, by a ring of 3 cp.async stages of 32-deep chunks: 16-byte
//     cp.async.cg where d is even and both bases are 16-byte aligned (VEC,
//     chosen by the caller's wrapper), the 8-byte form otherwise. Rows past
//     na or nb and depth past d are zero-filled through the copy's source
//     size, so the caller pads nothing and masks what it writes. One
//     barrier per chunk; the loads of the next 2 chunks are in flight during
//     each chunk's products. On an H100, 32-deep chunks in 3 stages
//     (221,184 bytes) ran 5% faster than 16-deep ones in 4, which meet
//     twice the barriers, and 16 warps of 32 x 32 outputs were no faster
//     than 8 (a third more shared-memory reads per DMMA).
//   * Shared-memory rows are padded to LD = BK + 4 doubles, so the 16
//     lanes of each half-warp's fragment load (row lane / 4, depth
//     lane % 4) fall on 16 distinct 8-byte bank pairs.
//   * Each accumulator is summed in ascending DMMA steps over the depth.
//     The tile and the step order depend only on d, never on the number of
//     rows, so a row's result does not depend on the batch it comes in. (On
//     an H100 the outputs equal, bit for bit, those of one fused
//     multiply-add chain in ascending depth, as the CUDA-core tile this one
//     replaced summed them.)
//
// Accumulator layout: warp w (w / WARPS_N along the rows, w % WARPS_N
// along the columns), lane = 4 g + t, holds acc[mt][nt][2 h + e] for tile
// row row_of(mt, h) = WM (w / WARPS_N) + 16 mt + g + 8 h and tile column
// col_of(nt, e) = WN (w % WARPS_N) + 8 nt + 2 t + e.

#pragma once

#include <cuda_runtime.h>

namespace srml {
namespace f64tc {

constexpr int BM = 128;      // rows of a tile (operand a)
constexpr int BN = 128;      // columns of a tile (operand b rows)
constexpr int BK = 32;       // depth of one shared-memory chunk
constexpr int STAGES = 3;    // chunks in the cp.async ring
constexpr int THREADS = 256;  // 8 warps
constexpr int LD = BK + 4;   // row stride in shared memory, in doubles
constexpr int WM = 32;       // rows of a warp's sub-tile
constexpr int WN = 64;       // its columns
constexpr int WARPS_N = BN / WN;
constexpr int MMA_K = 4;     // depth of one m16n8k4 DMMA step

constexpr int MT = WM / 16;  // DMMA tiles along a warp's rows
constexpr int NT = WN / 8;   // and along its columns
constexpr int STAGE_DOUBLES = (BM + BN) * LD;
constexpr int SMEM_BYTES = STAGES * STAGE_DOUBLES * 8;

static_assert((BM / WM) * WARPS_N * 32 == THREADS, "one warp per sub-tile");
static_assert(BK % MMA_K == 0, "a chunk holds whole DMMA steps");
static_assert((LD * 8) % 16 == 0 && LD % 16 == 4, "16-byte aligned, conflict-free rows");
static_assert(SMEM_BYTES <= 232448, "more shared memory than a Hopper CTA may have");

__device__ __forceinline__ int warp_row0() { return WM * (threadIdx.x / 32 / WARPS_N); }
__device__ __forceinline__ int warp_col0() { return WN * (threadIdx.x / 32 % WARPS_N); }

// the tile row of accumulators acc[mt][*][2 h + e], and the tile column of
// acc[*][nt][2 h + e]
__device__ __forceinline__ int row_of(int mt, int h) {
  return warp_row0() + 16 * mt + (threadIdx.x % 32) / 4 + 8 * h;
}
__device__ __forceinline__ int col_of(int nt, int e) {
  return warp_col0() + 8 * nt + 2 * (threadIdx.x % 4) + e;
}

// ------------------------------------------------------------ cp.async ----

__device__ __forceinline__ void cp_async16(double* dst, const double* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One operand's BK-deep chunk at depth k0 into s [rows][LD]: rows r0.. of
// g [n, d], zeros past row n and past depth d (a source size of 0 reads
// nothing; the address then stays g itself, which is valid). A thread
// copies the same depth of every ROW_STEP-th row, walking one pointer down
// them.
template <bool VEC>
__device__ __forceinline__ void load_chunk(double* s, const double* __restrict__ g, int r0, int n,
                                           int d, int k0) {
  constexpr int PER_ROW = VEC ? BK / 2 : BK;      // copies per chunk row
  constexpr int ROW_STEP = THREADS / PER_ROW;     // rows between a thread's copies
  constexpr int COPIES = BM / ROW_STEP;           // per thread
  static_assert(BM == BN && THREADS % PER_ROW == 0 && BM % ROW_STEP == 0,
                "a and b chunks are loaded with one index map");
  const int r = threadIdx.x / PER_ROW;
  const int col = (VEC ? 2 : 1) * (threadIdx.x % PER_ROW);
  const bool depth_in = k0 + col < d;  // VEC: d even, so a pair is whole or outside
  const double* p = g + static_cast<long long>(r0 + r) * d + k0 + col;
  double* dst = s + r * LD + col;
#pragma unroll
  for (int l = 0; l < COPIES; ++l) {
    const bool in = depth_in && r0 + r + ROW_STEP * l < n;
    if constexpr (VEC) {
      cp_async16(dst, in ? p : g, in ? 16 : 0);
    } else {
      cp_async8(dst, in ? p : g, in ? 8 : 0);
    }
    p += static_cast<long long>(ROW_STEP) * d;
    dst += ROW_STEP * LD;
  }
}

// ---------------------------------------------------------------- DMMA ----

// c += a b over one m16n8k4 step: c holds rows g and g + 8, columns 2 t
// and 2 t + 1; a rows g and g + 8 at depth t; b item g at depth t
// (lane = 4 g + t)
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[2], double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// The products of one chunk held in shared memory (as [BM][LD], then
// [BN][LD]), in ascending DMMA steps.
__device__ __forceinline__ void chunk_products(const double* __restrict__ as,
                                               const double* __restrict__ bs,
                                               double (&acc)[MT][NT][4]) {
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const double* a0 = as + (warp_row0() + g) * LD + t;
  const double* b0 = bs + (warp_col0() + g) * LD + t;
#pragma unroll
  for (int kk = 0; kk < BK; kk += MMA_K) {
    double af[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      af[mt][0] = a0[16 * mt * LD + kk];
      af[mt][1] = a0[(16 * mt + 8) * LD + kk];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const double bf = b0[8 * nt * LD + kk];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma(acc[mt][nt], af[mt], bf);
    }
  }
}

// The whole tile of one CTA: rows m0.. of a against rows n0.. of b; then
// every thread calls epilogue(acc, smem) (acc's layout in the note above).
// Launch with THREADS threads and SMEM_BYTES of dynamic shared memory; the
// epilogue may reuse that shared memory, `smem` (every copy has landed and
// every warp has left the products when it is called).
template <bool VEC, class Epilogue>
__device__ __forceinline__ void product_tile(const double* __restrict__ a, int m0, int na,
                                             const double* __restrict__ b, int n0, int nb, int d,
                                             Epilogue&& epilogue) {
  extern __shared__ __align__(16) double smem[];
  const int nk = (d + BK - 1) / BK;
  auto load = [&](int kc) {
    double* s = smem + (kc % STAGES) * STAGE_DOUBLES;
    load_chunk<VEC>(s, a, m0, na, d, kc * BK);
    load_chunk<VEC>(s + BM * LD, b, n0, nb, d, kc * BK);
  };

  double acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();  // an empty group past the depth keeps the count uniform
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk kc have landed
    __syncthreads();              // everyone's have, and chunk kc - 1 is consumed
    if (kc + STAGES - 1 < nk) load(kc + STAGES - 1);  // into chunk kc - 1's stage
    cp_async_commit();
    const double* as = smem + (kc % STAGES) * STAGE_DOUBLES;
    chunk_products(as, as + BM * LD, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
  epilogue(acc, smem);
}

}  // namespace f64tc
}  // namespace srml
