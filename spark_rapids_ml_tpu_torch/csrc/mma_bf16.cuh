// The bf16 tensor-core tile shared by the `fast` distance kernels
// (d2_block.cu; assign_argmin's tensor-core form is later work).
//
// One block of THREADS threads computes the BM x BN tile of dot products
//     acc[r][j] = bf16(a_row(m0 + r)) . bf16(b_row(n0 + j))
// of two row-major operands a [na, d] and b [nb, d] over the whole depth d,
// with float32 accumulation, on the tensor cores:
//
//   * BK-deep chunks of both operands are loaded from device memory in their
//     own type (float or double; neighbouring threads read neighbouring
//     columns of a row), rounded to bf16 with __float2bfloat16_rn (round to
//     nearest even, as torch's .to(torch.bfloat16) and JAX's astype; a double
//     is cast to float first, which is what both of those do too), and
//     stored in shared memory row-major with a padded row stride of LDS
//     values (80 bytes: every ldmatrix row stays 16-byte aligned and the
//     eight rows of one 8 x 8 matrix fall in distinct banks). Rows past na or
//     nb and depth past d are stored as zeros, which add nothing.
//   * The next chunk is loaded into registers while the tensor cores work on
//     the current one (one chunk of register prefetch; no cp.async or TMA).
//   * The 8 warps form a WARPS_M x WARPS_N grid; each owns a WM x WN sub-tile
//     (MT x NT fragments of 16 x 8) and feeds
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 from ldmatrix.x4
//     loads: A fragments straight from the row-major a tile, B fragments
//     from the row-major b tile (its rows are the columns of the product).
//
// Every output entry is one float32 sum of the same products in the same
// order whatever the tile's other rows hold, so a row's result does not
// depend on the batch it comes in. Products of two bf16 values are exact in
// float32, so integer-valued inputs whose sums stay below 2^24 give exact
// results.
//
// Accumulator layout (the m16n8 C fragment): lane (g, t) = (lane / 4,
// lane % 4) of a warp holds acc[mt][nt][2 * h + e] for tile row
// wm0 + 16 * mt + g + 8 * h and tile column wn0 + 8 * nt + 2 * t + e.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace srml {
namespace bf16mma {

constexpr int BM = 128;                 // rows of a tile (operand a)
constexpr int BN = 128;                 // columns of a tile (operand b)
constexpr int BK = 32;                  // depth of one shared-memory chunk
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;        // 64 rows per warp
constexpr int WN = BN / WARPS_N;        // 32 columns per warp
constexpr int MT = WM / 16;             // m16 fragments per warp
constexpr int NT = WN / 8;              // n8 fragments per warp
constexpr int LDS = BK + 8;             // shared row stride in bf16 values
constexpr int PAIRS = BM * BK / 2 / THREADS;  // bf16 pairs a thread stages per operand

static_assert(BM == BN, "both operands are staged with one index map");
static_assert((BM * BK / 2) % THREADS == 0, "chunk loads must divide evenly");
static_assert((LDS * 2) % 16 == 0, "ldmatrix rows must stay 16-byte aligned");
static_assert(NT % 2 == 0, "B fragments are loaded two n8 tiles at a time");

using Tile = __nv_bfloat16[BM][LDS];

// One thread's share of a BM x BK chunk of a row-major operand, held in
// registers between its load from device memory and its store to shared
// memory: pair p covers tile row e / (BK / 2), columns 2 * (e % (BK / 2))
// and one more, with e = threadIdx.x + THREADS * p.
template <typename T>
struct Chunk {
  T v[PAIRS][2];

  __device__ __forceinline__ void load(const T* __restrict__ g, int row0, int nrows,
                                       int k0, int d) {
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int e = threadIdx.x + THREADS * p;
      const int gr = row0 + e / (BK / 2);
      const int gc = k0 + 2 * (e % (BK / 2));
      const bool row_ok = gr < nrows;
      const T* src = g + static_cast<long long>(gr) * d + gc;
      v[p][0] = (row_ok && gc < d) ? src[0] : T(0);
      v[p][1] = (row_ok && gc + 1 < d) ? src[1] : T(0);
    }
  }

  __device__ __forceinline__ void store(Tile& s) const {
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int e = threadIdx.x + THREADS * p;
      *reinterpret_cast<__nv_bfloat162*>(&s[e / (BK / 2)][2 * (e % (BK / 2))]) =
          __floats2bfloat162_rn(static_cast<float>(v[p][0]), static_cast<float>(v[p][1]));
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += the warp's WM x WN sub-tile of as . bs^T over one BK-deep chunk.
__device__ __forceinline__ void warp_mma(const Tile& as, const Tile& bs, int wm0, int wn0,
                                         float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MT][4];
    uint32_t b[NT][2];
    // A: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
    // (rows 8-15, k 8-15) -> a0..a3; lane l gives the address of row l % 16
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(a[mt], &as[wm0 + 16 * mt + lane % 16][kk + 8 * (lane / 16)]);
    // B: matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
    // (n 8-15, k 8-15) -> b0, b1 of two neighbouring n8 fragments
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, &bs[wn0 + 16 * np + 8 * (lane / 16) + lane % 8][kk + 8 * ((lane / 8) % 2)]);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_16816(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// The whole tile: acc (zeroed here) = bf16(a rows m0..) . bf16(b rows n0..)
// over the depth d. as and bs are the block's shared tiles.
template <typename T>
__device__ __forceinline__ void tile_mma(const T* __restrict__ a, int m0, int na,
                                         const T* __restrict__ b, int n0, int nb, int d,
                                         Tile& as, Tile& bs, float (&acc)[MT][NT][4]) {
  const int warp = threadIdx.x / 32;
  const int wm0 = (warp / WARPS_N) * WM;
  const int wn0 = (warp % WARPS_N) * WN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  Chunk<T> ca, cb;
  ca.load(a, m0, na, 0, d);
  cb.load(b, n0, nb, 0, d);
  for (int k0 = 0; k0 < d; k0 += BK) {
    ca.store(as);
    cb.store(bs);
    __syncthreads();
    if (k0 + BK < d) {  // the next chunk's loads overlap this chunk's products
      ca.load(a, m0, na, k0 + BK, d);
      cb.load(b, n0, nb, k0 + BK, d);
    }
    warp_mma(as, bs, wm0, wn0, acc);
    __syncthreads();
  }
}

}  // namespace bf16mma
}  // namespace srml
