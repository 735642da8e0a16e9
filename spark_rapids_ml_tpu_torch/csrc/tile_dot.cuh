// The register-tiled dot-product tile of the float64 distance kernels
// (assign_argmin.cu, d2_block.cu).
//
// One block of THREADS threads computes the BM x BN tile of dot products
//     acc[r][j] = a_row(m0 + r) . b_row(n0 + j)
// of two row-major operands a [na, d] and b [nb, d] over the whole depth d,
// on the CUDA cores: BK-deep chunks of both operands are staged in shared
// memory (transposed, one column of padding against bank conflicts), and
// each thread accumulates a TM x TN sub-tile in registers, one FMA chain per
// dot product in ascending depth order. Rows past na or nb and depth past d
// are loaded as zeros, so the caller pads nothing; the caller masks what it
// writes.
//
// Thread (ty, tx) = (tid / LANES_N, tid % LANES_N) owns tile rows
// ty + LANES_M * i and tile columns tx + LANES_N * jj.

#pragma once

#include <cuda_runtime.h>

namespace srml {

constexpr int BM = 64;                  // rows of a tile (operand a)
constexpr int BN = 64;                  // columns of a tile (operand b)
constexpr int BK = 16;                  // depth of one shared-memory chunk
constexpr int TM = 4;                   // rows per thread
constexpr int TN = 4;                   // columns per thread
constexpr int LANES_N = BN / TN;        // 16 threads across the columns
constexpr int LANES_M = BM / TM;        // 16 threads across the rows
constexpr int THREADS = LANES_N * LANES_M;
constexpr int LOADS = (BM * BK) / THREADS;  // elements of each chunk a thread stages

static_assert(BM == BN, "the loader stages a and b chunks with one index map");
static_assert((BM * BK) % THREADS == 0, "chunk loads must divide evenly");

template <typename T>
__device__ __forceinline__ void tile_dot(const T* __restrict__ a, int m0, int na,
                                         const T* __restrict__ b, int n0, int nb, int d,
                                         T (&as)[BK][BM + 1], T (&bs)[BK][BN + 1],
                                         T (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % LANES_N;
  const int ty = tid / LANES_N;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[i][jj] = T(0);

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int e = tid + THREADS * l;
      const int r = e / BK;
      const int col = e % BK;
      const int gc = k0 + col;
      const int ga = m0 + r;
      const int gb = n0 + r;
      as[col][r] = (ga < na && gc < d) ? a[static_cast<long long>(ga) * d + gc] : T(0);
      bs[col][r] = (gb < nb && gc < d) ? b[static_cast<long long>(gb) * d + gc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T x[TM];
      T y[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) x[i] = as[kk][ty + LANES_M * i];
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) y[jj] = bs[kk][tx + LANES_N * jj];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[i][jj] += x[i] * y[jj];
    }
    __syncthreads();
  }
}

}  // namespace srml
