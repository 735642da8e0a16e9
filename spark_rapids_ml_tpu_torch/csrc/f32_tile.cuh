// The float32 CUDA-core product tile shared by assign_argmin.cu and
// d2_block.cu (their float32 forms).
//
// One CTA of THREADS threads computes the BM x BN tile of dot products
//     acc[r][j] = a_row(m0 + r) . b_row(n0 + j)
// of two row-major float32 operands a [na, d] and b [nb, d] over the whole
// depth d, then calls the caller's epilogue with its accumulators:
//   * 256 threads of 8 x 8 outputs each; thread (ty, tx) = (tid / 16,
//     tid % 16) owns tile rows row_of(i) (i < 8: 4 ty + i, 64 + 4 ty + i - 4)
//     and tile columns col_of(j) (4 tx + j, 64 + 4 tx + j - 4), read from
//     shared memory as float4 in two 4-wide groups per axis (no bank
//     conflicts);
//   * 8-deep chunks of both operands, stored transposed in shared memory and
//     double-buffered: the next chunk's global loads are in flight during the
//     current chunk's FMAs, and one __syncthreads closes each chunk;
//   * loads are float4 where d % 4 == 0 and both bases are 16-byte aligned,
//     scalar otherwise (VEC, chosen by the caller's wrapper); rows past na or
//     nb and depth past d load as zeros, so the caller pads nothing and masks
//     what it writes;
//   * each output is one fmaf chain in ascending depth order, whatever the
//     other rows hold, so a row's result does not depend on its batch.
// No cuBLAS, and TF32 never enters.

#pragma once

#include <cuda_runtime.h>

namespace srml {
namespace f32core {

constexpr int BM = 128;       // rows of a tile (operand a)
constexpr int BN = 128;       // columns of a tile (operand b rows)
constexpr int BK = 8;         // depth of one shared-memory chunk
constexpr int THREADS = 256;  // 16 x 16 threads of 8 x 8 outputs
constexpr int LD = BM + 4;    // row stride of a transposed chunk: float4-aligned, conflict-free stores

static_assert(BM == BN, "a and b chunks are staged with one index map");
static_assert(BM * BK == THREADS * 4, "each thread stages one float4 of each chunk");

// the tile row of this thread's accumulator row i, and the tile column of
// its accumulator column j
__device__ __forceinline__ int row_of(int i) {
  return (i < 4 ? 0 : 60) + 4 * (threadIdx.x / 16) + i;
}
__device__ __forceinline__ int col_of(int j) {
  return (j < 4 ? 0 : 60) + 4 * (threadIdx.x % 16) + j;
}

// One thread's share of a BM x BK chunk: row `row`, depth col..col+3, as
// zeros past the last row or past d.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ g, int row, int nrows, int col,
                                        int d) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < nrows) {
    const float* p = g + static_cast<long long>(row) * d + col;
    if constexpr (VEC) {
      if (col < d) v = *reinterpret_cast<const float4*>(p);
    } else {
      if (col < d) v.x = p[0];
      if (col + 1 < d) v.y = p[1];
      if (col + 2 < d) v.z = p[2];
      if (col + 3 < d) v.w = p[3];
    }
  }
  return v;
}

// stored transposed: s[depth][row]
__device__ __forceinline__ void stage4(float (&s)[BK][LD], float4 v, int row, int col) {
  s[col][row] = v.x;
  s[col + 1][row] = v.y;
  s[col + 2][row] = v.z;
  s[col + 3][row] = v.w;
}

// The whole tile of one CTA: rows m0.. of a against rows n0.. of b; then
// every thread calls epilogue(acc) with acc[i][j] the dot product of tile
// row row_of(i) and tile column col_of(j). Launch with THREADS threads.
template <bool VEC, class Epilogue>
__device__ __forceinline__ void product_tile(const float* __restrict__ a, int m0, int na,
                                             const float* __restrict__ b, int n0, int nb, int d,
                                             Epilogue&& epilogue) {
  __shared__ __align__(16) float as[2][BK][LD];
  __shared__ __align__(16) float bs[2][BK][LD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4*tx.. and 64 + 4*tx..
  const int ty = tid / 16;  // rows 4*ty.. and 64 + 4*ty..
  const int lr = tid / 2;   // the chunk row this thread loads
  const int lc = 4 * (tid % 2);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra = load4<VEC>(a, m0 + lr, na, lc, d);
  float4 rb = load4<VEC>(b, n0 + lr, nb, lc, d);
  stage4(as[0], ra, lr, lc);
  stage4(bs[0], rb, lr, lc);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < d; k0 += BK) {
    const bool more = k0 + BK < d;
    if (more) {  // the next chunk's loads overlap this chunk's FMAs
      ra = load4<VEC>(a, m0 + lr, na, k0 + BK + lc, d);
      rb = load4<VEC>(b, n0 + lr, nb, k0 + BK + lc, d);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][64 + 4 * tx]);
      const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    if (more) {
      stage4(as[buf ^ 1], ra, lr, lc);
      stage4(bs[buf ^ 1], rb, lr, lc);
    }
    __syncthreads();
    buf ^= 1;
  }
  epilogue(acc);
}

}  // namespace f32core
}  // namespace srml
