// One block of squared distances between a query tile and an item tile,
// without the ||q||^2 term: the inner product of the exact kNN top-k merge.
//
// Replaces the TPU kernel `_pl_d2_block` (spark_rapids_ml_tpu/ops/distance.py).
// For q [B, d], xt [kt, d] and xt_sq [kt] (the items' squared norms) it
// writes
//     out[r, j] = xt_sq[j] - 2 * q_r . xt_j          out [B, kt], row-major
// in the inputs' dtype. The running top-k merge around it stays in PyTorch
// (ops/distance.py topk_tile).
//
// What bounds it on an H100: operations. 2*B*kt*d FLOP against
// (B*d + kt*d + kt + B*kt) elements moved (at the main path's tile, B = 4096,
// kt = 16384, d = 3000: 4.03e11 FLOP against 0.52 GB in float32, about 780
// FLOP per byte), so the float32 CUDA-core rate (67 TFLOP/s) is the floor:
// 6.0 ms per block, against 0.16 ms for its bytes.
//
// Design (the first, simple form; tensor cores are later work):
//   * The TPU kernel held the whole item tile in VMEM and ran its grid over
//     row blocks only. A Hopper block has at most 227 KB of shared memory,
//     so here every block owns one 64 x 64 tile of the output, and the grid
//     covers both axes (item blocks on x, row blocks on y): 256 x 64 = 16,384
//     blocks at the main path's tile, enough to fill 132 SMs many times.
//   * Each tile is the register-tiled CUDA-core product of tile_dot.cuh,
//     the same loop as assign_argmin.cu: BK-deep chunks over d in shared
//     memory, a 4 x 4 sub-tile of dot products per thread, each summed in
//     one FMA chain in ascending depth order. The product is this kernel's
//     own work: no cuBLAS, and TF32 never enters.
//   * The epilogue forms xt_sq[j] - 2*dot and stores it; ragged rows (B) and
//     items (kt) are masked at the store, and a depth that is not a multiple
//     of BK is zero-padded in shared memory, so the caller pads nothing.
//     Sixteen neighbouring threads store sixteen neighbouring columns of a
//     row.
//
// C interface, bound with ctypes (spark_rapids_ml_tpu_torch/ops/_kernels.py):
// each function launches on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "tile_dot.cuh"

namespace {

using namespace srml;

template <typename T>
__global__ void __launch_bounds__(THREADS)
d2_block_kernel(const T* __restrict__ q, const T* __restrict__ xt,
                const T* __restrict__ xt_sq, T* __restrict__ out, int B, int kt,
                int d) {
  __shared__ T qs[BK][BM + 1];
  __shared__ T xs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % LANES_N;  // item lane: items tx + LANES_N * jj
  const int ty = tid / LANES_N;  // row lane: rows ty + LANES_M * i
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  T acc[TM][TN];
  tile_dot<T, false>(q, m0, B, xt, n0, kt, d, qs, xs, acc);

#pragma unroll
  for (int jj = 0; jj < TN; ++jj) {
    const int gn = n0 + tx + LANES_N * jj;
    if (gn < kt) {
      const T sq = xt_sq[gn];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int gm = m0 + ty + LANES_M * i;
        if (gm < B) out[static_cast<long long>(gm) * kt + gn] = sq - T(2) * acc[i][jj];
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* xt, const void* xt_sq, void* out, int B,
           int kt, int d, void* stream) {
  const dim3 grid((kt + BN - 1) / BN, (B + BM - 1) / BM);
  d2_block_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(xt), static_cast<const T*>(xt_sq),
      static_cast<T*>(out), B, kt, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int srml_d2_block_f32(const void* q, const void* xt, const void* xt_sq,
                                 void* out, int B, int kt, int d, void* stream) {
  return launch<float>(q, xt, xt_sq, out, B, kt, d, stream);
}

extern "C" int srml_d2_block_f64(const void* q, const void* xt, const void* xt_sq,
                                 void* out, int B, int kt, int d, void* stream) {
  return launch<double>(q, xt, xt_sq, out, B, kt, d, stream);
}
