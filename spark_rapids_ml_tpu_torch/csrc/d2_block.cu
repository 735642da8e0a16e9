// One block of squared distances between a query tile and an item tile,
// without the ||q||^2 term: the inner product of the exact kNN top-k merge.
//
// Replaces the TPU kernel `_pl_d2_block` (spark_rapids_ml_tpu/ops/distance.py).
// For q [B, d], xt [kt, d] and xt_sq [kt] (the items' squared norms) it
// writes
//     out[r, j] = xt_sq[j] - 2 * q_r . xt_j          out [B, kt], row-major
// in the inputs' dtype. The running top-k merge around it stays in PyTorch
// (ops/distance.py topk_tile). Two kernels: the exact one (float32, float64)
// and the `fast` one (serve_dtype="bf16"), which rounds both operands to bf16,
// sums the products in float32 on the tensor cores and casts the sum back
// to the inputs' dtype before the epilogue, as the TPU kernel's `fast` body
// does for float32 and float64 inputs alike.
//
// What bounds it on an H100: operations. 2*B*kt*d FLOP against
// (B*d + kt*d + kt + B*kt) elements moved (at the main path's tile, B = 4096,
// kt = 16384, d = 3000: 4.03e11 FLOP against 0.52 GB in float32, about 780
// FLOP per byte), so the float32 CUDA-core rate (67 TFLOP/s) is the floor:
// 6.0 ms per block, against 0.16 ms for its bytes.
//
// `fast` is bounded by operations too: the same 4.03e11 FLOP at the bf16
// tensor-core rate (989 TFLOP/s) is 0.41 ms per block at the main path's
// tile, and its bytes (0.51 GB in float32) 0.15 ms.
//
// Design of the exact kernel (the first, simple form):
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
// Design of the `fast` kernel (the first, simple form of a tensor-core
// kernel; no wgmma, TMA or cp.async pipeline yet):
//   * Every block owns one 128 x 128 output tile; its 8 warps run the
//     bf16 mma.sync tile of mma_bf16.cuh over 32-deep chunks of the depth,
//     the operands rounded to bf16 as they are staged in shared memory, the
//     next chunk loaded into registers while the current one is multiplied.
//   * The grid runs query tiles on x and item tiles on y, so the blocks in
//     flight share a few item tiles and walk over the query rows (4096 x
//     3000 float32 is 49 MB, about the L2): each item row is read from device
//     memory about once per call.
//   * A depth that is not a multiple of 16 (d = 3000) is zero-filled in
//     shared memory; ragged rows (B, every rung of the serving bucket ladder)
//     and items (kt) are masked at the store.
//
// C interface, bound with ctypes (spark_rapids_ml_tpu_torch/ops/_kernels.py):
// each function launches on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "mma_bf16.cuh"
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

namespace mm = srml::bf16mma;

template <typename T>
__global__ void __launch_bounds__(mm::THREADS)
d2_block_fast_kernel(const T* __restrict__ q, const T* __restrict__ xt,
                     const T* __restrict__ xt_sq, T* __restrict__ out, int B, int kt,
                     int d) {
  __shared__ __align__(16) mm::Tile qs;
  __shared__ __align__(16) mm::Tile xs;

  const int m0 = blockIdx.x * mm::BM;  // query rows
  const int n0 = blockIdx.y * mm::BN;  // items
  float acc[mm::MT][mm::NT][4];
  mm::tile_mma<T>(q, m0, B, xt, n0, kt, d, qs, xs, acc);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm0 = (warp / mm::WARPS_N) * mm::WM;
  const int wn0 = (warp % mm::WARPS_N) * mm::WN;
#pragma unroll
  for (int nt = 0; nt < mm::NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gn = n0 + wn0 + 8 * nt + 2 * (lane % 4) + e;
      if (gn >= kt) continue;
      const T sq = xt_sq[gn];
#pragma unroll
      for (int mt = 0; mt < mm::MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + wm0 + 16 * mt + lane / 4 + 8 * h;
          if (gm < B)
            out[static_cast<long long>(gm) * kt + gn] =
                sq - T(2) * static_cast<T>(acc[mt][nt][2 * h + e]);
        }
      }
    }
  }
}

template <typename T>
int launch_fast(const void* q, const void* xt, const void* xt_sq, void* out, int B,
                int kt, int d, void* stream) {
  const dim3 grid((B + mm::BM - 1) / mm::BM, (kt + mm::BN - 1) / mm::BN);
  d2_block_fast_kernel<T><<<grid, mm::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
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

extern "C" int srml_d2_block_fast_f32(const void* q, const void* xt, const void* xt_sq,
                                      void* out, int B, int kt, int d, void* stream) {
  return launch_fast<float>(q, xt, xt_sq, out, B, kt, d, stream);
}

extern "C" int srml_d2_block_fast_f64(const void* q, const void* xt, const void* xt_sq,
                                      void* out, int B, int kt, int d, void* stream) {
  return launch_fast<double>(q, xt, xt_sq, out, B, kt, d, stream);
}
