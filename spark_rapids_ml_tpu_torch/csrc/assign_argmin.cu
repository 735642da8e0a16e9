// Fused distance plus running argmin over all centers, for one tile of rows.
//
// Replaces the TPU kernel `_pl_argmin` (spark_rapids_ml_tpu/ops/distance.py).
// For each row x_r of x [B, d] it returns
//     mind[r] = min_j (c_sq[j] - 2 * x_r . c_j)      (||x_r||^2 left out)
//     best[r] = the first j reaching that minimum
// without ever storing the [B, k] distance matrix.
//
// What bounds it on an H100: operations. 2*B*k*d multiply-adds against
// B*d + k*d elements read (at the main path's tile, B = 32768, d = 3000,
// k = 1000: 1.97e11 FLOP against 0.4 GB, about 490 FLOP per byte), so the
// float32 CUDA-core rate (67 TFLOP/s) or, for `fast`, the bf16 tensor-core
// rate (989 TFLOP/s) is the floor.
//
// Design (the first, simple form; tensor cores are later work):
//   * A block owns BM rows and loops over ALL center tiles itself. On the
//     TPU the k blocks were a sequential grid axis carrying the running
//     minimum from step to step; Hopper runs blocks in no order, so the
//     loop over center tiles moves inside the block and the running
//     (min, index) lives in registers.
//   * Each center tile is a BM x BN register-tiled product (tile_dot.cuh,
//     shared with d2_block.cu): BK-deep chunks of x and c are staged in
//     shared memory (transposed, padded against bank conflicts) and every
//     thread accumulates a TM x TN tile of dot products over the whole
//     depth d, then forms c_sq[j] - 2*dot.
//   * Ragged rows, centers beyond k and a depth that is not a multiple of BK
//     are masked here; the caller pads nothing.
//   * Ties: inside a thread the centers are scanned in ascending order with a
//     strict '<', so the first index wins; the reduction ACROSS the threads
//     that share a row breaks equal minima by the lower index explicitly.
//     NaN counts as the minimum, as torch.min and jnp.min propagate it.
//   * `fast`: every loaded element is rounded to bf16 with
//     __float2bfloat16_rn (round to nearest even, as JAX's astype(bfloat16)),
//     and the products are summed in float32. Products of two bf16 values
//     are exact in float32, so this is the arithmetic of a bf16 matrix unit
//     with float32 accumulation. For float64 inputs the float32 dot products
//     are widened back and the epilogue (c_sq - 2*dot, the running minimum)
//     stays in float64, as the TPU kernel's `fast` body casts its product
//     back to the input dtype.
//
// C interface, bound with ctypes (spark_rapids_ml_tpu_torch/ops/_kernels.py):
// each function launches on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "tile_dot.cuh"

namespace {

using namespace srml;

// Whether candidate (v, j) replaces the current (bv, bj): the smaller value,
// NaN before any number, and the lower index on equal values.
template <typename T>
__device__ __forceinline__ bool take(T v, int j, T bv, int bj) {
  const bool v_nan = v != v;
  const bool b_nan = bv != bv;
  if (v_nan != b_nan) return v_nan;
  if (v_nan) return j < bj;
  return v < bv || (v == bv && j < bj);
}

template <typename T, bool FAST>
__global__ void __launch_bounds__(THREADS)
assign_argmin_kernel(const T* __restrict__ x, const T* __restrict__ c,
                     const T* __restrict__ c_sq, T* __restrict__ mind,
                     int* __restrict__ best, int B, int k, int d) {
  using A = acc_t<T, FAST>;
  __shared__ A xs[BK][BM + 1];
  __shared__ A cs[BK][BN + 1];
  __shared__ T red_v[BM][LANES_N + 1];
  __shared__ int red_j[BM][LANES_N + 1];

  const int tid = threadIdx.x;
  const int tx = tid % LANES_N;  // center lane: centers tx + LANES_N * jj
  const int ty = tid / LANES_N;  // row lane: rows ty + LANES_M * i
  const int m0 = blockIdx.x * BM;

  T run_v[TM];
  int run_j[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    run_v[i] = static_cast<T>(INFINITY);
    run_j[i] = INT_MAX;
  }

  for (int n0 = 0; n0 < k; n0 += BN) {
    A acc[TM][TN];
    tile_dot<T, FAST>(x, m0, B, c, n0, k, d, xs, cs, acc);

    // centers of this thread in ascending order: the strict '<' in take()
    // keeps the first index on ties
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int gn = n0 + tx + LANES_N * jj;
      if (gn < k) {
        const T csq = c_sq[gn];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const T v = csq - T(2) * static_cast<T>(acc[i][jj]);
          if (take(v, gn, run_v[i], run_j[i])) {
            run_v[i] = v;
            run_j[i] = gn;
          }
        }
      }
    }
  }

  // merge the LANES_N candidates of each row, lower index first on ties
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    red_v[ty + LANES_M * i][tx] = run_v[i];
    red_j[ty + LANES_M * i][tx] = run_j[i];
  }
  __syncthreads();
  if (tid < BM && m0 + tid < B) {
    T bv = red_v[tid][0];
    int bj = red_j[tid][0];
    for (int t = 1; t < LANES_N; ++t) {
      const T v = red_v[tid][t];
      const int j = red_j[tid][t];
      if (take(v, j, bv, bj)) {
        bv = v;
        bj = j;
      }
    }
    mind[m0 + tid] = bv;
    best[m0 + tid] = bj;
  }
}

template <typename T, bool FAST>
int launch(const void* x, const void* c, const void* c_sq, void* mind,
           void* best, int B, int k, int d, void* stream) {
  const dim3 grid((B + BM - 1) / BM);
  assign_argmin_kernel<T, FAST><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(c), static_cast<const T*>(c_sq),
      static_cast<T*>(mind), static_cast<int*>(best), B, k, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int srml_assign_argmin_f32(const void* x, const void* c, const void* c_sq,
                                      void* mind, void* best, int B, int k, int d,
                                      int fast, void* stream) {
  return fast ? launch<float, true>(x, c, c_sq, mind, best, B, k, d, stream)
              : launch<float, false>(x, c, c_sq, mind, best, B, k, d, stream);
}

extern "C" int srml_assign_argmin_f64(const void* x, const void* c, const void* c_sq,
                                      void* mind, void* best, int B, int k, int d,
                                      int fast, void* stream) {
  return fast ? launch<double, true>(x, c, c_sq, mind, best, B, k, d, stream)
              : launch<double, false>(x, c, c_sq, mind, best, B, k, d, stream);
}
