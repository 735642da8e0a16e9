// Fused distance plus argmin over all centers, for one tile of rows.
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
// float32 CUDA-core rate (67 TFLOP/s), for float64 the FP64 tensor-core
// rate (67 TFLOP/s) or, for `fast`, the bf16 tensor-core rate (989 TFLOP/s)
// is the floor.
//
// Design. On the TPU the center blocks were a sequential grid axis carrying
// the running minimum from step to step. Hopper runs blocks in no order, so
// the work is split in two passes:
//   1. One CTA per (row tile, center tile), center tiles fastest in the
//      launch order, so the CTAs of one row tile run side by side and read
//      x from L2 after the first has read it from device memory. Each
//      computes its tile of dot products and, in registers, the
//      (value, index) minimum of each row over the tile's centers (the
//      per-tile epilogue, `tile_min`), written to scratch [n_ct, B].
//   2. `argmin_merge` reduces each row's n_ct candidates in ascending
//      center-tile order.
// The tie rule lives in `take`, used by those two alone: the smaller value,
// NaN before any number (as torch.min and jnp.min propagate it), the lower
// index on equal values. The grid and the tiles are the same for every B,
// and each dot product is one fixed sum, so a row's result does not depend
// on the batch it comes in.
//
// The products of pass 1:
//   * float32: the CUDA-core tile of f32_tile.cuh (shared with d2_block.cu),
//     128 rows x 128 centers, 256 threads of 8 x 8 outputs each, 8-deep
//     double-buffered chunks. Loads are float4 where d % 4 == 0 and both
//     bases are 16-byte aligned, scalar otherwise (the VEC template
//     argument, chosen by the wrapper). One FMA chain per output in
//     ascending depth order.
//   * `fast` (float32 or float64 inputs): the wrapper stages both operands
//     as bf16 (round to nearest even; float64 through float32) into buffers
//     whose rows are padded to whole tiles and whose depth is padded with
//     zeros to a multiple of 64; the product is the TMA + wgmma tile of
//     wgmma_bf16.cuh, 128 rows x 256 centers, float32 sums. For float64 the
//     sums are widened back and the epilogue (c_sq - 2*dot, the minimum)
//     stays in float64, as the TPU kernel's `fast` body casts its product
//     back to the input dtype.
//   * float64: the FP64 tensor-core (DMMA) tile of f64_tile.cuh (shared
//     with d2_block.cu), 128 rows x 128 centers, 8 warps of 32 x 64
//     outputs, a 3-stage cp.async ring of 32-deep chunks read straight from
//     x and c (16-byte copies where d is even and both bases are 16-byte
//     aligned, the VEC template argument chosen by the wrapper; 8-byte
//     copies otherwise). The two warps that share a row each reduce their
//     64 centers, then exchange their candidates through shared memory.
// Centers at or past k are skipped by index in the epilogue, whatever their
// padded values.
//
// C interface, bound with ctypes (spark_rapids_ml_tpu_torch/ops/_kernels.py):
// each function launches on `stream` and returns cudaGetLastError() (or the
// first error of its set-up).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

#include "f32_tile.cuh"
#include "f64_tile.cuh"
#include "wgmma_bf16.cuh"

namespace {

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

// Per-tile epilogue. A thread scans its own centers of one row in ascending
// order (`scan`), then the LANES neighbouring lanes that share the row
// exchange their candidates (`lane_min`).
template <typename T>
struct tile_min {
  T v = static_cast<T>(INFINITY);
  int j = INT_MAX;

  __device__ __forceinline__ void scan(T cand, int jc) {
    if (take(cand, jc, v, j)) {
      v = cand;
      j = jc;
    }
  }

  template <int LANES>
  __device__ __forceinline__ void lane_min() {
#pragma unroll
    for (int o = LANES / 2; o > 0; o /= 2) {
      const T ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oj = __shfl_xor_sync(0xffffffffu, j, o);
      scan(ov, oj);
    }
  }

  __device__ __forceinline__ void store(T* pv, int* pj, int ct, int B, int r) const {
    const size_t i = static_cast<size_t>(ct) * B + r;
    pv[i] = v;
    pj[i] = j;
  }
};

// ------------------------------------------------ float32: CUDA cores ----

namespace f32core = srml::f32core;

template <bool VEC>
__global__ void __launch_bounds__(f32core::THREADS, 2)
argmin_f32_tiles(const float* __restrict__ x, const float* __restrict__ c,
                 const float* __restrict__ c_sq, float* __restrict__ pv, int* __restrict__ pj,
                 int B, int k, int d, int n_ct) {
  const int ct = blockIdx.x % n_ct;
  const int m0 = (blockIdx.x / n_ct) * f32core::BM;
  const int n0 = ct * f32core::BN;
  f32core::product_tile<VEC>(x, m0, B, c, n0, k, d, [&](const float (&acc)[8][8]) {
    float csq[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + f32core::col_of(j);
      csq[j] = gn < k ? c_sq[gn] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      tile_min<float> m;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // this thread's centers, ascending
        const int gn = n0 + f32core::col_of(j);
        if (gn < k) m.scan(csq[j] - 2.f * acc[i][j], gn);
      }
      m.lane_min<16>();  // the 16 lanes of one row group
      const int r = m0 + f32core::row_of(i);
      if (threadIdx.x % 16 == 0 && r < B) m.store(pv, pj, ct, B, r);
    }
  });
}

// ------------------------------------------------ float64: DMMA tile ----

namespace f64tc = srml::f64tc;

template <bool VEC>
__global__ void __launch_bounds__(f64tc::THREADS, 1)
argmin_f64_tiles(const double* __restrict__ x, const double* __restrict__ c,
                 const double* __restrict__ c_sq, double* __restrict__ pv, int* __restrict__ pj,
                 int B, int k, int d, int n_ct) {
  using f64tc::MT;
  using f64tc::NT;
  const int ct = blockIdx.x % n_ct;
  const int m0 = (blockIdx.x / n_ct) * f64tc::BM;
  const int n0 = ct * f64tc::BN;
  f64tc::product_tile<VEC>(x, m0, B, c, n0, k, d,
                           [&](const double (&acc)[MT][NT][4], double* smem) {
    double csq[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gn = n0 + f64tc::col_of(nt, e);
        csq[nt][e] = gn < k ? c_sq[gn] : 0.0;
      }
    // each row's candidate from each of the WARPS_N warps across the columns
    double* cv = smem;                                           // [WARPS_N][BM]
    int* cj = reinterpret_cast<int*>(smem + f64tc::WARPS_N * f64tc::BM);  // [WARPS_N][BM]
    const int wn = threadIdx.x / 32 % f64tc::WARPS_N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tile_min<double> m;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)  // this thread's centers, ascending
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int gn = n0 + f64tc::col_of(nt, e);
            if (gn < k) m.scan(csq[nt][e] - 2.0 * acc[mt][nt][2 * h + e], gn);
          }
        m.lane_min<4>();  // the quad that shares the row
        if (threadIdx.x % 4 == 0) {
          const int i = wn * f64tc::BM + f64tc::row_of(mt, h);
          cv[i] = m.v;
          cj[i] = m.j;
        }
      }
    __syncthreads();
    if (threadIdx.x < f64tc::BM) {
      tile_min<double> m;
#pragma unroll
      for (int w = 0; w < f64tc::WARPS_N; ++w)
        m.scan(cv[w * f64tc::BM + threadIdx.x], cj[w * f64tc::BM + threadIdx.x]);
      const int r = m0 + threadIdx.x;
      if (r < B) m.store(pv, pj, ct, B, r);
    }
  });
}

// ------------------------------------------- fast: bf16 TMA + wgmma -------

namespace wg = srml::wgmma_bf16;

template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
argmin_fast_tiles(__grid_constant__ const CUtensorMap map_x, __grid_constant__ const CUtensorMap map_c,
                  const T* __restrict__ c_sq, T* __restrict__ pv, int* __restrict__ pj, int B,
                  int k, int nk, int n_ct) {
  const int ct = blockIdx.x % n_ct;
  const int m0 = (blockIdx.x / n_ct) * wg::BM;
  const int n0 = ct * wg::BN;
  wg::product_tile(map_x, map_c, m0, n0, nk, [&](const float (&acc)[wg::ACC], int w) {
    const int t = threadIdx.x % 128;
    tile_min<T> m[2];  // rows r and r + 8
#pragma unroll
    for (int n = 0; n < wg::BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // this thread's centers, ascending
        const int gn = n0 + 8 * n + 2 * (t % 4) + e;
        if (gn < k) {
          const T csq = c_sq[gn];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            m[h].scan(csq - T(2) * static_cast<T>(acc[4 * n + 2 * h + e]), gn);
        }
      }
    const int r = m0 + 64 * w + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h].template lane_min<4>();  // the quad that shares the row
      if (t % 4 == 0 && r + 8 * h < B) m[h].store(pv, pj, ct, B, r + 8 * h);
    }
  });
}

// --------------------------------------------------------- second pass ----

template <typename T>
__global__ void argmin_merge(const T* __restrict__ pv, const int* __restrict__ pj,
                             T* __restrict__ mind, int* __restrict__ best, int B, int n_ct) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  T bv = pv[r];
  int bj = pj[r];
  for (int ct = 1; ct < n_ct; ++ct) {  // ascending center tiles
    const size_t i = static_cast<size_t>(ct) * B + r;
    if (take(pv[i], pj[i], bv, bj)) {
      bv = pv[i];
      bj = pj[i];
    }
  }
  mind[r] = bv;
  best[r] = bj;
}

int grid_of(int B, int rows, int n_ct) { return ((B + rows - 1) / rows) * n_ct; }

template <typename T>
int launch_fast(const void* xs, const void* cs, const void* c_sq, void* pv, void* pj, int B,
                int Bp, int k, int kp, int dp, void* stream) {
  CUtensorMap map_x, map_c;
  int e = wg::encode_rows(&map_x, xs, Bp, dp, wg::BM);
  if (e == 0) e = wg::encode_rows(&map_c, cs, kp, dp, wg::BN);
  if (e != 0) return e;
  // the ring needs more than the default 48 KB of shared memory; setting it
  // on every call keeps it right on whichever device is current
  const cudaError_t a = cudaFuncSetAttribute(
      argmin_fast_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_BYTES);
  if (a != cudaSuccess) return static_cast<int>(a);
  const int n_ct = kp / wg::BN;
  argmin_fast_tiles<T><<<grid_of(Bp, wg::BM, n_ct), wg::THREADS, wg::SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      map_x, map_c, static_cast<const T*>(c_sq), static_cast<T*>(pv), static_cast<int*>(pj), B, k,
      dp / wg::BK, n_ct);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_merge(const void* pv, const void* pj, void* mind, void* best, int B, int n_ct,
                 void* stream) {
  argmin_merge<T><<<(B + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pv), static_cast<const int*>(pj), static_cast<T*>(mind),
      static_cast<int*>(best), B, n_ct);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pass 1, float32 on the CUDA cores: partials [ceil(k / 128), B]. `vec`
// selects float4 loads (d % 4 == 0 and 16-byte aligned bases).
extern "C" int srml_argmin_tiles_f32(const void* x, const void* c, const void* c_sq, void* pv,
                                     void* pj, int B, int k, int d, int vec, void* stream) {
  const int n_ct = (k + f32core::BN - 1) / f32core::BN;
  const dim3 grid(grid_of(B, f32core::BM, n_ct));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* cf = static_cast<const float*>(c);
  const auto* qf = static_cast<const float*>(c_sq);
  if (vec)
    argmin_f32_tiles<true><<<grid, f32core::THREADS, 0, s>>>(
        xf, cf, qf, static_cast<float*>(pv), static_cast<int*>(pj), B, k, d, n_ct);
  else
    argmin_f32_tiles<false><<<grid, f32core::THREADS, 0, s>>>(
        xf, cf, qf, static_cast<float*>(pv), static_cast<int*>(pj), B, k, d, n_ct);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1, float64 on the FP64 tensor cores: partials [ceil(k / 128), B].
// `vec` selects 16-byte copies (d even and 16-byte aligned bases).
extern "C" int srml_argmin_tiles_f64(const void* x, const void* c, const void* c_sq, void* pv,
                                     void* pj, int B, int k, int d, int vec, void* stream) {
  // the ring needs more than the default 48 KB of shared memory; setting it
  // on every call keeps it right on whichever device is current
  const auto kernel = vec ? &argmin_f64_tiles<true> : &argmin_f64_tiles<false>;
  const cudaError_t a =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f64tc::SMEM_BYTES);
  if (a != cudaSuccess) return static_cast<int>(a);
  const int n_ct = (k + f64tc::BN - 1) / f64tc::BN;
  kernel<<<grid_of(B, f64tc::BM, n_ct), f64tc::THREADS, f64tc::SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(c),
      static_cast<const double*>(c_sq), static_cast<double*>(pv), static_cast<int*>(pj), B, k, d,
      n_ct);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1, `fast`: staged bf16 operands xs [Bp, dp] and cs [kp, dp] (Bp a
// multiple of 128, kp of 256, dp of 64); partials [kp / 256, B] in the
// type of c_sq (float32 for float32 inputs, float64 for float64 inputs).
extern "C" int srml_argmin_tiles_fast_f32(const void* xs, const void* cs, const void* c_sq,
                                          void* pv, void* pj, int B, int Bp, int k, int kp,
                                          int dp, void* stream) {
  return launch_fast<float>(xs, cs, c_sq, pv, pj, B, Bp, k, kp, dp, stream);
}

extern "C" int srml_argmin_tiles_fast_f64(const void* xs, const void* cs, const void* c_sq,
                                          void* pv, void* pj, int B, int Bp, int k, int kp,
                                          int dp, void* stream) {
  return launch_fast<double>(xs, cs, c_sq, pv, pj, B, Bp, k, kp, dp, stream);
}

// Pass 2: (mind, best) [B] from the partials [n_ct, B].
extern "C" int srml_argmin_merge_f32(const void* pv, const void* pj, void* mind, void* best, int B,
                                     int n_ct, void* stream) {
  return launch_merge<float>(pv, pj, mind, best, B, n_ct, stream);
}

extern "C" int srml_argmin_merge_f64(const void* pv, const void* pj, void* mind, void* best, int B,
                                     int n_ct, void* stream) {
  return launch_merge<double>(pv, pj, mind, best, B, n_ct, stream);
}

// The tile sizes, the `fast` and float64 kernels' dynamic shared memory and
// the float64 kernel's DMMA depth step, for the wrapper's scratch and the
// build report.
extern "C" int srml_argmin_config(int what) {
  switch (what) {
    case 0: return f32core::BM;
    case 1: return f32core::BN;
    case 2: return f64tc::BM;
    case 3: return f64tc::BN;
    case 4: return wg::BM;
    case 5: return wg::BN;
    case 6: return wg::BK;
    case 7: return wg::SMEM_BYTES;
    case 8: return f64tc::SMEM_BYTES;
    case 9: return f64tc::MMA_K;
    default: return -1;
  }
}
