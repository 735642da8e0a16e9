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
// FLOP per byte): 6.0 ms at the float32 CUDA-core rate (67 TFLOP/s) and, for
// float64, at the FP64 tensor-core rate (67 TFLOP/s), 0.41 ms for `fast` at
// the bf16 tensor-core rate (989 TFLOP/s), against 0.16 ms for the bytes
// (0.31 ms in float64).
//
// The TPU kernel held the whole item tile in VMEM and ran its grid over row
// blocks only. A Hopper CTA has at most 227 KB of shared memory, so here
// every CTA owns one output tile, and a 1-D grid covers both axes. The grid
// and the tiles are the same for every B, and each output is one sum in a
// fixed order, so a query's distances do not depend on the batch it comes
// in (a served request equals itself served alone, bit for bit). Ragged
// rows (B, every rung of the serving bucket ladder) and items (kt) are
// masked at the store. No cuBLAS, and TF32 never enters.
//
// The three forms:
//   * float32: the CUDA-core tile of f32_tile.cuh (shared with
//     assign_argmin.cu), 128 queries x 128 items, 256 threads of 8 x 8
//     outputs, 8-deep double-buffered chunks, float4 loads where d % 4 == 0
//     and both bases are 16-byte aligned (VEC, chosen by the wrapper). Each
//     output is one fmaf chain in ascending depth, as the 64 x 64 tile it
//     replaces summed it. Two CTAs per SM. Item tiles run fastest in the
//     launch order, as measured fastest at the kNN tile (PERF.md).
//   * `fast` (float32 or float64 inputs, serve_dtype="bf16"): the wrapper
//     stages q and xt as bf16 (round to nearest even; float64 through
//     float32, as JAX's astype does) into buffers whose rows are padded to
//     whole tiles (128 queries, 256 items) and whose depth is padded with
//     zeros to a multiple of 64; the product is the TMA + wgmma tile of
//     wgmma_bf16.cuh (shared with assign_argmin.cu), 128 x 256, float32
//     sums. The epilogue forms xt_sq - 2*dot in float32, or for float64
//     inputs widens the sum first and stays in float64, as the TPU kernel's
//     `fast` body casts its product back to the input dtype. Query tiles run
//     fastest, so the CTAs in flight share one item tile and the staged q
//     (24.6 MB at 4096 x 3008) stays in the 50 MB L2: each item row is read
//     from device memory about once. One CTA per SM.
//   * float64: the FP64 tensor-core (DMMA) tile of f64_tile.cuh (shared
//     with assign_argmin.cu), 128 queries x 128 items, 8 warps of 32 x 64
//     outputs, a 3-stage cp.async ring of 32-deep chunks read straight from
//     q and xt (16-byte copies where d is even and both bases are 16-byte
//     aligned, VEC, chosen by the wrapper; 8-byte copies otherwise). One
//     CTA per SM, query tiles fastest, as in `fast`: the CTAs in flight
//     share a few item tiles, and each wave re-reads the queries (98 MB at
//     4096 x 3000), not the items (393 MB at kt = 16,384). The epilogue
//     stores xt_sq - 2*dot in aligned pairs where whole (`store_pair`).
//
// C interface, bound with ctypes (spark_rapids_ml_tpu_torch/ops/_kernels.py):
// each function launches on `stream` and returns cudaGetLastError() (or the
// first error of its set-up).

#include <cuda_runtime.h>

#include "f32_tile.cuh"
#include "f64_tile.cuh"
#include "wgmma_bf16.cuh"

namespace {

// ------------------------------------------------ float32: CUDA cores ----

namespace f32core = srml::f32core;

template <bool VEC>
__global__ void __launch_bounds__(f32core::THREADS, 2)
d2_block_f32(const float* __restrict__ q, const float* __restrict__ xt,
             const float* __restrict__ xt_sq, float* __restrict__ out, int B, int kt, int d,
             int n_it) {
  const int n0 = (blockIdx.x % n_it) * f32core::BN;  // items: the fastest
  const int m0 = (blockIdx.x / n_it) * f32core::BM;  // queries
  f32core::product_tile<VEC>(q, m0, B, xt, n0, kt, d, [&](const float (&acc)[8][8]) {
    // a thread's columns are two runs of 4 neighbours: one float4 each
    // where the row stride keeps them 16-byte aligned and all 4 lie inside
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + f32core::col_of(4 * h);
      float sq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) sq[j] = gn + j < kt ? xt_sq[gn + j] : 0.f;
      const bool whole = kt % 4 == 0 && gn + 3 < kt;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int gm = m0 + f32core::row_of(i);
        if (gm >= B) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = sq[j] - 2.f * acc[i][4 * h + j];
        float* o = out + static_cast<long long>(gm) * kt + gn;
        if (whole) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < kt) o[j] = v[j];
        }
      }
    }
  });
}

// two neighbouring outputs of one row: one 8- or 16-byte store where the
// row stride keeps the pair aligned and both lie inside
template <typename T>
__device__ __forceinline__ void store_pair(T* o, T v0, T v1, bool pair, bool second) {
  if (pair) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<double2*>(o) = make_double2(v0, v1);
    }
  } else {
    o[0] = v0;
    if (second) o[1] = v1;
  }
}

// ------------------------------------------------ float64: DMMA tile ----

namespace f64tc = srml::f64tc;

template <bool VEC>
__global__ void __launch_bounds__(f64tc::THREADS, 1)
d2_block_f64(const double* __restrict__ q, const double* __restrict__ xt,
             const double* __restrict__ xt_sq, double* __restrict__ out, int B, int kt, int d,
             int n_qt) {
  using f64tc::MT;
  using f64tc::NT;
  const int m0 = (blockIdx.x % n_qt) * f64tc::BM;  // queries: the fastest
  const int n0 = (blockIdx.x / n_qt) * f64tc::BN;  // items
  f64tc::product_tile<VEC>(q, m0, B, xt, n0, kt, d,
                           [&](const double (&acc)[MT][NT][4], double*) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int gn = n0 + f64tc::col_of(nt, 0);  // columns gn and gn + 1
      if (gn >= kt) continue;
      const bool second = gn + 1 < kt;
      const bool pair = second && kt % 2 == 0;
      const double sq0 = xt_sq[gn];
      const double sq1 = second ? xt_sq[gn + 1] : 0.0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + f64tc::row_of(mt, h);
          if (gm >= B) continue;
          store_pair(out + static_cast<long long>(gm) * kt + gn, sq0 - 2.0 * acc[mt][nt][2 * h],
                     sq1 - 2.0 * acc[mt][nt][2 * h + 1], pair, second);
        }
    }
  });
}

// ------------------------------------------- fast: bf16 TMA + wgmma -------

namespace wg = srml::wgmma_bf16;

template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
d2_block_fast(__grid_constant__ const CUtensorMap map_q, __grid_constant__ const CUtensorMap map_x,
              const T* __restrict__ xt_sq, T* __restrict__ out, int B, int kt, int nk, int n_qt) {
  const int m0 = (blockIdx.x % n_qt) * wg::BM;  // queries: the fastest
  const int n0 = (blockIdx.x / n_qt) * wg::BN;  // items
  wg::product_tile(map_q, map_x, m0, n0, nk, [&](const float (&acc)[wg::ACC], int w) {
    const int t = threadIdx.x % 128;
    const int r = m0 + 64 * w + 16 * (t / 32) + (t % 32) / 4;  // rows r and r + 8
#pragma unroll
    for (int n = 0; n < wg::BN / 8; ++n) {
      const int gn = n0 + 8 * n + 2 * (t % 4);  // columns gn and gn + 1
      if (gn >= kt) continue;
      const bool second = gn + 1 < kt;
      const bool pair = second && kt % 2 == 0;
      const T sq0 = xt_sq[gn];
      const T sq1 = second ? xt_sq[gn + 1] : T(0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = r + 8 * h;
        if (gm >= B) continue;
        const T v0 = sq0 - T(2) * static_cast<T>(acc[4 * n + 2 * h]);
        const T v1 = sq1 - T(2) * static_cast<T>(acc[4 * n + 2 * h + 1]);
        store_pair(out + static_cast<long long>(gm) * kt + gn, v0, v1, pair, second);
      }
    }
  });
}

template <typename T>
int launch_fast(const void* qs, const void* xs, const void* xt_sq, void* out, int B, int Bp,
                int kt, int ktp, int dp, void* stream) {
  CUtensorMap map_q, map_x;
  int e = wg::encode_rows(&map_q, qs, Bp, dp, wg::BM);
  if (e == 0) e = wg::encode_rows(&map_x, xs, ktp, dp, wg::BN);
  if (e != 0) return e;
  // the ring needs more than the default 48 KB of shared memory; setting it
  // on every call keeps it right on whichever device is current
  const cudaError_t a = cudaFuncSetAttribute(
      d2_block_fast<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_BYTES);
  if (a != cudaSuccess) return static_cast<int>(a);
  const int n_qt = Bp / wg::BM;
  d2_block_fast<T><<<n_qt * (ktp / wg::BN), wg::THREADS, wg::SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      map_q, map_x, static_cast<const T*>(xt_sq), static_cast<T*>(out), B, kt, dp / wg::BK, n_qt);
  return static_cast<int>(cudaGetLastError());
}

int tiles(int n, int per) { return (n + per - 1) / per; }

}  // namespace

// float32 on the CUDA cores; `vec` selects float4 loads (d % 4 == 0 and
// 16-byte aligned bases).
extern "C" int srml_d2_block_f32(const void* q, const void* xt, const void* xt_sq, void* out,
                                 int B, int kt, int d, int vec, void* stream) {
  const int n_it = tiles(kt, f32core::BN);
  const dim3 grid(tiles(B, f32core::BM) * n_it);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* xf = static_cast<const float*>(xt);
  const auto* sf = static_cast<const float*>(xt_sq);
  auto* of = static_cast<float*>(out);
  if (vec)
    d2_block_f32<true><<<grid, f32core::THREADS, 0, s>>>(qf, xf, sf, of, B, kt, d, n_it);
  else
    d2_block_f32<false><<<grid, f32core::THREADS, 0, s>>>(qf, xf, sf, of, B, kt, d, n_it);
  return static_cast<int>(cudaGetLastError());
}

// float64 on the FP64 tensor cores; `vec` selects 16-byte copies (d even
// and 16-byte aligned bases).
extern "C" int srml_d2_block_f64(const void* q, const void* xt, const void* xt_sq, void* out,
                                 int B, int kt, int d, int vec, void* stream) {
  // the ring needs more than the default 48 KB of shared memory; setting it
  // on every call keeps it right on whichever device is current
  const auto kernel = vec ? &d2_block_f64<true> : &d2_block_f64<false>;
  const cudaError_t a =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f64tc::SMEM_BYTES);
  if (a != cudaSuccess) return static_cast<int>(a);
  const int n_qt = tiles(B, f64tc::BM);
  kernel<<<n_qt * tiles(kt, f64tc::BN), f64tc::THREADS, f64tc::SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(q), static_cast<const double*>(xt),
      static_cast<const double*>(xt_sq), static_cast<double*>(out), B, kt, d, n_qt);
  return static_cast<int>(cudaGetLastError());
}

// `fast`: staged bf16 operands qs [Bp, dp] and xs [ktp, dp] (Bp a multiple
// of 128, ktp of 256, dp of 64); xt_sq and out in the inputs' dtype.
extern "C" int srml_d2_block_fast_f32(const void* qs, const void* xs, const void* xt_sq, void* out,
                                      int B, int Bp, int kt, int ktp, int dp, void* stream) {
  return launch_fast<float>(qs, xs, xt_sq, out, B, Bp, kt, ktp, dp, stream);
}

extern "C" int srml_d2_block_fast_f64(const void* qs, const void* xs, const void* xt_sq, void* out,
                                      int B, int Bp, int kt, int ktp, int dp, void* stream) {
  return launch_fast<double>(qs, xs, xt_sq, out, B, Bp, kt, ktp, dp, stream);
}

// The tile sizes, the `fast` and float64 kernels' dynamic shared memory and
// the float64 kernel's DMMA depth step, for the wrapper's staging and the
// build report.
extern "C" int srml_d2_config(int what) {
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
