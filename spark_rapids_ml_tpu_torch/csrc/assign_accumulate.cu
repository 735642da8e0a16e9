// Weighted one-hot accumulation of a row tile into per-center sums, with no
// float atomics: two launches on the same inputs give bitwise-equal results.
//
// Replaces the TPU kernel `_pl_accumulate` (spark_rapids_ml_tpu/ops/distance.py):
//     sums[j, :] = sum over rows r with assign[r] == j of w[r] * x[r, :]
//     counts[j]  = sum over the same rows of w[r]
// without ever storing the [B, k] one-hot matrix.
//
// What bounds it on an H100: bytes. B*d multiply-adds against B*d elements
// of x read and k*d written (at the main path's tile, B = 32768, d = 3000,
// k = 1000: 393 MB read, 12 MB written), so the 3.35 TB/s memory rate is the
// floor.
//
// Design:
//   * The caller orders the row indices by assignment with a stable sort and
//     passes the segment offsets of each center (index preparation; the sum
//     is this kernel). So the rows of center j are order[offsets[j] ..
//     offsets[j+1]), in ascending row order.
//   * One block per (center, slice of DT columns); thread t owns one column
//     and sums w*x over the center's rows in that fixed order. No two blocks
//     write the same output, so no atomics and no second pass are needed, and
//     the order of every sum is fixed by the data alone: the result is
//     deterministic. Neighbouring threads read neighbouring columns of a row,
//     so each row read is coalesced.
//   * The loop loads four rows ahead before adding them in order, to keep
//     loads in flight without changing the order of the sum.
//   * Rows with zero weight are skipped: they add nothing.
//   * `fast`: x and w are rounded to bf16 (round to nearest even; a double
//     through float, as torch's and XLA's casts do) before the product, and
//     the products are summed in float32, as the TPU kernel's bf16 one-hot
//     product with float32 accumulation did; a float64 sum is widened back
//     at the store. Counts stay at full precision, as there.
//
// C interface, bound with ctypes (spark_rapids_ml_tpu_torch/ops/_kernels.py):
// each function launches on `stream` and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int DT = 256;     // columns per block, one per thread
constexpr int UNROLL = 4;   // rows loaded ahead of the in-order sum

// the type the products are summed in: float32 for `fast`, else the input's
template <typename T, bool FAST>
using sum_t = std::conditional_t<FAST, float, T>;

template <typename T, bool FAST>
__device__ __forceinline__ sum_t<T, FAST> rounded(T v) {
  if constexpr (FAST) {
    return __bfloat162float(__float2bfloat16_rn(static_cast<float>(v)));
  } else {
    return v;
  }
}

template <typename T, bool FAST>
__global__ void __launch_bounds__(DT)
assign_accumulate_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const int* __restrict__ order, const int* __restrict__ offsets,
                         T* __restrict__ sums, T* __restrict__ counts, int d) {
  const int j = blockIdx.x;
  const int col = blockIdx.y * DT + threadIdx.x;
  const int lo = offsets[j];
  const int hi = offsets[j + 1];

  if (col < d) {
    using S = sum_t<T, FAST>;
    S s = S(0);
    int p = lo;
    for (; p + UNROLL <= hi; p += UNROLL) {
      S wv[UNROLL];
      S xv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = order[p + u];
        wv[u] = rounded<T, FAST>(w[r]);
        xv[u] = rounded<T, FAST>(x[static_cast<long long>(r) * d + col]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (wv[u] != S(0)) s += wv[u] * xv[u];
      }
    }
    for (; p < hi; ++p) {
      const int r = order[p];
      const S wr = rounded<T, FAST>(w[r]);
      if (wr != S(0)) s += wr * rounded<T, FAST>(x[static_cast<long long>(r) * d + col]);
    }
    sums[static_cast<long long>(j) * d + col] = static_cast<T>(s);
  }

  if (blockIdx.y == 0 && threadIdx.x == 0) {
    T cnt = T(0);
    for (int p = lo; p < hi; ++p) cnt += w[order[p]];
    counts[j] = cnt;
  }
}

template <typename T, bool FAST>
int launch(const void* x, const void* w, const void* order, const void* offsets,
           void* sums, void* counts, int k, int d, void* stream) {
  const dim3 grid(k, (d + DT - 1) / DT);
  assign_accumulate_kernel<T, FAST><<<grid, DT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(order),
      static_cast<const int*>(offsets), static_cast<T*>(sums), static_cast<T*>(counts), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int srml_assign_accumulate_f32(const void* x, const void* w, const void* order,
                                          const void* offsets, void* sums, void* counts,
                                          int k, int d, int fast, void* stream) {
  return fast ? launch<float, true>(x, w, order, offsets, sums, counts, k, d, stream)
              : launch<float, false>(x, w, order, offsets, sums, counts, k, d, stream);
}

extern "C" int srml_assign_accumulate_f64(const void* x, const void* w, const void* order,
                                          const void* offsets, void* sums, void* counts,
                                          int k, int d, int fast, void* stream) {
  return fast ? launch<double, true>(x, w, order, offsets, sums, counts, k, d, stream)
              : launch<double, false>(x, w, order, offsets, sums, counts, k, d, stream);
}
