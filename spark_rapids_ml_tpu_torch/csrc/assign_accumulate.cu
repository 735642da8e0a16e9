// Weighted one-hot accumulation of a row tile into per-center sums, with no
// float atomics: two launches on the same inputs give bitwise-equal results.
//
// Replaces the TPU kernel `_pl_accumulate` (spark_rapids_ml_tpu/ops/distance.py):
//     sums[j, :] = sum over rows r with assign[r] == j of w[r] * x[r, :]
//     counts[j]  = sum over the same rows of w[r]
// without ever storing the [B, k] one-hot matrix. Rows with zero weight, and
// rows whose assignment lies outside [0, k), add nothing.
//
// What bounds it on an H100: bytes. B*d multiply-adds against B*d elements
// of x read and k*d written (at the main path's tile, B = 32768, d = 3000,
// k = 1000: 393 MB read, 12 MB written), so the 3.35 TB/s memory rate is the
// floor. The work is a gather: each center sums its own rows, so what keeps
// the memory busy is enough row loads in flight on every SM, and work spread
// evenly over the SMs however the rows fall on the centers.
//
// Design, on one stream:
//   * index preparation: the rows stable-sorted by center, so the rows of
//     center j are a segment of that order in ascending row order. Up to
//     COUNT_CENTERS centers by a counting sort of three passes: per chunk
//     of COUNT_ROWS rows each center's count (shared-memory counters); the
//     plan below, which also turns the counts into each (chunk, center)'s
//     first position; one warp per chunk placing its rows in order, equal
//     centers among 32 rows ranked by __match_any_sync and a popcount. Rows
//     outside [0, k) are left out. Past COUNT_CENTERS the caller sorts and
//     the plan finds the segments by binary search;
//   * plan (one CTA): each center's segment is cut into pieces of at most R
//     rows (an empty center is one empty piece); an exclusive scan of the
//     piece counts writes the piece table {center, first, end, alone} and
//     the list of centers of several pieces. The grid of the next passes is
//     sized on the host by the bound k + ceil(B / R) pieces, so no count is
//     read back; surplus CTAs return at once;
//   * sums: one CTA per (piece, slice of THREADS * V columns), the slices of
//     a piece adjacent in the grid. The CTA loads its piece's row indices and
//     weights into shared memory once, coalesced; each thread owns V
//     consecutive columns, read with 16-byte streaming loads (float4 for
//     float32, double2 for float64; V = 1 where a row is not 16-byte
//     aligned, chosen by the wrapper) and keeps U rows of loads in flight
//     ahead of its in-order sum. Each output is one running sum from 0 with
//     s = fma(w, x, s) in ascending row order, zero weights skipped, and
//     the count the same ascending sum of w, so the sums of a center of one
//     piece depend on its own rows alone (not on R, the grid or the other
//     centers); it writes them straight to the outputs. A piece of a center
//     of several pieces writes a partial row (and count) to scratch;
//   * fold: one CTA per (center of several pieces, column slice) adds that
//     center's partials in piece order.
//   Every sum's order is fixed by the data alone: the result is
//   deterministic. A center that owns a whole tile is ceil(B / R) pieces
//   spread over the card, not one CTA per column slice walking every row.
//   On an H100 80GB HBM3 at 700 W the sum pass moves 2.8-2.9 TB/s at the
//   main path's tile, and a tile whose rows all fall on one center takes
//   about the time of a balanced one (chip_smoke.py phase 2; PERF.md).
//   * `fast`: x and w are rounded to bf16 (round to nearest even; a double
//     through float, as torch's and XLA's casts do) before the product, and
//     the products are summed in float32 (partials too), as the TPU
//     kernel's bf16 one-hot product with float32 accumulation did; a float64
//     sum is widened back at the store. Counts stay at full precision, as
//     there.
//
// C interface, bound with ctypes (spark_rapids_ml_tpu_torch/ops/_kernels.py):
// each function launches on `stream` and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int R = 128;             // rows per piece at most
constexpr int THREADS = 256;       // threads of a sum or fold CTA, V columns each
constexpr int U = 8;               // rows loaded ahead of the in-order sum
constexpr int FOLD_U = 16;         // partials loaded ahead of the in-order fold
constexpr int PLAN_THREADS = 1024;
constexpr int COUNT_CENTERS = 12288;  // the counting sort's centers at most (48 KB of counters)
constexpr int COUNT_ROWS = 512;       // rows per chunk of the counting sort
constexpr int COUNT_THREADS = 256;

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

// V consecutive elements of type T as one register value
template <typename T, int V> struct vec;
template <> struct vec<float, 4> { using type = float4; };
template <> struct vec<float, 2> { using type = float2; };
template <> struct vec<double, 2> { using type = double2; };
template <> struct vec<float, 1> { using type = float; };
template <> struct vec<double, 1> { using type = double; };
template <typename T, int V> using vec_t = typename vec<T, V>::type;

__device__ __forceinline__ float elem(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ float elem(float2 v, int e) { return e == 0 ? v.x : v.y; }
__device__ __forceinline__ double elem(double2 v, int e) { return e == 0 ? v.x : v.y; }
__device__ __forceinline__ float elem(float v, int) { return v; }
__device__ __forceinline__ double elem(double v, int) { return v; }

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// read once: streaming loads, evicted first
template <typename T, int V>
__device__ __forceinline__ vec_t<T, V> load_stream(const T* p) {
  return __ldcs(reinterpret_cast<const vec_t<T, V>*>(p));
}

template <typename T, int V, typename S>
__device__ __forceinline__ void store(T* p, const S (&a)[V]) {
  if constexpr (V == 1) {
    *p = static_cast<T>(a[0]);
  } else if constexpr (V == 2) {
    vec_t<T, 2> v;
    v.x = static_cast<T>(a[0]);
    v.y = static_cast<T>(a[1]);
    *reinterpret_cast<vec_t<T, 2>*>(p) = v;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
}

__host__ __device__ __forceinline__ int pieces_of(int rows) {
  return rows == 0 ? 1 : (rows + R - 1) / R;
}

// the first position of a[0..n) (ascending) holding a value >= v
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Counting sort, pass 1: per chunk of COUNT_ROWS rows, the rows of each
// center in [0, k), hist[chunk * k + center] (integer atomics in shared
// memory: the counts do not depend on their order).
__global__ void __launch_bounds__(COUNT_THREADS)
accumulate_count(const int* __restrict__ assign, int B, int k, int* __restrict__ hist) {
  __shared__ int h[COUNT_CENTERS];
  for (int j = threadIdx.x; j < k; j += COUNT_THREADS) h[j] = 0;
  __syncthreads();
  const int end = min(B, static_cast<int>(blockIdx.x + 1) * COUNT_ROWS);
  for (int r = blockIdx.x * COUNT_ROWS + threadIdx.x; r < end; r += COUNT_THREADS) {
    const int j = assign[r];
    if (j >= 0 && j < k) atomicAdd(&h[j], 1);
  }
  __syncthreads();
  int* out = hist + static_cast<long long>(blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += COUNT_THREADS) out[j] = h[j];
}

// Counting sort, pass 3 (after the plan): one warp per chunk places the
// chunk's rows, in ascending row order, at their center's position for the
// chunk (hist, made absolute by the plan); rows of one center among 32 are
// ranked by __match_any_sync and a popcount. The result is the stable sort
// of the rows in [0, k) by center.
__global__ void __launch_bounds__(32)
accumulate_scatter(const int* __restrict__ assign, int B, int k, const int* __restrict__ hist,
                   int* __restrict__ order) {
  __shared__ int next[COUNT_CENTERS];
  const int lane = threadIdx.x;
  const int* base = hist + static_cast<long long>(blockIdx.x) * k;
  for (int j = lane; j < k; j += 32) next[j] = base[j];
  int js[COUNT_ROWS / 32];
  const int r0 = blockIdx.x * COUNT_ROWS + lane;
#pragma unroll
  for (int i = 0; i < COUNT_ROWS / 32; ++i) {
    const int r = r0 + 32 * i;
    js[i] = r < B ? assign[r] : -1;
  }
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < COUNT_ROWS / 32; ++i) {
    const int j = js[i];
    const bool valid = j >= 0 && j < k;
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? j : -1);
    if (valid) order[next[j] + __popc(peers & below)] = r0 + 32 * i;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) next[j] += __popc(peers);
    __syncwarp();
  }
}

// Pass 2, one CTA: each center's rows (from the chunk counts `hist`, which
// it turns into each chunk's first position for the center; or, with
// hist == nullptr, by binary search in `sorted_assign`, the assignments
// sorted), an exclusive scan of rows, pieces and centers of several pieces,
// then the piece table {center, first, end, alone} over the sorted order,
// each center's first piece and the centers of several pieces. totals =
// {pieces, centers of several pieces}.
__global__ void __launch_bounds__(PLAN_THREADS)
accumulate_plan(const int* __restrict__ sorted_assign, int* __restrict__ hist, int n_chunks,
                int B, int k, int4* __restrict__ pieces, int* __restrict__ first_piece,
                int* __restrict__ multi, int* __restrict__ totals) {
  __shared__ int scan_r[PLAN_THREADS];
  __shared__ int scan_p[PLAN_THREADS];
  __shared__ int scan_m[PLAN_THREADS];
  const int t = threadIdx.x;
  const int per = (k + PLAN_THREADS - 1) / PLAN_THREADS;
  const int j0 = static_cast<int>(min(static_cast<long long>(k), static_cast<long long>(t) * per));
  const int j1 = min(k, j0 + per);
  int nr = 0, np = 0, nm = 0;
  int lo = hist ? 0 : lower_bound(sorted_assign, B, j0);
  for (int j = j0; j < j1; ++j) {
    int rows;
    if (hist) {
      rows = 0;
      for (int c = 0; c < n_chunks; ++c) {
        int* h = hist + static_cast<long long>(c) * k + j;
        const int v = *h;
        *h = rows;
        rows += v;
      }
      first_piece[j] = rows;  // kept for the second walk below
    } else {
      const int hi = lower_bound(sorted_assign, B, j + 1);
      rows = hi - lo;
      lo = hi;
    }
    const int c = pieces_of(rows);
    nr += rows;
    np += c;
    nm += c > 1;
  }
  scan_r[t] = nr;
  scan_p[t] = np;
  scan_m[t] = nm;
  __syncthreads();
  for (int off = 1; off < PLAN_THREADS; off <<= 1) {
    const int a = t >= off ? scan_r[t - off] : 0;
    const int b = t >= off ? scan_p[t - off] : 0;
    const int m = t >= off ? scan_m[t - off] : 0;
    __syncthreads();
    scan_r[t] += a;
    scan_p[t] += b;
    scan_m[t] += m;
    __syncthreads();
  }
  int base = scan_p[t] - np;
  int mbase = scan_m[t] - nm;
  lo = hist ? scan_r[t] - nr : lower_bound(sorted_assign, B, j0);
  for (int j = j0; j < j1; ++j) {
    int rows;
    if (hist) {
      rows = first_piece[j];
      for (int c = 0; c < n_chunks; ++c) hist[static_cast<long long>(c) * k + j] += lo;
    } else {
      rows = lower_bound(sorted_assign, B, j + 1) - lo;
    }
    const int hi = lo + rows;
    const int c = pieces_of(rows);
    first_piece[j] = base;
    for (int q = 0; q < c; ++q) {
      pieces[base + q] = make_int4(j, lo + q * R, min(hi, lo + (q + 1) * R), c == 1);
    }
    if (c > 1) multi[mbase++] = j;
    base += c;
    lo = hi;
  }
  if (t == PLAN_THREADS - 1) {
    first_piece[k] = base;
    totals[0] = base;
    totals[1] = mbase;
  }
}

template <typename T, bool FAST, int V>
__global__ void __launch_bounds__(THREADS)
accumulate_sums(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ order, const int4* __restrict__ pieces,
                const int* __restrict__ totals, T* __restrict__ sums, T* __restrict__ counts,
                sum_t<T, FAST>* __restrict__ part, T* __restrict__ part_counts, int d,
                int n_slices) {
  using S = sum_t<T, FAST>;
  __shared__ int rows[R];
  __shared__ S ws[R];
  __shared__ T wt[R];
  const int p = blockIdx.x / n_slices;
  const int slice = blockIdx.x - p * n_slices;
  if (p >= totals[0]) return;
  const int4 pc = pieces[p];  // {center, first, end, alone}
  const int n = pc.z - pc.y;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = order[pc.y + i];
    const T wr = w[r];
    rows[i] = r;
    wt[i] = wr;
    ws[i] = rounded<T, FAST>(wr);
  }
  __syncthreads();

  const int col = (slice * THREADS + threadIdx.x) * V;
  if (col < d) {
    S acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = S(0);
    for (int i0 = 0; i0 < n; i0 += U) {
      vec_t<T, V> xv[U];
      S wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        wv[u] = i0 + u < n ? ws[i0 + u] : S(0);
        if (wv[u] != S(0)) {
          xv[u] = load_stream<T, V>(x + static_cast<long long>(rows[i0 + u]) * d + col);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (wv[u] != S(0)) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = fma_(wv[u], rounded<T, FAST>(elem(xv[u], e)), acc[e]);
        }
      }
    }
    if (pc.w) {
      store<T, V>(sums + static_cast<long long>(pc.x) * d + col, acc);
    } else {
      store<S, V>(part + static_cast<long long>(p) * d + col, acc);
    }
  }
  if (slice == 0 && threadIdx.x == 0) {
    T cnt = T(0);
    for (int i = 0; i < n; ++i) cnt += wt[i];
    if (pc.w) counts[pc.x] = cnt; else part_counts[p] = cnt;
  }
}

template <typename T, bool FAST, int V>
__global__ void __launch_bounds__(THREADS)
accumulate_fold(const sum_t<T, FAST>* __restrict__ part, const T* __restrict__ part_counts,
                const int* __restrict__ first_piece, const int* __restrict__ multi,
                const int* __restrict__ totals, T* __restrict__ sums, T* __restrict__ counts,
                int d, int n_slices) {
  using S = sum_t<T, FAST>;
  const int i = blockIdx.x / n_slices;
  const int slice = blockIdx.x - i * n_slices;
  if (i >= totals[1]) return;
  const int j = multi[i];
  const int q0 = first_piece[j];
  const int q1 = first_piece[j + 1];
  const int col = (slice * THREADS + threadIdx.x) * V;
  if (col < d) {
    S acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = S(0);
    for (int q = q0; q < q1; q += FOLD_U) {
      vec_t<S, V> pv[FOLD_U];
#pragma unroll
      for (int u = 0; u < FOLD_U; ++u) {
        if (q + u < q1) pv[u] = load_stream<S, V>(part + static_cast<long long>(q + u) * d + col);
      }
#pragma unroll
      for (int u = 0; u < FOLD_U; ++u) {
        if (q + u < q1) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += elem(pv[u], e);
        }
      }
    }
    store<T, V>(sums + static_cast<long long>(j) * d + col, acc);
  }
  if (slice == 0 && threadIdx.x == 0) {
    T cnt = T(0);
    for (int q = q0; q < q1; ++q) cnt += part_counts[q];
    counts[j] = cnt;
  }
}

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

template <typename T, bool FAST, int V>
int launch_sums(const void* x, const void* w, const void* order, const void* pieces,
                const void* totals, void* sums, void* counts, void* part, void* part_counts,
                int B, int k, int d, cudaStream_t stream) {
  const int n_slices = ceil_div(d, THREADS * V);
  const int n_pieces = k + ceil_div(B, R);
  accumulate_sums<T, FAST, V><<<n_pieces * n_slices, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(order),
      static_cast<const int4*>(pieces), static_cast<const int*>(totals), static_cast<T*>(sums),
      static_cast<T*>(counts), static_cast<sum_t<T, FAST>*>(part), static_cast<T*>(part_counts),
      d, n_slices);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool FAST, int V>
int launch_fold(const void* part, const void* part_counts, const void* first_piece,
                const void* multi, const void* totals, void* sums, void* counts, int B, int d,
                cudaStream_t stream) {
  const int n_multi = B / (R + 1);  // a center of several pieces has more than R rows
  if (n_multi == 0) return 0;
  const int n_slices = ceil_div(d, THREADS * V);
  accumulate_fold<T, FAST, V><<<n_multi * n_slices, THREADS, 0, stream>>>(
      static_cast<const sum_t<T, FAST>*>(part), static_cast<const T*>(part_counts),
      static_cast<const int*>(first_piece), static_cast<const int*>(multi),
      static_cast<const int*>(totals), static_cast<T*>(sums), static_cast<T*>(counts), d,
      n_slices);
  return static_cast<int>(cudaGetLastError());
}

// the vector width of a float32 or float64 row: 16 bytes, or one element
template <typename T> constexpr int VEC = 16 / sizeof(T);

}  // namespace

// 0: rows per piece (R), 1: the counting sort's centers at most, 2: its
// rows per chunk
extern "C" int srml_accumulate_config(int what) {
  const int values[] = {R, COUNT_CENTERS, COUNT_ROWS};
  return what >= 0 && what < 3 ? values[what] : -1;
}

// Index preparation by counting sort (k <= COUNT_CENTERS): the chunk counts
// into `hist` [ceil(B / COUNT_ROWS), k], the plan, then the rows in [0, k)
// stable-sorted by center into `order` [B].
extern "C" int srml_accumulate_prep(const void* assign, int B, int k, void* order, void* hist,
                                    void* pieces, void* first_piece, void* multi, void* totals,
                                    void* stream) {
  if (k > COUNT_CENTERS) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int n_chunks = ceil_div(B, COUNT_ROWS);
  const int* a = static_cast<const int*>(assign);
  int* h = static_cast<int*>(hist);
  if (n_chunks > 0) accumulate_count<<<n_chunks, COUNT_THREADS, 0, s>>>(a, B, k, h);
  accumulate_plan<<<1, PLAN_THREADS, 0, s>>>(nullptr, h, n_chunks, B, k,
                                             static_cast<int4*>(pieces),
                                             static_cast<int*>(first_piece),
                                             static_cast<int*>(multi), static_cast<int*>(totals));
  if (n_chunks > 0) accumulate_scatter<<<n_chunks, 32, 0, s>>>(a, B, k, h, static_cast<int*>(order));
  return static_cast<int>(cudaGetLastError());
}

// The plan alone, from the assignments sorted (k > COUNT_CENTERS: the
// caller sorts).
extern "C" int srml_accumulate_plan_sorted(const void* sorted_assign, int B, int k, void* pieces,
                                           void* first_piece, void* multi, void* totals,
                                           void* stream) {
  accumulate_plan<<<1, PLAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sorted_assign), nullptr, 0, B, k, static_cast<int4*>(pieces),
      static_cast<int*>(first_piece), static_cast<int*>(multi), static_cast<int*>(totals));
  return static_cast<int>(cudaGetLastError());
}

#define SRML_ACCUMULATE(T, NAME)                                                               \
  extern "C" int srml_accumulate_sums_##NAME(                                                  \
      const void* x, const void* w, const void* order, const void* pieces, const void* totals, \
      void* sums, void* counts, void* part, void* part_counts, int B, int k, int d, int fast,  \
      int vec, void* stream) {                                                                 \
    auto s = static_cast<cudaStream_t>(stream);                                                \
    if (fast) {                                                                                \
      return vec ? launch_sums<T, true, VEC<T>>(x, w, order, pieces, totals, sums, counts,     \
                                                part, part_counts, B, k, d, s)                 \
                 : launch_sums<T, true, 1>(x, w, order, pieces, totals, sums, counts, part,    \
                                           part_counts, B, k, d, s);                           \
    }                                                                                          \
    return vec ? launch_sums<T, false, VEC<T>>(x, w, order, pieces, totals, sums, counts,      \
                                               part, part_counts, B, k, d, s)                  \
               : launch_sums<T, false, 1>(x, w, order, pieces, totals, sums, counts, part,     \
                                          part_counts, B, k, d, s);                            \
  }                                                                                            \
  extern "C" int srml_accumulate_fold_##NAME(                                                  \
      const void* part, const void* part_counts, const void* first_piece, const void* multi,   \
      const void* totals, void* sums, void* counts, int B, int d, int fast, int vec,           \
      void* stream) {                                                                          \
    auto s = static_cast<cudaStream_t>(stream);                                                \
    if (fast) {                                                                                \
      return vec ? launch_fold<T, true, VEC<T>>(part, part_counts, first_piece, multi, totals, \
                                                sums, counts, B, d, s)                         \
                 : launch_fold<T, true, 1>(part, part_counts, first_piece, multi, totals,      \
                                           sums, counts, B, d, s);                             \
    }                                                                                          \
    return vec ? launch_fold<T, false, VEC<T>>(part, part_counts, first_piece, multi, totals,  \
                                               sums, counts, B, d, s)                          \
               : launch_fold<T, false, 1>(part, part_counts, first_piece, multi, totals, sums, \
                                          counts, B, d, s);                                    \
  }

SRML_ACCUMULATE(float, f32)
SRML_ACCUMULATE(double, f64)
