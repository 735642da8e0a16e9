// The bf16 tensor-core product tile of Hopper: TMA loads into a ring of
// shared-memory stages, `wgmma` on two consumer warpgroups, float32 sums in
// registers. Used by the `fast` forms of assign_argmin.cu and d2_block.cu.
//
// One CTA of THREADS threads computes the BM x BN tile of dot products
//     acc[r][j] = a_row(m0 + r) . b_row(n0 + j)
// of two row-major bf16 operands a [rows_a, dp] and b [rows_b, dp] over the
// whole depth dp. The caller stages both operands (rounded to bf16, rows
// padded to whole tiles, the depth padded with zeros to a multiple of BK),
// so every TMA box lies inside its tensor and the zeros add nothing.
//
//   * Warpgroups 0 and 1 are consumers: each owns 64 rows of the tile and
//     issues wgmma.mma_async m64n256k16 (bf16 x bf16 -> f32), both operands
//     K-major in shared memory, 4 per BK-deep stage. Warpgroup 2 is the
//     producer: one thread issues cp.async.bulk.tensor loads of the next
//     stages (a: BM x BK, b: BN x BK, 48 KB a stage) while the consumers
//     multiply. Each stage has a `full` mbarrier (the producer's
//     arrive.expect_tx of the stage's bytes, completed by the TMA) and an
//     `empty` one (one arrival from each consumer thread once its wgmma
//     group has finished reading the stage).
//   * Shared memory is the 128-byte swizzle of the tensor maps
//     (CU_TENSOR_MAP_SWIZZLE_128B): a BK-deep row is 128 bytes, 8 rows make
//     a 1024-byte swizzle atom, so every stage starts 1024-aligned and the
//     wgmma descriptors say layout B128 with a stride byte offset of 1024
//     bytes between 8-row groups. The k16 steps inside a stage advance the
//     descriptor's start address by 32 bytes.
//   * setmaxnreg moves registers from the producer (40) to the consumers
//     (232), whose 128 float32 accumulators stay in registers.
//
// Each accumulator is one float32 sum of exact bf16 products taken in the
// same order whatever the other rows and columns of the tile hold, so a
// row's result does not depend on the batch it comes in or on the CTA that
// covers it.
//
// Accumulator layout (m64nNk16, per consumer warpgroup wg): thread
// t = threadIdx.x % 128 holds acc[4 * n + 2 * h + e] for tile row
// 64 * wg + 16 * (t / 32) + (t % 32) / 4 + 8 * h and tile column
// 8 * n + 2 * (t % 4) + e (n < BN / 8, h and e in {0, 1}).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace srml {
namespace wgmma_bf16 {

constexpr int BM = 128;                 // rows of a tile (operand a): two warpgroups of 64
constexpr int BN = 256;                 // columns of a tile (operand b rows)
constexpr int BK = 64;                  // depth of one stage: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;            // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int ACC = BN / 2;             // float32 accumulators per consumer thread
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the stages, 2 mbarriers per stage, and slack to align the first stage to 1024
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

static_assert(BK * 2 == 128, "a stage row must be one 128-byte swizzle row");
static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "stages must stay 1024-aligned");
static_assert(SMEM_BYTES <= 232448, "more shared memory than a Hopper CTA may have");

// ---------------------------------------------------------------- host ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: it is looked up once through the
// CUDA runtime's entry-point query, so the library needs no link against it.
inline cudaError_t encode_fn(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  static const cudaError_t status = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && (found != cudaDriverEntryPointSuccess || p == nullptr))
      e = cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
    return e;
  }();
  *out = fn;
  return status;
}

// The tensor map of a row-major bf16 matrix [rows, cols] (cols a multiple of
// BK), read in boxes of box_rows x BK with the 128-byte swizzle. Returns 0,
// a cudaError_t from the lookup, or -CUresult from the encoding.
inline int encode_rows(CUtensorMap* map, const void* base, long long rows, long long cols,
                       int box_rows) {
  EncodeTiled fn;
  const cudaError_t e = encode_fn(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// -------------------------------------------------------------- device ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// box (depth c0, row c1) of the map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// K-major operand in 128-byte-swizzled shared memory: start address, leading
// byte offset 16 (unused by this layout), stride byte offset 1024 (one
// 8-row swizzle atom), layout B128.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a[64 x 16] . b[256 x 16]^T, both K-major bf16 in shared memory
__device__ __forceinline__ void mma_m64n256k16(float (&d)[ACC], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The whole tile of one CTA: rows m0.. of map_a against rows n0.. of map_b
// over nk stages of depth BK. The consumer threads then call
// epilogue(acc, wg) with their accumulators (the layout at the top of this
// file); the producer warpgroup takes no part in it. Launch with THREADS
// threads and SMEM_BYTES of dynamic shared memory.
template <class Epilogue>
__device__ __forceinline__ void product_tile(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                             int m0, int n0, int nk, Epilogue&& epilogue) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  auto stage_a = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(smem + s * STAGE_BYTES); };
  auto stage_b = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * STAGE_BYTES + A_BYTES);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // producer: the roles never meet again
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      for (int kc = 0, s = 0, ph = 0; kc < nk; ++kc) {
        mbar_wait(&empty[s], ph ^ 1);  // the first pass over the ring finds every stage free
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load(stage_a(s), map_a, kc * BK, m0, &full[s]);
        tma_load(stage_b(s), map_b, kc * BK, n0, &full[s]);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    for (int kc = 0, s = 0, ph = 0; kc < nk; ++kc) {
      mbar_wait(&full[s], ph);
      const __nv_bfloat16* a = stage_a(s) + wg * 64 * BK;
      const __nv_bfloat16* b = stage_b(s);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_m64n256k16(acc, smem_desc(a + 16 * kk), smem_desc(b + 16 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      mbar_arrive(&empty[s]);
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    epilogue(acc, wg);
  }
}

}  // namespace wgmma_bf16
}  // namespace srml
