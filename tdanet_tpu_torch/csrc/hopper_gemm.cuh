// The pieces a bf16 matrix product for Hopper (sm_90a) is built from, shared
// by the products of this package: a ring of shared-memory stages guarded by
// mbarriers, the asynchronous loads that fill it, the wgmma operand
// descriptors, the warpgroup product itself (bf16 operands, fp32
// accumulation) and an epilogue that stores a warpgroup's accumulators as
// bf16 in 16-byte vectors. A kernel supplies its own tile walk.
//
// Staging: TMA tensor loads (cp.async.bulk.tensor), not cp.async. One thread
// asks for a whole tile, the hardware writes it in the 128-byte swizzle that
// wgmma reads without bank conflicts, reports the bytes to the stage's
// mbarrier, and fills what lies outside the tensor with zeros, so the ragged
// edges (rows beyond M, a last k slice beyond K) cost no test per element
// and multiply as zeros. cp.async would spend the consumers' registers and
// instruction slots on addresses and a hand-written swizzle. The price is a
// CUtensorMap per operand, encoded on the host in every call (it holds the
// tensor's address) and passed as a __grid_constant__ kernel parameter;
// cuTensorMapEncodeTiled lives in libcuda; its address is taken through
// cudaGetDriverEntryPoint, so nothing links against libcuda.
//
// Shared-memory tiles. A k slice is 64 bf16 = 128 bytes, the swizzle span.
//   K-major operand (k contiguous in device memory: A of shape (M, K), or a
//     B stored (N, K)): rows of 128 bytes, [rows][64 k]; a TMA box
//     {64 k, rows}. One wgmma (k = 16) reads 32 bytes of every row: the
//     descriptor advances by 32 bytes per k step.
//   MN-major operand (m or n contiguous: a B stored (K, N), as x[b] and the
//     projection weight are): chunks of 64 columns, [chunk][k rows][64 n];
//     one TMA box {64 n, k rows} per chunk. The descriptor's leading offset
//     is the chunk stride, its stride offset the 8 k rows of one swizzle
//     atom (1024 bytes); it advances by 16 rows (2048 bytes) per k step, and
//     the instruction's transpose flag for that operand is 1.
// Every tile starts on a 1024-byte boundary (the swizzle is a function of
// the address).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hgemm {

constexpr int kWarpgroup = 128;  // threads that run one wgmma together
constexpr int kBK = 64;          // k slice of a stage: 128 bytes of bf16
constexpr int kAtomBytes = 1024; // 8 rows x 128 bytes: the swizzle atom
constexpr int kChunk = 64;       // columns of an MN-major chunk
constexpr int kAccN = 256;       // columns of one warpgroup product
constexpr int kAccRegs = kAccN / 2;  // fp32 accumulators per thread

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor of up to three dimensions, innermost first: dims in
// elements, strides in elements for dimensions 1 and 2 (the innermost is
// contiguous), box in elements (box[0] at most 64: the 128-byte swizzle).
// What a box covers outside dims arrives as zeros. The base and every
// stride must be multiples of 16 bytes. Returns false where the
// encoding is refused.
inline bool make_map(CUtensorMap* map, const void* base, int rank,
                     const long long* dims, const long long* strides,
                     const int* box) {
  EncodeTiled fn = encode_tiled();
  if (!fn || rank < 2 || rank > 3) return false;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t gbox[3], estride[3];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    gbox[i] = static_cast<cuuint32_t>(box[i]);
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * 2;
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), gdim, gstride, gbox, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// device: mbarriers and the ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the asynchronous (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also announces the bytes the stage's loads will bring.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase differs from parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A ring of kStages stages. full[s] completes when the stage's loads have
// landed (one expect_tx arrival plus the bytes); empty[s] when every
// consumer warp has released it. The producer starts at parity 1 on empty,
// so its first pass over the ring does not wait.
template <int kStages>
struct Ring {
  uint64_t full[kStages];
  uint64_t empty[kStages];

  // one thread, before a __syncthreads()
  __device__ void init(int consumer_warps) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_fence_init();
  }
};

// A position in the ring: the stage and the parity of its current round.
template <int kStages>
struct RingPos {
  int stage = 0;
  int parity = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1;
    }
  }
};

// ---------------------------------------------------------------------------
// device: TMA loads
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// device: registers between the producer and the consumers
// ---------------------------------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// The 64-bit shared-memory descriptor of a 128-byte-swizzled tile: address,
// leading and stride byte offsets in 16-byte units, layout type 1 (B128).
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, int lbo_bytes,
                                              int sbo_bytes) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

// K-major tile [rows][64 k]: 8-row groups kAtomBytes apart; the leading
// offset is not used by the swizzled K-major layouts.
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) {
  return make_desc(smem_u32(tile), 16, kAtomBytes);
}
// MN-major tile [chunk][k rows][64 n]: chunks chunk_bytes apart, 8-row k
// groups kAtomBytes apart.
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile,
                                                  int chunk_bytes) {
  return make_desc(smem_u32(tile), chunk_bytes, kAtomBytes);
}
// A descriptor moved by bytes inside its tile (a k step, a row group).
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, int bytes) {
  return desc + static_cast<uint64_t>(bytes >> 4);
}
constexpr int kStepK = 32;      // bytes per k = 16 step, K-major
constexpr int kStepMN = 2048;   // bytes per k = 16 step, MN-major

// Orders the accumulator registers and earlier shared-memory writes before
// the wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most kPending committed groups are still running.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

#define HG_ACC8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HG_ACC32(d, i) \
  HG_ACC8(d, i), HG_ACC8(d, i + 8), HG_ACC8(d, i + 16), HG_ACC8(d, i + 24)

// d (64 x 256, fp32) = a (64 x 16) b (16 x 256) + (accumulate ? d : 0), bf16
// operands from shared memory. a is K-major; b is MN-major where
// kTransB == 1, K-major where 0. Asynchronous: d may be read after
// wgmma_commit() and wgmma_wait<>().
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[kAccRegs],
                                                 uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n"
      "}"
      : HG_ACC32(d, 0), HG_ACC32(d, 32), HG_ACC32(d, 64), HG_ACC32(d, 96)
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

// The same with a 128-column b (64 accumulators a thread).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[kAccRegs / 2],
                                                 uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}"
      : HG_ACC32(d, 0), HG_ACC32(d, 32)
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

#undef HG_ACC32
#undef HG_ACC8

// ---------------------------------------------------------------------------
// device: epilogue
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A warpgroup's 64 x 256 accumulators to bf16, stored at out (row 0, column
// 0 of the tile; ld elements between rows) for rows below rows and columns
// below cols (a multiple of 8). In the accumulator layout the four lanes of
// a quad hold 2 neighbouring columns each of one 8-column block; two
// shuffle rounds transpose four blocks across the quad, so that every lane
// holds the 8 columns (16 bytes) of one block and a quad writes 64
// contiguous bytes of a row.
__device__ __forceinline__ void store_acc_bf16(const float (&d)[kAccRegs],
                                               __nv_bfloat16* out,
                                               long long ld, int rows,
                                               int cols) {
  const int t = threadIdx.x % kWarpgroup;
  const int lane = t % 32, q = lane % 4;
  const int r0 = 16 * (t / 32) + lane / 4;
  const bool odd = q & 1, high = q & 2;
#pragma unroll
  for (int j0 = 0; j0 < kAccN / 8; j0 += 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = pack_bf16(d[4 * (j0 + i) + 2 * h], d[4 * (j0 + i) + 2 * h + 1]);
      // round 1, lanes q ^ 1: exchange the odd blocks for the even ones
      uint32_t s0 = odd ? v[0] : v[1], s1 = odd ? v[2] : v[3];
      s0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      s1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      if (odd) {
        v[0] = s0;
        v[2] = s1;
      } else {
        v[1] = s0;
        v[3] = s1;
      }
      // round 2, lanes q ^ 2: exchange the upper pair for the lower pair
      s0 = high ? v[0] : v[2];
      s1 = high ? v[1] : v[3];
      s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
      if (high) {
        v[0] = s0;
        v[1] = s1;
      } else {
        v[2] = s0;
        v[3] = s1;
      }
      const int r = r0 + 8 * h, c = 8 * (j0 + q);
      if (r < rows && c < cols)
        *reinterpret_cast<uint4*>(out + r * ld + c) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The same transpose in fp32 for a 64 x kN warpgroup product, for epilogues
// that add and test before they round: fn(r, c, v) for every 8 neighbouring
// columns of a row that this lane holds after it, r the row within the
// warpgroup's 64 and c the first
// column (a multiple of 8), v the 8 fp32 accumulators. Every lane of a
// quad calls fn once per row and group of four 8-column blocks.
template <int kN = kAccN, typename Fn>
__device__ __forceinline__ void for_each_acc8(const float (&d)[kN / 2],
                                              Fn fn) {
  const int t = threadIdx.x % kWarpgroup;
  const int lane = t % 32, q = lane % 4;
  const int r0 = 16 * (t / 32) + lane / 4;
  const bool odd = q & 1, high = q & 2;
  auto shfl2 = [](float2 v, int m) {
    return make_float2(__shfl_xor_sync(0xffffffffu, v.x, m),
                       __shfl_xor_sync(0xffffffffu, v.y, m));
  };
#pragma unroll
  for (int j0 = 0; j0 < kN / 8; j0 += 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = make_float2(d[4 * (j0 + i) + 2 * h], d[4 * (j0 + i) + 2 * h + 1]);
      // round 1, lanes q ^ 1: exchange the odd blocks for the even ones
      float2 s0 = odd ? v[0] : v[1], s1 = odd ? v[2] : v[3];
      s0 = shfl2(s0, 1);
      s1 = shfl2(s1, 1);
      if (odd) {
        v[0] = s0;
        v[2] = s1;
      } else {
        v[1] = s0;
        v[3] = s1;
      }
      // round 2, lanes q ^ 2: exchange the upper pair for the lower pair
      s0 = high ? v[0] : v[2];
      s1 = high ? v[1] : v[3];
      s0 = shfl2(s0, 2);
      s1 = shfl2(s1, 2);
      if (high) {
        v[0] = s0;
        v[1] = s1;
      } else {
        v[2] = s0;
        v[3] = s1;
      }
      float w[8] = {v[0].x, v[0].y, v[1].x, v[1].y,
                    v[2].x, v[2].y, v[3].x, v[3].y};
      fn(r0 + 8 * h, 8 * (j0 + q), w);
    }
  }
}

// n16 16-byte vectors of zeros at p, by nthreads threads of which this is
// thread tid.
__device__ __forceinline__ void zero_fill(uint4* p, long long n16, int tid,
                                          int nthreads) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = tid; i < n16; i += nthreads) p[i] = z;
}

}  // namespace hgemm
