// Micro-kernels of the UConvBlock's ops, one op each, for Hopper (sm_90a).
//
// Replaces the Pallas micro-benchmarks of scripts/probe_mosaic_ops.py and
// scripts/probe_mosaic_ops2.py: a copy, the five-tap FMA (fp32 or bf16
// accumulation), the decimation product, one-pass statistics + normalise,
// the projection product and the x2 row repeat, each on a (B, R, C) bf16
// tensor, whole or walked in row chunks. Every kernel takes one sample per
// blockIdx.x, as the scripts' grids do. Each computes what the Pallas body
// computes, not its block structure: where a script walks a sample in
// chunks of CH rows inside one TPU program, CH here is the rows one CTA
// takes (a template constant; 0 = the whole sample), so the question "which
// tile keeps the work on chip" is asked of the SM's registers and shared
// memory.
//
// Bounds: the copy, taps, statistics and repeat kernels move bytes (2 to 4
// bytes per element and a handful of operations); the decimation product
// ((1008, 2032) @ (2032, 512) per sample) is bound by operations, the
// projection product ((2032, 128) @ (128, 512)) by bytes. The products are
// this file's own. On bf16 operands they run on the tensor cores through
// wgmma, fed by TMA loads through a ring of shared-memory stages, with the
// pieces of hopper_gemm.cuh: 128 x 256 tiles from two consumer warpgroups
// and a producer thread; the decimation walks K through a 4-stage ring, the
// projection keeps the whole weight in shared memory in a persistent CTA
// per SM and streams the rows past it. On fp32 operands the decimation
// stays on the SIMT cores (TF32 would change the numbers): 128 x 128 tiles,
// 8 x 8 outputs a thread, cp.async double buffering. Rows a script's body
// never writes are written as zeros, in 16-byte stores.

#include "hopper_gemm.cuh"
#include "uconv_common.cuh"

namespace {

using namespace uconv;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kT = 256;  // threads of the elementwise kernels

// ---------------------------------------------------------------------------
// copy and repeat: 16-byte vectors
// ---------------------------------------------------------------------------

// grid (B, tiles of the sample's vectors)
__global__ void __launch_bounds__(kT)
copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ o, int per) {
  const int i = blockIdx.y * kT + threadIdx.x;
  if (i >= per) return;
  const long long off = (long long)blockIdx.x * per + i;
  o[off] = x[off];
}

// out row r = x row r / 2 for r < 2 * n_src, zero below. vpr: vectors per
// row. grid (B, tiles of R * vpr)
__global__ void __launch_bounds__(kT)
repeat_kernel(const uint4* __restrict__ x, uint4* __restrict__ o, int R,
              int vpr, int n_src) {
  const int i = blockIdx.y * kT + threadIdx.x;
  if (i >= R * vpr) return;
  const int r = i / vpr, v = i % vpr;
  const long long base = (long long)blockIdx.x * R * vpr;
  o[base + i] = r < 2 * n_src ? x[base + (r / 2) * vpr + v]
                              : make_uint4(0u, 0u, 0u, 0u);
}

// ---------------------------------------------------------------------------
// five-tap FMA: out[8 + r] = sum_k x[6 + k + r] * w[k] for r in [0, N),
// zero rows elsewhere. A thread takes two neighbouring channels and walks
// its rows with the five input rows in registers. A CTA is (channel pairs,
// row shares): the rows it takes, CH or the whole sample, are split evenly
// among its blockDim.y row shares. The chunked CTAs are (128, 1); the CTA of
// a whole sample is (32, 8), a 64-channel band whose eight warps each walk
// an eighth of the rows, so that 48 CTAs of 4 warps become 192 of 8 and the
// loads in flight cover the card.
// grid (B, chunks of CH rows, C / (2 * blockDim.x))
// ---------------------------------------------------------------------------

constexpr int kTapT = 128;                   // threads of a chunked CTA
constexpr int kTapBand = 32, kTapShares = 8; // the whole-sample CTA

template <int CH, bool kBf16Acc>
__global__ void __launch_bounds__(kTapBand * kTapShares)
taps_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
            bf16* __restrict__ o, int R, int C, int N) {
  const int ch = CH > 0 ? CH : N;
  const int c = 2 * (blockIdx.z * blockDim.x + threadIdx.x);
  if (c >= C) return;
  const int c0 = blockIdx.y * ch, c1 = min(c0 + ch, N);
  const int share = cdiv(c1 - c0, static_cast<int>(blockDim.y));
  const int r0 = min(c0 + static_cast<int>(threadIdx.y) * share, c1),
            r1 = min(r0 + share, c1);
  const bf16* xs = x + (long long)blockIdx.x * R * C + c;
  bf16* os = o + (long long)blockIdx.x * R * C + c;
  const bf162 zero = __floats2bfloat162_rn(0.f, 0.f);
  if (blockIdx.y == 0 && threadIdx.y == 0)
    for (int r = 0; r < 8; ++r)
      *reinterpret_cast<bf162*>(os + (long long)r * C) = zero;
  if (c1 == N && threadIdx.y == blockDim.y - 1)
    for (int r = 8 + N; r < R; ++r)
      *reinterpret_cast<bf162*>(os + (long long)r * C) = zero;
  if (r0 >= r1) return;
  float2 wf[5];
  bf162 wb[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    wf[k] = make_float2(w[k * C + c], w[k * C + c + 1]);
    wb[k] = __floats2bfloat162_rn(wf[k].x, wf[k].y);
  }
  bf162 win[5];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    win[k] = *reinterpret_cast<const bf162*>(xs + (long long)(6 + r0 + k) * C);
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    win[4] = *reinterpret_cast<const bf162*>(xs + (long long)(10 + r) * C);
    bf162 res;
    if (kBf16Acc) {  // every product and every sum rounded to bf16
      bf162 acc = __hmul2_rn(win[0], wb[0]);
#pragma unroll
      for (int k = 1; k < 5; ++k)
        acc = __hadd2_rn(acc, __hmul2_rn(win[k], wb[k]));
      res = acc;
    } else {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float2 t = __bfloat1622float2(win[k]);
        acc.x = fmaf(t.x, wf[k].x, acc.x);
        acc.y = fmaf(t.y, wf[k].y, acc.y);
      }
      res = __floats2bfloat162_rn(acc.x, acc.y);
    }
    *reinterpret_cast<bf162*>(os + (long long)(8 + r) * C) = res;
#pragma unroll
    for (int k = 0; k < 4; ++k) win[k] = win[k + 1];
  }
}

// ---------------------------------------------------------------------------
// decimation product: out[b, m, n] = sum_k D[m, k] x[b, k, n] for m < M,
// zero rows below; D (M, R) is shared by the samples.
// ---------------------------------------------------------------------------

// fp32 operands (x converted as it is staged) on the SIMT cores: TF32 would
// change the numbers. 128 x 128 output tiles, 8 x 8 outputs per thread read
// from shared memory as float4, 16-deep k slices in two buffers: D arrives
// by cp.async (16 bytes a thread, zero-filled beyond M and R), x through
// registers, loaded before the slice's products and converted after them.
// grid (cdiv(R, 128), cdiv(C, 128), B): the tiles below M are zeros.
constexpr int kFM = 128, kFN = 128, kFK = 16, kFThreads = 256;

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   hgemm::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__global__ void __launch_bounds__(kFThreads, 2)
dec_f32_kernel(const bf16* __restrict__ x, const float* __restrict__ D,
               bf16* __restrict__ o, int R, int C, int M) {
  __shared__ __align__(16) float As[2][kFM][kFK + 4];
  __shared__ __align__(16) float Xs[2][kFK][kFN];
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bf16* xs = x + (long long)blockIdx.z * R * C;
  bf16* os = o + (long long)blockIdx.z * R * C;
  const int row_end = min(m0 + kFM, R), vecs = min(kFN, C - n0) / 8;
  if (m0 >= M) {  // a tile of zero rows
    for (int e = tid; e < (row_end - m0) * vecs; e += kFThreads)
      *reinterpret_cast<uint4*>(os + (long long)(m0 + e / vecs) * C + n0 +
                                8 * (e % vecs)) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  // this thread's share of a slice: two 16-byte pieces of D, one of x
  const int xk = tid / 16, xn = n0 + 8 * (tid % 16);
  auto stage_d = [&](int k0, int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + j * kFThreads, m = e / 4, k = k0 + 4 * (e % 4);
      const bool ok = m0 + m < M && k < R;
      cp_async_16(&As[buf][m][4 * (e % 4)],
                  ok ? D + (long long)(m0 + m) * R + k : D, ok);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  auto load_x = [&](int k0) {
    return (k0 + xk < R && xn < C)
               ? *reinterpret_cast<const uint4*>(
                     xs + (long long)(k0 + xk) * C + xn)
               : make_uint4(0u, 0u, 0u, 0u);
  };
  auto stage_x = [&](uint4 v, int buf) {
    const bf162* h = reinterpret_cast<const bf162*>(&v);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]),
                 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    float4* dst = reinterpret_cast<float4*>(&Xs[buf][xk][8 * (tid % 16)]);
    dst[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
    dst[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
  };
  float acc[8][8] = {};
  const int slices = cdiv(R, kFK);
  stage_d(0, 0);
  stage_x(load_x(0), 0);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < slices;
    uint4 next = make_uint4(0u, 0u, 0u, 0u);
    if (more) {
      stage_d((s + 1) * kFK, cur ^ 1);
      next = load_x((s + 1) * kFK);
    }
#pragma unroll
    for (int kq = 0; kq < kFK; kq += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            &As[cur][(i / 4) * 64 + ty * 4 + i % 4][kq]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&Xs[cur][kq + k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Xs[cur][kq + k][64 + tx * 4]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = k == 0 ? a[i].x : k == 1 ? a[i].y
                         : k == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
    if (more) {
      stage_x(next, cur ^ 1);
      asm volatile("cp.async.wait_all;" ::: "memory");
    }
    __syncthreads();
  }
  // rows of the tile at or beyond M multiplied zero-filled rows of D
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int n = n0 + g * 64 + tx * 4;
      if (m < R && n < C)
        *reinterpret_cast<uint2*>(os + (long long)m * C + n) = make_uint2(
            hgemm::pack_bf16(acc[i][4 * g], acc[i][4 * g + 1]),
            hgemm::pack_bf16(acc[i][4 * g + 2], acc[i][4 * g + 3]));
    }
  }
}

// The two bf16 products below share one CTA shape (hopper_gemm.cuh has the
// pieces): 384 threads, of which warpgroups 0 and 1 consume (64 rows x 256
// columns of fp32 accumulators each, so a CTA's tile is 128 x 256) and one
// thread of warpgroup 2 produces, keeping TMA loads in flight through the
// ring; the producer's warpgroup hands its registers to the consumers.
constexpr int kProdThreads = 3 * hgemm::kWarpgroup;
constexpr int kConsumerWarps = 2 * hgemm::kWarpgroup / 32;
constexpr int kTileM = 128, kTileN = hgemm::kAccN;
constexpr int kRowBytes = 128;  // a shared-memory row: 64 bf16

__device__ __forceinline__ unsigned char* align_tile(unsigned char* p) {
  return p + (hgemm::kAtomBytes - hgemm::smem_u32(p) % hgemm::kAtomBytes) %
                 hgemm::kAtomBytes;
}

// bf16 operands on the tensor cores (wgmma), fp32 accumulation. Bound by
// operations. A CTA computes one 128 x 256 tile of one sample over the whole
// of K in 64-deep slices through a 4-stage ring: D (K-major) as one TMA box
// a slice, x[b] (N contiguous: MN-major) as four. Tile order: the row tiles
// of one x panel are neighbours, so a wave of CTAs shares its x panels and
// all of D (4 MB) in the L2. Rows beyond M inside the last row tile multiply
// zero-filled rows of D; the rows below the last row tile, half of the
// output, are written by the first zero_ctas CTAs of the grid, which do
// nothing else (16-byte stores), so they are scheduled first and out of the
// products' way.
// grid (zero_ctas + B * mt * nt)
constexpr int kDecStages = 4;
constexpr int kDecA = kTileM * kRowBytes;         // [128 m][64 k]
constexpr int kDecBChunk = hgemm::kBK * kRowBytes;  // [64 k][64 n]
constexpr int kDecB = (kTileN / hgemm::kChunk) * kDecBChunk;

struct DecSmem {
  unsigned char a[kDecStages][kDecA];
  unsigned char b[kDecStages][kDecB];
  hgemm::Ring<kDecStages> ring;
};
constexpr int kDecSmemBytes = sizeof(DecSmem) + hgemm::kAtomBytes;

__global__ void __launch_bounds__(kProdThreads, 1)
dec_bf16_kernel(const __grid_constant__ CUtensorMap map_d,
                const __grid_constant__ CUtensorMap map_x,
                bf16* __restrict__ o, int R, int C, int mt, int nt,
                int zero_ctas, int zero_per_sample) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (static_cast<int>(blockIdx.x) < zero_ctas) {
    const int b = blockIdx.x / zero_per_sample,
              part = blockIdx.x % zero_per_sample;
    const int z0 = mt * kTileM;
    const long long per = (long long)(R - z0) * C / 8;
    const long long lo = per * part / zero_per_sample,
                    hi = per * (part + 1) / zero_per_sample;
    hgemm::zero_fill(
        reinterpret_cast<uint4*>(o + ((long long)b * R + z0) * C) + lo,
        hi - lo, threadIdx.x, kProdThreads);
    return;
  }
  DecSmem& sm = *reinterpret_cast<DecSmem*>(align_tile(smem_raw));
  const int t = blockIdx.x - zero_ctas;
  const int m0 = (t % mt) * kTileM, n0 = (t / mt % nt) * kTileN,
            b = t / (mt * nt);
  const int slices = cdiv(R, hgemm::kBK);
  if (threadIdx.x == 0) {
    sm.ring.init(kConsumerWarps);
    hgemm::prefetch_map(&map_d);
    hgemm::prefetch_map(&map_x);
  }
  __syncthreads();
  const int wg = threadIdx.x / hgemm::kWarpgroup;
  if (wg == 2) {
    hgemm::reg_dealloc<40>();
    if (threadIdx.x == 2 * hgemm::kWarpgroup) {
      hgemm::RingPos<kDecStages> pos;
      for (int s = 0; s < slices; ++s) {
        hgemm::mbar_wait(&sm.ring.empty[pos.stage], pos.parity ^ 1);
        uint64_t* full = &sm.ring.full[pos.stage];
        hgemm::mbar_expect_tx(full, kDecA + kDecB);
        hgemm::tma_load_2d(sm.a[pos.stage], &map_d, full, s * hgemm::kBK, m0);
#pragma unroll
        for (int c = 0; c < kTileN / hgemm::kChunk; ++c)
          hgemm::tma_load_3d(sm.b[pos.stage] + c * kDecBChunk, &map_x, full,
                             n0 + c * hgemm::kChunk, s * hgemm::kBK, b);
        pos.advance();
      }
    }
  } else {
    hgemm::reg_alloc<232>();
    float acc[hgemm::kAccRegs];
    hgemm::RingPos<kDecStages> pos;
    int prev = -1;
    for (int s = 0; s < slices; ++s) {
      hgemm::mbar_wait(&sm.ring.full[pos.stage], pos.parity);
      const uint64_t da = hgemm::desc_k_major(sm.a[pos.stage] +
                                              wg * 64 * kRowBytes);
      const uint64_t db = hgemm::desc_mn_major(sm.b[pos.stage], kDecBChunk);
      hgemm::wgmma_fence();
#pragma unroll
      for (int i = 0; i < hgemm::kBK / 16; ++i)
        hgemm::wgmma_m64n256k16<1>(
            acc, hgemm::desc_advance(da, i * hgemm::kStepK),
            hgemm::desc_advance(db, i * hgemm::kStepMN), s > 0 || i > 0);
      hgemm::wgmma_commit();
      hgemm::wgmma_wait<1>();  // the previous slice's products are done
      if (prev >= 0 && threadIdx.x % 32 == 0)
        hgemm::mbar_arrive(&sm.ring.empty[prev]);
      prev = pos.stage;
      pos.advance();
    }
    hgemm::wgmma_wait<0>();
    const int r0 = m0 + wg * 64;
    hgemm::store_acc_bf16(acc, o + ((long long)b * R + r0) * C + n0, C,
                          R - r0, C - n0);
  }
}

// ---------------------------------------------------------------------------
// projection product: out[b, m, n] = sum_k a[b, m, k] Wp[k, n] for
// m < rows, zero rows below; k < kProjK, C <= kProjMaxC.
//
// Bound by bytes (a read once, 4 x its bytes written), so the design moves
// each byte once: a persistent CTA per SM stages the whole weight (128 x C,
// N contiguous: MN-major, 128 KB at C 512) in shared memory once, then walks
// its share of the 128-row tiles: a (K-major, read in place through its
// strides) arrives through a 3-stage ring, each consumer warpgroup
// multiplies its 64 rows by each 256-column half of the weight (8 k steps)
// and stores the half as 16-byte vectors while the other warpgroup and the
// next tile's loads are in flight. The a map ends at rows, so the rows below
// read as zeros; tiles that start below rows are written as zeros without
// loads.
//
// An item is the rows a CTA takes in one visit: tpi consecutive 128-row
// tiles of one sample (chunk / 128; 1 for the whole sample, where the visit
// is a tile). The CTAs split the item list evenly in contiguous runs.
// grid (min(items, SMs))
// ---------------------------------------------------------------------------

constexpr int kProjK = 128;
constexpr int kProjMaxC = 512;
constexpr int kProjStages = 3;
constexpr int kProjAChunk = kTileM * kRowBytes;               // [128 m][64 k]
constexpr int kProjA = (kProjK / hgemm::kBK) * kProjAChunk;
constexpr int kProjWChunk = kProjK * kRowBytes;               // [128 k][64 n]

struct ProjSmem {
  unsigned char w[kProjMaxC / hgemm::kChunk][kProjWChunk];
  unsigned char a[kProjStages][kProjA];
  hgemm::Ring<kProjStages> ring;
  uint64_t w_full;
};
constexpr int kProjSmemBytes = sizeof(ProjSmem) + hgemm::kAtomBytes;

__global__ void __launch_bounds__(kProdThreads, 1)
proj_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_w, bf16* __restrict__ o,
            int R, int C, int rows, int tiles_per_sample, int tpi, int ips,
            int items) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  ProjSmem& sm = *reinterpret_cast<ProjSmem*>(align_tile(smem_raw));
  const int it0 = (long long)items * blockIdx.x / gridDim.x,
            it1 = (long long)items * (blockIdx.x + 1) / gridDim.x;
  if (threadIdx.x == 0) {
    sm.ring.init(kConsumerWarps);
    hgemm::mbar_init(&sm.w_full, 1);
    hgemm::mbar_fence_init();
    hgemm::prefetch_map(&map_a);
    hgemm::prefetch_map(&map_w);
  }
  __syncthreads();
  const int wg = threadIdx.x / hgemm::kWarpgroup;
  if (wg == 2) {
    hgemm::reg_dealloc<40>();
    if (threadIdx.x == 2 * hgemm::kWarpgroup) {
      const int chunks = C / hgemm::kChunk;
      hgemm::mbar_expect_tx(&sm.w_full, chunks * kProjWChunk);
      for (int c = 0; c < chunks; ++c)
        hgemm::tma_load_2d(sm.w[c], &map_w, &sm.w_full, c * hgemm::kChunk, 0);
      hgemm::RingPos<kProjStages> pos;
      for (int it = it0; it < it1; ++it) {
        const int b = it / ips, first = (it % ips) * tpi,
                  last = min(first + tpi, tiles_per_sample);
        for (int tile = first; tile < last; ++tile) {
          const int m0 = tile * kTileM;
          if (m0 >= rows) break;  // zero tiles: nothing to load
          hgemm::mbar_wait(&sm.ring.empty[pos.stage], pos.parity ^ 1);
          uint64_t* full = &sm.ring.full[pos.stage];
          hgemm::mbar_expect_tx(full, kProjA);
#pragma unroll
          for (int kc = 0; kc < kProjK / hgemm::kBK; ++kc)
            hgemm::tma_load_3d(sm.a[pos.stage] + kc * kProjAChunk, &map_a,
                               full, kc * hgemm::kBK, m0, b);
          pos.advance();
        }
      }
    }
  } else {
    hgemm::reg_alloc<232>();
    float acc[hgemm::kAccRegs];
    hgemm::RingPos<kProjStages> pos;
    const int halves = cdiv(C, kTileN);
    const int ctid = threadIdx.x;  // 0 .. 255 among the consumers
    hgemm::mbar_wait(&sm.w_full, 0);
    for (int it = it0; it < it1; ++it) {
      const int b = it / ips, first = (it % ips) * tpi,
                last = min(first + tpi, tiles_per_sample);
      for (int tile = first; tile < last; ++tile) {
        const int m0 = tile * kTileM;
        bf16* ot = o + ((long long)b * R + m0) * C;
        if (m0 >= rows) {
          hgemm::zero_fill(reinterpret_cast<uint4*>(ot),
                           (long long)(min(m0 + kTileM, R) - m0) * C / 8,
                           ctid, 2 * hgemm::kWarpgroup);
          continue;
        }
        hgemm::mbar_wait(&sm.ring.full[pos.stage], pos.parity);
        const uint64_t da = hgemm::desc_k_major(sm.a[pos.stage] +
                                                wg * 64 * kRowBytes);
        for (int h = 0; h < halves; ++h) {
          const uint64_t db = hgemm::desc_mn_major(
              sm.w[h * (kTileN / hgemm::kChunk)], kProjWChunk);
          hgemm::wgmma_fence();
#pragma unroll
          for (int i = 0; i < kProjK / 16; ++i)
            hgemm::wgmma_m64n256k16<1>(
                acc,
                hgemm::desc_advance(da, (i / 4) * kProjAChunk +
                                            (i % 4) * hgemm::kStepK),
                hgemm::desc_advance(db, i * hgemm::kStepMN), i > 0);
          hgemm::wgmma_commit();
          hgemm::wgmma_wait<0>();
          if (h == halves - 1 && threadIdx.x % 32 == 0)
            hgemm::mbar_arrive(&sm.ring.empty[pos.stage]);
          hgemm::store_acc_bf16(acc, ot + (long long)wg * 64 * C + h * kTileN,
                                C, R - m0 - wg * 64, C - h * kTileN);
        }
        pos.advance();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// one-pass statistics over rows [0, rows) of each sample, divided by R * C
// whatever rows is, then (x - mean) * rstd on those rows and zeros below.
// Two launches: per-tile (sum, sum of squares), then a fixed-order sum of the
// sample's tiles in every CTA and the normalise. A CTA takes ROWS rows of a
// band of BAND channels (BAND 0: all of them): 512-row chunks are cut into
// 64-channel bands, so that 72 and 96 CTAs become 576 and 768 and cover the
// card; the merge runs over chunks and bands in one fixed order.
// grid (B, chunks, bands)
// ---------------------------------------------------------------------------

// The thread's walk over its CTA's tile: fn(offset in the sample, row).
template <int ROWS, int BAND, typename Fn>
__device__ __forceinline__ void stats_walk(int R, int C, int r_end, Fn fn) {
  const int band = BAND > 0 ? BAND : C;
  const int tpr = min(kT, band / 2);  // threads along a row, 2 channels each
  const int rpp = kT / tpr;           // rows a pass of the CTA covers
  if (static_cast<int>(threadIdx.x) >= rpp * tpr) return;
  const int c0 = blockIdx.z * band + 2 * (threadIdx.x % tpr);
  const int r0 = blockIdx.y * ROWS, r1 = min(r0 + ROWS, r_end);
  for (int r = r0 + threadIdx.x / tpr; r < r1; r += rpp)
    for (int c = c0; c < (blockIdx.z + 1) * band; c += 2 * tpr)
      fn((long long)r * C + c, r);
}

template <int ROWS, int BAND>
__global__ void __launch_bounds__(kT)
stats_sum_kernel(const bf16* __restrict__ x, float* __restrict__ partials,
                 int R, int C, int rows) {
  __shared__ float red[kT / 32];
  const bf16* xs = x + (long long)blockIdx.x * R * C;
  float s = 0.f, ss = 0.f;
  stats_walk<ROWS, BAND>(R, C, rows, [&](long long off, int) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const bf162*>(xs + off));
    s += v.x + v.y;
    ss = fmaf(v.x, v.x, fmaf(v.y, v.y, ss));
  });
  s = block_sum<kT>(s, red);
  ss = block_sum<kT>(ss, red);
  if (threadIdx.x == 0) {
    float* p = partials + 2 * (((long long)blockIdx.x * gridDim.y +
                                blockIdx.y) * gridDim.z + blockIdx.z);
    p[0] = s;
    p[1] = ss;
  }
}

template <int ROWS, int BAND>
__global__ void __launch_bounds__(kT)
stats_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ partials,
                  bf16* __restrict__ o, int R, int C, int rows, int tiles,
                  float eps) {
  const float* p = partials + 2LL * blockIdx.x * tiles;
  float s = 0.f, ss = 0.f;
  for (int i = 0; i < tiles; ++i) {
    s += p[2 * i];
    ss += p[2 * i + 1];
  }
  const float n = static_cast<float>(R) * static_cast<float>(C);
  const float mean = s / n;
  const float rstd = rsqrtf(ss / n - mean * mean + eps);
  const long long base = (long long)blockIdx.x * R * C;
  stats_walk<ROWS, BAND>(R, C, R, [&](long long off, int r) {
    float2 v = make_float2(0.f, 0.f);
    if (r < rows) {
      v = __bfloat1622float2(*reinterpret_cast<const bf162*>(x + base + off));
      v.x = (v.x - mean) * rstd;
      v.y = (v.y - mean) * rstd;
    }
    *reinterpret_cast<bf162*>(o + base + off) = __floats2bfloat162_rn(v.x, v.y);
  });
}

template <int ROWS, int BAND>
cudaError_t run_stats(const bf16* x, bf16* o, float* partials, int B, int R,
                      int C, int rows, float eps, cudaStream_t s) {
  const int chunks = cdiv(rows, ROWS), bands = BAND > 0 ? C / BAND : 1;
  stats_sum_kernel<ROWS, BAND><<<dim3(B, chunks, bands), kT, 0, s>>>(
      x, partials, R, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_norm_kernel<ROWS, BAND><<<dim3(B, cdiv(R, ROWS), bands), kT, 0, s>>>(
      x, partials, o, R, C, rows, chunks * bands, eps);
  return cudaGetLastError();
}

constexpr int kStatsBand = 64;  // channels of a 512-row chunk's CTA

bool bad_shape(int B, int R, int C) {
  return B < 1 || B > 65535 || R < 1 || C < 1 || C % 64 != 0 ||
         (long long)R * C >= (1LL << 31);
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// The decimation's zero-only CTAs: rows [first_row, R) of a sample, which no
// row tile covers, in pieces of about 256 KB.
struct DecZeros {
  int first_row, per_sample;
};
DecZeros dec_zeros(int R, int C, int mt) {
  const int first = mt * kTileM < R ? mt * kTileM : R;
  const long long bytes = (long long)(R - first) * C * 2;
  const long long n = (bytes + (256 << 10) - 1) / (256 << 10);
  return {first, static_cast<int>(n > 16 ? 16 : n)};
}

// The projection's items: see proj_kernel.
struct ProjItems {
  int tiles_per_sample, tpi, ips, items;
};
ProjItems proj_items(int B, int R, int chunk) {
  const int tiles = cdiv(R, kTileM), tpi = chunk > 0 ? chunk / kTileM : 1,
            ips = cdiv(tiles, tpi);
  return {tiles, tpi, ips, B * ips};
}

// The CUDA error for a tensor map that could not be encoded.
constexpr int kBadMap = static_cast<int>(cudaErrorInvalidValue);

// Lets a kernel use bytes of dynamic shared memory on the current device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// Every tensor is contiguous bf16 (B, R, C) unless said otherwise; C is a
// multiple of 64. Every function returns a cudaError_t, 0 on success.

int micro_copy(const void* x, void* o, int B, int R, int C, void* stream) {
  if (bad_shape(B, R, C)) return static_cast<int>(cudaErrorInvalidValue);
  const int per = R * C / 8;
  copy_kernel<<<dim3(B, cdiv(per, kT)), kT, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(o), per);
  return static_cast<int>(cudaGetLastError());
}

// rows [0, 2 * n_src) repeat x's rows [0, n_src) twice each
int micro_repeat(const void* x, void* o, int B, int R, int C, int n_src,
                 void* stream) {
  if (bad_shape(B, R, C) || n_src < 0 || 2 * n_src > R)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vpr = C / 8;
  repeat_kernel<<<dim3(B, cdiv(R * vpr, kT)), kT, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(o), R, vpr, n_src);
  return static_cast<int>(cudaGetLastError());
}

// w: fp32 (>= 5, C) taps. N output rows at 8 .. 8 + N. chunk: rows per CTA,
// 0 (the whole sample), 512 or 128. bf16acc: accumulate in bf16.
int micro_taps(const void* x, const float* w, void* o, int B, int R, int C,
               int N, int chunk, int bf16acc, void* stream) {
  if (bad_shape(B, R, C) || N < 1 || N + 10 > R)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cz = cdiv(C, 2 * kTapT);
  const dim3 whole(kTapBand, kTapShares), bands(B, 1, C / (2 * kTapBand));
  if (chunk == 0 && bf16acc)
    taps_kernel<0, true><<<bands, whole, 0, s>>>(xp, w, op, R, C, N);
  else if (chunk == 0)
    taps_kernel<0, false><<<bands, whole, 0, s>>>(xp, w, op, R, C, N);
  else if (chunk == 512 && !bf16acc)
    taps_kernel<512, false><<<dim3(B, cdiv(N, 512), cz), kTapT, 0, s>>>(
        xp, w, op, R, C, N);
  else if (chunk == 128 && !bf16acc)
    taps_kernel<128, false><<<dim3(B, cdiv(N, 128), cz), kTapT, 0, s>>>(
        xp, w, op, R, C, N);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// D: (M, R), fp32 (bf16 == 0: SIMT product on fp32 operands) or bf16 (tensor
// cores); rows [M, R) of the output are zero. R is a multiple of 8 and every
// pointer of 16 bytes.
int micro_decimate(const void* x, const void* D, void* o, int B, int R, int C,
                   int M, int bf16_operands, void* stream) {
  if (bad_shape(B, R, C) || M < 1 || M > R || R % 8 != 0 ||
      misaligned(x) || misaligned(D) || misaligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16_operands) {
    dec_f32_kernel<<<dim3(cdiv(R, kFM), cdiv(C, kFN), B), kFThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(D),
        static_cast<bf16*>(o), R, C, M);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t allowed = allow_smem(dec_bf16_kernel, kDecSmemBytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  // the maps hold the operands' addresses: encoded in every call
  CUtensorMap map_d, map_x;
  const long long d_dims[2] = {R, M}, d_strides[1] = {R};
  const int d_box[2] = {hgemm::kBK, kTileM};
  const long long x_dims[3] = {C, R, B}, x_strides[2] = {C, (long long)R * C};
  const int x_box[3] = {hgemm::kChunk, hgemm::kBK, 1};
  if (!hgemm::make_map(&map_d, D, 2, d_dims, d_strides, d_box) ||
      !hgemm::make_map(&map_x, x, 3, x_dims, x_strides, x_box))
    return kBadMap;
  const int mt = cdiv(M, kTileM), nt = cdiv(C, kTileN);
  const DecZeros z = dec_zeros(R, C, mt);
  dec_bf16_kernel<<<B * (z.per_sample + mt * nt), kProdThreads, kDecSmemBytes,
                    s>>>(map_d, map_x, static_cast<bf16*>(o), R, C, mt, nt,
                         B * z.per_sample, z.per_sample);
  return static_cast<int>(cudaGetLastError());
}

// a: bf16, element (b, m, k) at a + b*ab + m*am + k, k < 128, read in place:
// a, ab and am are multiples of 16 bytes. Wp: bf16 (128, C), C at most 512.
// rows: output rows that hold the product, zero below. chunk: rows a CTA
// takes per visit, 0 (a 128-row tile of the whole sample), 512 or 128.
int micro_proj(const void* a, long long ab, long long am, const void* Wp,
               void* o, int B, int R, int C, int rows, int chunk,
               void* stream) {
  if (bad_shape(B, R, C) || C > kProjMaxC || rows < 0 || rows > R ||
      (chunk != 0 && chunk != 512 && chunk != 128) || ab % 8 != 0 ||
      am % 8 != 0 || am < kProjK || misaligned(a) || misaligned(Wp) ||
      misaligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t allowed = allow_smem(proj_kernel, kProjSmemBytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    return static_cast<int>(cudaErrorInvalidDevice);
  CUtensorMap map_a, map_w;
  const long long a_dims[3] = {kProjK, rows > 0 ? rows : 1, B},
                  a_strides[2] = {am, ab};
  const int a_box[3] = {hgemm::kBK, kTileM, 1};
  const long long w_dims[2] = {C, kProjK}, w_strides[1] = {C};
  const int w_box[2] = {hgemm::kChunk, kProjK};
  if (!hgemm::make_map(&map_a, a, 3, a_dims, a_strides, a_box) ||
      !hgemm::make_map(&map_w, Wp, 2, w_dims, w_strides, w_box))
    return kBadMap;
  const ProjItems it = proj_items(B, R, chunk);
  proj_kernel<<<it.items < sms ? it.items : sms, kProdThreads, kProjSmemBytes,
                static_cast<cudaStream_t>(stream)>>>(
      map_a, map_w, static_cast<bf16*>(o), R, C, rows, it.tiles_per_sample,
      it.tpi, it.ips, it.items);
  return static_cast<int>(cudaGetLastError());
}

// fp32 floats of scratch micro_stats needs: a (sum, sum of squares) per tile.
long long micro_stats_scratch(int B, int C, int rows, int chunk) {
  return chunk == 512 ? 2LL * B * cdiv(rows, 512) * (C / kStatsBand)
                      : 2LL * B * cdiv(rows, 16);
}

// Statistics over rows [0, rows), divided by R * C; chunk: rows per CTA, 0
// (16-row tiles over the whole sample) or 512 (in 64-channel bands).
int micro_stats(const void* x, void* o, float* partials, int B, int R, int C,
                int rows, int chunk, float eps, void* stream) {
  if (bad_shape(B, R, C) || rows < 1 || rows > R)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk == 0)
    return static_cast<int>(
        run_stats<16, 0>(xp, op, partials, B, R, C, rows, eps, s));
  if (chunk == 512)
    return static_cast<int>(
        run_stats<512, kStatsBand>(xp, op, partials, B, R, C, rows, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
