// The two 1x1 convolutions of a UConvBlock as batched products,
// out[b, m, n] = sum_k A[b, m, k] Wt[k, n], for Hopper (sm_90a): the
// projection C_out -> C of uconv_pyramid.cu and res_conv C -> C_out of
// uconv_fuse_expand.cu. A is read in place (k contiguous, any row and
// sample strides that keep 16-byte alignment); Wt is the conv weight
// transposed, (K, N) contiguous, made once per set of parameters by the
// wrapper. An epilogue type adds what each product needs: the bias, the
// projection's storage and statistics, or res_conv's residual and zero pad
// rows. K and N are multiples of 64.
//
// bf16 runs on the tensor cores with the pieces of hopper_gemm.cuh: one
// persistent CTA per SM keeps all of Wt in shared memory (MN-major, at most
// 128 KB) and walks 128-row tiles of A; two consumer warpgroups multiply
// 64 rows each by 256 (or 128) columns at a time while a producer thread
// keeps TMA loads of A's 64-deep k slices in flight through a 4-stage ring,
// so the next part's loads overlap this part's epilogue. The map of A ends
// at M, so rows beyond read as zeros. The epilogue makes one pass over the
// accumulators (transposed across each quad to 16-byte stores): values,
// stores and the statistics' sums about one shared value.
//
// fp32 stays on the SIMT cores (TF32 would change the numbers): BM x 64
// tiles, 4 x 4 outputs a thread, read from shared memory as float4, 32-deep
// k slices in two buffers filled by cp.async (16 bytes a piece). BM is 64,
// or 32 where the product has few row tiles (res_conv at B = 1: 128 CTAs
// in place of 64 on 132 SMs).

#pragma once

#include "hopper_gemm.cuh"
#include "uconv_common.cuh"

namespace uconv {

// ---------------------------------------------------------------------------
// fp32, SIMT
// ---------------------------------------------------------------------------

constexpr int kFBN = 64, kFBK = 32;

struct Operand {
  const void* a;     // A[b, m, k] at a + b * ab + m * am + k
  long long ab, am;
  int M, N, K;
};

// grid (cdiv(M, BM), N / 64, B)
template <int BM, typename Epi>
__global__ void __launch_bounds__(BM * 4)
simt_gemm_kernel(const __grid_constant__ Operand op,
                 const float* __restrict__ Wt,
                 const __grid_constant__ Epi epi) {
  constexpr int NT = BM * 4;
  __shared__ __align__(16) float As[2][BM][kFBK + 4];
  __shared__ __align__(16) float Ws[2][kFBK][kFBN];
  __shared__ StatSmem<NT> ss;
  const int b = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * kFBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* A = static_cast<const float*>(op.a) + b * op.ab;
  auto stage = [&](int k0, int buf) {
#pragma unroll
    for (int j = 0; j < BM * kFBK / 4 / NT; ++j) {  // 16-byte pieces of A
      const int e = tid + j * NT, m = e / (kFBK / 4), kq = 4 * (e % (kFBK / 4));
      const bool ok = m0 + m < op.M && k0 + kq < op.K;
      cp_async16(&As[buf][m][kq],
                 ok ? A + (long long)(m0 + m) * op.am + k0 + kq : A, ok);
    }
#pragma unroll
    for (int j = 0; j < kFBK * kFBN / 4 / NT; ++j) {
      const int e = tid + j * NT, k = e / 16, nq = 4 * (e % 16);
      const bool ok = k0 + k < op.K;
      cp_async16(&Ws[buf][k][nq],
                 ok ? Wt + (long long)(k0 + k) * op.N + n0 + nq : Wt, ok);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  float acc[4][4] = {};
  const int slices = cdiv(op.K, kFBK);
  stage(0, 0);
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) {
      stage((s + 1) * kFBK, cur ^ 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < kFBK; kq += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&As[cur][ty * 4 + i][kq]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(&Ws[cur][kq + k][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = k == 0 ? a[i].x : k == 1 ? a[i].y
                         : k == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, w.x, acc[i][0]);
          acc[i][1] = fmaf(av, w.y, acc[i][1]);
          acc[i][2] = fmaf(av, w.z, acc[i][2]);
          acc[i][3] = fmaf(av, w.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // the buffer is refilled by the next stage()
  }

  // one pass: the values stored, and their sums about y0, a value the
  // epilogue names for the tile's first column (the same in every thread)
  const int n = n0 + tx * 4;
  const float y0 = epi.y0(n0);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
    if (epi.finalize(b, m, n, v)) {
      epi.store(b, m, n, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s1 += v[j] - y0;
        s2 = fmaf(v[j] - y0, v[j] - y0, s2);
      }
    }
  }
  if constexpr (Epi::kStats) {
    const int parts = gridDim.x * gridDim.y;
    const int idx = blockIdx.x * gridDim.y + blockIdx.y;
    const float cnt = static_cast<float>(min(BM, op.M - m0) * kFBN);
    tile_part<NT>(s1, s2, y0, cnt, ss,
                  epi.norm.part + 3LL * (b * parts + idx));
    finish(epi.norm.part + 3LL * b * parts, parts, epi.norm.count + b,
           epi.norm.stats + b, epi.eps);
  }
}

// The row tile: 64, or 32 where 64 would leave most of 132 SMs idle.
inline int simt_bm(int M, int N, int B) {
  return cdiv(M, 64) * (N / kFBN) * B >= 132 ? 64 : 32;
}
// Product tiles of one sample (one statistics part each).
inline int simt_tiles(int M, int N, int B) {
  return cdiv(M, simt_bm(M, N, B)) * (N / kFBN);
}

template <typename Epi>
cudaError_t launch_simt_gemm(const Operand& op, const float* Wt,
                             const Epi& epi, int B, cudaStream_t s) {
  const int n_t = op.N / kFBN;
  if (simt_bm(op.M, op.N, B) == 64) {
    simt_gemm_kernel<64, Epi><<<dim3(cdiv(op.M, 64), n_t, B), 256, 0, s>>>(
        op, Wt, epi);
  } else {
    simt_gemm_kernel<32, Epi><<<dim3(cdiv(op.M, 32), n_t, B), 128, 0, s>>>(
        op, Wt, epi);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, wgmma
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 3 * hgemm::kWarpgroup;
constexpr int kMmaM = 128;                           // rows of a tile
constexpr int kMmaRow = 128;  // bytes of a shared-memory row: 64 bf16
constexpr int kMmaA = kMmaM * kMmaRow;               // [128 m][64 k]
constexpr int kMmaStages = 4;
constexpr int kMmaWBytes = 128 * 1024;               // K x N bf16, at most

struct MmaSmem {
  unsigned char w[kMmaWBytes];  // [N / 64][K][64 n], MN-major
  unsigned char a[kMmaStages][kMmaA];
  hgemm::Ring<kMmaStages> ring;
  uint64_t w_full;
};
constexpr int kMmaSmemBytes = sizeof(MmaSmem) + hgemm::kAtomBytes;

// The two consumer warpgroups' own barrier (the producer's warpgroup does
// not take part in the epilogues).
struct ConsumerSync {
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync 1, 256;" ::: "memory");
  }
};

template <int kN>
__device__ __forceinline__ void wgmma_n(float (&d)[kN / 2], uint64_t a,
                                        uint64_t b, int accumulate) {
  if constexpr (kN == 256)
    hgemm::wgmma_m64n256k16<1>(d, a, b, accumulate);
  else
    hgemm::wgmma_m64n128k16<1>(d, a, b, accumulate);
}

// A persistent CTA per SM: it loads all of Wt into shared memory once (one
// TMA box of 64 x 64 per chunk and k slice), then walks the 128-row tiles
// t = blockIdx.x, + gridDim.x, ...; for each kN-column part of a tile its
// consumers run the 64-deep k slices of A that the producer streams through
// the ring, then the epilogue, while the producer already loads the next
// part's slices. kN: mma_n(N). Where N < kN the columns beyond N read
// chunks that hold other data or none: they are never stored or counted.
// grid (min(B * mt, SMs)); tile t is row tile t % mt of sample t / mt.
template <int kN, typename Epi>
__global__ void __launch_bounds__(kMmaThreads, 1)
mma_kernel(const __grid_constant__ CUtensorMap map_a,
           const __grid_constant__ CUtensorMap map_w, int M, int N, int K,
           int mt, int tiles, const __grid_constant__ Epi epi) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ StatSmem<2 * hgemm::kWarpgroup> ss;
  unsigned char* base = smem_raw + (hgemm::kAtomBytes -
                                    hgemm::smem_u32(smem_raw) %
                                        hgemm::kAtomBytes) %
                                       hgemm::kAtomBytes;
  MmaSmem& sm = *reinterpret_cast<MmaSmem*>(base);
  const int slices = K / hgemm::kBK, parts = cdiv(N, kN);
  const int w_chunk = K * kMmaRow;  // bytes of 64 columns of Wt
  if (threadIdx.x == 0) {
    sm.ring.init(2 * hgemm::kWarpgroup / 32);
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
      hgemm::mbar_expect_tx(&sm.w_full, (N / hgemm::kChunk) * w_chunk);
      for (int c = 0; c < N / hgemm::kChunk; ++c)
        for (int s = 0; s < slices; ++s)
          hgemm::tma_load_2d(sm.w + c * w_chunk + s * hgemm::kBK * kMmaRow,
                             &map_w, &sm.w_full, c * hgemm::kChunk,
                             s * hgemm::kBK);
      hgemm::RingPos<kMmaStages> pos;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x)
        for (int h = 0; h < parts; ++h)
          for (int s = 0; s < slices; ++s) {
            hgemm::mbar_wait(&sm.ring.empty[pos.stage], pos.parity ^ 1);
            uint64_t* full = &sm.ring.full[pos.stage];
            hgemm::mbar_expect_tx(full, kMmaA);
            hgemm::tma_load_3d(sm.a[pos.stage], &map_a, full, s * hgemm::kBK,
                               (t % mt) * kMmaM, t / mt);
            pos.advance();
          }
    }
    return;
  }
  hgemm::reg_alloc<232>();
  hgemm::mbar_wait(&sm.w_full, 0);
  hgemm::RingPos<kMmaStages> pos;
  float acc[kN / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / mt, m0 = (t % mt) * kMmaM, r0 = m0 + wg * 64;
    for (int h = 0; h < parts; ++h) {
      const int n0 = h * kN;
      int prev = -1;
      for (int s = 0; s < slices; ++s) {
        hgemm::mbar_wait(&sm.ring.full[pos.stage], pos.parity);
        const uint64_t da =
            hgemm::desc_k_major(sm.a[pos.stage] + wg * 64 * kMmaRow);
        const uint64_t db = hgemm::desc_mn_major(
            sm.w + (n0 / hgemm::kChunk) * w_chunk +
                s * hgemm::kBK * kMmaRow,
            w_chunk);
        hgemm::wgmma_fence();
#pragma unroll
        for (int i = 0; i < hgemm::kBK / 16; ++i)
          wgmma_n<kN>(acc, hgemm::desc_advance(da, i * hgemm::kStepK),
                      hgemm::desc_advance(db, i * hgemm::kStepMN),
                      s > 0 || i > 0);
        hgemm::wgmma_commit();
        hgemm::wgmma_wait<1>();  // the previous slice's products are done
        if (prev >= 0 && threadIdx.x % 32 == 0)
          hgemm::mbar_arrive(&sm.ring.empty[prev]);
        prev = pos.stage;
        pos.advance();
      }
      hgemm::wgmma_wait<0>();
      if (threadIdx.x % 32 == 0) hgemm::mbar_arrive(&sm.ring.empty[prev]);

      // one pass: the values stored, and their sums about y0 (see
      // simt_gemm_kernel)
      const float y0 = epi.y0(n0);
      float s1 = 0.f, s2 = 0.f;
      hgemm::for_each_acc8<kN>(acc, [&](int r, int c, float (&v)[8]) {
        if (n0 + c < N && epi.finalize(b, r0 + r, n0 + c, v)) {
          epi.store(b, r0 + r, n0 + c, v);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s1 += v[j] - y0;
            s2 = fmaf(v[j] - y0, v[j] - y0, s2);
          }
        }
      });
      if constexpr (Epi::kStats) {
        const int n_parts = mt * parts;
        const float cnt =
            static_cast<float>(min(kMmaM, M - m0) * min(kN, N - n0));
        tile_part<2 * hgemm::kWarpgroup>(
            s1, s2, y0, cnt, ss,
            epi.norm.part + 3LL * (b * n_parts + (t % mt) * parts + h),
            ConsumerSync{});
        finish(epi.norm.part + 3LL * b * n_parts, n_parts,
               epi.norm.count + b, epi.norm.stats + b, epi.eps);
      }
    }
  }
}

// The columns of one warpgroup product: 256, or 128 for N below 256.
__host__ __device__ inline int mma_n(int N) { return N >= 256 ? 256 : 128; }

// Statistics parts of one sample: one per 128-row tile and mma_n columns.
inline int mma_tiles(int M, int N) {
  return cdiv(M, kMmaM) * cdiv(N, mma_n(N));
}

// What the resident weight takes: N a multiple of 256 from 256 on, and the
// 64-column chunks that the products read (mma_n of them per part) within
// kMmaWBytes.
inline bool mma_fits(int K, int N) {
  const int parts = cdiv(N, mma_n(N));
  return K % hgemm::kBK == 0 && N % 64 == 0 &&
         (N < 256 || N % 256 == 0) &&
         (long long)parts * mma_n(N) * K * 2 <= kMmaWBytes;
}

// A: bf16 (k contiguous; a, ab, am multiples of 16 bytes); Wt: bf16 (K, N)
// with mma_fits(K, N).
template <typename Epi>
cudaError_t launch_mma(const Operand& op, const void* Wt, const Epi& epi,
                       int B, cudaStream_t s) {
  if (!mma_fits(op.K, op.N)) return cudaErrorInvalidValue;
  auto kernel = mma_n(op.N) == 128 ? mma_kernel<128, Epi>
                                   : mma_kernel<256, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  CUtensorMap map_a, map_w;
  const long long a_dims[3] = {op.K, op.M, B}, a_strides[2] = {op.am, op.ab};
  const int a_box[3] = {hgemm::kBK, kMmaM, 1};
  const long long w_dims[2] = {op.N, op.K}, w_strides[1] = {op.N};
  const int w_box[2] = {hgemm::kChunk, hgemm::kBK};
  if (!hgemm::make_map(&map_a, op.a, 3, a_dims, a_strides, a_box) ||
      !hgemm::make_map(&map_w, Wt, 2, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  const int mt = cdiv(op.M, kMmaM), tiles = B * mt;
  kernel<<<tiles < sms ? tiles : sms, kMmaThreads, kMmaSmemBytes, s>>>(
      map_a, map_w, op.M, op.N, op.K, mt, tiles, epi);
  return cudaGetLastError();
}

}  // namespace uconv
