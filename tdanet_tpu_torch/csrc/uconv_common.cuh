// Pieces shared by the two UConvBlock kernels (uconv_pyramid.cu,
// uconv_fuse_expand.cu), for Hopper (sm_90a).
//
// Layout. A scale of true length T lives in a padded channels-last buffer
// (B, padded_rows(T), C): true row t at buffer row kPad + t, zero rows
// around it. The kernels hand a buffer around as a pointer to its first
// true row, so a k5 tap at row t - 2 reads a zero pad row and needs no
// bounds test.
//
// GlobLN. Every stage normalises over a sample's whole (T, C), which is
// megabytes: many CTAs share a sample. A stage is therefore two launches
// on one stream: a statistics pass, where each CTA writes its tile's
// (count, mean, M2), and a pass that merges the sample's tiles in one fixed
// order (Chan's pairwise update) and applies the affine. No atomics, so
// the result is deterministic. The stage's raw values are recomputed in
// the second pass rather than stored: five taps re-read from L1/L2 cost
// fewer bytes than an fp32 store and load of the raw conv.
//
// Conv-family CTAs: kCh threads, one channel each (neighbouring threads on
// neighbouring addresses along C), kRows output rows each.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace uconv {

constexpr int kPad = 8;
constexpr int kCh = 128;
constexpr int kRows = 32;
constexpr int kMaxDepth = 8;
// Longest input: the resize and pool index products (t * T_other, at most
// T0 * T0 / 2) stay in 32 bits, whose division is far cheaper than 64.
constexpr int kMaxT = 65535;
constexpr int kMaxJobs = 3 * kMaxDepth;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int padded_rows(int T) {
  return cdiv(T, kPad) * kPad + 2 * kPad;
}

// The stride-2 'same' k5 chain: T_{s+1} = ceil(T_s / 2).
inline void scale_lengths(int T0, int depth, int* Ts) {
  Ts[0] = T0;
  for (int s = 1; s < depth; ++s) Ts[s] = (Ts[s - 1] + 1) / 2;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The hardware exp2-based exponential and an approximate divide: a few
// instructions per element against some thirty for expf and an IEEE
// divide, at a relative error near 1e-6.
__device__ __forceinline__ float sigmoid(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

// Sum over a CTA of NT threads in a fixed order; every thread gets it.
template <int NT>
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < NT / 32; ++i) t += red[i];
  return t;
}

// Chan's pairwise merge of (count, mean, M2) b into a.
__device__ __forceinline__ void merge(float& na, float& ma, float& m2a,
                                      float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  if (na == 0.f) {
    na = nb;
    ma = mb;
    m2a = m2b;
    return;
  }
  const float n = na + nb;
  const float d = mb - ma;
  ma += d * (nb / n);
  m2a += m2b + d * d * (na / n) * nb;
  na = n;
}

// A tile's (count, mean, M2) from its threads' values (count n over the
// CTA), written by thread 0 to p.
template <int NT, int NV>
__device__ void tile_stats(const float (&vals)[NV], const bool (&valid)[NV],
                           float n, float* red, float* p) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) s += valid[i] ? vals[i] : 0.f;
  const float mean = block_sum<NT>(s, red) / n;
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float d = vals[i] - mean;
    m2 += valid[i] ? d * d : 0.f;
  }
  m2 = block_sum<NT>(m2, red);
  if (threadIdx.x == 0) {
    p[0] = n;
    p[1] = mean;
    p[2] = m2;
  }
}

// Merge a sample's n tile partials (n, 3) in a fixed order: thread i takes
// tiles i, i + NT, ...; then a tree. s: 3 * NT floats of shared memory.
// Every thread gets the mean and 1/sqrt(var + eps).
template <int NT>
__device__ void merge_partials(const float* __restrict__ p, int n, float eps,
                               float* s, float& mean, float& rstd) {
  float cn = 0.f, cm = 0.f, cq = 0.f;
  for (int i = threadIdx.x; i < n; i += NT)
    merge(cn, cm, cq, p[3 * i], p[3 * i + 1], p[3 * i + 2]);
  __syncthreads();  // s may still be read by a previous call
  s[threadIdx.x] = cn;
  s[NT + threadIdx.x] = cm;
  s[2 * NT + threadIdx.x] = cq;
  __syncthreads();
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      float na = s[threadIdx.x], ma = s[NT + threadIdx.x],
            qa = s[2 * NT + threadIdx.x];
      merge(na, ma, qa, s[threadIdx.x + h], s[NT + threadIdx.x + h],
            s[2 * NT + threadIdx.x + h]);
      s[threadIdx.x] = na;
      s[NT + threadIdx.x] = ma;
      s[2 * NT + threadIdx.x] = qa;
    }
    __syncthreads();
  }
  mean = s[NT];
  rstd = rsqrtf(s[2 * NT] / s[0] + eps);
}

// ---------------------------------------------------------------------------
// Depthwise conv statistics: one launch runs up to kMaxJobs independent
// (input, taps, length) jobs, each over all B samples.
// ---------------------------------------------------------------------------

struct ConvJob {
  const void* x;         // first true input row; element (b, r, c) at
  long long sb, st, sc;  // x + b*sb + r*st + c*sc, r may reach -(K-1)/2
  const float* w;        // (C, K) taps
  const float* bias;     // (C,) or null
  float* partials;       // (B, tiles, 3)
  int T_out, K, stride;  // all jobs of one launch share K
};

struct ConvJobs {
  ConvJob j[kMaxJobs];
  int n;
};

__host__ __device__ inline int conv_tiles(int T_out, int C) {
  return cdiv(T_out, kRows) * cdiv(C, kCh);
}

// A K-tap conv at output row t of channel c. Callers clamp t and c into
// range and mask the value afterwards, so no load sits behind a branch and
// a thread's loads for all its rows can be in flight together (a thread
// walking its rows one dependent load at a time is latency-bound).
template <int K, typename T>
__device__ __forceinline__ float conv_at(const T* __restrict__ xs,
                                         const ConvJob& j,
                                         const float (&w)[K], int t, int c) {
  const T* p = xs + (long long)(t * j.stride - (K - 1) / 2) * j.st +
               (long long)c * j.sc;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) acc = fmaf(ld(p + k * j.st), w[k], acc);
  return acc;
}

template <int K>
__device__ __forceinline__ void load_taps(const float* __restrict__ w, int c,
                                          float (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = w[c * K + k];
}

// grid (row tiles of the longest job, channel tiles, B * jobs.n)
template <typename T, int K>
__global__ void __launch_bounds__(kCh)
conv_stats_kernel(const __grid_constant__ ConvJobs jobs, int C) {
  __shared__ float red[kCh / 32];
  const ConvJob& j = jobs.j[blockIdx.z % jobs.n];
  const int b = blockIdx.z / jobs.n;
  const int n_t = cdiv(j.T_out, kRows);
  if (static_cast<int>(blockIdx.x) >= n_t) return;  // uniform in the CTA
  const int t0 = blockIdx.x * kRows;
  const int c = blockIdx.y * kCh + threadIdx.x;
  const bool cv = c < C;
  const int cc = cv ? c : C - 1;
  float w[K];
  load_taps<K>(j.w, cc, w);
  const float bias = j.bias != nullptr ? j.bias[cc] : 0.f;
  const T* xs = static_cast<const T*>(j.x) + b * j.sb;
  float vals[kRows];
  bool valid[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    valid[r] = cv && t0 + r < j.T_out;
    vals[r] = conv_at<K>(xs, j, w, min(t0 + r, j.T_out - 1), cc) + bias;
  }
  const float n = static_cast<float>(min(kRows, j.T_out - t0) *
                                     min(kCh, C - static_cast<int>(
                                                      blockIdx.y) * kCh));
  float* p = j.partials +
             3 * ((long long)b * n_t * gridDim.y + blockIdx.x * gridDim.y +
                  blockIdx.y);
  tile_stats<kCh>(vals, valid, n, red, p);
}

// K is 1 or 5 and the same for every job.
inline cudaError_t launch_conv_stats(const ConvJobs& jobs, int B, int C,
                                     bool bf16, cudaStream_t s) {
  int max_t = 1;
  for (int i = 0; i < jobs.n; ++i) {
    if (jobs.j[i].K != jobs.j[0].K) return cudaErrorInvalidValue;
    const int n_t = cdiv(jobs.j[i].T_out, kRows);
    max_t = n_t > max_t ? n_t : max_t;
  }
  const dim3 grid(max_t, cdiv(C, kCh), B * jobs.n);
  const int K = jobs.j[0].K;
  if (K == 5 && bf16)
    conv_stats_kernel<__nv_bfloat16, 5><<<grid, kCh, 0, s>>>(jobs, C);
  else if (K == 5)
    conv_stats_kernel<float, 5><<<grid, kCh, 0, s>>>(jobs, C);
  else if (K == 1 && bf16)
    conv_stats_kernel<__nv_bfloat16, 1><<<grid, kCh, 0, s>>>(jobs, C);
  else if (K == 1)
    conv_stats_kernel<float, 1><<<grid, kCh, 0, s>>>(jobs, C);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 1x1 convolution as a batched product C[b, m, n] = sum_k A[b, m, k] W[n, k]
// (W is the conv weight (N, K, 1)). fp32: 64 x 64 output tiles, 16-deep k
// slices staged in shared memory, fp32 accumulation, 4 x 4 outputs per
// thread at rows ty + 16 i and columns tx + 16 j (conflict-free reads,
// coalesced writes).
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

struct Gemm {
  const void* a;          // element (b, m, k) at a + b*ab + m*am + k*ak
  long long ab, am, ak;
  const float* w;         // (N, K) row-major
  const float* bias;      // (N,)
  int M, N, K;
  float* y;               // proj: raw fp32 (B, M, N)
  float* partials;        // proj: (B, tiles, 3) of the raw values
  const void* resid;      // res: (B, M, N), storage type
  void* out;              // res: (B, M, N), storage type
  int lo, hi;             // res: rows [lo, hi) hold data, the rest is zero
};

// kProj: bias, raw fp32 store and tile statistics; else bias + residual
// into the storage type, rows outside [lo, hi) zero.
template <bool kProj>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const __grid_constant__ Gemm g) {
  using T = float;
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Ws[kBK][kBN + 4];
  __shared__ float red[kGemmThreads / 32];
  const int b = blockIdx.z, m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* A = static_cast<const T*>(g.a) + b * g.ab;
  const bool m_contig = g.am == 1;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kGemmThreads) {
      const int m = m_contig ? e % kBM : e / kBK;
      const int k = m_contig ? e / kBM : e % kBK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < g.M && gk < g.K)
                     ? ld(A + (long long)gm * g.am + (long long)gk * g.ak)
                     : 0.f;
    }
    for (int e = tid; e < kBN * kBK; e += kGemmThreads) {
      const int n = e / kBK, k = e % kBK;
      const int gn = n0 + n, gk = k0 + k;
      Ws[k][n] = (gn < g.N && gk < g.K) ? g.w[(long long)gn * g.K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  float vals[16];
  bool valid[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      const bool ok = m < g.M && n < g.N;
      const long long off = ((long long)b * g.M + m) * g.N + n;
      float v = ok ? acc[i][j] + g.bias[n] : 0.f;
      if (kProj) {
        if (ok) g.y[off] = v;
      } else if (ok) {
        v = (m >= g.lo && m < g.hi)
                ? v + ld(static_cast<const T*>(g.resid) + off)
                : 0.f;
        store(static_cast<T*>(g.out) + off, v);
      }
      vals[4 * i + j] = v;
      valid[4 * i + j] = ok;
    }
  if (kProj) {
    const float n = static_cast<float>(min(kBM, g.M - m0) * min(kBN, g.N - n0));
    float* p = g.partials + 3 * ((long long)b * gridDim.x * gridDim.y +
                                 blockIdx.x * gridDim.y + blockIdx.y);
    tile_stats<kGemmThreads>(vals, valid, n, red, p);
  }
}

__host__ inline int gemm_tiles(int M, int N) {
  return cdiv(M, kBM) * cdiv(N, kBN);
}

// The bf16 product on the tensor cores (warp-level wmma, 16 x 16 x 16 bf16
// fragments, fp32 accumulation): 64 x 64 output tiles, 32-deep k slices in
// shared memory, four warps of 32 x 32 each. The fp32 weights are rounded
// to bf16 as they are staged, as the module's bf16 path casts them. The
// accumulators go through shared memory to the same epilogues.
constexpr int kWK = 32, kWThreads = 128;

template <bool kProj>
__global__ void __launch_bounds__(kWThreads)
gemm_bf16_kernel(const __grid_constant__ Gemm g) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[kBM][kWK + 8];
  __shared__ __align__(32) __nv_bfloat16 Ws[kBN][kWK + 8];
  __shared__ __align__(32) float Cs[kBM][kBN + 4];
  __shared__ float red[kWThreads / 32];
  const int b = blockIdx.z, m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, wm = tid / 64, wn = (tid / 32) % 2;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(g.a) + b * g.ab;
  const bool m_contig = g.am == 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k0 = 0; k0 < g.K; k0 += kWK) {
    for (int e = tid; e < kBM * kWK; e += kWThreads) {
      const int m = m_contig ? e % kBM : e / kWK;
      const int k = m_contig ? e / kBM : e % kWK;
      const int gm = m0 + m, gk = k0 + k;
      As[m][k] = (gm < g.M && gk < g.K)
                     ? A[(long long)gm * g.am + (long long)gk * g.ak]
                     : __float2bfloat16(0.f);
    }
    for (int e = tid; e < kBN * kWK; e += kWThreads) {
      const int n = e / kWK, k = e % kWK;
      const int gn = n0 + n, gk = k0 + k;
      Ws[n][k] = __float2bfloat16(
          (gn < g.N && gk < g.K) ? g.w[(long long)gn * g.K + gk] : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[wm * 32 + i * 16][kk], kWK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Ws[wn * 32 + j * 16][kk], kWK + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16],
                              acc[i][j], kBN + 4, wmma::mem_row_major);
  __syncthreads();

  constexpr int kPer = kBM * kBN / kWThreads;  // 32 rows of one column
  float vals[kPer];
  bool valid[kPer];
  const int nl = tid % kBN, n = n0 + nl;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int ml = tid / kBN + r * (kWThreads / kBN), m = m0 + ml;
    const bool ok = m < g.M && n < g.N;
    const long long off = ((long long)b * g.M + m) * g.N + n;
    float v = ok ? Cs[ml][nl] + g.bias[n] : 0.f;
    if (kProj) {
      if (ok) g.y[off] = v;
    } else if (ok) {
      v = (m >= g.lo && m < g.hi)
              ? v + ld(static_cast<const __nv_bfloat16*>(g.resid) + off)
              : 0.f;
      store(static_cast<__nv_bfloat16*>(g.out) + off, v);
    }
    vals[r] = v;
    valid[r] = ok;
  }
  if (kProj) {
    const float cnt =
        static_cast<float>(min(kBM, g.M - m0) * min(kBN, g.N - n0));
    float* p = g.partials + 3 * ((long long)b * gridDim.x * gridDim.y +
                                 blockIdx.x * gridDim.y + blockIdx.y);
    tile_stats<kWThreads>(vals, valid, cnt, red, p);
  }
}

// fp32 on the SIMT cores (TF32 would change the numbers), bf16 on the
// tensor cores; the same tiles, so the same partial-statistics layout.
template <bool kProj>
inline cudaError_t launch_gemm(const Gemm& g, int B, bool bf16,
                               cudaStream_t s) {
  const dim3 grid(cdiv(g.M, kBM), cdiv(g.N, kBN), B);
  if (bf16)
    gemm_bf16_kernel<kProj><<<grid, kWThreads, 0, s>>>(g);
  else
    gemm_kernel<kProj><<<grid, kGemmThreads, 0, s>>>(g);
  return cudaGetLastError();
}

}  // namespace uconv
