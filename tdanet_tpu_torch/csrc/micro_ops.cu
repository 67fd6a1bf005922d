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
// projection product ((2032, 128) @ (128, 512)) by bytes on the tensor
// cores. The products are this file's own, with the tiling of
// uconv_common.cuh's: 64 x 64 output tiles, fp32 on the SIMT cores with
// 16-deep k slices, bf16 on the tensor cores (wmma 16 x 16 x 16, fp32
// accumulation). Rows a script's body never writes are written as zeros.

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
// its rows with the five input rows in registers.
// grid (B, chunks of CH rows, C / (2 * kTapT))
// ---------------------------------------------------------------------------

constexpr int kTapT = 128;

template <int CH, bool kBf16Acc>
__global__ void __launch_bounds__(kTapT)
taps_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
            bf16* __restrict__ o, int R, int C, int N) {
  const int ch = CH > 0 ? CH : N;
  const int c = 2 * (blockIdx.z * kTapT + threadIdx.x);
  if (c >= C) return;
  const int r0 = blockIdx.y * ch, r1 = min(r0 + ch, N);
  const bf16* xs = x + (long long)blockIdx.x * R * C + c;
  bf16* os = o + (long long)blockIdx.x * R * C + c;
  const bf162 zero = __floats2bfloat162_rn(0.f, 0.f);
  if (blockIdx.y == 0)
    for (int r = 0; r < 8; ++r)
      *reinterpret_cast<bf162*>(os + (long long)r * C) = zero;
  if (r1 == N)
    for (int r = 8 + N; r < R; ++r)
      *reinterpret_cast<bf162*>(os + (long long)r * C) = zero;
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
// grid (B, cdiv(R, 64), C / 64)
// ---------------------------------------------------------------------------

// A whole 64 x 64 tile of zero rows. NT threads.
template <int NT>
__device__ void zero_tile(bf16* o, int R, int C, int m0, int n0) {
  for (int e = threadIdx.x; e < kBM * kBN; e += NT) {
    const int m = m0 + e / kBN, n = n0 + e % kBN;
    if (m < R && n < C) o[(long long)m * C + n] = __float2bfloat16(0.f);
  }
}

// fp32 operands (x converted as it is staged) on the SIMT cores.
__global__ void __launch_bounds__(kGemmThreads)
dec_f32_kernel(const bf16* __restrict__ x, const float* __restrict__ D,
               bf16* __restrict__ o, int R, int C, int M) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Xs[kBK][kBN + 4];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.z * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bf16* xs = x + (long long)blockIdx.x * R * C;
  bf16* os = o + (long long)blockIdx.x * R * C;
  if (m0 >= M) {
    zero_tile<kGemmThreads>(os, R, C, m0, n0);
    return;
  }
  float acc[4][4] = {};
  for (int k0 = 0; k0 < R; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kGemmThreads) {
      const int m = e / kBK, k = e % kBK;
      As[k][m] = (m0 + m < M && k0 + k < R)
                     ? D[(long long)(m0 + m) * R + k0 + k] : 0.f;
    }
    for (int e = tid; e < kBN * kBK; e += kGemmThreads) {
      const int k = e / kBN, n = e % kBN;
      Xs[k][n] = (k0 + k < R && n0 + n < C)
                     ? ld(xs + (long long)(k0 + k) * C + n0 + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Xs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < R && n < C)
        store(os + (long long)m * C + n, m < M ? acc[i][j] : 0.f);
    }
}

// The accumulators of four warps (32 x 32 each) into a 64 x 64 fp32 tile.
using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                       float>;

__device__ __forceinline__ void store_acc(float (*Cs)[kBN + 4],
                                          AccFrag (&acc)[2][2], int wm,
                                          int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(
          &Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j], kBN + 4,
          nvcuda::wmma::mem_row_major);
}

// Rows [m0, m0 + 64) of the tile to bf16; rows at or beyond m_end are zero.
__device__ __forceinline__ void write_tile(const float (*Cs)[kBN + 4],
                                           bf16* os, int R, int C, int m0,
                                           int n0, int m_end) {
  for (int e = threadIdx.x; e < kBM * kBN; e += kWThreads) {
    const int ml = e / kBN, nl = e % kBN, m = m0 + ml, n = n0 + nl;
    if (m < R && n < C)
      store(os + (long long)m * C + n, m < m_end ? Cs[ml][nl] : 0.f);
  }
}

// bf16 operands on the tensor cores, fp32 accumulation.
__global__ void __launch_bounds__(kWThreads)
dec_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ D,
                bf16* __restrict__ o, int R, int C, int M) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[kBM][kWK + 8];
  __shared__ __align__(32) bf16 Xs[kWK][kBN + 8];
  __shared__ __align__(32) float Cs[kBM][kBN + 4];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.z * kBN;
  const int tid = threadIdx.x, wm = tid / 64, wn = (tid / 32) % 2;
  const bf16* xs = x + (long long)blockIdx.x * R * C;
  bf16* os = o + (long long)blockIdx.x * R * C;
  if (m0 >= M) {
    zero_tile<kWThreads>(os, R, C, m0, n0);
    return;
  }
  AccFrag acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const bf16 zero = __float2bfloat16(0.f);
  for (int k0 = 0; k0 < R; k0 += kWK) {
    for (int e = tid; e < kBM * kWK; e += kWThreads) {
      const int m = e / kWK, k = e % kWK;
      As[m][k] = (m0 + m < M && k0 + k < R)
                     ? D[(long long)(m0 + m) * R + k0 + k] : zero;
    }
    for (int e = tid; e < kWK * kBN; e += kWThreads) {
      const int k = e / kBN, n = e % kBN;
      Xs[k][n] = (k0 + k < R && n0 + n < C)
                     ? xs[(long long)(k0 + k) * C + n0 + n] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[wm * 32 + i * 16][kk], kWK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Xs[kk][wn * 32 + j * 16], kBN + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  store_acc(Cs, acc, wm, wn);
  __syncthreads();
  write_tile(Cs, os, R, C, m0, n0, M);
}

// ---------------------------------------------------------------------------
// projection product: out[b, m, n] = sum_k a[b, m, k] Wp[k, n] for
// m < rows, zero rows below; k < kProjK. A CTA takes CH rows (0 = all R) of
// one 64-column tile: the weight tile is staged once, then each 64-row
// sub-tile of a is staged, multiplied on the tensor cores and written.
// grid (B, cdiv(R, CH), C / 64)
// ---------------------------------------------------------------------------

constexpr int kProjK = 128;

template <int CH>
__global__ void __launch_bounds__(kWThreads)
proj_kernel(const bf16* __restrict__ a, long long ab, long long am,
            const bf16* __restrict__ Wp, bf16* __restrict__ o, int R, int C,
            int rows) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 Ws[kProjK][kBN + 8];
  // the staged a sub-tile and, once the products are done, the fp32 result
  constexpr int kABytes = kBM * (kProjK + 8) * sizeof(bf16);
  constexpr int kCBytes = kBM * (kBN + 4) * sizeof(float);
  __shared__ __align__(32) unsigned char
      buf[kABytes > kCBytes ? kABytes : kCBytes];
  bf16 (*As)[kProjK + 8] = reinterpret_cast<bf16 (*)[kProjK + 8]>(buf);
  float (*Cs)[kBN + 4] = reinterpret_cast<float (*)[kBN + 4]>(buf);
  const int ch = CH > 0 ? CH : R;
  const int n0 = blockIdx.z * kBN;
  const int tid = threadIdx.x, wm = tid / 64, wn = (tid / 32) % 2;
  const bf16* as = a + blockIdx.x * ab;
  bf16* os = o + (long long)blockIdx.x * R * C;
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = tid; e < kProjK * kBN; e += kWThreads) {
    const int k = e / kBN, n = e % kBN;
    Ws[k][n] = n0 + n < C ? Wp[(long long)k * C + n0 + n] : zero;
  }
  const int r_end = min((static_cast<int>(blockIdx.y) + 1) * ch, R);
  for (int m0 = blockIdx.y * ch; m0 < r_end; m0 += kBM) {
    if (m0 >= rows) {  // uniform in the CTA
      zero_tile<kWThreads>(os, min(r_end, R), C, m0, n0);
      continue;
    }
    __syncthreads();  // Cs of the previous sub-tile has been read
    for (int e = tid; e < kBM * kProjK; e += kWThreads) {
      const int m = e / kProjK, k = e % kProjK;
      As[m][k] = m0 + m < rows ? as[(long long)(m0 + m) * am + k] : zero;
    }
    __syncthreads();
    AccFrag acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
    for (int kk = 0; kk < kProjK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[wm * 32 + i * 16][kk], kProjK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Ws[kk][wn * 32 + j * 16], kBN + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // As has been read: Cs may overwrite it
    store_acc(Cs, acc, wm, wn);
    __syncthreads();
    write_tile(Cs, os, min(r_end, R), C, m0, n0, rows);
  }
}

// ---------------------------------------------------------------------------
// one-pass statistics over rows [0, rows) of each sample, divided by R * C
// whatever rows is, then (x - mean) * rstd on those rows and zeros below.
// Two launches: per-chunk (sum, sum of squares), then a fixed-order sum of
// the chunks in every CTA and the normalise. ROWS rows per CTA.
// grid (B, chunks)
// ---------------------------------------------------------------------------

template <int ROWS>
__global__ void __launch_bounds__(kT)
stats_sum_kernel(const bf16* __restrict__ x, float* __restrict__ partials,
                 int R, int C, int rows) {
  __shared__ float red[kT / 32];
  const int r0 = blockIdx.y * ROWS, r1 = min(r0 + ROWS, rows);
  const bf16* xs = x + (long long)blockIdx.x * R * C;
  float s = 0.f, ss = 0.f;
  for (int r = r0; r < r1; ++r)
    for (int c = 2 * threadIdx.x; c < C; c += 2 * kT) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const bf162*>(xs + (long long)r * C + c));
      s += v.x + v.y;
      ss = fmaf(v.x, v.x, fmaf(v.y, v.y, ss));
    }
  s = block_sum<kT>(s, red);
  ss = block_sum<kT>(ss, red);
  if (threadIdx.x == 0) {
    float* p = partials + 2 * ((long long)blockIdx.x * gridDim.y + blockIdx.y);
    p[0] = s;
    p[1] = ss;
  }
}

template <int ROWS>
__global__ void __launch_bounds__(kT)
stats_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ partials,
                  bf16* __restrict__ o, int R, int C, int rows, int chunks,
                  float eps) {
  const float* p = partials + 2LL * blockIdx.x * chunks;
  float s = 0.f, ss = 0.f;
  for (int i = 0; i < chunks; ++i) {
    s += p[2 * i];
    ss += p[2 * i + 1];
  }
  const float n = static_cast<float>(R) * static_cast<float>(C);
  const float mean = s / n;
  const float rstd = rsqrtf(ss / n - mean * mean + eps);
  const int r0 = blockIdx.y * ROWS, r1 = min(r0 + ROWS, R);
  const long long base = (long long)blockIdx.x * R * C;
  for (int r = r0; r < r1; ++r)
    for (int c = 2 * threadIdx.x; c < C; c += 2 * kT) {
      const long long off = base + (long long)r * C + c;
      float2 v = make_float2(0.f, 0.f);
      if (r < rows) {
        v = __bfloat1622float2(*reinterpret_cast<const bf162*>(x + off));
        v.x = (v.x - mean) * rstd;
        v.y = (v.y - mean) * rstd;
      }
      *reinterpret_cast<bf162*>(o + off) = __floats2bfloat162_rn(v.x, v.y);
    }
}

template <int ROWS>
cudaError_t run_stats(const bf16* x, bf16* o, float* partials, int B, int R,
                      int C, int rows, float eps, cudaStream_t s) {
  const int chunks = cdiv(rows, ROWS);
  stats_sum_kernel<ROWS><<<dim3(B, chunks), kT, 0, s>>>(x, partials, R, C,
                                                        rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_norm_kernel<ROWS><<<dim3(B, cdiv(R, ROWS)), kT, 0, s>>>(
      x, partials, o, R, C, rows, chunks, eps);
  return cudaGetLastError();
}

bool bad_shape(int B, int R, int C) {
  return B < 1 || B > 65535 || R < 1 || C < 1 || C % kBN != 0 ||
         (long long)R * C >= (1LL << 31);
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
  if (chunk == 0 && bf16acc)
    taps_kernel<0, true><<<dim3(B, 1, cz), kTapT, 0, s>>>(xp, w, op, R, C, N);
  else if (chunk == 0)
    taps_kernel<0, false><<<dim3(B, 1, cz), kTapT, 0, s>>>(xp, w, op, R, C, N);
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
// cores); rows [M, R) of the output are zero.
int micro_decimate(const void* x, const void* D, void* o, int B, int R, int C,
                   int M, int bf16_operands, void* stream) {
  if (bad_shape(B, R, C) || M < 1 || M > R)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, cdiv(R, kBM), C / kBN);
  if (bf16_operands)
    dec_bf16_kernel<<<grid, kWThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(D),
        static_cast<bf16*>(o), R, C, M);
  else
    dec_f32_kernel<<<grid, kGemmThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(D),
        static_cast<bf16*>(o), R, C, M);
  return static_cast<int>(cudaGetLastError());
}

// a: bf16, element (b, m, k) at a + b*ab + m*am + k, k < 128; Wp: bf16
// (128, C). rows: output rows that hold the product, zero below. chunk:
// rows per CTA, 0 (the whole sample), 512 or 128.
int micro_proj(const void* a, long long ab, long long am, const void* Wp,
               void* o, int B, int R, int C, int rows, int chunk,
               void* stream) {
  if (bad_shape(B, R, C) || rows < 0 || rows > R)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* ap = static_cast<const bf16*>(a);
  const bf16* wp = static_cast<const bf16*>(Wp);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk == 0)
    proj_kernel<0><<<dim3(B, 1, C / kBN), kWThreads, 0, s>>>(
        ap, ab, am, wp, op, R, C, rows);
  else if (chunk == 512)
    proj_kernel<512><<<dim3(B, cdiv(R, 512), C / kBN), kWThreads, 0, s>>>(
        ap, ab, am, wp, op, R, C, rows);
  else if (chunk == 128)
    proj_kernel<128><<<dim3(B, cdiv(R, 128), C / kBN), kWThreads, 0, s>>>(
        ap, ab, am, wp, op, R, C, rows);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// fp32 floats of scratch micro_stats needs.
long long micro_stats_scratch(int B, int rows, int chunk) {
  return 2LL * B * cdiv(rows, chunk == 512 ? 512 : 16);
}

// Statistics over rows [0, rows), divided by R * C; chunk: rows per CTA, 0
// (16-row tiles over the whole sample) or 512.
int micro_stats(const void* x, void* o, float* partials, int B, int R, int C,
                int rows, int chunk, float eps, void* stream) {
  if (bad_shape(B, R, C) || rows < 1 || rows > R)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk == 0)
    return static_cast<int>(
        run_stats<16>(xp, op, partials, B, R, C, rows, eps, s));
  if (chunk == 512)
    return static_cast<int>(
        run_stats<512>(xp, op, partials, B, R, C, rows, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
