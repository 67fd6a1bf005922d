// Depthwise K-tap "same" conv (stride 1 or 2, optional bias) followed by a
// GlobLN over each sample's whole (T_out, C), for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package:
//   tdanet_tpu/kernels/fused_pyramid.py          dw_conv_glob_ln
//   tdanet_tpu/kernels/fused_pyramid_chunked.py  dw_conv_glob_ln_chunked
// Both compute this function; the TPU versions hold a sample's (T, C)
// scale in VMEM (whole, or streamed in 512-row chunks by one core).
//
// What bounds it on the H100: bytes. Per output element it does K
// multiply-adds and about ten more flops for the statistics and the
// affine, against 16 bytes moved in fp32 (read x, write raw y, read raw y,
// write out), about 2 operations per byte, far below the card's ~20
// fp32 flops per byte of HBM bandwidth. A sample's finest scale,
// (2010, 512) fp32, is 4.1 MB, 18 times what one SM's shared memory holds,
// so one CTA cannot own a sample as one TPU core did.
//
// What the design does about it: two passes over a grid of
// (time tile, channel tile, sample) CTAs, with no atomics, so the result
// is deterministic.
//   Pass A: a CTA stages its input rows plus the K-1 halo in shared memory
//     (zero outside [0, T)), computes the strided conv in fp32, adds the
//     bias, writes raw y to an fp32 scratch, and writes its tile's
//     statistics (count, mean, M2) to a per-sample partials buffer.
//   Pass B: every CTA merges its sample's partials in one fixed order
//     (Chan's pairwise update), then normalises its tile of raw y and
//     applies the per-channel affine.
// (count, mean, M2) instead of (sum, sumsq): a tile's M2 is taken about
// its own mean and the merge never subtracts two large squares, so the
// variance stays exact when the activations share a large offset; it
// costs nothing in bytes. Raw y is stored rather than recomputed in pass
// B, which keeps pass B a pure elementwise pass over what pass A's
// statistics saw. Each CTA reads and writes along whichever of T or C is
// the innermost contiguous axis, so the model's (B, C, T) tensors pass as
// a transposed view without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileT = 64;
constexpr int kTileC = 32;
constexpr int kThreads = 256;
constexpr int kPerThread = kTileT * kTileC / kThreads;  // 8
constexpr int kMaxK = 7;
constexpr int kMaxStride = 2;
// rows of input a tile needs at most; odd, so walking channels in shared
// memory touches 32 distinct banks
constexpr int kRows = (kTileT - 1) * kMaxStride + kMaxK;  // 133

struct Geometry {
  int B, T, C, T_out, K, stride, pad;
  int n_tiles_c;
  long long xb, xt, xc;  // element strides of x
  long long ob, ot, oc;  // element strides of out and of raw y
  int t_contig;          // 1: T is the innermost axis, 0: C is
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Element e of a tile -> (time, channel) within it. Neighbouring threads
// take neighbouring addresses along the contiguous axis.
__device__ __forceinline__ void tile_coords(int e, int t_contig, int& tl,
                                            int& cl) {
  if (t_contig) {
    tl = e % kTileT;
    cl = e / kTileT;
  } else {
    cl = e % kTileC;
    tl = e / kTileC;
  }
}

// Sum over the CTA in a fixed order; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) t += red[i];
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_stats_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y,
                  float* __restrict__ partials, Geometry g) {
  __shared__ float tile[kTileC][kRows];
  __shared__ float red[kThreads / 32];
  const int tt = blockIdx.x, ct = blockIdx.y, b = blockIdx.z;
  const int t0 = tt * kTileT, c0 = ct * kTileC;
  const int rows = (kTileT - 1) * g.stride + g.K;
  const int in0 = t0 * g.stride - g.pad;
  const T* xs = x + b * g.xb;

  for (int i = threadIdx.x; i < rows * kTileC; i += kThreads) {
    int r, cl;
    if (g.t_contig) {
      r = i % rows;
      cl = i / rows;
    } else {
      cl = i % kTileC;
      r = i / kTileC;
    }
    const int ti = in0 + r, c = c0 + cl;
    float v = 0.f;
    if (ti >= 0 && ti < g.T && c < g.C) v = load(xs + ti * g.xt + c * g.xc);
    tile[cl][r] = v;
  }
  __syncthreads();

  float vals[kPerThread];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    int tl, cl;
    tile_coords(threadIdx.x + i * kThreads, g.t_contig, tl, cl);
    const int t = t0 + tl, c = c0 + cl;
    float acc = 0.f;
    if (t < g.T_out && c < g.C) {
      const float* wc = w + c * g.K;
      const float* row = &tile[cl][tl * g.stride];
      for (int k = 0; k < g.K; ++k) acc += row[k] * wc[k];
      if (bias != nullptr) acc += bias[c];
      y[b * g.ob + t * g.ot + c * g.oc] = acc;
      s += acc;
    }
    vals[i] = acc;
  }

  const int nt = min(kTileT, g.T_out - t0), nc = min(kTileC, g.C - c0);
  const float n = static_cast<float>(nt * nc);
  const float mean = block_sum(s, red) / n;
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    int tl, cl;
    tile_coords(threadIdx.x + i * kThreads, g.t_contig, tl, cl);
    if (t0 + tl < g.T_out && c0 + cl < g.C) {
      const float d = vals[i] - mean;
      m2 += d * d;
    }
  }
  m2 = block_sum(m2, red);
  if (threadIdx.x == 0) {
    const int n_tiles = gridDim.x * gridDim.y;
    float* p = partials + 3 * (b * n_tiles + tt * g.n_tiles_c + ct);
    p[0] = n;
    p[1] = mean;
    p[2] = m2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const float* __restrict__ y,
                 const float* __restrict__ partials,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ out,
                 Geometry g, float eps) {
  __shared__ float sn[kThreads], sm[kThreads], sq[kThreads];
  const int tt = blockIdx.x, ct = blockIdx.y, b = blockIdx.z;
  const int n_tiles = gridDim.x * gridDim.y;
  const float* pb = partials + 3 * b * n_tiles;

  // fixed order: thread i merges tiles i, i + kThreads, ...; then a tree
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int i = threadIdx.x; i < n_tiles; i += kThreads)
    merge(n, mean, m2, pb[3 * i], pb[3 * i + 1], pb[3 * i + 2]);
  sn[threadIdx.x] = n;
  sm[threadIdx.x] = mean;
  sq[threadIdx.x] = m2;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      float na = sn[threadIdx.x], ma = sm[threadIdx.x], qa = sq[threadIdx.x];
      merge(na, ma, qa, sn[threadIdx.x + s], sm[threadIdx.x + s],
            sq[threadIdx.x + s]);
      sn[threadIdx.x] = na;
      sm[threadIdx.x] = ma;
      sq[threadIdx.x] = qa;
    }
    __syncthreads();
  }
  const float mu = sm[0];
  const float rstd = rsqrtf(sq[0] / sn[0] + eps);

  const int t0 = tt * kTileT, c0 = ct * kTileC;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    int tl, cl;
    tile_coords(threadIdx.x + i * kThreads, g.t_contig, tl, cl);
    const int t = t0 + tl, c = c0 + cl;
    if (t < g.T_out && c < g.C) {
      const long long off = b * g.ob + t * g.ot + c * g.oc;
      store(out + off, (y[off] - mu) * rstd * gamma[c] + beta[c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, float* y, float* partials,
                   const float* w, const float* bias, const float* gamma,
                   const float* beta, const Geometry& g, float eps,
                   cudaStream_t stream) {
  const dim3 grid((g.T_out + kTileT - 1) / kTileT, g.n_tiles_c, g.B);
  conv_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, bias, y, partials, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  normalize_kernel<T><<<grid, kThreads, 0, stream>>>(
      y, partials, gamma, beta, static_cast<T*>(out), g, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiles per sample: the wrapper sizes the (B, tiles, 3) partials buffer.
int dw_conv_glob_ln_tiles(int T_out, int C) {
  return ((T_out + kTileT - 1) / kTileT) * ((C + kTileC - 1) / kTileC);
}

// x, out: storage in fp32 (bf16 == 0) or bf16 (bf16 == 1), with element
// strides (B, T, C); y: fp32 scratch with out's strides; partials: fp32
// (B, tiles, 3); w: fp32 (C, K); bias: fp32 (C,) or null; gamma, beta:
// fp32 (C,). Returns a cudaError_t, 0 on success.
int dw_conv_glob_ln_launch(const void* x, void* out, float* y,
                           float* partials, const float* w,
                           const float* bias, const float* gamma,
                           const float* beta, int B, int T, int C, int T_out,
                           int K, int stride, long long xb, long long xt,
                           long long xc, long long ob, long long ot,
                           long long oc, int t_contig, int bf16, float eps,
                           void* stream) {
  if (K < 1 || K > kMaxK || K % 2 == 0 || stride < 1 ||
      stride > kMaxStride || B < 1 || B > 65535 || C < 1 || T_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{B, T, C, T_out, K, stride, (K - 1) / 2, (C + kTileC - 1) / kTileC,
             xb, xt, xc, ob, ot, oc, t_contig};
  if (g.n_tiles_c > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, out, y, partials, w, bias, gamma, beta,
                                   g, eps, s)
           : launch<float>(x, out, y, partials, w, bias, gamma, beta, g, eps,
                           s);
  return static_cast<int>(err);
}

}  // extern "C"
