// Depthwise K-tap "same" conv (stride 1 or 2, optional bias) followed by a
// GlobLN over each sample's whole (T_out, C), for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package:
//   tdanet_tpu/kernels/fused_pyramid.py          dw_conv_glob_ln
//   tdanet_tpu/kernels/fused_pyramid_chunked.py  dw_conv_glob_ln_chunked
// Both compute this function; the TPU versions hold a sample's (T, C)
// scale in VMEM (whole, or streamed in 512-row chunks by one core).
//
// What bounds it on the H100: bytes, and at most sites the launch. Per
// output element it does K multiply-adds and about six more operations
// for the statistics and the affine, far below the card's ~20 fp32 flops
// per byte of HBM bandwidth; the least it can move is one read of x and
// one write of out. A served forward runs it at 512 sites, most of them
// at most 1005 rows (0.5-2 MB), where one launch and the pass boundary
// cost more than the bytes.
//
// What the design does about it: one cooperative launch per site, and
// no scratch beyond the statistics.
//   The grid is at most the CTAs the card holds at once (the occupancy
//   figure times the SMs) and at most the tiles. The (sample, channel
//   tile, time tile) tiles of 128 rows x 32 channels are numbered sample
//   by sample, and CTA j owns the contiguous run [j N / G, (j+1) N / G).
//   Phase 1: a CTA of 512 threads stages each tile's input rows plus the
//     K-1 halo in shared memory (clamped and masked at the edges),
//     computes the conv in fp32 and the tile's (count, mean, M2) in one
//     reduction in fp64, about the tile's first value, and folds the tiles
//     of a sample, in tile order, into one part per (sample, CTA): four
//     doubles in a (B, G, 4) buffer. No conv output is stored: the first and the
//     last tile's values stay in registers.
//   One grid barrier (cooperative_groups::this_grid().sync()).
//   Phase 2: per sample, a CTA merges the parts of the CTAs that own the
//     sample's tiles, in CTA order (one a thread, a shuffle tree in each
//     warp, then one over the warps), with Chan's update; then it
//     normalises the kept tiles and recomputes the conv of the others
//     from x (still in the L2 at the served sizes), applies the affine
//     and stores out in x's type.
// The merge order is fixed by tile and CTA index, never by arrival, and
// the barrier's own counter is the only atomic: for one card and shape
// the output is the same bit for bit from run to run. Where a gradient
// is wanted, the CTA that owns a sample's first tile also writes the
// sample's (hi, lo, rstd), which the backward kernel
// (dw_conv_glob_ln_backward.cu) reads. The statistics are fp64 from the
// tile's sums on (the conv values and the output stay fp32): an error of
// the variance scales the whole sample's output and its gradient alike,
// so unlike an element's rounding it does not average out downstream; in
// fp32 the tiles' one-pass sums left it at up to 1e-6, ten times the
// plain fp32 form's, which the model's gradients amplified. (count, mean,
// M2) rather than (sum, sum of squares), with each mean held as hi + lo
// (a value of the data and the rest): no precision goes to a large
// common offset of the activations. The tap count and the stride are template
// constants, so every tap's load is issued before the arithmetic; a
// stride-2 tile is staged in two phases (even rows, then odd) so
// neighbouring threads read neighbouring words. Rows of the model's
// (B, C, T) views are not 16-byte aligned at its lengths (2010, 1005,
// 503, ...), so loads are scalar, a warp covering 64-128 contiguous
// bytes: full sectors, and far fewer instructions than the L2 rate could
// absorb. Parameters are read in their own storage type. One CTA of 512
// threads an SM: up to 128 registers a thread, no spills (at 64, the
// staging arrays spilled).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileT = 128;
constexpr int kTileC = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = kTileT * kTileC / kThreads;  // 8
constexpr int kMinBlocks = 1;

struct Geometry {
  int B, T, C, T_out;
  int tiles_t, tiles_c, per_sample;  // tiles per sample along T_out, C
  int n_tiles;                       // B * per_sample; n_tiles * G < 2^31
  long long xb, ob;                  // sample strides of x and out
  int xt, xc, ot, oc;                // element strides within a sample
  float eps;
};

// A sample's statistics, or a part of them: count, mean = hi + lo (hi a
// value of the data, the first tile's first conv value; lo the rest),
// and M2, the sum of squared deviations from the mean; in fp64.
struct Stats {
  double n, hi, lo, m2;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Chan's pairwise merge of b into a. The difference of the means is
// (b.hi - a.hi) + (b.lo - a.lo): near a common offset the first term is
// exact, so no precision goes to the offset. a keeps its hi.
__device__ __forceinline__ void merge(Stats& a, const Stats& b) {
  if (b.n == 0.0) return;
  if (a.n == 0.0) {
    a = b;
    return;
  }
  const double n = a.n + b.n, r = 1.0 / n;
  const double d = (b.hi - a.hi) + (b.lo - a.lo);
  a.lo += d * (b.n * r);
  a.m2 += b.m2 + d * d * (a.n * r) * b.n;
  a.n = n;
}

__device__ __forceinline__ Stats shfl_down(const Stats& s, int o) {
  return {__shfl_down_sync(0xffffffffu, s.n, o),
          __shfl_down_sync(0xffffffffu, s.hi, o),
          __shfl_down_sync(0xffffffffu, s.lo, o),
          __shfl_down_sync(0xffffffffu, s.m2, o)};
}

// Merge every thread's s over the CTA in a fixed order (a shuffle-down
// tree in each warp, then one over the warps in warp 0); every thread
// gets the result. red: kWarps + 1 Stats of shared memory.
__device__ Stats block_merge(Stats s, Stats* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) merge(s, shfl_down(s, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) red[wid] = s;
  __syncthreads();
  if (wid == 0) {
    s = lane < kWarps ? red[lane] : Stats{0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) merge(s, shfl_down(s, o));
    if (lane == 0) red[kWarps] = s;
  }
  __syncthreads();
  return red[kWarps];
}

// Two sums over the CTA in a fixed order (an xor butterfly in each warp,
// the warps in order); every thread gets them. red: 2 * kWarps doubles.
__device__ __forceinline__ void block_sum2(double& u, double& v,
                                           double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    u += __shfl_xor_sync(0xffffffffu, u, o);
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = u;
    red[kWarps + (threadIdx.x >> 5)] = v;
  }
  __syncthreads();
  u = red[0];
  v = red[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    u += red[w];
    v += red[kWarps + w];
  }
}

// The CTA that owns tile i: the largest j with j N / G <= i.
__device__ __forceinline__ int owner(int i, int N, int G) {
  return ((i + 1) * G - 1) / N;
}

template <typename TX, typename TP, int K, int S, bool TC>
struct Tile {
  static constexpr int kRows = (kTileT - 1) * S + K;  // input rows a tile
  static constexpr int kHalf = (kRows + 1) / 2;
  static constexpr int kRowLen = S == 2 ? 2 * kHalf : kRows;
  static constexpr int kElems = kRows * kTileC;
  static constexpr int kIter = (kElems + kThreads - 1) / kThreads;
  // T-contiguous: [channel][row], a stride-2 row split into its even and
  // odd phases; C-contiguous: [row][channel]
  static constexpr int kSmem = TC ? kTileC * kRowLen : kRows * kTileC;

  // staged element e -> (row, channel): neighbouring threads take
  // neighbouring addresses of the contiguous axis
  __device__ static __forceinline__ int row_of(int e) {
    return TC ? e % kRows : e / kTileC;
  }
  __device__ static __forceinline__ int chan_of(int e) {
    return TC ? e / kRows : e % kTileC;
  }
  __device__ static __forceinline__ int at(int r, int cl) {
    if (TC) return cl * kRowLen + (S == 2 ? (r & 1) * kHalf + (r >> 1) : r);
    return r * kTileC + cl;
  }
  // shared-memory index of tap k of output row tl
  __device__ static __forceinline__ int tap(int tl, int k, int cl) {
    if (TC)
      return cl * kRowLen +
             (S == 2 ? (k & 1) * kHalf + tl + (k >> 1) : tl + k);
    return (tl * S + k) * kTileC + cl;
  }
  // element i of this thread -> (row, channel) within the tile
  __device__ static __forceinline__ void coords(int i, int& tl, int& cl) {
    const int e = threadIdx.x + i * kThreads;
    if (TC) {
      tl = e % kTileT;
      cl = e / kTileT;
    } else {
      cl = e % kTileC;
      tl = e / kTileC;
    }
  }

  // Stage tile (b, t0, c0): x rows into shared memory, the parameters of
  // its channels into ws and ps (bias, gamma, beta). Every load is issued
  // before the first store; rows and channels outside x are clamped for
  // the address and masked to 0.
  __device__ static void stage(const TX* __restrict__ x,
                               const TP* __restrict__ w,
                               const TP* __restrict__ bias,
                               const TP* __restrict__ gamma,
                               const TP* __restrict__ beta, const Geometry& g,
                               int b, int t0, int c0, float* tile, float* ws,
                               float* ps) {
    const TX* xs = x + b * g.xb;
    const int in0 = t0 * S - (K - 1) / 2;
    float v[kIter];
#pragma unroll
    for (int j = 0; j < kIter; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int t = in0 + row_of(e), c = c0 + chan_of(e);
      const int off = min(max(t, 0), g.T - 1) * g.xt + min(c, g.C - 1) * g.xc;
      const float val = to_f(xs[off]);
      v[j] = (e < kElems && t >= 0 && t < g.T && c < g.C) ? val : 0.f;
    }
    if (threadIdx.x < kTileC) {
      const int c = min(c0 + static_cast<int>(threadIdx.x), g.C - 1);
#pragma unroll
      for (int k = 0; k < K; ++k) ws[threadIdx.x * K + k] = to_f(w[c * K + k]);
      ps[threadIdx.x] = bias != nullptr ? to_f(bias[c]) : 0.f;
      ps[kTileC + threadIdx.x] = to_f(gamma[c]);
      ps[2 * kTileC + threadIdx.x] = to_f(beta[c]);
    }
#pragma unroll
    for (int j = 0; j < kIter; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < kElems) tile[at(row_of(e), chan_of(e))] = v[j];
    }
  }

  // The conv of this thread's kPerThread elements, bias added.
  __device__ static __forceinline__ void conv(const float* tile,
                                              const float* ws,
                                              const float* ps,
                                              float (&acc)[kPerThread]) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      int tl, cl;
      coords(i, tl, cl);
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) a += tile[tap(tl, k, cl)] * ws[cl * K + k];
      acc[i] = a + ps[cl];
    }
  }

  // The tile's statistics, about its first value y0 (the conv at its
  // first row and channel, which every thread computes alike from shared
  // memory): one reduction of the sum and the squares of y - y0, in
  // fp64. The mean is held as y0 + lo, so no precision goes to a common
  // offset.
  __device__ static __forceinline__ Stats stats(const float (&acc)[kPerThread],
                                                const float* tile,
                                                const float* ws,
                                                const float* ps, int nt,
                                                int nc, double* red) {
    float y0 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) y0 += tile[tap(0, k, 0)] * ws[k];
    y0 += ps[0];
    double s1 = 0.0, s2 = 0.0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      int tl, cl;
      coords(i, tl, cl);
      const double d = static_cast<double>(acc[i]) - y0;
      if (tl < nt && cl < nc) {
        s1 += d;
        s2 += d * d;
      }
    }
    block_sum2(s1, s2, red);
    const double n = static_cast<double>(nt * nc), lo = s1 / n;
    return {n, y0, lo, s2 - s1 * lo};
  }
};

template <typename TX, typename TP, int K, int S, bool TC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dw_conv_glob_ln_kernel(const TX* __restrict__ x, TX* __restrict__ out,
                       const TP* __restrict__ w, const TP* __restrict__ bias,
                       const TP* __restrict__ gamma,
                       const TP* __restrict__ beta, double2* partials,
                       float* stats, Geometry g) {
  using Tl = Tile<TX, TP, K, S, TC>;
  __shared__ float tile[Tl::kSmem];
  __shared__ float ws[kTileC * K];
  // bias, gamma, beta of the first tile, then of the one being staged
  __shared__ float ps[2 * 3 * kTileC];
  __shared__ double red[2 * kWarps];
  __shared__ Stats red_stats[kWarps + 1];

  const int G = gridDim.x, j = blockIdx.x, N = g.n_tiles;
  const int lo = j * N / G, hi = (j + 1) * N / G;  // hi > lo: G <= N
  auto box = [&](int i, int& b, int& t0, int& c0) {
    const int r = i % g.per_sample;
    b = i / g.per_sample;
    t0 = (r % g.tiles_t) * kTileT;
    c0 = (r / g.tiles_t) * kTileC;
  };
  auto stage = [&](int i, float* slot) {
    int b, t0, c0;
    box(i, b, t0, c0);
    __syncthreads();  // the previous tile's reads of shared memory are done
    Tl::stage(x, w, bias, gamma, beta, g, b, t0, c0, tile, ws, slot);
    __syncthreads();
  };
  auto put = [&](int b, const Stats& s) {  // this CTA's part of sample b
    if (threadIdx.x == 0) {
      partials[2 * (b * G + j)] = make_double2(s.n, s.hi);
      partials[2 * (b * G + j) + 1] = make_double2(s.lo, s.m2);
    }
  };

  // phase 1: statistics, folded per (sample, CTA) in tile order; the
  // conv values of the first and the last tile stay in registers
  float acc[kPerThread], first[kPerThread];
  int cur = lo / g.per_sample;
  Stats part{0.0, 0.0, 0.0, 0.0};
  for (int i = lo; i < hi; ++i) {
    int b, t0, c0;
    box(i, b, t0, c0);
    if (b != cur) {
      put(cur, part);
      cur = b;
      part = Stats{0.0, 0.0, 0.0, 0.0};
    }
    float* slot = i == lo ? ps : ps + 3 * kTileC;
    stage(i, slot);
    Tl::conv(tile, ws, slot, acc);
    merge(part, Tl::stats(acc, tile, ws, slot, min(kTileT, g.T_out - t0),
                          min(kTileC, g.C - c0), red));
    if (i == lo) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) first[k] = acc[k];
    }
  }
  put(cur, part);

  cg::this_grid().sync();

  // phase 2: per sample, merge the parts of its CTAs in CTA order, then
  // normalise as ((y - hi) - lo) * rstd, hi, lo and rstd rounded to fp32
  int stat_b = -1;
  float hi_f = 0.f, lo_f = 0.f, rstd = 0.f;
  auto normalise = [&](const float (&vals)[kPerThread], int i,
                       const float* slot) {
    int b, t0, c0;
    box(i, b, t0, c0);
    if (b != stat_b) {
      const int first_tile = b * g.per_sample;
      const int j0 = owner(first_tile, N, G);
      const int j1 = owner(first_tile + g.per_sample - 1, N, G);
      Stats s{0.0, 0.0, 0.0, 0.0};
      for (int jj = j0 + threadIdx.x; jj <= j1; jj += kThreads) {
        const double2 p = __ldcg(partials + 2 * (b * G + jj));
        const double2 q = __ldcg(partials + 2 * (b * G + jj) + 1);
        merge(s, Stats{p.x, p.y, q.x, q.y});
      }
      const Stats st = block_merge(s, red_stats);
      hi_f = static_cast<float>(st.hi);
      lo_f = static_cast<float>(st.lo);
      rstd = static_cast<float>(1.0 / sqrt(st.m2 / st.n + g.eps));
      stat_b = b;
    }
    if (stats != nullptr && threadIdx.x == 0 && i == b * g.per_sample) {
      stats[3 * b] = hi_f;
      stats[3 * b + 1] = lo_f;
      stats[3 * b + 2] = rstd;
    }
    TX* ob = out + b * g.ob;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      int tl, cl;
      Tl::coords(k, tl, cl);
      const int t = t0 + tl, c = c0 + cl;
      if (t < g.T_out && c < g.C)
        store(ob + t * g.ot + c * g.oc,
              ((vals[k] - hi_f) - lo_f) * rstd * slot[kTileC + cl] +
                  slot[2 * kTileC + cl]);
    }
  };

  // the kept tiles first (their parameters are still staged), then the
  // others, recomputed from x
  normalise(acc, hi - 1, hi - 1 == lo ? ps : ps + 3 * kTileC);
  if (hi - lo > 1) normalise(first, lo, ps);
  for (int i = lo + 1; i < hi - 1; ++i) {
    stage(i, ps + 3 * kTileC);
    Tl::conv(tile, ws, ps + 3 * kTileC, acc);
    normalise(acc, i, ps + 3 * kTileC);
  }
}

template <typename TX, typename TP, int S, bool TC>
const void* pick_k(int K) {
  switch (K) {
    case 1: return reinterpret_cast<const void*>(
        dw_conv_glob_ln_kernel<TX, TP, 1, S, TC>);
    case 3: return reinterpret_cast<const void*>(
        dw_conv_glob_ln_kernel<TX, TP, 3, S, TC>);
    case 5: return reinterpret_cast<const void*>(
        dw_conv_glob_ln_kernel<TX, TP, 5, S, TC>);
    case 7: return reinterpret_cast<const void*>(
        dw_conv_glob_ln_kernel<TX, TP, 7, S, TC>);
  }
  return nullptr;
}

template <typename TX, typename TP>
const void* pick_s(int K, int stride, int t_contig) {
  if (stride == 1)
    return t_contig ? pick_k<TX, TP, 1, true>(K) : pick_k<TX, TP, 1, false>(K);
  if (stride == 2)
    return t_contig ? pick_k<TX, TP, 2, true>(K) : pick_k<TX, TP, 2, false>(K);
  return nullptr;
}

// The kernel for x's storage (fp32 or bf16), the parameters' storage,
// K in {1, 3, 5, 7}, stride in {1, 2} and the contiguous axis; null for
// anything else.
const void* pick(int x_bf16, int p_bf16, int K, int stride, int t_contig) {
  using bf = __nv_bfloat16;
  if (x_bf16)
    return p_bf16 ? pick_s<bf, bf>(K, stride, t_contig)
                  : pick_s<bf, float>(K, stride, t_contig);
  return p_bf16 ? pick_s<float, bf>(K, stride, t_contig)
                : pick_s<float, float>(K, stride, t_contig);
}

}  // namespace

extern "C" {

// The CTAs of the chosen kernel the current card holds at once: the
// occupancy figure (CTAs an SM) times the SMs; the largest cooperative
// grid. A negative value is a cudaError_t, negated.
int dw_conv_glob_ln_capacity(int x_bf16, int p_bf16, int K, int stride,
                             int t_contig) {
  const void* fn = pick(x_bf16, p_bf16, K, stride, t_contig);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                        kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks * sms;
}

// x, out: storage in fp32 (x_bf16 == 0) or bf16, element strides (B, T,
// C); w (C, K), bias (C,) or null, gamma, beta (C,): contiguous, fp32
// (p_bf16 == 0) or bf16; partials: fp64 (B, grid, 4), 16-byte aligned;
// stats: null, or fp32 (B, 3) that receives each sample's (hi, lo, rstd),
// mean = hi + lo. grid: the CTAs, at most the capacity and the tiles. One
// cooperative launch on ``stream``.
// Returns a cudaError_t, 0 on success.
int dw_conv_glob_ln_launch(const void* x, void* out, const void* w,
                           const void* bias, const void* gamma,
                           const void* beta, void* partials, float* stats,
                           int B, int T,
                           int C, int T_out, int K, int stride, long long xb,
                           long long xt, long long xc, long long ob,
                           long long ot, long long oc, int t_contig,
                           int x_bf16, int p_bf16, int grid, float eps,
                           void* stream) {
  const void* fn = pick(x_bf16, p_bf16, K, stride, t_contig);
  if (fn == nullptr || B < 1 || T < 1 || C < 1 || T_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_t = (T_out + kTileT - 1) / kTileT;
  const long long tiles_c = (C + kTileC - 1) / kTileC;
  const long long n_tiles = B * tiles_t * tiles_c;
  // offsets within a sample, and tile indices times the grid, in 32 bits
  const long long span = (T - 1) * xt + (C - 1) * xc + (T_out - 1) * ot +
                         (C - 1) * oc;
  if (grid < 1 || grid > n_tiles || (n_tiles + 1) * grid >= (1LL << 31) ||
      span >= (1LL << 31) || xt < 0 || xc < 0 || ot < 0 || oc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{B, T, C, T_out,
             static_cast<int>(tiles_t), static_cast<int>(tiles_c),
             static_cast<int>(tiles_t * tiles_c), static_cast<int>(n_tiles),
             xb, ob, static_cast<int>(xt), static_cast<int>(xc),
             static_cast<int>(ot), static_cast<int>(oc), eps};
  void* args[] = {const_cast<void**>(&x), &out, const_cast<void**>(&w),
                  const_cast<void**>(&bias), const_cast<void**>(&gamma),
                  const_cast<void**>(&beta), &partials, &stats, &g};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
