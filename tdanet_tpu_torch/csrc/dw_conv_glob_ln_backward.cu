// The backward of the fused depthwise conv + GlobLN (dw_conv_glob_ln.cu),
// for Hopper (sm_90a).
//
// The JAX package has no TPU kernel for it: its trainer differentiates
// the plain ConvNorm (ops.conv1d + ops.glob_ln). The port needs one
// because every depthwise ConvNorm of a TDANet block runs the forward
// kernel on the card (32 sites a block), so a training step runs this
// kernel at every one of them.
//
// Function. x (B, T, C) in either layout, w (C, K), bias, gamma, the
// forward's per-sample statistics (hi, lo, rstd: mean = hi + lo), and dy
// in the output's layout:
//   y  = dwconv(x) + bias, recomputed from x
//   xh = ((y - hi) - lo) * rstd
//   dgamma = sum dy * xh, dbeta = sum dy          per channel over B, T_out
//   g = dy * gamma; A = mean(g), M = mean(g * xh) per sample over T_out, C
//   dz = rstd * (g - A - xh * M)
//   dbias = sum dz, dw[c, k] = sum_t dz[t, c] * x[t S + k - P, c]
//   dx = the transposed depthwise conv of dz (stride 1 or 2, P = (K-1)/2)
//
// What bounds it on the H100: bytes. Per element it does about 2K + 12
// operations against a read of x and dy and a write of dx; the least it
// can move is those three tensors, 22 us at the recipe's finest site,
// (8, 3004, 512) bf16, over 3.35 TB/s.
//
// What the design does: one cooperative launch per site, no float
// atomics, every sum in a fixed order, so a rerun is equal bit for bit.
//   Tiles of 64 output rows x 32 channels, numbered sample by sample as
//   in the forward; CTA j of G owns the contiguous run [j N / G, (j+1)
//   N / G). A CTA of 256 threads: thread = (channel, one of 8 row groups).
//   Phase 1: stage the tile's x rows (plus the K-1 halo) and dy rows in
//     shared memory, recompute y, and sum g and g * xh over the tile
//     (a tree in shared memory); fold the tiles of a sample per CTA in
//     tile order, in double, into one part per (sample, CTA).
//   Grid barrier.
//   Phase 2: per sample, A and M from the parts of the CTAs that own its
//     tiles, in CTA order (every thread the same sum). Per tile: stage
//     x and dy for the tile's output rows plus the dz halo the transposed
//     conv needs (floor(P/S) rows before, floor((S-1+P)/S) after),
//     compute dz for all of them into shared memory, and, over the
//     tile's own rows, the per-channel partials of dw, dbias, dgamma and
//     dbeta, written per tile to a small fp32 buffer; then dx for the
//     input rows [t0 S, (t0 + 64) S) from dz, through shared memory so
//     that the store is coalesced in either layout.
//   Grid barrier.
//   Phase 3: each (channel, quantity) sums its tiles' partials over the
//     samples and time tiles, in that order, in double.
// A simple kernel first: x is read twice (once a phase) and the halo
// rows again by the neighbouring tile; its speed is for a later change.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileT = 64;
constexpr int kTileC = 32;
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kTileC;  // row groups: 8
constexpr int kMaxK = 7;
constexpr int kMaxQ = kMaxK + 3;  // per channel: K taps of dw, dbias,
                                  // dgamma, dbeta (slots kMaxK..kMaxK+2)
constexpr int kMaxOut = kTileT + 6;              // rows of dz with halo
constexpr int kMaxIn = (kTileT + 2) * 2 + kMaxK;  // x rows under them: 139
constexpr int kPad = kTileC + 1;                  // no bank conflicts

struct Geo {
  int B, T, C, T_out, K, S, P, hb, ha;
  int tiles_t, tiles_c, per_sample, n_tiles;  // n_tiles * G < 2^31
  long long xb, yb, zb;  // sample strides of x, dy and dx
  int xt, xc, yt, yc, zt, zc;
  int t_contig, x_bf16, p_bf16;
};

struct Smem {
  float xs[kMaxIn][kPad];   // x rows; then the tile's dx rows
  float ys[kMaxOut][kPad];  // dy rows; then dz
  float w[kTileC][kMaxK];
  float bias[kTileC], gamma[kTileC];
  float part[kMaxQ][kGroups][kTileC];  // per row group; phase 1: scratch
};

__device__ __forceinline__ float ld(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, long long i, int bf16, float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// The CTA that owns tile i: the largest j with j N / G <= i.
__device__ __forceinline__ int owner(int i, int N, int G) {
  return ((i + 1) * G - 1) / N;
}

// Two sums over the CTA in a fixed order (a tree in shared memory); every
// thread gets them. scratch: 2 * kThreads floats.
__device__ void block_sum2(float& u, float& v, float* scratch) {
  const int tid = threadIdx.x;
  float* ru = scratch;
  float* rv = scratch + kThreads;
  __syncthreads();  // scratch may still be read by the previous call
  ru[tid] = u;
  rv[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      ru[tid] += ru[tid + s];
      rv[tid] += rv[tid + s];
    }
    __syncthreads();
  }
  u = ru[0];
  v = rv[0];
}

// Stage into shared memory the x rows [in0, in0 + n_in) and the dy rows
// [o0, o0 + n_out) of channels [c0, c0 + 32) of sample b, and the
// channels' parameters; rows and channels outside the tensors are 0.
// Neighbouring threads take neighbouring addresses of the contiguous axis.
__device__ void stage(const void* x, const void* dy, const void* w,
                      const void* bias, const void* gamma, const Geo& g,
                      int b, int c0, int in0, int n_in, int o0, int n_out,
                      Smem& sm) {
  const int tid = threadIdx.x;
  for (int e = tid; e < n_in * kTileC; e += kThreads) {
    const int r = g.t_contig ? e % n_in : e / kTileC;
    const int cl = g.t_contig ? e / n_in : e % kTileC;
    const int t = in0 + r, c = c0 + cl;
    float v = 0.f;
    if (t >= 0 && t < g.T && c < g.C)
      v = ld(x, b * g.xb + static_cast<long long>(t) * g.xt +
                    static_cast<long long>(c) * g.xc, g.x_bf16);
    sm.xs[r][cl] = v;
  }
  for (int e = tid; e < n_out * kTileC; e += kThreads) {
    const int r = g.t_contig ? e % n_out : e / kTileC;
    const int cl = g.t_contig ? e / n_out : e % kTileC;
    const int t = o0 + r, c = c0 + cl;
    float v = 0.f;
    if (t >= 0 && t < g.T_out && c < g.C)
      v = ld(dy, b * g.yb + static_cast<long long>(t) * g.yt +
                     static_cast<long long>(c) * g.yc, g.x_bf16);
    sm.ys[r][cl] = v;
  }
  if (tid < kTileC) {
    const int c = min(c0 + tid, g.C - 1);
    for (int k = 0; k < g.K; ++k) sm.w[tid][k] = ld(w, c * g.K + k, g.p_bf16);
    sm.bias[tid] = bias != nullptr ? ld(bias, c, g.p_bf16) : 0.f;
    sm.gamma[tid] = ld(gamma, c, g.p_bf16);
  }
}

// y at local output row r of the staged tile (x rows r S + k).
__device__ __forceinline__ float conv_at(const Smem& sm, const Geo& g, int r,
                                         int cl) {
  float a = 0.f;
  for (int k = 0; k < g.K; ++k) a += sm.xs[r * g.S + k][cl] * sm.w[cl][k];
  return a + sm.bias[cl];
}

__global__ void __launch_bounds__(kThreads)
dw_conv_glob_ln_backward_kernel(const void* __restrict__ x,
                                const void* __restrict__ dy,
                                const void* __restrict__ w,
                                const void* __restrict__ bias,
                                const void* __restrict__ gamma,
                                const float* __restrict__ stats, void* dx,
                                float* dw, float* dbias, float* dgamma,
                                float* dbeta, double2* parts,
                                float* tile_parts, Geo g) {
  __shared__ Smem sm;
  const int G = gridDim.x, j = blockIdx.x, N = g.n_tiles;
  const int lo = j * N / G, hi = (j + 1) * N / G;  // hi > lo: G <= N
  const int tid = threadIdx.x, cl = tid % kTileC, rg = tid / kTileC;
  auto box = [&](int i, int& b, int& t0, int& c0) {
    const int r = i % g.per_sample;
    b = i / g.per_sample;
    t0 = (r % g.tiles_t) * kTileT;
    c0 = (r / g.tiles_t) * kTileC;
  };

  // phase 1: per sample, the sums of g and g * xh, folded per (sample,
  // CTA) in tile order
  int cur = lo / g.per_sample;
  double p1 = 0.0, p2 = 0.0;
  for (int i = lo; i < hi; ++i) {
    int b, t0, c0;
    box(i, b, t0, c0);
    if (b != cur) {
      if (tid == 0) parts[cur * G + j] = make_double2(p1, p2);
      cur = b;
      p1 = p2 = 0.0;
    }
    __syncthreads();  // the previous tile's reads of shared memory are done
    stage(x, dy, w, bias, gamma, g, b, c0, t0 * g.S - g.P,
          (kTileT - 1) * g.S + g.K, t0, kTileT, sm);
    __syncthreads();
    const float shi = stats[3 * b], slo = stats[3 * b + 1],
                rstd = stats[3 * b + 2];
    float s1 = 0.f, s2 = 0.f;
    for (int r = rg; r < kTileT; r += kGroups) {
      if (t0 + r < g.T_out && c0 + cl < g.C) {
        const float xh = ((conv_at(sm, g, r, cl) - shi) - slo) * rstd;
        const float gg = sm.ys[r][cl] * sm.gamma[cl];
        s1 += gg;
        s2 += gg * xh;
      }
    }
    block_sum2(s1, s2, &sm.part[0][0][0]);
    p1 += s1;
    p2 += s2;
  }
  if (tid == 0) parts[cur * G + j] = make_double2(p1, p2);

  cg::this_grid().sync();

  // phase 2: dz with its halo, the tile's parameter partials, dx
  int stat_b = -1;
  float A = 0.f, M = 0.f, shi = 0.f, slo = 0.f, rstd = 0.f;
  for (int i = lo; i < hi; ++i) {
    int b, t0, c0;
    box(i, b, t0, c0);
    if (b != stat_b) {
      const int first = b * g.per_sample;
      const int j0 = owner(first, N, G);
      const int j1 = owner(first + g.per_sample - 1, N, G);
      double s1 = 0.0, s2 = 0.0;
      for (int jj = j0; jj <= j1; ++jj) {
        const double2 p = parts[b * G + jj];
        s1 += p.x;
        s2 += p.y;
      }
      const double n = static_cast<double>(g.T_out) * g.C;
      A = static_cast<float>(s1 / n);
      M = static_cast<float>(s2 / n);
      shi = stats[3 * b];
      slo = stats[3 * b + 1];
      rstd = stats[3 * b + 2];
      stat_b = b;
    }
    const int o0 = t0 - g.hb, n_out = kTileT + g.hb + g.ha;
    const int in0 = o0 * g.S - g.P, n_in = (n_out - 1) * g.S + g.K;
    __syncthreads();
    stage(x, dy, w, bias, gamma, g, b, c0, in0, n_in, o0, n_out, sm);
    __syncthreads();
    float pw[kMaxK] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float pb = 0.f, pg = 0.f, pbe = 0.f;
    for (int r = rg; r < n_out; r += kGroups) {
      const int t = o0 + r;
      float dz = 0.f;
      if (t >= 0 && t < g.T_out && c0 + cl < g.C) {
        const float xh = ((conv_at(sm, g, r, cl) - shi) - slo) * rstd;
        const float d = sm.ys[r][cl];
        dz = rstd * ((d * sm.gamma[cl] - A) - xh * M);
        if (r >= g.hb && r < g.hb + kTileT) {  // the tile's own rows
          pg += d * xh;
          pbe += d;
          pb += dz;
#pragma unroll
          for (int k = 0; k < kMaxK; ++k)
            if (k < g.K) pw[k] += dz * sm.xs[r * g.S + k][cl];
        }
      }
      sm.ys[r][cl] = dz;  // only this thread reads or writes (r, cl) here
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) sm.part[k][rg][cl] = pw[k];
    sm.part[kMaxK][rg][cl] = pb;
    sm.part[kMaxK + 1][rg][cl] = pg;
    sm.part[kMaxK + 2][rg][cl] = pbe;
    __syncthreads();  // dz and the partials are in shared memory
    for (int e = tid; e < kMaxQ * kTileC; e += kThreads) {
      const int q = e / kTileC, c = e % kTileC;
      float s = 0.f;
      for (int r = 0; r < kGroups; ++r) s += sm.part[q][r][c];
      tile_parts[(static_cast<long long>(i) * kMaxQ + q) * kTileC + c] = s;
    }
    // dx at input rows [t0 S, t0 S + n_dx): the taps that land there
    const int r0 = t0 * g.S, n_dx = min(kTileT * g.S, g.T - r0);
    for (int q = rg; q < n_dx; q += kGroups) {
      float a = 0.f;
      for (int k = 0; k < g.K; ++k) {
        const int num = r0 + q + g.P - k;  // = t S for the output row t
        if (num % g.S != 0) continue;
        const int local = num / g.S - o0;
        if (local >= 0 && local < n_out) a += sm.w[cl][k] * sm.ys[local][cl];
      }
      sm.xs[q][cl] = a;  // x rows are no longer read in this tile
    }
    __syncthreads();
    for (int e = tid; e < n_dx * kTileC; e += kThreads) {
      const int r = g.t_contig ? e % n_dx : e / kTileC;
      const int c = g.t_contig ? e / n_dx : e % kTileC;
      if (c0 + c < g.C)
        st(dx, b * g.zb + static_cast<long long>(r0 + r) * g.zt +
                   static_cast<long long>(c0 + c) * g.zc, g.x_bf16,
           sm.xs[r][c]);
    }
  }

  cg::this_grid().sync();

  // phase 3: every (channel, quantity) over its tiles, samples outer
  const int nq = g.K + 3;
  for (int e = j * kThreads + tid; e < g.C * nq; e += G * kThreads) {
    const int c = e / nq, q = e % nq;
    const int slot = q < g.K ? q : kMaxK + (q - g.K);
    const int ct = c / kTileC, cl2 = c % kTileC;
    double s = 0.0;
    for (int b = 0; b < g.B; ++b)
      for (int tt = 0; tt < g.tiles_t; ++tt) {
        const long long i = static_cast<long long>(b) * g.per_sample +
                            ct * g.tiles_t + tt;
        s += tile_parts[(i * kMaxQ + slot) * kTileC + cl2];
      }
    const float v = static_cast<float>(s);
    if (q < g.K)
      dw[c * g.K + q] = v;
    else if (q == g.K)
      dbias[c] = v;
    else if (q == g.K + 1)
      dgamma[c] = v;
    else
      dbeta[c] = v;
  }
}

}  // namespace

extern "C" {

// Sizes of the scratch a launch needs: the parts (double2 a (sample,
// CTA)) and the tile partials (floats).
long long dw_conv_glob_ln_backward_tile_floats(int n_tiles) {
  return static_cast<long long>(n_tiles) * kMaxQ * kTileC;
}

// The CTAs the current card holds at once (occupancy x SMs): the largest
// cooperative grid. A negative value is a cudaError_t, negated.
int dw_conv_glob_ln_backward_capacity(void) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, dw_conv_glob_ln_backward_kernel, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks * sms;
}

// x, dx: storage in fp32 (x_bf16 == 0) or bf16, element strides (B, T,
// C); dy: the same storage, strides (B, T_out, C); w (C, K), bias (C,) or
// null, gamma (C,): contiguous, fp32 (p_bf16 == 0) or bf16; stats: fp32
// (B, 3) (hi, lo, rstd) from the forward; dw (C, K), dbias, dgamma, dbeta
// (C,): fp32 outputs; parts: (B, grid) double2; tile_parts: the floats
// of dw_conv_glob_ln_backward_tile_floats. One cooperative launch of
// ``grid`` CTAs (at most the capacity and the tiles) on ``stream``.
// t_contig: T is the innermost axis of x, dy and dx alike.
// Returns a cudaError_t, 0 on success.
int dw_conv_glob_ln_backward_launch(
    const void* x, const void* dy, const void* w, const void* bias,
    const void* gamma, const float* stats, void* dx, float* dw, float* dbias,
    float* dgamma, float* dbeta, void* parts, float* tile_parts, int B, int T,
    int C, int T_out, int K, int stride, long long xb, long long xt,
    long long xc, long long yb, long long yt, long long yc, long long zb,
    long long zt, long long zc, int t_contig, int x_bf16, int p_bf16,
    int grid, void* stream) {
  if (B < 1 || T < 1 || C < 1 || K < 1 || K > kMaxK || K % 2 == 0 ||
      (stride != 1 && stride != 2) ||
      T_out != (T - 1) / stride + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = (K - 1) / 2;
  const long long tiles_t = (T_out + kTileT - 1) / kTileT;
  const long long tiles_c = (C + kTileC - 1) / kTileC;
  const long long n_tiles = B * tiles_t * tiles_c;
  const long long span = (T - 1) * (xt + zt) + (C - 1) * (xc + zc) +
                         (T_out - 1) * yt + (C - 1) * yc;
  if (grid < 1 || grid > n_tiles || (n_tiles + 1) * grid >= (1LL << 31) ||
      span >= (1LL << 31) || xt < 0 || xc < 0 || yt < 0 || yc < 0 ||
      zt < 0 || zc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geo g{B, T, C, T_out, K, stride, P, P / stride, (stride - 1 + P) / stride,
        static_cast<int>(tiles_t), static_cast<int>(tiles_c),
        static_cast<int>(tiles_t * tiles_c), static_cast<int>(n_tiles),
        xb, yb, zb, static_cast<int>(xt), static_cast<int>(xc),
        static_cast<int>(yt), static_cast<int>(yc), static_cast<int>(zt),
        static_cast<int>(zc), t_contig, x_bf16, p_bf16};
  double2* pp = static_cast<double2*>(parts);
  void* args[] = {const_cast<void**>(&x), const_cast<void**>(&dy),
                  const_cast<void**>(&w), const_cast<void**>(&bias),
                  const_cast<void**>(&gamma),
                  const_cast<float**>(&stats), &dx, &dw, &dbias, &dgamma,
                  &dbeta, &pp, &tile_parts, &g};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dw_conv_glob_ln_backward_kernel),
      dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
