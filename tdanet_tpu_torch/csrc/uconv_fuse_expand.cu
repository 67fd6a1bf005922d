// The second half of one UConvBlock (inference) for Hopper (sm_90a):
// per-scale LA fusion with the post-GA global feature g, the top-down LA
// expansion, then res_conv (1x1 conv C -> C_out + bias) + the residual.
//
//   fused_i = N(s_i * wl_i) * sigmoid(N(g * wa_i)[u]) + N(g * we_i)[u],
//             u = floor(t * T_g / T_i)                 (k1 ConvNorms)
//   exp_i   = N(k5(fused_i)) * sigmoid(N(k5(x_g))[r]) + N(k5(x_g))[r],
//             x_g = fused_{depth-3} for i = depth-2 (the reference's
//             finer-scale quirk: r = floor(t * T_{depth-3} / T_{depth-2})
//             resizes it down), else exp_{i+1} (r = t // 2)
//   out     = res_conv(exp_0) + x                      (N: GlobLN)
//
// Replaces the TPU kernel tdanet_tpu/kernels/uconv_block.py
// fuse_expand_fused (_fuse_expand_kernel), which holds one sample's five
// scales in VMEM and resizes with one-hot matrix products.
//
// What bounds it on the H100: as for uconv_pyramid.cu, a sample's scales
// are 8.2 MB in fp32 and each of the 3 * (2 * depth - 1) ConvNorms ends in
// a GlobLN over its whole (T, C). At B = 24 in bf16 the kernel must move
// about 127 MB (38 us at 3.35 TB/s; res_conv's 6.4 GFLOP take 6 us of
// tensor cores): bytes. At B = 1 the dependent launches set the floor.
//
// What the design does about it: one C entry launches depth + 2 kernels
// on one stream, after one memset of the election counters:
//   1. the statistics of every k1 ConvNorm of the fusion: per scale the
//      local one over s_i; over g, which GA hands over as a strided view, a
//      CTA per tile of g reads it once (coalesced along its contiguous
//      axis, through shared memory), stores a contiguous copy for the later
//      passes and writes the parts of all 2 * depth ConvNorms over g;
//   2. the fusion of every scale in one launch (a flat list of (scale,
//      tile) jobs, so no CTA idles), which also writes the statistics of
//      the expansion's k5 ConvNorms over the fused scales: every pair's
//      local one, and the first pair's two over fused_{depth-3};
//   3. per expansion pair, top down, a pass that writes exp_i and the
//      statistics of the next pair's two k5 ConvNorms over it;
//   4. res_conv (uconv_gemm.cuh: wgmma and TMA in bf16, SIMT in fp32),
//      bias and residual in its epilogue, pad rows zero.
// Each (mean, rstd) is finalised once per sample (uconv_common.cuh); the
// passes read two floats of it. Tiles are 128 rows x 64 channels; the
// fusion and expansion passes stage the rows they read (of s_i and g, of
// fused_i and x_g) in shared memory. Resizes are index arithmetic, not
// matrices. Deterministic: no atomics but the counters that elect.

#include "uconv_gemm.cuh"

namespace {

using namespace uconv;

// The fp32 parameter pack, in the wrapper's order: per fusion LA i (depth
// of them) the local, global_act and global_embedding k1 ConvNorms as
// (w, gamma, beta), C each; per expansion pair i = 0 .. depth - 2 the same
// three k5 ConvNorms as (taps (5, C) tap-major, gamma, beta); then
// res_conv's bias (C_out).
struct ConvNormP {
  const float *w, *gamma, *beta;
};
struct Params {
  ConvNormP fuse[kMaxDepth][3], expand[kMaxDepth][3];
  const float* res_bias;
};

long long params_floats(int C, int Cout, int depth) {
  return 9LL * C * depth + 21LL * C * (depth - 1) + Cout;
}

Params params(const float* p, int C, int depth) {
  Params q{};
  for (int i = 0; i < depth; ++i)
    for (int k = 0; k < 3; ++k, p += 3 * C)
      q.fuse[i][k] = {p, p + C, p + 2 * C};
  for (int i = 0; i < depth - 1; ++i)
    for (int k = 0; k < 3; ++k, p += 7 * C)
      q.expand[i][k] = {p, p + 5 * C, p + 6 * C};
  q.res_bias = p;
  return q;
}

// res_conv's epilogue: bias and residual on the true rows [lo, hi), zero
// on the pad rows.
template <typename T>
struct ResEpi {
  static constexpr bool kStats = false;
  const float* bias;
  const T* resid;
  T* out;
  int M, N, lo, hi;
  Norm norm;
  float eps;

  template <int W>
  __device__ bool finalize(int b, int m, int n, float (&v)[W]) const {
    if (m >= M) return false;
    if (m >= lo && m < hi) {
      float bb[W], x[W];
      ld_f32<W>(bias + n, bb);
      ld_vec(resid + ((long long)b * M + m) * N + n, x);
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = (v[j] + bb[j]) + x[j];
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = 0.f;
    }
    return true;
  }
  template <int W>
  __device__ void store(int b, int m, int n, const float (&v)[W]) const {
    st_vec(out + ((long long)b * M + m) * N + n, v);
  }
  __device__ float y0(int) const { return 0.f; }  // no statistics
};

constexpr int R = 128;  // rows of a tile
constexpr int kSpan = R + 2 * kHalo;

// The statistics of a stride-1 k5 conv (no bias) over a pass's values in
// shared memory (rows r0 - 2 .. r0 + R + 1 of a scale of length T, kBand
// channels a row): output row r0 + j reads rows j .. j + 4. One part for
// the tile (part idx of the sample), then the election.
template <typename T>
__device__ void next_stats(const T* vals, const float* taps, const Norm& nm,
                           int r0, int T_len, int c0, int C, int b, int idx,
                           float eps, StatSmem<kThreads>& ss) {
  const int lane = threadIdx.x % kLanes, grp = threadIdx.x / kLanes;
  const int cl = lane * kV;
  float w[5][kV];
#pragma unroll
  for (int k = 0; k < 5; ++k) ld_f32<kV>(taps + k * C + c0 + cl, w[k]);
  const int jv = max(0, -r0);
  float y0 = 0.f;
  for (int k = 0; k < 5; ++k) {
    float x[kV];
    ld4(vals + (jv + k) * kBand, x);
    y0 = fmaf(x[0], taps[k * C + c0], y0);
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int j = grp; j < R; j += kGroups) {
    float acc[kV] = {};
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      float x[kV];
      ld4(vals + (j + k) * kBand + cl, x);
#pragma unroll
      for (int e = 0; e < kV; ++e) acc[e] = fmaf(x[e], w[k][e], acc[e]);
    }
    const int t = r0 + j;
    if (t >= 0 && t < T_len) {
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float d = acc[e] - y0;
        s1 += d;
        s2 = fmaf(d, d, s2);
      }
    }
  }
  const int n_rows = max(min(r0 + R, T_len) - max(r0, 0), 0);
  float* p = nm.part + 3LL * (b * nm.n + idx);
  tile_part<kThreads>(s1, s2, y0, static_cast<float>(n_rows * kBand), ss, p);
  finish(nm.part + 3LL * b * nm.n, nm.n, nm.count + b, nm.stats + b, eps);
}

// ---------------------------------------------------------------------------
// 1. the k1 statistics (and the contiguous copy of g)
// ---------------------------------------------------------------------------

struct K1Job {
  const void* x;  // local: first true row of padded scale i
  long long sb;
  int T, first, tiles;
  const float* w;
  Norm norm;
};

struct K1Jobs {
  K1Job local[kMaxDepth];
  // g: element (b, t, c) at g + b*gb + t*gt + c*gc; its 2 * depth k1
  // ConvNorms (w, norm) in the order act_0, emb_0, act_1, ...
  const void* g;
  long long gb, gt, gc;
  void* g_work;
  int Tg, g_tiles;
  const float* gw[2 * kMaxDepth];
  Norm gnorm[2 * kMaxDepth];
  int depth, C, bands;
  float eps;
};

// grid (g_tiles + the local jobs' tiles, B): the g tiles first. Tiles are
// R true rows x kBand channels; a thread takes 4 channels of every
// kGroups-th row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
k1_kernel(const __grid_constant__ K1Jobs js) {
  __shared__ float sm[R][kBand + 1];  // + 1: column writes
  __shared__ StatSmem<kThreads> ss;
  const int b = blockIdx.y, C = js.C;
  const int lane = threadIdx.x % kLanes, grp = threadIdx.x / kLanes;
  const int cl = lane * kV;
  int idx = blockIdx.x;
  if (idx < js.g_tiles) {
    const int c0 = (idx % js.bands) * kBand, t0 = (idx / js.bands) * R;
    const T* g = static_cast<const T*>(js.g) + b * js.gb;
    // coalesced along g's contiguous axis (t when gt == 1, else c)
    const bool t_fast = js.gt == 1;
    for (int e = threadIdx.x; e < R * kBand; e += kThreads) {
      const int tl = t_fast ? e % R : e / kBand;
      const int ch = t_fast ? e / R : e % kBand;
      const int t = min(t0 + tl, js.Tg - 1);
      float v;
      if constexpr (sizeof(T) == 2)
        v = __bfloat162float(g[t * js.gt + (c0 + ch) * js.gc]);
      else
        v = g[t * js.gt + (c0 + ch) * js.gc];
      sm[tl][ch] = v;
    }
    __syncthreads();
    T* gw = static_cast<T*>(js.g_work) + (long long)b * js.Tg * C + c0 + cl;
    for (int j = grp; j < R && t0 + j < js.Tg; j += kGroups) {
      float x[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) x[e] = sm[j][cl + e];
      st4(gw + (long long)(t0 + j) * C, x);
    }
    const int n_rows = min(t0 + R, js.Tg) - t0;
    for (int n = 0; n < 2 * js.depth; ++n) {
      float w[kV];
      ld_f32<kV>(js.gw[n] + c0 + cl, w);
      const float y0 = sm[0][0] * js.gw[n][c0];
      float s1 = 0.f, s2 = 0.f;
      for (int j = grp; j < n_rows; j += kGroups) {
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const float d = sm[j][cl + e] * w[e] - y0;
          s1 += d;
          s2 = fmaf(d, d, s2);
        }
      }
      const Norm& nm = js.gnorm[n];
      tile_part<kThreads>(s1, s2, y0, static_cast<float>(n_rows * kBand), ss,
                          nm.part + 3LL * (b * nm.n + idx));
      finish(nm.part + 3LL * b * nm.n, nm.n, nm.count + b, nm.stats + b,
             js.eps);
    }
    return;
  }
  int k = 0;
  while (k + 1 < js.depth && idx >= js.local[k + 1].first) ++k;
  const K1Job& j = js.local[k];
  idx -= j.first;
  const int c0 = (idx % js.bands) * kBand, t0 = (idx / js.bands) * R;
  const T* xs = static_cast<const T*>(j.x) + b * j.sb + c0;
  float w[kV];
  ld_f32<kV>(j.w + c0 + cl, w);
  float x0[kV];
  ld4(xs + (long long)t0 * C, x0);
  const float y0 = x0[0] * j.w[c0];
  const int n_rows = min(t0 + R, j.T) - t0;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
  for (int r = grp; r < n_rows; r += kGroups) {
    float x[kV];
    ld4(xs + (long long)(t0 + r) * C + cl, x);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const float d = x[e] * w[e] - y0;
      s1 += d;
      s2 = fmaf(d, d, s2);
    }
  }
  tile_part<kThreads>(s1, s2, y0, static_cast<float>(n_rows * kBand), ss,
                      j.norm.part + 3LL * (b * j.norm.n + idx));
  finish(j.norm.part + 3LL * b * j.norm.n, j.norm.n, j.norm.count + b,
         j.norm.stats + b, js.eps);
}

// ---------------------------------------------------------------------------
// 2. the fusion, and the statistics of the expansion's k5 convs over it
// ---------------------------------------------------------------------------

struct FuseJob {
  const void* s;  // first true row of padded scale i
  void* out;      // fused_i, padded, its row 0
  int T, rows, first;
  ConvNormP n[3];  // local, act, emb (k1)
  const float2* st[3];
  int n_next;      // k5 convs over fused_i whose statistics this job writes
  const float* ntaps[3];
  Norm next[3];
};

struct FuseJobs {
  FuseJob j[kMaxDepth];
  const void* g;  // contiguous (B, Tg, C)
  int Tg, n, C, bands;
  float eps;
};

// Rows of g a fusion tile reads: u(r) = floor(r T_g / T_i) over its
// kSpan rows, T_g <= T_i.
constexpr int kFuseG = kSpan + 1;

template <typename T>
constexpr int fuse_smem() {
  return (kSpan + kFuseG + kSpan) * kBand * static_cast<int>(sizeof(T));
}

// grid (the jobs' tiles, B); a job's tiles cover the padded rows of its
// scale, R rows each. A CTA stages the rows of s_i and of g that its
// values read (cp.async, 16 bytes a thread) in shared memory.
// At most 64 registers, so that four CTAs share an SM (faster on the card
// than three at 80).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
fuse_kernel(const __grid_constant__ FuseJobs js) {
  constexpr int kVec = 16 / sizeof(T), kRowVecs = kBand / kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_s = reinterpret_cast<T*>(smem_raw);  // [kSpan][kBand]
  T* g_s = s_s + kSpan * kBand;              // [kFuseG][kBand]
  T* vals = g_s + kFuseG * kBand;            // [kSpan][kBand]
  __shared__ StatSmem<kThreads> ss;
  const int b = blockIdx.y, C = js.C;
  const int lane = threadIdx.x % kLanes, grp = threadIdx.x / kLanes;
  const int cl = lane * kV;
  int k = 0;
  while (k + 1 < js.n && static_cast<int>(blockIdx.x) >= js.j[k + 1].first)
    ++k;
  const FuseJob& j = js.j[k];
  const int idx = blockIdx.x - j.first;
  const int c0 = (idx % js.bands) * kBand, c = c0 + cl;
  const int r0 = (idx / js.bands) * R - kPad;
  const int u_lo = min(max(r0 - kHalo, 0), j.T - 1) * js.Tg / j.T;
  const int u_hi = min(max(r0 + R + kHalo - 1, 0), j.T - 1) * js.Tg / j.T;
  const T* sx = static_cast<const T*>(j.s) + (long long)b * j.rows * C + c0;
  const T* gx = static_cast<const T*>(js.g) + (long long)b * js.Tg * C + c0;
  for (int e = threadIdx.x; e < kSpan * kRowVecs; e += kThreads) {
    const int row = r0 - kHalo + e / kRowVecs, v = e % kRowVecs;
    const bool ok = row >= -kPad && row < j.rows - kPad;
    cp_async16(s_s + (e / kRowVecs) * kBand + v * kVec,
               ok ? sx + (long long)row * C + v * kVec : sx, ok);
  }
  for (int e = threadIdx.x; e < (u_hi - u_lo + 1) * kRowVecs; e += kThreads) {
    const int row = u_lo + e / kRowVecs, v = e % kRowVecs;
    cp_async16(g_s + (e / kRowVecs) * kBand + v * kVec,
               gx + (long long)row * C + v * kVec, true);
  }
  float w[3][kV], ga[3][kV], be[3][kV], mean[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    ld_f32<kV>(j.n[q].w + c, w[q]);
    ld_f32<kV>(j.n[q].gamma + c, ga[q]);
    ld_f32<kV>(j.n[q].beta + c, be[q]);
    const float2 st = j.st[q][b];
    mean[q] = st.x;
#pragma unroll
    for (int e = 0; e < kV; ++e) ga[q][e] *= st.y;
  }
  cp_async_wait_all();
  __syncthreads();
  T* out = static_cast<T*>(j.out) + (long long)b * j.rows * C + c;
  for (int i = grp; i < kSpan; i += kGroups) {
    const int r = r0 - kHalo + i;
    const int rc = min(max(r, 0), j.T - 1);
    const int u = rc * js.Tg / j.T - u_lo;  // T0 <= kMaxT: no overflow
    float sv[kV], gv[kV], v[kV];
    ld4(s_s + i * kBand + cl, sv);
    ld4(g_s + u * kBand + cl, gv);
    const bool ok = r >= 0 && r < j.T;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const float zl = (sv[e] * w[0][e] - mean[0]) * ga[0][e] + be[0][e];
      const float za = (gv[e] * w[1][e] - mean[1]) * ga[1][e] + be[1][e];
      const float ze = (gv[e] * w[2][e] - mean[2]) * ga[2][e] + be[2][e];
      v[e] = ok ? keep<T>(zl * sigmoid(za) + ze) : 0.f;
    }
    st4(vals + i * kBand + cl, v);
  }
  __syncthreads();
  for (int q = 0; q < j.n_next; ++q)
    next_stats<T>(vals, j.ntaps[q], j.next[q], r0, j.T, c0, C, b, idx,
                  js.eps, ss);
  store_rows<R>(vals, out, r0, j.rows, C);
}

// ---------------------------------------------------------------------------
// 3. one expansion pair, and the statistics of the next pair's two convs
// ---------------------------------------------------------------------------

struct ExpandArgs {
  const void* loc;   // fused_i, padded, its row 0
  const void* glob;  // x_g, padded, its row 0
  void* out;         // exp_i, padded, its row 0
  int T_l, rows_l, T_g, rows_g;
  int g_rows;        // rows of x_g a tile stages, at most
  ConvNormP n[3];    // local, act, emb (k5 taps (5, C))
  const float2* st[3];
  int n_next;
  const float* ntaps[2];
  Norm next[2];
  int C, bands;
  float eps;
};

// x_g's rows that the tile from r0 reads: from u(r0 - 2) - 2 to
// u(r0 + R + 1) + 2, u(r) = floor(clamp(r) T_g / T_l).
__host__ __device__ inline void glob_span(int r0, int T_l, int T_g, int& lo,
                                          int& n) {
  const int a = min(max(r0 - kHalo, 0), T_l - 1);
  const int z = min(max(r0 + R + kHalo - 1, 0), T_l - 1);
  lo = a * T_g / T_l - 2;
  n = z * T_g / T_l + 2 - lo + 1;
}

constexpr int kLocRows = kSpan + 4;  // fused_i rows r0 - 4 .. r0 + R + 3

template <typename T>
int expand_smem(int g_rows) {
  return (kLocRows + g_rows + kSpan) * kBand * static_cast<int>(sizeof(T));
}

// grid (row_tiles(T_l, R) * bands, B). A CTA stages the rows of fused_i and
// of x_g that its values read (cp.async, 16 bytes a thread) in shared
// memory and computes its rows and the halo there.
template <typename T>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const __grid_constant__ ExpandArgs a) {
  constexpr int kVec = 16 / sizeof(T), kRowVecs = kBand / kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* loc_s = reinterpret_cast<T*>(smem_raw);  // [kLocRows][kBand]
  T* glob_s = loc_s + kLocRows * kBand;        // [a.g_rows][kBand]
  T* vals = glob_s + a.g_rows * kBand;         // [kSpan][kBand]
  __shared__ __align__(16) float taps[3][5][kBand];
  __shared__ StatSmem<kThreads> ss;
  const int b = blockIdx.y, C = a.C, c0 = (blockIdx.x % a.bands) * kBand;
  const int r0 = (blockIdx.x / a.bands) * R - kPad;
  const int lane = threadIdx.x % kLanes, grp = threadIdx.x / kLanes;
  const int cl = lane * kV, c = c0 + cl;
  int g_lo, g_n;
  glob_span(r0, a.T_l, a.T_g, g_lo, g_n);
  const T* lx = static_cast<const T*>(a.loc) +
                ((long long)b * a.rows_l + kPad) * C + c0;
  const T* gx = static_cast<const T*>(a.glob) +
                ((long long)b * a.rows_g + kPad) * C + c0;
  for (int e = threadIdx.x; e < kLocRows * kRowVecs; e += kThreads) {
    const int row = r0 - 4 + e / kRowVecs, v = e % kRowVecs;
    const bool ok = row >= -kPad && row < a.rows_l - kPad;
    cp_async16(loc_s + (e / kRowVecs) * kBand + v * kVec,
               ok ? lx + (long long)row * C + v * kVec : lx, ok);
  }
  for (int e = threadIdx.x; e < g_n * kRowVecs; e += kThreads) {
    const int row = g_lo + e / kRowVecs, v = e % kRowVecs;
    cp_async16(glob_s + (e / kRowVecs) * kBand + v * kVec,
               gx + (long long)row * C + v * kVec, true);
  }
  for (int e = threadIdx.x; e < 3 * 5 * kBand; e += kThreads) {
    const int q = e / (5 * kBand), k = e / kBand % 5, ch = e % kBand;
    taps[q][k][ch] = a.n[q].w[k * C + c0 + ch];
  }
  float ga[3][kV], be[3][kV], mean[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    ld_f32<kV>(a.n[q].gamma + c, ga[q]);
    ld_f32<kV>(a.n[q].beta + c, be[q]);
    const float2 st = a.st[q][b];
    mean[q] = st.x;
#pragma unroll
    for (int e = 0; e < kV; ++e) ga[q][e] *= st.y;
  }
  cp_async_wait_all();
  __syncthreads();
  T* out = static_cast<T*>(a.out) + (long long)b * a.rows_l * C + c;
  // not unrolled: unrolled, the loop held 127 registers (two CTAs an SM)
  // and ran slower on the card
#pragma unroll 1
  for (int i = grp; i < kSpan; i += kGroups) {
    const int r = r0 - kHalo + i;
    const int rc = min(max(r, 0), a.T_l - 1);
    const int u = rc * a.T_g / a.T_l - g_lo - 2;  // T0 <= kMaxT
    float yl[kV] = {}, ya[kV] = {}, ye[kV] = {};
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      float xl[kV], xg[kV], wl[kV], wa[kV], we[kV];
      ld4(loc_s + (i + k) * kBand + cl, xl);
      ld4(glob_s + (u + k) * kBand + cl, xg);
      ld4(&taps[0][k][cl], wl);
      ld4(&taps[1][k][cl], wa);
      ld4(&taps[2][k][cl], we);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        yl[e] = fmaf(xl[e], wl[e], yl[e]);
        ya[e] = fmaf(xg[e], wa[e], ya[e]);
        ye[e] = fmaf(xg[e], we[e], ye[e]);
      }
    }
    const bool ok = r >= 0 && r < a.T_l;
    float v[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const float zl = (yl[e] - mean[0]) * ga[0][e] + be[0][e];
      const float za = (ya[e] - mean[1]) * ga[1][e] + be[1][e];
      const float ze = (ye[e] - mean[2]) * ga[2][e] + be[2][e];
      v[e] = ok ? keep<T>(zl * sigmoid(za) + ze) : 0.f;
    }
    st4(vals + i * kBand + cl, v);
  }
  __syncthreads();
  for (int q = 0; q < a.n_next; ++q)
    next_stats<T>(vals, a.ntaps[q], a.next[q], r0, a.T_l, c0, C, b,
                  blockIdx.x, a.eps, ss);
  store_rows<R>(vals, out, r0, a.rows_l, C);
}

// ---------------------------------------------------------------------------
// the entry
// ---------------------------------------------------------------------------

// The statistics of every ConvNorm, laid out by one walk (see Scratch).
struct Norms {
  Norm local[kMaxDepth], act[kMaxDepth], emb[kMaxDepth];   // fusion
  Norm e_local[kMaxDepth], e_act[kMaxDepth], e_emb[kMaxDepth];  // pairs
};

void walk(Scratch& sc, Norms& nm, const int* Ts, int depth, int bands) {
  const int g_parts = cdiv(Ts[depth - 1], R) * bands;
  for (int i = 0; i < depth; ++i) {
    nm.local[i] = sc.take(cdiv(Ts[i], R) * bands);
    nm.act[i] = sc.take(g_parts);
    nm.emb[i] = sc.take(g_parts);
  }
  for (int i = depth - 2; i >= 0; --i) {
    nm.e_local[i] = sc.take(row_tiles(Ts[i], R) * bands);
    // x_g's pass: fused_{depth-3} for the first pair, else exp_{i+1}
    const int T_x = i == depth - 2 ? Ts[i - 1] : Ts[i + 1];
    nm.e_act[i] = sc.take(row_tiles(T_x, R) * bands);
    nm.e_emb[i] = sc.take(row_tiles(T_x, R) * bands);
  }
}

template <typename T>
cudaError_t run(const void* const* scales, const void* g, long long gb,
                long long gt, long long gc, void* g_work, const void* x,
                void* out, void* const* fused, void* const* exps,
                float* scratch, const float* prm, const void* wt, int B,
                int T0, int C, int Cout, int depth, float eps,
                cudaStream_t stream) {
  constexpr bool bf16 = sizeof(T) == 2;
  int Ts[kMaxDepth];
  scale_lengths(T0, depth, Ts);
  const int bands = C / kBand, Tg = Ts[depth - 1];
  Norms nm{};
  cudaError_t err = lay_out(scratch, B, stream, [&](Scratch& sc) {
    walk(sc, nm, Ts, depth, bands);
  });
  if (err != cudaSuccess) return err;
  const Params p = params(prm, C, depth);
  auto first_row = [&](const void* buf) {
    return static_cast<const T*>(buf) + (long long)kPad * C;
  };

  // 1. the k1 statistics, the copy of g
  K1Jobs k1{};
  k1.g = g;
  k1.gb = gb;
  k1.gt = gt;
  k1.gc = gc;
  k1.g_work = g_work;
  k1.Tg = Tg;
  k1.g_tiles = cdiv(Tg, R) * bands;
  k1.depth = depth;
  k1.C = C;
  k1.bands = bands;
  k1.eps = eps;
  int tiles = k1.g_tiles;
  for (int i = 0; i < depth; ++i) {
    k1.gw[2 * i] = p.fuse[i][1].w;
    k1.gw[2 * i + 1] = p.fuse[i][2].w;
    k1.gnorm[2 * i] = nm.act[i];
    k1.gnorm[2 * i + 1] = nm.emb[i];
    K1Job& j = k1.local[i];
    j.x = first_row(scales[i]);
    j.sb = (long long)padded_rows(Ts[i]) * C;
    j.T = Ts[i];
    j.first = tiles;
    j.tiles = cdiv(Ts[i], R) * bands;
    j.w = p.fuse[i][0].w;
    j.norm = nm.local[i];
    tiles += j.tiles;
  }
  k1_kernel<T><<<dim3(tiles, B), kThreads, 0, stream>>>(k1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 2. the fusion of every scale; the k5 statistics over the fused scales
  FuseJobs fj{};
  fj.g = g_work;
  fj.Tg = Tg;
  fj.n = depth;
  fj.C = C;
  fj.bands = bands;
  fj.eps = eps;
  tiles = 0;
  for (int i = 0; i < depth; ++i) {
    FuseJob& j = fj.j[i];
    j.s = first_row(scales[i]);
    j.out = fused[i];
    j.T = Ts[i];
    j.rows = padded_rows(Ts[i]);
    j.first = tiles;
    tiles += row_tiles(Ts[i], R) * bands;
    for (int q = 0; q < 3; ++q) j.n[q] = p.fuse[i][q];
    j.st[0] = nm.local[i].stats;
    j.st[1] = nm.act[i].stats;
    j.st[2] = nm.emb[i].stats;
    if (i <= depth - 2) {
      j.ntaps[j.n_next] = p.expand[i][0].w;
      j.next[j.n_next++] = nm.e_local[i];
    }
    if (i == depth - 3) {  // the first pair's x_g
      for (int q = 1; q < 3; ++q) {
        j.ntaps[j.n_next] = p.expand[depth - 2][q].w;
        j.next[j.n_next++] = q == 1 ? nm.e_act[depth - 2] : nm.e_emb[depth - 2];
      }
    }
  }
  err = cudaFuncSetAttribute(fuse_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fuse_smem<T>());
  if (err != cudaSuccess) return err;
  fuse_kernel<T><<<dim3(tiles, B), kThreads, fuse_smem<T>(), stream>>>(fj);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 3. the expansion, top down
  for (int i = depth - 2; i >= 0; --i) {
    const bool quirk = i == depth - 2;
    ExpandArgs a{};
    a.loc = fused[i];
    a.glob = quirk ? fused[i - 1] : exps[i + 1];
    a.out = exps[i];
    a.T_l = Ts[i];
    a.rows_l = padded_rows(Ts[i]);
    a.T_g = quirk ? Ts[i - 1] : Ts[i + 1];
    a.rows_g = padded_rows(a.T_g);
    for (int q = 0; q < 3; ++q) a.n[q] = p.expand[i][q];
    a.st[0] = nm.e_local[i].stats;
    a.st[1] = nm.e_act[i].stats;
    a.st[2] = nm.e_emb[i].stats;
    if (i > 0) {  // exp_i is the next pair's x_g
      a.n_next = 2;
      a.ntaps[0] = p.expand[i - 1][1].w;
      a.ntaps[1] = p.expand[i - 1][2].w;
      a.next[0] = nm.e_act[i - 1];
      a.next[1] = nm.e_emb[i - 1];
    }
    a.C = C;
    a.bands = bands;
    a.eps = eps;
    const int tiles_l = row_tiles(Ts[i], R);
    for (int t = 0; t < tiles_l; ++t) {
      int lo, n;
      glob_span(t * R - kPad, a.T_l, a.T_g, lo, n);
      a.g_rows = n > a.g_rows ? n : a.g_rows;
    }
    const int bytes = expand_smem<T>(a.g_rows);
    err = cudaFuncSetAttribute(expand_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    expand_kernel<T><<<dim3(tiles_l * bands, B), kThreads, bytes, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  // 4. res_conv + bias + residual over every padded row
  const int rows0 = padded_rows(T0);
  const Operand op{exps[0], (long long)rows0 * C, C, rows0, Cout, C};
  const ResEpi<T> epi{p.res_bias, static_cast<const T*>(x),
                      static_cast<T*>(out), rows0, Cout, kPad, kPad + T0,
                      Norm{}, eps};
  if constexpr (bf16)
    return launch_mma(op, wt, epi, B, stream);
  else
    return launch_simt_gemm(op, static_cast<const float*>(wt), epi, B,
                            stream);
}

}  // namespace

extern "C" {

// fp32 scratch floats (parts, statistics, counters) for this geometry.
long long uconv_fuse_expand_scratch(int B, int T0, int C, int depth) {
  if (B < 1 || T0 < 1 || C < 1 || depth < 3 || depth > kMaxDepth) return -1;
  int Ts[kMaxDepth];
  scale_lengths(T0, depth, Ts);
  Scratch sc{nullptr, nullptr, B};
  Norms nm{};
  walk(sc, nm, Ts, depth, C / kBand);
  return sc.total();
}

// Floats of the fp32 parameter pack (see Params).
long long uconv_fuse_expand_params(int C, int Cout, int depth) {
  return params_floats(C, Cout, depth);
}

// scales: `depth` padded (B, rows_i, C) buffers; g: the post-GA global
// feature, (b, t, c) at g + b*gb + t*gt + c*gc for t < T_g; g_work:
// (B, T_g, C) scratch; x, out: padded (B, rows_0, Cout); fused: `depth`
// padded (B, rows_i, C) scratch buffers; exps: `depth - 1` of them; all in
// the storage type, fp32 (bf16 == 0) or bf16, 16-byte aligned. scratch:
// uconv_fuse_expand_scratch floats; prm: the parameter pack; wt:
// res_conv's weight transposed, (C, Cout) in the storage type. C and Cout
// are multiples of 64. Returns a cudaError_t, 0 on success.
int uconv_fuse_expand_launch(const void* const* scales, const void* g,
                             long long gb, long long gt, long long gc,
                             void* g_work, const void* x, void* out,
                             void* const* fused, void* const* exps,
                             float* scratch, const float* prm, const void* wt,
                             int B, int T0, int C, int Cout, int depth,
                             int bf16, float eps, void* stream) {
  if (B < 1 || B > 65535 || T0 < 1 || T0 > kMaxT || C < 64 || C % 64 != 0 ||
      Cout < 64 || Cout % 64 != 0 || depth < 3 || depth > kMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? run<__nv_bfloat16>(scales, g, gb, gt, gc, g_work, x, out, fused,
                                exps, scratch, prm, wt, B, T0, C, Cout, depth,
                                eps, s)
           : run<float>(scales, g, gb, gt, gc, g_work, x, out, fused, exps,
                        scratch, prm, wt, B, T0, C, Cout, depth, eps, s);
  return static_cast<int>(err);
}

}  // extern "C"
