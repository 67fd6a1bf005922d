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
// are 8.2 MB in fp32 and every ConvNorm ends in a GlobLN over its whole
// (T, C), 3 * (2 * depth - 1) reductions per block; past res_conv (0.26
// GFLOP a sample) the work is a few flops per byte: memory- and L2-bound.
// Of those reductions, 2 * depth are over the tiny (T_g, C) g.
//
// What the design does about it: one C entry launches, on one stream,
//   0. a gather of g, which GA hands over as a strided view, into a
//      contiguous copy, so that every later read of it is coalesced;
//   1. one statistics pass for all 3 * depth k1 ConvNorms of the fusion
//      (the 2 * depth over g are computed once per block, as jobs of the
//      same launch);
//   2. one fusion pass over every scale: each CTA merges its three
//      reductions in a fixed order and writes fused_i (padded, zero pads);
//      the resizes are index arithmetic, not matrices;
//   3. per expansion pair a statistics pass over its three k5 convs and
//      a pass that recomputes them and writes exp_i;
//   4. res_conv as a shared-memory tiled product with fp32 accumulation,
//      bias and residual in its epilogue, pad rows zero.
// 4 + 2 * (depth - 1) launches, deterministic, no atomics.

#include "uconv_common.cuh"

namespace {

using namespace uconv;

struct Norm3 {  // the local, global_act and global_embedding ConvNorms
  const float* w[3];
  const float* gamma[3];
  const float* beta[3];
  const float* part[3];
  int n_part[3];
};

struct FuseJob {
  const void* s;  // first true row of scale i, padded (B, rows, C)
  void* out;      // fused_i, padded (B, rows, C), its row 0
  int T, rows;
  Norm3 n;
};

struct FuseJobs {
  FuseJob j[kMaxDepth];
  const void* g;  // contiguous (B, Tg, C)
  int Tg, n;
};

template <int NT>
__device__ void merge3(const Norm3& nm, int b, float eps, float* s,
                       float (&mean)[3], float (&rstd)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q)
    merge_partials<NT>(nm.part[q] + 3LL * b * nm.n_part[q], nm.n_part[q],
                       eps, s, mean[q], rstd[q]);
}

// grid (row tiles of the finest padded scale, channel tiles, B * depth).
// Every row's loads are issued before any store (see conv_at).
template <typename T>
__global__ void __launch_bounds__(kCh)
fuse_kernel(const __grid_constant__ FuseJobs jobs, int C, float eps) {
  __shared__ float s[3 * kCh];
  const FuseJob& j = jobs.j[blockIdx.z % jobs.n];
  const int b = blockIdx.z / jobs.n;
  const int row0 = blockIdx.x * kRows;
  if (row0 >= j.rows) return;  // uniform in the CTA
  float mean[3], rstd[3];
  merge3<kCh>(j.n, b, eps, s, mean, rstd);
  const int c = blockIdx.y * kCh + threadIdx.x;
  if (c >= C) return;
  float w[3], ga[3], be[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    w[q] = j.n.w[q][c];
    ga[q] = j.n.gamma[q][c] * rstd[q];
    be[q] = j.n.beta[q][c];
  }
  const T* sx = static_cast<const T*>(j.s) + (long long)b * j.rows * C + c;
  const T* gx = static_cast<const T*>(jobs.g) + (long long)b * jobs.Tg * C + c;
  float vals[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = row0 + r - kPad;
    const int tc = min(max(t, 0), j.T - 1);
    const int u = tc * jobs.Tg / j.T;  // T0 <= kMaxT: no overflow
    const float gv = ld(gx + (long long)u * C);
    const float zl = (ld(sx + (long long)tc * C) * w[0] - mean[0]) * ga[0]
                     + be[0];
    const float za = (gv * w[1] - mean[1]) * ga[1] + be[1];
    const float ze = (gv * w[2] - mean[2]) * ga[2] + be[2];
    vals[r] = (t >= 0 && t < j.T) ? zl * sigmoid(za) + ze : 0.f;
  }
  T* out = static_cast<T*>(j.out) + (long long)b * j.rows * C + c;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (row0 + r < j.rows) store(out + (long long)(row0 + r) * C, vals[r]);
}

struct ExpandArgs {
  const void* loc;   // first true row of fused_i, padded (B, rows_l, C)
  const void* glob;  // first true row of x_g, padded (B, rows_g, C)
  void* out;         // exp_i, padded (B, rows_l, C), its row 0
  int T_l, rows_l, T_g, rows_g;
  Norm3 n;           // k5 taps (C, 5)
};

// grid (row tiles of the padded exp_i, channel tiles, B)
template <typename T>
__global__ void __launch_bounds__(kCh)
expand_kernel(const __grid_constant__ ExpandArgs a, int C, float eps) {
  __shared__ float s[3 * kCh];
  const int b = blockIdx.z;
  float mean[3], rstd[3];
  merge3<kCh>(a.n, b, eps, s, mean, rstd);
  const int c = blockIdx.y * kCh + threadIdx.x;
  if (c >= C) return;
  float w[3][5], ga[3], be[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int k = 0; k < 5; ++k) w[q][k] = a.n.w[q][c * 5 + k];
    ga[q] = a.n.gamma[q][c] * rstd[q];
    be[q] = a.n.beta[q][c];
  }
  const T* lx = static_cast<const T*>(a.loc) + (long long)b * a.rows_l * C + c;
  const T* gx = static_cast<const T*>(a.glob) + (long long)b * a.rows_g * C + c;
  const int row0 = blockIdx.x * kRows;
  float vals[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = row0 + r - kPad;
    const int tc = min(max(t, 0), a.T_l - 1);
    const int u = tc * a.T_g / a.T_l;  // T0 <= kMaxT: no overflow
    float yl = 0.f, ya = 0.f, ye = 0.f;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      yl = fmaf(ld(lx + (long long)(tc + k - 2) * C), w[0][k], yl);
      const float xg = ld(gx + (long long)(u + k - 2) * C);
      ya = fmaf(xg, w[1][k], ya);
      ye = fmaf(xg, w[2][k], ye);
    }
    const float zl = (yl - mean[0]) * ga[0] + be[0];
    const float za = (ya - mean[1]) * ga[1] + be[1];
    const float ze = (ye - mean[2]) * ga[2] + be[2];
    vals[r] = (t >= 0 && t < a.T_l) ? zl * sigmoid(za) + ze : 0.f;
  }
  T* out = static_cast<T*>(a.out) + (long long)b * a.rows_l * C + c;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (row0 + r < a.rows_l) store(out + (long long)(row0 + r) * C, vals[r]);
}

// g, any strides -> contiguous (B, Tg, C), through a 32 x 32 tile so that
// both the read and the write are coalesced whichever axis of g is
// innermost. W: a type of the element's size. grid (Tg/32, C/32, B),
// block (32, 8)
template <typename W>
__global__ void gather_g_kernel(const W* __restrict__ g, long long gb,
                                long long gt, long long gc,
                                W* __restrict__ out, int Tg, int C) {
  __shared__ W tile[32][33];
  const int b = blockIdx.z, t0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const bool t_fast = gt == 1;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int t = t0 + (t_fast ? threadIdx.x : i);
    const int c = c0 + (t_fast ? i : threadIdx.x);
    if (t < Tg && c < C)
      tile[t - t0][c - c0] = g[b * gb + t * gt + c * gc];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int t = t0 + i, c = c0 + threadIdx.x;
    if (t < Tg && c < C)
      out[((long long)b * Tg + t) * C + c] = tile[i][threadIdx.x];
  }
}

// Partial-statistics layout, walked the same way by the size query and the
// launch: per scale i, (local over T_i, act over T_g, emb over T_g); per
// expansion pair i = depth-2 .. 0, (local over T_i, act, emb over T_gg).
struct Layout {
  float* fuse[kMaxDepth][3];
  float* expand[kMaxDepth][3];
  long long total;
};

Layout layout(float* base, int B, const int* Ts, int depth, int C) {
  Layout l{};
  long long off = 0;
  auto take = [&](int T) {
    float* p = base == nullptr ? nullptr : base + off;
    off += 3LL * B * conv_tiles(T, C);
    return p;
  };
  const int Tg = Ts[depth - 1];
  for (int i = 0; i < depth; ++i) {
    l.fuse[i][0] = take(Ts[i]);
    l.fuse[i][1] = take(Tg);
    l.fuse[i][2] = take(Tg);
  }
  for (int i = depth - 2; i >= 0; --i) {
    const int T_gg = i == depth - 2 ? Ts[i - 1] : Ts[i + 1];
    l.expand[i][0] = take(Ts[i]);
    l.expand[i][1] = take(T_gg);
    l.expand[i][2] = take(T_gg);
  }
  l.total = off;
  return l;
}

template <typename T>
cudaError_t run(const void* const* scales, const void* g, long long gb,
                long long gt, long long gc, void* gw, const void* x, void* out,
                void* const* fused, void* const* exps, float* partials,
                const float* const* prm, int B, int T0, int C, int Cout,
                int depth, float eps, cudaStream_t stream) {
  int Ts[kMaxDepth];
  scale_lengths(T0, depth, Ts);
  const Layout lay = layout(partials, B, Ts, depth, C);
  const bool bf16 = sizeof(T) == 2;
  const int Tg = Ts[depth - 1];
  const dim3 block(kCh);
  cudaError_t err;
  // prm: per LA (depth fusion, then depth-1 expansion) three ConvNorms of
  // (weight, gamma, beta); then res_conv weight, bias
  auto norm3 = [&](int la, float* const* part, const int* T3) {
    Norm3 n{};
    for (int q = 0; q < 3; ++q) {
      n.w[q] = prm[9 * la + 3 * q];
      n.gamma[q] = prm[9 * la + 3 * q + 1];
      n.beta[q] = prm[9 * la + 3 * q + 2];
      n.part[q] = part[q];
      n.n_part[q] = conv_tiles(T3[q], C);
    }
    return n;
  };
  auto padded_job = [&](const void* buf, int rows, int T_out, int K,
                        const float* w, float* part) {
    ConvJob j{};
    j.x = static_cast<const T*>(buf) + (long long)kPad * C;
    j.sb = (long long)rows * C;
    j.st = C;
    j.sc = 1;
    j.w = w;
    j.partials = part;
    j.T_out = T_out;
    j.K = K;
    j.stride = 1;
    return j;
  };

  // 0. g into a contiguous (B, Tg, C) copy, read coalesced from here on
  const dim3 gg(cdiv(Tg, 32), cdiv(C, 32), B), gblk(32, 8);
  if (bf16)
    gather_g_kernel<unsigned short><<<gg, gblk, 0, stream>>>(
        static_cast<const unsigned short*>(g), gb, gt, gc,
        static_cast<unsigned short*>(gw), Tg, C);
  else
    gather_g_kernel<float><<<gg, gblk, 0, stream>>>(
        static_cast<const float*>(g), gb, gt, gc, static_cast<float*>(gw),
        Tg, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 1. statistics of every fusion ConvNorm: local on scale i, act and emb
  //    on g
  ConvJobs jobs{};
  for (int i = 0; i < depth; ++i) {
    const float* const* p = prm + 9 * i;
    jobs.j[jobs.n++] = padded_job(scales[i], padded_rows(Ts[i]), Ts[i], 1,
                                  p[0], lay.fuse[i][0]);
    for (int q = 1; q < 3; ++q) {
      ConvJob j{};
      j.x = gw;
      j.sb = (long long)Tg * C;
      j.st = C;
      j.sc = 1;
      j.w = p[3 * q];
      j.partials = lay.fuse[i][q];
      j.T_out = Tg;
      j.K = 1;
      j.stride = 1;
      jobs.j[jobs.n++] = j;
    }
  }
  err = launch_conv_stats(jobs, B, C, bf16, stream);
  if (err != cudaSuccess) return err;

  // 2. fusion, every scale in one launch
  FuseJobs fj{};
  fj.g = gw;
  fj.Tg = Tg;
  fj.n = depth;
  for (int i = 0; i < depth; ++i) {
    const int T3[3] = {Ts[i], Tg, Tg};
    FuseJob& j = fj.j[i];
    j.s = static_cast<const T*>(scales[i]) + (long long)kPad * C;
    j.out = fused[i];
    j.T = Ts[i];
    j.rows = padded_rows(Ts[i]);
    j.n = norm3(i, lay.fuse[i], T3);
  }
  fuse_kernel<T><<<dim3(cdiv(padded_rows(T0), kRows), cdiv(C, kCh),
                        B * depth), block, 0, stream>>>(fj, C, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 3. top-down expansion
  for (int i = depth - 2; i >= 0; --i) {
    const bool quirk = i == depth - 2;
    const void* xg = quirk ? fused[i - 1] : exps[i + 1];
    const int T_gg = quirk ? Ts[i - 1] : Ts[i + 1];
    const int rows_l = padded_rows(Ts[i]), rows_g = padded_rows(T_gg);
    const float* const* p = prm + 9 * (depth + i);
    ConvJobs ej{};
    ej.n = 3;
    ej.j[0] = padded_job(fused[i], rows_l, Ts[i], 5, p[0], lay.expand[i][0]);
    ej.j[1] = padded_job(xg, rows_g, T_gg, 5, p[3], lay.expand[i][1]);
    ej.j[2] = padded_job(xg, rows_g, T_gg, 5, p[6], lay.expand[i][2]);
    err = launch_conv_stats(ej, B, C, bf16, stream);
    if (err != cudaSuccess) return err;
    ExpandArgs a{};
    a.loc = ej.j[0].x;
    a.glob = ej.j[1].x;
    a.out = exps[i];
    a.T_l = Ts[i];
    a.rows_l = rows_l;
    a.T_g = T_gg;
    a.rows_g = rows_g;
    const int T3[3] = {Ts[i], T_gg, T_gg};
    a.n = norm3(depth + i, lay.expand[i], T3);
    expand_kernel<T><<<dim3(cdiv(rows_l, kRows), cdiv(C, kCh), B), block, 0,
                       stream>>>(a, C, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  // 4. res_conv + bias + residual over every padded row
  const int rows0 = padded_rows(T0);
  Gemm r{};
  r.a = exps[0];
  r.ab = (long long)rows0 * C;
  r.am = C;
  r.ak = 1;
  r.w = prm[9 * (2 * depth - 1)];
  r.bias = prm[9 * (2 * depth - 1) + 1];
  r.M = rows0;
  r.N = Cout;
  r.K = C;
  r.resid = x;
  r.out = out;
  r.lo = kPad;
  r.hi = kPad + T0;
  return launch_gemm<false>(r, B, bf16, stream);
}

}  // namespace

extern "C" {

// fp32 partial-statistics floats the launch needs for this geometry.
long long uconv_fuse_expand_scratch(int B, int T0, int C, int depth) {
  if (depth < 3 || depth > kMaxDepth) return -1;
  int Ts[kMaxDepth];
  scale_lengths(T0, depth, Ts);
  return layout(nullptr, B, Ts, depth, C).total;
}

// scales: `depth` padded (B, rows_i, C) buffers; g: the post-GA global
// feature, (b, t, c) at g + b*gb + t*gt + c*gc for t < T_g; g_work:
// (B, T_g, C) scratch in the storage type; x, out:
// padded (B, rows_0, Cout); fused: `depth` padded (B, rows_i, C) scratch
// buffers; exps: `depth - 1` padded (B, rows_i, C) scratch buffers;
// partials: uconv_fuse_expand_scratch floats; all activations fp32
// (bf16 == 0) or bf16. prm: 9 * (2 * depth - 1) + 2 fp32 device pointers
// (see run). Returns a cudaError_t, 0 on success.
int uconv_fuse_expand_launch(const void* const* scales, const void* g,
                             long long gb, long long gt, long long gc,
                             void* g_work, const void* x, void* out,
                             void* const* fused, void* const* exps,
                             float* partials,
                             const float* const* prm, int B, int T0, int C,
                             int Cout, int depth, int bf16, float eps,
                             void* stream) {
  if (B < 1 || T0 < 1 || T0 > kMaxT || C < 1 || Cout < 1 || depth < 3 ||
      depth > kMaxDepth || (long long)B * 3 * depth > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? run<__nv_bfloat16>(scales, g, gb, gt, gc, g_work, x, out, fused,
                                exps, partials, prm, B, T0, C, Cout, depth,
                                eps, s)
           : run<float>(scales, g, gb, gt, gc, g_work, x, out, fused, exps,
                        partials, prm, B, T0, C, Cout, depth, eps, s);
  return static_cast<int>(err);
}

}  // extern "C"
