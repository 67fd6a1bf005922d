// The first half of one UConvBlock (inference) for Hopper (sm_90a):
// proj_1x1 (1x1 conv C_out -> C + bias, GlobLN, PReLU), then `depth`
// depthwise k5 conv + bias + GlobLN stages (stride 1, then 2), then the
// adaptive-average-pool sum of every scale at the coarsest length.
//
// Replaces the TPU kernel tdanet_tpu/kernels/uconv_block.py pyramid_fused
// (_pyramid_kernel), which holds one sample's whole pyramid in VMEM and
// makes one HBM pass per tensor.
//
// What bounds it on the H100: at full width (T 2010, C_out 128, C 512,
// depth 5) a sample's scales are (2032+1024+520+272+144) x 512 values,
// 8.2 MB in fp32, 36 times an SM's 227 KB of shared memory, and every
// stage ends in a GlobLN over the sample's whole (T_i, C). So one CTA
// cannot own a sample, and each stage needs a grid-wide barrier. Past
// the projection (0.26 GFLOP a sample) the work is a few flops per byte:
// memory- and L2-bound.
//
// What the design does about it: one C entry launches the stages in
// order on one stream (the launch boundary is the barrier; the host
// does not wait):
//   1. proj product, tiled in shared memory with fp32 accumulation; its
//      epilogue adds the bias, stores raw fp32 and the tile's (n, mean,
//      M2);
//   2. proj normalise: merge the tiles in a fixed order, GlobLN, PReLU,
//      store the padded stage input (zero pad rows);
//   3. per stage: a statistics pass over the conv, then a pass that
//      recomputes the conv, normalises and stores the padded scale
//      (zero pad rows), the input of the next stage;
//   4. pool: each coarse row sums its windows of every scale.
// 3 + 2 * depth launches, deterministic, no atomics (uconv_common.cuh).

#include "uconv_common.cuh"

namespace {

using namespace uconv;

struct Scales {
  const void* p[kMaxDepth];  // first true row of each padded scale
  int T[kMaxDepth];
  int rows[kMaxDepth];
  int depth;
};

// The projection's GlobLN + PReLU: raw fp32 (B, T0, C) -> padded h0.
// grid (row tiles of the padded buffer, channel tiles, B). Every row's
// load is issued before any store (see conv_at).
template <typename T>
__global__ void __launch_bounds__(kCh)
proj_norm_kernel(const float* __restrict__ y, const float* __restrict__ part,
                 int n_part, const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const float* __restrict__ slope, T* __restrict__ h0, int T0,
                 int C, float eps) {
  __shared__ float s[3 * kCh];
  const int b = blockIdx.z;
  float mean, rstd;
  merge_partials<kCh>(part + 3LL * b * n_part, n_part, eps, s, mean, rstd);
  const int c = blockIdx.y * kCh + threadIdx.x;
  if (c >= C) return;
  const int rows = padded_rows(T0), row0 = blockIdx.x * kRows;
  const float g = gamma[c] * rstd, be = beta[c], a = slope[0];
  float vals[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = row0 + r - kPad;
    const int tc = min(max(t, 0), T0 - 1);
    float v = (y[((long long)b * T0 + tc) * C + c] - mean) * g + be;
    v = v >= 0.f ? v : a * v;
    vals[r] = (t >= 0 && t < T0) ? v : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (row0 + r < rows)
      store(h0 + ((long long)b * rows + row0 + r) * C + c, vals[r]);
}

// A stage's second pass: recompute the k5 conv, GlobLN, store the padded
// scale. grid (row tiles of the padded output, channel tiles, B)
template <typename T>
__global__ void __launch_bounds__(kCh)
conv_norm_kernel(const __grid_constant__ ConvJob j,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ out, int C,
                 float eps) {
  __shared__ float s[3 * kCh];
  const int b = blockIdx.z;
  const int n_part = conv_tiles(j.T_out, C);
  float mean, rstd;
  merge_partials<kCh>(j.partials + 3LL * b * n_part, n_part, eps, s, mean,
                      rstd);
  const int c = blockIdx.y * kCh + threadIdx.x;
  if (c >= C) return;
  float w[5];
  load_taps<5>(j.w, c, w);
  const float bias = j.bias[c], g = gamma[c] * rstd, be = beta[c];
  const T* xs = static_cast<const T*>(j.x) + b * j.sb;
  const int rows = padded_rows(j.T_out), row0 = blockIdx.x * kRows;
  float vals[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = row0 + r - kPad;
    const int tc = min(max(t, 0), j.T_out - 1);
    const float v = (conv_at<5>(xs, j, w, tc, c) + bias - mean) * g + be;
    vals[r] = (t >= 0 && t < j.T_out) ? v : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (row0 + r < rows)
      store(out + ((long long)b * rows + row0 + r) * C + c, vals[r]);
}

// pooled[i] = sum over the scales of the mean of rows
// [floor(i*T_s/T_g), ceil((i+1)*T_s/T_g)) (row i itself at the coarsest);
// rows from T_g on are zero. grid (rows of pooled, channel tiles, B)
template <typename T>
__global__ void __launch_bounds__(kCh)
pool_kernel(const __grid_constant__ Scales sc, T* __restrict__ pooled,
            int rows_g, int C) {
  const int b = blockIdx.z, i = blockIdx.x;
  const int c = blockIdx.y * kCh + threadIdx.x;
  if (c >= C) return;
  const int d = sc.depth, Tg = sc.T[d - 1];
  float v = 0.f;
  if (i < Tg) {
    for (int s = 0; s < d; ++s) {
      const T* x = static_cast<const T*>(sc.p[s]) +
                   (long long)b * sc.rows[s] * C + c;
      const int Ts = sc.T[s];
      const int lo = i * Ts / Tg;  // T0 <= kMaxT: no overflow
      const int hi = ((i + 1) * Ts + Tg - 1) / Tg;
      float sum = 0.f;
      for (int t = lo; t < hi; ++t) sum += ld(x + (long long)t * C);
      v += sum / static_cast<float>(hi - lo);
    }
  }
  store(pooled + ((long long)b * rows_g + i) * C + c, v);
}

template <typename T>
cudaError_t run(const void* x, long long xb, long long xt, long long xc,
                void* const* outs, void* pooled, float* y, float* partials,
                void* h0, const float* const* prm, int B, int T0, int Cin,
                int C, int depth, float eps, cudaStream_t stream) {
  int Ts[kMaxDepth];
  scale_lengths(T0, depth, Ts);
  const dim3 block(kCh);
  cudaError_t err;

  // 1. projection product + raw statistics
  Gemm g{};
  g.a = x;
  g.ab = xb;
  g.am = xt;
  g.ak = xc;
  g.w = prm[0];
  g.bias = prm[1];
  g.M = T0;
  g.N = C;
  g.K = Cin;
  g.y = y;
  g.partials = partials;
  err = launch_gemm<true>(g, B, sizeof(T) == 2, stream);
  if (err != cudaSuccess) return err;
  const int n_proj = gemm_tiles(T0, C);
  float* part = partials + 3LL * B * n_proj;

  // 2. projection GlobLN + PReLU into the padded stage input
  const int rows0 = padded_rows(T0);
  proj_norm_kernel<T><<<dim3(cdiv(rows0, kRows), cdiv(C, kCh), B), block, 0,
                        stream>>>(y, partials, n_proj, prm[2], prm[3], prm[4],
                                  static_cast<T*>(h0), T0, C, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 3. the depthwise stages
  Scales sc{};
  sc.depth = depth;
  const T* in = static_cast<const T*>(h0);
  int rows_in = rows0;
  for (int s = 0; s < depth; ++s) {
    const float* const* p = prm + 5 + 4 * s;
    ConvJobs jobs{};
    jobs.n = 1;
    ConvJob& j = jobs.j[0];
    j.x = in + (long long)kPad * C;
    j.sb = (long long)rows_in * C;
    j.st = C;
    j.sc = 1;
    j.w = p[0];
    j.bias = p[1];
    j.partials = part;
    j.T_out = Ts[s];
    j.K = 5;
    j.stride = s == 0 ? 1 : 2;
    err = launch_conv_stats(jobs, B, C, sizeof(T) == 2, stream);
    if (err != cudaSuccess) return err;
    const int rows = padded_rows(Ts[s]);
    T* out = static_cast<T*>(outs[s]);
    conv_norm_kernel<T><<<dim3(cdiv(rows, kRows), cdiv(C, kCh), B), block, 0,
                          stream>>>(j, p[2], p[3], out, C, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    part += 3LL * B * conv_tiles(Ts[s], C);
    sc.p[s] = out + (long long)kPad * C;
    sc.T[s] = Ts[s];
    sc.rows[s] = rows;
    in = out;
    rows_in = rows;
  }

  // 4. the pooled global feature
  const int rows_g = padded_rows(Ts[depth - 1]) - 2 * kPad;
  pool_kernel<T><<<dim3(rows_g, cdiv(C, kCh), B), block, 0, stream>>>(
      sc, static_cast<T*>(pooled), rows_g, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 partial-statistics floats the launch needs for this geometry.
long long uconv_pyramid_scratch(int B, int T0, int C, int depth) {
  if (depth < 1 || depth > kMaxDepth) return -1;
  int Ts[kMaxDepth];
  scale_lengths(T0, depth, Ts);
  long long n = gemm_tiles(T0, C);
  for (int s = 0; s < depth; ++s) n += conv_tiles(Ts[s], C);
  return 3LL * B * n;
}

// x: the block input, element (b, t, k) for true row t at x + b*xb + t*xt
//    + k*xc (model layout or padded rows), fp32 (bf16 == 0) or bf16;
// outs: `depth` padded (B, rows_i, C) scales; pooled: (B, rows_g, C);
// y: fp32 (B, T0, C) scratch; partials: uconv_pyramid_scratch floats;
// h0: padded (B, rows_0, C) scratch in the storage type;
// prm: 5 + 4 * depth fp32 device pointers: proj weight (C, Cin), bias,
//    gamma, beta, PReLU slope (1,), then per stage taps (C, 5), bias,
//    gamma, beta. Returns a cudaError_t, 0 on success.
int uconv_pyramid_launch(const void* x, long long xb, long long xt,
                         long long xc, void* const* outs, void* pooled,
                         float* y, float* partials, void* h0,
                         const float* const* prm, int B, int T0, int Cin,
                         int C, int depth, int bf16, float eps,
                         void* stream) {
  if (B < 1 || B > 65535 || T0 < 1 || T0 > kMaxT || Cin < 1 || C < 1 ||
      depth < 1 ||
      depth > kMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? run<__nv_bfloat16>(x, xb, xt, xc, outs, pooled, y, partials, h0,
                                prm, B, T0, Cin, C, depth, eps, s)
           : run<float>(x, xb, xt, xc, outs, pooled, y, partials, h0, prm, B,
                        T0, Cin, C, depth, eps, s);
  return static_cast<int>(err);
}

}  // extern "C"
