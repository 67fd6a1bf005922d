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
// 8.2 MB in fp32, 36 times an SM's shared memory, and every stage ends in
// a GlobLN over the sample's whole (T_i, C), so each stage needs a
// grid-wide barrier. At B = 24 in bf16 the kernel must move about 114 MB:
// bytes bound it (34 us at 3.35 TB/s; the projection's 6.3 GFLOP take 6 us
// of tensor cores). At B = 1 the work is 10 MB and the dependent launches
// set the floor, a few microseconds each.
//
// What the design does about it: one C entry launches depth + 2 kernels
// on one stream, after one memset of the election counters:
//   1. the projection product (uconv_gemm.cuh: wgmma and TMA in bf16, SIMT
//      in fp32), whose epilogue adds the bias, stores the result in the
//      storage type, as the JAX kernel rounds it (the reference's own
//      numerics, and half the bytes of an fp32 store at bf16), and writes
//      each tile's statistics; the last tile of a sample finalises them;
//   2. a pass over stage 0's tiles that makes the stage input h0 = PReLU(
//      GlobLN(y)) on the tile and its halo in shared memory (h0 is never
//      stored) and writes the statistics of stage 0's conv;
//   3. per stage s, a pass that applies stage s (its conv read from the
//      previous scale, or from y through the projection's norm at s = 0),
//      stores the padded scale (zero pad rows) and writes the statistics
//      of stage s + 1's conv over the values it has just made;
//   4. the last stage's pass sums the pooled global feature for its rows
//      (the earlier scales are complete by then).
// Each (mean, rstd) is finalised once per sample (uconv_common.cuh); the
// passes read two floats of it. Tiles are 128 rows (32 for the pool pass,
// whose rows each walk about 34 rows of the finer scales) x 64 channels,
// their input staged in shared memory 16 bytes a thread. Deterministic: no
// atomics but the counters that elect.

#include "uconv_gemm.cuh"

namespace {

using namespace uconv;

// The fp32 parameter pack, in the wrapper's order: proj bias, gamma, beta
// (C each), the PReLU slope (padded to 4 floats), then per stage the taps
// as (5, C) (tap-major, so a thread's channels of one tap are contiguous),
// bias, gamma, beta.
struct Params {
  const float *pb, *pg, *pbe, *slope;
  const float *taps[kMaxDepth], *bias[kMaxDepth], *gamma[kMaxDepth],
      *beta[kMaxDepth];
};

long long params_floats(int C, int depth) { return 3LL * C + 4 + 8LL * C * depth; }

Params params(const float* p, int C, int depth) {
  Params q{};
  q.pb = p;
  q.pg = p + C;
  q.pbe = p + 2 * C;
  q.slope = p + 3 * C;
  const float* s = p + 3 * C + 4;
  for (int i = 0; i < depth; ++i, s += 8 * C) {
    q.taps[i] = s;
    q.bias[i] = s + 5 * C;
    q.gamma[i] = s + 6 * C;
    q.beta[i] = s + 7 * C;
  }
  return q;
}

// The projection's epilogue: bias, the value the storage type keeps, y
// (B, M, N) over the true rows, and the tile's statistics of those values.
template <typename T>
struct ProjEpi {
  static constexpr bool kStats = true;
  const float* bias;
  T* y;
  int M, N;
  Norm norm;
  float eps;

  template <int W>
  __device__ bool finalize(int, int m, int n, float (&v)[W]) const {
    if (m >= M) return false;
    float b[W];
    ld_f32<W>(bias + n, b);
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = keep<T>(v[j] + b[j]);
    return true;
  }
  template <int W>
  __device__ void store(int b, int m, int n, const float (&v)[W]) const {
    st_vec(y + ((long long)b * M + m) * N + n, v);
  }
  // a value near the tile's data: the bias of its first column
  __device__ float y0(int n0) const { return keep<T>(bias[n0]); }
};

struct StageArgs {
  // the pass's input: y (B, T_in, C) for kIn == 0, else the first true row
  // of a padded scale of rows_in buffer rows; sample stride in elements
  const void* in;
  long long in_sb;
  int T_in, rows_in;
  // the projection's GlobLN + PReLU (kIn == 0)
  const float *pg, *pbe, *slope;
  const float2* pstats;
  // the stage this pass applies (kS > 0), and the padded scale it writes
  const float *taps, *bias, *gamma, *beta;
  const float2* stats;
  void* out;
  int T_out, rows_out;
  // the next stage's conv, whose statistics the pass writes (kNext > 0)
  const float *ntaps, *nbias;
  int T_next;
  Norm next;
  // the pool (kNext == 0): the earlier scales, complete by now
  const void* scale[kMaxDepth];
  int Ts[kMaxDepth], rows[kMaxDepth];
  int n_prev;
  void* pooled;
  int rows_g;
  int C, bands;
  float eps;
};

// Rows of the staged input and of the pass's values for a tile of R rows.
template <int kS, int R>
struct StageShape {
  static constexpr int kVals = R + 2 * kHalo;  // rows r0 - 2 .. r0 + R + 1
  static constexpr int kIn = kS == 0 ? kVals : kS * (kVals - 1) + 5;
  template <typename T>
  static constexpr int smem() {
    return (kIn + (kS > 0 ? kVals : 0)) * kBand * static_cast<int>(sizeof(T));
  }
};

// kIn: 0 = the input is y through the projection's norm and PReLU (h0,
//   never stored), 1 = a padded scale.
// kS: the stride of the stage this pass applies; 0 = none (the pass's
//   values are h0 itself).
// kNext: the stride of the next conv whose statistics the pass writes;
//   0 = none, sum the pooled feature instead.
// R: rows of a tile.
// A CTA stages the input rows its values read (cp.async, 16 bytes a
// thread, zeros outside the input) in shared memory, computes the values
// of its R rows and the halo into shared memory, stores its own rows, and
// runs the next conv over them. A thread computes 4 channels.
// grid (row_tiles(T_out, R) * bands, B): tile = blockIdx.x / bands over the
// padded rows of the pass's values, band = blockIdx.x % bands.
template <typename T, int kIn, int kS, int kNext, int R>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const __grid_constant__ StageArgs a) {
  using Sh = StageShape<kS, R>;
  constexpr int kVec = 16 / sizeof(T);          // elements of 16 bytes
  constexpr int kRowVecs = kBand / kVec;        // 16-byte vectors a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* in_s = reinterpret_cast<T*>(smem_raw);     // [Sh::kIn][kBand]
  T* vals = kS > 0 ? in_s + Sh::kIn * kBand : in_s;  // [Sh::kVals][kBand]
  __shared__ __align__(16) float pp[2][kBand];  // proj gamma * rstd, beta
  __shared__ StatSmem<kThreads> ss;
  const int b = blockIdx.y, band = blockIdx.x % a.bands, C = a.C;
  const int r0 = (blockIdx.x / a.bands) * R - kPad;
  const int c0 = band * kBand;
  const int lane = threadIdx.x % kLanes, grp = threadIdx.x / kLanes;
  const int cl = lane * kV, c = c0 + cl;

  // 1. the input rows f .. f + Sh::kIn - 1 into shared memory
  const int f = kS == 0 ? r0 - kHalo : kS * (r0 - kHalo) - 2;
  const T* in = static_cast<const T*>(a.in) + b * a.in_sb + c0;
  const int lo = kIn == 0 ? 0 : -kPad;
  const int hi = kIn == 0 ? a.T_in : a.rows_in - kPad;
  for (int e = threadIdx.x; e < Sh::kIn * kRowVecs; e += kThreads) {
    const int row = f + e / kRowVecs, v = e % kRowVecs;
    const bool ok = row >= lo && row < hi;
    cp_async16(in_s + (e / kRowVecs) * kBand + v * kVec,
               ok ? in + (long long)row * C + v * kVec : in, ok);
  }
  if constexpr (kIn == 0) {
    if (threadIdx.x < kBand) {
      pp[0][threadIdx.x] = a.pg[c0 + threadIdx.x] * a.pstats[b].y;
      pp[1][threadIdx.x] = a.pbe[c0 + threadIdx.x];
    }
  }
  cp_async_wait_all();
  if constexpr (kIn == 0) {  // h0 = PReLU(GlobLN(y)), zero outside y
    __syncthreads();  // pp
    const float pm = a.pstats[b].x, slope = a.slope[0];
    for (int e = threadIdx.x; e < Sh::kIn * kRowVecs; e += kThreads) {
      const int row = f + e / kRowVecs, v = e % kRowVecs;
      if (row < 0 || row >= a.T_in) continue;
      T* p = in_s + (e / kRowVecs) * kBand + v * kVec;
#pragma unroll
      for (int q = 0; q < kVec; q += 4) {
        float x[4];
        ld4(p + q, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ch = v * kVec + q + j;
          float z = (x[j] - pm) * pp[0][ch] + pp[1][ch];
          x[j] = z >= 0.f ? z : slope * z;
        }
        st4(p + q, x);
      }
    }
  }
  __syncthreads();

  // 2. the pass's values on rows r0 - 2 .. r0 + R + 1 (its own rows are
  // stored after the statistics)
  T* out = static_cast<T*>(a.out) + (long long)b * a.rows_out * C + c;
  if constexpr (kS > 0) {
    float w[5][kV], bias[kV], g[kV], be[kV];
#pragma unroll
    for (int k = 0; k < 5; ++k) ld_f32<kV>(a.taps + k * C + c, w[k]);
    ld_f32<kV>(a.bias + c, bias);
    ld_f32<kV>(a.gamma + c, g);
    ld_f32<kV>(a.beta + c, be);
    const float2 st = a.stats[b];
#pragma unroll
    for (int j = 0; j < kV; ++j) g[j] *= st.y;
#pragma unroll 4
    for (int i = grp; i < Sh::kVals; i += kGroups) {
      const int r = r0 - kHalo + i;
      float acc[kV] = {};
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        float x[kV];
        ld4(in_s + (kS * i + k) * kBand + cl, x);
#pragma unroll
        for (int j = 0; j < kV; ++j) acc[j] = fmaf(x[j], w[k][j], acc[j]);
      }
      const bool ok = r >= 0 && r < a.T_out;
      float v[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j)
        v[j] = ok ? keep<T>((acc[j] + bias[j] - st.x) * g[j] + be[j]) : 0.f;
      st4(vals + i * kBand + cl, v);
    }
    __syncthreads();
  }

  if constexpr (kNext > 0) {
    // 3. the next conv over the values: output row t0 + j reads rows
    // kNext * j .. kNext * j + 4 of vals
    constexpr int NB = R / kNext;
    const int t0 = r0 / kNext;
    float nw[5][kV], nb[kV];
#pragma unroll
    for (int k = 0; k < 5; ++k) ld_f32<kV>(a.ntaps + k * C + c, nw[k]);
    ld_f32<kV>(a.nbias + c, nb);
    // y0: the tile's first valid output at the band's first channel
    const int jv = max(0, -t0);
    float y0 = a.nbias[c0];
    for (int k = 0; k < 5; ++k) {
      float x[kV];
      ld4(vals + (kNext * jv + k) * kBand, x);
      y0 = fmaf(x[0], a.ntaps[k * C + c0], y0);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int j = grp; j < NB; j += kGroups) {
      const int t = t0 + j;
      float acc[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) acc[e] = nb[e];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        float x[kV];
        ld4(vals + (kNext * j + k) * kBand + cl, x);
#pragma unroll
        for (int e = 0; e < kV; ++e) acc[e] = fmaf(x[e], nw[k][e], acc[e]);
      }
      if (t >= 0 && t < a.T_next) {
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const float d = acc[e] - y0;
          s1 += d;
          s2 = fmaf(d, d, s2);
        }
      }
    }
    const int n_rows = max(min(t0 + NB, a.T_next) - max(t0, 0), 0);
    float* p = a.next.part + 3LL * (b * gridDim.x + blockIdx.x);
    tile_part<kThreads>(s1, s2, y0, static_cast<float>(n_rows * kBand), ss,
                        p);
    finish(a.next.part + 3LL * b * gridDim.x, gridDim.x, a.next.count + b,
           a.next.stats + b, a.eps);
    if constexpr (kS > 0) store_rows<R>(vals, out, r0, a.rows_out, C);
  } else {
    store_rows<R>(vals, out, r0, a.rows_out, C);
    // 3. the pooled feature: row i is the sum over the scales of the mean
    // of rows [floor(i T_s / T_g), ceil((i + 1) T_s / T_g)), the coarsest
    // scale's own row last; rows from T_g on are zero
    const int Tg = a.T_out;
    T* pooled = static_cast<T*>(a.pooled) + (long long)b * a.rows_g * C + c;
    for (int j = grp; j < R; j += kGroups) {
      const int i = r0 + j;
      if (i < 0 || i >= a.rows_g) continue;
      float v[kV] = {};
      if (i < Tg) {
        for (int s = 0; s < a.n_prev; ++s) {
          const T* x = static_cast<const T*>(a.scale[s]) +
                       (long long)b * a.rows[s] * C + c;
          const int Ts = a.Ts[s];
          const int t_lo = i * Ts / Tg;  // T0 <= kMaxT: no overflow
          const int t_hi = ((i + 1) * Ts + Tg - 1) / Tg;
          float sum[kV] = {};
#pragma unroll 4
          for (int t = t_lo; t < t_hi; ++t) {
            float x4[kV];
            ld4(x + (long long)t * C, x4);
#pragma unroll
            for (int e = 0; e < kV; ++e) sum[e] += x4[e];
          }
          const float n = static_cast<float>(t_hi - t_lo);
#pragma unroll
          for (int e = 0; e < kV; ++e) v[e] += sum[e] / n;
        }
        float own[kV];
        ld4(vals + (j + kHalo) * kBand + cl, own);
#pragma unroll
        for (int e = 0; e < kV; ++e) v[e] += own[e];
      }
      st4(pooled + (long long)i * C, v);
    }
  }
}

// Rows of a tile: 128 where the pass writes the next conv's statistics
// (fewer CTAs, each with more loads in flight, and one part each); 32 for
// the pool, whose rows each read about 34 rows of the finer scales, so
// that more CTAs share that walk.
constexpr int kStageRows = 128, kPoolRows = 32;

template <typename T, int kIn, int kS, int kNext>
cudaError_t launch_stage(const StageArgs& a, int B, cudaStream_t s) {
  constexpr int R = kNext > 0 ? kStageRows : kPoolRows;
  constexpr int bytes = StageShape<kS, R>::template smem<T>();
  auto kernel = stage_kernel<T, kIn, kS, kNext, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(row_tiles(kS > 0 ? a.T_out : a.T_in, R) * a.bands, B),
           kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

// The parts of the projection's statistics: one per product tile.
int proj_parts(int B, int T0, int C, bool bf16) {
  return bf16 ? mma_tiles(T0, C) : simt_tiles(T0, C, B);
}

struct Norms {
  Norm proj, stage[kMaxDepth];
};

template <typename T>
cudaError_t run(const void* x, long long xb, long long xt, void* const* outs,
                void* pooled, void* y, float* scratch, const float* prm,
                const void* wt, int B, int T0, int Cin, int C, int depth,
                float eps, cudaStream_t stream) {
  constexpr bool bf16 = sizeof(T) == 2;
  int Ts[kMaxDepth];
  scale_lengths(T0, depth, Ts);
  const int bands = C / kBand;
  Norms nm{};
  cudaError_t err = lay_out(scratch, B, stream, [&](Scratch& sc) {
    nm.proj = sc.take(proj_parts(B, T0, C, bf16));
    for (int s = 0; s < depth; ++s)
      nm.stage[s] = sc.take(row_tiles(Ts[s > 0 ? s - 1 : 0], kStageRows) *
                            bands);
  });
  if (err != cudaSuccess) return err;
  const Params p = params(prm, C, depth);

  // 1. the projection product, its bias and statistics
  const Operand op{x, xb, xt, T0, C, Cin};
  const ProjEpi<T> epi{p.pb, static_cast<T*>(y), T0, C, nm.proj, eps};
  if constexpr (bf16)
    err = launch_mma(op, wt, epi, B, stream);
  else
    err = launch_simt_gemm(op, static_cast<const float*>(wt), epi, B, stream);
  if (err != cudaSuccess) return err;

  StageArgs a{};
  a.in = y;
  a.in_sb = (long long)T0 * C;
  a.T_in = T0;
  a.pg = p.pg;
  a.pbe = p.pbe;
  a.slope = p.slope;
  a.pstats = nm.proj.stats;
  a.C = C;
  a.bands = bands;
  a.eps = eps;
  auto next = [&](int s) {  // the pass writes stage s's statistics
    a.ntaps = p.taps[s];
    a.nbias = p.bias[s];
    a.T_next = Ts[s];
    a.next = nm.stage[s];
  };
  auto apply = [&](int s) {  // the pass applies stage s
    a.taps = p.taps[s];
    a.bias = p.bias[s];
    a.gamma = p.gamma[s];
    a.beta = p.beta[s];
    a.stats = nm.stage[s].stats;
    a.out = outs[s];
    a.T_out = Ts[s];
    a.rows_out = padded_rows(Ts[s]);
  };

  // 2. h0 on stage 0's tiles: stage 0's statistics
  next(0);
  err = launch_stage<T, 0, 0, 1>(a, B, stream);
  if (err != cudaSuccess) return err;
  // 3. stage 0 from y, stage 1's statistics
  apply(0);
  next(1);
  err = launch_stage<T, 0, 1, 2>(a, B, stream);
  if (err != cudaSuccess) return err;
  // stages 1 .. depth - 1, each from the previous scale
  for (int s = 1; s < depth; ++s) {
    a.in = static_cast<const T*>(outs[s - 1]) + (long long)kPad * C;
    a.rows_in = padded_rows(Ts[s - 1]);
    a.in_sb = (long long)a.rows_in * C;
    a.T_in = Ts[s - 1];
    apply(s);
    if (s < depth - 1) {
      next(s + 1);
      err = launch_stage<T, 1, 2, 2>(a, B, stream);
    } else {  // 4. with the pool
      for (int i = 0; i < s; ++i) {
        a.scale[i] = static_cast<const T*>(outs[i]) + (long long)kPad * C;
        a.Ts[i] = Ts[i];
        a.rows[i] = padded_rows(Ts[i]);
      }
      a.n_prev = s;
      a.pooled = pooled;
      a.rows_g = padded_rows(Ts[s]) - 2 * kPad;
      err = launch_stage<T, 1, 2, 0>(a, B, stream);
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// fp32 scratch floats (parts, statistics, counters) for this geometry.
long long uconv_pyramid_scratch(int B, int T0, int C, int depth, int bf16) {
  if (B < 1 || T0 < 1 || C < 1 || depth < 1 || depth > kMaxDepth) return -1;
  int Ts[kMaxDepth];
  scale_lengths(T0, depth, Ts);
  Scratch sc{nullptr, nullptr, B};
  sc.take(proj_parts(B, T0, C, bf16 != 0));
  for (int s = 0; s < depth; ++s)
    sc.take(row_tiles(Ts[s > 0 ? s - 1 : 0], kStageRows) * (C / kBand));
  return sc.total();
}

// Floats of the fp32 parameter pack (see Params).
long long uconv_pyramid_params(int C, int depth) {
  return params_floats(C, depth);
}

// x: the block input, element (b, t, k) for true row t at x + b*xb + t*xt
//    + k, fp32 (bf16 == 0) or bf16; outs: `depth` padded (B, rows_i, C)
//    scales; pooled: (B, rows_g, C); y: (B, T0, C) scratch in the storage
//    type; scratch: uconv_pyramid_scratch floats; prm: the parameter pack;
//    wt: the projection weight transposed, (Cin, C) in the storage type.
//    Cin and C are multiples of 64; x, xb, xt, y and wt keep 16-byte
//    alignment. Returns a cudaError_t, 0 on success.
int uconv_pyramid_launch(const void* x, long long xb, long long xt,
                         void* const* outs, void* pooled, void* y,
                         float* scratch, const float* prm, const void* wt,
                         int B, int T0, int Cin, int C, int depth, int bf16,
                         float eps, void* stream) {
  if (B < 1 || B > 65535 || T0 < 1 || T0 > kMaxT || Cin < 64 ||
      Cin % 64 != 0 || C < 64 || C % 64 != 0 || depth < 3 ||
      depth > kMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? run<__nv_bfloat16>(x, xb, xt, outs, pooled, y, scratch, prm, wt,
                                B, T0, Cin, C, depth, eps, s)
           : run<float>(x, xb, xt, outs, pooled, y, scratch, prm, wt, B, T0,
                        Cin, C, depth, eps, s);
  return static_cast<int>(err);
}

}  // extern "C"
