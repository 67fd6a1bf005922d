// Pieces shared by the two UConvBlock kernels (uconv_pyramid.cu,
// uconv_fuse_expand.cu), for Hopper (sm_90a).
//
// Layout. A scale of true length T lives in a padded channels-last buffer
// (B, padded_rows(T), C): true row t at buffer row kPad + t, zero rows
// around it. A k5 tap at row t - 2 of a true row reads a zero pad row and
// needs no bounds test. Channel counts are multiples of 64 (the wrappers
// check it), so a thread moves 16-byte vectors along C: 4 fp32 or 8 bf16
// channels.
//
// GlobLN. Every ConvNorm normalises over a sample's whole (T, C), which is
// megabytes, so many CTAs share a sample. A launch that computes a
// ConvNorm's values writes one (count, mean, M2) part per CTA; the CTA that
// finishes last for a sample (elected by one counter) merges the sample's
// parts in index order and writes the sample's (mean, rstd), which every
// later pass reads as two floats. The counter only elects: the merge order
// is fixed by the part index, so the result is the same bit for bit from
// run to run.
//
// Passes. A pass normalises one ConvNorm over a tile of 128 rows and one
// 64-channel band, and in the same launch computes the statistics of the
// next k5 ConvNorm over the values it has just made: it stages the input
// rows it reads in shared memory (cp.async, no registers), makes its values
// on the tile's rows plus the two-row halo each side that the next taps
// read, keeps them in shared memory, runs the next taps there, and stores
// its own rows. A thread computes 4 channels. The launch boundary is the
// only barrier; no conv output is stored raw.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace uconv {

constexpr int kPad = 8;
constexpr int kMaxDepth = 8;
// Longest input: the resize and pool index products (t * T_other, at most
// T0 * T0 / 2) stay in 32 bits, whose division is far cheaper than 64.
constexpr int kMaxT = 65535;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int padded_rows(int T) {
  return cdiv(T, kPad) * kPad + 2 * kPad;
}

// The stride-2 'same' k5 chain: T_{s+1} = ceil(T_s / 2).
inline void scale_lengths(int T0, int depth, int* Ts) {
  Ts[0] = T0;
  for (int s = 1; s < depth; ++s) Ts[s] = (Ts[s - 1] + 1) / 2;
}

// ---------------------------------------------------------------------------
// Tiles of the conv-family passes
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // a conv-family CTA
constexpr int kBand = 64;      // channels of a tile
constexpr int kHalo = 2;       // rows each side that the next k5 taps read
constexpr int kV = 4;          // channels a thread computes
constexpr int kLanes = kBand / kV, kGroups = kThreads / kLanes;

// A tile of R rows over the padded rows of a scale: padded rows
// [R i, R i + R), true rows from r0 = R i - kPad (even).
__host__ __device__ inline int row_tiles(int T, int R) {
  return cdiv(padded_rows(T), R);
}

// 4 channels: 16 bytes of fp32, 8 of bf16 (global or shared memory).
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = q;
}

// 16 bytes of channels, 4 fp32 or 8 bf16 (the products' epilogues).
__device__ __forceinline__ void st_vec(float* p, const float (&v)[4]) {
  st4(p, v);
}
__device__ __forceinline__ void st_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[4]) {
  ld4(p, v);
}
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
// V fp32 values (parameters) at p, 16-byte aligned.
template <int V>
__device__ __forceinline__ void ld_f32(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}

// The value the storage type keeps: what the next pass will read back.
template <typename T>
__device__ __forceinline__ float keep(float v) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__float2bfloat16(v));
  else
    return v;
}

// The hardware exp2-based exponential and an approximate divide: a few
// instructions per element against some thirty for expf and an IEEE
// divide, at a relative error near 1e-6.
__device__ __forceinline__ float sigmoid(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

// ---------------------------------------------------------------------------
// Reductions in a fixed order
// ---------------------------------------------------------------------------

struct CtaSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// Sum over a CTA (or the NT threads that share sync) in a fixed order;
// every thread gets it. red: NT / 32 floats of shared memory.
template <int NT, typename Sync = CtaSync>
__device__ float block_sum(float v, float* red, Sync sync = Sync{}) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  sync();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[(threadIdx.x % NT) >> 5] = v;
  sync();
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

// Shared memory of a CTA's reductions.
template <int NT>
struct StatSmem {
  float red[2 * (NT / 32)];
};

// Two sums over the NT threads that share sync, in a fixed order (an xor
// butterfly in each warp, then the warps in order); every thread gets them.
template <int NT, typename Sync = CtaSync>
__device__ void block_sum2(float& u, float& v, float* red,
                           Sync sync = Sync{}) {
  for (int o = 16; o > 0; o >>= 1) {
    u += __shfl_xor_sync(0xffffffffu, u, o);
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  sync();  // red may still be read by a previous call
  const int w = (threadIdx.x % NT) >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[w] = u;
    red[NT / 32 + w] = v;
  }
  sync();
  u = red[0];
  v = red[NT / 32];
  for (int i = 1; i < NT / 32; ++i) {
    u += red[i];
    v += red[NT / 32 + i];
  }
}

// A tile's (count, mean, M2) from sums about a value of the tile's data,
// y0 (the same in every thread): s1 = sum(y - y0), s2 = sum((y - y0)^2)
// over its n valid values. One reduction; since y0 is a value of the data,
// no precision goes to a large common offset. Thread 0 writes p[0..2].
template <int NT, typename Sync = CtaSync>
__device__ void tile_part(float s1, float s2, float y0, float n,
                          StatSmem<NT>& sm, float* p, Sync sync = Sync{}) {
  block_sum2<NT>(s1, s2, sm.red, sync);
  if (threadIdx.x % NT == 0) {
    const float d = n > 0.f ? s1 / n : 0.f;
    p[0] = n;
    p[1] = y0 + d;
    p[2] = fmaxf(s2 - s1 * d, 0.f);
  }
}

// One arrival at a counter, with release and acquire semantics at the
// card's scope: the part this thread wrote before is visible to the CTA
// that sees the last ticket. Cheaper than __threadfence() (fence.sc),
// which also waits for every earlier store of the thread.
__device__ __forceinline__ unsigned arrive(unsigned* counter) {
  unsigned ticket;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(ticket)
               : "l"(counter)
               : "memory");
  return ticket;
}
__device__ __forceinline__ void acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// After tile_part: the CTA that arrives last among a sample's n parts
// merges them in index order (lane i of warp 0 takes parts i, i + 32, ...;
// then a shuffle tree) and writes the sample's (mean, 1/sqrt(var + eps))
// to out, and puts the counter back to 0. The counter only elects; it
// orders nothing. Only warp 0 takes part; the other threads go on.
__device__ __forceinline__ void finish(const float* part, int n,
                                       unsigned* counter, float2* out,
                                       float eps) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  unsigned last = 0;
  if (lane == 0) last = arrive(counter) == static_cast<unsigned>(n - 1);
  last = __shfl_sync(0xffffffffu, last, 0);
  if (!last) return;
  acquire();
  float cn = 0.f, cm = 0.f, cq = 0.f;
  for (int i = lane; i < n; i += 32)
    merge(cn, cm, cq, __ldcg(part + 3 * i), __ldcg(part + 3 * i + 1),
          __ldcg(part + 3 * i + 2));
  for (int h = 16; h > 0; h >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, cn, h);
    const float mb = __shfl_down_sync(0xffffffffu, cm, h);
    const float qb = __shfl_down_sync(0xffffffffu, cq, h);
    merge(cn, cm, cq, nb, mb, qb);
  }
  if (lane == 0) {
    *out = make_float2(cm, rsqrtf(cq / cn + eps));
    *counter = 0u;
  }
}

// A pass's own rows (rows kHalo .. kHalo + R - 1 of its values in shared
// memory, vals[row][kBand]) to the padded scale at out (this thread's
// channels, row 0 of the sample), rows below rows_out; after the pass's
// statistics, so that no store is pending when it arrives at a counter.
template <int R, typename T>
__device__ __forceinline__ void store_rows(const T* vals, T* out, int r0,
                                           int rows_out, int C) {
  const int cl = (threadIdx.x % kLanes) * kV;
  for (int j = threadIdx.x / kLanes; j < R; j += kGroups) {
    const int row = r0 + j + kPad;  // padded row of value row j + kHalo
    if (row >= rows_out) break;
    float v[kV];
    ld4(vals + (j + kHalo) * kBand + cl, v);
    st4(out + (long long)row * C, v);
  }
}

// 16 bytes from global to shared memory without registers; zeros where
// !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------------------
// Scratch: the parts, the per-sample statistics and the counters, laid out
// by one walk that the size query and the launch share.
// ---------------------------------------------------------------------------

// A ConvNorm's statistics: parts (B, n, 3), the result (B,) of (mean,
// rstd), counters (B,).
struct Norm {
  float* part;
  float2* stats;
  unsigned* count;
  int n;  // parts per sample
};

// The floats (parts and results) come first, the counters after all of
// them, so that one memset clears every counter. A walk with a null base
// only counts.
struct Scratch {
  float* base;
  unsigned* counter_base;
  int B;
  long long floats = 0;
  long long counters = 0;

  Norm take(int n) {
    Norm m{};
    m.n = n;
    const long long part = floats;
    floats += 3LL * B * n;
    floats += floats & 1;  // float2 alignment
    const long long st = floats;
    floats += 2LL * B;
    if (base != nullptr) {
      m.part = base + part;
      m.stats = reinterpret_cast<float2*>(base + st);
      m.count = counter_base + counters;
    }
    counters += B;
    return m;
  }
  long long total() const { return floats + counters; }
};

// Runs walk(Scratch&) once to count and once on the buffer of total()
// floats at base (16-byte aligned); clears the counters on the stream.
template <typename Walk>
cudaError_t lay_out(float* base, int B, cudaStream_t s, Walk walk) {
  Scratch count{nullptr, nullptr, B};
  walk(count);
  Scratch real{base, reinterpret_cast<unsigned*>(base + count.floats), B};
  walk(real);
  return cudaMemsetAsync(real.counter_base, 0,
                         sizeof(unsigned) * count.counters, s);
}

}  // namespace uconv
