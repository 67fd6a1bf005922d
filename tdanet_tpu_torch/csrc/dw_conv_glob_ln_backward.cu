// The backward of the fused depthwise conv + GlobLN (dw_conv_glob_ln.cu),
// for Hopper (sm_90a).
//
// The JAX package has no TPU kernel for it: its trainer differentiates
// the plain ConvNorm (ops.conv1d + ops.glob_ln). The port needs one
// because every depthwise ConvNorm of a TDANet block runs the forward
// kernel (tdanet_tpu/kernels/fused_pyramid.py dw_conv_glob_ln on the
// TPU) on the card, so a training step runs this kernel at every site
// that reaches the loss.
//
// Function. x (B, T, C) in either layout, w (C, K), bias, gamma, the
// forward's per-sample statistics (hi, lo, rstd: mean = hi + lo), and dy
// (B, T_out, C) with the same innermost axis as x:
//   y  = dwconv(x) + bias, recomputed from x as the forward computes it
//   xh = ((y - hi) - lo) * rstd, the forward's normalised value bit for bit
//   dgamma = sum dy * xh, dbeta = sum dy          per channel over B, T_out
//   g = dy * gamma; A = mean(g), M = mean(g * xh) per sample over T_out, C
//   dz = rstd * (g - A - xh * M)
//   dbias = sum dz, dw[c, k] = sum_t dz[t, c] * x[t S + k - P, c]
//   dx = the transposed depthwise conv of dz (stride 1 or 2, P = (K-1)/2)
//
// What bounds it on the H100: bytes. Per output element it does about
// 4K + 14 operations against a read of x and dy and a write of dx; the
// least it can move is those three tensors once, 22 us at the recipe's
// finest site, (8, 3010, 512) bf16, over 3.35 TB/s.
//
// What the design does: one cooperative launch per site, one CTA of 512
// threads an SM, no float atomics, every sum in a fixed order (a rerun is
// equal bit for bit).
//   Tiles: a thread owns RW consecutive output rows of one channel (T
//   innermost: warp = channel, lane = row group, tiles of 32 RW rows x 16
//   channels; C innermost: lane = channel, warp = row group, 16 RW x 32).
//   RW is 8, or 16 at stride 1 where T is innermost (each tile's fixed
//   costs, its windows, halo and stores, spread over twice the rows); the
//   wrapper picks it (kernels/dw_conv_glob_ln.py backward_rows). Tiles
//   are numbered sample by sample, channel tile by channel tile, time
//   tile fastest; CTA j of G owns the run [j N / G, (j+1) N / G). The
//   plan of a launch (make_plan: grid, slots, shared memory, parts) is
//   this file's alone: the wrapper asks for it and the launch recomputes
//   it.
//   Staging: a row of the model's tensor is 2T bytes in bf16, not a
//   multiple of 16 at the recipe's lengths (3010, 1505, 753, ...), so no
//   TMA tensor map takes it and a 16-byte load of a row is misaligned.
//   Each line of a tile (a channel's rows, or a row's channels, with 8
//   rows of halo each side, none for K = 1) is copied as the 16-byte
//   chunks of the aligned span that covers it (cp.async), and read in
//   place: element j of a line sits at j + the line's offset, so the
//   arithmetic loads 16-byte vectors and shifts them (funnel shifts),
//   masking rows outside the tensor only in a window that reaches them.
//   (A bulk TMA copy a line, about 560 bytes, was slower: the issuing
//   threads stalled; an in-place realigning pass cost more than the
//   arithmetic.) Each thread's copies arrive on an mbarrier of the slot
//   (cp.async.mbarrier.arrive.noinc): one a (slot, warp) where T is
//   innermost, since a warp copies, reads and writes only its own
//   channel's lines and the warps then run with no CTA barrier a tile;
//   one a slot, with CTA barriers, where C is.
//   Residency: x and dy are read from device memory once. A CTA keeps
//   its first R tiles, in their storage type, in shared memory from
//   phase 1 to phase 2 (R = its whole run when that fits in 227 KB),
//   and issues all their copies at once; the rest go through a ring of
//   three slots and are loaded again in phase 2, newest first, so that
//   the L2 serves them; the first three of those are issued before the
//   grid barrier.
//   Phase 1: per thread, the sums of g and g * xh over the CTA's tiles of
//     a sample, reduced once per (sample, CTA) (warp shuffles, then the
//     warps in order, in double) into parts (B, G); per channel, dgamma
//     and dbeta in registers over the CTA's tiles of one channel tile,
//     reduced once per (CTA, channel tile) into cparts (G, segs, K + 3,
//     channels of a tile).
//   Grid barrier.
//   Phase 2, the run walked backwards: per sample, A and M from the parts
//     in CTA order; dz of the thread's rows in registers, dbias and dw
//     folded as dgamma above; the dz rows next to them from the
//     neighbouring thread (a shuffle, or shared memory where C is
//     innermost), the tile's halo rows a row a lane; dx into shared
//     memory over the line's x, then stored as 16-byte vectors shifted
//     to the line's alignment, whole chunks at once.
//   Grid barrier.
//   Phase 3: each (channel, quantity) sums its parts over the samples,
//     then the CTAs that own the sample's tiles, in double, a warp an
//     output.
// What still bounds it (H100 timers and ablations): instruction issue,
// not bytes: a T 3010 site, which loads two thirds of its tiles twice,
// costs the same per megabyte as a T 1505 site that keeps all of them;
// the per-sample sums therefore come from the dgamma and dbeta sums
// (gamma is one a channel), and dz is two FMAs. xh is formed as the
// forward forms it, not as one FMA of the conv about a per-channel
// offset: that FMA's rounding grows with the channel's mean over its
// spread and the model's gradients amplified it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_gemm.cuh"  // the mbarrier helpers

namespace cg = cooperative_groups;
using hgemm::mbar_fence_init;
using hgemm::mbar_init;
using hgemm::mbar_wait;
using hgemm::smem_u32;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRing = 3;          // slots of the tiles loaded twice
constexpr int kSlots = 32;        // the most slots a CTA has
constexpr int kSmemMax = 232448;  // dynamic shared memory a CTA may take
constexpr unsigned kFull = 0xffffffffu;

constexpr int round8(int v) { return (v + 7) / 8 * 8; }

// Timing marks between the kernel's steps, for probes/dw_backward_phases.py,
// which builds a copy of this file with them defined; empty here.
#ifndef PHASE_MARK
#define PHASE_MARKS_BEGIN
#define PHASE_MARK(n)
#define PHASE_MARKS_END
#endif

struct Geo {
  int B, T, C, T_out;
  int tiles_t, tiles_c, per_sample, n_tiles;  // n_tiles * G < 2^31
  int max_slots;         // tile slots in a CTA's shared memory
  int segs;              // channel tiles a CTA's run touches, at most
  long long xb, yb, zb;  // sample strides of x, dy and dx
  int xl, yl, zl;        // line strides: C's (T innermost) or T's
  int p_bf16;
};

// The tile, its staged lines and its shared memory, for x's storage TX,
// K taps, stride S, the innermost axis (TC: T) and RW consecutive output
// rows a thread owns (16 only where T is innermost, at stride 1).
template <typename TX, int K, int S, bool TC, int RW>
struct Cfg {
  static constexpr int kRows = RW;
  static constexpr int E = 16 / static_cast<int>(sizeof(TX));  // a chunk
  static constexpr int P = (K - 1) / 2;
  static constexpr int HB = P / S;            // dz rows before a tile
  static constexpr int HA = (S - 1 + P) / S;  // ... and after it
  static constexpr int TT = (TC ? 32 : kWarps) * RW;  // output rows a tile
  static constexpr int TCC = TC ? 16 : 32;    // channels a tile
  static constexpr int FH = K > 1 ? 8 : 0;    // staged rows before t0
  static constexpr int BH = HA > 0 ? 8 : 0;   // ... after t0 + TT
  static constexpr int NY = FH + TT + BH;     // dy rows from t0 - FH
  static constexpr int NX = round8((NY - 1) * S + K);  // x rows from
                                                       // (t0 - FH) S - P
  static constexpr int WX = round8((kRows - 1) * S + K);  // a thread's x
  // a line: 16-byte aligned, one chunk longer than its span (the raw copy)
  static constexpr int SX = TC ? NX : TCC;  // span of an x line
  static constexpr int SY = TC ? NY : TCC;
  static constexpr int LX = TC ? TCC : NX;  // lines
  static constexpr int LY = TC ? TCC : NY;
  static constexpr int PX = SX + E;         // pitches
  static constexpr int PY = SY + E;
  static constexpr int kSlot = (LX * PX + LY * PY) * sizeof(TX);  // bytes
  // shared memory before the slots: the mbarriers that say a slot has
  // landed (one a (slot, warp) where T is innermost: a warp reads only its
  // own channel's lines; one a slot where C is), the per-sample reduction
  // (doubles); where C is innermost also the dz edges and the channel
  // reduction
  static constexpr int kBars = TC ? kSlots * kWarps : kSlots;
  static constexpr int kEdge = TC ? 0 : 2 * (kWarps + 1) * 3 * 32;  // fl.
  static constexpr int kFixed =
      kBars * 8 + 2 * kWarps * 8 + (TC ? 0 : (kEdge + kWarps * 32) * 4);
  static constexpr int Q = K + 3;  // K taps of dw, dbias, dgamma, dbeta
  static_assert((RW == 8 || (RW == 16 && TC && S == 1)) && HB <= 3 &&
                    HA <= 3 && FH >= HB * S &&
                    (TC ? PX >= TT * S + E : LX >= TT * S),
                "tile geometry: halo rows, and room for dx in the x lines");
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_el(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_el(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float ldp(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// An arrival on bar once every cp.async this thread has issued so far
// has landed (bar counts one such arrival a thread).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The E elements of a 16-byte chunk as floats.
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// E floats as a 16-byte chunk of storage.
__device__ __forceinline__ uint4 pack(const float* v, const float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float* v, const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Words WS.. WS + N - 1 of w, each shifted right by f bits into the next
// (f = 0, or 16 for a bf16 element).
template <int WS, int N>
__device__ __forceinline__ void words_at(const uint32_t* w, int f,
                                         uint32_t* out) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    out[i] = __funnelshift_r(w[WS + i], w[WS + i + 1], f);
}

// Elements [sh, sh + NC E) of the NC + 1 chunks c (sh in [0, E)) as NC
// chunks. sh is the same across a warp where it is used (a line's
// offset), so the switch does not diverge.
template <typename TX, int NC>
__device__ __forceinline__ void shifted(const uint4* c, int sh, uint4* out) {
  constexpr int per = 4 / static_cast<int>(sizeof(TX));  // elements a word
  uint32_t w[4 * NC + 4], r[4 * NC];
#pragma unroll
  for (int m = 0; m <= NC; ++m) {
    w[4 * m] = c[m].x;
    w[4 * m + 1] = c[m].y;
    w[4 * m + 2] = c[m].z;
    w[4 * m + 3] = c[m].w;
  }
  const int f = per == 2 ? 16 * (sh & 1) : 0;
  switch (sh / per) {
    case 0: words_at<0, 4 * NC>(w, f, r); break;
    case 1: words_at<1, 4 * NC>(w, f, r); break;
    case 2: words_at<2, 4 * NC>(w, f, r); break;
    default: words_at<3, 4 * NC>(w, f, r); break;
  }
#pragma unroll
  for (int m = 0; m < NC; ++m)
    out[m] = make_uint4(r[4 * m], r[4 * m + 1], r[4 * m + 2], r[4 * m + 3]);
}

// Lines of a tile in device memory and in a slot: line line0 + l (l <
// lines, valid in [0, line_hi)) holds elements s0 + p (p < span, valid in
// [0, s_hi)), contiguous; its raw copy in shared memory, the 16-byte
// chunks that cover the valid span, starts at sm + l * pitch.
template <typename TX>
struct Lines {
  const TX* base;
  long long stride;
  int line0, lines, line_hi;
  int s0, span, s_hi;
  TX* sm;
  int pitch;
};

// The aligned chunks that cover elements [sa, sb) of a line: the first
// one's address and their count.
template <typename TX>
__device__ __forceinline__ int cover(const TX* row, int sa, int sb,
                                     uintptr_t& first) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + sa) & ~uintptr_t(15);
  const uintptr_t z = reinterpret_cast<uintptr_t>(row + sb - 1) & ~uintptr_t(15);
  first = a;
  return static_cast<int>((z - a) / 16) + 1;
}

// Chunks first, first + step, ... of the cover of elements [sa, sb) of a
// line into dst.
template <typename TX>
__device__ __forceinline__ void issue_line(const TX* row, int sa, int sb,
                                           TX* dst, int first, int step) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
  uintptr_t a;
  const int n = cover(row, sa, sb, a);
  for (int m = first; m < n; m += step)
    cp_async16(dst + m * E, reinterpret_cast<const void*>(a + 16 * m));
}

// Issue the 16-byte copies of every valid line's cover into its slot
// line: a warp a line where lines are channels (T innermost), else the
// CTA's threads over (line, chunk).
template <typename TX, bool TC>
__device__ __forceinline__ void issue(const Lines<TX>& L) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
  const int sa = max(L.s0, 0), sb = min(L.s0 + L.span, L.s_hi);
  if (sa >= sb) return;
  if constexpr (TC) {  // L.lines == kWarps, line0 >= 0
    const int l = threadIdx.x >> 5, lam = L.line0 + l;
    if (lam < L.line_hi)
      issue_line(L.base + lam * L.stride, sa, sb, L.sm + l * L.pitch,
                 threadIdx.x & 31, 32);
  } else {
    const int per = L.pitch / E;  // the most chunks a cover has
    for (int e = threadIdx.x; e < L.lines * per; e += kThreads) {
      const int l = e / per, lam = L.line0 + l;
      if (lam >= 0 && lam < L.line_hi)
        issue_line(L.base + lam * L.stride, sa, sb, L.sm + l * L.pitch,
                   e % per, per);
    }
  }
}

// The thread's view of a staged tensor: element j of the staged rows
// (row row0 + j) of its channel, from the raw copy. T innermost: sm is
// the channel's slot line and element j sits at j + off. C innermost: sm
// is the slot, rows pitch apart, element j at j * pitch + ((off + j *
// step) mod E) + cl. Rows outside [0, hi) and a channel past C read 0.
template <typename TX, bool TC>
struct View {
  static constexpr int E = 16 / static_cast<int>(sizeof(TX));
  const TX* sm;
  int pitch, off, step, cl, row0, hi;
  bool ok;

  __device__ __forceinline__ float at(int j) const {
    const int row = row0 + j;
    if (!ok || row < 0 || row >= hi) return 0.f;
    return to_f(TC ? sm[j + off]
                   : sm[j * pitch + ((off + j * step) & (E - 1)) + cl]);
  }

  // Elements [j0, j0 + N), N a multiple of E: T innermost as 16-byte
  // chunks shifted by the line's offset, masked only where the window
  // reaches past the rows.
  template <int N>
  __device__ __forceinline__ void window(int j0, float (&out)[N]) const {
    if constexpr (TC) {
      constexpr int NC = N / E;
      const int p = j0 + off;  // > -E
      const int rc = p >= 0 ? p / E : -1;
      const uint4* c = reinterpret_cast<const uint4*>(sm) + rc;
      uint4 raw[NC + 1], v[NC];
      raw[0] = rc >= 0 ? c[0] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int m = 1; m <= NC; ++m) raw[m] = c[m];
      shifted<TX, NC>(raw, p - rc * E, v);
#pragma unroll
      for (int m = 0; m < NC; ++m) unpack(v[m], out + m * E, sm);
      if (!ok || row0 + j0 < 0 || row0 + j0 + N > hi) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int row = row0 + j0 + i;
          if (!ok || row < 0 || row >= hi) out[i] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = at(j0 + i);
    }
  }
};

// The view of line set L for the thread's channel cl (T innermost: the
// line; C innermost: the slot's rows).
template <typename TX, bool TC>
__device__ __forceinline__ View<TX, TC> view(const Lines<TX>& L, int cl) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
  if constexpr (TC) {  // lines: channels; elements: rows from s0
    const int c = L.line0 + cl, sa = max(L.s0, 0);
    const bool ok = c < L.line_hi;
    const TX* row = L.base + (ok ? c : 0) * L.stride;
    const int o = static_cast<int>(reinterpret_cast<uintptr_t>(row + sa) &
                                   15) / static_cast<int>(sizeof(TX));
    return {L.sm + cl * L.pitch, L.pitch, o - (sa - L.s0), 0, cl, L.s0,
            L.s_hi, ok};
  } else {  // lines: rows from line0; elements: channels from s0 >= 0
    const uintptr_t a = reinterpret_cast<uintptr_t>(L.base + L.s0) +
                        static_cast<uintptr_t>(L.line0 * L.stride *
                                               static_cast<long long>(
                                                   sizeof(TX)));
    const int o = static_cast<int>(a & 15) / static_cast<int>(sizeof(TX));
    return {L.sm, L.pitch, o, static_cast<int>(L.stride & (E - 1)), cl,
            L.line0, L.line_hi, L.s0 + cl < L.s_hi};
  }
}

// Store chunks first, first + step, ... of a line whose elements [s0,
// sb) sit at [0, sb - s0) of src (16-byte aligned), valid elements only:
// a chunk of device memory that is whole as one 16-byte store, shifted
// from two chunks of src; the ragged ends one by one.
template <typename TX>
__device__ __forceinline__ void store_line(TX* row, int s0, int sb,
                                           const TX* src, int first,
                                           int step) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + s0);
  const int o = static_cast<int>(a & 15) / static_cast<int>(sizeof(TX));
  const int n = (o + sb - s0 + E - 1) / E;  // device chunks
  const uint4* c = reinterpret_cast<const uint4*>(src);
  for (int m = first; m < n; m += step) {
    const int s = s0 + m * E - o;  // the chunk's first element
    if (s >= s0 && s + E <= sb) {
      const int p = m * E - o;  // >= 0
      uint4 v;
      shifted<TX, 1>(c + p / E, p % E, &v);
      *reinterpret_cast<uint4*>((a & ~uintptr_t(15)) + 16 * m) = v;
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (s + i >= s0 && s + i < sb) row[s + i] = src[s + i - s0];
    }
  }
}

// Two sums over the CTA in a fixed order (an xor butterfly in each warp
// in double, then the warps in order), written by thread 0 to dst.
// red: 2 * kWarps doubles.
__device__ __forceinline__ void cta_sum2(float u, float v, double* red,
                                         double2* dst) {
  double a = u, b = v;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[kWarps + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0, t = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      s += red[w];
      t += red[kWarps + w];
    }
    *dst = make_double2(s, t);
  }
  __syncthreads();
}

// Each thread's NQ per-channel sums, reduced over the threads of its
// channel in a fixed order (T innermost: the lanes of its warp; C
// innermost: the warps of its lane, through chred) and written as
// quantities q0.. of dst[q * TCC + channel].
template <bool TC, int TCC, int NQ>
__device__ __forceinline__ void flush(const float (&v)[NQ], int q0,
                                      float* dst, float* chred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    if constexpr (TC) {
      float a = v[t];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
      if (lane == 0) dst[(q0 + t) * TCC + warp] = a;
    } else {
      chred[warp * 32 + lane] = v[t];
      __syncthreads();
      if (warp == 0) {
        float a = 0.f;
        for (int w = 0; w < kWarps; ++w) a += chred[w * 32 + lane];
        dst[(q0 + t) * TCC + lane] = a;
      }
      __syncthreads();
    }
  }
}

// The CTA that owns tile i: the largest j with j N / G <= i.
__device__ __forceinline__ int owner(int i, int N, int G) {
  return ((i + 1) * G - 1) / N;
}

template <typename TX, int K, int S, bool TC, int RW>
__global__ void __launch_bounds__(kThreads, 1)
dw_conv_glob_ln_backward_kernel(const TX* __restrict__ x,
                                const TX* __restrict__ dy,
                                const void* __restrict__ w,
                                const void* __restrict__ bias,
                                const void* __restrict__ gamma,
                                const float* __restrict__ stats,
                                TX* __restrict__ dx, float* dw, float* dbias,
                                float* dgamma, float* dbeta, double2* parts,
                                float* cparts, Geo g) {
  using Cf = Cfg<TX, K, S, TC, RW>;
  constexpr int TT = Cf::TT, TCC = Cf::TCC, FH = Cf::FH, HB = Cf::HB,
                HA = Cf::HA, P = Cf::P, Q = Cf::Q, E = Cf::E,
                kRows = Cf::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  double* red = reinterpret_cast<double*>(smem + Cf::kBars * 8);
  float* edge =
      reinterpret_cast<float*>(smem + Cf::kBars * 8 + 2 * kWarps * 8);
  float* chred = edge + Cf::kEdge;
  unsigned char* slots = smem + Cf::kFixed;
  auto slot_x = [&](int s) {
    return reinterpret_cast<TX*>(slots + static_cast<size_t>(s) * Cf::kSlot);
  };
  auto slot_y = [&](int s) { return slot_x(s) + Cf::LX * Cf::PX; };

  const int G = gridDim.x, j = blockIdx.x, N = g.n_tiles;
  PHASE_MARKS_BEGIN
  const int lo = j * N / G, hi = (j + 1) * N / G;  // hi > lo: G <= N
  const int n = hi - lo;
  const int R = n <= g.max_slots ? n : g.max_slots - kRing;  // resident
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = TC ? warp : lane;  // the thread's channel in a tile
  const int q = TC ? lane : warp;   // its rows: 8 q .. 8 q + 7
  const bool first_rows = q == 0, last_rows = q == TT / kRows - 1;
  float* my_parts = cparts + static_cast<size_t>(j) * g.segs * Q * TCC;

  auto box = [&](int i, int& b, int& t0, int& c0) {
    const int r = i % g.per_sample;
    b = i / g.per_sample;
    t0 = (r % g.tiles_t) * TT;
    c0 = (r / g.tiles_t) * TCC;
  };
  auto lines = [&](int b, int t0, int c0, int s, Lines<TX>& X,
                   Lines<TX>& Y) {
    const int rx0 = (t0 - FH) * S - P, ry0 = t0 - FH;
    if constexpr (TC) {
      X = {x + b * g.xb, g.xl, c0, TCC, g.C, rx0, Cf::NX, g.T,
           slot_x(s), Cf::PX};
      Y = {dy + b * g.yb, g.yl, c0, TCC, g.C, ry0, Cf::NY, g.T_out,
           slot_y(s), Cf::PY};
    } else {
      X = {x + b * g.xb, g.xl, rx0, Cf::NX, g.T, c0, TCC, g.C,
           slot_x(s), Cf::PX};
      Y = {dy + b * g.yb, g.yl, ry0, Cf::NY, g.T_out, c0, TCC, g.C,
           slot_y(s), Cf::PY};
    }
  };
  // slot s has landed for this thread: where T is innermost its warp's
  // lines (each warp copies, reads and writes only its own channel's
  // lines of a slot, so a warp's own barrier orders its use of a slot),
  // else the whole slot
  auto bar = [&](int s) { return bars + (TC ? s * kWarps + warp : s); };
  auto sync = [&]() {
    if constexpr (TC)
      __syncwarp();
    else
      __syncthreads();
  };
  auto load = [&](int i, int s) {  // tile i's copies into slot s
    int b, t0, c0;
    box(i, b, t0, c0);
    Lines<TX> X, Y;
    lines(b, t0, c0, s, X, Y);
    issue<TX, TC>(X);
    issue<TX, TC>(Y);
    cp_async_arrive(bar(s));
  };
  unsigned parity = 0;  // bit s: the phase of slot s to wait for next
  auto wait = [&](int s) {
    mbar_wait(bar(s), (parity >> s) & 1);
    parity ^= 1u << s;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.max_slots * (Cf::kBars / kSlots); ++s)
      mbar_init(bars + s, TC ? 32 : kThreads);
    mbar_fence_init();
  }
  __syncthreads();

  // the parameters of the thread's channel and the sample's statistics
  float wk[K] = {}, bs = 0.f, gm = 0.f, shi = 0.f, slo = 0.f, rstd = 0.f;
  auto params = [&](int c0) {
    const int c = c0 + cl;
    const bool ok = c < g.C;
    const int cc = ok ? c : 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      wk[k] = ok ? ldp(w, cc * K + k, g.p_bf16) : 0.f;
    bs = ok && bias != nullptr ? ldp(bias, cc, g.p_bf16) : 0.f;
    gm = ok ? ldp(gamma, cc, g.p_bf16) : 0.f;
  };
  auto sample = [&](int b) {
    shi = stats[3 * b];
    slo = stats[3 * b + 1];
    rstd = stats[3 * b + 2];
  };
  // phase 1: the dgamma and dbeta sums (dy xh and dy), and from them the
  // per-sample ones (g = dy gamma with gamma one a channel: gamma times
  // each, added per thread when its channel tile changes). Every tile
  // that has a slot of its own is loaded at once, and the ring's first
  // three.
  auto slot1 = [&](int k) { return k < R ? k : R + (k - R) % kRing; };
  for (int k = 0; k < min(n, R + kRing); ++k) load(lo + k, slot1(k));
  float s1 = 0.f, s2 = 0.f;
  float pgb[2] = {0.f, 0.f};  // dgamma, dbeta
  int cur_b = -1, cur_grp = -1;
  int b, t0, c0;  // the tile's box, stepped along the run
  box(lo, b, t0, c0);
  for (int k = 0; k < n; ++k) {
    const int i = lo + k;
    const int grp = b * g.tiles_c + c0 / TCC;
    wait(slot1(k));
    sync();  // tile i has landed; the previous tile is done
    PHASE_MARK(0)
    if (k > R && k - 1 + kRing < n)  // into the previous tile's ring slot
      load(i - 1 + kRing, slot1(k - 1));
    PHASE_MARK(1)
    if (grp != cur_grp) {  // a new channel tile (or sample)
      if (cur_grp >= 0) {
        s1 += gm * pgb[1];
        s2 += gm * pgb[0];
        flush<TC, TCC>(pgb, K + 1,
                       my_parts + (cur_grp - lo / g.tiles_t) * Q * TCC,
                       chred);
      }
      if (b != cur_b) {
        if (cur_b >= 0) cta_sum2(s1, s2, red, parts + cur_b * G + j);
        s1 = s2 = 0.f;
        cur_b = b;
        sample(b);
      }
      pgb[0] = pgb[1] = 0.f;
      cur_grp = grp;
      params(c0);
    }
    PHASE_MARK(2)
    Lines<TX> X, Y;
    lines(b, t0, c0, slot1(k), X, Y);
    const View<TX, TC> vx = view<TX, TC>(X, cl), vy = view<TX, TC>(Y, cl);
    float xw[Cf::WX], dv[kRows];
    vx.window((FH + kRows * q) * S, xw);
    vy.window(FH + kRows * q, dv);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {  // rows outside: dy = 0
      float a = 0.f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) a += xw[r * S + kk] * wk[kk];
      const float xh = (((a + bs) - shi) - slo) * rstd;
      pgb[0] += dv[r] * xh;
      pgb[1] += dv[r];
    }
    PHASE_MARK(3)
    if ((t0 += TT) == g.tiles_t * TT) {  // the next tile
      t0 = 0;
      if ((c0 += TCC) == g.tiles_c * TCC) {
        c0 = 0;
        ++b;
      }
    }
  }
  s1 += gm * pgb[1];
  s2 += gm * pgb[0];
  flush<TC, TCC>(pgb, K + 1, my_parts + (cur_grp - lo / g.tiles_t) * Q * TCC,
                 chred);
  cta_sum2(s1, s2, red, parts + cur_b * G + j);

  // the first tiles that phase 2 loads again, ahead of the barrier
  const int again = n - R;
  sync();  // phase 1 is done with the ring
  for (int m = 0; m < min(again, kRing); ++m) load(hi - 1 - m, R + m);
  PHASE_MARK(4)

  cg::this_grid().sync();
  PHASE_MARK(5)

  // phase 2, the run backwards: dz, dbias and dw, dx
  float A = 0.f, M = 0.f;
  float pwb[K + 1];  // dw taps, dbias
  cur_b = cur_grp = -1;
  box(hi - 1, b, t0, c0);
  for (int m = 0; m < n; ++m) {
    const int k = n - 1 - m;
    if (m > 0 && (t0 -= TT) < 0) {  // the previous tile
      t0 = (g.tiles_t - 1) * TT;
      if ((c0 -= TCC) < 0) {
        c0 = (g.tiles_c - 1) * TCC;
        --b;
      }
    }
    const int grp = b * g.tiles_c + c0 / TCC;
    const int s = m < again ? R + m % kRing : k;
    if (m < again) wait(s);
    sync();  // the tile has landed; the previous tile is done
    PHASE_MARK(6)
    if (m >= 1 && m - 1 + kRing < again)  // into the previous tile's slot
      load(hi - 1 - (m - 1 + kRing), R + (m - 1) % kRing);
    if (grp != cur_grp) {  // a new channel tile (or sample)
      if (cur_grp >= 0)
        flush<TC, TCC>(pwb, 0,
                       my_parts + (cur_grp - lo / g.tiles_t) * Q * TCC,
                       chred);
#pragma unroll
      for (int kk = 0; kk <= K; ++kk) pwb[kk] = 0.f;
      cur_grp = grp;
      params(c0);
    }
    if (b != cur_b) {  // A and M: the sample's parts in CTA order
      const int f = b * g.per_sample;
      const int j0 = owner(f, N, G), j1 = owner(f + g.per_sample - 1, N, G);
      double sa = 0.0, sm2 = 0.0;
      for (int jj = j0 + lane; jj <= j1; jj += 32) {
        const double2 p = __ldcg(parts + b * G + jj);
        sa += p.x;
        sm2 += p.y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sa += __shfl_xor_sync(kFull, sa, o);
        sm2 += __shfl_xor_sync(kFull, sm2, o);
      }
      const double cnt = static_cast<double>(g.T_out) * g.C;
      A = static_cast<float>(sa / cnt);
      M = static_cast<float>(sm2 / cnt);
      cur_b = b;
      sample(b);
    }
    // xh as the forward forms it, dz = dy rg - (xh rM + rA)
    const float rg = rstd * gm, rM = rstd * M, rA = rstd * A;
    PHASE_MARK(7)
    Lines<TX> X, Y;
    lines(b, t0, c0, s, X, Y);
    const View<TX, TC> vx = view<TX, TC>(X, cl), vy = view<TX, TC>(Y, cl);
    const bool c_ok = c0 + cl < g.C;
    const int tb = t0 + kRows * q;  // the thread's first output row
    float xw[Cf::WX], dv[kRows], dz[kRows];
    vx.window((FH + kRows * q) * S, xw);
    vy.window(FH + kRows * q, dv);
    const int rows_ok = c_ok ? min(kRows, g.T_out - tb) : 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float a = 0.f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) a += xw[r * S + kk] * wk[kk];
      const float xh = (((a + bs) - shi) - slo) * rstd;
      dz[r] = dv[r] * rg - (xh * rM + rA);
    }
    if (rows_ok < kRows) {  // the ragged last tile, or a channel past C
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r >= rows_ok) dz[r] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      pwb[K] += dz[r];
#pragma unroll
      for (int kk = 0; kk < K; ++kk) pwb[kk] += dz[r] * xw[r * S + kk];
    }
    PHASE_MARK(8)
    // dz of the tile's halo rows (HB before it, HA after it), at dy
    // buffer row jr
    auto halo_dz = [&](int jr) {
      const int t = t0 - FH + jr;
      float a = 0.f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) a += vx.at(jr * S + kk) * wk[kk];
      const float xh = (((a + bs) - shi) - slo) * rstd;
      return c_ok && t >= 0 && t < g.T_out ? vy.at(jr) * rg - (xh * rM + rA)
                                           : 0.f;
    };
    float hz[3] = {0.f, 0.f, 0.f};  // the first row group's before, the
                                    // last's after
    if constexpr (TC && HB + HA > 0) {  // a row a lane, then to lanes 0, 31
      const float h = lane < HB + HA
                          ? halo_dz(lane < HB ? FH - HB + lane
                                              : FH + TT + lane - HB)
                          : 0.f;
#pragma unroll
      for (int r = 0; r < HB + HA; ++r) {
        const float v = __shfl_sync(kFull, h, r);
        if (r < HB && first_rows) hz[r] = v;
        if (r >= HB && last_rows) hz[r - HB] = v;
      }
    } else if constexpr (HB + HA > 0) {  // the edge warps, every lane
      if (first_rows || last_rows) {
        const int nh = first_rows ? HB : HA;
        const int j0 = first_rows ? FH - HB : FH + TT;
#pragma unroll
        for (int r = 0; r < 3; ++r)
          if (r < nh) hz[r] = halo_dz(j0 + r);
      }
    }
    // dz rows [tb - HB, tb + 8 + HA)
    float ext[HB + kRows + HA];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ext[HB + r] = dz[r];
    if constexpr (TC) {
#pragma unroll
      for (int r = 0; r < HB; ++r) {
        const float v = __shfl_up_sync(kFull, dz[kRows - HB + r], 1);
        ext[r] = first_rows ? hz[r] : v;
      }
#pragma unroll
      for (int r = 0; r < HA; ++r) {
        const float v = __shfl_down_sync(kFull, dz[r], 1);
        ext[HB + kRows + r] = last_rows ? hz[r] : v;
      }
      __syncwarp();  // every read of the warp's x line is done
    } else {
      // eF[w + 1]: the last HB rows of warp w, eF[0]: the rows before the
      // tile; eB[w]: the first HA rows of warp w, eB[kWarps]: those after
      float* eF = edge;
      float* eB = edge + (kWarps + 1) * 3 * 32;
#pragma unroll
      for (int r = 0; r < HB; ++r) {
        eF[((warp + 1) * 3 + r) * 32 + lane] = dz[kRows - HB + r];
        if (first_rows) eF[r * 32 + lane] = hz[r];
      }
#pragma unroll
      for (int r = 0; r < HA; ++r) {
        eB[(warp * 3 + r) * 32 + lane] = dz[r];
        if (last_rows) eB[(kWarps * 3 + r) * 32 + lane] = hz[r];
      }
      __syncthreads();  // the edges are written; x is read
#pragma unroll
      for (int r = 0; r < HB; ++r) ext[r] = eF[(warp * 3 + r) * 32 + lane];
#pragma unroll
      for (int r = 0; r < HA; ++r)
        ext[HB + kRows + r] = eB[((warp + 1) * 3 + r) * 32 + lane];
    }
    // dx at input rows [tb S, tb S + 8 S): the taps that land there
    float dxv[kRows * S];
#pragma unroll
    for (int u = 0; u < kRows * S; ++u) {
      float a = 0.f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const int num = u + P - kk;  // = t S for dz row tb + t
        if (((num % S) + S) % S == 0) a += wk[kk] * ext[HB + num / S];
      }
      dxv[u] = a;
    }
    // into the slot's x lines, aligned: input row t0 S + u of line cl at
    // u (T innermost), channel cl of line u at cl
    TX* xs = slot_x(s);
    if constexpr (TC) {
#pragma unroll
      for (int v = 0; v < kRows * S / E; ++v)
        reinterpret_cast<uint4*>(xs + cl * Cf::PX + kRows * q * S)[v] =
            pack(dxv + v * E, xs);
    } else {
#pragma unroll
      for (int u = 0; u < kRows * S; ++u)
        store_el(xs + (kRows * q * S + u) * Cf::PX + cl, dxv[u]);
    }
    PHASE_MARK(9)
    sync();
    TX* zs = dx + b * g.zb;
    if constexpr (TC) {  // a warp a channel's rows
      const int c = c0 + warp;
      if (c < g.C)
        store_line(zs + c * static_cast<long long>(g.zl), t0 * S,
                   min(g.T, (t0 + TT) * S), xs + warp * Cf::PX, lane, 32);
    } else {  // a row's channels, (row, chunk) over the threads
      constexpr int per = (TCC + E - 1) / E + 1;  // device chunks, at most
      for (int e = threadIdx.x; e < TT * S * per; e += kThreads) {
        const int l = e / per, t = t0 * S + l;
        if (t < g.T)
          store_line(zs + t * static_cast<long long>(g.zl), c0,
                     min(g.C, c0 + TCC), xs + l * Cf::PX, e % per, per);
      }
    }
    PHASE_MARK(10)
  }
  flush<TC, TCC>(pwb, 0, my_parts + (cur_grp - lo / g.tiles_t) * Q * TCC,
                 chred);
  PHASE_MARK(11)

  cg::this_grid().sync();
  PHASE_MARK(12)

  // phase 3: a warp a (channel, quantity): lane l sums samples l, l + 32,
  // ..., each over the CTAs that own its tiles in order, in double; then
  // an xor butterfly over the lanes
  const int total = g.tiles_c * Q * TCC;
  for (int e = j * kWarps + warp; e < total; e += G * kWarps) {
    const int ct = e / (Q * TCC), qq = (e / TCC) % Q, c2 = e % TCC;
    const int c = ct * TCC + c2;
    if (c >= g.C) continue;
    double sum = 0.0;
    for (int b = lane; b < g.B; b += 32) {
      const int grp = b * g.tiles_c + ct;
      const int f = grp * g.tiles_t;
      for (int jj = owner(f, N, G); jj <= owner(f + g.tiles_t - 1, N, G);
           ++jj) {
        const int seg = grp - (jj * N / G) / g.tiles_t;
        sum += __ldcg(cparts + ((static_cast<size_t>(jj) * g.segs + seg) *
                                    Q + qq) * TCC + c2);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    if (lane == 0) {
      const float v = static_cast<float>(sum);
      if (qq < K)
        dw[c * K + qq] = v;
      else if (qq == K)
        dbias[c] = v;
      else if (qq == K + 1)
        dgamma[c] = v;
      else
        dbeta[c] = v;
    }
  }
  PHASE_MARK(13)
  PHASE_MARKS_END
}

// The kernel of one instance and its shared-memory layout.
struct Pick {
  const void* fn;
  int tile_t, tile_c, slot, fixed;
};

template <typename TX, int K, int S, bool TC, int RW>
Pick make() {
  using Cf = Cfg<TX, K, S, TC, RW>;
  return {reinterpret_cast<const void*>(
              dw_conv_glob_ln_backward_kernel<TX, K, S, TC, RW>),
          Cf::TT, Cf::TCC, Cf::kSlot, Cf::kFixed};
}

template <typename TX, int S, bool TC, int RW>
Pick pick_k(int K) {
  switch (K) {
    case 1: return make<TX, 1, S, TC, RW>();
    case 3: return make<TX, 3, S, TC, RW>();
    case 5: return make<TX, 5, S, TC, RW>();
    case 7: return make<TX, 7, S, TC, RW>();
  }
  return {nullptr, 0, 0, 0, 0};
}

template <typename TX>
Pick pick_s(int K, int stride, int t_contig, int rows) {
  if (rows == 16)  // T innermost, stride 1 only
    return stride == 1 && t_contig ? pick_k<TX, 1, true, 16>(K)
                                   : Pick{nullptr, 0, 0, 0, 0};
  if (rows != 8) return {nullptr, 0, 0, 0, 0};
  if (stride == 1)
    return t_contig ? pick_k<TX, 1, true, 8>(K) : pick_k<TX, 1, false, 8>(K);
  if (stride == 2)
    return t_contig ? pick_k<TX, 2, true, 8>(K) : pick_k<TX, 2, false, 8>(K);
  return {nullptr, 0, 0, 0, 0};
}

// The instance for x's storage (fp32 or bf16), K in {1, 3, 5, 7}, stride
// in {1, 2}, the innermost axis and the rows a thread owns (8, or 16 at
// stride 1 where T is innermost); fn is null for anything else.
Pick pick(int x_bf16, int K, int stride, int t_contig, int rows) {
  return x_bf16 ? pick_s<__nv_bfloat16>(K, stride, t_contig, rows)
                : pick_s<float>(K, stride, t_contig, rows);
}

// One launch of an instance: its tiles, its grid, and how much of each
// CTA's run stays in shared memory.
struct Plan {
  long long tiles_t, tiles_c, n_tiles;
  int grid;       // min(capacity, n_tiles)
  int max_slots;  // tile slots the fixed part leaves in kSmemMax bytes
  int segs;       // channel tiles one CTA's run touches, at most
  int smem;       // dynamic shared memory: the fixed part and a slot for
                  // each tile of the longest run, up to max_slots
  long long kept;    // tiles kept from phase 1 to phase 2, all CTAs
  long long cparts;  // floats of the per-(CTA, channel tile) sums
};

// The plan for (B, T_out, C) and at most `capacity` CTAs. CTA j of G owns
// tiles [j N / G, (j+1) N / G) and keeps its whole run when it fits in
// max_slots, else max_slots - kRing tiles (the ring takes the rest).
// False where the instance's slots are fewer than the ring's or the
// indices would overflow.
bool make_plan(const Pick& p, int K, int B, int T_out, int C, int capacity,
               Plan& out) {
  Plan q{};
  q.tiles_t = (T_out + p.tile_t - 1) / p.tile_t;
  q.tiles_c = (C + p.tile_c - 1) / p.tile_c;
  q.n_tiles = B * q.tiles_t * q.tiles_c;
  q.grid = static_cast<int>(std::min<long long>(capacity, q.n_tiles));
  q.max_slots = std::min(kSlots, (kSmemMax - p.fixed) / p.slot);
  if (q.grid < 1 || q.max_slots < kRing ||
      (q.n_tiles + 1) * q.grid >= (1LL << 31))
    return false;
  long long longest = 0;
  for (long long j = 0; j < q.grid; ++j) {
    const long long lo = j * q.n_tiles / q.grid;
    const long long hi = (j + 1) * q.n_tiles / q.grid;
    const long long n = hi - lo;
    longest = std::max(longest, n);
    q.segs = static_cast<int>(std::max<long long>(
        q.segs, (hi - 1) / q.tiles_t - lo / q.tiles_t + 1));
    q.kept += n <= q.max_slots ? n : q.max_slots - kRing;
  }
  q.smem = p.fixed + static_cast<int>(std::min<long long>(
                         longest, q.max_slots)) * p.slot;
  q.cparts = static_cast<long long>(q.grid) * q.segs * (K + 3) * p.tile_c;
  out = q;
  return true;
}

}  // namespace

extern "C" {

// The CTAs of the instance the current card holds at once (occupancy at
// the most shared memory x SMs): the largest cooperative grid. A
// negative value is a cudaError_t, negated.
int dw_conv_glob_ln_backward_capacity(int x_bf16, int K, int stride,
                                      int t_contig, int rows) {
  const Pick p = pick(x_bf16, K, stride, t_contig, rows);
  if (p.fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.fn,
                                                        kThreads, kSmemMax);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks * sms;
}

// The plan of a launch of the instance at (B, T_out, C) with at most
// `capacity` CTAs: out[0..10] = output rows and channels a tile, bytes of
// a tile's slot and of the shared memory before the slots, tiles, grid,
// tile slots a CTA holds, channel tiles a CTA's run touches at most,
// dynamic shared memory bytes, tiles kept in shared memory across the
// grid barrier (all CTAs), floats of cparts. Needs no card. Returns a
// cudaError_t.
int dw_conv_glob_ln_backward_plan(int x_bf16, int K, int stride,
                                  int t_contig, int rows, int B, int T_out,
                                  int C, int capacity, long long* out) {
  const Pick p = pick(x_bf16, K, stride, t_contig, rows);
  Plan q;
  if (p.fn == nullptr || B < 1 || T_out < 1 || C < 1 ||
      !make_plan(p, K, B, T_out, C, capacity, q))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long v[] = {p.tile_t, p.tile_c,    p.slot, p.fixed,
                         q.n_tiles, q.grid,     q.max_slots, q.segs,
                         q.smem,   q.kept,      q.cparts};
  std::copy(v, v + 11, out);
  return 0;
}

// x, dx: storage in fp32 (x_bf16 == 0) or bf16, element strides (B, T,
// C); dy: the same storage, strides (B, T_out, C), the same innermost
// axis (T where t_contig); w (C, K), bias (C,) or null, gamma (C,):
// contiguous, fp32 (p_bf16 == 0) or bf16; stats: fp32 (B, 3) (hi, lo,
// rstd) from the forward; dw (C, K), dbias, dgamma, dbeta (C,): fp32
// outputs; parts: (B, grid) double2; cparts: the plan's floats
// (dw_conv_glob_ln_backward_plan with capacity = grid). rows picks the
// instance, grid is at most the instance's capacity. One cooperative
// launch on ``stream``. Returns a cudaError_t, 0 on success.
int dw_conv_glob_ln_backward_launch(
    const void* x, const void* dy, const void* w, const void* bias,
    const void* gamma, const float* stats, void* dx, float* dw, float* dbias,
    float* dgamma, float* dbeta, void* parts, float* cparts, int B, int T,
    int C, int T_out, int K, int stride, long long xb, long long xt,
    long long xc, long long yb, long long yt, long long yc, long long zb,
    long long zt, long long zc, int t_contig, int x_bf16, int p_bf16,
    int rows, int grid, void* stream) {
  const Pick p = pick(x_bf16, K, stride, t_contig, rows);
  Plan q;
  if (p.fn == nullptr || B < 1 || T < 1 || C < 1 ||
      T_out != (T - 1) / stride + 1 ||
      !make_plan(p, K, B, T_out, C, grid, q) || q.grid != grid)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long span = (T - 1) * (xt + zt) + (C - 1) * (xc + zc) +
                         (T_out - 1) * yt + (C - 1) * yc;
  const bool unit = t_contig ? xt == 1 && yt == 1 && zt == 1
                             : xc == 1 && yc == 1 && zc == 1;
  if (span >= (1LL << 31) || !unit || xt < 0 || xc < 0 || yt < 0 ||
      yc < 0 || zt < 0 || zc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geo g{B, T, C, T_out, static_cast<int>(q.tiles_t),
        static_cast<int>(q.tiles_c),
        static_cast<int>(q.tiles_t * q.tiles_c),
        static_cast<int>(q.n_tiles), q.max_slots, q.segs, xb, yb, zb,
        static_cast<int>(t_contig ? xc : xt),
        static_cast<int>(t_contig ? yc : yt),
        static_cast<int>(t_contig ? zc : zt), p_bf16};
  cudaError_t err = cudaFuncSetAttribute(
      p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  double2* pp = static_cast<double2*>(parts);
  void* args[] = {const_cast<void**>(&x), const_cast<void**>(&dy),
                  const_cast<void**>(&w), const_cast<void**>(&bias),
                  const_cast<void**>(&gamma),
                  const_cast<float**>(&stats), &dx, &dw, &dbias, &dgamma,
                  &dbeta, &pp, &cparts, &g};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      p.fn, dim3(grid), dim3(kThreads), args, q.smem,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
