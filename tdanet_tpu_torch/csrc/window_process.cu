// Swin window partition and merge with the cyclic shift fused in, for
// Hopper (sm_90a).
//
// Replaces the two Pallas kernels of tdanet_tpu/kernels/window_process.py:
//   roll_and_window_partition: (B, H, W, C) -> (B*nH*nW, ws, ws, C), the
//     image rolled by -shift along H and W first;
//   window_merge_and_roll: the inverse, rolled by +shift afterwards.
// Each is the other's gradient with the same shift.
//
// Both are permutations of whole channel rows: bytes bound them, and no
// arithmetic is done on the values. The TPU program holds one image in fast
// memory and rolls it there; here one thread moves one vector of up to 16
// bytes, neighbouring threads on neighbouring vectors of a channel row, so
// reads and writes are both contiguous along C and no shared memory is
// needed. A thread walks the window side in order and computes the image
// side's row; partition reads the image and writes the window, merge does
// the reverse through the same index, so the two are exact inverses by
// construction. The kernel knows nothing of the element type: a channel
// row is `row_bytes` bytes, moved in vectors of the widest size that
// divides it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Geometry {
  int H, W, ws, nH, nW, shift;
  int vecs;       // vectors in one channel row
  uint32_t total; // vectors in the tensor
};

// V: uint4 (16 B), uint2 (8), uint32_t (4), uint16_t (2), uint8_t (1).
template <typename V, bool kMerge>
__global__ void __launch_bounds__(kThreads)
window_kernel(const V* __restrict__ src, V* __restrict__ dst,
              const Geometry g) {
  const uint32_t o = blockIdx.x * static_cast<uint32_t>(kThreads) + threadIdx.x;
  if (o >= g.total) return;
  // window side: (((b*nH + wh)*nW + ww)*ws + i)*ws + j)*vecs + v
  uint32_t r = o;
  const uint32_t v = r % g.vecs;
  r /= g.vecs;
  const uint32_t j = r % g.ws;
  r /= g.ws;
  const uint32_t i = r % g.ws;
  r /= g.ws;
  const uint32_t ww = r % g.nW;
  r /= g.nW;
  const uint32_t wh = r % g.nH;
  const uint32_t b = r / g.nH;
  // the rolled image's (h', w') is the image's ((h' + shift) mod H, ...)
  uint32_t h = wh * g.ws + i + g.shift;
  uint32_t w = ww * g.ws + j + g.shift;
  if (h >= static_cast<uint32_t>(g.H)) h -= g.H;
  if (w >= static_cast<uint32_t>(g.W)) w -= g.W;
  const uint32_t p = ((b * g.H + h) * g.W + w) * g.vecs + v;
  if (kMerge)
    dst[p] = src[o];
  else
    dst[o] = src[p];
}

template <typename V>
cudaError_t launch(const void* src, void* dst, const Geometry& g, bool merge,
                   cudaStream_t s) {
  const unsigned blocks = (g.total + kThreads - 1) / kThreads;
  if (merge)
    window_kernel<V, true><<<blocks, kThreads, 0, s>>>(
        static_cast<const V*>(src), static_cast<V*>(dst), g);
  else
    window_kernel<V, false><<<blocks, kThreads, 0, s>>>(
        static_cast<const V*>(src), static_cast<V*>(dst), g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src, dst: contiguous; the image side is (B, H, W, row_bytes), the window
// side (B * (H/ws) * (W/ws), ws, ws, row_bytes). merge == 0: partition
// (src is the image), else merge (src is the windows). vec: the vector's
// bytes (16, 8, 4, 2 or 1); it must divide row_bytes and both pointers.
// Returns a cudaError_t, 0 on success.
int window_process_launch(const void* src, void* dst, int B, int H, int W,
                          long long row_bytes, int ws, int shift, int merge,
                          int vec, void* stream) {
  if (B < 1 || H < 1 || W < 1 || ws < 1 || row_bytes < 1 || H % ws != 0 ||
      W % ws != 0 || shift < 0 || shift >= ws || vec < 1 ||
      row_bytes % vec != 0 ||
      reinterpret_cast<uintptr_t>(src) % vec != 0 ||
      reinterpret_cast<uintptr_t>(dst) % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)B * H * W * (row_bytes / vec);
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.H = H;
  g.W = W;
  g.ws = ws;
  g.nH = H / ws;
  g.nW = W / ws;
  g.shift = shift;
  g.vecs = static_cast<int>(row_bytes / vec);
  g.total = static_cast<uint32_t>(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (vec) {
    case 16: err = launch<uint4>(src, dst, g, merge != 0, s); break;
    case 8: err = launch<uint2>(src, dst, g, merge != 0, s); break;
    case 4: err = launch<uint32_t>(src, dst, g, merge != 0, s); break;
    case 2: err = launch<uint16_t>(src, dst, g, merge != 0, s); break;
    case 1: err = launch<uint8_t>(src, dst, g, merge != 0, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
