// Per-block reference-window gather for the motion search and chroma MC.
//
// Replaces the TPU kernel x265_tpu/ops/me_win.py:gather_windows_pallas.
//
//   out[b] = src[y0[b] : y0[b] + win, x0[b] : x0[b] + win]
//
// for B windows at arbitrary offsets into an edge-padded reference
// plane. Start indices follow jax.lax.dynamic_slice, the reference
// package's tested form: a negative start counts from the far end
// (numpy's convention), then the start is clamped to [0, H - win] x
// [0, W - win]. The main path only produces in-bounds starts. The TPU
// form fetched a tile-aligned superset by DMA and
// rolled it into place; Hopper needs none of that: one thread block per
// window copies it row by row, neighbouring threads on neighbouring
// output samples, so the writes coalesce and each row of the read is a
// contiguous run.
//
// What bounds it on an H100: writing its output. The source plane
// (2.3 MB luma, 1.2 MB chroma at 1080p after padding) sits in the
// 50 MB L2, while the windows overlap heavily and are written out
// whole: 8160 x 44x44 + 2040 x 60x60 luma and 2 x (8160 x 22x22 +
// 2040 x 30x30) chroma bytes per P frame, about 34.7 MB, which is about
// 10 us at 3.35 TB/s. The design does nothing cleverer than streaming
// those writes; fusing the gather into the integer search, so the
// windows never reach device memory, is the way past that bound.
//
// Interface: plain C entry points bound through ctypes. A call launches
// on the given stream, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clamp_start(int s, int dim, int win) {
  if (s < 0) s += dim;
  return min(max(s, 0), dim - win);
}

template <typename T>
__global__ void gather_windows_kernel(const T* __restrict__ src, int h,
                                      int w, const int32_t* __restrict__ ys,
                                      const int32_t* __restrict__ xs,
                                      int win, T* __restrict__ out) {
  const int b = blockIdx.x;
  const int y0 = clamp_start(ys[b], h, win);
  const int x0 = clamp_start(xs[b], w, win);
  const T* s = src + static_cast<int64_t>(y0) * w + x0;
  T* o = out + static_cast<int64_t>(b) * win * win;
  const int n = win * win;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / win;
    const int c = i - r * win;
    o[i] = s[static_cast<int64_t>(r) * w + c];
  }
}

template <typename T>
int launch(const void* src, int h, int w, const void* ys, const void* xs,
           int b, int win, void* out, void* stream) {
  if (b > 0) {
    gather_windows_kernel<T><<<b, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(src), h, w, static_cast<const int32_t*>(ys),
        static_cast<const int32_t*>(xs), win, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_windows_u8(const void* src, int h, int w,
                                 const void* ys, const void* xs, int b,
                                 int win, void* out, void* stream) {
  return launch<uint8_t>(src, h, w, ys, xs, b, win, out, stream);
}

extern "C" int gather_windows_u16(const void* src, int h, int w,
                                  const void* ys, const void* xs, int b,
                                  int win, void* out, void* stream) {
  return launch<uint16_t>(src, h, w, ys, xs, b, win, out, stream);
}
