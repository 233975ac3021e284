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
// form fetched a tile-aligned superset by DMA and rolled it into place;
// Hopper needs none of that alignment machinery.
//
// What bounds it on an H100: writing its output. The source plane
// (2.3 MB luma, 1.2 MB chroma at 1080p after padding) sits in the
// 50 MB L2, while the windows overlap heavily and are written out
// whole: 8160 x 44x44 + 2040 x 60x60 luma and 2 x (8160 x 22x22 +
// 2040 x 30x30) chroma bytes per P frame, about 34.7 MB, which is about
// 10 us at 3.35 TB/s. The windows are small (484-3600 bytes), so a
// thread block per window leaves most of its threads idle and the card
// waits on block scheduling and one-byte accesses. In this design the
// reads hold it back: an unaligned uint8 word takes two aligned loads,
// one that straddles two rows up to four, so uint8 windows reach a
// smaller share of the bound than uint16 ones (PERF.md).
//
// Design. The kernel is byte-level: a window is `win` rows of
// rowb = win * element-size bytes, so the uint8 and uint16 instances
// are one code path. One warp (a 22 or 30 window) or a few (2 for 44,
// 4 for 60) copy a window, a block of kWarps warps holds several
// windows, and a grid of a few blocks per SM strides over all windows,
// reading the next window's start while it copies the current one. When a window's byte count is a multiple of 4 (every
// main-path shape: 44, 60, 22 and 30 are even) each window of the
// contiguous output starts 4-byte aligned and is written as a flat run
// of 4-byte words, lane k of the warp on word k, so a warp stores 128
// contiguous bytes; a word may straddle two window rows. Each word is
// read as the two aligned source words that hold it, realigned in
// registers with a funnel shift (a straddling word merges two such
// reads under a byte mask, without a branch). The (row, column) of a
// lane's word advances by a constant step per iteration, so the inner
// loop has no division, and a lane issues the reads of kBatch words
// before their stores, so that the loads' latency overlaps.
// Windows of an odd byte count take the same loop with byte units.
// The windows themselves stay in device memory because their consumers
// (csrc/int_search.cu, the sub-pel refinement, chroma MC) read them.
//
// Interface: plain C entry points bound through ctypes. A call launches
// on the given stream, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // windows in flight per block
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 8;         // 8 x 256 threads fill an SM
constexpr int kBatch = 4;               // reads in flight per lane

__device__ __forceinline__ int clamp_start(int s, int dim, int win) {
  if (s < 0) s += dim;
  return min(max(s, 0), dim - win);
}

// The 4 bytes at any address p, read as the aligned word(s) holding
// them. The second word is read only when p is unaligned, and then it
// holds p[3], so no read leaves the words that p[0..3] touch.
__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  const uint32_t sh = static_cast<uint32_t>(a & 3) * 8;
  const uint32_t lo = __ldg(q);
  return sh == 0 ? lo : __funnelshift_r(lo, __ldg(q + 1), sh);
}

// The 4 bytes of a window at row r, byte column c (s: the window's first
// byte). kSplit: rows are not whole words, so a word may hold the last
// m < 4 bytes of row r and the first 4 - m of row r + 1; the two reads
// merge under a byte mask, without a branch.
template <bool kSplit>
__device__ __forceinline__ uint32_t load_word(const uint8_t* s, int r, int c,
                                              int64_t pitch, int rowb) {
  const uint8_t* p = s + r * pitch + c;
  if constexpr (!kSplit) {
    return load4(p);
  } else {
    const int m = rowb - c;
    const bool split = m < 4;
    const uint32_t mask = split ? (1u << (8 * (split ? m : 0))) - 1
                                : 0xffffffffu;
    const uint8_t* p2 = split ? s + (r + 1) * pitch - m : p;
    return (load4(p) & mask) | (load4(p2) & ~mask);
  }
}

// U bytes per lane per step: 4 (word stores) or 1 (odd byte counts).
// A window of `units` units is cut into segments of 32 * kBatch units
// (one batch: each lane issues the reads of kBatch units before their
// stores, so that kBatch reads are in flight per lane). g warps share a
// window, warp j of them on segments j, j + g, ...; a block holds
// kWarps / g windows at a time.
template <int U, bool kSplit>
__global__ void __launch_bounds__(kThreads)
gather_windows_kernel(const uint8_t* __restrict__ src, int h, int w, int es,
                      const int32_t* __restrict__ ys,
                      const int32_t* __restrict__ xs, int nb, int win,
                      int g, uint8_t* __restrict__ out) {
  using Unit = typename std::conditional<U == 4, uint32_t, uint8_t>::type;
  constexpr int kSeg = 32 * kBatch;     // units of a segment
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = warp % g;
  const int64_t pitch = static_cast<int64_t>(w) * es;
  const int rowb = win * es;
  const int units = win * rowb / U;
  // (row, col) of the lane's first unit, of the warp's step of 32
  // units, and of the jump over the other warps' segments
  const int k_first = part * kSeg + lane;
  const int r0 = (U * k_first) / rowb;
  const int c0 = U * k_first - r0 * rowb;
  const int step_r = (32 * U) / rowb;
  const int step_c = 32 * U - step_r * rowb;
  const int jump_r = ((g - 1) * kSeg * U) / rowb;
  const int jump_c = (g - 1) * kSeg * U - jump_r * rowb;
  const int per_block = kWarps / g;
  const int stride = gridDim.x * per_block;
  int b = blockIdx.x * per_block + warp / g;
  // the next window's start is read while the current one is copied
  int ys_next = b < nb ? ys[b] : 0;
  int xs_next = b < nb ? xs[b] : 0;
  for (; b < nb; b += stride) {
    const int y0 = clamp_start(ys_next, h, win);
    const int x0 = clamp_start(xs_next, w, win);
    if (b + stride < nb) {
      ys_next = ys[b + stride];
      xs_next = xs[b + stride];
    }
    const uint8_t* s = src + y0 * pitch + static_cast<int64_t>(x0) * es;
    Unit* o = reinterpret_cast<Unit*>(out + static_cast<int64_t>(b) * win *
                                                rowb);
    int r = r0, c = c0;
    for (int k0 = k_first; k0 < units; k0 += g * kSeg) {
      Unit v[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        if (k0 + 32 * t < units) {
          if constexpr (U == 4) {
            v[t] = load_word<kSplit>(s, r, c, pitch, rowb);
          } else {
            v[t] = s[r * pitch + c];
          }
        }
        c += step_c;
        r += step_r;
        if (c >= rowb) {
          c -= rowb;
          ++r;
        }
      }
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        if (k0 + 32 * t < units) o[k0 + 32 * t] = v[t];
      }
      c += jump_c;
      r += jump_r;
      if (c >= rowb) {
        c -= rowb;
        ++r;
      }
    }
  }
}

int launch(const void* src, int h, int w, int es, const void* ys,
           const void* xs, int b, int win, void* out, void* stream) {
  if (b > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // warps per window: every warp gets at least two segments
    const int unit = (win * win * es) % 4 == 0 ? 4 : 1;
    const int segs = (win * win * es / unit + 32 * kBatch - 1) /
                     (32 * kBatch);
    int g = 1;
    while (2 * g <= kWarps && 2 * g <= segs / 2) g *= 2;
    const int per_block = kWarps / g;
    const int grid = min((b + per_block - 1) / per_block, sms * kBlocksPerSm);
    auto* s = static_cast<const uint8_t*>(src);
    auto* y = static_cast<const int32_t*>(ys);
    auto* x = static_cast<const int32_t*>(xs);
    auto* o = static_cast<uint8_t*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if ((win * es) % 4 == 0) {
      gather_windows_kernel<4, false>
          <<<grid, kThreads, 0, st>>>(s, h, w, es, y, x, b, win, g, o);
    } else if (unit == 4) {
      gather_windows_kernel<4, true>
          <<<grid, kThreads, 0, st>>>(s, h, w, es, y, x, b, win, g, o);
    } else {
      gather_windows_kernel<1, false>
          <<<grid, kThreads, 0, st>>>(s, h, w, es, y, x, b, win, g, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_windows_u8(const void* src, int h, int w,
                                 const void* ys, const void* xs, int b,
                                 int win, void* out, void* stream) {
  return launch(src, h, w, 1, ys, xs, b, win, out, stream);
}

extern "C" int gather_windows_u16(const void* src, int h, int w,
                                  const void* ys, const void* xs, int b,
                                  int win, void* out, void* stream) {
  return launch(src, h, w, 2, ys, xs, b, win, out, stream);
}
