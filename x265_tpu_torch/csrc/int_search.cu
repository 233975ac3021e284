// Integer full search over the gathered reference windows, fused into
// one kernel: candidate SADs, MV-bit penalties and the (cost, index)
// argmin, with no per-candidate tensor in device memory.
//
// Replaces the reference's integer searches x265_tpu/ops/me_win.py:308
// int_search_vec and :350 int_search_vec_pair (jnp code that XLA
// lowers, not a Pallas kernel). Their plain PyTorch versions
// (ops/me_win.py) build one int16 abs-diff tensor per dy row.
//
// For a unit (a 16-region, or an n-block) with window W (s x s bytes,
// gathered at seed - (radius + lead)) and current block C (n x n), the
// candidate (dy, dx) in [0, side)^2 has
//
//   sad  = sum_ij |C[i, j] - W[lead + dy + i, lead + dx + j]|
//   cost = sad + penx[dx] + peny[dy],    index = dy * side + dx
//
// and the result is the lexicographic minimum of (cost, index), with
// (1 << 30, 0) as the starting best: exactly the reference's raster
// loop with strict < across dy rows and a first-index argmin inside a
// row, whatever order the candidates are reduced in. int_search_pair_u8
// searches a 16-region and its four 8-blocks in one pass: the 8-block
// (jj, ii) window is the region window cut at (8 jj, 8 ii), as
// me_all_sizes cuts it, so each 8-block SAD is one quadrant of the
// 16-block sum.
//
// What bounds it on an H100: integer issue. Per 1080p P frame each of
// the two searches takes 921 M absolute differences (8160 regions x
// 441 candidates x 256 px; 2040 32-blocks x 441 x 1024 px) out of
// 16-31 MB of inputs. Design: one block of kThreads threads per unit.
// The block stages the window's searched rows (36 rows of 36 bytes for a
// region, 52 of 52 for a 32-block, at me_range 10) and the unit's
// penalties in shared memory, the rows read as bytes (a window side
// need not be a multiple of 4) and packed 4 to a word, and packs the
// current block 4 pixels to a word. Each thread takes candidates
// (441 = 2 x 224 - 7 at side 21); a candidate row is n/4 + 1 shared
// words realigned in registers with a funnel shift, its SAD taken 4
// bytes at a time (__vsadu4) into register accumulators, and the
// current row is one broadcast shared load for the warp. Each thread keeps its best (cost, index) as one 64-bit key;
// a warp-shuffle min, then a shared-memory min over the block's warps,
// gives the unit's result.
//
// The current plane is int32 and holds 8-bit samples in [0, 255] (the
// source plane, or its weight-compensated copy, which clamps); the
// kernel keeps the low byte of each.
//
// Interface: plain C entry points bound through ctypes. A call launches
// on the given stream, allocates nothing, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 224;
constexpr int kWarps = kThreads / 32;

// One output of a search: (side, nb) penalties, (nb,) results.
struct Out {
  const int32_t* penx;
  const int32_t* peny;
  int nb;
  int32_t* cost;
  int32_t* idx;
};

__device__ __forceinline__ long long key_of(int cost, int idx) {
  return static_cast<long long>(cost) * 4294967296LL + idx;
}

template <int W>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&v)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 t = reinterpret_cast<const uint4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = p[j];
  }
}

// Output o of unit (ry, rx): the pair's 8-block o = 2 jj + ii in the
// raster order of the 8-grid, or the unit itself.
template <bool kPair>
__device__ __forceinline__ int out_index(int o, int u, int ry, int rx,
                                         int bx) {
  if (!kPair || o == 4) return u;
  return (2 * ry + (o >> 1)) * (2 * bx) + 2 * rx + (o & 1);
}

// N: current block size (16 for the pair); kPair: also the four 8-blocks.
template <int N, bool kPair>
__global__ void __launch_bounds__(kThreads)
int_search_kernel(const uint8_t* __restrict__ win, int s, int lead,
                  int side, const int32_t* __restrict__ cur, int cur_w,
                  int bx, Out a, Out b) {
  constexpr int kOut = kPair ? 5 : 1;   // pair: 8-blocks 0-3, region 4
  constexpr int kWords = N / 4;         // words in a current row
  __shared__ __align__(16) uint32_t scur[N * kWords];
  __shared__ long long skey[kOut][kWarps];
  extern __shared__ uint32_t smem[];
  const int rows = N + side - 1;        // searched rows (and columns)
  const int wd = (rows + 3) / 4;        // words in a staged row
  uint32_t* swin = smem;                // rows x wd words, 1 pad word
  int32_t* spx = reinterpret_cast<int32_t*>(smem + rows * wd + 1);
  int32_t* spy = spx + kOut * side;

  const int tid = threadIdx.x;
  const int u = blockIdx.x;
  const int ry = u / bx;
  const int rx = u - ry * bx;

  // byte loads: a searched row starts at any byte offset for any s
  const uint8_t* wsrc = win + static_cast<int64_t>(u) * s * s +
                        static_cast<int64_t>(lead) * s + lead;
  for (int t = tid; t < rows * wd; t += kThreads) {
    const int y = t / wd;
    const int c = 4 * (t - y * wd);
    const uint8_t* p = wsrc + y * s + c;
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < rows) v |= static_cast<uint32_t>(p[k]) << (8 * k);
    swin[t] = v;
  }
  if (tid == 0) swin[rows * wd] = 0;    // read, never used, at sh = 0
  for (int t = tid; t < kOut * side; t += kThreads) {
    const int o = t / side;
    const int d = t - o * side;
    const Out& q = (kPair && o == 4) ? b : a;
    const int bi = out_index<kPair>(o, u, ry, rx, bx);
    spx[t] = q.penx[d * q.nb + bi];
    spy[t] = q.peny[d * q.nb + bi];
  }
  for (int t = tid; t < N * kWords; t += kThreads) {
    const int i = t / kWords;
    const int32_t* p = cur + static_cast<int64_t>(ry * N + i) * cur_w +
                       rx * N + 4 * (t - i * kWords);
    scur[t] = static_cast<uint32_t>(p[0] & 255) |
              static_cast<uint32_t>(p[1] & 255) << 8 |
              static_cast<uint32_t>(p[2] & 255) << 16 |
              static_cast<uint32_t>(p[3] & 255) << 24;
  }
  __syncthreads();

  long long best[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) best[o] = key_of(1 << 30, 0);
  for (int k = tid; k < side * side; k += kThreads) {
    const int dy = k / side;
    const int dx = k - dy * side;
    const uint32_t* wrow = swin + dy * wd + (dx >> 2);
    const uint32_t sh = static_cast<uint32_t>(dx & 3) * 8;
    uint32_t acc[kPair ? 4 : 1] = {};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      uint32_t wv[kWords + 1];
#pragma unroll
      for (int j = 0; j <= kWords; ++j) wv[j] = wrow[i * wd + j];
      uint32_t cv[kWords];
      load_words<kWords>(scur + i * kWords, cv);
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const uint32_t ref = __funnelshift_r(wv[j], wv[j + 1], sh);
        const int q = kPair ? 2 * (i >= N / 2) + (j >= kWords / 2) : 0;
        acc[q] += __vsadu4(ref, cv[j]);
      }
    }
    if constexpr (kPair) {
      int sum = 0;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int sad = static_cast<int>(acc[o]);
        sum += sad;
        best[o] = min(best[o], key_of(sad + spx[o * side + dx] +
                                          spy[o * side + dy], k));
      }
      best[4] = min(best[4], key_of(sum + spx[4 * side + dx] +
                                        spy[4 * side + dy], k));
    } else {
      best[0] = min(best[0], key_of(static_cast<int>(acc[0]) + spx[dx] +
                                        spy[dy], k));
    }
  }

  const int lane = tid & 31;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    long long v = best[o];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v = min(v, __shfl_xor_sync(0xffffffffu, v, d));
    if (lane == 0) skey[o][tid >> 5] = v;
  }
  __syncthreads();
  if (tid < kOut) {
    long long v = skey[tid][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = min(v, skey[tid][w]);
    const Out& q = (kPair && tid == 4) ? b : a;
    const int bi = out_index<kPair>(tid, u, ry, rx, bx);
    q.cost[bi] = static_cast<int32_t>(v >> 32);
    q.idx[bi] = static_cast<int32_t>(v & 0xffffffffLL);
  }
}

template <int N, bool kPair>
int launch(const void* win, int nb, int s, int lead, int side,
           const void* cur, int cur_w, int bx, Out a, Out b, void* stream) {
  if (nb > 0) {
    const int rows = N + side - 1;
    const int wd = (rows + 3) / 4;
    const size_t smem =
        sizeof(uint32_t) * (rows * wd + 1 + 2 * (kPair ? 5 : 1) * side);
    int_search_kernel<N, kPair>
        <<<nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(win), s, lead, side,
            static_cast<const int32_t*>(cur), cur_w, bx, a, b);
  }
  return static_cast<int>(cudaGetLastError());
}

Out out_of(const void* penx, const void* peny, int nb, void* cost,
           void* idx) {
  return Out{static_cast<const int32_t*>(penx),
             static_cast<const int32_t*>(peny), nb,
             static_cast<int32_t*>(cost), static_cast<int32_t*>(idx)};
}

}  // namespace

// A 16-region and its four 8-blocks. win (nb16, s, s) uint8 region
// windows, any s; cur (16 by16, 16 bx16) int32 with row length
// cur_w = 16 bx16; penx8/peny8 (side, 4 nb16), penx16/peny16
// (side, nb16) int32; results (4 nb16,) and (nb16,) int32.
extern "C" int int_search_pair_u8(const void* win, int nb16, int s,
                                  int lead, int side, const void* cur,
                                  int cur_w, int bx16, const void* penx8,
                                  const void* peny8, const void* penx16,
                                  const void* peny16, void* cost8,
                                  void* idx8, void* cost16, void* idx16,
                                  void* stream) {
  return launch<16, true>(win, nb16, s, lead, side, cur, cur_w, bx16,
                          out_of(penx8, peny8, 4 * nb16, cost8, idx8),
                          out_of(penx16, peny16, nb16, cost16, idx16),
                          stream);
}

// 32-blocks. win (nb, s, s) uint8, any s; cur (32 by, 32 bx) int32 with
// row length cur_w = 32 bx; penx/peny (side, nb) int32; results (nb,)
// int32.
extern "C" int int_search_u8(const void* win, int nb, int s, int lead,
                             int side, const void* cur, int cur_w, int bx,
                             const void* penx, const void* peny, void* cost,
                             void* idx, void* stream) {
  const Out a = out_of(penx, peny, nb, cost, idx);
  return launch<32, false>(win, nb, s, lead, side, cur, cur_w, bx, a, a,
                           stream);
}
