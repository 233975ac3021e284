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
// 441 candidates x 256 px; 2040 32-blocks x 441 x 1024 px), one packed
// 4-byte SAD-and-accumulate (__vsadu4, VABSDIFF4) per 4 of them, out of
// 16-31 MB of inputs. So the design spends as few instructions as it
// can on anything but that SAD:
//
// - Register-blocked candidates. A thread owns one dx and R
//   consecutive dy (R chosen per side from a few compiled values; the
//   last group of a side that R does not divide starts at side - R and
//   repeats a few candidates). It walks the window rows dy0 .. dy0 + R
//   + n - 2 once: each row is 5 shared words realigned with 4 funnel
//   shifts, then fed to every one of its R candidates that overlaps it
//   (4 SADs each, each one VABSDIFF4 that accumulates). Shared loads
//   per SAD fall from 1.5 (one candidate per thread) to about
//   (R + n - 1) * 6 / (4 R n), 0.2-0.3, and a row's address is one
//   pointer step (rows r and r + 4 are s words apart, with one shift).
// - The current block in registers. Each current row is one 16-byte
//   shared load, made when the walk reaches it, and stays in registers
//   for the R candidates that use it (a ring of R rows). A 32-block
//   row (8 words) is split between 2 neighbouring lanes, 4 words each;
//   their partial SADs are added with one __shfl_xor_sync before the
//   penalties and the min. The pair search keeps the four quadrant sums
//   of each candidate and folds each half into the 8-block keys as soon
//   as it is complete, so it holds at most 3 sums per candidate.
// - Small blocks striding over groups of units. A group is as many
//   units as fill the block's passes over their threads with under 5%
//   of them idle (one 16-region or one 32-block at side 21); the grid
//   is as many blocks as fit the SMs. A group's windows, current
//   blocks and penalties are copied to shared memory with cp.async (16
//   bytes at a time where the windows are 16-byte aligned, else 4, and
//   bytes for a window that is not 4-byte aligned) into one of two
//   buffers while the previous group is searched, so the copy's
//   latency hides behind the SADs.
// - Exact selection. Each thread keeps the first least cost of each
//   output and its index; two warp reductions over the unit's lanes
//   (REDUX: the least cost, then the least index that has it) and a
//   shared-memory atomicMin of the 64-bit (cost, index) key over the
//   unit's warps, from the start key (1 << 30, 0), give the reference's
//   lexicographic minimum in any order of reduction.
//
// What is left: integer issue. VABSDIFF4, the funnel shifts and the
// index and fold arithmetic share the SM's 64 integer lanes a clock
// (csrc/probes/int_rates.cu measures it), and per window row the walk
// issues 5 shared loads, 4 funnel shifts and a pointer step beside its
// 4 R SADs, and each pair candidate folds 5 keys (PERF.md counts them
// from the SASS and gives the time of each search against its bound).
//
// The current plane is int32 and holds 8-bit samples in [0, 255] (the
// source plane, or its weight-compensated copy, which clamps); the
// kernel keeps the low byte of each.
//
// Interface: plain C entry points bound through ctypes. A call launches
// on the given stream, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSmemDefault = 48 * 1024;  // above this, opt in per kernel
constexpr int kSmemMax = 227 * 1024;

// Threads of a block and blocks per SM: the pair search one warp a
// block, 20 blocks (at most 102 registers a thread), the 32-block
// search two warps, 8 blocks (128 registers). Small blocks wait less
// at their barriers; both timed best among 32-256 threads and 8-20
// blocks on an H100.
__host__ __device__ constexpr int threads_of(bool pair) {
  return pair ? 32 : 64;
}
__host__ __device__ constexpr int min_blocks_of(bool pair) {
  return pair ? 20 : 8;
}

// One output of a search: (side, nb) penalties, (nb,) results.
struct Out {
  const int32_t* penx;
  const int32_t* peny;
  int nb;
  int32_t* cost;
  int32_t* idx;
};

// Shapes of one launch, fixed on the host. A group is `units`
// consecutive units staged together; a unit is searched by `items`
// threads (side x dy groups x lanes). A slot of a staging buffer holds
// one unit: its window (win_bytes: the s x s bytes and a tail that the
// last row's fifth word reads), its n x n int32 current block, and its
// penalties (x then y, each (side, kOut)).
struct Geo {
  int s, lead, side, nb, ngroups, units, items;
  int win_bytes, slot_bytes, off_cur, off_key;
  int cur_w, bx, win_align, cur16;
};

__device__ __forceinline__ long long key_of(int cost, int idx) {
  return static_cast<long long>(cost) * 4294967296LL + idx;
}

// Output o of unit (ry, rx): the pair's 8-block o = 2 jj + ii in the
// raster order of the 8-grid, or the unit itself.
template <bool kPair>
__device__ __forceinline__ int out_index(int o, int u, int ry, int rx,
                                         int bx) {
  if (!kPair || o == 4) return u;
  return (2 * ry + (o >> 1)) * (2 * bx) + 2 * rx + (o & 1);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// d = |a - b| summed over the 4 bytes, plus c: one VABSDIFF4 with its
// accumulator (acc += __vsadu4(a, b) compiles to a SAD into zero and a
// separate add).
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Starts the copies of group gi into the staging buffer buf.
template <int N, bool kPair>
__device__ __forceinline__ void stage(const Geo& g, int gi, uint8_t* buf,
                                      const uint8_t* __restrict__ win,
                                      const int32_t* __restrict__ cur,
                                      const Out& a, const Out& b, int tid) {
  constexpr int kOut = kPair ? 5 : 1;
  constexpr int kThreads = threads_of(kPair);
  const int u0 = gi * g.units;
  const int un = min(g.units, g.nb - u0);
  const int ss = g.s * g.s;
  const int ry0 = u0 / g.bx;
  // windows: un x (s x s) contiguous bytes, copied in the widest unit
  // that their base and size allow (bytes are plain loads and stores,
  // which the barrier before their use makes visible)
  for (int sl = 0; sl < un; ++sl) {
    const uint8_t* src = win + static_cast<int64_t>(u0 + sl) * ss;
    uint8_t* dst = buf + sl * g.slot_bytes;
    if (g.win_align == 16) {
      for (int c = 16 * tid; c < ss; c += 16 * kThreads)
        cp_async<16>(dst + c, src + c);
    } else if (g.win_align == 4) {
      for (int c = 4 * tid; c < ss; c += 4 * kThreads)
        cp_async<4>(dst + c, src + c);
    } else {
      for (int c = tid; c < ss; c += kThreads) dst[c] = src[c];
    }
  }
  // current blocks: n rows of n int32 each; (ry, rx) advance in raster
  int ry = ry0, rx = u0 - ry0 * g.bx;
  for (int sl = 0; sl < un; ++sl) {
    const int32_t* src = cur + static_cast<int64_t>(ry * N) * g.cur_w +
                         rx * N;
    uint8_t* dst = buf + sl * g.slot_bytes + g.win_bytes;
    if (g.cur16) {
      for (int c = tid; c < N * N / 4; c += kThreads) {
        const int i = c / (N / 4), k = c % (N / 4);
        cp_async<16>(dst + 4 * N * i + 16 * k,
                     src + static_cast<int64_t>(i) * g.cur_w + 4 * k);
      }
    } else {
      for (int c = tid; c < N * N; c += kThreads) {
        const int i = c / N, k = c % N;
        cp_async<4>(dst + 4 * N * i + 4 * k,
                    src + static_cast<int64_t>(i) * g.cur_w + k);
      }
    }
    if (++rx == g.bx) rx = 0, ++ry;
  }
  // penalties: x then y, each (side, kOut), element e = (half, d, o)
  const int per = 2 * kOut * g.side;
  for (int e = tid; e < per; e += kThreads) {
    const int half = e >= kOut * g.side;
    const int rem = e - half * kOut * g.side;
    const int d = rem / kOut;
    const int o = rem - d * kOut;
    const bool second = kPair && o == 4;
    const int32_t* pen = half ? (second ? b.peny : a.peny)
                              : (second ? b.penx : a.penx);
    const int32_t* base = pen + static_cast<int64_t>(d) *
                                    (second ? b.nb : a.nb);
    int ry1 = ry0, rx1 = u0 - ry0 * g.bx;
    for (int sl = 0; sl < un; ++sl) {
      const int bi = out_index<kPair>(o, u0 + sl, ry1, rx1, g.bx);
      cp_async<4>(buf + sl * g.slot_bytes + g.win_bytes + 4 * N * N + 4 * e,
                  base + bi);
      if (++rx1 == g.bx) rx1 = 0, ++ry1;
    }
  }
}

// One thread's candidates: dx and the R consecutive dy from dy0 (the
// last group of a side that R does not divide starts at side - R, so
// it repeats candidates of the group before, which cannot change a
// minimum), lane l of kL (its 4 words of each current row). Returns the
// best cost and its index for each output; candidates are met in
// ascending index, so a strict < keeps the first of equal costs.
template <int N, bool kPair, int R>
__device__ __forceinline__ void search_item(
    int item, const Geo& g, const uint8_t* wslot, const uint32_t* cslot,
    const int32_t* spx, const int32_t* spy, int (&bc)[kPair ? 5 : 1],
    int (&bi)[kPair ? 5 : 1]) {
  constexpr int kOut = kPair ? 5 : 1;
  constexpr int kL = kPair ? 1 : 2;     // lanes per candidate
  constexpr int kCW = N / 4;            // words in a current row
  static_assert(kCW == 4 * kL, "a lane takes 4 words of a row");
  const int l = item & (kL - 1);
  const int rest = item / kL;
  const int grp = rest / g.side;
  const int dx = rest - grp * g.side;
  const int dy0 = min(grp * R, g.side - R);
  const uint32_t* crow = cslot + 4 * l;
  // window row dy0 + r starts at byte a0 + r s; 4 s bytes are s words,
  // so rows r, r + 4, r + 8, ... share a shift and a word step
  const int a0 = (g.lead + dy0) * g.s + g.lead + dx + 16 * l;
  const uint32_t* wrow[4];
  uint32_t sh[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int aq = a0 + q * g.s;
    wrow[q] = reinterpret_cast<const uint32_t*>(wslot) + (aq >> 2);
    sh[q] = static_cast<uint32_t>(aq & 3) * 8;
  }
  const int32_t* px = spx + dx * kOut;
  const int32_t* py = spy + dy0 * kOut;
  int bk[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) bc[o] = INT_MAX, bk[o] = 0;
  auto fold = [&](int o, int k, uint32_t sad) {
    const int cost = static_cast<int>(sad) + px[o] + py[k * kOut + o];
    if (cost < bc[o]) bc[o] = cost, bk[o] = k;
  };
  uint32_t c[R][4];                     // ring of current rows
  uint32_t acc[R][kPair ? 4 : 1];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int q = 0; q < (kPair ? 4 : 1); ++q) acc[k][q] = 0;

#pragma unroll
  for (int r = 0; r < R + N - 1; ++r) {
    if (r < N) {
      const uint4 v = *reinterpret_cast<const uint4*>(crow + r * kCW);
      c[r % R][0] = v.x;
      c[r % R][1] = v.y;
      c[r % R][2] = v.z;
      c[r % R][3] = v.w;
    }
    const uint32_t* p = wrow[r & 3];
    wrow[r & 3] = p + g.s;
    uint32_t w[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) w[j] = p[j];
    uint32_t ref[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ref[j] = __funnelshift_r(w[j], w[j + 1], sh[r & 3]);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = r - k;                // current row of candidate k
      if (i < 0 || i >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = kPair ? 2 * (i >= N / 2) + (j >= 2) : 0;
        acc[k][q] = sad4(ref[j], c[i % R][j], acc[k][q]);
      }
      if constexpr (kPair) {
        if (i == N / 2 - 1) {             // top 8-blocks complete
          fold(0, k, acc[k][0]);
          fold(1, k, acc[k][1]);
          acc[k][0] += acc[k][1];         // the top half of the region
        } else if (i == N - 1) {          // bottom ones and the region
          fold(2, k, acc[k][2]);
          fold(3, k, acc[k][3]);
          fold(4, k, acc[k][0] + acc[k][2] + acc[k][3]);
        }
      }
    }
  }
  if constexpr (!kPair) {
    const unsigned pair_mask = 3u << (threadIdx.x & 30);
#pragma unroll
    for (int k = 0; k < R; ++k)
      fold(0, k, acc[k][0] + __shfl_xor_sync(pair_mask, acc[k][0], 1));
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) bi[o] = (dy0 + bk[o]) * g.side + dx;
}

// N: current block size (16 for the pair); kPair: also the four
// 8-blocks; R: dy candidates per thread.
template <int N, bool kPair, int R>
__global__ void __launch_bounds__(threads_of(kPair), min_blocks_of(kPair))
int_search_kernel(const uint8_t* __restrict__ win,
                  const int32_t* __restrict__ cur, Geo g, Out a, Out b) {
  constexpr int kOut = kPair ? 5 : 1;   // pair: 8-blocks 0-3, region 4
  constexpr int kThreads = threads_of(kPair);
  constexpr int kCurWords = N * N / 4;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* scur = reinterpret_cast<uint32_t*>(smem + g.off_cur);
  long long* skey = reinterpret_cast<long long*>(smem + g.off_key);
  const int buf_bytes = g.units * g.slot_bytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the group's units x items threads of work, in passes of the block
  const int passes = (g.units * g.items + kThreads - 1) / kThreads;

  int gi = blockIdx.x;
  stage<N, kPair>(g, gi, smem, win, cur, a, b, tid);
  cp_async_commit();
  for (int it = 0; gi < g.ngroups; gi += gridDim.x, ++it) {
    uint8_t* buf = smem + (it & 1) * buf_bytes;
    const int next = gi + gridDim.x;
    if (next < g.ngroups)
      stage<N, kPair>(g, next, smem + ((it + 1) & 1) * buf_bytes, win, cur,
                      a, b, tid);
    cp_async_commit();
    cp_async_wait_prev();               // this group's copies are done
    __syncthreads();

    const int u0 = gi * g.units;
    const int un = min(g.units, g.nb - u0);
    // current blocks, low bytes packed 4 to a word; start keys
    for (int sl = 0; sl < un; ++sl) {
      const int4* src = reinterpret_cast<const int4*>(
          buf + sl * g.slot_bytes + g.win_bytes);
      for (int t = tid; t < kCurWords; t += kThreads) {
        const int4 v = src[t];
        scur[sl * kCurWords + t] = static_cast<uint32_t>(v.x & 255) |
                                   static_cast<uint32_t>(v.y & 255) << 8 |
                                   static_cast<uint32_t>(v.z & 255) << 16 |
                                   static_cast<uint32_t>(v.w & 255) << 24;
      }
    }
    for (int t = tid; t < un * kOut; t += kThreads)
      skey[t] = key_of(1 << 30, 0);
    __syncthreads();

    for (int m = 0; m < passes; ++m) {
      const int t = tid + m * kThreads;
      const int slot = t / g.items;     // a unit's threads are consecutive
      const int item = t - slot * g.items;
      int bc[kOut], bi[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o) bc[o] = INT_MAX, bi[o] = INT_MAX;
      if (slot < un) {
        const uint8_t* sb = buf + slot * g.slot_bytes;
        const int32_t* spx =
            reinterpret_cast<const int32_t*>(sb + g.win_bytes + 4 * N * N);
        search_item<N, kPair, R>(item, g, sb, scur + slot * kCurWords, spx,
                                 spx + kOut * g.side, bc, bi);
      }
      // min over the unit's lanes of this warp (least cost, then least
      // index among the lanes that have it), then over its warps
      const unsigned seg = __match_any_sync(0xffffffffu, slot);
      const bool head = slot < un && lane == __ffs(seg) - 1;
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const int mc = __reduce_min_sync(seg, bc[o]);
        const unsigned mi = __reduce_min_sync(
            seg, bc[o] == mc ? static_cast<unsigned>(bi[o]) : UINT_MAX);
        if (head) atomicMin(&skey[slot * kOut + o],
                            key_of(mc, static_cast<int>(mi)));
      }
    }
    __syncthreads();

    for (int t = tid; t < un * kOut; t += kThreads) {
      const int sl = t / kOut;
      const int o = t - sl * kOut;
      const int u = u0 + sl;
      const int ry = u / g.bx;
      const int rx = u - ry * g.bx;
      const bool second = kPair && o == 4;
      const int bi = out_index<kPair>(o, u, ry, rx, g.bx);
      const long long v = skey[t];
      (second ? b.cost : a.cost)[bi] = static_cast<int32_t>(v >> 32);
      (second ? b.idx : a.idx)[bi] = static_cast<int32_t>(v & 0xffffffffLL);
    }
  }
}

int round16(int x) { return (x + 15) & ~15; }

template <int N, bool kPair, int R>
int run(const void* win, int nb, int s, int lead, int side, const void* cur,
        int cur_w, int bx, Out a, Out b, cudaStream_t stream) {
  constexpr int kOut = kPair ? 5 : 1;
  constexpr int kL = kPair ? 1 : 2;
  constexpr int kThreads = threads_of(kPair);
  const int groups_dy = (side + R - 1) / R;
  Geo g{};
  g.s = s;
  g.lead = lead;
  g.side = side;
  g.nb = nb;
  g.items = side * groups_dy * kL;
  g.win_bytes = round16(s * s + 16);    // + the last row's fifth word
  g.slot_bytes = g.win_bytes + 4 * N * N + round16(4 * 2 * kOut * side);
  // units per group: the fewest that leave under 5% of the passes'
  // threads idle, within the shared memory of one of min_blocks_of
  // blocks on an SM
  const int per_unit = 2 * g.slot_bytes + N * N + 8 * kOut;
  const int max_units =
      max(1, min(nb, kSmemMax / min_blocks_of(kPair) / per_unit));
  int units = 1;
  long long best_idle = LLONG_MAX, best_work = 1;
  for (int u = 1; u <= max_units; ++u) {
    const long long work = static_cast<long long>(u) * g.items;
    const long long idle =
        (work + kThreads - 1) / kThreads * kThreads - work;
    if (idle * best_work < best_idle * work)
      units = u, best_idle = idle, best_work = work;
    if (idle * 20 < work) break;
  }
  g.units = units;
  g.ngroups = (nb + units - 1) / units;
  g.off_cur = 2 * units * g.slot_bytes;
  g.off_key = g.off_cur + round16(units * N * N);
  const int smem = g.off_key + 8 * kOut * units;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  g.cur_w = cur_w;
  g.bx = bx;
  const uintptr_t win_addr = reinterpret_cast<uintptr_t>(win);
  g.win_align = win_addr % 16 == 0 && (s * s) % 16 == 0 ? 16
                : win_addr % 4 == 0 && (s * s) % 4 == 0 ? 4 : 1;
  g.cur16 = (reinterpret_cast<uintptr_t>(cur) % 16 == 0) && cur_w % 4 == 0;

  auto* kernel = int_search_kernel<N, kPair, R>;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const int grid = min(g.ngroups, max(1, per_sm) * sms);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(win), static_cast<const int32_t*>(cur), g,
      a, b);
  return static_cast<int>(cudaGetLastError());
}

// The R of a side, among the compiled values no larger than the side
// (1 always is): the least integer instructions per dx, counting per dy
// group R candidates of n^2/4 SADs and their folds (kPair: 5 keys and
// the halves' sums, about 21 instructions; else about 6) and R + n - 1
// window rows of 5 (4 funnel shifts and a pointer step) per lane.
int pick_r(const int (&rs)[4], int n, bool pair, int side) {
  const int lanes = pair ? 1 : 2;
  const long long fold = pair ? 21 : 6;
  int best = 1;
  long long best_cost = LLONG_MAX;
  for (int r : rs) {
    if (r > side) continue;
    const long long groups = (side + r - 1) / r;
    const long long cost =
        groups * (r * (n * n / 4 + fold) + (r + n - 1) * lanes * 5);
    if (cost < best_cost) best = r, best_cost = cost;
  }
  return best;
}

constexpr int kPairR[4] = {1, 5, 6, 7};
constexpr int kSingleR[4] = {1, 5, 7, 13};

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
  if (nb16 <= 0) return static_cast<int>(cudaGetLastError());
  const Out a = out_of(penx8, peny8, 4 * nb16, cost8, idx8);
  const Out b = out_of(penx16, peny16, nb16, cost16, idx16);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (pick_r(kPairR, 16, true, side)) {
    case 1:
      return run<16, true, 1>(win, nb16, s, lead, side, cur, cur_w, bx16, a,
                              b, st);
    case 5:
      return run<16, true, 5>(win, nb16, s, lead, side, cur, cur_w, bx16, a,
                              b, st);
    case 6:
      return run<16, true, 6>(win, nb16, s, lead, side, cur, cur_w, bx16, a,
                              b, st);
    default:
      return run<16, true, 7>(win, nb16, s, lead, side, cur, cur_w, bx16, a,
                              b, st);
  }
}

// 32-blocks. win (nb, s, s) uint8, any s; cur (32 by, 32 bx) int32 with
// row length cur_w = 32 bx; penx/peny (side, nb) int32; results (nb,)
// int32.
extern "C" int int_search_u8(const void* win, int nb, int s, int lead,
                             int side, const void* cur, int cur_w, int bx,
                             const void* penx, const void* peny, void* cost,
                             void* idx, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  const Out a = out_of(penx, peny, nb, cost, idx);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (pick_r(kSingleR, 32, false, side)) {
    case 1:
      return run<32, false, 1>(win, nb, s, lead, side, cur, cur_w, bx, a, a,
                               st);
    case 5:
      return run<32, false, 5>(win, nb, s, lead, side, cur, cur_w, bx, a, a,
                               st);
    case 7:
      return run<32, false, 7>(win, nb, s, lead, side, cur, cur_w, bx, a, a,
                               st);
    default:
      return run<32, false, 13>(win, nb, s, lead, side, cur, cur_w, bx, a,
                                a, st);
  }
}
