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
// row, whatever order the candidates are reduced in. int_search_pair_*
// search a 16-region and its four 8-blocks in one pass: the 8-block
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
// The current plane is int32 and holds samples in [0, 2^bd - 1] (the
// source plane, or its weight-compensated copy, which clamps); the
// kernel keeps the low byte of each at 8 bits, the low 16 bits at 10.
//
// Main10 (the _u16 entry points) runs the same design on 2-byte
// samples: a lane still takes 4 words (16 bytes) of a row, now 8
// samples, so a 16-block row takes 2 lanes and a 32-block row 4; a
// row's realignment is a funnel shift of 0 or 16 bits. sm_90 has no
// 16-bit SAD instruction: ptxas expands the half-word vabsdiff, which
// these instances used before, into about 3 integer instructions per
// sample, and the packed vabsdiff2 into about 9 per word. That form is
// gone. The SAD is now |w - c| = 2 max(w, c) - w - c, summed in packed
// form: a word's two samples are its halves, and a candidate's sum over
// a lane's words holds the even samples' sum in its low half and the
// odd samples' in its high half. Per word and candidate that is one
// max.u16x2 (VIMNMX, on the integer pipe) and one IMAD that adds twice
// the max (on the FMA pipe, so the two overlap); sum w over a
// candidate's rows is the difference of two prefix sums of the lane's
// window rows (2 IADD3 a row, shared by the row's R candidates), and
// sum c per lane and half is staged with the current block. All of it
// is uint32 arithmetic mod 2^32, so the packed result V = lo + 2^16 hi
// is exact whenever each half's true SAD lo, hi is below 2^16, and the
// SAD is lo + hi. That needs every sample, window and current, below
// 2^10 (10-bit planes; the weight-compensated current clamps to them): a
// pair lane's half holds 4 samples of a row over an 8-block's 8 rows,
// 32 x 1023 = 32,736 at most; a 32-block lane's half would hold 128
// samples over 32 rows, up to 130,944, so the 32-block's sums are
// unpacked every 16 rows (64 x 1023 = 65,472). Both searches keep their
// sums per half: the pair its lane's top and bottom 8-block (it holds
// one column of 8-blocks; the region adds the two lanes with one
// shuffle after the walk), the 32-block its top and bottom 16 rows. The
// sequence's rate, measured by csrc/probes/int_rates.cu (sad16_max_imad:
// two VIMNMX and two IMAD per 4 samples; 96.2 samples a clock per SM on
// an H100, against 85.6 with one IADD3 for the sums and 20.3 for the
// half-word vabsdiff), is the uint16 searches' bound. Per window row and
// lane the walk adds the prefix's 2 IADD3 to the 5 loads, 4 funnel
// shifts and pointer step, beside 8 instructions (4 VIMNMX, 4 IMAD) for
// each of its R candidates. A 32-block SAD at 10 bits stays under 2^20,
// so the (1 << 30, 0) start key and the 64-bit keys hold as at 8 bits.
//
// Interface: plain C entry points bound through ctypes. A call launches
// on the given stream, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kSmemDefault = 48 * 1024;  // above this, opt in per kernel
constexpr int kSmemMax = 227 * 1024;

// Threads of a block and blocks per SM (kb bytes a sample): the uint8
// pair search one warp a block, 20 blocks (at most 102 registers a
// thread); the uint16 pair search two warps, 10 blocks (102 registers:
// its shared memory holds 17 one-warp blocks at most, and its walk
// needs as many registers); the 32-block search two warps, 8 blocks
// (128 registers). Small blocks wait less at their barriers; each timed
// best among 32-256 threads and 4-20 blocks on an H100.
__host__ __device__ constexpr int threads_of(bool pair, int kb) {
  return pair && kb == 1 ? 32 : 64;
}
__host__ __device__ constexpr int min_blocks_of(bool pair, int kb) {
  return pair ? (kb == 1 ? 20 : 10) : 8;
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

// d = max(a, b) in each 16-bit half (max.u16x2: one VIMNMX on sm_90).
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The sum of the two 16-bit halves of a packed sum.
__device__ __forceinline__ uint32_t unpack2(uint32_t v) {
  return (v & 0xffffu) + (v >> 16);
}

// d = a * b + c: one IMAD, which runs on the FMA pipe.
__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b,
                                       uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Starts the copies of group gi into the staging buffer buf (kB bytes
// a sample).
template <int N, bool kPair, int kB>
__device__ __forceinline__ void stage(const Geo& g, int gi, uint8_t* buf,
                                      const uint8_t* __restrict__ win,
                                      const int32_t* __restrict__ cur,
                                      const Out& a, const Out& b, int tid) {
  constexpr int kOut = kPair ? 5 : 1;
  constexpr int kThreads = threads_of(kPair, kB);
  const int u0 = gi * g.units;
  const int un = min(g.units, g.nb - u0);
  const int ss = g.s * g.s * kB;
  const int ry0 = u0 / g.bx;
  // windows: un x (s x s x kB) contiguous bytes, copied in the widest unit
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
// ascending index, so a strict < keeps the first of equal costs. With
// 2-byte samples the pair's lane l holds the 8-blocks of column l
// only; the other outputs keep INT_MAX, which the reduction over the
// unit's lanes passes over. sslot: with 2-byte samples, the packed sums
// of the unit's current words per half and lane (stage_sums).
template <int N, bool kPair, int R, int kB>
__device__ __forceinline__ void search_item(
    int item, const Geo& g, const uint8_t* wslot, const uint32_t* cslot,
    const uint32_t* sslot, const int32_t* spx, const int32_t* spy,
    int (&bc)[kPair ? 5 : 1], int (&bi)[kPair ? 5 : 1]) {
  constexpr int kOut = kPair ? 5 : 1;
  constexpr int kL = N * kB / 16;       // lanes per candidate
  constexpr int kCW = N * kB / 4;       // words in a current row
  static_assert(kCW == 4 * kL, "a lane takes 4 words of a row");
  static_assert(!kPair || kL <= 2, "a pair lane holds whole 8-blocks");
  // partial sums per candidate: the pair's four quadrants (one lane)
  // or its lane's top and bottom 8-block (two lanes); the 32-block's
  // top and bottom 16 rows at 2 bytes a sample (a packed sum is
  // unpacked every N / 2 rows); else one
  constexpr int kQ = kPair ? (kL == 1 ? 4 : 2) : kB;
  const int l = item & (kL - 1);
  const int rest = item / kL;
  const int grp = rest / g.side;
  const int dx = rest - grp * g.side;
  const int dy0 = min(grp * R, g.side - R);
  const uint32_t* crow = cslot + 4 * l;
  // window row dy0 + r starts at byte a0 + r s kB; 4 s kB bytes are
  // s kB words, so rows r, r + 4, r + 8, ... share a shift and a step
  const int a0 = ((g.lead + dy0) * g.s + g.lead + dx) * kB + 16 * l;
  const uint32_t* wrow[4];
  uint32_t sh[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int aq = a0 + q * g.s * kB;
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
  uint32_t acc[R][kQ];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[k][q] = 0;
  // 2 bytes a sample: pre[r], the packed sum of the lane's window words
  // in the walk's rows before r; csum[q], of its current words in half q;
  // two, 2 where ptxas cannot see it (lead >= 0), so that acc + 2 max
  // stays an IMAD and does not become an IADD3 on the integer pipe
  const uint32_t two = static_cast<uint32_t>(g.lead >> 31) + 2;
  uint32_t pre[kB == 2 ? R + N : 1];
  uint32_t csum[2];
  if constexpr (kB == 2) {
    pre[0] = 0;
    csum[0] = sslot[l];
    csum[1] = sslot[kL + l];
  }

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
    wrow[r & 3] = p + g.s * kB;
    uint32_t w[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) w[j] = p[j];
    uint32_t ref[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ref[j] = __funnelshift_r(w[j], w[j + 1], sh[r & 3]);
    if constexpr (kB == 2)
      pre[r + 1] = pre[r] + ref[0] + ref[1] + ref[2] + ref[3];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = r - k;                // current row of candidate k
      if (i < 0 || i >= N) continue;
      if constexpr (kB == 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = kQ == 4 ? 2 * (i >= N / 2) + (j >= 2) : 0;
          acc[k][q] = sad4(ref[j], c[i % R][j], acc[k][q]);
        }
        if constexpr (kPair) {
          if (i == N / 2 - 1) {           // top 8-blocks complete
            fold(0, k, acc[k][0]);
            fold(1, k, acc[k][1]);
            acc[k][0] += acc[k][1];       // the top half of the region
          } else if (i == N - 1) {        // bottom ones and the region
            fold(2, k, acc[k][2]);
            fold(3, k, acc[k][3]);
            fold(4, k, acc[k][0] + acc[k][2] + acc[k][3]);
          }
        }
      } else {
        // sum 2 max(w, c) of both halves of each word into half q's
        // sum; when the half is complete, make it the packed SAD
        // 2 sum max - sum w - sum c (see the note at the top)
        const int q = i >= N / 2;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[k][q] = mad(max2(ref[j], c[i % R][j]), two, acc[k][q]);
        if (i == N / 2 - 1 || i == N - 1)
          acc[k][q] -= pre[r + 1] - pre[r + 1 - N / 2] + csum[q];
      }
    }
  }
  // the lanes of one candidate are kL consecutive lanes of a warp
  const unsigned lane_mask = ((1u << kL) - 1) << (threadIdx.x & (32 - kL));
  if constexpr (kPair && kQ == 2) {
    // lane l's 8-blocks are outputs l (top) and 2 + l (bottom): their
    // penalties are read at l, their minima kept in outputs 0 and 2,
    // then moved, so no lane branches per candidate
    auto fold_at = [&](int o, int p, int k, uint32_t sad) {
      const int cost = static_cast<int>(sad) + px[p] + py[k * kOut + p];
      if (cost < bc[o]) bc[o] = cost, bk[o] = k;
    };
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const uint32_t top = unpack2(acc[k][0]), bot = unpack2(acc[k][1]);
      fold_at(0, l, k, top);
      fold_at(2, 2 + l, k, bot);
      fold(4, k, top + bot + __shfl_xor_sync(lane_mask, top + bot, 1));
    }
    if (l == 1) {
      bc[1] = bc[0], bk[1] = bk[0], bc[0] = INT_MAX;
      bc[3] = bc[2], bk[3] = bk[2], bc[2] = INT_MAX;
    }
  } else if constexpr (!kPair) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      uint32_t sad = acc[k][0];
      if constexpr (kB == 2) sad = unpack2(sad) + unpack2(acc[k][1]);
#pragma unroll
      for (int m = 1; m < kL; m *= 2)
        sad += __shfl_xor_sync(lane_mask, sad, m);
      fold(0, k, sad);
    }
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) bi[o] = (dy0 + bk[o]) * g.side + dx;
}

// N: current block size (16 for the pair); kPair: also the four
// 8-blocks; R: dy candidates per thread; kB: bytes a sample (1 or 2).
template <int N, bool kPair, int R, int kB>
__global__ void __launch_bounds__(threads_of(kPair, kB),
                                  min_blocks_of(kPair, kB))
int_search_kernel(const uint8_t* __restrict__ win,
                  const int32_t* __restrict__ cur, Geo g, Out a, Out b) {
  constexpr int kOut = kPair ? 5 : 1;   // pair: 8-blocks 0-3, region 4
  constexpr int kThreads = threads_of(kPair, kB);
  constexpr int kCurWords = N * N * kB / 4;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* scur = reinterpret_cast<uint32_t*>(smem + g.off_cur);
  long long* skey = reinterpret_cast<long long*>(smem + g.off_key);
  // 2 bytes a sample: 2 kL packed current sums per slot, after the keys
  uint32_t* ssum = reinterpret_cast<uint32_t*>(smem + g.off_key +
                                               8 * kOut * g.units);
  constexpr int kL = N * kB / 16;
  const int buf_bytes = g.units * g.slot_bytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the group's units x items threads of work, in passes of the block
  const int passes = (g.units * g.items + kThreads - 1) / kThreads;

  int gi = blockIdx.x;
  stage<N, kPair, kB>(g, gi, smem, win, cur, a, b, tid);
  cp_async_commit();
  for (int it = 0; gi < g.ngroups; gi += gridDim.x, ++it) {
    uint8_t* buf = smem + (it & 1) * buf_bytes;
    const int next = gi + gridDim.x;
    if (next < g.ngroups)
      stage<N, kPair, kB>(g, next, smem + ((it + 1) & 1) * buf_bytes, win,
                          cur, a, b, tid);
    cp_async_commit();
    cp_async_wait_prev();               // this group's copies are done
    __syncthreads();

    const int u0 = gi * g.units;
    const int un = min(g.units, g.nb - u0);
    // current blocks, low bytes packed 4 to a word (low half-words 2
    // to a word); start keys
    for (int sl = 0; sl < un; ++sl) {
      const int4* src = reinterpret_cast<const int4*>(
          buf + sl * g.slot_bytes + g.win_bytes);
      for (int t = tid; t < N * N / 4; t += kThreads) {
        const int4 v = src[t];
        if constexpr (kB == 1) {
          scur[sl * kCurWords + t] =
              static_cast<uint32_t>(v.x & 255) |
              static_cast<uint32_t>(v.y & 255) << 8 |
              static_cast<uint32_t>(v.z & 255) << 16 |
              static_cast<uint32_t>(v.w & 255) << 24;
        } else {
          scur[sl * kCurWords + 2 * t] =
              static_cast<uint32_t>(v.x & 0xffff) |
              static_cast<uint32_t>(v.y & 0xffff) << 16;
          scur[sl * kCurWords + 2 * t + 1] =
              static_cast<uint32_t>(v.z & 0xffff) |
              static_cast<uint32_t>(v.w & 0xffff) << 16;
        }
      }
    }
    if constexpr (kB == 2) {
      // per slot, half h and lane: the packed sum (mod 2^32) of the
      // current words the lane compares in rows [h N / 2, (h + 1) N / 2)
      for (int t = tid; t < un * 2 * kL; t += kThreads) {
        const int sl = t / (2 * kL);
        const int h = t / kL % 2;
        const int4* src = reinterpret_cast<const int4*>(
                              buf + sl * g.slot_bytes + g.win_bytes) +
                          h * (N / 2) * (N / 4) + 2 * (t % kL);
        uint32_t lo = 0, hi = 0;
#pragma unroll 4
        for (int i = 0; i < N / 2; ++i) {
          const int4 v0 = src[i * (N / 4)], v1 = src[i * (N / 4) + 1];
          lo += (v0.x & 0xffff) + (v0.z & 0xffff) + (v1.x & 0xffff) +
                (v1.z & 0xffff);
          hi += v0.y + v0.w + v1.y + v1.w;
        }
        ssum[t] = lo + (hi << 16);
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
        search_item<N, kPair, R, kB>(item, g, sb, scur + slot * kCurWords,
                                     ssum + slot * 2 * kL, spx,
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

template <int N, bool kPair, int R, int kB>
int run(const void* win, int nb, int s, int lead, int side, const void* cur,
        int cur_w, int bx, Out a, Out b, cudaStream_t stream) {
  constexpr int kOut = kPair ? 5 : 1;
  constexpr int kL = N * kB / 16;
  constexpr int kThreads = threads_of(kPair, kB);
  const int groups_dy = (side + R - 1) / R;
  Geo g{};
  g.s = s;
  g.lead = lead;
  g.side = side;
  g.nb = nb;
  g.items = side * groups_dy * kL;
  g.win_bytes = round16(s * s * kB + 16);  // + the last row's 5th word
  g.slot_bytes = g.win_bytes + 4 * N * N + round16(4 * 2 * kOut * side);
  // units per group: the fewest that leave under 5% of the passes'
  // threads idle, within the shared memory of one of min_blocks_of
  // blocks on an SM
  const int sums = kB == 2 ? 8 * kL : 0;  // the packed current sums
  const int per_unit = 2 * g.slot_bytes + N * N * kB + 8 * kOut + sums;
  const int max_units =
      max(1, min(nb, kSmemMax / min_blocks_of(kPair, kB) / per_unit));
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
  g.off_key = g.off_cur + round16(units * N * N * kB);
  const int smem = g.off_key + (8 * kOut + sums) * units;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  g.cur_w = cur_w;
  g.bx = bx;
  const uintptr_t win_addr = reinterpret_cast<uintptr_t>(win);
  const int ss = s * s * kB;
  g.win_align = win_addr % 16 == 0 && ss % 16 == 0 ? 16
                : win_addr % 4 == 0 && ss % 4 == 0 ? 4 : 1;
  g.cur16 = (reinterpret_cast<uintptr_t>(cur) % 16 == 0) && cur_w % 4 == 0;

  auto* kernel = int_search_kernel<N, kPair, R, kB>;
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
// (1 always is): the fewest integer instructions per dx, in halves of
// one. Per dy group: R candidates of n^2 kB / 4 current words each and
// their folds, and R + n - 1 window rows per lane. At 1 byte a sample a
// word is one VABSDIFF4, a window row 5 (4 funnel shifts and a pointer
// step), the folds of a candidate about 21 (the pair: 5 keys and the
// halves' sums) or 6. At 2 bytes a word is 2 (a VIMNMX and an IMAD), a
// window row 12 (5 loads, 4 funnel shifts, a pointer step and 2 IADD3
// of its prefix sum), the folds per candidate and lane about 26 (the
// pair: 2 halves made SADs and unpacked, 3 keys and a shuffle) or 18.
int pick_r(const int* rs, int nr, int n, bool pair, int kb, int side) {
  const int lanes = n * kb / 16;
  const long long word = kb == 1 ? 2 : 4;
  const long long fold = kb == 1 ? 2 * (pair ? 21 : 6)
                                 : 2 * lanes * (pair ? 26 : 18);
  const long long row = kb == 1 ? 2 * 5 : 2 * 12;
  int best = 1;
  long long best_cost = LLONG_MAX;
  for (int m = 0; m < nr; ++m) {
    const int r = rs[m];
    if (r > side) continue;
    const long long groups = (side + r - 1) / r;
    const long long cost =
        groups * (r * (n * n * kb / 4 * word + fold) +
                  (r + n - 1) * lanes * row);
    if (cost < best_cost) best = r, best_cost = cost;
  }
  return best;
}

// The compiled R of each search (and sample width; 1 must be one).
template <int... Rs>
struct RList {};
using PairR = RList<1, 5, 6, 7>;
using SingleR1 = RList<1, 5, 7, 13>;
using SingleR2 = RList<1, 5, 6, 7>;

// run<> at the R that pick_r gives among Rs.
template <int N, bool kPair, int kB, int... Rs>
int run_picked(RList<Rs...>, const void* win, int nb, int s, int lead,
               int side, const void* cur, int cur_w, int bx, Out a, Out b,
               cudaStream_t st) {
  constexpr int rs[] = {Rs...};
  const int r = pick_r(rs, sizeof...(Rs), N, kPair, kB, side);
  int err = static_cast<int>(cudaErrorInvalidValue);
  (void)((r == Rs && ((err = run<N, kPair, Rs, kB>(win, nb, s, lead, side,
                                                   cur, cur_w, bx, a, b,
                                                   st)),
                      true)) ||
         ...);
  return err;
}

Out out_of(const void* penx, const void* peny, int nb, void* cost,
           void* idx) {
  return Out{static_cast<const int32_t*>(penx),
             static_cast<const int32_t*>(peny), nb,
             static_cast<int32_t*>(cost), static_cast<int32_t*>(idx)};
}

template <int kB>
int search_pair(const void* win, int nb16, int s, int lead, int side,
                const void* cur, int cur_w, int bx16, const void* penx8,
                const void* peny8, const void* penx16, const void* peny16,
                void* cost8, void* idx8, void* cost16, void* idx16,
                void* stream) {
  if (nb16 <= 0) return static_cast<int>(cudaGetLastError());
  const Out a = out_of(penx8, peny8, 4 * nb16, cost8, idx8);
  const Out b = out_of(penx16, peny16, nb16, cost16, idx16);
  auto* st = static_cast<cudaStream_t>(stream);
  return run_picked<16, true, kB>(PairR{}, win, nb16, s, lead, side, cur,
                                  cur_w, bx16, a, b, st);
}

template <int kB>
int search_single(const void* win, int nb, int s, int lead, int side,
                  const void* cur, int cur_w, int bx, const void* penx,
                  const void* peny, void* cost, void* idx, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  const Out a = out_of(penx, peny, nb, cost, idx);
  auto* st = static_cast<cudaStream_t>(stream);
  using Rs = std::conditional_t<kB == 1, SingleR1, SingleR2>;
  return run_picked<32, false, kB>(Rs{}, win, nb, s, lead, side, cur,
                                   cur_w, bx, a, a, st);
}

}  // namespace

// A 16-region and its four 8-blocks. win (nb16, s, s) uint8 region
// windows (uint16 for _u16), any s; cur (16 by16, 16 bx16) int32 with
// row length cur_w = 16 bx16; penx8/peny8 (side, 4 nb16), penx16/peny16
// (side, nb16) int32; results (4 nb16,) and (nb16,) int32.
extern "C" int int_search_pair_u8(const void* win, int nb16, int s,
                                  int lead, int side, const void* cur,
                                  int cur_w, int bx16, const void* penx8,
                                  const void* peny8, const void* penx16,
                                  const void* peny16, void* cost8,
                                  void* idx8, void* cost16, void* idx16,
                                  void* stream) {
  return search_pair<1>(win, nb16, s, lead, side, cur, cur_w, bx16, penx8,
                        peny8, penx16, peny16, cost8, idx8, cost16, idx16,
                        stream);
}

extern "C" int int_search_pair_u16(const void* win, int nb16, int s,
                                   int lead, int side, const void* cur,
                                   int cur_w, int bx16, const void* penx8,
                                   const void* peny8, const void* penx16,
                                   const void* peny16, void* cost8,
                                   void* idx8, void* cost16, void* idx16,
                                   void* stream) {
  return search_pair<2>(win, nb16, s, lead, side, cur, cur_w, bx16, penx8,
                        peny8, penx16, peny16, cost8, idx8, cost16, idx16,
                        stream);
}

// 32-blocks. win (nb, s, s) uint8 (uint16 for _u16), any s; cur
// (32 by, 32 bx) int32 with row length cur_w = 32 bx; penx/peny
// (side, nb) int32; results (nb,) int32.
extern "C" int int_search_u8(const void* win, int nb, int s, int lead,
                             int side, const void* cur, int cur_w, int bx,
                             const void* penx, const void* peny, void* cost,
                             void* idx, void* stream) {
  return search_single<1>(win, nb, s, lead, side, cur, cur_w, bx, penx,
                          peny, cost, idx, stream);
}

extern "C" int int_search_u16(const void* win, int nb, int s, int lead,
                              int side, const void* cur, int cur_w, int bx,
                              const void* penx, const void* peny,
                              void* cost, void* idx, void* stream) {
  return search_single<2>(win, nb, s, lead, side, cur, cur_w, bx, penx,
                          peny, cost, idx, stream);
}
