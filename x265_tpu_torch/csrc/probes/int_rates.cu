// Issue rates of the integer instructions the search kernel
// (x265_tpu_torch/csrc/int_search.cu) is made of, on one SM: each
// thread runs 8 independent dependency chains of one instruction, one
// wave of blocks fills every SM, and each block counts its own SM
// clocks (clock64), so the rate is per clock whatever the card's clock.
// Driven by chip_smoke.py (phase_int_rates); not a kernel of the
// encoder.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t c) {
  uint32_t d;
  asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
               : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the packed 16-bit SAD: two 16-bit absolute differences and their
// accumulator (no instruction of its own on sm_90: about 9 integer ones)
__device__ __forceinline__ uint32_t sad2(uint32_t a, uint32_t b,
                                         uint32_t c) {
  uint32_t d;
  asm volatile("vabsdiff2.u32.u32.u32.add %0, %1, %2, %3;"
               : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the Main10 search's SAD: one 16-bit absolute difference (the low
// half-words) and its accumulator (expanded too: about 3 integer ones)
__device__ __forceinline__ uint32_t sadh(uint32_t a, uint32_t b,
                                         uint32_t c) {
  uint32_t d;
  asm volatile("vabsdiff.u32.u32.u32.add %0, %1.h0, %2.h0, %3;"
               : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// packed 16-bit maximum and minimum (PTX 8.0, sm_90: one VIMNMX each)
__device__ __forceinline__ uint32_t vmax2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t vmin2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// a + b + c: two PTX adds that ptxas fuses into one IADD3
__device__ __forceinline__ uint32_t add3(uint32_t a, uint32_t b,
                                         uint32_t c) {
  uint32_t d;
  asm volatile("{\n\t.reg .u32 t;\n\tadd.u32 t, %1, %2;\n\t"
               "add.u32 %0, t, %3;\n\t}"
               : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// a - b + c in one IADD3 (its operands may be negated)
__device__ __forceinline__ uint32_t sub_add(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm volatile("{\n\t.reg .u32 t;\n\tsub.u32 t, %1, %2;\n\t"
               "add.u32 %0, t, %3;\n\t}"
               : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t shf(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("shf.r.wrap.b32 %0, %1, %2, %1;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t imad(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("mad.lo.u32 %0, %1, %2, %1;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// a * b + c (IMAD: the FMA pipe's integer multiply-add)
__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b,
                                        uint32_t c) {
  uint32_t d;
  asm volatile("mad.lo.u32 %0, %1, %2, %3;"
               : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// FP32 fused multiply-add, 128 lanes per clock per SM on Hopper: the
// yardstick that says which clock the counts are in.
__device__ __forceinline__ uint32_t ffma(uint32_t a, uint32_t b) {
  float d;
  asm volatile("fma.rn.f32 %0, %1, %2, %1;"
               : "=f"(d) : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)));
  return __float_as_uint(d);
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// op 0: VABSDIFF4 (accumulating); 1: SHF; 2: IMAD; 3: half the chains
// VABSDIFF4 and half SHF; 4: FFMA; 5: vabsdiff2 (accumulating); 6:
// scalar vabsdiff of half-words (accumulating); 7: max.u16x2 then
// min.u16x2 (two VIMNMX a step: a chain of maxima alone, ptxas fuses
// two steps into one 3-input VIMNMX3); 8: IADD3; and two exact SADs of
// two 16-bit samples a word whose halves' sums fit 16 bits: 9, |w - c|
// = max - min, one step a word (max, min and acc + max - min: 2
// samples); 10, |w - c| = 2 max(w, c) - w - c with the sums of w and c
// taken apart, one step two words (two max and acc + max0 + max1: 4
// samples); 11: max.u16x2 then IMAD (whether the two pipes overlap);
// 12: the sequence of 10 with IMADs for the sums, acc + 2 max0 + 2 max1
// as two IMADs by a 2 the compiler cannot see (4 samples). Each block
// writes its SM clocks and its start and end on the global nanosecond
// timer.
template <int kOp>
__global__ void __launch_bounds__(kThreads)
chains(uint32_t y, int iters, uint32_t* sink, long long* cycles,
       long long* ns) {
  uint32_t acc[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) acc[j] = threadIdx.x * 7 + j;
  const uint32_t two = (y >> 31) + 2;   // y < 2^31: 2, unknown to ptxas
  __syncthreads();
  const long long g0 = global_ns();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if (kOp == 0 || (kOp == 3 && j % 2 == 0))
        acc[j] = sad4(acc[j], y, acc[j]);
      else if (kOp == 1 || kOp == 3)
        acc[j] = shf(acc[j], y + j);
      else if (kOp == 2)
        acc[j] = imad(acc[j], y + j);
      else if (kOp == 4)
        acc[j] = ffma(acc[j], y + j);
      else if (kOp == 5)
        acc[j] = sad2(acc[j], y, acc[j]);
      else if (kOp == 6)
        acc[j] = sadh(acc[j], y, acc[j]);
      else if (kOp == 7)
        acc[j] = vmin2(vmax2(acc[j], y + j), y - j);
      else if (kOp == 8)
        acc[j] = add3(acc[j], acc[j ^ 1], y);
      else if (kOp == 9)
        acc[j] = sub_add(vmax2(acc[j], y + j), vmin2(acc[j], y + j),
                         acc[j]);
      else if (kOp == 10)
        acc[j] = add3(acc[j], vmax2(acc[j], y + j), vmax2(acc[j], y - j));
      else if (kOp == 11)
        acc[j] = imad(vmax2(acc[j], y + j), y + j);
      else
        acc[j] = mad(vmax2(acc[j], y + j), two,
                     mad(vmax2(acc[j], y - j), two, acc[j]));
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  const long long g1 = global_ns();
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) x ^= acc[j];
  sink[blockIdx.x * kThreads + threadIdx.x] = x;
  if (threadIdx.x == 0) {
    cycles[blockIdx.x] = t1 - t0;
    ns[2 * blockIdx.x] = g0;
    ns[2 * blockIdx.x + 1] = g1;
  }
}

template <int kOp>
int launch(int iters, int grid, uint32_t* sink, long long* cycles,
           long long* ns) {
  chains<kOp><<<grid, kThreads>>>(0x01020304u, iters, sink, cycles, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of one wave per SM for op (its occupancy), or -1.
extern "C" int int_rates_blocks_per_sm(int op) {
  int n = -1;
  const void* fns[] = {reinterpret_cast<const void*>(chains<0>),
                       reinterpret_cast<const void*>(chains<1>),
                       reinterpret_cast<const void*>(chains<2>),
                       reinterpret_cast<const void*>(chains<3>),
                       reinterpret_cast<const void*>(chains<4>),
                       reinterpret_cast<const void*>(chains<5>),
                       reinterpret_cast<const void*>(chains<6>),
                       reinterpret_cast<const void*>(chains<7>),
                       reinterpret_cast<const void*>(chains<8>),
                       reinterpret_cast<const void*>(chains<9>),
                       reinterpret_cast<const void*>(chains<10>),
                       reinterpret_cast<const void*>(chains<11>),
                       reinterpret_cast<const void*>(chains<12>)};
  if (op < 0 || op > 12) return -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fns[op], kThreads, 0);
  return n;
}

// One wave of `grid` blocks of 256 threads, each thread 8 chains of
// `iters` instructions; sink (grid x 256) uint32, cycles (grid,) and
// ns (grid, 2) int64 are device buffers. Returns cudaGetLastError().
extern "C" int int_rates_run(int op, int iters, int grid, void* sink,
                             void* cycles, void* ns) {
  auto* s = static_cast<uint32_t*>(sink);
  auto* c = static_cast<long long*>(cycles);
  auto* t = static_cast<long long*>(ns);
  switch (op) {
    case 0: return launch<0>(iters, grid, s, c, t);
    case 1: return launch<1>(iters, grid, s, c, t);
    case 2: return launch<2>(iters, grid, s, c, t);
    case 3: return launch<3>(iters, grid, s, c, t);
    case 4: return launch<4>(iters, grid, s, c, t);
    case 5: return launch<5>(iters, grid, s, c, t);
    case 6: return launch<6>(iters, grid, s, c, t);
    case 7: return launch<7>(iters, grid, s, c, t);
    case 8: return launch<8>(iters, grid, s, c, t);
    case 9: return launch<9>(iters, grid, s, c, t);
    case 10: return launch<10>(iters, grid, s, c, t);
    case 11: return launch<11>(iters, grid, s, c, t);
    default: return launch<12>(iters, grid, s, c, t);
  }
}
