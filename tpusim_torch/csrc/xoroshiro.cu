// X1, the xoroshiro128++ row sampler, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's rng="xoroshiro" path runs on its
// scan engine, which draws these words with XLA ops
// (tpusim/engine.py:550-645 chunk_fn, with next_words_wide and
// select_stream_by_count, tpusim/xoroshiro.py:140-185), and its Pallas
// engine refuses the path (tpusim/pallas_engine.py:707-711). The plain
// PyTorch version of the same function is
// tpusim_torch/xoroshiro.py::xoro_rows_plain.
//
// What it computes: one launch a chunk. Each run has two sequential
// streams, interval and winner, as (R, 8) uint32 limbs (s0_hi, s0_lo,
// s1_hi, s1_lo each). Both are advanced by the draws the previous chunk
// consumed (`consumed`, from the consumed-row event loop X2; 0 at the first
// chunk), that state is stored, then `steps` words are drawn from each and
// row c = (winner, interval ms) of the c-th pair is written runs-last,
// (steps, 2, R) as the event-loop kernels read them: rows[(2c + k) R + r].
// The event loop reads row c at the run's c-th find of the chunk and returns
// the count, and the next launch advances the stored state by it, so word
// c goes to the c-th consumed draw, as in the reference and in
// native/simcore.cpp. A chunk of `steps` steps consumes at most `steps`
// draws, so `steps` rows always suffice.
//
// The mappings are the native oracle's: the winner is the first cumulative
// uint64 threshold strictly above the word (clamped to the last miner), the
// interval -log1p(-u) * mean_ns with u the word's top 53 bits times 2^-53,
// rounded to the nearest ns (floor(x + 0.5)), truncated to ms and capped at
// 2^27 ms. log1p is a transcription of glibc's (its x86-64 FMA build, which
// the native oracle calls there), every operation an explicitly rounded
// intrinsic and every multiply-add glibc's build fuses an __fma_rn, so nvcc
// contracts nothing else: the card's own log1p may differ from glibc's in
// the last place, which moves a millisecond at a rounding boundary.
//
// The design. Only the generator is sequential: each stream's words come
// one after another, but a run's two streams are independent of each other,
// and every drawn word is mapped independently of all the others. So a
// block takes kRuns runs (one warp's lanes) for the whole chunk, and its
// warps take two roles:
// - generator warps, a thread a stream (warp 0 the runs' winner streams,
//   warp 1 their interval streams, lane j run j): advance the stream by
//   consumed[r], store it, then draw the chunk's words in tiles of kTile
//   steps into a ring of kRing tiles in shared memory, words[slot][s][k][j];
// - mapping warps, all the others: mapping warp w maps steps w, w + kMapWarps,
//   ... of each tile that has arrived, lane j run j's pair (winner and
//   interval), and writes both rows, each store coalesced across the
//   block's runs. The thresholds are staged in shared memory once: (M - 1)
//   words, or the block's columns of (M - 1, R) when per run.
// The roles hand tiles over by named barriers, two a ring slot: the
// generators arrive at "full" once the slot's tile is drawn and the mappers
// wait there; the mappers arrive at "empty" once they have mapped it, and
// the generators wait there before they draw into the slot again. Every
// thread of the block meets every barrier, the absent runs' of a partial
// last block too (they draw from a zero state and write nothing), so no
// barrier waits on a thread that left.
//
// What bounds it: its operations, not its bytes (the rows it writes, steps
// x 2 x R int32, 122 MB at R = 8,192 and 1,856 steps: 0.036 ms at 3.35
// TB/s). Per consumed draw two generator steps; per drawn pair two
// generator steps, M - 1 threshold compares and the float64 mapping. The
// integer work issues on the SM's ALU and FMA pipes, the float64 on its
// FP64 pipe; chip_smoke.py counts each pipe's instructions from this
// kernel's SASS (XORO_PIPES) and takes the busiest. The generator chain of
// one stream (consumed + steps serial steps) is the floor of a block's time;
// the mapping warps hide one another's float64 chains, two blocks an SM at
// R = 8,192 (256 blocks).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Runs a block: one warp's lanes, so lane j of every warp is run j.
constexpr int kRuns = 32;
// Steps a tile, and tiles in the shared-memory ring.
constexpr int kTile = 64, kRing = 2;
// Generator warps (winner streams, interval streams) and mapping warps.
constexpr int kGenWarps = 2, kMapWarps = 16;
constexpr int kThreads = 32 * (kGenWarps + kMapWarps);
// Named barrier ids (0 is __syncthreads'): slot b's "full" and "empty".
constexpr int kFull = 1, kEmpty = kFull + kRing;
static_assert(kEmpty + kRing <= 16, "a block has 16 named barriers");
// The ring's uint64 words: kRing tiles of kTile steps x 2 streams x kRuns.
constexpr int kRingWords = kRing * kTile * 2 * kRuns;

}  // namespace

// The block's shared memory and barriers. A host build of this file (its
// CPU test, tests/test_torch_xoro_host.py) defines these four in its own
// cuda_runtime.h, with the block's threads as host threads.
#ifdef __CUDACC__
namespace {

__device__ __forceinline__ unsigned char* block_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

__device__ __forceinline__ void block_sync() { __syncthreads(); }

// Every thread of the block takes part in each named barrier: `arrive`
// counts this warp in and goes on, `wait` counts it in and waits for all.
__device__ __forceinline__ void barrier_arrive(int id) {
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void barrier_wait(int id) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

}  // namespace
#endif

namespace {

struct Xoro {
  unsigned long long s0, s1;

  __device__ __forceinline__ unsigned long long next() {
    const unsigned long long a = s0;
    unsigned long long b = s1;
    const unsigned long long out = rotl(a + b, 17) + a;
    b ^= a;
    s0 = rotl(a, 49) ^ b ^ (b << 21);
    s1 = rotl(b, 28);
    return out;
  }

  static __device__ __forceinline__ unsigned long long rotl(unsigned long long v, int k) {
    return (v << k) | (v >> (64 - k));
  }

  __device__ __forceinline__ void load(const unsigned* w) {
    s0 = (static_cast<unsigned long long>(w[0]) << 32) | w[1];
    s1 = (static_cast<unsigned long long>(w[2]) << 32) | w[3];
  }

  __device__ __forceinline__ void store(unsigned* w) const {
    w[0] = static_cast<unsigned>(s0 >> 32);
    w[1] = static_cast<unsigned>(s0);
    w[2] = static_cast<unsigned>(s1 >> 32);
    w[3] = static_cast<unsigned>(s1);
  }
};

// glibc's log1p for x in (-1, 0] (sysdeps/ieee754/dbl-64/s_log1p.c as
// x86-64 glibc builds it with -mfma): tpusim_torch/xoroshiro.py::log1p
// operation for operation.
__device__ __forceinline__ double log1p_glibc(double x) {
  constexpr double kLn2Hi = 0x1.62e42fee00000p-1, kLn2Lo = 0x1.a39ef35793c76p-33;
  constexpr double kLp1 = 0x1.5555555555593p-1, kLp2 = 0x1.999999997fa04p-2,
                   kLp3 = 0x1.2492494229359p-2, kLp4 = 0x1.c71c51d8e78afp-3,
                   kLp5 = 0x1.7466496cb03dep-3, kLp6 = 0x1.39a09d078c69fp-3,
                   kLp7 = 0x1.2f112df3e5244p-3;
  const int hx = __double2hiint(x);
  const int ax = hx & 0x7fffffff;
  if (ax < 0x3e200000) {  // |x| < 2^-29
    if (ax < 0x3c900000) return x;
    return __dsub_rn(x, __dmul_rn(__dmul_rn(x, x), 0.5));
  }
  int k = 0, hu = 1;
  double f = x, c = 0.0;
  if (!(hx > 0 || static_cast<unsigned>(hx) < 0xbfd2bec4u)) {
    double u = __dadd_rn(x, 1.0);
    hu = __double2hiint(u);
    k = (hu >> 20) - 1023;
    c = k > 0 ? __dsub_rn(1.0, __dsub_rn(u, x)) : __dsub_rn(x, __dsub_rn(u, 1.0));
    c = __ddiv_rn(c, u);
    hu &= 0x000fffff;
    if (hu < 0x6a09e) {
      u = __hiloint2double(hu | 0x3ff00000, __double2loint(u));
    } else {
      ++k;
      u = __hiloint2double(hu | 0x3fe00000, __double2loint(u));
      hu = (0x00100000 - hu) >> 2;
    }
    f = __dsub_rn(u, 1.0);
  }
  const double hfsq = __dmul_rn(__dmul_rn(f, 0.5), f);
  const double kk = static_cast<double>(k);
  if (hu == 0) {  // |f| < 2^-20
    if (f == 0.0) return k == 0 ? 0.0 : __fma_rn(kk, kLn2Hi, __fma_rn(kk, kLn2Lo, c));
    const double r = __dmul_rn(__fma_rn(-f, 0x1.5555555555555p-1, 1.0), hfsq);
    if (k == 0) return __dsub_rn(f, r);
    return __fma_rn(kk, kLn2Hi, -__dsub_rn(__dsub_rn(r, __fma_rn(kk, kLn2Lo, c)), f));
  }
  const double s = __ddiv_rn(f, __dadd_rn(2.0, f));
  const double z = __dmul_rn(s, s);
  const double r2 = __fma_rn(z, kLp3, kLp2), r3 = __fma_rn(z, kLp5, kLp4),
               r4 = __fma_rn(z, kLp7, kLp6);
  const double z2 = __dmul_rn(z, z);
  const double z4 = __dmul_rn(z2, z2);
  const double z6 = __dmul_rn(z2, z4);
  const double r = __fma_rn(z6, r4, __fma_rn(z4, r3, __fma_rn(z, kLp1, __dmul_rn(z2, r2))));
  const double q = __dmul_rn(__dadd_rn(r, hfsq), s);
  if (k == 0) return __dsub_rn(f, __dsub_rn(hfsq, q));
  return __fma_rn(kk, kLn2Hi,
                  -__dsub_rn(__dsub_rn(hfsq, __dadd_rn(__fma_rn(kk, kLn2Lo, c), q)), f));
}

// The interval in ms of one word: tpusim_torch/xoroshiro.py::interval_ms_from_word.
__device__ __forceinline__ int interval_ms(unsigned long long w, double mean_ns) {
  const double u = __dmul_rn(static_cast<double>(w >> 11), 0x1.0p-53);
  const double ns = floor(__dadd_rn(__dmul_rn(-log1p_glibc(-u), mean_ns), 0.5));
  return static_cast<int>(fmin(floor(__ddiv_rn(ns, 1e6)), 0x1.0p27));
}

__global__ void __launch_bounds__(kThreads, 2)
xoro_rows_kernel(const unsigned* __restrict__ streams_in, const int* __restrict__ consumed,
                 const unsigned* __restrict__ thr_hi, const unsigned* __restrict__ thr_lo,
                 const double* __restrict__ mean, int n_miners, int per_run, int steps,
                 int n_runs, int* __restrict__ rows, unsigned* __restrict__ streams_out) {
  unsigned long long* const words = reinterpret_cast<unsigned long long*>(block_smem());
  unsigned long long* const thr = words + kRingWords;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * kRuns, r = r0 + lane;
  const bool live = r < n_runs;
  const long R = n_runs;
  // Threshold m of run j at thr[m * cols + j] (cols 1 when uniform).
  const int cols = per_run ? kRuns : 1;
  for (int i = threadIdx.x; i < (n_miners - 1) * cols; i += kThreads) {
    const int m = i / cols, rr = r0 + i % cols;
    const long at = per_run ? m * R + rr : m;
    thr[i] = per_run && rr >= n_runs
                 ? 0ull
                 : (static_cast<unsigned long long>(thr_hi[at]) << 32) | thr_lo[at];
  }
  block_sync();
  const int tiles = (steps + kTile - 1) / kTile;

  if (warp < kGenWarps) {
    // Generator: warp 0 the winner streams (row kind 0, limbs 4-7), warp 1
    // the interval streams (row kind 1, limbs 0-3).
    const int kind = warp, at = kind == 0 ? 4 : 0;
    Xoro x{0ull, 0ull};
    if (live) {
      x.load(streams_in + 8L * r + at);
      for (int c = consumed[r]; c > 0; --c) x.next();
      x.store(streams_out + 8L * r + at);
    }
    for (int i = 0; i < tiles; ++i) {
      const int slot = i % kRing, n = min(kTile, steps - i * kTile);
      if (i >= kRing) barrier_wait(kEmpty + slot);
      unsigned long long* const w = words + (slot * kTile * 2 + kind) * kRuns + lane;
#pragma unroll 4
      for (int s = 0; s < n; ++s) w[s * 2 * kRuns] = x.next();
      barrier_arrive(kFull + slot);
    }
  } else {
    // Mapping: this warp's steps of each tile, lane j run j's pair.
    const int first = warp - kGenWarps;
    const double mean_ns = live ? __dmul_rn(mean[per_run ? r : 0], 1e6) : 0.0;
    const unsigned long long* const t = thr + (per_run ? lane : 0);
    for (int i = 0; i < tiles; ++i) {
      const int slot = i % kRing, n = min(kTile, steps - i * kTile);
      barrier_wait(kFull + slot);
      const unsigned long long* const w = words + slot * kTile * 2 * kRuns + lane;
      if (live) {
        for (int s = first; s < n; s += kMapWarps) {
          const unsigned long long win_word = w[2 * s * kRuns];
          const unsigned long long iv_word = w[(2 * s + 1) * kRuns];
          int win = n_miners - 1;
          for (int m = n_miners - 2; m >= 0; --m) {
            if (t[m * cols] > win_word) win = m;
          }
          const long row = 2L * (i * kTile + s);
          rows[row * R + r] = win;
          rows[(row + 1) * R + r] = interval_ms(iv_word, mean_ns);
        }
      }
      // The generators wait for this slot only to draw a later tile into it.
      if (i + kRing < tiles) barrier_arrive(kEmpty + slot);
    }
  }
}

}  // namespace

extern "C" {

// X1's launch shape, into shape[0..4]: runs a block, steps a tile, tiles in
// the ring, generator warps and mapping warps.
void tpusim_xoro_shape(int* shape) {
  shape[0] = kRuns;
  shape[1] = kTile;
  shape[2] = kRing;
  shape[3] = kGenWarps;
  shape[4] = kMapWarps;
}

// The dynamic shared memory of one block, in bytes: the ring's words and the
// thresholds, (M - 1) words or per run (M - 1) x kRuns.
int tpusim_xoro_smem_bytes(int n_miners, int per_run) {
  return 8 * (kRingWords + (n_miners - 1) * (per_run ? kRuns : 1));
}

// Launch X1 on `stream`: streams_in (R, 8) uint32, consumed (R,) int32, the
// uint64 thresholds' limbs thr_hi and thr_lo (M,) or with per_run (M, R)
// runs-last, mean (1,) or per run (R,) float64 ms; writes rows (steps, 2,
// R) int32 and streams_out (R, 8). kRuns runs a block, its ring of word
// tiles and its thresholds in dynamic shared memory. Returns the launch's
// cudaError_t.
int tpusim_xoro_rows(const void* streams_in, const void* consumed, const void* thr_hi,
                     const void* thr_lo, const void* mean, int n_miners, int per_run,
                     int steps, int n_runs, void* rows, void* streams_out, void* stream) {
  if (n_runs <= 0) return 0;
  if (n_miners < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = tpusim_xoro_smem_bytes(n_miners, per_run);
  const cudaError_t set = cudaFuncSetAttribute(
      xoro_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_runs + kRuns - 1) / kRuns);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, xoro_rows_kernel, static_cast<const unsigned*>(streams_in),
      static_cast<const int*>(consumed), static_cast<const unsigned*>(thr_hi),
      static_cast<const unsigned*>(thr_lo), static_cast<const double*>(mean), n_miners,
      per_run, steps, n_runs, static_cast<int*>(rows), static_cast<unsigned*>(streams_out));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

const char* tpusim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
