// Helpers shared by the event-loop kernels (event_loop.cu for fast mode,
// event_loop_exact.cu for exact mode): the state constants, loads and stores
// of a leaf in its own type, the arrival-group buffer (split K = 2 slots,
// and the generic K >= 3 slots), the flight recorder's ring rows, the
// raw-word variants' mapping of a step's threefry words (Sampler,
// winner_from_word, interval_from_word, and map_raw_words_kernel, the
// mapping alone), and the groups of lanes
// that step a run: a 16-lane group up to 16 miners (RunGroup, or RunPair,
// two that step together), a warp (RunWarp, miner_bit) above.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// One library per miner count: the build passes -DTPUSIM_MINERS=<M>
// (tpusim_torch/csrc/build.py), so a run compiles only the M it uses.
#ifndef TPUSIM_MINERS
#error "compile with -DTPUSIM_MINERS=<miner count>"
#endif

// The wide variants (-DTPUSIM_WIDE=1, built for rosters of more than 16
// miners), for any miner count: a warp owns a run, each lane ceil(M / 32)
// miners (K1w, K2w). Without the flag a group of lanes owns a run, and 16
// miners is the limit.
#ifndef TPUSIM_WIDE
#define TPUSIM_WIDE 0
#endif
static_assert(TPUSIM_MINERS >= 1 && (TPUSIM_WIDE || TPUSIM_MINERS <= 16),
              "1..16 miners, or any count in a wide build");

// A library holds either the kernels without the flight recorder or its
// FLIGHT variants: the build passes -DTPUSIM_FLIGHT=1 for the latter, so the
// two sets compile as libraries of their own, in parallel.
#ifndef TPUSIM_FLIGHT
#define TPUSIM_FLIGHT 0
#endif

// Likewise the packed-grid variants (-DTPUSIM_PACKED=1): per-run propagation
// delays and selfish flags. A library built with both is the packed grid
// with the flight recorder (K4 x K3).
#ifndef TPUSIM_PACKED
#define TPUSIM_PACKED 0
#endif

// Arrival-group slots K per (run, miner). Without the flag K = 2: the split
// slots, the reference's split-slot specialization, as the kernels were
// before the generic buffer. K >= 3 (-DTPUSIM_GROUP_SLOTS=<K>) builds the
// generic K-slot buffer (K5c) into a library of its own.
#ifndef TPUSIM_GROUP_SLOTS
#define TPUSIM_GROUP_SLOTS 2
#endif
static_assert(TPUSIM_GROUP_SLOTS >= 2, "2 or more group slots");

// The raw-word variants (-DTPUSIM_RAW_WORDS=1, K5a): a step's row holds the
// two raw uint32 threefry words, stored as int32 bit patterns, and the kernel
// maps them to (winner, interval) itself from the winner thresholds and the
// mean interval, which it takes as one more argument, a Sampler
// (TPUSIM_SAMPLER_PARAM). Without the flag the rows are pre-mapped and the
// kernels' text is as it was.
#ifndef TPUSIM_RAW_WORDS
#define TPUSIM_RAW_WORDS 0
#endif

// The one-hot variants (-DTPUSIM_ONEHOT=1, K5b): every read indexed by the
// best chain's owner b is a contraction over the miner axis with the one-hot
// of b, where the other variants read the one entry.
#ifndef TPUSIM_ONEHOT
#define TPUSIM_ONEHOT 0
#endif

// The Sampler as a kernel's last parameter and its argument, and the C entry
// points' three addresses (lo, hi, mean) before the stream. Empty without the
// flag.
#if TPUSIM_RAW_WORDS
#define TPUSIM_SAMPLER_PARAM , Sampler smp
#define TPUSIM_SAMPLER_ARG , smp
#define TPUSIM_SAMPLER_C_PARAMS , const void *lo, const void *hi, const void *mean
#define TPUSIM_SAMPLER_C_ARGS                                                   \
  , Sampler{static_cast<const unsigned*>(lo), static_cast<const unsigned*>(hi), \
            static_cast<const float*>(mean)}
#else
#define TPUSIM_SAMPLER_PARAM
#define TPUSIM_SAMPLER_ARG
#define TPUSIM_SAMPLER_C_PARAMS
#define TPUSIM_SAMPLER_C_ARGS
#endif

namespace {

constexpr int kInf = 1 << 30;             // state.INF_TIME
constexpr int kNegGate = -(1 << 29) - 1;  // state.NEG_TIME_CAP - 1
constexpr int kBuckets = 8;               // engine.DEPTH_BUCKETS
constexpr int kSlots = TPUSIM_GROUP_SLOTS;
// The generic buffer's array extent: 1 (and unused) at K = 2.
constexpr int kGenSlots = kSlots == 2 ? 1 : kSlots;

template <typename T>
__device__ __forceinline__ int ld(const void* base, long i) {
  return static_cast<int>(static_cast<const T*>(base)[i]);
}

template <typename T>
__device__ __forceinline__ void st(void* base, long i, int v) {
  static_cast<T*>(base)[i] = static_cast<T>(v);
}

#if TPUSIM_RAW_WORDS
// The raw-word variants' sampler operands (K5a): the cumulative winner
// thresholds as uint32 intervals [lo[m], hi[m]) and the mean interval in ms,
// one set for every run, or with PACKED per run: lo and hi (M, R) runs-last,
// mean (R,).
struct Sampler {
  const unsigned* lo;
  const unsigned* hi;
  const float* mean;
};

// float32 log1p(x) for x in (-1, 0]: tpusim_torch/sampling.py::_log1p_neg
// operation for operation, which is XLA:CPU's compiled expansion (a Cephes
// rational approximation for small |x|, logf of 1 + x otherwise). The 24
// multiply-adds that XLA's x86 backend contracts are __fmaf_rn; every other
// multiply, add, subtract and divide is an explicitly rounded intrinsic,
// which nvcc never contracts (its default --fmad=true would fuse any
// a * b + c it sees). The constants are the float32 values of sampling.py's.
__device__ __forceinline__ float log1p_neg(float x) {
  // Small |x|: x + (-x^2/2 + x^3 * d(x)/n(x)).
  const float x2 = __fmul_rn(x, x);
  const float x0 = __fmul_rn(x, 0.0f);
  float n = __fmaf_rn(__fadd_rn(x0, 1.0f), x, 0x1.e2035ap+3f);
  n = __fmaf_rn(n, x, 0x1.4c30b6p+6f);
  n = __fmaf_rn(n, x, 0x1.bb865ap+7f);
  n = __fmaf_rn(n, x, 0x1.351946p+8f);
  n = __fmaf_rn(n, x, 0x1.b0db14p+7f);
  n = __fmaf_rn(n, x, 0x1.e0f304p+5f);
  float d = __fmaf_rn(__fadd_rn(x0, 0x1.7bc096p-15f), x, 0x1.fe818ap-2f);
  d = __fmaf_rn(d, x, 0x1.a509f4p+2f);
  d = __fmaf_rn(d, x, 0x1.de9738p+4f);
  d = __fmaf_rn(d, x, 0x1.e798ecp+5f);
  d = __fmaf_rn(d, x, 0x1.c8e75ap+5f);
  d = __fmaf_rn(d, x, 0x1.40a202p+4f);
  const float small =
      __fadd_rn(x, __fmaf_rn(-x2, 0.5f, __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(d, n))));

  // Otherwise logf(y), y = 1 + x clamped below at the least normal float:
  // the mantissa split at sqrt(1/2), three cubic pieces, ln 2 in two parts.
  const float y = __fadd_rn(x, 1.0f);
  const float yc = y > 0x1p-126f ? y : 0x1p-126f;
  const int ybits = __float_as_int(yc);
  const float m = __int_as_float((ybits & 0x7FFFFF) | 0x3F000000);  // [0.5, 1)
  const bool lt = m < 0x1.6a09e6p-1f;
  const float z = __fadd_rn(__fsub_rn(m, 1.0f), lt ? m : 0.0f);
  const float k = __fsub_rn(__fadd_rn(__int2float_rn((ybits >> 23) - 127), 1.0f),
                            lt ? 1.0f : 0.0f);
  const float z2 = __fmul_rn(z, z);
  const float z3 = __fmul_rn(z2, z);
  const float a = __fmaf_rn(__fmaf_rn(z, 0x1.204376p-4f, -0x1.d7a37p-4f), z, 0x1.de4a34p-4f);
  const float b = __fmaf_rn(__fmaf_rn(z, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), z, -0x1.555cap-3f);
  const float c = __fmaf_rn(__fmaf_rn(z, 0x1.999d58p-3f, -0x1.fffff8p-3f), z, 0x1.555554p-2f);
  const float p = __fmaf_rn(__fmaf_rn(a, z3, b), z3, c);
  float big = __fmaf_rn(k, 0x1.63p-1f,
                        __fadd_rn(__fmaf_rn(-z2, 0.5f, z),
                                  __fmaf_rn(p, z3, __fmul_rn(k, -0x1.bd0106p-13f))));
  // logf's special values: y <= 0 or NaN -> NaN, 0 -> -inf, inf -> inf.
  if (!(y > 0.0f)) big = __int_as_float(0x7FC00000);
  if (y == 0.0f) big = -__int_as_float(0x7F800000);
  if (y == __int_as_float(0x7F800000)) big = y;
  return fabsf(x) < 0x1.a8279ap-2f ? small : big;
}

// The interval in integer ms of one raw word (sampling.interval_from_bits):
// floor(-log1p(-u) * mean), clamped at 2^27 ms, u = (w >> 8) * 2^-24.
__device__ __forceinline__ int interval_from_word(unsigned w, float mean) {
  const float x = __fmul_rn(__int2float_rn(static_cast<int>(w >> 8)), -0x1p-24f);  // -u, exact
  return __float2int_rz(fminf(__fmul_rn(log1p_neg(x), -mean), 0x1p27f));
}

// The winner of one raw word: the miner m with lo[m] <= w < hi[m], the last
// interval closed (tpusim/pallas_engine.py:301-304, the ~96/2^32 words past
// the 100 % threshold go to the last miner). Entry m of lo and hi is at
// m * stride.
template <int M>
__device__ __forceinline__ int winner_from_word(unsigned w, const unsigned* lo,
                                                const unsigned* hi, long stride) {
  int wq = 0;
#pragma unroll 4
  for (int m = 0; m < M; ++m) {
    if (w >= lo[m * stride] && (m == M - 1 || w < hi[m * stride])) wq = m;
  }
  return wq;
}
#endif

// pallas push_groups2 for one miner: append (arrival, count) where `d`:
// the first empty slot, an equal arrival merged into the last occupied
// slot, slot 1 accumulating on overflow. Returns 1 on overflow.
__device__ __forceinline__ int push2(int& a0, int& a1, int& c0, int& c1, int arrival,
                                     int count, bool d) {
  const bool e0 = c0 > 0, e1 = c1 > 0;
  const int last_arr = e1 ? a1 : a0;
  const bool merge = d && e0 && last_arr == arrival;
  const bool overflowed = d && !merge && e1;
  const bool w0 = d && (!e0 || (merge && !e1));
  const bool w1 = d && e0 && (e1 || !merge);
  const bool accum = merge || overflowed;
  if (w0) {
    a0 = arrival;
    c0 = accum ? c0 + count : count;
  }
  if (w1) {
    a1 = arrival;
    c1 = accum ? c1 + count : count;
  }
  return overflowed;
}

// pallas push_groups for one miner on K >= 3 slots (tpusim/pallas_engine.py:
// 233-249): append (arrival, count) where `d`, at the first empty slot; an
// equal arrival merges into the last occupied slot; a full buffer merges
// into its last slot, the overflow. Returns 1 on overflow.
template <int K>
__device__ __forceinline__ int push_k(int (&ga)[K], int (&gc)[K], int arrival, int count,
                                      bool d) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) n += gc[k] > 0;
  const int last = max(n - 1, 0);
  int last_arr = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) last_arr = (k == last) ? ga[k] : last_arr;
  const bool merge = d && n > 0 && last_arr == arrival;
  const bool overflowed = d && !merge && n == K;
  const bool accum = merge || overflowed;
  const int w = accum ? last : min(n, K - 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (d && k == w) {
      ga[k] = arrival;
      gc[k] = accum ? gc[k] + count : count;
    }
  }
  return overflowed;
}

// The generic flush for one miner (pallas_engine.py:367-379): the n_f
// groups that arrived by t_flush leave, the last one's arrival becomes
// `base`, and the rest shift left by n_f, kInf arrivals and 0 counts filling
// the tail. Returns the count still unarrived. Slot d reads slot d + n_f
// >= d before it is written, so the shift runs in place.
template <int K>
__device__ __forceinline__ int flush_k(int (&ga)[K], int (&gc)[K], int t_flush, int& base) {
  int nf = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) nf += ga[k] <= t_flush;
#pragma unroll
  for (int k = 0; k < K; ++k) base = (k == nf - 1) ? ga[k] : base;
  int unarrived = 0;
#pragma unroll
  for (int d = 0; d < K; ++d) {
    int a = kInf, c = 0;
#pragma unroll
    for (int s = d; s < K; ++s) {
      if (s == d + nf) {
        a = ga[s];
        c = gc[s];
      }
    }
    ga[d] = a;
    gc[d] = c;
    unarrived += c;
  }
  return unarrived;
}

// The earliest pending arrival after t over one miner's K slots (kInf if
// none): its share of the cut-through.
template <int K>
__device__ __forceinline__ int pending_k(const int (&ga)[K], int t) {
  int e = kInf;
#pragma unroll
  for (int k = 0; k < K; ++k) e = min(e, ga[k] > t ? ga[k] : kInf);
  return e;
}

// The flight recorder's leaves for the FLIGHT variants (tpusim_torch.flight
// FLIGHT_LEAVES, runs-last): the row count (1, R) and the origins (3, R) =
// [base_hi, base_lo, h_base] are read from `*_in` and written whole to
// `*_out`; `buf` is the output ring (C, 6, R), which the wrapper has filled
// with a copy of the input ring, so a thread writes only the rows it records.
struct Flight {
  const int* cnt_in;
  const int* base_in;
  int* buf;
  int* cnt_out;
  int* base_out;
  int capacity;
};

constexpr int kFields = 6;  // flight.N_FIELDS
constexpr int kKindFind = 0, kKindArrival = 1, kKindStale = 2, kKindReorg = 3;

// One run's ring cursor, in registers for the chunk.
struct FlightRun {
  int cnt, slot, b_hi, b_lo, h_b;

  __device__ __forceinline__ void load(const Flight& f, int r, long R) {
    cnt = f.cnt_in[r];
    slot = cnt % f.capacity;
    b_hi = f.base_in[r];
    b_lo = f.base_in[R + r];
    h_b = f.base_in[2 * R + r];
  }

  // Row (kind, miner, height + h_base, depth, b_hi, b_lo + t) at slot
  // cnt % C. The time pair is left un-normalized (b_lo + t may pass 2^30),
  // as the reference stores it; heights are read-only origins here.
  __device__ __forceinline__ void push(const Flight& f, int r, long R, int kind, int miner,
                                       int height, int depth, int t) {
    int* const row = f.buf + static_cast<long>(slot) * kFields * R + r;
    row[0] = kind;
    row[R] = miner;
    row[2 * R] = height + h_b;
    row[3 * R] = depth;
    row[4 * R] = b_hi;
    row[5 * R] = b_lo + t;
    ++cnt;
    slot = (slot + 1 == f.capacity) ? 0 : slot + 1;
  }

  __device__ __forceinline__ void store(const Flight& f, int r, long R) const {
    f.cnt_out[r] = cnt;
    f.base_out[r] = b_hi;
    f.base_out[R + r] = b_lo;
    f.base_out[2 * R + r] = h_b;
  }
};

// Entries the wide exact kernel loads before it stores any of them: a load
// cannot move above an earlier store to memory that may alias it, so
// without batching each copied entry waits a whole round trip.
constexpr int kBatch = 8;

// The narrow kernels' run group (event_loop_exact.cu, event_loop.cu):
// kGroupLanes lanes of one warp own one run, lane m its miner m, so a warp
// holds two runs. Every collective names the group's own lanes: the two runs of a
// warp leave their step loops at different steps, and a block's last
// groups may hold no run at all.
constexpr int kGroupLanes = 16;

struct RunGroup {
  unsigned mask;  // the group's lanes within its warp
  int shift;      // the group's first lane within its warp: 0 or 16
  int lane;       // this thread's lane within the group: its miner

  __device__ __forceinline__ explicit RunGroup(int thread)
      : mask(0xFFFFu << (thread & 16)), shift(thread & 16), lane(thread & 15) {}

  __device__ __forceinline__ int max(int v) const { return __reduce_max_sync(mask, v); }
  __device__ __forceinline__ int min(int v) const { return __reduce_min_sync(mask, v); }
  __device__ __forceinline__ int add(int v) const { return __reduce_add_sync(mask, v); }
  // Bit m set where lane m's predicate holds.
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return (__ballot_sync(mask, p) >> shift) & 0xFFFFu;
  }
  // The lowest lane whose predicate holds (-1 if none).
  __device__ __forceinline__ int lowest(bool p) const { return __ffs(ballot(p)) - 1; }
  // Lane src's v.
  __device__ __forceinline__ int from(int v, int src) const {
    return __shfl_sync(mask, v, src, kGroupLanes);
  }
  // Orders every lane's shared-memory writes before any lane's later reads.
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

// One miner's split slots (K = 2) for a run group's lane: the narrow
// kernels' flush (groups arrived by t_flush leave, the last one's arrival
// becomes `base`; returns the count still unarrived), the earliest pending
// arrival after t and the earliest group arrived by t (kInf if none).
__device__ __forceinline__ int flush2(int& a0, int& a1, int& c0, int& c1, int t_flush,
                                      int& base) {
  const bool f0 = a0 <= t_flush, f1 = a1 <= t_flush;
  base = f1 ? a1 : (f0 ? a0 : base);
  const int na0 = f1 ? kInf : (f0 ? a1 : a0);
  const int na1 = f0 ? kInf : a1;
  const int nc0 = f1 ? 0 : (f0 ? c1 : c0);
  const int nc1 = f0 ? 0 : c1;
  a0 = na0;
  a1 = na1;
  c0 = nc0;
  c1 = nc1;
  return nc0 + nc1;
}

__device__ __forceinline__ int pending2(int a0, int a1, int t) {
  return min(a0 > t ? a0 : kInf, a1 > t ? a1 : kInf);
}

__device__ __forceinline__ int arrived2(int a0, int a1, int t) {
  return min(a0 <= t ? a0 : kInf, a1 <= t ? a1 : kInf);
}

// arrived2 over one miner's K >= 3 slots.
template <int K>
__device__ __forceinline__ int arrived_k(const int (&ga)[K], int t) {
  int e = kInf;
#pragma unroll
  for (int k = 0; k < K; ++k) e = min(e, ga[k] <= t ? ga[k] : kInf);
  return e;
}

// The wide kernels' run (event_loop_exact.cu and event_loop.cu,
// TPUSIM_WIDE): one whole warp steps it, lane l owning miners l, l + 32, ...
// (P = ceil(M / 32) of them, slot k its miner l + 32 k). The lanes of a warp
// leave their step loop together, so every collective takes the full mask.
// A per-miner value is held as v[P] in each lane; the helpers below fold a
// lane's P slots and then reduce over the warp.
constexpr int kWarpLanes = 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

struct RunWarp {
  int lane;

  __device__ __forceinline__ explicit RunWarp(int thread) : lane(thread & (kWarpLanes - 1)) {}

  __device__ __forceinline__ int max(int v) const { return __reduce_max_sync(kFullMask, v); }
  __device__ __forceinline__ int min(int v) const { return __reduce_min_sync(kFullMask, v); }
  __device__ __forceinline__ int add(int v) const { return __reduce_add_sync(kFullMask, v); }
  __device__ __forceinline__ unsigned ballot(bool p) const { return __ballot_sync(kFullMask, p); }
  __device__ __forceinline__ int from(int v, int src) const {
    return __shfl_sync(kFullMask, v, src);
  }
  // The miner of this lane's slot k.
  __device__ __forceinline__ int miner(int k) const { return lane + kWarpLanes * k; }

  // Miner m's v: its slot picked in every lane, then lane m % 32's.
  template <int P>
  __device__ __forceinline__ int of(const int (&v)[P], int m) const {
    int x = v[0];
#pragma unroll
    for (int k = 1; k < P; ++k) x = (m / kWarpLanes == k) ? v[k] : x;
    return from(x, m % kWarpLanes);
  }

  // The lowest miner whose p holds (kInf if none).
  template <int P>
  __device__ __forceinline__ int lowest(const bool (&p)[P]) const {
    int x = kInf;
#pragma unroll
    for (int k = P - 1; k >= 0; --k) x = p[k] ? miner(k) : x;
    return min(x);
  }

  // The warp's max, min and sum of a per-miner value.
  template <int P>
  __device__ __forceinline__ int max_of(const int (&v)[P]) const {
    int x = v[0];
#pragma unroll
    for (int k = 1; k < P; ++k) x = ::max(x, v[k]);
    return max(x);
  }
  template <int P>
  __device__ __forceinline__ int min_of(const int (&v)[P]) const {
    int x = v[0];
#pragma unroll
    for (int k = 1; k < P; ++k) x = ::min(x, v[k]);
    return min(x);
  }
  template <int P>
  __device__ __forceinline__ int add_of(const int (&v)[P]) const {
    int x = v[0];
#pragma unroll
    for (int k = 1; k < P; ++k) x += v[k];
    return add(x);
  }
};

// The fast kernel's pair of runs (event_loop.cu): 16 lanes of a warp own
// one run, lane m its miner m, and the warp's two runs step together (a run
// that has finished steps on inactive), so every collective takes the full
// mask and reduces each half apart: a reduction with a group mask in a
// converged warp runs once for each distinct mask.
struct RunPair {
  int shift;  // the run's first lane within its warp: 0 or 16
  int lane;   // this thread's lane within its run's half: its miner

  __device__ __forceinline__ explicit RunPair(int thread)
      : shift(thread & 16), lane(thread & 15) {}

  // Each half's max, min and sum: the other half contributes the neutral
  // value to the warp's reduction.
  __device__ __forceinline__ int max(int v) const {
    const int lo = __reduce_max_sync(kFullMask, shift ? INT32_MIN : v);
    const int hi = __reduce_max_sync(kFullMask, shift ? v : INT32_MIN);
    return shift ? hi : lo;
  }
  __device__ __forceinline__ int min(int v) const {
    const int lo = __reduce_min_sync(kFullMask, shift ? INT32_MAX : v);
    const int hi = __reduce_min_sync(kFullMask, shift ? v : INT32_MAX);
    return shift ? hi : lo;
  }
  __device__ __forceinline__ int add(int v) const {
    const int lo = __reduce_add_sync(kFullMask, shift ? 0 : v);
    const int hi = __reduce_add_sync(kFullMask, shift ? v : 0);
    return shift ? hi : lo;
  }
  // Bit m set where lane m's predicate holds.
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return (__ballot_sync(kFullMask, p) >> shift) & 0xFFFFu;
  }
  // Lane src's v.
  __device__ __forceinline__ int from(int v, int src) const {
    return __shfl_sync(kFullMask, v, src, kGroupLanes);
  }
};

// Bit m of a miner set held as P 32-bit words (word k: miners 32 k ..
// 32 k + 31, as RunWarp::ballot gives them slot by slot).
template <int P>
__device__ __forceinline__ bool miner_bit(const unsigned (&set)[P], int m) {
  unsigned w = set[0];
#pragma unroll
  for (int k = 1; k < P; ++k) w = (m / kWarpLanes == k) ? set[k] : w;
  return (w >> (m % kWarpLanes)) & 1u;
}

}  // namespace

#if TPUSIM_RAW_WORDS
namespace {

// The raw-word mapping alone, one word pair a thread: words (2, n) int32 bit
// patterns, winner words then interval words, to out (2, n), winners then
// intervals, with one set of thresholds and one mean. The event-loop kernels
// inline the same two device functions; this exists to hold them against
// sampling.winners_from_bits and interval_from_bits over every uniform.
__global__ void __launch_bounds__(256)
map_raw_words_kernel(const int* __restrict__ words, Sampler smp, int n, int* __restrict__ out) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = winner_from_word<TPUSIM_MINERS>(static_cast<unsigned>(words[i]), smp.lo, smp.hi, 1);
  out[n + i] = interval_from_word(static_cast<unsigned>(words[n + i]), smp.mean[0]);
}

}  // namespace

// Launch map_raw_words_kernel on `stream` for n word pairs and the
// TPUSIM_MINERS thresholds lo, hi (uint32) and mean (float32, one value).
// Returns the launch's cudaError_t.
extern "C" int tpusim_map_raw_words(const void* words, const void* lo, const void* hi,
                                    const void* mean, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  const Sampler smp{static_cast<const unsigned*>(lo), static_cast<const unsigned*>(hi),
                    static_cast<const float*>(mean)};
  map_raw_words_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(words), smp, n, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
#endif
