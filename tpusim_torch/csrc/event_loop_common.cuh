// Helpers shared by the event-loop kernels (event_loop.cu for fast mode,
// event_loop_exact.cu for exact mode): the state constants, loads and stores
// of a leaf in its own type, b-indexed reads as selects, the arrival-group
// buffer (split K = 2 slots, and the generic K >= 3 slots), the flight
// recorder's ring rows, the wide variants' state held in place in the
// output leaves (Column, WideGroups), the raw-word variants' mapping of a
// step's threefry words (Sampler, draw_raw, and map_raw_words_kernel, the
// mapping alone) and the one-hot variants' contractions (contract_b,
// contract_col).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// One library per miner count: the build passes -DTPUSIM_MINERS=<M>
// (tpusim_torch/csrc/build.py), so a run compiles only the M it uses.
#ifndef TPUSIM_MINERS
#error "compile with -DTPUSIM_MINERS=<miner count>"
#endif

// The wide variants (-DTPUSIM_WIDE=1, built for rosters of more than 16
// miners): a run's per-miner state lives in its output leaves in global
// memory and loops over miners stay rolled, so any miner count compiles.
// Without the flag a run's state lives in registers, every miner loop is
// unrolled, and 16 miners is the limit.
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
constexpr int kThreads = 64;
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

// v[b] for a run-dependent index b, as selects over a compile-time range.
template <int M>
__device__ __forceinline__ int pick(const int (&v)[M], int b) {
  int x = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) x = (m == b) ? v[m] : x;
  return x;
}

#if TPUSIM_ONEHOT
// v[b] as the one-hot contraction sum_m v[m] * [m == b]
// (tpusim/pallas_engine.py:442-449): the one-hot variants' read of what pick
// selects.
template <int M>
__device__ __forceinline__ int contract_b(const int (&v)[M], int b) {
  int x = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) x += v[m] * (m == b);
  return x;
}
#endif

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

// Step s's (winner, interval) for run r from its two raw words (K5a): the
// mapping that the other variants find already done in their rows. A
// kernel draws only on a step where a block is found: nothing else reads
// the pair.
template <int M, bool PACKED>
__device__ __forceinline__ void draw_raw(const int* rows, int s, int r, long R,
                                         const Sampler& smp, int& wq, int& dt) {
  const unsigned w = static_cast<unsigned>(rows[(2L * s) * R + r]);
  const unsigned wi = static_cast<unsigned>(rows[(2L * s + 1) * R + r]);
  const long off = PACKED ? r : 0, stride = PACKED ? R : 1;
  wq = winner_from_word<M>(w, smp.lo + off, smp.hi + off, stride);
  dt = interval_from_word(wi, smp.mean[off]);
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

// The arrival row's operands from the step-entry groups at time t: the
// earliest arrived group over all miners (kInf if none) and its owner, the
// lowest index on ties (pallas_engine.py:574-588).
template <int M>
__device__ __forceinline__ void earliest_arrived(const int (&a0)[M], const int (&a1)[M], int t,
                                                 int& pmin, int& owner) {
  pmin = kInf;
  owner = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int pm = min(a0[m] <= t ? a0[m] : kInf, a1[m] <= t ? a1[m] : kInf);
    if (pm < pmin) {
      pmin = pm;
      owner = m;
    }
  }
}

// earliest_arrived over K >= 3 slots (pallas_engine.py:581-588).
template <int M, int K>
__device__ __forceinline__ void earliest_arrived_k(const int (&ga)[M][K], int t, int& pmin,
                                                   int& owner) {
  pmin = kInf;
  owner = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    int pm = kInf;
#pragma unroll
    for (int k = 0; k < K; ++k) pm = min(pm, ga[m][k] <= t ? ga[m][k] : kInf);
    if (pm < pmin) {
      pmin = pm;
      owner = m;
    }
  }
}

// One run's column of a runs-last leaf of type T: entry e at p[e * R], read
// as int and stored in T. The wide kernels address a run's state through
// these by a dynamic miner index; a warp's access to one entry is 32
// neighbouring elements.
template <typename T>
struct Column {
  T* p;
  long R;

  __device__ __forceinline__ Column(void* base, int r, long runs)
      : p(static_cast<T*>(base) + r), R(runs) {}
  __device__ __forceinline__ int operator()(long e) const { return static_cast<int>(p[e * R]); }
  __device__ __forceinline__ void set(long e, int v) const { p[e * R] = static_cast<T>(v); }
};

#if TPUSIM_ONEHOT
// Entry base + b * stride of a run's column for the run-dependent b, as the
// one-hot contraction sum_p c(base + p * stride) * [p == b] over the M
// miners (K5b): M loads where the other wide variants load one entry.
template <typename T>
__device__ __forceinline__ int contract_col(const Column<T>& c, long base, long stride, int b,
                                            int M) {
  int x = 0;
#pragma unroll 4
  for (int p = 0; p < M; ++p) x += c(base + p * stride) * (p == b);
  return x;
}
#endif

// Entries a wide kernel loads before it stores any of them. Its leaves are
// plain pointers that the compiler must assume may alias, so a load cannot
// move above an earlier store: without batching, each copied entry waits a
// whole memory round trip.
constexpr int kBatch = 8;

// Miners a wide kernel's per-event pass loads before it flushes any.
constexpr int kMinerBatch = 4;

// use(e, load(e)) for e in [0, n), kBatch loads issued before their uses.
template <typename Load, typename Use>
__device__ __forceinline__ void batched(long n, Load load, Use use) {
#pragma unroll 1
  for (long e0 = 0; e0 < n; e0 += kBatch) {
    int v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = e0 + u < n ? load(e0 + u) : 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (e0 + u < n) use(e0 + u, v[u]);
    }
  }
}

// The first pass of a wide kernel's adopting event: which miners adopt
// (adopt[i]: height below best_h), and each adopter's reorg stale accounting,
// its own blocks above lca(i, b): stale and stale_by_miner, the deepest pop
// dmax and, for the flight row, the deepest adopter (miner2, d2: the lowest
// index on ties). kMinerBatch miners' loads are issued before any store.
template <typename C, typename S>
__device__ __forceinline__ void stale_pass(int M, int best_h, int b, const Column<C>& height,
                                           const Column<C>& ocnt, const Column<C>& ocp,
                                           const Column<S>& stale, const Column<int>& sbm,
                                           bool* adopt, int& dmax, int& miner2, int& d2) {
#pragma unroll 1
  for (int i0 = 0; i0 < M; i0 += kMinerBatch) {
    int h[kMinerBatch], cnt[kMinerBatch], cpb[kMinerBatch], st[kMinerBatch], sb[kMinerBatch];
#pragma unroll
    for (int u = 0; u < kMinerBatch; ++u) {
      const long i = i0 + u;
      if (i >= M) break;
      h[u] = height(i);
      cnt[u] = ocnt(i);
#if TPUSIM_ONEHOT
      cpb[u] = contract_col(ocp, i * M, 1, b, M);
#else
      cpb[u] = ocp(i * M + b);
#endif
      st[u] = stale(i);
      sb[u] = sbm(i);
    }
#pragma unroll
    for (int u = 0; u < kMinerBatch; ++u) {
      const int i = i0 + u;
      if (i >= M) break;
      adopt[i] = best_h > h[u];
      if (!adopt[i]) continue;
      const int d_stale = cnt[u] - cpb[u];
      stale.set(i, st[u] + d_stale);
      if (d_stale > 0) sbm.set(i, sb[u] + 1);
      dmax = max(dmax, d_stale);
      if (d_stale > d2 || (miner2 == M && d_stale == d2)) {
        miner2 = i;
        d2 = d_stale;
      }
    }
  }
}

// This run's n entries of a runs-last leaf, copied from the input to the
// output: the wide kernels then update the output in place.
template <typename T>
__device__ __forceinline__ void copy_column(const void* in, void* out, long n, int r, long R) {
  const T* const src = static_cast<const T*>(in) + r;
  T* const dst = static_cast<T*>(out) + r;
  batched(
      n, [&](long e) { return static_cast<int>(src[e * R]); },
      [&](long e, int v) { dst[e * R] = static_cast<T>(v); });
}

// The wide kernels' view of one run's arrival groups: garr (M, K) int32 and
// gcnt (M, K) in the count type C, runs-last, in place in the output leaves.
// Each operation loads one miner's K slots into registers and applies the
// narrow kernels' helper to them (push2 and the split flush at K = 2,
// push_k and flush_k at K >= 3); a push stores them back, and a flush leaves
// the store to its caller, who needs it only when a group left.
template <typename C>
struct WideGroups {
  Column<int> arr;
  Column<C> cnt;

  __device__ __forceinline__ WideGroups(void* garr, void* gcnt, int r, long R)
      : arr(garr, r, R), cnt(gcnt, r, R) {}

  __device__ __forceinline__ void load(int m, int (&ga)[kSlots], int (&gc)[kSlots]) const {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      ga[k] = arr(static_cast<long>(m) * kSlots + k);
      gc[k] = cnt(static_cast<long>(m) * kSlots + k);
    }
  }

  __device__ __forceinline__ void store(int m, const int (&ga)[kSlots],
                                        const int (&gc)[kSlots]) const {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      arr.set(static_cast<long>(m) * kSlots + k, ga[k]);
      cnt.set(static_cast<long>(m) * kSlots + k, gc[k]);
    }
  }

  // Append (arrival, count) to miner m's groups. Returns 1 on overflow.
  __device__ __forceinline__ int push(int m, int arrival, int count) const {
    int ga[kSlots], gc[kSlots];
    load(m, ga, gc);
    int over;
    if constexpr (kSlots == 2) {
      over = push2(ga[0], ga[1], gc[0], gc[1], arrival, count, true);
    } else {
      over = push_k<kSlots>(ga, gc, arrival, count, true);
    }
    store(m, ga, gc);
    return over;
  }

  // Flush one miner's loaded groups arrived by t_flush: the last one's
  // arrival becomes `base`. Returns the count still unarrived; `flushed`
  // says whether the slots changed (and must be stored).
  __device__ __forceinline__ static int flush(int (&ga)[kSlots], int (&gc)[kSlots], int t_flush,
                                              int& base, bool& flushed) {
    flushed = false;
    int unarrived = 0;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      flushed |= ga[k] <= t_flush;
      unarrived += gc[k];
    }
    if (!flushed) return unarrived;
    if constexpr (kSlots == 2) {
      // The narrow kernels' split-slot flush.
      const bool f0 = ga[0] <= t_flush, f1 = ga[1] <= t_flush;
      base = f1 ? ga[1] : (f0 ? ga[0] : base);
      const int na0 = f1 ? kInf : (f0 ? ga[1] : ga[0]);
      const int na1 = f0 ? kInf : ga[1];
      const int nc0 = f1 ? 0 : (f0 ? gc[1] : gc[0]);
      const int nc1 = f0 ? 0 : gc[1];
      ga[0] = na0;
      ga[1] = na1;
      gc[0] = nc0;
      gc[1] = nc1;
      unarrived = nc0 + nc1;
    } else {
      unarrived = flush_k<kSlots>(ga, gc, t_flush, base);
    }
    return unarrived;
  }

  // Empty miner m's groups (an adopter's).
  __device__ __forceinline__ void clear(int m) const {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      arr.set(static_cast<long>(m) * kSlots + k, kInf);
      cnt.set(static_cast<long>(m) * kSlots + k, 0);
    }
  }

  // Miner m's earliest arrival after t (kInf if none): the cut-through's.
  __device__ __forceinline__ int pending(int m, int t) const {
    int e = kInf;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int a = arr(static_cast<long>(m) * kSlots + k);
      e = min(e, a > t ? a : kInf);
    }
    return e;
  }

  // Miner m's earliest group arrived by t (kInf if none): the arrival row's.
  __device__ __forceinline__ int arrived(int m, int t) const {
    int e = kInf;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int a = arr(static_cast<long>(m) * kSlots + k);
      e = min(e, a <= t ? a : kInf);
    }
    return e;
  }
};

// The narrow exact kernel's run group (event_loop_exact.cu): kGroupLanes
// lanes of one warp own one run, lane m its miner m, so a warp holds two
// runs. Every collective names the group's own lanes: the two runs of a
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
