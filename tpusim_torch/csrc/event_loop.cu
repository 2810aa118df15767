// Fast-mode event loop of the mining simulation, for Hopper (sm_90a).
//
// Replaces the fast-mode variant of tpusim/pallas_engine.py::_make_kernel
// (exact=False, split K=2 group slots, gather reads, pre-mapped int32
// (winner, interval) rows): one chunk of `steps` events for every run, each
// event a block find if one is due, the notify sweep (flush, best chain,
// reorg) and the cut-through time advance, plus the SimCounters updates.
// Above 16 miners (TPUSIM_WIDE, K1w) it also replaces the scan engine's
// fast step (tpusim/engine.py:335 _step_event), which the TPU runs for
// rosters its kernel's VMEM guard refuses (tpusim/pallas_engine.py:735-774).
// The plain PyTorch version of the same function is
// tpusim_torch/event_loop.py::event_loop_chunk_plain.
//
// Design. One body for every width: a group of L lanes of one warp steps a
// run, lane l owning miners l, l + L, ... (P = ceil(M / L) of them, slot k
// its miner l + L k). Up to 16 miners the group is 16 lanes, lane m miner m
// (P = 1, two runs a warp, 8 runs a 128-thread block); above 16 miners, and
// in the flight variants at any M, it is RunWarp's whole warp (P = ceil(M /
// 32), 4 runs a block). Lanes that own no
// miner hold neutral values (empty groups, a published height of -kInf).
// Each lane keeps its miners' leaves in registers: height, stale, base,
// the K group slots (a0/a1/c0/c1 at K = 2, ga/gc[K] at K >= 3), own count,
// stale_by_miner and delay; every lane keeps the run's scalars (t, nbt, the
// counters), lane k < 8 bucket k of rdh, lane 0 the flight ring's cursor.
// What was a loop over miners is a fold over a lane's P miners, then one
// collective over the group: the flush and the published heights, the best
// height a max, the first-seen tip among the best a min, b the lowest such
// miner, the adopters a ballot and the deepest pop a max, the cut-through a
// min; b's height and own count are a shuffle from b's lane. A warp's runs
// step together: a run that has finished steps on inactive, and every branch
// that holds a collective is taken by the whole warp when any of its runs
// needs it, each run's effects gated by its own predicates. So every
// collective takes the full mask (RunPair reduces the warp's two halves
// apart): a reduction whose mask differs between the lanes of a converged
// warp runs once for each distinct mask.
//
// The tables. In fast mode the adoption sets own_cp[i][j] from a value that
// depends only on i (b's published count row at i for an adopter i, else its
// own_cp column toward b), under adopt[i] | adopt[j], and own_in[i][j] from a
// value that depends only on j (b's published count row at j), under
// adopt[i]; the reads are own_cp[i][b] and own_in[b][j]
// (tpusim/pallas_engine.py:440, 457, 509-523). So the lane of miner i keeps
// row i of own_cp and column i of own_in, as a row of a transposed table:
// every read is an index by b into the lane's own row, every write a loop
// over the lane's own row under the adopters' ballot, and no lane touches
// another's entries (so no barrier orders them: a lane's program order
// does). The rows live in shared memory in the count type, kRow counts
// apart, an odd number of 4-byte words, so that the lanes' reads of entry b
// fall in distinct banks. A block copies its runs' tables in at entry and
// out at exit, consecutive threads on consecutive runs of one entry of the
// runs-last leaves, own_in transposed on the way in and back on the way out.
//
// What bounds it. Per busy chunk at the default R = 8192 and 1856 steps the
// kernel must read the rows (steps x 2 x R int32, 122 MB) and read and write
// about 0.6 KB of state and counters per run: 132 MB, 0.04 ms at 3.35 TB/s.
// The integer work is larger: the function needs 29 M + 20 int32 operations
// per active event (flush, best chain, adoption test, cut-through) and 30
// more per find (the winner's arrival group), and 3 M + 2 K + 5 for each
// (miner, event) pair in which the miner adopts (its own_cp row, its column
// in the other rows, its own_in column, its scalars and slots), less a^2 on
// an event with a adopters (an own_cp entry whose row and column both adopt
// is written once): chip_smoke.py counts the adopting pairs of the chunk it
// times and the sum of their squares. In
// practice every lane of a group executes the event's whole sequence,
// collectives included, so the card's instruction issue sets the time.
//
// Counts are computed in int32 and stored in the leaf's type: every count
// stays within SimConfig.count_bound, so the result is that of the
// reference's int16 arithmetic.
//
// The flight recorder (FLIGHT = true, K3f). Replaces the flight-ring variant
// of the same Pallas kernel (flight_capacity > 0: the ring writes at
// tpusim/pallas_engine.py:548-609, the ring operands at :1040-1050): every
// step also writes up to two int32 rows of 6 fields into its run's ring
// (C, 6, R), the find or arrival, then the stale or reorg, at slot
// count % C. The arrival row is classified on the step-entry groups, taken
// before the find's push overwrites them: the earliest arrived group and its
// owner, the lowest miner on ties; a reorg row's miner is the adopter with
// the deepest pop, the lowest on ties. The rows' heights are after the
// adoption, except the find's, and add the read-only origin h_base; the time
// pair is (base_hi, base_lo + t), un-normalized, as the reference stores it.
// The capacity C is a runtime argument. The wrapper copies the input ring to
// the output once per chunk (about 201 MB each way at C = 1024 and R =
// 8192) and lane 0 of a run's group writes only the rows it records into its
// run's runs-last column. What bounds it: K1's operations plus about 4 M a
// step for the entry-slot minimum and its owner and 3 M an adopting step for
// the deepest adopter, and K1's bytes plus the ring read and written once;
// chip_smoke.py counts both from the chunk it times. Every flight statement
// sits under `if (FLIGHT)`, and the flight variants are built as libraries
// of their own (-DTPUSIM_FLIGHT=1).
//
// Packed grids (PACKED = true, K4f). Replaces the packed variant of the same
// Pallas kernel (packed=True, tpusim/pallas_engine.py:1065-1081): a sweep
// grid's points share one launch, each run with its own point's roster. The
// per-run winner thresholds and mean interval stay in the sampler's torch
// ops, as in the reference, so they reach the kernel already mapped into the
// rows; what the kernel itself takes per run is the propagation delay of
// every miner, prop (M, R) runs-last, where the other variants read one
// (M,) vector for all runs: each lane loads its miners' delays of its run
// once at entry, and the event loop is K1's. What bounds it: K1's
// operations, and K1's bytes plus the (M, R) delays (0.3 MB at R = 8192).
// The packed variant is a library of its own (-DTPUSIM_PACKED=1).
//
// Generic group slots (K >= 3, K5c). Replaces the generic K-slot arrival-group
// machinery of the same Pallas kernel (group_slots >= 3: push_groups at
// tpusim/pallas_engine.py:233-249, the flush and compaction at :367-379, the
// adoption clear and cut-through at :535-539), which the reference's K = 2
// split slots route around. The build passes -DTPUSIM_GROUP_SLOTS=<K>. A
// lane keeps each of its miners' buffers as int ga[K], gc[K]; every slot
// index is a compile-time one after unrolling (a push, the flush and the
// compaction are selects against the miner's occupied and arrived counts),
// so the buffer lives in registers. A push merges an equal arrival into the
// last occupied slot and, when all K are full, merges into slot K - 1 and
// counts the overflow; a flush moves the tip of the arrived prefix into base
// and shifts the rest left, kInf and 0 filling the tail. What bounds it: K1's
// operations with the group terms at K slots (per miner and active event
// 9 K + 11, 29 at K = 2; per find 5 K + 20, 30 at K = 2), and K1's bytes
// with (M, K, R) groups. chip_smoke.py counts both. Every generic statement
// sits in the `else` of an `if constexpr (kSlots == 2)`, and a K = 2 build
// takes no flag.
//
// Packed grids with the flight recorder (PACKED and FLIGHT, K4 x K3): the
// two compose as they are, the ring code K3's and the per-run operands K4's,
// each at its own argument offsets, in a library of their own
// (-DTPUSIM_PACKED=1 -DTPUSIM_FLIGHT=1).
//
// Wide rosters (TPUSIM_WIDE, K1w): the same body with a warp a run, built
// with -DTPUSIM_WIDE=1 for any M, with FLIGHT, PACKED and any K as above. A
// lane's P miners are arrays folded before each collective, and the adopters
// are P ballot words, so no miner set is limited to a mask's width.
//
// Raw words (TPUSIM_RAW_WORDS, K5a). Replaces the same Pallas kernel with
// rng_batch=False (tpusim/pallas_engine.py:293-309), in every variant above:
// a step's row holds its two raw threefry words (int32 bit patterns), and on
// a step where a block is found the run's lanes map them: the winner by
// the uint32 threshold intervals, each lane testing its own miners'
// (loaded once at entry) and the group's max picking the last that holds,
// as winner_from_word does; the interval in every lane by the F1
// transcription of XLA:CPU's log1p (interval_from_word in
// event_loop_common.cuh), every float operation an explicitly rounded
// intrinsic so that nvcc contracts none but the 24 multiply-adds XLA
// contracts. The thresholds and the mean are a Sampler, the kernel's last
// parameter (per run when PACKED). What bounds it: K1's operations plus,
// per find, 87 float32 operations and 4 M + 5 int32 ones; K1's bytes with
// the raw words in place of the mapped rows, the same size. Every raw-word
// statement sits under `#if TPUSIM_RAW_WORDS`.
//
// One-hot reads (TPUSIM_ONEHOT, K5b). Replaces the same Pallas kernel with
// consensus_gather=False (tpusim/pallas_engine.py:442-449, 459-461): each read
// indexed by the best chain's owner b is the contraction sum_m v[m] * [m == b]
// over the miner axis: b's height and own count a group sum, own_cp's column
// b and own_in's row b a sum over each lane's whole row. Only one term is
// nonzero, so the values are the gather's. What bounds it: K1's operations
// plus 2 M (2 M + 2) for the contractions of each adopting event.
//
// Consumed rows (TPUSIM_CONSUMED_ROWS, X2). The xoroshiro path's form of every
// variant above but the raw-word one, for which the reference has no Pallas
// kernel (it runs rng="xoroshiro" on its scan engine, tpusim/engine.py:588-624
// body_wide): the rows are a run's next draws in the order it consumes them
// (the row sampler X1, xoroshiro.cu), so a run reads row c, its finds so far
// in the chunk, where the others read row s, and lane 0 writes the final
// count to `consumed_out`, which X1 advances the run's streams by before the
// next chunk. A find loads the next row a step ahead, through a pointer that
// moves a row pair a find (no index multiplied out each step). What bounds
// it: K1's. Every statement the flag adds sits under `#if TPUSIM_CONSUMED_ROWS`.
//
// Per-event xoroshiro draws (TPUSIM_XORO_WORDS, X2r). The xoroshiro path with
// rng_batch=False: the reference's per-event body (tpusim/engine.py:625-634
// body_seq, _step_xoro at :399), in every variant X2 has. The kernel reads no
// rows: a run's group keeps a tile of its next kLanes finds' (winner,
// interval) pairs, one a lane (xoro_tile.cuh), and a find takes its pair
// from lane `used` by a shuffle. The find that finds the tile used up has
// the group refill it, under a branch the whole warp takes when any of its
// runs needs it: lanes 0 and 1 advance the run's interval and winner
// streams kLanes draws (integer work) and hand word j of each to lane j by
// shuffles, and lane j maps its pair, the winner as the count of the run's
// uint64 thresholds at or below the word (each lane holds its own miners',
// loaded once at entry, and hands them round), clamped to the last miner,
// the interval by the float64 glibc log1p transcription. So the warp issues
// the float64 map once for kLanes finds of a run, not once a find. A stream
// moves only on a find: lanes 0 and 1 keep it at the tile's start and store
// it advanced by the pairs taken, so the words go to the finds in order, as
// X1 + X2 hand them out. What bounds it: K1's operations plus, per find, two
// stream draws (about 10 64-bit operations each), M 64-bit compares and the
// float64 interval map (about 40 float64 operations); K1's bytes less the
// rows, plus the streams (32 bytes a run each way). Every statement the flag
// adds sits under `#if TPUSIM_XORO_WORDS`.

#include <type_traits>

#include "event_loop_common.cuh"

// Fast mode on a selfish roster (-DTPUSIM_FAST_SELFISH=1, K1s; with FLIGHT
// K3fs, with PACKED K4fs): the private chain and the selfish branches, as
// the exact kernel has them (the file's header), their per-lane rules in
// fast_selfish_step.cuh. The selfish flags are one more operand: their bit
// mask (bit m for miner m), or per run (M, R) int32 when PACKED. A find's
// race or private append changes its one push; the reveal, a second push,
// runs only on the warp-steps in which a lane of the warp reveals or
// adopts, under the adoption's vote of the whole warp, not predicated in
// every lane on every step (a third of a busy chunk's warp-steps reveal on
// the selfish rosters, and nearly all of those adopt too). Without the flag
// the kernel's text is as it was.
#ifndef TPUSIM_FAST_SELFISH
#define TPUSIM_FAST_SELFISH 0
#endif
static_assert(!TPUSIM_FAST_SELFISH || !(TPUSIM_WIDE || TPUSIM_RAW_WORDS || TPUSIM_ONEHOT ||
                                        TPUSIM_CONSUMED_ROWS || TPUSIM_GROUP_SLOTS != 2),
              "the fast selfish kernel: narrow rosters at K = 2 on pre-mapped threefry rows");
#if TPUSIM_FAST_SELFISH && TPUSIM_XORO_WORDS
#error "the fast selfish kernel runs on pre-mapped threefry rows"
#endif
#if TPUSIM_FAST_SELFISH
#include "fast_selfish_step.cuh"
#endif
#if TPUSIM_FAST_SELFISH && TPUSIM_PACKED
#define TPUSIM_SELFISH_PARAM , const int* __restrict__ selfish_in
#define TPUSIM_SELFISH_ARG , selfish_in
#define TPUSIM_SELFISH_C_PARAMS , const void *selfish
#define TPUSIM_SELFISH_C_ARGS , static_cast<const int*>(selfish)
#elif TPUSIM_FAST_SELFISH
#define TPUSIM_SELFISH_PARAM , unsigned selfish_mask
#define TPUSIM_SELFISH_ARG , selfish_mask
#define TPUSIM_SELFISH_C_PARAMS , unsigned selfish_mask
#define TPUSIM_SELFISH_C_ARGS , selfish_mask
#else
#define TPUSIM_SELFISH_PARAM
#define TPUSIM_SELFISH_ARG
#define TPUSIM_SELFISH_C_PARAMS
#define TPUSIM_SELFISH_C_ARGS
#endif

namespace {

#if TPUSIM_FAST_SELFISH
constexpr int kLeaves = 18;  // 11 state + 5 counter leaves, then bhp and npriv
#else
constexpr int kLeaves = 16;  // 11 state + 5 counter leaves
#endif

struct Leaves {
  void* p[kLeaves];
};

constexpr int kBlockThreads = 128;

// Lanes a run: a warp (RunWarp, lane l miners l, l + 32, ...) above 16
// miners and in the flight recorder's variants, whose ring rows cost less
// with a warp a run; else 16, lane m miner m, the warp's two runs stepping
// together (RunPair). scripts/fast_variants.py times these against 16 lanes
// in the flight variants, 8 lanes and a warp a run at M = 9.
constexpr int kLanes = (TPUSIM_WIDE || TPUSIM_FLIGHT) ? kWarpLanes : kGroupLanes;
using Group = std::conditional_t<kLanes == kWarpLanes, RunWarp, RunPair>;
static_assert(kLanes >= kBuckets, "a lane holds each bucket of rdh");

// A run's lanes: the group helper G of L lanes, lane l owning miners l,
// l + L, ... (P of them, slot k its miner l + L k). A per-miner value is held
// as v[P] in each lane; the helpers fold a lane's P slots and then reduce
// over the group.
template <class G, int L, int P>
struct Team {
  G g;
  int lane;

  __device__ __forceinline__ explicit Team(int thread) : g(thread), lane(thread % L) {}

  __device__ __forceinline__ int miner(int k) const { return lane + L * k; }
  // Bit l set where lane l's predicate holds.
  __device__ __forceinline__ unsigned ballot(bool p) const { return g.ballot(p); }
  __device__ __forceinline__ int add(int v) const { return g.add(v); }
  // Whether p, a run's predicate, holds for any run of the warp, whose runs
  // step together (a warp a run: p itself).
  __device__ __forceinline__ bool any(bool p) const {
    if constexpr (L == kWarpLanes) {
      return p;
    } else {
      return __any_sync(kFullMask, p);
    }
  }

  // Miner m's v: its slot picked in every lane, then lane m % L's.
  __device__ __forceinline__ int of(const int (&v)[P], int m) const {
    int x = v[0];
#pragma unroll
    for (int k = 1; k < P; ++k) x = (m / L == k) ? v[k] : x;
    return g.from(x, m % L);
  }

  // The lowest miner whose p holds (kInf if none).
  __device__ __forceinline__ int lowest(const bool (&p)[P]) const {
    if constexpr (P == 1) {
      const unsigned bits = g.ballot(p[0]);
      return bits ? __ffs(bits) - 1 : kInf;
    } else {
      int x = kInf;
#pragma unroll
      for (int k = P - 1; k >= 0; --k) x = p[k] ? miner(k) : x;
      return g.min(x);
    }
  }

  // The group's max, min and sum of a per-miner value.
  __device__ __forceinline__ int max_of(const int (&v)[P]) const {
    int x = v[0];
#pragma unroll
    for (int k = 1; k < P; ++k) x = ::max(x, v[k]);
    return g.max(x);
  }
  __device__ __forceinline__ int min_of(const int (&v)[P]) const {
    int x = v[0];
#pragma unroll
    for (int k = 1; k < P; ++k) x = ::min(x, v[k]);
    return g.min(x);
  }
  __device__ __forceinline__ int add_of(const int (&v)[P]) const {
    int x = v[0];
#pragma unroll
    for (int k = 1; k < P; ++k) x += v[k];
    return g.add(x);
  }
};

// A block's tables in shared memory, in the count type C: for each of its
// kRuns runs, kLanes * P rows of own_cp (row i: miner i's own_cp row) and as
// many of own_in transposed (row j: miner j's own_in column), each row kRow
// counts, an odd number of 4-byte words (so that the rows of consecutive
// lanes start in other banks); run q's row of miner m is row q * kLanes * P
// + m, the lane's own.
template <int M, typename C>
struct Tables {
  static constexpr int kSize = static_cast<int>(sizeof(C));
  static constexpr int P = (M + kLanes - 1) / kLanes;
  static constexpr int kRuns = kBlockThreads / kLanes;
  static constexpr int kRunRows = kLanes * P;
  static constexpr int kRow = (((M * kSize + 3) / 4) | 1) * 4 / kSize;
  static constexpr int kTable = kRuns * kRunRows * kRow;  // counts a table
  static constexpr int kSmem = 2 * kTable * kSize;
};

// The block's runs' own_cp and own_in between their runs-last leaves and the
// tables (own_in transposed): consecutive threads take consecutive runs of
// one entry, so a warp's accesses to a leaf fall in a few 32-byte sectors.
template <int M, typename C, bool IN>
__device__ __forceinline__ void copy_tables(C* tables, const Leaves& in, const Leaves& out,
                                            int r0, int n_runs, long R) {
  using T = Tables<M, C>;
  for (int i = threadIdx.x; i < T::kRuns * M * M; i += kBlockThreads) {
    const int q = i % T::kRuns, e = i / T::kRuns;
    if (r0 + q >= n_runs) continue;
    const int row = q * T::kRunRows;
    C& x = tables[(row + e / M) * T::kRow + e % M];
    C& y = tables[T::kTable + (row + e % M) * T::kRow + e / M];
    if (IN) {
      x = static_cast<const C*>(in.p[7])[e * R + r0 + q];
      y = static_cast<const C*>(in.p[8])[e * R + r0 + q];
    } else {
      static_cast<C*>(out.p[7])[e * R + r0 + q] = x;
      static_cast<C*>(out.p[8])[e * R + r0 + q] = y;
    }
  }
}

// Leaf order: t, nbt, height, stale, base, garr, gcnt, ocp, oin, ocnt, ovf,
// then the counters mre, sev, act, sbm, rdh (tpusim_torch.event_loop), then
// in a selfish build bhp and npriv.
// C is the count type, S the type of `stale`. A run a group of kLanes lanes,
// Tables<M, C>::kRuns runs a block (the file's header).
// X2r holds a thread to 64 registers, 8 blocks an SM, so that 8,192 runs
// (1,024 blocks) take one wave: its tile's streams, read only by a refill,
// take the few bytes it spills. The others stay within that unasked.
#if TPUSIM_XORO_WORDS
#define TPUSIM_FAST_BOUNDS __launch_bounds__(kBlockThreads, 8)
#else
#define TPUSIM_FAST_BOUNDS __launch_bounds__(kBlockThreads)
#endif
template <int M, typename C, typename S, bool FLIGHT, bool PACKED>
__global__ void TPUSIM_FAST_BOUNDS
event_loop_kernel(const int* __restrict__ rows, const int* __restrict__ cap_in,
                  const int* __restrict__ prop_in, Leaves in, Leaves out,
                  int steps, int n_runs, Flight fl TPUSIM_SAMPLER_PARAM TPUSIM_SELFISH_PARAM) {
  using T = Tables<M, C>;
  constexpr int P = T::P;
  extern __shared__ __align__(16) unsigned char smem[];
  const long R = n_runs;
  const int r0 = blockIdx.x * T::kRuns;
  const int q = threadIdx.x / kLanes;  // the run's place in the block
  const int r = r0 + q;
  const Team<Group, kLanes, P> g(threadIdx.x);
  C* const tables = reinterpret_cast<C*>(smem);
  copy_tables<M, C, true>(tables, in, out, r0, n_runs, R);
  __syncthreads();

  // Every thread steps the loop, so that each collective finds all the
  // lanes of its warp: a group past the last run is inactive throughout.
  const bool live = r < n_runs;
  {
    // The run's scalars, the same in every lane.
    int t = 0, nbt = 0, mre = 0, sev = 0, act = 0, cap = 0;
    int rdh = 0;  // bucket `lane` of rdh
    FlightRun fr;
    if (live) {
      t = ld<int>(in.p[0], r);
      nbt = ld<int>(in.p[1], r);
      mre = ld<int>(in.p[11], r);
      sev = ld<int>(in.p[12], r);
      act = ld<int>(in.p[13], r);
      cap = cap_in[r];
      if (g.lane < kBuckets) rdh = ld<int>(in.p[15], g.lane * R + r);
      if (FLIGHT && g.lane == 0) fr.load(fl, r, R);
    }
#if TPUSIM_FAST_SELFISH
    // The best published height at the last notify (the race test's), the
    // same in every lane.
    int bhp = live ? ld<C>(in.p[16], r) : 0;
    bool sel[P];   // the slot's miner is selfish
    int npriv[P];  // its private blocks
#endif
    int ovf = 0;  // this lane's overflows; the run's are their sum
    // Slot k's miner's leaves and table rows; a slot without a miner holds
    // empty groups.
    bool own[P];
    int height[P], stale[P], base[P], ocnt[P], sbm[P], prop[P];
    int a0[P], a1[P], c0[P], c1[P];
    int ga[P][kGenSlots], gc[P][kGenSlots];
    C* ocp[P];  // ocp[k][j] = own_cp[miner][j]
    C* oin[P];  // oin[k][i] = own_in[i][miner]
#if TPUSIM_RAW_WORDS
    unsigned lo[P], hi[P];  // the miner's winner interval [lo, hi) (K5a)
#endif
#if TPUSIM_XORO_WORDS
    unsigned long long thr[P];  // the miner's cumulative uint64 threshold (X2r)
#endif
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int m = g.miner(k);
      own[k] = live && m < M;
      height[k] = stale[k] = base[k] = ocnt[k] = sbm[k] = prop[k] = 0;
      a0[k] = a1[k] = kInf;
      c0[k] = c1[k] = 0;
#pragma unroll
      for (int s = 0; s < kGenSlots; ++s) {
        ga[k][s] = kInf;
        gc[k][s] = 0;
      }
      ocp[k] = tables + (q * T::kRunRows + m) * T::kRow;
      oin[k] = ocp[k] + T::kTable;
#if TPUSIM_RAW_WORDS
      lo[k] = hi[k] = 0;
#endif
#if TPUSIM_XORO_WORDS
      thr[k] = 0ull;
#endif
#if TPUSIM_FAST_SELFISH
      sel[k] = false;
      npriv[k] = 0;
#endif
      if (!own[k]) continue;
      height[k] = ld<C>(in.p[2], m * R + r);
      stale[k] = ld<S>(in.p[3], m * R + r);
      base[k] = ld<int>(in.p[4], m * R + r);
      if constexpr (kSlots == 2) {
        a0[k] = ld<int>(in.p[5], (2 * m) * R + r);
        a1[k] = ld<int>(in.p[5], (2 * m + 1) * R + r);
        c0[k] = ld<C>(in.p[6], (2 * m) * R + r);
        c1[k] = ld<C>(in.p[6], (2 * m + 1) * R + r);
      } else {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          ga[k][s] = ld<int>(in.p[5], (m * kSlots + s) * R + r);
          gc[k][s] = ld<C>(in.p[6], (m * kSlots + s) * R + r);
        }
      }
      ocnt[k] = ld<C>(in.p[9], m * R + r);
      sbm[k] = ld<int>(in.p[14], m * R + r);
      prop[k] = PACKED ? prop_in[m * R + r] : prop_in[m];
#if TPUSIM_FAST_SELFISH
      npriv[k] = ld<C>(in.p[17], m * R + r);
#if TPUSIM_PACKED
      sel[k] = selfish_in[m * R + r] != 0;
#else
      sel[k] = (selfish_mask >> m) & 1u;
#endif
#endif
#if TPUSIM_RAW_WORDS
      lo[k] = PACKED ? smp.lo[m * R + r] : smp.lo[m];
      hi[k] = PACKED ? smp.hi[m * R + r] : smp.hi[m];
#endif
#if TPUSIM_XORO_WORDS
      thr[k] = threshold64(xo, PACKED ? m * R + r : m);
#endif
    }
#if TPUSIM_XORO_WORDS
    // The run's tile of its next kLanes finds' pairs (X2r, xoro_tile.cuh).
    XoroTile<kLanes> xt;
    if (live) xt.load(xo.streams_in + 8 * r, g.lane, xo.mean[PACKED ? r : 0]);
#endif
#if TPUSIM_RAW_WORDS
    const float mean = live ? smp.mean[PACKED ? r : 0] : 0.0f;
#endif

#if !TPUSIM_XORO_WORDS
    // The step's row, loaded a step ahead: its latency overlaps the step
    // before it.
    int row0 = 0, row1 = 0;
    if (live) {
      row0 = rows[r];
      row1 = rows[R + r];
    }
#endif
#if TPUSIM_CONSUMED_ROWS
    int used = 0;  // the rows this run's finds consumed this chunk (X2)
    const int* next_row = rows + r;  // row `used`'s winner entry
#endif
    for (int s = 0; s < steps; ++s) {
      // An inactive step changes nothing, and a run stays inactive to the
      // end of the chunk (t moves only while t < cap): stopping is exact.
      // The warp leaves when all its runs are inactive; until then every
      // branch that holds a collective is taken by the whole warp.
      const bool active = t < cap;
      if (!g.any(active)) break;
#if !TPUSIM_XORO_WORDS
      const int w0 = row0, w1 = row1;
#endif
#if TPUSIM_XORO_WORDS
      // X2r: no rows; the draws are the streams' next words, below.
#elif TPUSIM_CONSUMED_ROWS
      // X2: the row is the run's next draw, and only a find consumes it;
      // the next find reads the row after it, one row pair further on.
      if (live && active && t == nbt && ++used < steps) {
        next_row += 2 * R;
        row0 = next_row[0];
        row1 = next_row[R];
      }
#else
      if (live && s + 1 < steps) {
        row0 = rows[(2L * s + 2) * R + r];
        row1 = rows[(2L * s + 3) * R + r];
      }
#endif
      const bool found_due = active && t == nbt;
#if TPUSIM_RAW_WORDS
      // The step's two raw words mapped on a find only: the winner is the
      // last miner whose interval holds the winner word (each lane tests
      // its own miners), and every lane maps the interval word itself.
      int wq = 0, dt = 0;
      if (g.any(found_due)) {
        int hit[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const unsigned w = static_cast<unsigned>(w0);
          const bool last = g.miner(k) == M - 1;
          hit[k] = own[k] && w >= lo[k] && (last || w < hi[k]) ? g.miner(k) : -1;
        }
        wq = max(g.max_of(hit), 0);
        dt = interval_from_word(static_cast<unsigned>(w1), mean);
      }
#elif TPUSIM_XORO_WORDS
      // X2r: a find takes the next pair of the run's tile; the find that
      // finds it used up first has the group draw and map the next kLanes
      // (only a find moves the streams).
      int wq = 0, dt = 0;
      if (g.any(found_due)) {
        const bool refill = found_due && xt.used == kLanes;
        if (g.any(refill)) xt.refill<M>(g.g, g.lane, refill, thr);
        xt.take(g.g, found_due, wq, dt);
      }
#else
      const int wq = w0, dt = w1;
#endif
      // The arrival row's operands, from the step-entry groups: the earliest
      // arrived group and its owner, the lowest miner on ties (row 1 of a
      // find step is the find's).
      int pmin = kInf, arr_miner = 0;
      if (FLIGHT && g.any(active && !found_due)) {
        int pm[P];
        bool at[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if constexpr (kSlots == 2) {
            pm[k] = arrived2(a0[k], a1[k], t);
          } else {
            pm[k] = arrived_k<kGenSlots>(ga[k], t);
          }
        }
        pmin = g.min_of(pm);
#pragma unroll
        for (int k = 0; k < P; ++k) at[k] = pm[k] == pmin;
        arr_miner = g.lowest(at);
      }

      // FoundBlock: the winner's own count, height and one arrival group.
      const bool won = found_due && 0 <= wq && wq < M;
      const int w_idx = won ? wq : 0;  // the find row's miner
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const bool ow = won && g.miner(k) == wq;
#if TPUSIM_FAST_SELFISH
        // A selfish winner appends privately or races (selfish_find): the
        // find's one push holds 2 blocks on a race, and a private append
        // pushes none. Only the winner's lane moves its count, and it holds
        // every operand, so no lane waits on another.
        int count;
        const bool pushes = selfish_find(ow, sel[k], npriv[k], bhp, height[k], count);
        ovf += push2(a0[k], a1[k], c0[k], c1[k], t + prop[k], count, pushes);
#else
        if constexpr (kSlots == 2) {
          ovf += push2(a0[k], a1[k], c0[k], c1[k], t + prop[k], 1, ow);
        } else {
          ovf += push_k<kGenSlots>(ga[k], gc[k], t + prop[k], 1, ow);
        }
#endif
        ocnt[k] += ow;
        height[k] += ow;
      }
      int h_found = 0;  // the find row's height
      if (FLIGHT && g.any(found_due)) {
        const int hw = g.of(height, w_idx);
        h_found = won ? hw : 0;
      }
      if (found_due) nbt = t + dt;

      // Notify sweep, deferred while another find is due at this ms: the
      // flush, then the best published chain, the first-seen tip among the
      // best, the lowest miner among those.
      const bool notify = active && !(found_due && nbt == t);
      const int t_flush = notify ? t : kNegGate;
      int pub[P], tip[P];
      bool is_best[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        int unarrived;
        if constexpr (kSlots == 2) {
          unarrived = flush2(a0[k], a1[k], c0[k], c1[k], t_flush, base[k]);
        } else {
          unarrived = flush_k<kGenSlots>(ga[k], gc[k], t_flush, base[k]);
        }
#if TPUSIM_FAST_SELFISH
        pub[k] = own[k] ? height[k] - unarrived - npriv[k] : -kInf;  // private excluded
#else
        pub[k] = own[k] ? height[k] - unarrived : -kInf;
#endif
      }
      const int best_h = g.max_of(pub);
#pragma unroll
      for (int k = 0; k < P; ++k) tip[k] = pub[k] == best_h ? base[k] : kInf;
      const int best_tip = g.min_of(tip);
#pragma unroll
      for (int k = 0; k < P; ++k) is_best[k] = pub[k] == best_h && base[k] == best_tip;
      const int b = g.lowest(is_best);
#if TPUSIM_FAST_SELFISH
      // Selfish reveal, with the reorg: a selfish miner whose chain is at
      // least as long as the best published one publishes enough private
      // blocks to match or beat it, all of them at a lead of one. Each lane
      // tests its own miners here (selfish_reveals; a lane without a miner
      // holds no selfish flag); the count and the push run in the
      // adoption's branch below. Height is unchanged, so the adoption test
      // is not.
      int lead[P];
      bool reveal[P];
      bool reveals = false;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        lead[k] = height[k] - best_h;
        reveal[k] = selfish_reveals(notify, sel[k], lead[k], npriv[k]);
        reveals |= reveal[k];
      }
#endif

      // Adoption: a miner adopts b's chain when it is strictly longer.
      bool adopt[P];
      unsigned amask[P];  // word k: bit l where lane l's slot k adopts
      unsigned any = 0;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        adopt[k] = own[k] && notify && best_h > height[k];
        amask[k] = g.ballot(adopt[k]);
        any |= amask[k];
      }
      int dmax = 0;
      int miner2 = M;  // the adoption row's miner: the deepest pop
#if TPUSIM_FAST_SELFISH
      // The reveal's count and push under the adoption's vote, taken on the
      // warp-steps in which a lane of the warp adopts or reveals (a vote of
      // the full warp in every form, a warp a run too): a revealing miner
      // does not adopt (its lead is at least 0), and the adoption below
      // changes nothing where no miner of the run adopts.
      if (__any_sync(kFullMask, any != 0 || reveals)) {
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int n = selfish_reveal(reveal[k], lead[k], npriv[k]);
          ovf += push2(a0[k], a1[k], c0[k], c1[k], t + prop[k], n, reveal[k]);
        }
#else
      if (g.any(any != 0)) {
#endif
        // Reads of b's entries, diagonals corrected from ocnt (the
        // authority): b's unpublished count and own count from b's lane, b's
        // column of own_cp and row of own_in at each of this lane's miners.
#if TPUSIM_ONEHOT
        // K5b: each as the contraction with the one-hot of b
        // (pallas_engine.py:442-449, 459-461): a group sum, and sums over
        // each miner's own_cp row and own_in column.
        int hb[P], cb[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          hb[k] = height[k] * (g.miner(k) == b);
          cb[k] = ocnt[k] * (g.miner(k) == b);
        }
        const int unpub_b = g.add_of(hb) - best_h;
        const int cnt_b = g.add_of(cb);
#else
        const int unpub_b = g.of(height, b) - best_h;
        const int cnt_b = g.of(ocnt, b);
#endif
        int rb[P], col[P], d_stale[P], score[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          int oc_b = 0, in_b = 0;
          if (own[k]) {
#if TPUSIM_ONEHOT
#pragma unroll 8
            for (int j = 0; j < M; ++j) {
              oc_b += static_cast<int>(ocp[k][j]) * (j == b);
              in_b += static_cast<int>(oin[k][j]) * (j == b);
            }
#else
            oc_b = ocp[k][b];
            in_b = oin[k][b];
#endif
          }
          const bool is_b = g.miner(k) == b;
          // b's published count row (own_in's row b, diagonal corrected) and
          // the own_cp column toward b, at this slot's miner.
          rb[k] = is_b ? cnt_b - unpub_b : in_b;
          col[k] = is_b ? cnt_b - unpub_b : oc_b;
          // Reorg stale accounting: own blocks above lca(miner, b).
          d_stale[k] = adopt[k] ? ocnt[k] - (is_b ? cnt_b : oc_b) : 0;
          stale[k] += d_stale[k];
          sbm[k] += d_stale[k] > 0;
          score[k] = adopt[k] ? d_stale[k] : -1;
        }
        dmax = g.max_of(d_stale);
        if (FLIGHT) {
          const int deepest = g.max_of(score);
          bool deep[P];
#pragma unroll
          for (int k = 0; k < P; ++k) deep[k] = adopt[k] && score[k] == deepest;
          miner2 = min(g.lowest(deep), M);
        }
        // Adoption (fast mode), every write into this lane's own rows: an
        // adopter's own_cp row takes b's published count at the adopter, the
        // other rows' columns toward the adopters their own_cp column toward
        // b, and own_in's rows of the adopters b's published count row (so
        // each miner's column, this lane's row of the transposed table,
        // takes the row's entry at that miner in the adopters' columns).
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if (!own[k]) continue;
          const int v = adopt[k] ? rb[k] : col[k];
#pragma unroll
          for (int j = 0; j < M; ++j) {
            const bool aj = (amask[j / kLanes] >> (j % kLanes)) & 1u;
            if (adopt[k] || aj) ocp[k][j] = static_cast<C>(v);
            if (aj) oin[k][j] = static_cast<C>(rb[k]);
          }
          if (adopt[k]) {
#if TPUSIM_FAST_SELFISH
            npriv[k] = 0;
#endif
            ocnt[k] = rb[k];
            height[k] = best_h;
            base[k] = best_tip;
            a0[k] = a1[k] = kInf;
            c0[k] = c1[k] = 0;
#pragma unroll
            for (int s = 0; s < kGenSlots; ++s) {
              ga[k][s] = kInf;
              gc[k][s] = 0;
            }
          }
        }
      }

#if TPUSIM_FAST_SELFISH
      if (notify) bhp = best_h;
#endif

      if (FLIGHT) {
        // Row 1: the find, or an arrival if the sweep flushed a group; row 2:
        // the adoption, if any. Heights are after the adoption except the
        // find's. Lane 0 keeps the run's ring cursor and writes the rows.
        const bool arrival = !found_due && notify && pmin < kInf;
        int h_arr = 0;
        if (g.any(arrival)) h_arr = g.of(height, arr_miner);
        if (g.lane == 0) {
          if (found_due || arrival) {
            fr.push(fl, r, R, found_due ? kKindFind : kKindArrival,
                    found_due ? w_idx : arr_miner, found_due ? h_found : h_arr, 0, t);
          }
          if (any) {
            fr.push(fl, r, R, dmax > 0 ? kKindStale : kKindReorg, miner2,
                    miner2 < M ? best_h : 0, dmax, t);
          }
        }
      }

      // Cut-through to the next event.
      int pend[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if constexpr (kSlots == 2) {
          pend[k] = pending2(a0[k], a1[k], t);
        } else {
          pend[k] = pending_k<kGenSlots>(ga[k], t);
        }
      }
      const int earliest = g.min_of(pend);
      if (active) t = max(min(nbt, earliest), t);

      mre = max(mre, dmax);
      sev += dmax > 0;
      act += active;
      if (dmax > 0 && g.lane == min(dmax, kBuckets) - 1) ++rdh;
    }

    ovf = g.add(ovf);
    if (live && g.lane == 0) {
      st<int>(out.p[0], r, t);
      st<int>(out.p[1], r, nbt);
      st<int>(out.p[10], r, ld<int>(in.p[10], r) + ovf);
      st<int>(out.p[11], r, mre);
      st<int>(out.p[12], r, sev);
      st<int>(out.p[13], r, act);
      if (FLIGHT) fr.store(fl, r, R);
#if TPUSIM_CONSUMED_ROWS
      consumed_out[r] = used;
#endif
#if TPUSIM_FAST_SELFISH
      st<C>(out.p[16], r, bhp);
#endif
    }
    if (live && g.lane < kBuckets) st<int>(out.p[15], g.lane * R + r, rdh);
#if TPUSIM_XORO_WORDS
    if (live) xt.store(xo.streams_out + 8 * r, g.lane);
#endif
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (!own[k]) continue;
      const int m = g.miner(k);
      st<C>(out.p[2], m * R + r, height[k]);
      st<S>(out.p[3], m * R + r, stale[k]);
      st<int>(out.p[4], m * R + r, base[k]);
      if constexpr (kSlots == 2) {
        st<int>(out.p[5], (2 * m) * R + r, a0[k]);
        st<int>(out.p[5], (2 * m + 1) * R + r, a1[k]);
        st<C>(out.p[6], (2 * m) * R + r, c0[k]);
        st<C>(out.p[6], (2 * m + 1) * R + r, c1[k]);
      } else {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          st<int>(out.p[5], (m * kSlots + s) * R + r, ga[k][s]);
          st<C>(out.p[6], (m * kSlots + s) * R + r, gc[k][s]);
        }
      }
      st<C>(out.p[9], m * R + r, ocnt[k]);
      st<int>(out.p[14], m * R + r, sbm[k]);
#if TPUSIM_FAST_SELFISH
      st<C>(out.p[17], m * R + r, npriv[k]);
#endif
    }
  }

  __syncthreads();
  copy_tables<M, C, false>(tables, in, out, r0, n_runs, R);
}

// One launch in count type C and stale type S: Tables<M, C>::kRuns runs a
// 128-thread block, their tables in dynamic shared memory; above 48 KB (40
// miners with int32 counts) the attribute raises the kernel's limit.
template <int M, typename C, typename S, bool FLIGHT, bool PACKED>
cudaError_t launch_typed(const int* rows, const int* cap, const int* prop, const Leaves& in,
                         const Leaves& out, int steps, int n_runs,
                         const Flight& fl TPUSIM_SAMPLER_PARAM TPUSIM_SELFISH_PARAM,
                         cudaStream_t stream) {
  using T = Tables<M, C>;
  const auto kernel = event_loop_kernel<M, C, S, FLIGHT, PACKED>;
  const dim3 grid((n_runs + T::kRuns - 1) / T::kRuns), block(kBlockThreads);
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (set != cudaSuccess) return set;
  kernel<<<grid, block, T::kSmem, stream>>>(rows, cap, prop, in, out, steps, n_runs,
                                            fl TPUSIM_SAMPLER_ARG TPUSIM_SELFISH_ARG);
  return cudaGetLastError();
}

template <int M, bool FLIGHT, bool PACKED>
cudaError_t launch_m(const int* rows, const int* cap, const int* prop, const Leaves& in,
                     const Leaves& out, int count16, int stale16, int steps, int n_runs,
                     const Flight& fl TPUSIM_SAMPLER_PARAM TPUSIM_SELFISH_PARAM,
                     cudaStream_t stream) {
  if (count16 && stale16) {
    return launch_typed<M, int16_t, int16_t, FLIGHT, PACKED>(
        rows, cap, prop, in, out, steps, n_runs, fl TPUSIM_SAMPLER_ARG TPUSIM_SELFISH_ARG, stream);
  }
  if (count16) {
    return launch_typed<M, int16_t, int32_t, FLIGHT, PACKED>(
        rows, cap, prop, in, out, steps, n_runs, fl TPUSIM_SAMPLER_ARG TPUSIM_SELFISH_ARG, stream);
  }
  if (!stale16) {
    return launch_typed<M, int32_t, int32_t, FLIGHT, PACKED>(
        rows, cap, prop, in, out, steps, n_runs, fl TPUSIM_SAMPLER_ARG TPUSIM_SELFISH_ARG, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch(const void* rows, const void* cap, const void* prop, void* const* in,
                   void* const* out, int n_miners, int count16, int stale16, int steps,
                   int n_runs, const Flight& fl TPUSIM_SAMPLER_PARAM TPUSIM_SELFISH_PARAM,
                   void* stream) {
  if (n_runs <= 0 || steps <= 0) return cudaSuccess;
  if (n_miners != TPUSIM_MINERS) return cudaErrorInvalidValue;
  Leaves lin, lout;
  for (int i = 0; i < kLeaves; ++i) {
    lin.p[i] = in[i];
    lout.p[i] = out[i];
  }
  const auto* rw = static_cast<const int*>(rows);
  const auto* cp = static_cast<const int*>(cap);
  const auto* pp = static_cast<const int*>(prop);
  const auto s = static_cast<cudaStream_t>(stream);
  return launch_m<TPUSIM_MINERS, TPUSIM_FLIGHT != 0, TPUSIM_PACKED != 0>(
      rw, cp, pp, lin, lout, count16, stale16, steps, n_runs,
      fl TPUSIM_SAMPLER_ARG TPUSIM_SELFISH_ARG, s);
}

}  // namespace

extern "C" {

#if TPUSIM_FLIGHT && TPUSIM_PACKED
// Launch one chunk of a packed grid with the flight recorder on `stream`:
// `prop` as tpusim_event_loop_packed_chunk takes it, `flight` and
// `capacity` as tpusim_event_loop_flight_chunk takes them.
int tpusim_event_loop_packed_flight_chunk(const void* rows, const void* cap, const void* prop,
                                          void* const* in, void* const* out, int n_miners,
                                          int count16, int stale16, int steps, int n_runs,
                                          void* const* flight, int capacity
                                          TPUSIM_SAMPLER_C_PARAMS TPUSIM_SELFISH_C_PARAMS,
                                          void* stream) {
  if (capacity < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Flight fl{static_cast<const int*>(flight[0]), static_cast<const int*>(flight[1]),
                  static_cast<int*>(flight[2]), static_cast<int*>(flight[3]),
                  static_cast<int*>(flight[4]), capacity};
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, count16, stale16, steps,
                                 n_runs, fl TPUSIM_SAMPLER_C_ARGS TPUSIM_SELFISH_C_ARGS,
                                 stream));
}
#elif TPUSIM_FLIGHT
// Launch one chunk with the flight recorder on `stream`, as
// tpusim_event_loop_chunk does without it. `flight` holds the device
// addresses of the count (1, R) and origins (3, R) read, then the ring
// (C, 6, R) already holding a copy of the input ring, the count and the
// origins written; `capacity` is C.
int tpusim_event_loop_flight_chunk(const void* rows, const void* cap, const void* prop,
                                   void* const* in, void* const* out, int n_miners,
                                   int count16, int stale16, int steps, int n_runs,
                                   void* const* flight, int capacity TPUSIM_SAMPLER_C_PARAMS
                                   TPUSIM_SELFISH_C_PARAMS, void* stream) {
  if (capacity < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Flight fl{static_cast<const int*>(flight[0]), static_cast<const int*>(flight[1]),
                  static_cast<int*>(flight[2]), static_cast<int*>(flight[3]),
                  static_cast<int*>(flight[4]), capacity};
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, count16, stale16, steps,
                                 n_runs, fl TPUSIM_SAMPLER_C_ARGS TPUSIM_SELFISH_C_ARGS,
                                 stream));
}
#elif TPUSIM_PACKED
// Launch one chunk of a packed grid on `stream`, as tpusim_event_loop_chunk
// does for one roster; `prop` holds the (M, R) runs-last int32 delays, one
// per (miner, run).
int tpusim_event_loop_packed_chunk(const void* rows, const void* cap, const void* prop,
                                   void* const* in, void* const* out, int n_miners,
                                   int count16, int stale16, int steps, int n_runs
                                   TPUSIM_SAMPLER_C_PARAMS TPUSIM_SELFISH_C_PARAMS,
                                   void* stream) {
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, count16, stale16, steps,
                                 n_runs, Flight{} TPUSIM_SAMPLER_C_ARGS TPUSIM_SELFISH_C_ARGS,
                                 stream));
}
#else
// Launch one chunk on `stream` for `n_miners` == TPUSIM_MINERS miners. `in`
// and `out` hold the 16 leaf pointers (device addresses) in the order above;
// `in` is only read. Returns the launch's cudaError_t (0 on success); the
// kernel runs asynchronously.
int tpusim_event_loop_chunk(const void* rows, const void* cap, const void* prop,
                            void* const* in, void* const* out, int n_miners,
                            int count16, int stale16, int steps, int n_runs
                            TPUSIM_SAMPLER_C_PARAMS TPUSIM_SELFISH_C_PARAMS, void* stream) {
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, count16, stale16, steps,
                                 n_runs, Flight{} TPUSIM_SAMPLER_C_ARGS TPUSIM_SELFISH_C_ARGS,
                                 stream));
}
#endif

const char* tpusim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
