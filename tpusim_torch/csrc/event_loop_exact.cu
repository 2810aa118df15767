// Exact-mode event loop of the mining simulation, for Hopper (sm_90a).
//
// Replaces the exact-mode variant of tpusim/pallas_engine.py::_make_kernel
// (exact=True, split K=2 group slots, gather reads, pre-mapped int32
// (winner, interval) rows), for honest rosters and, with SELFISH, for rosters
// with selfish miners: one chunk of `steps` events for every run, each event
// a block find if one is due (a selfish winner's private append, or the
// race), the notify sweep (flush, best published chain, selfish reveal,
// reorg with the exact common-prefix statistic cp) and the cut-through time
// advance, plus the SimCounters updates. The plain PyTorch version of the
// same function is tpusim_torch/event_loop.py::event_loop_chunk_plain.
//
// Design (rosters of up to 16 miners). A group of 16 lanes of one warp owns
// one run, lane m its miner m, so a warp holds two runs and a 128-thread
// block eight; at R = 8192 that is 1,024 blocks, about 8 an SM, all resident
// in one wave while a thread takes at most 64 registers. Lane m keeps miner
// m's leaves in registers (height, npriv, stale, base, its arrival-group
// slots, own count, stale_by_miner, delay, selfish flag); lanes M .. 15 own no
// miner and hold empty slots. Every lane keeps the run's scalars (t, nbt,
// bhp, the counters), lane k < 8 its bucket k of rdh, lane 0 the flight
// ring's cursor. What was a loop over miners is a reduction over the group,
// with the group's own mask (the two runs of a warp leave their loops at
// different steps): the best published height a max, the first-seen tip
// among the best a min, b the lowest such lane by ballot, the cut-through a
// min, the adopters a ballot, the flight row's deepest adopter a max and the
// lowest such lane; a read of b's scalar is a shuffle from lane b.
//
// A run's tables live in shared memory for the chunk, in the count type:
// own_cp (M, M), own_in (M, M), cp (M, M, M) with each row cp[i, j, :]
// padded to 16 bytes, and b's published count row b_pub (23,680 bytes a
// block at M = 9 with int16 counts; 36,736 with int32, which leaves room for
// 6 blocks an SM, two waves at R = 8192). The block copies them in at
// entry and out at exit, consecutive threads on consecutive runs of the
// runs-last leaves (((i * M + j) * M + o) * R + r). Lane m reads and writes
// row m of own_cp and column m of own_in, so b's column of own_cp and b's row
// of own_in at miner m are lane m's own loads. On an adopting event each lane
// writes its b_pub entry, then the group's lanes share the pairs (i, j) with
// an adopter, each a row of M counts copied as 16-byte words: b_pub, or the
// row cp[b, p, :] of a miner p that neither adopts nor is b. The update is
// done in place safely: it reads only the rows cp[b, p, :] of such p, and
// writes only rows cp[i, :, :] of adopters i and columns cp[:, j, :] of
// adopters j; b itself never adopts (its published height is the best). A
// __syncwarp of the group orders each event's writes before the next reads.
//
// What bounds it. Per busy chunk at R = 8192 and 1856 steps the function
// must read the rows (122 MB) and read and write the state (about 2 KB a
// run with int16 counts, 33 MB both ways). Its integer work is that of K1
// plus the private counts and the race test (~30 M + 20 operations an
// active event, 40 more a find) and 6 M + 10 per adopting miner for own_cp
// and own_in. An event with A adopters must store the adopters' cp rows and
// their columns in the other rows (A M^2 + (M - A) A M entries) and load
// only the M - A - 1 rows cp[b, p, :] it copies (the rest is b's published
// count row). chip_smoke.py counts the adopters of every event of a chunk by
// replay and takes the larger of the byte and the operation bound. In
// practice the card's instruction issue bounds it: every lane of a group
// executes the event's whole sequence, reductions included, and on an
// adopting event the row copies (6 pairs a lane at M = 9); the step's row is
// loaded a step ahead, so its latency overlaps the step before.
//
// Counts are computed in int32 and stored in the leaf's type: every count
// stays within SimConfig.count_bound, so the result is that of the
// reference's int16 arithmetic.
//
// The flight recorder (FLIGHT = true, K3x). Replaces the flight-ring variant
// of the same Pallas kernel in exact mode (flight_capacity > 0: the ring
// writes at tpusim/pallas_engine.py:548-609, the ring operands at
// :1040-1050), with and without SELFISH: every step also writes up to two
// int32 rows of 6 fields into its run's ring (C, 6, R), the find or
// arrival, then the stale or reorg, at slot count % C. The arrival row is
// classified on the step-entry groups, taken before the find's push
// overwrites them; a find row's height is the winner's right after the find,
// private blocks included; the rows' heights add the read-only origin
// h_base, and the time pair is (base_hi, base_lo + t), un-normalized, as
// the reference stores it. The capacity C is a runtime argument. The
// wrapper copies the input ring to the output once per chunk (about 201 MB
// each way at C = 1024 and R = 8192), and the kernel writes only the rows
// it records, lane 0 of a run's group into its run's runs-last column. What
// bounds it: K2's operations plus about 4 M a step for the
// entry-slot minimum and its owner and 3 M an adopting step for the deepest
// adopter, and K2's bytes plus the ring read and written once;
// chip_smoke.py counts both from the chunk it times. FLIGHT = false
// compiles to the kernel as it was before the recorder: every flight
// statement sits under `if (FLIGHT)`, and the flight variants are built as
// libraries of their own (-DTPUSIM_FLIGHT=1).
//
// Packed grids (PACKED = true, K4x). Replaces the packed variant of the same
// Pallas kernel in exact mode (packed=True, tpusim/pallas_engine.py:
// 1065-1081), with and without SELFISH: a sweep grid's points share one
// launch, each run with its own point's roster. The per-run winner
// thresholds and mean interval stay in the sampler's torch ops, as in the
// reference; the kernel takes per run the propagation delays prop (M, R)
// and the selfish flags selfish_in (M, R), both int32 runs-last. Lane m
// loads its miner's delay and flag of its run, prop_in[m * R + r] and
// selfish_in[m * R + r], once at entry, where the uniform variants take
// entry m of the delays and bit m of the mask, so the event loop is K2's. SELFISH stays a template choice, uniform per pack (the planner
// keys packs on whether any miner is selfish); a run whose flags are all
// honest takes no selfish branch under SELFISH = true and gives the honest
// result. What bounds it: K2's operations, and K2's bytes plus the two
// (M, R) tables (0.6 MB at R = 8192). PACKED = false compiles to the kernel
// as it was: the packed variants are libraries of their own
// (-DTPUSIM_PACKED=1), and the per-run flags are the kernel's last
// argument, so the others keep their argument offsets.
//
// Generic group slots (K >= 3, K5c). Replaces the generic K-slot arrival-group
// machinery of the same Pallas kernel (group_slots >= 3: push_groups at
// tpusim/pallas_engine.py:233-249, the flush and compaction at :367-379, the
// adoption clear and cut-through at :535-539), which the reference's K = 2
// split slots route around. A selfish reveal pushes its whole burst as one
// merged group through the same push (:413-420). The build passes
// -DTPUSIM_GROUP_SLOTS=<K>. Lane m keeps its miner's buffer as int ga[K],
// gc[K]; every slot index is a compile-time one after unrolling (a push, the
// flush and the compaction are selects against the miner's occupied and
// arrived counts), so the buffer lives in registers. A push merges an equal
// arrival into the last occupied slot and, when all K are full, merges into
// slot K - 1 and counts the overflow; a flush moves the tip of the arrived
// prefix into base and shifts the rest left, kInf and 0 filling the tail. What
// bounds it: K2's operations with the group terms at K slots, and K2's bytes
// with (M, K, R) groups. chip_smoke.py counts both. K = 2 compiles to the
// split-slot kernel as it was: every generic statement sits in the `else` of an
// `if constexpr (kSlots == 2)`, and a K = 2 build takes no flag.
//
// Packed grids with the flight recorder (PACKED and FLIGHT, K4 x K3): the
// two compose as they are, the ring code K3's and the per-run operands K4's,
// each at its own argument offsets, in a library of their own
// (-DTPUSIM_PACKED=1 -DTPUSIM_FLIGHT=1).
//
// Wide rosters (TPUSIM_WIDE, K2w). Replaces the exact mode of the reference at
// more than 16 miners, which has no Pallas kernel (the VMEM guard,
// tpusim/pallas_engine.py:735-774, refuses exact mode above 13 miners): the
// scan engine's exact step, tpusim/engine.py:335 _step_event with
// tpusim/state.py:467 found_block and :579 notify, as the hetero32 grid runs
// it. With and without SELFISH, with FLIGHT, PACKED and any K as above. Built
// with -DTPUSIM_WIDE=1, for any M. The narrow design, widened: a warp steps
// a run, lane l its miners l, l + 32, ... (P = ceil(M / 32) a lane, each
// miner's leaves in registers as lane m's above), and every per-miner loop
// is a fold over a lane's P miners and then a reduction, ballot or shuffle
// over the whole warp (RunWarp: the run's lanes leave the step loop
// together, so every collective takes the full mask). No miner set is a bit
// mask: the selfish flags are an (M,) int32 device operand ((M, R) when
// packed), the adopters P ballot words. A block holds one run; its shared
// memory holds the run's b_pub, own_cp (rows M + 1 counts apart, so lane
// m's row and lane m + 1's fall in other banks) and own_in and, where the
// whole region fits the 227 KB a block may take, cp with its rows padded to
// 16 bytes (69,760 bytes at M = 32 with int16 counts: three runs an SM, the
// 8,192 runs of a chunk in about 21 waves). Where it does not (among the
// rosters held today only M = 40 with int32 counts, 250 KB), cp stays in the
// output leaf in device memory and is updated there in place; which form a
// library takes is a compile-time function of (M, C) (WideTables::kShared).
// cp reaches the kernel run-major, (R, M, M, M): event_loop._launch permutes
// the runs-last leaf before the launch and back after it, so a run's M^3
// counts are one block that its threads copy in and out with consecutive
// threads on consecutive words (the global form copies it from the input to
// the output leaf). The cp update is the narrow kernel's: the pairs (i, j)
// with an adopter take b's published count row or a copy of the plane row
// cp[b, p, :] of a p that neither adopts nor is b, in place, spread over the
// lanes by (pair, word): lane l takes word l % W of pair l / W (W words a
// row), so consecutive lanes store consecutive words, a lane keeping its
// word of b_pub in registers, and each row block's sources are decided for
// the whole warp, so that the common case, rows of b_pub, is stores alone.
// Where an SM holds few runs, a run's block has up to four warps
// (WideTables::kRunWarps): each steps the whole run, which reads nothing of
// cp, own_cp, own_in or the counts they feed, warp 0 alone reads b's tables
// and writes the results, and the warps share the row copies; a
// __syncthreads orders b_pub before the copies and each event's writes
// before the next event's reads. What bounds it: operations. The bytes the
// function must move are each leaf read and written once (about 1.3 GB a
// chunk at M = 32 and R = 8192, 0.38 ms at the HBM's rate): cp stays on the
// chip between the copies. Its integer work, counted by chip_smoke.py by
// replay, is that of K2 at M = 32 plus the cp update's stores and loads
// (32,736 entries a run on an event where the other 31 miners adopt, as
// nearly every arrival makes them under hetero32's per-source delays). In
// practice the row copies are issue-bound, a warp's 16-byte shared-memory
// stores one after another, and the rest of an event is a chain of warp
// collectives, with an SM holding only three runs at M = 32.
//
// Raw words (TPUSIM_RAW_WORDS, K5a) and one-hot reads (TPUSIM_ONEHOT, K5b), in
// every variant above, as in event_loop.cu. The one-hot form also reads the
// cp plane of b as the contraction cpb[j][o] = sum_p cp[p, j, o] * [p == b]
// over the M planes (pallas_engine.py:477-479), where the gather reads one
// plane: M loads for each entry the update copies, and cpb's diagonal as the
// eye contraction sum_q cpb[i][q] * [i == q]. The update stays in place: a
// plane p that an earlier write of the event touched is an adopter's, never
// b's, and enters the sum times 0. What bounds it: K2's, plus for K5a the
// mapping of each find, and for K5b the contractions' operations and cp
// loads (M^3 an adopting event where the gather loads (M - A - 1) M), which
// chip_smoke.py counts by replay.

#include "event_loop_common.cuh"

namespace {

constexpr int kLeaves = 19;  // 14 state + 5 counter leaves

struct Leaves {
  void* p[kLeaves];
};

#if TPUSIM_WIDE
// The most dynamic shared memory one block may take on sm_90 (227 KB).
constexpr int kSmemMax = 232448;

// The largest power of two that divides n, at most 16: the widest word that
// tiles a row of n bytes.
constexpr int word_bytes(int n) { return (n & -n) < 16 ? (n & -n) : 16; }

constexpr int clamp_int(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

template <int B>
struct WordOf;
template <>
struct WordOf<16> {
  using type = uint4;
};
template <>
struct WordOf<8> {
  using type = uint2;
};
template <>
struct WordOf<4> {
  using type = unsigned;
};
template <>
struct WordOf<2> {
  using type = unsigned short;
};

// A run's tables, in the count type C. In shared memory: b's published count
// row b_pub (M, padded to 16 bytes), own_cp (M, M) with rows M + 1 counts
// apart (lane m's row and lane m + 1's fall in other banks), own_in (M, M)
// and, when the whole region fits a block (kShared), cp (M, M, M) with each
// row cp[i, j, :] padded to 16 bytes. Otherwise cp stays in the output leaf
// in global memory, run-major and unpadded. A row is copied as kWords words
// of kWordBytes.
template <int M, typename C>
struct WideTables {
  static constexpr int kSize = static_cast<int>(sizeof(C));
  static constexpr int kVec = 16 / kSize;  // counts in 16 bytes
  static constexpr int kPadRow = (M + kVec - 1) / kVec * kVec;
  static constexpr int kOcpRow = M + 1;
  static constexpr int kBpub = 0, kOcp = kPadRow, kOin = kOcp + M * kOcpRow;
  static constexpr int kCp = (kOin + M * M + kVec - 1) / kVec * kVec;
  static constexpr bool kShared = (kCp + M * M * kPadRow) * kSize <= kSmemMax;
  static constexpr int kRow = kShared ? kPadRow : M;  // cp's row stride in counts
  static constexpr int kWordBytes = word_bytes(kRow * kSize);
  static constexpr int kWords = kRow * kSize / kWordBytes;
  static constexpr int kSmem = (kShared ? kCp + M * M * kPadRow : kCp) * kSize;
  using Word = typename WordOf<kWordBytes>::type;
  // Runs an SM holds: its 228 KB of shared memory, 1 KB of it reserved a
  // block. Warps a run: about 16 warps an SM in all, at most 4 a run. Each
  // of a run's warps steps the whole run (its control flow never reads cp,
  // own_cp, own_in, own counts or stale counts, so they take the same
  // branches); warp 0, the lead, alone reads b's tables, keeps those counts
  // and writes the results, and the warps share the row copies of an
  // adopting event, which one warp's issue latency bounds where an SM holds
  // few runs (hetero32 at M = 32 with int16 counts: 3 runs an SM, 4 warps a
  // run).
  static constexpr int kRunsPerSm = 233472 / (kSmem + 1024);
  static constexpr int kRunWarps = clamp_int(16 / kRunsPerSm, 1, 4);
  static constexpr int kRunThreads = kRunWarps * kWarpLanes;
};

// K2w: a run a block of WideTables::kRunWarps warps, the runs in waves of
// as many blocks as an SM's shared memory holds. Leaf order and arguments
// are the narrow kernel's below, except that cp (leaf 9) is run-major, (R,
// M, M, M), in both `in` and `out` (event_loop._launch permutes it); the
// selfish flags are selfish_in, (M,) or with PACKED (M, R), or null for an
// all-honest roster (SELFISH = false), and `selfish` is unused.
template <int M, typename C, typename S, bool SELFISH, bool FLIGHT, bool PACKED>
__global__ void __launch_bounds__(WideTables<M, C>::kRunThreads)
event_loop_exact_kernel(const int* __restrict__ rows, const int* __restrict__ cap_in,
                        const int* __restrict__ prop_in, unsigned /* selfish */, Leaves in,
                        Leaves out, int steps, int n_runs, Flight fl,
                        const int* __restrict__ selfish_in TPUSIM_SAMPLER_PARAM) {
  using T = WideTables<M, C>;
  using Word = typename T::Word;
  constexpr int P = (M + kWarpLanes - 1) / kWarpLanes;  // miners a lane
  constexpr long kCube = static_cast<long>(M) * M * M;
  extern __shared__ __align__(16) unsigned char smem[];
  const long R = n_runs;
  const int r = blockIdx.x;
  const RunWarp g(threadIdx.x);
  const int lane = g.lane, warp = threadIdx.x / kWarpLanes;
  const bool lead = warp == 0;
  C* const tables = reinterpret_cast<C*>(smem);
  C* const bpub = tables + T::kBpub;  // bpub[o]
  C* const ocp = tables + T::kOcp;    // ocp[i * kOcpRow + j]
  C* const oin = tables + T::kOin;    // oin[i * M + j]
  const C* const cp_in = static_cast<const C*>(in.p[9]) + r * kCube;
  C* const cp_out = static_cast<C*>(out.p[9]) + r * kCube;
  C* const cp = T::kShared ? tables + T::kCp : cp_out;  // cp[(i * M + j) * kRow + o]

  // The run's tables in: own_cp and own_in from their runs-last leaves, cp
  // from its run-major one, a warp's accesses to consecutive counts.
  for (int e = threadIdx.x; e < M * M; e += T::kRunThreads) {
    ocp[e / M * T::kOcpRow + e % M] = static_cast<const C*>(in.p[10])[e * R + r];
    oin[e] = static_cast<const C*>(in.p[11])[e * R + r];
  }
  if constexpr (T::kRow == M) {
    constexpr long kN = kCube * T::kSize / T::kWordBytes;
    const Word* const src = reinterpret_cast<const Word*>(cp_in);
    Word* const dst = reinterpret_cast<Word*>(cp);
#pragma unroll 8
    for (long e = threadIdx.x; e < kN; e += T::kRunThreads) dst[e] = src[e];
  } else {
#pragma unroll 8
    for (long e = threadIdx.x; e < kCube; e += T::kRunThreads) {
      cp[e / M * T::kRow + e % M] = cp_in[e];
    }
  }
  __syncthreads();

  // The run's scalars, the same in every lane.
  int t = ld<int>(in.p[0], r);
  int nbt = ld<int>(in.p[1], r);
  int bhp = ld<C>(in.p[2], r);
  int mre = ld<int>(in.p[14], r);
  int sev = ld<int>(in.p[15], r);
  int act = ld<int>(in.p[16], r);
  const int cap = cap_in[r];
  int ovf = 0;  // this lane's overflows; the run's are their sum
  FlightRun fr;
  if (FLIGHT && lead && lane == 0) fr.load(fl, r, R);
  int rdh = lane < kBuckets ? ld<int>(in.p[18], lane * R + r) : 0;  // bucket `lane`
  // Slot k's miner's leaves; a slot without a miner holds empty groups.
  bool own[P], sel[P];
  int height[P], npriv[P], stale[P], base[P], ocnt[P], sbm[P], prop[P];
  int a0[P], a1[P], c0[P], c1[P];
  int ga[P][kGenSlots], gc[P][kGenSlots];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int m = g.miner(k);
    own[k] = m < M;
    sel[k] = false;
    height[k] = npriv[k] = stale[k] = base[k] = ocnt[k] = sbm[k] = prop[k] = 0;
    a0[k] = a1[k] = kInf;
    c0[k] = c1[k] = 0;
#pragma unroll
    for (int q = 0; q < kGenSlots; ++q) {
      ga[k][q] = kInf;
      gc[k][q] = 0;
    }
    if (!own[k]) continue;
    height[k] = ld<C>(in.p[3], m * R + r);
    npriv[k] = ld<C>(in.p[4], m * R + r);
    stale[k] = ld<S>(in.p[5], m * R + r);
    base[k] = ld<int>(in.p[6], m * R + r);
    if constexpr (kSlots == 2) {
      a0[k] = ld<int>(in.p[7], (2 * m) * R + r);
      a1[k] = ld<int>(in.p[7], (2 * m + 1) * R + r);
      c0[k] = ld<C>(in.p[8], (2 * m) * R + r);
      c1[k] = ld<C>(in.p[8], (2 * m + 1) * R + r);
    } else {
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        ga[k][q] = ld<int>(in.p[7], (m * kSlots + q) * R + r);
        gc[k][q] = ld<C>(in.p[8], (m * kSlots + q) * R + r);
      }
    }
    ocnt[k] = ld<C>(in.p[12], m * R + r);
    sbm[k] = ld<int>(in.p[17], m * R + r);
    prop[k] = PACKED ? prop_in[m * R + r] : prop_in[m];
    sel[k] = SELFISH && (PACKED ? selfish_in[m * R + r] : selfish_in[m]) != 0;
  }
  const auto push = [&](int k, int arrival, int count, bool d) {
    if constexpr (kSlots == 2) {
      ovf += push2(a0[k], a1[k], c0[k], c1[k], arrival, count, d);
    } else {
      ovf += push_k<kGenSlots>(ga[k], gc[k], arrival, count, d);
    }
  };
  // cpb(b, j, o) = cp[b, j, o], the cp plane of b.
#if TPUSIM_ONEHOT
  // K5b: the contraction sum_p cp[p, j, o] * [p == b] over the M planes
  // (pallas_engine.py:477-479), M loads where the gather loads one.
  const auto cpb = [&](int b, int j, int o) {
    int v = 0;
#pragma unroll 8
    for (int p = 0; p < M; ++p) v += static_cast<int>(cp[(p * M + j) * T::kRow + o]) * (p == b);
    return v;
  };
#else
  const auto cpb = [&](int b, int j, int o) {
    return static_cast<int>(cp[(b * M + j) * T::kRow + o]);
  };
#endif

  // The step's row, loaded a step ahead: its latency overlaps the step
  // before it.
  int row0 = rows[r], row1 = rows[R + r];
  for (int s = 0; s < steps; ++s) {
    // An inactive step changes nothing, and a run stays inactive to the end
    // of the chunk (t moves only while t < cap): stopping is exact.
    if (!(t < cap)) break;
    const int w0 = row0, w1 = row1;
    if (s + 1 < steps) {
      row0 = rows[(2L * s + 2) * R + r];
      row1 = rows[(2L * s + 3) * R + r];
    }
    const bool found_due = (t == nbt);
#if TPUSIM_RAW_WORDS
    // The mapping of the step's two raw words (winner_from_word,
    // interval_from_word), on a find only, in lane 0, which hands them to
    // the others.
    int wq = 0, dt = 0;
    if (found_due) {
      if (lane == 0) {
        const long off = PACKED ? r : 0, stride = PACKED ? R : 1;
        wq = winner_from_word<M>(static_cast<unsigned>(w0), smp.lo + off, smp.hi + off, stride);
        dt = interval_from_word(static_cast<unsigned>(w1), smp.mean[off]);
      }
      wq = g.from(wq, 0);
      dt = g.from(dt, 0);
    }
#else
    const int wq = w0, dt = w1;
#endif
    // The arrival row's operands, from the step-entry groups: the earliest
    // arrived group and its owner, the lowest miner on ties (row 1 of a
    // find step is the find's).
    int pmin = kInf, arr_miner = 0;
    if (FLIGHT && !found_due) {
      int pm[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if constexpr (kSlots == 2) {
          pm[k] = arrived2(a0[k], a1[k], t);
        } else {
          pm[k] = arrived_k<kGenSlots>(ga[k], t);
        }
      }
      pmin = g.min_of(pm);
      bool at[P];
#pragma unroll
      for (int k = 0; k < P; ++k) at[k] = pm[k] == pmin;
      arr_miner = g.lowest(at);
    }

    // FoundBlock. A selfish winner appends privately, except that a find on
    // its one private block while the public chain is level with it (bhp)
    // publishes both: the race, a group of count 2.
    const bool won = found_due && 0 <= wq && wq < M;
    const int w = won ? wq : 0;
    bool private_append = false, is_race = false;
    if (SELFISH && found_due) {
      int self[P];
#pragma unroll
      for (int k = 0; k < P; ++k) self[k] = sel[k];
      const int npriv_w = g.of(npriv, w), height_w = g.of(height, w);
      const bool sel_w = won && g.of(self, w);
      is_race = sel_w && npriv_w == 1 && bhp == height_w;
      private_append = sel_w && !is_race;
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const bool ow = won && g.miner(k) == wq;
      push(k, t + prop[k], is_race ? 2 : 1, ow && !private_append);
      if (SELFISH && ow) npriv[k] += private_append ? 1 : (is_race ? -1 : 0);
      ocnt[k] += ow;
      height[k] += ow;
    }
    int h_found = 0;  // the find row's height
    if (FLIGHT && found_due) h_found = won ? g.of(height, w) : 0;
    if (found_due) nbt = t + dt;

    // Notify sweep, deferred while another find is due at this ms: the
    // flush, then the best published chain (private blocks excluded), the
    // first-seen tip among the best, the lowest miner among those.
    const bool notify = !(found_due && nbt == t);
    const int t_flush = notify ? t : kNegGate;
    int pub[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      int unarrived;
      if constexpr (kSlots == 2) {
        unarrived = flush2(a0[k], a1[k], c0[k], c1[k], t_flush, base[k]);
      } else {
        unarrived = flush_k<kGenSlots>(ga[k], gc[k], t_flush, base[k]);
      }
      pub[k] = own[k] ? height[k] - unarrived - npriv[k] : -kInf;
    }
    const int best_h = g.max_of(pub);
    int tip[P];
#pragma unroll
    for (int k = 0; k < P; ++k) tip[k] = pub[k] == best_h ? base[k] : kInf;
    const int best_tip = g.min_of(tip);
    bool is_best[P];
#pragma unroll
    for (int k = 0; k < P; ++k) is_best[k] = pub[k] == best_h && base[k] == best_tip;
    const int b = g.lowest(is_best);

    if (SELFISH) {
      // Selfish reveal, before the reorg: publish enough private blocks to
      // match or beat the best chain, the whole burst as one merged group
      // (pallas_engine.py:413-420).
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int lead = height[k] - best_h;
        const int sc = npriv[k];
        const bool reveal = sel[k] && lead >= 0 && sc > lead && notify;
        const int n = (sc > 1 && lead == 1) ? sc : sc - lead;
        push(k, t + prop[k], n, reveal);
        if (reveal) npriv[k] = sc - n;
      }
    }

    // Adoption: a miner adopts b's chain when it is strictly longer.
    bool adopt[P];
    unsigned amask[P];
    unsigned any = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      adopt[k] = own[k] && notify && best_h > height[k];
      amask[k] = g.ballot(adopt[k]);
      any |= amask[k];
    }
    int dmax = 0;
    int miner2 = M;  // the adoption row's miner: the deepest pop
    if (any) {
      // Whether some miner neither adopts nor is b (the only pairs that read
      // a plane of b, not b_pub).
      int adopters = 0;
#pragma unroll
      for (int k = 0; k < P; ++k) adopters += __popc(amask[k]);
      const bool any_other = adopters < M - 1;
      if (lead) {
        // Reads of b's entries, diagonals corrected from ocnt (the
        // authority): b's unpublished count and own count from b's lane, b's
        // column of own_cp and row of own_in at each of this lane's miners.
#if TPUSIM_ONEHOT
        // K5b: each as the contraction with the one-hot of b
        // (pallas_engine.py:442-449, 459-461): a warp sum, and sums over each
        // miner's own_cp row and own_in column.
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
        int d_stale[P], rb[P], score[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int m = g.miner(k);
          int oc_b = 0, in_b = 0;
          if (own[k]) {
#if TPUSIM_ONEHOT
#pragma unroll 8
            for (int q = 0; q < M; ++q) {
              oc_b += static_cast<int>(ocp[m * T::kOcpRow + q]) * (q == b);
              in_b += static_cast<int>(oin[q * M + m]) * (q == b);
            }
#else
            oc_b = ocp[m * T::kOcpRow + b];
            in_b = oin[b * M + m];
#endif
          }
          const bool is_b = m == b;
          // b's published count row (own_in's row b, diagonal corrected) at
          // miner m.
          rb[k] = is_b ? cnt_b - unpub_b : in_b;
          // Reorg stale accounting: own blocks above lca(m, b).
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
          miner2 = g.lowest(deep);
        }
        // The factored update (tpusim.state.notify), cpb[j][o] = cp[b, j, o]:
        //   cp[i, j] = a_i ? ((a_j | j == b) ? b_pub : cpb[j])
        //                  : (a_j ? (i == b ? b_pub : cpb[i]) : cp[i, j])
        // own_cp[i][j] = cp[i, j, i] of the same update (miner i's lane writes
        // its row), the adopters' own_in rows (miner j's lane its column) and
        // own counts.
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if (!own[k]) continue;
          const int m = g.miner(k);
          const bool is_b = m == b;
          bpub[m] = static_cast<C>(rb[k]);
          // A non-adopter's new entries: cpb[m][m], or b_pub at b.
#if TPUSIM_ONEHOT
          // cpb's diagonal entry (m, m), as the eye contraction over cpb[m].
          int col = rb[k];
          if (!adopt[k] && !is_b) {
            col = 0;
#pragma unroll 1
            for (int q = 0; q < M; ++q) col += q == m ? cpb(b, m, q) : 0;
          }
#else
          const int col = adopt[k] || is_b ? rb[k] : cpb(b, m, m);
#endif
          // Stores only: an adopter's row is b_pub at every column but those
          // of miners that neither adopt nor are b, which the pass below
          // overwrites.
#pragma unroll 8
          for (int j = 0; j < M; ++j) {
            const bool aj = miner_bit(amask, j);
            if (adopt[k] || aj) ocp[m * T::kOcpRow + j] = static_cast<C>(adopt[k] ? rb[k] : col);
            if (aj) oin[j * M + m] = static_cast<C>(rb[k]);
          }
          if (any_other && adopt[k]) {
            // cpb[j][m] at those columns, kBatch loads issued before their
            // stores (the planes of b are not written).
#pragma unroll 1
            for (int j0 = 0; j0 < M; j0 += kBatch) {
              int x[kBatch];
#pragma unroll
              for (int u = 0; u < kBatch; ++u) {
                const int j = j0 + u;
                x[u] = j < M && !miner_bit(amask, j) && j != b ? cpb(b, j, m) : 0;
              }
#pragma unroll
              for (int u = 0; u < kBatch; ++u) {
                const int j = j0 + u;
                if (j < M && !miner_bit(amask, j) && j != b) {
                  ocp[m * T::kOcpRow + j] = static_cast<C>(x[u]);
                }
              }
            }
          }
          if (adopt[k]) ocnt[k] = rb[k];
        }
      }
      __syncthreads();  // b_pub complete
      // cp: the pairs (i, j) with an adopter, each a row of kW words, spread
      // over the lanes by (pair, word): a pass of the warp takes kPairs
      // pairs (i, j) of one row block i, lane l word l % kW of column j = l /
      // kW + kPairs q in pass q, so consecutive lanes store consecutive
      // words. Row block by row block (i is the same in every lane), each
      // lane's columns and their adopter flags and its word of b_pub in
      // registers, and a row block's sources decided for the whole warp:
      // b_pub alone (a row of an adopter when every other miner adopts or is
      // b, and b's row), stores with no load; one plane row cp[b, i, :] (the
      // row of a non-adopter i != b); or, in an adopter's row, the plane
      // rows cp[b, j, :] of the columns j that neither adopt nor are b, all
      // loaded before any is stored. The update runs in place: it reads only
      // the planes cp[b, p, :] of miners p that neither adopt nor are b, and
      // writes only rows cp[i, :, :] of adopters i and columns cp[:, j, :] of
      // adopters j; b never adopts. (The one-hot read also sums the other
      // planes' entries, each times 0.)
      constexpr int kW = T::kWords;
      const Word* const bpub_w = reinterpret_cast<const Word*>(bpub);
      Word* const cp_w = reinterpret_cast<Word*>(cp);
      // Word v of the plane row cp[b, p, :].
      const auto plane_word = [&](int p, int v) {
#if TPUSIM_ONEHOT
        Word x;
        C* const xe = reinterpret_cast<C*>(&x);
        constexpr int kPerWord = T::kWordBytes / T::kSize;
#pragma unroll
        for (int e = 0; e < kPerWord; ++e) {
          const int o = v * kPerWord + e;
          xe[e] = static_cast<C>(o < M ? cpb(b, p, o) : 0);
        }
        return x;
#else
        return cp_w[(b * M + p) * kW + v];
#endif
      };
      if constexpr (kW <= kWarpLanes) {
        constexpr int kPairs = kWarpLanes / kW;
        constexpr int kPasses = (M + kPairs - 1) / kPairs;
        const int v = lane % kW, j0 = lane / kW;  // this lane's word and pass-0 column
        const bool copies = lane < kPairs * kW;
        Word bv{};  // b_pub's word v
        if (copies) bv = bpub_w[v];
        bool col_ok[kPasses], col_a[kPasses];
#pragma unroll
        for (int q = 0; q < kPasses; ++q) {
          const int j = j0 + q * kPairs;
          col_ok[q] = copies && j < M;
          col_a[q] = col_ok[q] && miner_bit(amask, j);
        }
#pragma unroll 1
        for (int i = warp; i < M; i += T::kRunWarps) {
          const bool ai = miner_bit(amask, i);
          if (ai ? !any_other : i == b) {
#pragma unroll
            for (int q = 0; q < kPasses; ++q) {
              if (ai ? col_ok[q] : col_a[q]) cp_w[(i * M + j0 + q * kPairs) * kW + v] = bv;
            }
          } else if (!ai) {
            const Word x = copies ? plane_word(i, v) : bv;
#pragma unroll
            for (int q = 0; q < kPasses; ++q) {
              if (col_a[q]) cp_w[(i * M + j0 + q * kPairs) * kW + v] = x;
            }
          } else {
            Word x[kPasses];
#pragma unroll
            for (int q = 0; q < kPasses; ++q) {
              const int j = j0 + q * kPairs;
              x[q] = col_ok[q] && !col_a[q] && j != b ? plane_word(j, v) : bv;
            }
#pragma unroll
            for (int q = 0; q < kPasses; ++q) {
              if (col_ok[q]) cp_w[(i * M + j0 + q * kPairs) * kW + v] = x[q];
            }
          }
        }
      } else {
        // Rows of more than 32 words (M > 128 with int32 counts): a pair at a
        // time, lane l words l, l + 32, ...
#pragma unroll 1
        for (int p = warp; p < M * M; p += T::kRunWarps) {
          const int i = p / M, j = p - i * M;
          const bool ai = miner_bit(amask, i), aj = miner_bit(amask, j);
          if (!ai && !aj) continue;
          const bool from_bpub = ai ? (aj || j == b) : (i == b);
          for (int v = lane; v < kW; v += kWarpLanes) {
            cp_w[p * kW + v] = from_bpub ? bpub_w[v] : plane_word(ai ? j : i, v);
          }
        }
      }
      // Adoption of the rest of the state.
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (!adopt[k]) continue;
        height[k] = best_h;
        npriv[k] = 0;
        base[k] = best_tip;
        a0[k] = a1[k] = kInf;
        c0[k] = c1[k] = 0;
#pragma unroll
        for (int q = 0; q < kGenSlots; ++q) {
          ga[k][q] = kInf;
          gc[k][q] = 0;
        }
      }
      __syncthreads();  // this event's tables before the next event's reads
    }
    if (notify) bhp = best_h;

    if (FLIGHT) {
      // Row 1: the find, or an arrival if the sweep flushed a group; row 2:
      // the adoption, if any. Heights are after the adoption except the
      // find's. Lane 0 keeps the run's ring cursor and writes the rows.
      const bool arrival = !found_due && notify && pmin < kInf;
      const int h_arr = arrival ? g.of(height, arr_miner) : 0;
      if (lead && lane == 0) {
        if (found_due || arrival) {
          fr.push(fl, r, R, found_due ? kKindFind : kKindArrival, found_due ? w : arr_miner,
                  found_due ? h_found : h_arr, 0, t);
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
    t = max(min(nbt, g.min_of(pend)), t);

    mre = max(mre, dmax);
    sev += dmax > 0;
    act += 1;
    if (dmax > 0 && lane == min(dmax, kBuckets) - 1) ++rdh;
  }

  ovf = ld<int>(in.p[13], r) + g.add(ovf);
  if (lead && lane == 0) {
    st<int>(out.p[0], r, t);
    st<int>(out.p[1], r, nbt);
    st<C>(out.p[2], r, bhp);
    st<int>(out.p[13], r, ovf);
    st<int>(out.p[14], r, mre);
    st<int>(out.p[15], r, sev);
    st<int>(out.p[16], r, act);
    if (FLIGHT) fr.store(fl, r, R);
  }
  if (lead && lane < kBuckets) st<int>(out.p[18], lane * R + r, rdh);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (!lead || !own[k]) continue;
    const int m = g.miner(k);
    st<C>(out.p[3], m * R + r, height[k]);
    st<C>(out.p[4], m * R + r, npriv[k]);
    st<S>(out.p[5], m * R + r, stale[k]);
    st<int>(out.p[6], m * R + r, base[k]);
    if constexpr (kSlots == 2) {
      st<int>(out.p[7], (2 * m) * R + r, a0[k]);
      st<int>(out.p[7], (2 * m + 1) * R + r, a1[k]);
      st<C>(out.p[8], (2 * m) * R + r, c0[k]);
      st<C>(out.p[8], (2 * m + 1) * R + r, c1[k]);
    } else {
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        st<int>(out.p[7], (m * kSlots + q) * R + r, ga[k][q]);
        st<C>(out.p[8], (m * kSlots + q) * R + r, gc[k][q]);
      }
    }
    st<C>(out.p[12], m * R + r, ocnt[k]);
    st<int>(out.p[17], m * R + r, sbm[k]);
  }

  // The run's tables out (cp only from shared memory: in the global form
  // it was updated in place).
  __syncthreads();
  for (int e = threadIdx.x; e < M * M; e += T::kRunThreads) {
    static_cast<C*>(out.p[10])[e * R + r] = ocp[e / M * T::kOcpRow + e % M];
    static_cast<C*>(out.p[11])[e * R + r] = oin[e];
  }
  if constexpr (T::kShared) {
    if constexpr (T::kRow == M) {
      constexpr long kN = kCube * T::kSize / T::kWordBytes;
      const Word* const src = reinterpret_cast<const Word*>(cp);
      Word* const dst = reinterpret_cast<Word*>(cp_out);
#pragma unroll 8
      for (long e = threadIdx.x; e < kN; e += T::kRunThreads) dst[e] = src[e];
    } else {
#pragma unroll 8
      for (long e = threadIdx.x; e < kCube; e += T::kRunThreads) {
        cp_out[e] = cp[e / M * T::kRow + e % M];
      }
    }
  }
}
#else
// The narrow kernel's block: kRunsPerBlock runs of kGroupLanes lanes each.
constexpr int kRunsPerBlock = 8;
constexpr int kBlockThreads = kRunsPerBlock * kGroupLanes;
// At 8,192 runs, 1,024 blocks: one wave needs 8 blocks an SM, so at most 64
// registers a thread. The flight libraries ask for that (their ring cursor
// and row operands take more otherwise, and two waves); the others stay
// within it unasked, and were slower asked.
#if TPUSIM_FLIGHT
#define TPUSIM_NARROW_BOUNDS __launch_bounds__(kBlockThreads, 8)
#else
#define TPUSIM_NARROW_BOUNDS __launch_bounds__(kBlockThreads)
#endif

// A run's region of shared memory, in the count type C: b's published count
// row b_pub (M), own_cp (M, M), own_in (M, M) and cp (M, M, M), at these
// offsets. b_pub and each row cp[i, j, :] take kRow counts, M rounded up to
// 16 bytes, so a row is copied as kRow / kVec 16-byte words.
template <int M, typename C>
struct Tables {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(C));  // counts in 16 bytes
  static constexpr int kRow = (M + kVec - 1) / kVec * kVec;
  static constexpr int kBpub = 0, kOcp = kRow, kOin = kOcp + M * M;
  static constexpr int kCp = (kOin + M * M + kVec - 1) / kVec * kVec;
  static constexpr int kRegion = kCp + M * M * kRow;
};

// A block's dynamic shared memory: each run's region.
template <int M, typename C>
constexpr int narrow_smem_bytes() {
  return kRunsPerBlock * Tables<M, C>::kRegion * static_cast<int>(sizeof(C));
}

// The n entries of a runs-last leaf, rows of M, for the block's runs r0 ..
// r0 + kRunsPerBlock - 1, between the leaf and each run's table at offset
// `at`, whose rows are `row` counts apart: consecutive threads take
// consecutive runs of one entry, so a warp's accesses to the leaf fall in a
// few 32-byte sectors.
template <int M, typename C, bool IN>
__device__ __forceinline__ void copy_table(C* regions, const void* in, void* out, int n, int at,
                                           int row, int r0, int n_runs, long R) {
  for (int i = threadIdx.x; i < kRunsPerBlock * n; i += kBlockThreads) {
    const int q = i % kRunsPerBlock, e = i / kRunsPerBlock;
    if (r0 + q >= n_runs) continue;
    C& x = regions[q * Tables<M, C>::kRegion + at + e / M * row + e % M];
    if (IN) {
      x = static_cast<const C*>(in)[e * R + r0 + q];
    } else {
      static_cast<C*>(out)[e * R + r0 + q] = x;
    }
  }
}

// Leaf order: t, nbt, bhp, height, npriv, stale, base, garr, gcnt, cp, ocp,
// oin, ocnt, ovf, then the counters mre, sev, act, sbm, rdh
// (tpusim_torch.event_loop.EXACT_LEAVES). C is the count type, S the type
// of `stale`; bit i of `selfish` marks miner i selfish, or with PACKED the
// run's column of selfish_in (M, R) does. One run a group of kGroupLanes
// lanes, lane m its miner m's leaves in registers, the run's scalars in
// every lane, the tables in shared memory (the file's header).
template <int M, typename C, typename S, bool SELFISH, bool FLIGHT, bool PACKED>
__global__ void TPUSIM_NARROW_BOUNDS
event_loop_exact_kernel(const int* __restrict__ rows, const int* __restrict__ cap_in,
                        const int* __restrict__ prop_in, unsigned selfish, Leaves in,
                        Leaves out, int steps, int n_runs, Flight fl,
                        const int* __restrict__ selfish_in TPUSIM_SAMPLER_PARAM) {
  using T = Tables<M, C>;
  extern __shared__ __align__(16) unsigned char smem[];
  const long R = n_runs;
  const int r0 = blockIdx.x * kRunsPerBlock;
  const int slot = threadIdx.x / kGroupLanes;  // the run's place in the block
  const int r = r0 + slot;
  const RunGroup g(threadIdx.x);
  const int m = g.lane;
  C* const regions = reinterpret_cast<C*>(smem);
  C* const bpub = regions + slot * T::kRegion + T::kBpub;  // bpub[o]
  C* const ocp = regions + slot * T::kRegion + T::kOcp;    // ocp[i * M + j]
  C* const oin = regions + slot * T::kRegion + T::kOin;    // oin[i * M + j]
  C* const cp = regions + slot * T::kRegion + T::kCp;      // cp[(i * M + j) * kRow + o]
  copy_table<M, C, true>(regions, in.p[10], nullptr, M * M, T::kOcp, M, r0, n_runs, R);
  copy_table<M, C, true>(regions, in.p[11], nullptr, M * M, T::kOin, M, r0, n_runs, R);
  copy_table<M, C, true>(regions, in.p[9], nullptr, M * M * M, T::kCp, T::kRow, r0, n_runs, R);
  __syncthreads();

  if (r < n_runs) {
    const bool own = m < M;  // lanes M .. kGroupLanes - 1 own no miner
    // The run's scalars, the same in every lane.
    int t = ld<int>(in.p[0], r);
    int nbt = ld<int>(in.p[1], r);
    int bhp = ld<C>(in.p[2], r);
    int mre = ld<int>(in.p[14], r);
    int sev = ld<int>(in.p[15], r);
    int act = ld<int>(in.p[16], r);
    const int cap = cap_in[r];
    int ovf = 0;  // this lane's overflows; the run's are their sum
    FlightRun fr;
    if (FLIGHT && m == 0) fr.load(fl, r, R);
    int rdh = m < kBuckets ? ld<int>(in.p[18], m * R + r) : 0;  // bucket m
    // Miner m's leaves; a lane without a miner holds empty slots.
    int height = 0, npriv = 0, stale = 0, base = 0, ocnt = 0, sbm = 0, prop = 0;
    int a0 = kInf, a1 = kInf, c0 = 0, c1 = 0;
    // The generic buffer (K >= 3; kGenSlots == kSlots there, and the K = 2
    // build's generic statements, of extent 1, are discarded).
    int ga[kGenSlots], gc[kGenSlots];
#pragma unroll
    for (int k = 0; k < kGenSlots; ++k) {
      ga[k] = kInf;
      gc[k] = 0;
    }
    bool sel = false;
    if (own) {
      height = ld<C>(in.p[3], m * R + r);
      npriv = ld<C>(in.p[4], m * R + r);
      stale = ld<S>(in.p[5], m * R + r);
      base = ld<int>(in.p[6], m * R + r);
      if constexpr (kSlots == 2) {
        a0 = ld<int>(in.p[7], (2 * m) * R + r);
        a1 = ld<int>(in.p[7], (2 * m + 1) * R + r);
        c0 = ld<C>(in.p[8], (2 * m) * R + r);
        c1 = ld<C>(in.p[8], (2 * m + 1) * R + r);
      } else {
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          ga[k] = ld<int>(in.p[7], (m * kSlots + k) * R + r);
          gc[k] = ld<C>(in.p[8], (m * kSlots + k) * R + r);
        }
      }
      ocnt = ld<C>(in.p[12], m * R + r);
      sbm = ld<int>(in.p[17], m * R + r);
      prop = PACKED ? prop_in[m * R + r] : prop_in[m];
      sel = SELFISH && (PACKED ? selfish_in[m * R + r] != 0 : ((selfish >> m) & 1u) != 0);
    }
    const auto push = [&](int arrival, int count, bool d) {
      if constexpr (kSlots == 2) {
        ovf += push2(a0, a1, c0, c1, arrival, count, d);
      } else {
        ovf += push_k<kGenSlots>(ga, gc, arrival, count, d);
      }
    };
    // cpb(b, j, o) = cp[b, j, o], the cp plane of b.
#if TPUSIM_ONEHOT
    // K5b: the contraction sum_p cp[p, j, o] * [p == b] over the M planes
    // (pallas_engine.py:477-479), M loads where the gather loads one.
    const auto cpb = [&](int b, int j, int o) {
      int v = 0;
#pragma unroll
      for (int p = 0; p < M; ++p) v += static_cast<int>(cp[(p * M + j) * T::kRow + o]) * (p == b);
      return v;
    };
#else
    const auto cpb = [&](int b, int j, int o) {
      return static_cast<int>(cp[(b * M + j) * T::kRow + o]);
    };
#endif

    // The step's row, loaded a step ahead: its latency overlaps the step
    // before it.
    int row0 = rows[r], row1 = rows[R + r];
    for (int s = 0; s < steps; ++s) {
      // An inactive step changes nothing, and a run stays inactive to the
      // end of the chunk (t moves only while t < cap): stopping is exact.
      if (!(t < cap)) break;
      const int w0 = row0, w1 = row1;
      if (s + 1 < steps) {
        row0 = rows[(2L * s + 2) * R + r];
        row1 = rows[(2L * s + 3) * R + r];
      }
      const bool found_due = (t == nbt);
#if TPUSIM_RAW_WORDS
      // The mapping of the step's two raw words (winner_from_word,
      // interval_from_word), on a find only.
      int wq = 0, dt = 0;
      if (found_due) {
        const long off = PACKED ? r : 0, stride = PACKED ? R : 1;
        wq = winner_from_word<M>(static_cast<unsigned>(w0), smp.lo + off, smp.hi + off, stride);
        dt = interval_from_word(static_cast<unsigned>(w1), smp.mean[off]);
      }
#else
      const int wq = w0, dt = w1;
#endif
      // The arrival row's operands, from the step-entry groups: the earliest
      // arrived group and its owner, the lowest miner on ties (row 1 of a
      // find step is the find's).
      int pmin = kInf, arr_miner = 0;
      if (FLIGHT && !found_due) {
        int pm;
        if constexpr (kSlots == 2) {
          pm = arrived2(a0, a1, t);
        } else {
          pm = arrived_k<kGenSlots>(ga, t);
        }
        pmin = g.min(pm);
        arr_miner = g.lowest(pm == pmin);
      }

      // FoundBlock. A selfish winner appends privately, except that a find on
      // its one private block while the public chain is level with it (bhp)
      // publishes both: the race, a group of count 2.
      const bool won = found_due && 0 <= wq && wq < M;
      const int w = won ? wq : 0;
      bool private_append = false, is_race = false;
      if (SELFISH && found_due) {
        const int npriv_w = g.from(npriv, w), height_w = g.from(height, w);
        const bool sel_w = won && g.from(sel, w);
        is_race = sel_w && npriv_w == 1 && bhp == height_w;
        private_append = sel_w && !is_race;
      }
      const bool ow = won && m == wq;
      push(t + prop, is_race ? 2 : 1, ow && !private_append);
      if (SELFISH && ow) npriv += private_append ? 1 : (is_race ? -1 : 0);
      ocnt += ow;
      height += ow;
      int h_found = 0;  // the find row's height
      if (FLIGHT && found_due) h_found = won ? g.from(height, w) : 0;
      if (found_due) nbt = t + dt;

      // Notify sweep, deferred while another find is due at this ms: the
      // flush, then the best published chain (private blocks excluded), the
      // first-seen tip among the best, the lowest miner among those.
      const bool notify = !(found_due && nbt == t);
      const int t_flush = notify ? t : kNegGate;
      int unarrived;
      if constexpr (kSlots == 2) {
        unarrived = flush2(a0, a1, c0, c1, t_flush, base);
      } else {
        unarrived = flush_k<kGenSlots>(ga, gc, t_flush, base);
      }
      const int pub = own ? height - unarrived - npriv : -kInf;
      const int best_h = g.max(pub);
      const bool cand = pub == best_h;
      const int best_tip = g.min(cand ? base : kInf);
      const int b = g.lowest(cand && base == best_tip);

      if (SELFISH) {
        // Selfish reveal, before the reorg: publish enough private blocks to
        // match or beat the best chain, the whole burst as one merged group
        // (pallas_engine.py:413-420).
        const int lead = height - best_h;
        const int sc = npriv;
        const bool reveal = sel && lead >= 0 && sc > lead && notify;
        const int n = (sc > 1 && lead == 1) ? sc : sc - lead;
        push(t + prop, n, reveal);
        if (reveal) npriv = sc - n;
      }

      // Adoption: a miner adopts b's chain when it is strictly longer.
      const bool adopt = own && notify && best_h > height;
      const unsigned amask = g.ballot(adopt);
      int dmax = 0;
      int miner2 = M;  // the adoption row's miner: the deepest pop
      if (amask) {
        const bool is_b = m == b;
        // Reads of b's entries, diagonals corrected from ocnt (the
        // authority): b's unpublished count and own count from lane b, b's
        // column of own_cp and row of own_in at this lane's miner.
#if TPUSIM_ONEHOT
        // K5b: each as the contraction with the one-hot of b
        // (pallas_engine.py:442-449, 459-461): a group sum, and sums over
        // this lane's own_cp row and own_in column.
        const int unpub_b = g.add(height * is_b) - best_h;
        const int cnt_b = g.add(ocnt * is_b);
        int oc_b = 0, in_b = 0;
        if (own) {
#pragma unroll
          for (int k = 0; k < M; ++k) {
            oc_b += static_cast<int>(ocp[m * M + k]) * (k == b);
            in_b += static_cast<int>(oin[k * M + m]) * (k == b);
          }
        }
#else
        const int unpub_b = g.from(height, b) - best_h;
        const int cnt_b = g.from(ocnt, b);
        const int oc_b = own ? static_cast<int>(ocp[m * M + b]) : 0;
        const int in_b = own ? static_cast<int>(oin[b * M + m]) : 0;
#endif
        // row_bpub[m]: b's published count row (own_in's row b, diagonal
        // corrected) at this lane's miner.
        const int rb = is_b ? cnt_b - unpub_b : in_b;
        // Reorg stale accounting: own blocks above lca(m, b).
        const int d_stale = adopt ? ocnt - (is_b ? cnt_b : oc_b) : 0;
        stale += d_stale;
        sbm += d_stale > 0;
        dmax = g.max(d_stale);
        if (FLIGHT) {
          const int score = adopt ? d_stale : -1;
          const int deepest = g.max(score);
          miner2 = g.lowest(adopt && score == deepest);
        }
        // The factored update (tpusim.state.notify), cpb[j][o] = cp[b, j, o]:
        //   cp[i, j] = a_i ? ((a_j | j == b) ? b_pub : cpb[j])
        //                  : (a_j ? (i == b ? b_pub : cpb[i]) : cp[i, j])
        // own_cp[i][j] = cp[i, j, i] of the same update (lane i's row), the
        // adopters' own_in rows (lane j's column) and own counts.
        if (own) {
          bpub[m] = static_cast<C>(rb);
          // A non-adopter's new entries: cpb[m][m], or b_pub at b.
#if TPUSIM_ONEHOT
          // cpb's diagonal entry (m, m), as the eye contraction over cpb[m].
          int col = rb;
          if (!adopt && !is_b) {
            col = 0;
#pragma unroll
            for (int q = 0; q < M; ++q) col += q == m ? cpb(b, m, q) : 0;
          }
#else
          const int col = adopt || is_b ? rb : cpb(b, m, m);
#endif
#pragma unroll
          for (int j = 0; j < M; ++j) {
            const bool aj = (amask >> j) & 1u;
            const int v = adopt ? (aj || j == b ? rb : cpb(b, j, m)) : col;
            if (adopt || aj) ocp[m * M + j] = static_cast<C>(v);
            if (aj) oin[j * M + m] = static_cast<C>(rb);
          }
          if (adopt) ocnt = rb;
        }
        g.sync();  // bpub complete
        // cp: the pairs (i, j) with an adopter, each a row of M counts,
        // spread over the lanes. The update runs in place: it reads only the
        // planes cp[b, p, :] of miners p that neither adopt nor are b, and
        // writes only rows cp[i, :, :] of adopters i and columns cp[:, j, :]
        // of adopters j; b never adopts. (The one-hot read also sums the
        // other planes' entries, each times 0.)
        for (int p = m; p < M * M; p += kGroupLanes) {
          const int i = p / M, j = p - i * M;
          const bool ai = (amask >> i) & 1u, aj = (amask >> j) & 1u;
          if (!ai && !aj) continue;
          C* const dst = cp + p * T::kRow;
          const bool from_bpub = ai ? (aj || j == b) : (i == b);
#if TPUSIM_ONEHOT
          if (!from_bpub) {
            const int src = ai ? j : i;
#pragma unroll
            for (int o = 0; o < M; ++o) dst[o] = static_cast<C>(cpb(b, src, o));
            continue;
          }
          const C* const src = bpub;
#else
          const C* const src = from_bpub ? bpub : cp + (b * M + (ai ? j : i)) * T::kRow;
#endif
#pragma unroll
          for (int v = 0; v < T::kRow / T::kVec; ++v) {
            reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(src)[v];
          }
        }
        // Adoption of the rest of the state.
        if (adopt) {
          height = best_h;
          npriv = 0;
          base = best_tip;
          a0 = a1 = kInf;
          c0 = c1 = 0;
#pragma unroll
          for (int k = 0; k < kGenSlots; ++k) {
            ga[k] = kInf;
            gc[k] = 0;
          }
        }
        g.sync();  // this event's tables before the next event's reads
      }
      if (notify) bhp = best_h;

      if (FLIGHT) {
        // Row 1: the find, or an arrival if the sweep flushed a group; row 2:
        // the adoption, if any. Heights are after the adoption except the
        // find's. Lane 0 keeps the run's ring cursor and writes the rows.
        const bool arrival = !found_due && notify && pmin < kInf;
        const int h_arr = arrival ? g.from(height, arr_miner) : 0;
        if (m == 0) {
          if (found_due || arrival) {
            fr.push(fl, r, R, found_due ? kKindFind : kKindArrival, found_due ? w : arr_miner,
                    found_due ? h_found : h_arr, 0, t);
          }
          if (amask) {
            fr.push(fl, r, R, dmax > 0 ? kKindStale : kKindReorg, miner2,
                    miner2 < M ? best_h : 0, dmax, t);
          }
        }
      }

      // Cut-through to the next event.
      int pend;
      if constexpr (kSlots == 2) {
        pend = pending2(a0, a1, t);
      } else {
        pend = pending_k<kGenSlots>(ga, t);
      }
      t = max(min(nbt, g.min(pend)), t);

      mre = max(mre, dmax);
      sev += dmax > 0;
      act += 1;
      if (dmax > 0 && m == min(dmax, kBuckets) - 1) ++rdh;
    }

    ovf = ld<int>(in.p[13], r) + g.add(ovf);
    if (m == 0) {
      st<int>(out.p[0], r, t);
      st<int>(out.p[1], r, nbt);
      st<C>(out.p[2], r, bhp);
      st<int>(out.p[13], r, ovf);
      st<int>(out.p[14], r, mre);
      st<int>(out.p[15], r, sev);
      st<int>(out.p[16], r, act);
      if (FLIGHT) fr.store(fl, r, R);
    }
    if (m < kBuckets) st<int>(out.p[18], m * R + r, rdh);
    if (own) {
      st<C>(out.p[3], m * R + r, height);
      st<C>(out.p[4], m * R + r, npriv);
      st<S>(out.p[5], m * R + r, stale);
      st<int>(out.p[6], m * R + r, base);
      if constexpr (kSlots == 2) {
        st<int>(out.p[7], (2 * m) * R + r, a0);
        st<int>(out.p[7], (2 * m + 1) * R + r, a1);
        st<C>(out.p[8], (2 * m) * R + r, c0);
        st<C>(out.p[8], (2 * m + 1) * R + r, c1);
      } else {
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          st<int>(out.p[7], (m * kSlots + k) * R + r, ga[k]);
          st<C>(out.p[8], (m * kSlots + k) * R + r, gc[k]);
        }
      }
      st<C>(out.p[12], m * R + r, ocnt);
      st<int>(out.p[17], m * R + r, sbm);
    }
  }

  __syncthreads();
  copy_table<M, C, false>(regions, nullptr, out.p[10], M * M, T::kOcp, M, r0, n_runs, R);
  copy_table<M, C, false>(regions, nullptr, out.p[11], M * M, T::kOin, M, r0, n_runs, R);
  copy_table<M, C, false>(regions, nullptr, out.p[9], M * M * M, T::kCp, T::kRow, r0, n_runs, R);
}
#endif  // TPUSIM_WIDE

// One launch in count type C and stale type S: the wide kernel a warp a run,
// one run a block, its tables in dynamic shared memory (WideTables); the
// narrow one a group of kGroupLanes lanes a run, kRunsPerBlock runs a block,
// the runs' tables in dynamic shared memory. Above 48 KB (the narrow kernel
// from M = 11 with int32 counts and M = 14 with int16) the attribute raises
// the kernel's limit.
template <int M, typename C, typename S, bool SELFISH, bool FLIGHT, bool PACKED>
cudaError_t launch_typed(const int* rows, const int* cap, const int* prop, unsigned selfish,
                         const int* selfish_in, const Leaves& in, const Leaves& out, int steps,
                         int n_runs, const Flight& fl TPUSIM_SAMPLER_PARAM, cudaStream_t stream) {
  const auto kernel = event_loop_exact_kernel<M, C, S, SELFISH, FLIGHT, PACKED>;
#if TPUSIM_WIDE
  const dim3 grid(n_runs), block(WideTables<M, C>::kRunThreads);
  constexpr int smem = WideTables<M, C>::kSmem;
  // As many runs an SM as its shared memory holds: all of the unified
  // L1/shared memory as shared memory.
  const cudaError_t carve = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return carve;
#else
  const dim3 grid((n_runs + kRunsPerBlock - 1) / kRunsPerBlock), block(kBlockThreads);
  constexpr int smem = narrow_smem_bytes<M, C>();
#endif
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  kernel<<<grid, block, smem, stream>>>(rows, cap, prop, selfish, in, out, steps, n_runs, fl,
                                        selfish_in TPUSIM_SAMPLER_ARG);
  return cudaGetLastError();
}

template <int M, bool SELFISH, bool FLIGHT, bool PACKED>
cudaError_t launch_ms(const int* rows, const int* cap, const int* prop, unsigned selfish,
                      const int* selfish_in, const Leaves& in, const Leaves& out, int count16,
                      int stale16, int steps, int n_runs, const Flight& fl TPUSIM_SAMPLER_PARAM,
                      cudaStream_t stream) {
  if (count16 && stale16) {
    return launch_typed<M, int16_t, int16_t, SELFISH, FLIGHT, PACKED>(
        rows, cap, prop, selfish, selfish_in, in, out, steps, n_runs, fl TPUSIM_SAMPLER_ARG,
        stream);
  }
  if (count16) {
    return launch_typed<M, int16_t, int32_t, SELFISH, FLIGHT, PACKED>(
        rows, cap, prop, selfish, selfish_in, in, out, steps, n_runs, fl TPUSIM_SAMPLER_ARG,
        stream);
  }
  if (!stale16) {
    return launch_typed<M, int32_t, int32_t, SELFISH, FLIGHT, PACKED>(
        rows, cap, prop, selfish, selfish_in, in, out, steps, n_runs, fl TPUSIM_SAMPLER_ARG,
        stream);
  }
  return cudaErrorInvalidValue;
}

// `selfish_in` is the packed variants' per-run flags, or null: no run has a
// selfish miner (SELFISH = false); the other variants take `selfish`.
cudaError_t launch(const void* rows, const void* cap, const void* prop, void* const* in,
                   void* const* out, int n_miners, unsigned selfish, const int* selfish_in,
                   int count16, int stale16, int steps, int n_runs,
                   const Flight& fl TPUSIM_SAMPLER_PARAM, void* stream) {
  if (n_runs <= 0 || steps <= 0) return cudaSuccess;
  if (n_miners != TPUSIM_MINERS) return cudaErrorInvalidValue;
#if !TPUSIM_WIDE
  if (selfish >> TPUSIM_MINERS) return cudaErrorInvalidValue;
#endif
  Leaves lin, lout;
  for (int i = 0; i < kLeaves; ++i) {
    lin.p[i] = in[i];
    lout.p[i] = out[i];
  }
  const auto* rw = static_cast<const int*>(rows);
  const auto* cp = static_cast<const int*>(cap);
  const auto* pp = static_cast<const int*>(prop);
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr bool kFlight = TPUSIM_FLIGHT != 0, kPacked = TPUSIM_PACKED != 0;
  const bool any_selfish = (kPacked || TPUSIM_WIDE) ? selfish_in != nullptr : selfish != 0;
  return any_selfish
             ? launch_ms<TPUSIM_MINERS, true, kFlight, kPacked>(
                   rw, cp, pp, selfish, selfish_in, lin, lout, count16, stale16, steps, n_runs,
                   fl TPUSIM_SAMPLER_ARG, s)
             : launch_ms<TPUSIM_MINERS, false, kFlight, kPacked>(
                   rw, cp, pp, selfish, selfish_in, lin, lout, count16, stale16, steps, n_runs,
                   fl TPUSIM_SAMPLER_ARG, s);
}

// The uniform variants' selfish operand: the bit mask in a narrow library;
// in a wide one the (M,) int32 flags' device address, or null when no miner
// is selfish.
#if TPUSIM_WIDE
using SelfishArg = const void*;
unsigned selfish_mask(SelfishArg) { return 0u; }
const int* selfish_flags(SelfishArg s) { return static_cast<const int*>(s); }
#else
using SelfishArg = unsigned;
unsigned selfish_mask(SelfishArg s) { return s; }
const int* selfish_flags(SelfishArg) { return nullptr; }
#endif

}  // namespace

extern "C" {

#if TPUSIM_FLIGHT && TPUSIM_PACKED
// Launch one chunk of a packed grid with the flight recorder on `stream`:
// `prop` and `selfish` as tpusim_event_loop_exact_packed_chunk takes them,
// `flight` and `capacity` as tpusim_event_loop_exact_flight_chunk does.
int tpusim_event_loop_exact_packed_flight_chunk(const void* rows, const void* cap,
                                                const void* prop, void* const* in,
                                                void* const* out, int n_miners,
                                                const void* selfish, int count16, int stale16,
                                                int steps, int n_runs, void* const* flight,
                                                int capacity TPUSIM_SAMPLER_C_PARAMS,
                                                void* stream) {
  if (capacity < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Flight fl{static_cast<const int*>(flight[0]), static_cast<const int*>(flight[1]),
                  static_cast<int*>(flight[2]), static_cast<int*>(flight[3]),
                  static_cast<int*>(flight[4]), capacity};
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, 0u,
                                 static_cast<const int*>(selfish), count16, stale16, steps,
                                 n_runs, fl TPUSIM_SAMPLER_C_ARGS, stream));
}
#elif TPUSIM_FLIGHT
// Launch one chunk with the flight recorder on `stream`, as
// tpusim_event_loop_exact_chunk does without it. `flight` holds the device
// addresses of the count (1, R) and origins (3, R) read, then the ring
// (C, 6, R) already holding a copy of the input ring, the count and the
// origins written; `capacity` is C.
int tpusim_event_loop_exact_flight_chunk(const void* rows, const void* cap, const void* prop,
                                         void* const* in, void* const* out, int n_miners,
                                         SelfishArg selfish, int count16, int stale16, int steps,
                                         int n_runs, void* const* flight, int capacity
                                         TPUSIM_SAMPLER_C_PARAMS, void* stream) {
  if (capacity < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Flight fl{static_cast<const int*>(flight[0]), static_cast<const int*>(flight[1]),
                  static_cast<int*>(flight[2]), static_cast<int*>(flight[3]),
                  static_cast<int*>(flight[4]), capacity};
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, selfish_mask(selfish),
                                 selfish_flags(selfish), count16, stale16, steps, n_runs,
                                 fl TPUSIM_SAMPLER_C_ARGS, stream));
}
#elif TPUSIM_PACKED
// Launch one chunk of a packed grid on `stream`, as
// tpusim_event_loop_exact_chunk does for one roster: `prop` holds the (M, R)
// runs-last int32 delays, `selfish` the (M, R) runs-last int32 flags, or is
// null when no run has a selfish miner.
int tpusim_event_loop_exact_packed_chunk(const void* rows, const void* cap, const void* prop,
                                         void* const* in, void* const* out, int n_miners,
                                         const void* selfish, int count16, int stale16,
                                         int steps, int n_runs TPUSIM_SAMPLER_C_PARAMS,
                                         void* stream) {
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, 0u,
                                 static_cast<const int*>(selfish), count16, stale16, steps,
                                 n_runs, Flight{} TPUSIM_SAMPLER_C_ARGS, stream));
}
#else
// Launch one chunk on `stream` for `n_miners` == TPUSIM_MINERS miners. `in`
// and `out` hold the 19 leaf pointers (device addresses) in the order above;
// `in` is only read. Bit i of `selfish` marks miner i selfish (in a wide
// library: `selfish` is the (M,) int32 flags' address, or null). Returns the
// launch's cudaError_t (0 on success); the kernel runs asynchronously.
int tpusim_event_loop_exact_chunk(const void* rows, const void* cap, const void* prop,
                                  void* const* in, void* const* out, int n_miners,
                                  SelfishArg selfish, int count16, int stale16, int steps,
                                  int n_runs TPUSIM_SAMPLER_C_PARAMS, void* stream) {
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, selfish_mask(selfish),
                                 selfish_flags(selfish), count16, stale16, steps, n_runs,
                                 Flight{} TPUSIM_SAMPLER_C_ARGS, stream));
}
#endif

const char* tpusim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
