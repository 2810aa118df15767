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
// with -DTPUSIM_WIDE=1, for any M. As in event_loop.cu's K1w, a run's
// per-miner vectors and (M, M) tables stay in its output leaves in global
// memory, runs-last, copied once at entry and updated in place, b-indexed
// reads are single loads, loops over miners stay rolled, loads are batched
// ahead of stores, and an adopting event's adopter flags and b's published
// count row are thread-local scratch. No miner set is a bit mask: the
// selfish flags are an (M,) int32 device operand (per run, (M, R), when
// packed) and the uniform variants' bit mask is not taken. The cp update is
// the narrow kernel's, rolled: a pair (i, j) with an adopter among i and j
// gets b's published count row (from the scratch) or a copy of a
// non-adopter's plane cp[b, p, :], which no write of the event touches.
// What bounds it: bytes. At M = 32 cp is M^3 = 32,768 counts a run, 512 MiB
// at R = 8192 with int16 counts, ten times the L2; when nearly every block's
// arrival makes the other 31 miners adopt (per-source propagation, the
// hetero32 roster), an event stores 32,736 cp entries a run, and each goes to
// HBM. chip_smoke.py counts the adopters of every event of a chunk by replay
// and counts cp's accesses as HBM bytes once the tensor exceeds the L2. With
// one thread a run, 2 warps an SM at R = 8192 issue those stores one after
// another, far below the memory's rate.
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
// K2w, with the leaf order and arguments of the narrow kernel below; the
// selfish flags are selfish_in, (M,) or with PACKED (M, R), or null for an
// all-honest roster (SELFISH = false), and `selfish` is unused.
template <int M, typename C, typename S, bool SELFISH, bool FLIGHT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
event_loop_exact_kernel(const int* __restrict__ rows, const int* __restrict__ cap_in,
                        const int* __restrict__ prop_in, unsigned /* selfish */, Leaves in,
                        Leaves out, int steps, int n_runs, Flight fl,
                        const int* __restrict__ selfish_in TPUSIM_SAMPLER_PARAM) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_runs) return;
  const long R = n_runs;
  FlightRun fr;
  if (FLIGHT) fr.load(fl, r, R);

  int t = ld<int>(in.p[0], r);
  int nbt = ld<int>(in.p[1], r);
  int bhp = ld<C>(in.p[2], r);
  int ovf = ld<int>(in.p[13], r);
  int mre = ld<int>(in.p[14], r);
  int sev = ld<int>(in.p[15], r);
  int act = ld<int>(in.p[16], r);
  const int cap = cap_in[r];
  int rdh[kBuckets];
#pragma unroll
  for (int k = 0; k < kBuckets; ++k) rdh[k] = ld<int>(in.p[18], k * R + r);
  copy_column<C>(in.p[3], out.p[3], M, r, R);
  copy_column<C>(in.p[4], out.p[4], M, r, R);
  copy_column<S>(in.p[5], out.p[5], M, r, R);
  copy_column<int>(in.p[6], out.p[6], M, r, R);
  copy_column<int>(in.p[7], out.p[7], M * kSlots, r, R);
  copy_column<C>(in.p[8], out.p[8], M * kSlots, r, R);
  copy_column<C>(in.p[9], out.p[9], static_cast<long>(M) * M * M, r, R);
  copy_column<C>(in.p[10], out.p[10], M * M, r, R);
  copy_column<C>(in.p[11], out.p[11], M * M, r, R);
  copy_column<C>(in.p[12], out.p[12], M, r, R);
  copy_column<int>(in.p[17], out.p[17], M, r, R);
  const Column<C> height(out.p[3], r, R), npriv(out.p[4], r, R), cp(out.p[9], r, R),
      ocp(out.p[10], r, R), oin(out.p[11], r, R), ocnt(out.p[12], r, R);
  const Column<S> stale(out.p[5], r, R);
  const Column<int> base(out.p[6], r, R), sbm(out.p[17], r, R);
  const WideGroups<C> groups(out.p[7], out.p[8], r, R);
  const auto prop = [&](int m) { return PACKED ? prop_in[m * R + r] : prop_in[m]; };
  const auto selfish = [&](int m) {
    return SELFISH && (PACKED ? selfish_in[m * R + r] : selfish_in[m]) != 0;
  };
  // An adopting event's scratch: which miners adopt, and b's published
  // count row. Thread-local, so in local memory, which the compiler knows
  // the leaves' stores cannot touch.
  bool adopt[M];
  int row_bpub[M];

  for (int s = 0; s < steps; ++s) {
    // An inactive step changes nothing, and a run stays inactive to the end
    // of the chunk (t moves only while t < cap): stopping is exact.
    if (!(t < cap)) break;
    const bool found_due = (t == nbt);
#if TPUSIM_RAW_WORDS
    int wq = 0, dt = 0;
    if (found_due) draw_raw<M, PACKED>(rows, s, r, R, smp, wq, dt);
#else
    const int wq = rows[(2L * s) * R + r];
    const int dt = rows[(2L * s + 1) * R + r];
#endif
    int pmin = kInf, arr_miner = 0;  // the arrival row's, from the step-entry groups
    if (FLIGHT) {
#pragma unroll 4
      for (int m = 0; m < M; ++m) {
        const int pm = groups.arrived(m, t);
        if (pm < pmin) {
          pmin = pm;
          arr_miner = m;
        }
      }
    }

    // FoundBlock. A selfish winner appends privately, except that a find on
    // its one private block while the public chain is level with it (bhp)
    // publishes both: the race, a group of count 2.
    const bool won = found_due && 0 <= wq && wq < M;
    bool private_append = false, is_race = false;
    if (SELFISH && won && selfish(wq)) {
      is_race = npriv(wq) == 1 && bhp == height(wq);
      private_append = !is_race;
    }
    int w_idx = 0, h_found = 0;  // the find row's miner and height
    if (won) {
      if (!private_append) ovf += groups.push(wq, t + prop(wq), is_race ? 2 : 1);
      if (SELFISH) npriv.set(wq, npriv(wq) + (private_append ? 1 : (is_race ? -1 : 0)));
      ocnt.set(wq, ocnt(wq) + 1);
      h_found = height(wq) + 1;
      height.set(wq, h_found);
      w_idx = wq;
    }
    if (found_due) nbt = t + dt;

    // Notify sweep, deferred while another find is due at this ms: the flush
    // and the best published chain (private blocks excluded) in one pass
    // (the highest, then the first-seen tip, then the lowest index), and the
    // lowest height, loading kMinerBatch miners' state before flushing any.
    const bool notify = !(found_due && nbt == t);
    const int t_flush = notify ? t : kNegGate;
    int best_h = -kInf, best_tip = kInf, b = M, min_h = kInf;
#pragma unroll 1
    for (int m0 = 0; m0 < M; m0 += kMinerBatch) {
      int h[kMinerBatch], np[kMinerBatch], bs[kMinerBatch];
      int ga[kMinerBatch][kSlots], gc[kMinerBatch][kSlots];
#pragma unroll
      for (int u = 0; u < kMinerBatch; ++u) {
        if (m0 + u >= M) break;
        h[u] = height(m0 + u);
        np[u] = npriv(m0 + u);
        bs[u] = base(m0 + u);
        groups.load(m0 + u, ga[u], gc[u]);
      }
#pragma unroll
      for (int u = 0; u < kMinerBatch; ++u) {
        const int m = m0 + u;
        if (m >= M) break;
        bool flushed;
        const int pub =
            h[u] - WideGroups<C>::flush(ga[u], gc[u], t_flush, bs[u], flushed) - np[u];
        if (flushed) {
          groups.store(m, ga[u], gc[u]);
          base.set(m, bs[u]);
        }
        if (pub > best_h || (pub == best_h && bs[u] < best_tip)) {
          best_h = pub;
          best_tip = bs[u];
          b = m;
        }
        min_h = min(min_h, h[u]);
      }
    }

    if (SELFISH && notify) {
      // Selfish reveal, before the reorg: publish enough private blocks to
      // match or beat the best chain, the whole burst as one merged group.
#pragma unroll 1
      for (int m = 0; m < M; ++m) {
        if (!selfish(m)) continue;
        const int lead = height(m) - best_h;
        const int sc = npriv(m);
        if (!(lead >= 0 && sc > lead)) continue;
        const int n = (sc > 1 && lead == 1) ? sc : sc - lead;
        ovf += groups.push(m, t + prop(m), n);
        npriv.set(m, sc - n);
      }
    }

    // Adoption: a miner adopts b's chain when it is strictly longer.
    const bool any_adopt = notify && best_h > min_h;
    int dmax = 0;
    int miner2 = M, d2 = -1;  // the adoption row's miner: the deepest pop
    if (any_adopt) {
      // b never adopts (its published height is the best); its published
      // own count is the diagonal correction of b's rows.
#if TPUSIM_ONEHOT
      // cpb[j][o] = cp[b, j, o] as the contraction over the M planes.
      const auto cpb = [&](long jo) { return contract_col(cp, jo, static_cast<long>(M) * M, b, M); };
      const int bpub = contract_col(ocnt, 0, 1, b, M) - (contract_col(height, 0, 1, b, M) - best_h);
#else
      const long bM = static_cast<long>(b) * M;
      const int bpub = ocnt(b) - (height(b) - best_h);
#endif
      // The adopters, and their reorg stale accounting: own blocks above
      // lca(i, b).
      stale_pass(M, best_h, b, height, ocnt, ocp, stale, sbm, adopt, dmax, miner2, d2);
      // b's published count row: own_in's row b, diagonal corrected.
#if TPUSIM_ONEHOT
      batched(M, [&](long o) { return o == b ? bpub : contract_col(oin, o, M, b, M); },
              [&](long o, int v) { row_bpub[o] = v; });
#else
      batched(M, [&](long o) { return o == b ? bpub : oin(bM + o); },
              [&](long o, int v) { row_bpub[o] = v; });
#endif
      // own_cp[i][j] = cp[i, j, i] of the factored update (tpusim.state.
      // notify), with cpb[j][o] = cp[b, j, o]:
      //   cp[i, j] = a_i ? ((a_j | j == b) ? b_pub : cpb[j])
      //                  : (a_j ? (i == b ? b_pub : cpb[i]) : cp[i, j])
      // and the adopters' own_in rows and own counts.
#pragma unroll 1
      for (int i = 0; i < M; ++i) {
        const long iM = static_cast<long>(i) * M;
        if (adopt[i]) {
          const int rb_i = row_bpub[i];
#if TPUSIM_ONEHOT
          batched(
              M, [&](long j) { return adopt[j] || j == b ? rb_i : cpb(j * M + i); },
              [&](long j, int v) { ocp.set(iM + j, v); });
#else
          batched(
              M, [&](long j) { return adopt[j] || j == b ? rb_i : cp((bM + j) * M + i); },
              [&](long j, int v) { ocp.set(iM + j, v); });
#endif
          batched(M, [&](long j) { return row_bpub[j]; },
                  [&](long j, int v) { oin.set(iM + j, v); });
          ocnt.set(i, rb_i);
        } else {
#if TPUSIM_ONEHOT
          // cpb's diagonal entry (i, i), as the eye contraction over cpb[i].
          int col = bpub;
          if (i != b) {
            col = 0;
#pragma unroll 1
            for (int q = 0; q < M; ++q) col += q == i ? cpb(iM + q) : 0;
          }
#else
          const int col = (i == b) ? bpub : cp((bM + i) * M + i);
#endif
          batched(M, [&](long j) { return adopt[j]; }, [&](long j, int aj) {
            if (aj) ocp.set(iM + j, col);
          });
        }
      }
      // cp: the pairs with an adopter, each a row of M counts.
#pragma unroll 1
      for (int i = 0; i < M; ++i) {
        const bool ai = adopt[i];
        batched(M, [&](long j) { return adopt[j]; }, [&](long j, int aj) {
          if (!ai && !aj) return;
          const long dst = (static_cast<long>(i) * M + j) * M;
          if (ai ? (aj || j == b) : (i == b)) {
            batched(M, [&](long o) { return row_bpub[o]; },
                    [&](long o, int v) { cp.set(dst + o, v); });
          } else {
#if TPUSIM_ONEHOT
            const long src = (ai ? j : i) * M;
            batched(M, [&](long o) { return cpb(src + o); },
                    [&](long o, int v) { cp.set(dst + o, v); });
#else
            const long src = (bM + (ai ? j : i)) * M;
            batched(M, [&](long o) { return cp(src + o); },
                    [&](long o, int v) { cp.set(dst + o, v); });
#endif
          }
        });
      }
      // The adopters' own state.
      batched(M, [&](long i) { return adopt[i]; }, [&](long i, int ai) {
        if (!ai) return;
        height.set(i, best_h);
        npriv.set(i, 0);
        base.set(i, best_tip);
        groups.clear(i);
      });
    }
    if (notify) bhp = best_h;

    if (FLIGHT) {
      // Row 1: the find, or an arrival if the sweep flushed a group; row 2:
      // the adoption, if any. Heights are after the adoption except the
      // find's.
      if (found_due || (notify && pmin < kInf)) {
        fr.push(fl, r, R, found_due ? kKindFind : kKindArrival, found_due ? w_idx : arr_miner,
                found_due ? h_found : height(arr_miner), 0, t);
      }
      if (any_adopt) {
        fr.push(fl, r, R, dmax > 0 ? kKindStale : kKindReorg, miner2, miner2 < M ? best_h : 0,
                dmax, t);
      }
    }

    // Cut-through to the next event.
    int earliest = kInf;
#pragma unroll 4
    for (int m = 0; m < M; ++m) earliest = min(earliest, groups.pending(m, t));
    t = max(min(nbt, earliest), t);

    mre = max(mre, dmax);
    sev += dmax > 0;
    act += 1;
    if (dmax > 0) {
      const int bucket = min(dmax, kBuckets) - 1;
#pragma unroll
      for (int k = 0; k < kBuckets; ++k) rdh[k] += (k == bucket);
    }
  }

  st<int>(out.p[0], r, t);
  st<int>(out.p[1], r, nbt);
  st<C>(out.p[2], r, bhp);
  st<int>(out.p[13], r, ovf);
  st<int>(out.p[14], r, mre);
  st<int>(out.p[15], r, sev);
  st<int>(out.p[16], r, act);
#pragma unroll
  for (int k = 0; k < kBuckets; ++k) st<int>(out.p[18], k * R + r, rdh[k]);
  if (FLIGHT) fr.store(fl, r, R);
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
      // draw_raw's mapping of the step's two raw words, on a find only.
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

// One launch in count type C and stale type S: the wide kernel one thread a
// run in kThreads-thread blocks; the narrow one a group of kGroupLanes lanes
// a run, kRunsPerBlock runs a block, the runs' tables in dynamic shared
// memory (above 48 KB from M = 11 with int32 counts and M = 14 with int16:
// the attribute raises the kernel's limit).
template <int M, typename C, typename S, bool SELFISH, bool FLIGHT, bool PACKED>
cudaError_t launch_typed(const int* rows, const int* cap, const int* prop, unsigned selfish,
                         const int* selfish_in, const Leaves& in, const Leaves& out, int steps,
                         int n_runs, const Flight& fl TPUSIM_SAMPLER_PARAM, cudaStream_t stream) {
  const auto kernel = event_loop_exact_kernel<M, C, S, SELFISH, FLIGHT, PACKED>;
#if TPUSIM_WIDE
  const dim3 grid((n_runs + kThreads - 1) / kThreads), block(kThreads);
  constexpr int smem = 0;
#else
  const dim3 grid((n_runs + kRunsPerBlock - 1) / kRunsPerBlock), block(kBlockThreads);
  constexpr int smem = narrow_smem_bytes<M, C>();
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
#endif
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
