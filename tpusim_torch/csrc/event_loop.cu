// Fast-mode event loop of the mining simulation, for Hopper (sm_90a).
//
// Replaces the fast-mode variant of tpusim/pallas_engine.py::_make_kernel
// (exact=False, split K=2 group slots, gather reads, pre-mapped int32
// (winner, interval) rows): one chunk of `steps` events for every run, each
// event a block find if one is due, the notify sweep (flush, best chain,
// reorg) and the cut-through time advance, plus the SimCounters updates.
// The plain PyTorch version of the same function is
// tpusim_torch/event_loop.py::event_loop_chunk_plain.
//
// Design. One thread owns one run. The run's state goes from the runs-last
// global leaves into registers (and local memory where they spill) at
// entry, the thread walks all `steps` events, and the state is written back
// once: the TPU kernel's "state resident for the whole chunk", with a
// thread in place of a VMEM lane. Leaves and rows are runs-last, so the 32
// threads of a warp read and write 32 neighbouring words. The ragged edge
// of the runs axis is masked. M (miners) and the count types are template
// parameters; the miner-axis gathers on the best-chain owner b are
// unrolled selects, so no array needs a dynamic index.
//
// What bounds it. Per busy chunk at the default R = 8192 and 1856 steps the
// kernel must read the rows (steps x 2 x R int32, 122 MB) and read and
// write about 0.6 KB of state and counters per run: 132 MB, 0.04 ms at
// 3.35 TB/s. The integer work is larger: outside the adoption branch the
// function needs 29 M + 20 int32 operations per active event (flush, best
// chain, adoption test, cut-through) and 30 more per find (the winner's
// arrival group), ~4.3 G operations for ~14.6 M active events of which about
// half are finds: ~0.26 ms at the H100's ~16.7 TOP/s int32 rate. So
// operations bound it. (The loop above does the group push for every miner
// with branch-free selects, ~30 M per event; that is the kernel's cost, not
// the function's.) In practice a thread runs its events one after another,
// so the latency of each dependent operation, with 2 warps per SM at
// R = 8192 (128 blocks of 64 threads), sets the time; raising occupancy is
// later work.
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
// before the find's push overwrites them; the rows' heights add the
// read-only origin h_base, and the time pair is (base_hi, base_lo + t),
// un-normalized, as the reference stores it. The capacity C is a runtime
// argument. The wrapper copies the input ring to the output once per chunk
// (about 201 MB each way at C = 1024 and R = 8192) and the kernel writes
// only the rows it records, each thread its own runs-last column, so a
// warp's store of one field covers 32 neighbouring words. What bounds it:
// K1's operations plus about 4 M a step for the entry-slot minimum and its
// owner and 3 M an adopting step for the deepest adopter, and K1's bytes
// plus the ring read and written once; chip_smoke.py counts both from the
// chunk it times. FLIGHT = false compiles to the kernel as it was before
// the recorder: every flight statement sits under `if (FLIGHT)`, and the
// flight variants are built as libraries of their own (-DTPUSIM_FLIGHT=1).
//
// Packed grids (PACKED = true, K4f). Replaces the packed variant of the same
// Pallas kernel (packed=True, tpusim/pallas_engine.py:1065-1081): a sweep
// grid's points share one launch, each run with its own point's roster. The
// per-run winner thresholds and mean interval stay in the sampler's torch
// ops, as in the reference, so they reach the kernel already mapped into the
// rows; what the kernel itself takes per run is the propagation delay of
// every miner, prop (M, R) runs-last, where the other variants read one
// (M,) vector for all runs. Each thread loads its run's column once at
// entry, a coalesced read of M words across the warp, and the event loop is
// K1's. What bounds it: K1's operations, and K1's bytes plus the (M, R)
// delays (0.3 MB at R = 8192). PACKED = false compiles to the kernel as it
// was: the packed variant is a library of its own (-DTPUSIM_PACKED=1).
//
// Generic group slots (K >= 3, K5c). Replaces the generic K-slot arrival-group
// machinery of the same Pallas kernel (group_slots >= 3: push_groups at
// tpusim/pallas_engine.py:233-249, the flush and compaction at :367-379, the
// adoption clear and cut-through at :535-539), which the reference's K = 2
// split slots route around. The build passes -DTPUSIM_GROUP_SLOTS=<K>. Each
// thread keeps its run's buffer as int ga[M][K], gc[M][K]; every slot index is
// a compile-time one after unrolling (a push, the flush and the compaction are
// selects against the run's occupied and arrived counts), so the buffer may
// live in registers, spilling to local memory where they run out (36 slots of
// each at M = 9, K = 4). A push merges an equal arrival into the last occupied
// slot and, when all K are full, merges into slot K - 1 and counts the
// overflow; a flush moves the tip of the arrived prefix into base and shifts
// the rest left, kInf and 0 filling the tail. What bounds it: K1's operations
// with the group terms at K slots (per miner and active event 9 K + 11, 29 at K
// = 2; per find 5 K + 20, 30 at K = 2), and K1's bytes with (M, K, R) groups.
// chip_smoke.py counts both. K = 2 compiles to the split-slot kernel as it was:
// every generic statement sits in the `else` of an `if constexpr (kSlots ==
// 2)`, and a K = 2 build takes no flag.
//
// Packed grids with the flight recorder (PACKED and FLIGHT, K4 x K3): the
// two compose as they are, the ring code K3's and the per-run operands K4's,
// each at its own argument offsets, in a library of their own
// (-DTPUSIM_PACKED=1 -DTPUSIM_FLIGHT=1).
//
// Wide rosters (TPUSIM_WIDE, K1w). Replaces the same Pallas kernel at more
// than 16 miners (K1 wide: the TPU runs 17-24 fast miners through it, VMEM
// guard at tpusim/pallas_engine.py:735-774, and wider rosters on its scan
// engine, tpusim/engine.py:335 _step_event), with FLIGHT, PACKED and any K as
// above. Built with -DTPUSIM_WIDE=1, for any M. At M = 32 the narrow design
// would hold 2,048 (M, M) table entries a thread and unroll every M^2 body, so
// here a run's per-miner vectors and its own_cp/own_in tables stay in its
// output leaves in global memory, runs-last (a warp's access to one entry is
// 32 neighbouring elements): the thread copies its column of every leaf from
// the input once at entry and updates it in place, and b-indexed reads are
// single loads. Thread-local arrays would have held the state in local
// memory, reserved for every resident thread; the output leaves must be
// written anyway. Loops over miners stay rolled (a small unroll factor), so
// compile time and code size do not grow with M. An event makes one pass
// over the miners for the flush, the best chain and the lowest height (so
// whether anyone adopts); an adopting event three more: the adopters and
// their stale accounting, the table rows and columns, the adopters' own
// state. Two per-event scratch vectors of M entries, the adopter flags and
// b's published count row, are thread-local arrays (local memory): no miner
// set is a bit mask, so no width limit. The leaves are plain pointers that
// the compiler must assume alias, so a load cannot move above an earlier
// store; the passes load kMinerBatch miners, or kBatch entries, before
// storing any (event_loop_common.cuh: batched), and the table writes take
// their values from the local scratch, which no store to a leaf can touch.
// What bounds it: the operations of K1 (the same function), and K1's bytes
// with (M, M) tables; a thread's accesses hit its own state in L1 and L2
// (about 5 KB a run at M = 32 with int16 counts, 40 MB at R = 8192), so in
// practice the latency of its dependent accesses, with 2 warps per SM at
// R = 8192, sets the time.
//
// Raw words (TPUSIM_RAW_WORDS, K5a). Replaces the same Pallas kernel with
// rng_batch=False (tpusim/pallas_engine.py:293-309), in every variant above:
// a step's row holds its two raw threefry words (int32 bit patterns), and on
// a step where a block is found the thread maps them itself (draw_raw in
// event_loop_common.cuh): the winner by the uint32 threshold intervals, the
// interval by the F1 transcription of XLA:CPU's log1p, every float operation
// an explicitly rounded intrinsic so that nvcc contracts none but the 24
// multiply-adds XLA contracts. The thresholds and the mean are a Sampler,
// the kernel's last parameter (per run when PACKED). What bounds it: K1's
// operations plus, per find, 87 float32 operations and 4 M + 5 int32 ones;
// K1's bytes with the raw words in place of the mapped rows, the same size.
// The other variants' text is unchanged: every raw-word statement sits under
// `#if TPUSIM_RAW_WORDS`.
//
// One-hot reads (TPUSIM_ONEHOT, K5b). Replaces the same Pallas kernel with
// consensus_gather=False (tpusim/pallas_engine.py:442-449, 459-461): each read
// indexed by the best chain's owner b (height, own_cnt, own_cp's column b,
// own_in's row b) is the contraction sum_m v[m] * [m == b] over the miner
// axis, in registers (contract_b), or in the wide variants over M loads of
// the run's column (contract_col). Only one term is nonzero, so the values
// are the gather's. What bounds it: K1's operations plus 2 M (2 M + 2) for
// the contractions of each adopting event.

#include "event_loop_common.cuh"

namespace {

constexpr int kLeaves = 16;  // 11 state + 5 counter leaves

struct Leaves {
  void* p[kLeaves];
};

#if TPUSIM_WIDE
// K1w, with the leaf order and arguments of the narrow kernel below.
template <int M, typename C, typename S, bool FLIGHT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
event_loop_kernel(const int* __restrict__ rows, const int* __restrict__ cap_in,
                  const int* __restrict__ prop_in, Leaves in, Leaves out,
                  int steps, int n_runs, Flight fl TPUSIM_SAMPLER_PARAM) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_runs) return;
  const long R = n_runs;
  FlightRun fr;
  if (FLIGHT) fr.load(fl, r, R);

  int t = ld<int>(in.p[0], r);
  int nbt = ld<int>(in.p[1], r);
  int ovf = ld<int>(in.p[10], r);
  int mre = ld<int>(in.p[11], r);
  int sev = ld<int>(in.p[12], r);
  int act = ld<int>(in.p[13], r);
  const int cap = cap_in[r];
  int rdh[kBuckets];
#pragma unroll
  for (int k = 0; k < kBuckets; ++k) rdh[k] = ld<int>(in.p[15], k * R + r);
  copy_column<C>(in.p[2], out.p[2], M, r, R);
  copy_column<S>(in.p[3], out.p[3], M, r, R);
  copy_column<int>(in.p[4], out.p[4], M, r, R);
  copy_column<int>(in.p[5], out.p[5], M * kSlots, r, R);
  copy_column<C>(in.p[6], out.p[6], M * kSlots, r, R);
  copy_column<C>(in.p[7], out.p[7], M * M, r, R);
  copy_column<C>(in.p[8], out.p[8], M * M, r, R);
  copy_column<C>(in.p[9], out.p[9], M, r, R);
  copy_column<int>(in.p[14], out.p[14], M, r, R);
  const Column<C> height(out.p[2], r, R), ocp(out.p[7], r, R), oin(out.p[8], r, R),
      ocnt(out.p[9], r, R);
  const Column<S> stale(out.p[3], r, R);
  const Column<int> base(out.p[4], r, R), sbm(out.p[14], r, R);
  const WideGroups<C> groups(out.p[5], out.p[6], r, R);
  const auto prop = [&](int m) { return PACKED ? prop_in[m * R + r] : prop_in[m]; };
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

    // FoundBlock: the winner's own count, height and one arrival group.
    int w_idx = 0, h_found = 0;  // the find row's miner and height
    if (found_due && 0 <= wq && wq < M) {
      ovf += groups.push(wq, t + prop(wq), 1);
      ocnt.set(wq, ocnt(wq) + 1);
      h_found = height(wq) + 1;
      height.set(wq, h_found);
      w_idx = wq;
    }
    if (found_due) nbt = t + dt;

    // Notify sweep, deferred while another find is due at this ms: the flush
    // and the best published chain in one pass (the highest, then the
    // first-seen tip, then the lowest index), and the lowest height, loading
    // kMinerBatch miners' state before flushing any.
    const bool notify = !(found_due && nbt == t);
    const int t_flush = notify ? t : kNegGate;
    int best_h = -kInf, best_tip = kInf, b = M, min_h = kInf;
#pragma unroll 1
    for (int m0 = 0; m0 < M; m0 += kMinerBatch) {
      int h[kMinerBatch], bs[kMinerBatch], ga[kMinerBatch][kSlots], gc[kMinerBatch][kSlots];
#pragma unroll
      for (int u = 0; u < kMinerBatch; ++u) {
        if (m0 + u >= M) break;
        h[u] = height(m0 + u);
        bs[u] = base(m0 + u);
        groups.load(m0 + u, ga[u], gc[u]);
      }
#pragma unroll
      for (int u = 0; u < kMinerBatch; ++u) {
        const int m = m0 + u;
        if (m >= M) break;
        bool flushed;
        const int pub = h[u] - WideGroups<C>::flush(ga[u], gc[u], t_flush, bs[u], flushed);
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

    // Adoption: a miner adopts b's chain when it is strictly longer.
    const bool any_adopt = notify && best_h > min_h;
    int dmax = 0;
    int miner2 = M, d2 = -1;  // the adoption row's miner: the deepest pop
    if (any_adopt) {
      // b never adopts (its published height is the best); its published
      // own count is the diagonal correction of b's rows.
#if TPUSIM_ONEHOT
      const int bpub = contract_col(ocnt, 0, 1, b, M) - (contract_col(height, 0, 1, b, M) - best_h);
#else
      const long bM = static_cast<long>(b) * M;
      const int bpub = ocnt(b) - (height(b) - best_h);
#endif
      // The adopters, and their reorg stale accounting: own blocks above
      // lca(i, b).
      stale_pass(M, best_h, b, height, ocnt, ocp, stale, sbm, adopt, dmax, miner2, d2);
      // b's published count row (own_in's row b, diagonal corrected).
#if TPUSIM_ONEHOT
      batched(M, [&](long o) { return o == b ? bpub : contract_col(oin, o, M, b, M); },
              [&](long o, int v) { row_bpub[o] = v; });
#else
      batched(M, [&](long o) { return o == b ? bpub : oin(bM + o); },
              [&](long o, int v) { row_bpub[o] = v; });
#endif
      // Adopters' rows take b's published view; the other rows' columns
      // toward the adopters take their own_cp with b (fast mode).
#pragma unroll 1
      for (int i = 0; i < M; ++i) {
        const long iM = static_cast<long>(i) * M;
        if (adopt[i]) {
          const int rb_i = row_bpub[i];
          batched(M, [&](long j) { return row_bpub[j]; }, [&](long j, int v) {
            ocp.set(iM + j, rb_i);
            oin.set(iM + j, v);
          });
          ocnt.set(i, rb_i);
        } else {
#if TPUSIM_ONEHOT
          const int col = (i == b) ? bpub : contract_col(ocp, iM, 1, b, M);
#else
          const int col = (i == b) ? bpub : ocp(iM + b);
#endif
          batched(M, [&](long j) { return adopt[j]; }, [&](long j, int aj) {
            if (aj) ocp.set(iM + j, col);
          });
        }
      }
      // The adopters' own state.
      batched(M, [&](long i) { return adopt[i]; }, [&](long i, int ai) {
        if (!ai) return;
        height.set(i, best_h);
        base.set(i, best_tip);
        groups.clear(i);
      });
    }

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
  st<int>(out.p[10], r, ovf);
  st<int>(out.p[11], r, mre);
  st<int>(out.p[12], r, sev);
  st<int>(out.p[13], r, act);
#pragma unroll
  for (int k = 0; k < kBuckets; ++k) st<int>(out.p[15], k * R + r, rdh[k]);
  if (FLIGHT) fr.store(fl, r, R);
}
#else
// Leaf order: t, nbt, height, stale, base, garr, gcnt, ocp, oin, ocnt, ovf,
// then the counters mre, sev, act, sbm, rdh (tpusim_torch.event_loop).
// C is the count type, S the type of `stale`.
template <int M, typename C, typename S, bool FLIGHT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
event_loop_kernel(const int* __restrict__ rows, const int* __restrict__ cap_in,
                  const int* __restrict__ prop_in, Leaves in, Leaves out,
                  int steps, int n_runs, Flight fl TPUSIM_SAMPLER_PARAM) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_runs) return;
  const long R = n_runs;
  FlightRun fr;
  if (FLIGHT) fr.load(fl, r, R);

  int t = ld<int>(in.p[0], r);
  int nbt = ld<int>(in.p[1], r);
  int ovf = ld<int>(in.p[10], r);
  int mre = ld<int>(in.p[11], r);
  int sev = ld<int>(in.p[12], r);
  int act = ld<int>(in.p[13], r);
  const int cap = cap_in[r];
  int height[M], stale[M], base[M], a0[M], a1[M], c0[M], c1[M], ocnt[M];
  int prop[M], sbm[M], rdh[kBuckets];
  int ocp[M][M], oin[M][M];
  int ga[M][kGenSlots], gc[M][kGenSlots];  // the generic buffer (K >= 3)
#pragma unroll
  for (int m = 0; m < M; ++m) {
    height[m] = ld<C>(in.p[2], m * R + r);
    stale[m] = ld<S>(in.p[3], m * R + r);
    base[m] = ld<int>(in.p[4], m * R + r);
    if constexpr (kSlots == 2) {
      a0[m] = ld<int>(in.p[5], (2 * m) * R + r);
      a1[m] = ld<int>(in.p[5], (2 * m + 1) * R + r);
      c0[m] = ld<C>(in.p[6], (2 * m) * R + r);
      c1[m] = ld<C>(in.p[6], (2 * m + 1) * R + r);
    } else {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        ga[m][k] = ld<int>(in.p[5], (m * kSlots + k) * R + r);
        gc[m][k] = ld<C>(in.p[6], (m * kSlots + k) * R + r);
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      ocp[m][j] = ld<C>(in.p[7], (m * M + j) * R + r);
      oin[m][j] = ld<C>(in.p[8], (m * M + j) * R + r);
    }
    ocnt[m] = ld<C>(in.p[9], m * R + r);
    sbm[m] = ld<int>(in.p[14], m * R + r);
    prop[m] = PACKED ? prop_in[m * R + r] : prop_in[m];
  }
#pragma unroll
  for (int k = 0; k < kBuckets; ++k) rdh[k] = ld<int>(in.p[15], k * R + r);

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
    if constexpr (kSlots == 2) {
      if (FLIGHT) earliest_arrived<M>(a0, a1, t, pmin, arr_miner);
    } else {
      if (FLIGHT) earliest_arrived_k<M, kSlots>(ga, t, pmin, arr_miner);
    }

    // FoundBlock: the winner's own count, height and one arrival group.
    int over = 0;
    int w_idx = 0, h_found = 0;  // the find row's miner and height
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const bool ow = found_due && (m == wq);
      if constexpr (kSlots == 2) {
        over += push2(a0[m], a1[m], c0[m], c1[m], t + prop[m], 1, ow);
      } else {
        over += push_k<kSlots>(ga[m], gc[m], t + prop[m], 1, ow);
      }
      ocnt[m] += ow;
      height[m] += ow;
      if (FLIGHT && ow) {
        w_idx = m;
        h_found = height[m];
      }
    }
    ovf += over;
    if (found_due) nbt = t + dt;

    // Notify sweep, deferred while another find is due at this ms.
    const bool notify = !(found_due && nbt == t);
    const int t_flush = notify ? t : kNegGate;
    int pub[M];
    int best_h = -kInf;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if constexpr (kSlots == 2) {
        const bool f0 = a0[m] <= t_flush, f1 = a1[m] <= t_flush;
        base[m] = f1 ? a1[m] : (f0 ? a0[m] : base[m]);
        const int na0 = f1 ? kInf : (f0 ? a1[m] : a0[m]);
        const int na1 = f0 ? kInf : a1[m];
        const int nc0 = f1 ? 0 : (f0 ? c1[m] : c0[m]);
        const int nc1 = f0 ? 0 : c1[m];
        a0[m] = na0;
        a1[m] = na1;
        c0[m] = nc0;
        c1[m] = nc1;
        pub[m] = height[m] - (nc0 + nc1);
      } else {
        pub[m] = height[m] - flush_k<kSlots>(ga[m], gc[m], t_flush, base[m]);
      }
      best_h = max(best_h, pub[m]);
    }
    // Best published chain: first-seen tiebreak, then the lowest index.
    int best_tip = kInf;
#pragma unroll
    for (int m = 0; m < M; ++m) best_tip = min(best_tip, pub[m] == best_h ? base[m] : kInf);
    int b = M;
#pragma unroll
    for (int m = M - 1; m >= 0; --m) b = (pub[m] == best_h && base[m] == best_tip) ? m : b;

    bool adopt[M];
    bool any_adopt = false;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      adopt[m] = notify && best_h > height[m];
      any_adopt |= adopt[m];
    }
    int dmax = 0;
    int miner2 = M, d2 = -1;  // the adoption row's miner: the deepest pop
    if (any_adopt) {
      // Reads of b's rows, diagonals corrected from ocnt (the authority).
#if TPUSIM_ONEHOT
      const int unpub_b = contract_b<M>(height, b) - best_h;
      const int cnt_b = contract_b<M>(ocnt, b);
#else
      const int unpub_b = pick<M>(height, b) - best_h;
      const int cnt_b = pick<M>(ocnt, b);
#endif
      int row_bpub[M], col_cp[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
#if TPUSIM_ONEHOT
        const int oc_b = (i == b) ? cnt_b : contract_b<M>(ocp[i], b);
        int row_b = 0;
#pragma unroll
        for (int k = 0; k < M; ++k) row_b += oin[k][i] * (k == b);
#else
        const int oc_b = (i == b) ? cnt_b : pick<M>(ocp[i], b);
        int row_b = 0;
#pragma unroll
        for (int k = 0; k < M; ++k) row_b = (k == b) ? oin[k][i] : row_b;
#endif
        row_b = (i == b) ? cnt_b : row_b;
        row_bpub[i] = row_b - ((i == b) ? unpub_b : 0);
        col_cp[i] = oc_b - ((i == b) ? unpub_b : 0);
        // Reorg stale accounting: own blocks above lca(i, b).
        const int d_stale = adopt[i] ? ocnt[i] - oc_b : 0;
        stale[i] += d_stale;
        dmax = max(dmax, d_stale);
        sbm[i] += d_stale > 0;
        if (FLIGHT && adopt[i] && (d_stale > d2 || (miner2 == M && d_stale == d2))) {
          miner2 = i;
          d2 = d_stale;
        }
      }
      // Adoption: rows of adopters and columns toward them (fast mode).
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int j = 0; j < M; ++j) {
          ocp[i][j] = adopt[i] ? row_bpub[i] : (adopt[j] ? col_cp[i] : ocp[i][j]);
          oin[i][j] = adopt[i] ? row_bpub[j] : oin[i][j];
        }
        if (adopt[i]) {
          ocnt[i] = row_bpub[i];
          height[i] = best_h;
          base[i] = best_tip;
          if constexpr (kSlots == 2) {
            a0[i] = kInf;
            a1[i] = kInf;
            c0[i] = 0;
            c1[i] = 0;
          } else {
#pragma unroll
            for (int k = 0; k < kSlots; ++k) {
              ga[i][k] = kInf;
              gc[i][k] = 0;
            }
          }
        }
      }
    }

    if (FLIGHT) {
      // Row 1: the find, or an arrival if the sweep flushed a group; row 2:
      // the adoption, if any. Heights are after the adoption except the
      // find's.
      if (found_due || (notify && pmin < kInf)) {
        fr.push(fl, r, R, found_due ? kKindFind : kKindArrival, found_due ? w_idx : arr_miner,
                found_due ? h_found : pick<M>(height, arr_miner), 0, t);
      }
      if (any_adopt) {
        fr.push(fl, r, R, dmax > 0 ? kKindStale : kKindReorg, miner2, miner2 < M ? best_h : 0,
                dmax, t);
      }
    }

    // Cut-through to the next event.
    int earliest = kInf;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if constexpr (kSlots == 2) {
        earliest = min(earliest, a0[m] > t ? a0[m] : kInf);
        earliest = min(earliest, a1[m] > t ? a1[m] : kInf);
      } else {
        earliest = min(earliest, pending_k<kSlots>(ga[m], t));
      }
    }
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
  st<int>(out.p[10], r, ovf);
  st<int>(out.p[11], r, mre);
  st<int>(out.p[12], r, sev);
  st<int>(out.p[13], r, act);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    st<C>(out.p[2], m * R + r, height[m]);
    st<S>(out.p[3], m * R + r, stale[m]);
    st<int>(out.p[4], m * R + r, base[m]);
    if constexpr (kSlots == 2) {
      st<int>(out.p[5], (2 * m) * R + r, a0[m]);
      st<int>(out.p[5], (2 * m + 1) * R + r, a1[m]);
      st<C>(out.p[6], (2 * m) * R + r, c0[m]);
      st<C>(out.p[6], (2 * m + 1) * R + r, c1[m]);
    } else {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        st<int>(out.p[5], (m * kSlots + k) * R + r, ga[m][k]);
        st<C>(out.p[6], (m * kSlots + k) * R + r, gc[m][k]);
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      st<C>(out.p[7], (m * M + j) * R + r, ocp[m][j]);
      st<C>(out.p[8], (m * M + j) * R + r, oin[m][j]);
    }
    st<C>(out.p[9], m * R + r, ocnt[m]);
    st<int>(out.p[14], m * R + r, sbm[m]);
  }
#pragma unroll
  for (int k = 0; k < kBuckets; ++k) st<int>(out.p[15], k * R + r, rdh[k]);
  if (FLIGHT) fr.store(fl, r, R);
}
#endif  // TPUSIM_WIDE

template <int M, bool FLIGHT, bool PACKED>
cudaError_t launch_m(const int* rows, const int* cap, const int* prop, const Leaves& in,
                     const Leaves& out, int count16, int stale16, int steps, int n_runs,
                     const Flight& fl TPUSIM_SAMPLER_PARAM, cudaStream_t stream) {
  const dim3 grid((n_runs + kThreads - 1) / kThreads), block(kThreads);
  if (count16 && stale16) {
    event_loop_kernel<M, int16_t, int16_t, FLIGHT, PACKED>
        <<<grid, block, 0, stream>>>(rows, cap, prop, in, out, steps, n_runs, fl TPUSIM_SAMPLER_ARG);
  } else if (count16) {
    event_loop_kernel<M, int16_t, int32_t, FLIGHT, PACKED>
        <<<grid, block, 0, stream>>>(rows, cap, prop, in, out, steps, n_runs, fl TPUSIM_SAMPLER_ARG);
  } else if (!stale16) {
    event_loop_kernel<M, int32_t, int32_t, FLIGHT, PACKED>
        <<<grid, block, 0, stream>>>(rows, cap, prop, in, out, steps, n_runs, fl TPUSIM_SAMPLER_ARG);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch(const void* rows, const void* cap, const void* prop, void* const* in,
                   void* const* out, int n_miners, int count16, int stale16, int steps,
                   int n_runs, const Flight& fl TPUSIM_SAMPLER_PARAM, void* stream) {
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
      rw, cp, pp, lin, lout, count16, stale16, steps, n_runs, fl TPUSIM_SAMPLER_ARG, s);
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
                                          TPUSIM_SAMPLER_C_PARAMS, void* stream) {
  if (capacity < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Flight fl{static_cast<const int*>(flight[0]), static_cast<const int*>(flight[1]),
                  static_cast<int*>(flight[2]), static_cast<int*>(flight[3]),
                  static_cast<int*>(flight[4]), capacity};
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, count16, stale16, steps,
                                 n_runs, fl TPUSIM_SAMPLER_C_ARGS, stream));
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
                                   void* const* flight, int capacity TPUSIM_SAMPLER_C_PARAMS,
                                   void* stream) {
  if (capacity < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Flight fl{static_cast<const int*>(flight[0]), static_cast<const int*>(flight[1]),
                  static_cast<int*>(flight[2]), static_cast<int*>(flight[3]),
                  static_cast<int*>(flight[4]), capacity};
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, count16, stale16, steps,
                                 n_runs, fl TPUSIM_SAMPLER_C_ARGS, stream));
}
#elif TPUSIM_PACKED
// Launch one chunk of a packed grid on `stream`, as tpusim_event_loop_chunk
// does for one roster; `prop` holds the (M, R) runs-last int32 delays, one
// per (miner, run).
int tpusim_event_loop_packed_chunk(const void* rows, const void* cap, const void* prop,
                                   void* const* in, void* const* out, int n_miners,
                                   int count16, int stale16, int steps, int n_runs
                                   TPUSIM_SAMPLER_C_PARAMS, void* stream) {
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, count16, stale16, steps,
                                 n_runs, Flight{} TPUSIM_SAMPLER_C_ARGS, stream));
}
#else
// Launch one chunk on `stream` for `n_miners` == TPUSIM_MINERS miners. `in`
// and `out` hold the 16 leaf pointers (device addresses) in the order above;
// `in` is only read. Returns the launch's cudaError_t (0 on success); the
// kernel runs asynchronously.
int tpusim_event_loop_chunk(const void* rows, const void* cap, const void* prop,
                            void* const* in, void* const* out, int n_miners,
                            int count16, int stale16, int steps, int n_runs
                            TPUSIM_SAMPLER_C_PARAMS, void* stream) {
  return static_cast<int>(launch(rows, cap, prop, in, out, n_miners, count16, stale16, steps,
                                 n_runs, Flight{} TPUSIM_SAMPLER_C_ARGS, stream));
}
#endif

const char* tpusim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
