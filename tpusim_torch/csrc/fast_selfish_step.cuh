// The per-lane rules of the fast kernel's selfish form (event_loop.cu,
// -DTPUSIM_FAST_SELFISH=1: K1s, K3fs, K4fs): one miner's private chain at a
// find and at a notify, as the plain version states them
// (tpusim_torch/event_loop.py, event_loop_chunk_plain's find and reveal;
// tpusim/state.py found_block and notify). They touch no other lane, so they
// build for the host too: tests/test_torch_fast_selfish_host.py holds them
// against the plain version with g++ and no card. The adoption zeroes an
// adopter's private count (event_loop.cu), and a notify sets bhp, the best
// published height, to the sweep's.

#pragma once

namespace {

// A find's effect on its winner's private chain. A selfish winner appends
// privately, except that a find on top of its one private block while the
// public chain is level with it (bhp, the best published height at the last
// notify) publishes both: the race. Moves `npriv`, sets `count` to the
// blocks the find pushes into the winner's arrival groups (2 on a race, else
// 1) and returns whether it pushes: where `won` (this miner found) and the
// find is not a private append.
__host__ __device__ __forceinline__ bool selfish_find(bool won, bool sel, int& npriv, int bhp,
                                                      int height, int& count) {
  const bool race = won && sel && npriv == 1 && bhp == height;
  const bool append = won && sel && !race;
  npriv += append ? 1 : (race ? -1 : 0);
  count = race ? 2 : 1;
  return won && !append;
}

// Whether a miner reveals at this step: a notify, a selfish miner, its chain
// (its height, private blocks included) at least as long as the best
// published one (lead = height - best published height >= 0), and more
// private blocks than the lead.
__host__ __device__ __forceinline__ bool selfish_reveals(bool notify, bool sel, int lead,
                                                         int npriv) {
  return notify && sel && lead >= 0 && npriv > lead;
}

// The reveal where `reveal` holds: every private block at a lead of one,
// else enough to match the best chain (npriv - lead). Moves `npriv` and
// returns the blocks published (0 where `reveal` is false).
__host__ __device__ __forceinline__ int selfish_reveal(bool reveal, int lead, int& npriv) {
  const int n = reveal ? (npriv > 1 && lead == 1 ? npriv : npriv - lead) : 0;
  npriv -= n;
  return n;
}

}  // namespace
