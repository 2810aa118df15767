// The fast kernel's selfish per-lane rules (tpusim_torch/csrc/
// fast_selfish_step.cuh) on the host, for tests/test_torch_fast_selfish_host.py:
// one miner's lane through one step as event_loop.cu's selfish form steps it
// (TPUSIM_FAST_SELFISH: the find's push, the notify's flush, the published
// height, the reveal and its push, the adoption, bhp), with the kernel's own
// group helpers (push2 and flush2 from event_loop_common.cuh) and the best
// published height of the other miners given. Build with g++ -std=c++20
// -I tests/cuda_host -I tpusim_torch/csrc.

#include <cuda_runtime.h>

// event_loop_common.cuh's lane groups name the warp collectives; nothing
// here calls them.
int __reduce_max_sync(unsigned, int);
int __reduce_min_sync(unsigned, int);
int __reduce_add_sync(unsigned, int);
unsigned __ballot_sync(unsigned, bool);
int __shfl_sync(unsigned, int, int, int = 32);
int __ffs(unsigned);
void __syncwarp(unsigned);

#define TPUSIM_MINERS 2
#include "event_loop_common.cuh"
#include "fast_selfish_step.cuh"

namespace {

// One case's inputs, in order, and its outputs.
enum In { kWon, kSel, kNpriv, kBhp, kHeight, kA0, kA1, kC0, kC1, kT, kProp, kNotify,
          kRivalPub, kIn };
enum Out { kOutNpriv, kOutA0, kOutA1, kOutC0, kOutC1, kOvf, kOutBhp, kPushed, kLead,
           kReveal, kRevealed, kOut };

void lane_step(const int* in, int* out) {
  const bool won = in[kWon], sel = in[kSel], notify = in[kNotify];
  int npriv = in[kNpriv], bhp = in[kBhp], height = in[kHeight];
  int a0 = in[kA0], a1 = in[kA1], c0 = in[kC0], c1 = in[kC1], base = 0;
  const int t = in[kT], arrival = in[kT] + in[kProp];
  int ovf = 0;
  int count;
  const bool pushes = selfish_find(won, sel, npriv, bhp, height, count);
  const int pushed = pushes ? count : 0;
  ovf += push2(a0, a1, c0, c1, arrival, count, pushes);
  height += won;
  const int unarrived = flush2(a0, a1, c0, c1, notify ? t : kNegGate, base);
  const int best_h = max(height - unarrived - npriv, in[kRivalPub]);
  const int lead = height - best_h;
  const bool reveal = selfish_reveals(notify, sel, lead, npriv);
  const int revealed = selfish_reveal(reveal, lead, npriv);
  ovf += push2(a0, a1, c0, c1, arrival, revealed, reveal);
  if (notify && best_h > height) {
    npriv = 0;
    a0 = a1 = kInf;
    c0 = c1 = 0;
  }
  if (notify) bhp = best_h;
  const int got[kOut] = {npriv, a0, a1, c0, c1, ovf, bhp, pushed, lead, reveal, revealed};
  for (int i = 0; i < kOut; ++i) out[i] = got[i];
}

}  // namespace

// Steps n cases: `in` holds kIn ints a case, `out` kOut. Returns 0, or -1
// where the layout is not the caller's (n_in, n_out).
extern "C" int tpusim_fast_selfish_host(int n, int n_in, int n_out, const int* in, int* out) {
  if (n_in != kIn || n_out != kOut) return -1;
  for (int i = 0; i < n; ++i) lane_step(in + i * kIn, out + i * kOut);
  return 0;
}
