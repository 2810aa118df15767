#!/usr/bin/env python3
"""Time variants of the fast event-loop kernel (tpusim_torch/csrc/
event_loop.cu) on one NVIDIA card, in turns.

Each variant is an edit of the kernel's source, built and timed on one busy
chunk of each case by the harness in scripts/kernel_variants.py. Every
variant computes the same function and is held against the checkout's
kernel.

    python3 scripts/fast_variants.py

Variants: the checkout (up to 16 miners 16 lanes a run, lane m miner m,
the warp's two runs stepping together with full-mask collectives,
RunPair; a warp a run in the flight variants); 16 lanes a run in the
flight variants too; 16 lanes with each collective over its own run's
lanes (RunGroup); 8 lanes a run (lane l miners l and l + 8, P = 2, four
runs a warp, group masks); a warp a run (RunWarp, P = 1, lanes 9-31 idle
at M = 9); the adoption's table writes as a loop over the adopters' ballot
bits in place of an unrolled pass over the lane's row; and the raw-word
mapping done by lane 0 and handed to the other lanes. Cases: the default
9-miner roster (K1) with int16 and int32 counts, with a 1,024-row ring
(K3f), at 4 group slots (K5c) and with raw words (K5a); path W1's 32
miners (K1w).
"""

from __future__ import annotations

import dataclasses

from kernel_variants import ROOT, run, sub
from tpusim_torch.config import SimConfig, default_network
from tpusim_torch.csrc import build

SOURCE = ROOT / "tpusim_torch" / "csrc" / "event_loop.cu"
LANES = ("constexpr int kLanes = (TPUSIM_WIDE || TPUSIM_FLIGHT) ? kWarpLanes : kGroupLanes;\n"
         "using Group = std::conditional_t<kLanes == kWarpLanes, RunWarp, RunPair>;")


def _lanes(narrow: str, group: str) -> str:
    """The narrow width and group helper at every M <= 16, ring or not."""
    return (f"constexpr int kLanes = TPUSIM_WIDE ? kWarpLanes : {narrow};\n"
            f"using Group = std::conditional_t<kLanes == kWarpLanes, RunWarp, {group}>;")

BLOCK = "constexpr int kBlockThreads = 128;\n"
#: An 8-lane group a run, lane l miners l and l + 8, four runs a warp, each
#: collective over its own group's lanes.
OCTET = """
struct RunOctet {
  unsigned mask;
  int shift, lane;
  __device__ __forceinline__ explicit RunOctet(int thread)
      : mask(0xFFu << (thread & 24)), shift(thread & 24), lane(thread & 7) {}
  __device__ __forceinline__ int max(int v) const { return __reduce_max_sync(mask, v); }
  __device__ __forceinline__ int min(int v) const { return __reduce_min_sync(mask, v); }
  __device__ __forceinline__ int add(int v) const { return __reduce_add_sync(mask, v); }
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return (__ballot_sync(mask, p) >> shift) & 0xFFu;
  }
  __device__ __forceinline__ int from(int v, int src) const {
    return __shfl_sync(mask, v, src, 8);
  }
};
"""
ADOPT = """          const int v = adopt[k] ? rb[k] : col[k];
#pragma unroll
          for (int j = 0; j < M; ++j) {
            const bool aj = (amask[j / kLanes] >> (j % kLanes)) & 1u;
            if (adopt[k] || aj) ocp[k][j] = static_cast<C>(v);
            if (aj) oin[k][j] = static_cast<C>(rb[k]);
          }
"""
ADOPT_BITS = """          if (adopt[k]) {
            for (int j = 0; j < M; ++j) ocp[k][j] = static_cast<C>(rb[k]);
          }
#pragma unroll
          for (int w = 0; w < P; ++w) {
            for (unsigned a = amask[w]; a; a &= a - 1) {
              const int j = w * kLanes + __ffs(a) - 1;
              if (!adopt[k]) ocp[k][j] = static_cast<C>(col[k]);
              oin[k][j] = static_cast<C>(rb[k]);
            }
          }
"""
RAW = """        wq = max(g.max_of(hit), 0);
        dt = interval_from_word(static_cast<unsigned>(w1), mean);
"""
RAW_LANE0 = """        if (g.lane == 0) {
          const long off = PACKED ? r : 0, stride = PACKED ? R : 1;
          wq = winner_from_word<M>(static_cast<unsigned>(w0), smp.lo + off, smp.hi + off, stride);
          dt = interval_from_word(static_cast<unsigned>(w1), smp.mean[off]);
        }
        wq = g.g.from(wq, 0);
        dt = g.g.from(dt, 0);
"""


#: name -> (edit of the source, whether it computes the same function): all do.
VARIANTS = {name: (edit, True) for name, edit in {
    "checkout": lambda s: s,
    "16 lanes with the ring too": lambda s: sub(s, LANES, _lanes("kGroupLanes", "RunPair")),
    "16 lanes, group masks": lambda s: sub(s, LANES, _lanes("kGroupLanes", "RunGroup")),
    "8 lanes": lambda s: sub(sub(s, LANES, _lanes("8", "RunOctet")), BLOCK, BLOCK + OCTET),
    "32 lanes": lambda s: sub(s, LANES, _lanes("kWarpLanes", "RunWarp")),
    "adopters' bits": lambda s: sub(s, ADOPT, ADOPT_BITS),
    "raw in lane 0": lambda s: sub(s, RAW, RAW_LANE0),
}.items()}


def _cases() -> dict[str, SimConfig]:
    cfg = SimConfig(network=default_network())
    h32 = (14, 11, 9, 8, 6, 5, 4, 3) + (2,) * 16 + (1,) * 8
    return {"default int16 (K1)": cfg,
            "default int32 (K1)": dataclasses.replace(cfg, state_dtype="int32"),
            "flight default (K3f)": dataclasses.replace(cfg, flight_capacity=1024),
            "default K = 4 (K5c)": dataclasses.replace(cfg, group_slots=4),
            "default raw words (K5a)": dataclasses.replace(cfg, rng_batch=False),
            "W1 (K1w)": SimConfig(network=default_network(hashrates=h32))}


def _lib(cfg: SimConfig) -> tuple[str, int, int]:
    m = cfg.network.n_miners
    return ("event_loop_fast" + ("_wide" if m > build.NARROW_MAX_MINERS else "")
            + ("_raw" if not cfg.rng_batch else "") + ("_flight" if cfg.flight_capacity else ""),
            m, cfg.resolved_group_slots)


if __name__ == "__main__":
    run("fast_variants", SOURCE, VARIANTS, _cases(), _lib)
