#!/usr/bin/env python3
"""Time variants of the fast event-loop kernel (tpusim_torch/csrc/
event_loop.cu) on one NVIDIA card, in turns.

Each variant is an edit of the kernel's source, built and timed on one busy
chunk of each case by the harness in scripts/kernel_variants.py. Every
variant computes the same function and is held against the checkout's
kernel.

    python3 scripts/fast_variants.py
    python3 scripts/fast_variants.py --case X2r --variant "x2r per-find map"
    python3 scripts/fast_variants.py --case "(K1s)" --case "(K4fs)" --replay

``--case`` (any number of times) keeps the cases whose label holds one of
the texts, ``--variant`` (any number of times) the variants named beside
the checkout. A variant runs on the cases of its kind: the honest ones
(K1's libraries) or the selfish ones (TPUSIM_FAST_SELFISH). ``--replay``
times nothing: it replays each selfish case's busy chunk one step per
launch with the checkout's kernel and prints what chip_smoke.py's
main-path chunk counts of it (``fast_selfish_step``): the selfish finds,
races and reveal pushes, and the warp-steps in which a run of the warp
reveals or holds its private chain.

Variants: the checkout (up to 16 miners 16 lanes a run, lane m miner m,
the warp's two runs stepping together with full-mask collectives,
RunPair; a warp a run in the flight variants); 16 lanes a run in the
flight variants too; 16 lanes with each collective over its own run's
lanes (RunGroup); 8 lanes a run (lane l miners l and l + 8, P = 2, four
runs a warp, group masks); a warp a run (RunWarp, P = 1, lanes 9-31 idle
at M = 9); the adoption's table writes as a loop over the adopters' ballot
bits in place of an unrolled pass over the lane's row; the raw-word
mapping done by lane 0 and handed to the other lanes; and the per-event
xoroshiro draw (X2r) as its first design ran it, every lane advancing its
own copy of both streams on each find and mapping the words as they come,
in place of the checkout's draw-ahead tile (xoro_tile.cuh), without and
with the checkout's bound of 64 registers a thread; the tile without that
bound; the tile's draw loop rolled. The selfish form's (K1s, K3fs, K4fs):
its first design (the reveal's count and push in every lane on every step,
where the checkout runs them under the adoption's vote); the reveal under
a vote of its own; the find's push count as one chain of selects; the
find's selfish test and push under a vote of the warp's finds; the lane
and adoption variants above apply to it too.
Cases:
the default 9-miner roster (K1) with int16 and int32 counts, with a
1,024-row ring (K3f), at 4 group slots (K5c), with raw words (K5a) and with
the per-event xoroshiro draw (X2r); the propagation sweep's fast pack (100
ms and 1 s, K4f); path W1's 32 miners (K1w); the reference's selfish roster
at ``--mode fast`` with int16 counts (K1s) and with a 1,024-row ring
(K3fs); the selfish-hashrate sweep's
37-46 % points at ``--mode fast``, packed (K4fs), as chip_smoke.py's phase
15 runs them.
scripts/exact_variants.py times X2r's first design in the exact kernel.
"""

from __future__ import annotations

import dataclasses

import torch
from kernel_variants import (ROOT, X2R_PER_FIND, X2R_TILE_VARIANTS, _busy_chunk, _outputs, run,
                             sub)

from tpusim_torch import event_loop, sweep
from tpusim_torch.config import SimConfig, default_network, reference_selfish_network
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

INCLUDE = '#include "event_loop_common.cuh"\n'
X2R_TILE = ("""    XoroTile<kLanes> xt;
    if (live) xt.load(xo.streams_in + 8 * r, g.lane, xo.mean[PACKED ? r : 0]);
""", """      if (g.any(found_due)) {
        const bool refill = found_due && xt.used == kLanes;
        if (g.any(refill)) xt.refill<M>(g.g, g.lane, refill, thr);
        xt.take(g.g, found_due, wq, dt);
      }
""", """    if (live) xt.store(xo.streams_out + 8 * r, g.lane);
""")
#: X2r's first design: every lane advances its own copy of both streams
#: on a find, the winner is the group's sum of each lane's compares, and
#: every finding lane maps the interval.
X2R_PER_FIND_BODY = ("""    XoroRun xr;
    if (live) xr.load(xo, r, PACKED);
""", """      if (g.any(found_due)) {
        unsigned long long ww = 0ull, iw = 0ull;
        if (found_due) {
          ww = xr.xw.next();
          iw = xr.xi.next();
        }
        int hit[P];
#pragma unroll
        for (int k = 0; k < P; ++k) hit[k] = own[k] && thr[k] <= ww;
        wq = min(g.add_of(hit), M - 1);
        if (found_due) dt = interval_ms(iw, xr.mean_ns);
      }
""", """    if (live && g.lane == 0) xr.store(xo, r);
""")


#: The selfish form's find, reveal test and reveal (TPUSIM_FAST_SELFISH): the
#: checkout's, under the adoption's vote, and the first design's, predicated
#: in every lane on every step.
FIND = """        int count;
        const bool pushes = selfish_find(ow, sel[k], npriv[k], bhp, height[k], count);
        ovf += push2(a0[k], a1[k], c0[k], c1[k], t + prop[k], count, pushes);
"""
FIND_FIRST = """        const bool race = ow && sel[k] && npriv[k] == 1 && bhp == height[k];
        const bool append = ow && sel[k] && !race;
        npriv[k] += append ? 1 : (race ? -1 : 0);
        ovf += push2(a0[k], a1[k], c0[k], c1[k], t + prop[k], race ? 2 : 1, ow && !append);
"""
REVEAL_TEST = """      int lead[P];
      bool reveal[P];
      bool reveals = false;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        lead[k] = height[k] - best_h;
        reveal[k] = selfish_reveals(notify, sel[k], lead[k], npriv[k]);
        reveals |= reveal[k];
      }
"""
REVEAL_PUSH = """#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int n = selfish_reveal(reveal[k], lead[k], npriv[k]);
          ovf += push2(a0[k], a1[k], c0[k], c1[k], t + prop[k], n, reveal[k]);
        }
"""
ADOPT_VOTE = "      if (g.any(any != 0)) {\n"
ADOPT_VOTE_REVEAL = ("      if (__any_sync(kFullMask, any != 0 || reveals)) {\n" + REVEAL_PUSH
                     + "#else\n" + ADOPT_VOTE + "#endif\n")
REVEAL_FIRST = """#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int lead = height[k] - best_h;
        const bool reveal = own[k] && notify && sel[k] && lead >= 0 && npriv[k] > lead;
        const int n = (npriv[k] > 1 && lead == 1) ? npriv[k] : npriv[k] - lead;
        ovf += push2(a0[k], a1[k], c0[k], c1[k], t + prop[k], n, reveal);
        if (reveal) npriv[k] -= n;
      }
"""


def _adoption_vote(s: str) -> str:
    """The source with the adoption's vote K1's, for the selfish form too."""
    start = s.index(ADOPT_VOTE_REVEAL)
    start = s.rindex("#if TPUSIM_FAST_SELFISH\n", 0, start)
    return s[:start] + ADOPT_VOTE + s[s.index(ADOPT_VOTE_REVEAL) + len(ADOPT_VOTE_REVEAL):]


def _first(s: str) -> str:
    return _adoption_vote(sub(sub(s, FIND, FIND_FIRST), REVEAL_TEST, REVEAL_FIRST))


def _own_vote(s: str) -> str:
    return _adoption_vote(sub(s, REVEAL_TEST, REVEAL_TEST + "      if (__any_sync(kFullMask, "
                              "reveals)) {\n" + REVEAL_PUSH + "      }\n"))


#: The find's push count as one chain of selects (0, 1 or 2 blocks).
FIND_SELECTS = """        const bool race = npriv[k] == 1 && bhp == height[k];
        if (ow && sel[k]) npriv[k] += race ? -1 : 1;
        const int pushed = ow ? (sel[k] ? (race ? 2 : 0) : 1) : 0;
        ovf += push2(a0[k], a1[k], c0[k], c1[k], t + prop[k], pushed, pushed > 0);
"""
#: The find's selfish test and push only on the warp-steps in which a run
#: of the warp finds.
FIND_VOTED = ("        if (__any_sync(kFullMask, won)) {\n"
              + FIND.replace("        ", "          ") + "        }\n")


_UNBOUNDED = X2R_TILE_VARIANTS["x2r tile unbounded"]["event_loop.cu"]


def _x2r_per_find(s: str) -> str:
    s = sub(s, INCLUDE, INCLUDE + X2R_PER_FIND)
    for new, old in zip(X2R_TILE, X2R_PER_FIND_BODY):
        s = sub(s, new, old)
    return s


BOTH, HONEST, SELFISH = {"honest", "selfish"}, {"honest"}, {"selfish"}
#: name -> (edit of the source, the kinds of case it runs on); every variant
#: computes the checkout's function.
VARIANTS = {
    "checkout": (lambda s: s, BOTH),
    "16 lanes with the ring too": (lambda s: sub(s, LANES, _lanes("kGroupLanes", "RunPair")),
                                   HONEST),
    "16 lanes, group masks": (lambda s: sub(s, LANES, _lanes("kGroupLanes", "RunGroup")), BOTH),
    "8 lanes": (lambda s: sub(sub(s, LANES, _lanes("8", "RunOctet")), BLOCK, BLOCK + OCTET),
                BOTH),
    "32 lanes": (lambda s: sub(s, LANES, _lanes("kWarpLanes", "RunWarp")), BOTH),
    "adopters' bits": (lambda s: sub(s, ADOPT, ADOPT_BITS), BOTH),
    "raw in lane 0": (lambda s: sub(s, RAW, RAW_LANE0), HONEST),
    "x2r per-find map": (lambda s: _UNBOUNDED(_x2r_per_find(s)), HONEST),
    "x2r per-find map at 8 blocks an SM": (_x2r_per_find, HONEST),
    **{name: (edit, HONEST) for name, edit in X2R_TILE_VARIANTS.items()},
    "fast selfish, reveal every step": (_first, SELFISH),
    "fast selfish, the reveal under a vote of its own": (_own_vote, SELFISH),
    "fast selfish, the find's count selected": (lambda s: sub(s, FIND, FIND_SELECTS), SELFISH),
    "fast selfish, the find under a warp vote": (lambda s: sub(s, FIND, FIND_VOTED), SELFISH),
}


def _cases() -> dict[str, SimConfig | tuple[SimConfig, ...]]:
    cfg = SimConfig(network=default_network())
    h32 = (14, 11, 9, 8, 6, 5, 4, 3) + (2,) * 16 + (1,) * 8
    grids = sweep.baseline_sweeps()
    return {"default int16 (K1)": cfg,
            "default int32 (K1)": dataclasses.replace(cfg, state_dtype="int32"),
            "flight default (K3f)": dataclasses.replace(cfg, flight_capacity=1024),
            "default K = 4 (K5c)": dataclasses.replace(cfg, group_slots=4),
            "default raw words (K5a)": dataclasses.replace(cfg, rng_batch=False),
            "default per-event xoroshiro (X2r)": dataclasses.replace(
                cfg, rng="xoroshiro", rng_batch=False),
            "propagation fast pack (K4f)": tuple(c for _, c in grids["propagation"]()[:2]),
            "W1 (K1w)": SimConfig(network=default_network(hashrates=h32)),
            "selfish int16 (K1s)": SimConfig(network=reference_selfish_network(), mode="fast",
                                             state_dtype="int16"),
            "flight selfish (K3fs)": SimConfig(network=reference_selfish_network(), mode="fast",
                                               flight_capacity=1024),
            "selfish-hashrate 37-46 % packed (K4fs)": tuple(
                dataclasses.replace(c, mode="fast") for _, c in grids["selfish-hashrate"]()[4:8])}


def _kind(cfg: SimConfig | tuple[SimConfig, ...]) -> str:
    first = cfg if isinstance(cfg, SimConfig) else cfg[0]
    return "selfish" if first.network.any_selfish else "honest"


def _lib(cfg: SimConfig | tuple[SimConfig, ...]) -> tuple[str, int, int]:
    packed = not isinstance(cfg, SimConfig)
    cfg = cfg[0] if packed else cfg
    m = cfg.network.n_miners
    return ("event_loop_fast" + ("_wide" if m > build.NARROW_MAX_MINERS else "")
            + ("" if cfg.rng_batch else "_xoro" if cfg.rng == "xoroshiro" else "_raw")
            + ("_selfish" if cfg.network.any_selfish else "")
            + ("_packed" if packed else "") + ("_flight" if cfg.flight_capacity else ""),
            m, cfg.resolved_group_slots)


def replay(label: str, cfg: SimConfig | tuple[SimConfig, ...]) -> dict[str, int]:
    """The busy chunk of a selfish case replayed one step per launch with
    the checkout's kernel, equal at its end to the chunk in one launch:
    chip_smoke.fast_selfish_step's counts summed over its steps, printed."""
    import chip_smoke

    args, kw = _busy_chunk(cfg)
    rows, cap, prop, leaves, counters, selfish, fl = args
    m, runs = leaves[2].shape
    sel = (selfish.bool() if torch.is_tensor(selfish) else torch.tensor(
        [bool(x) for x in selfish], device="cuda")[:, None].expand(m, runs))
    midx = torch.arange(m, device="cuda")[:, None]
    h_i, np_i, bhp_i = (event_loop.FAST_SELFISH_LEAVES.index(n)
                        for n in ("height", "npriv", "bhp"))
    want = _outputs(event_loop.event_loop_chunk(*args, **kw))
    out, total = (leaves, counters, fl), {}
    for s in range(rows.shape[0]):
        lv = out[0]
        active = lv[0][0] < cap
        ow = (midx == rows[s, 0][None]) & active & (lv[0][0] == lv[1][0])
        out = event_loop.event_loop_chunk(rows[s:s + 1], cap, prop, *out[:2], selfish, out[2],
                                          **kw)[:3]
        adopted = (out[0][h_i].long() - lv[h_i].long() - ow.long()) > 0
        step = chip_smoke.fast_selfish_step(torch, sel, ow, adopted, active, lv[np_i],
                                            out[0][np_i], lv[bhp_i], lv[h_i])
        total = {k: total.get(k, 0) + v for k, v in step.items()}
    if not all(torch.equal(x, y) for x, y in zip(_outputs(out), want)):
        raise SystemExit(f"fast_variants: {label}'s replay differs from its chunk")
    total = {k: int(v) for k, v in total.items()}
    print(f"[replay] {label}: {rows.shape[0]} steps of {runs} runs, " + ", ".join(
        f"{k} {v}" for k, v in total.items()) + "; reveal warp-steps "
        f"{total['reveal_warp_steps'] / total['warp_steps']:.2%}, private warp-steps "
        f"{total['private_warp_steps'] / total['warp_steps']:.2%}", flush=True)
    return total


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Time source variants of the fast kernel.")
    ap.add_argument("--case", action="append", default=[],
                    help="keep the cases whose label holds this text (default: every case)")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                    help="keep this variant beside the checkout (default: every variant)")
    ap.add_argument("--replay", action="store_true",
                    help="only count each selfish case's busy chunk, step by step")
    args = ap.parse_args()
    cases = {k: v for k, v in _cases().items()
             if not args.case or any(text in k for text in args.case)}
    if args.replay:
        for label, cfg in cases.items():
            if _kind(cfg) == "selfish":
                replay(label, cfg)
        raise SystemExit(0)
    for kind in ("honest", "selfish"):
        of_kind = {k: v for k, v in cases.items() if _kind(v) == kind}
        variants = {k: (edit, True) for k, (edit, kinds) in VARIANTS.items() if kind in kinds
                    and (not args.variant or k == "checkout" or k in args.variant)}
        if of_kind:
            run("fast_variants", SOURCE, variants, of_kind, _lib)
