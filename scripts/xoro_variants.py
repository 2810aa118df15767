#!/usr/bin/env python3
"""Time source variants of the xoroshiro path's kernels on one NVIDIA card,
in turns: the row sampler X1 (tpusim_torch/csrc/xoroshiro.cu) and the fast
consumed-row event loop X2 (tpusim_torch/csrc/event_loop.cu, built with
TPUSIM_CONSUMED_ROWS).

    python3 scripts/xoro_variants.py [--parent DIR]

X1: each variant is an edit of xoroshiro.cu, built and timed by the harness
in scripts/kernel_variants.py (into the git-ignored
smoke_out/xoro_variants/) and launched through ``xoroshiro.xoro_rows`` with
its library swapped in, on the main path's chunk: the xoroshiro selfish
roster, 8,192 runs x 1,856 steps, from chunk 0's streams and consumed
counts. Its time is the mean of five launches, the better of two turns;
every variant is held against the checkout's rows and streams bit for bit,
and its registers and spill stores are printed.
Variants: the checkout (32 runs a block, 2 generator warps and 16 mapping
warps, tiles of 64 steps in a ring of 2); 8 mapping warps; 12 with tiles of
48 steps; tiles of 32 steps; a ring of 3; the winner by binary search over
the sorted thresholds in place of a scan of all M - 1.

X2: the harness in scripts/kernel_variants.py on one busy chunk of each
case: the default roster, the same with a 1,024-row ring and path W1's 32
miners, each with threefry rows (K1, K3f, K1w: every variant edits only
the consumed-row form, so these are the same kernels under each and give
the yardsticks in the same call) and with xoroshiro (X2 fast, narrow, with
the ring and wide). Variants: the checkout
(a find moves a row pointer a row pair and loads the next row); every
step loading the row of the finds so far, with no predicate on the load.

With ``--parent DIR`` (a ``git archive`` of an earlier commit unpacked in
DIR), that commit's xoroshiro.cu and event_loop.cu join both tables as the
variant "parent". The numbers also go to smoke_out/xoro_variants.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from kernel_variants import ROOT, build_variants, card, in_turns, run, sub

import torch  # noqa: E402

from tpusim_torch import xoroshiro  # noqa: E402
from tpusim_torch.config import SimConfig, default_network, reference_selfish_network  # noqa: E402
from tpusim_torch.csrc import build  # noqa: E402
from tpusim_torch.engine import Engine  # noqa: E402

X1_SOURCE = ROOT / "tpusim_torch" / "csrc" / "xoroshiro.cu"
X2_SOURCE = ROOT / "tpusim_torch" / "csrc" / "event_loop.cu"
WIN = """          int win = n_miners - 1;
          for (int m = n_miners - 2; m >= 0; --m) {
            if (t[m * cols] > win_word) win = m;
          }
"""
#: The winner by binary search over the sorted cumulative thresholds: the
#: first strictly above the word, as the scan finds it.
WIN_BISECT = """          int win = 0;
          for (int len = n_miners - 1; len > 0;) {
            const int half = len >> 1;
            const bool above = t[(win + half) * cols] > win_word;
            win = above ? win : win + half + 1;
            len = above ? half : len - half - 1;
          }
"""
LOAD = """      if (live && active && t == nbt && ++used < steps) {
        next_row += 2 * R;
        row0 = next_row[0];
        row1 = next_row[R];
      }
"""
#: Every step loads the row of the run's finds so far (the last once all are
#: consumed): no predicate on the load that differs between a warp's runs.
LOAD_EVERY_STEP = """      used += live && active && t == nbt;
      if (live) {
        const long at = 2L * min(used, steps - 1) * R + r;
        row0 = rows[at];
        row1 = rows[at + R];
      }
"""

#: name -> edit of xoroshiro.cu; each computes the checkout's function.
X1_VARIANTS = {
    "checkout": lambda s: s,
    "8 mapping warps": lambda s: sub(s, "kMapWarps = 16;", "kMapWarps = 8;"),
    "12 mapping warps, tile 48": lambda s: sub(sub(s, "kMapWarps = 16;", "kMapWarps = 12;"),
                                               "kTile = 64,", "kTile = 48,"),
    "tile 32": lambda s: sub(s, "kTile = 64,", "kTile = 32,"),
    "ring 3": lambda s: sub(s, "kRing = 2;", "kRing = 3;"),
    "thresholds bisected": lambda s: sub(s, WIN, WIN_BISECT),
}
#: name -> (edit of event_loop.cu, whether it computes the same function).
X2_VARIANTS = {
    "checkout": (lambda s: s, True),
    "row every step": (lambda s: sub(s, LOAD, LOAD_EVERY_STEP), True),
}


def _x1_chunk():
    """X1's arguments on the main path's chunk after chunk 0."""
    cfg = SimConfig(network=reference_selfish_network(), rng="xoroshiro")
    eng = Engine(cfg, "cuda")
    runs = cfg.batch_size
    keys = eng.make_keys(0, runs)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    aux = eng._chunk(*eng._init(keys), cap, keys, 0)[1]
    return aux[3], aux[4], eng.xoro_sampler(), eng.chunk_steps


def time_x1(variants: dict, card: str) -> dict[str, dict]:
    """Build, check and time every X1 variant through the harness in
    kernel_variants.py; print and return each one's ms and registers."""
    lib = (build.XORO, 0, 0)
    built = build_variants("xoro_variants", X1_SOURCE, variants, [lib], build.bind_xoro)
    args = _x1_chunk()
    ms = in_turns("xoro_variants", "X1", {name: built[name, lib][0] for name in variants},
                  "load_xoro", lambda: xoroshiro.xoro_rows(*args),
                  xoroshiro.xoro_rows(*args), set(variants), reps=5)
    out = {name: dict(ms=ms[name], registers=built[name, lib][1],
                      spill_stores=built[name, lib][2]) for name in variants}
    print("[X1] ms a main-path chunk (8,192 runs x 1,856 steps), the better of two turns: "
          + ", ".join(f"{name} {v['ms']:.4f} ({v['registers']} registers, "
                      f"{v['spill_stores']} B spilled)" for name, v in out.items())
          + f"; on {card}", flush=True)
    return out


def _x2_lib(cfg: SimConfig) -> tuple[str, int, int]:
    """The fast event-loop library a case runs: K1, K3f, K1w or X2's forms."""
    m = cfg.network.n_miners
    return ("event_loop_fast" + ("_wide" if m > build.NARROW_MAX_MINERS else "")
            + ("_consumed" if cfg.rng == "xoroshiro" else "")
            + ("_flight" if cfg.flight_capacity else ""), m, 2)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="an earlier commit's tree, unpacked")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("xoro_variants: needs a CUDA device")
    name = card()
    x1, x2 = dict(X1_VARIANTS), dict(X2_VARIANTS)
    if args.parent:
        csrc = args.parent / "tpusim_torch" / "csrc"
        x1["parent"] = lambda s, text=(csrc / X1_SOURCE.name).read_text(): text
        x2["parent"] = (lambda s, text=(csrc / X2_SOURCE.name).read_text(): text, True)
    result = {"card": name, "x1": time_x1(x1, name)}
    cfg = SimConfig(network=default_network())
    h32 = (14, 11, 9, 8, 6, 5, 4, 3) + (2,) * 16 + (1,) * 8
    cases = {}
    for label, base in (("default", cfg),
                        ("flight default", dataclasses.replace(cfg, flight_capacity=1024)),
                        ("W1", SimConfig(network=default_network(hashrates=h32)))):
        xoro = dataclasses.replace(base, rng="xoroshiro")
        cases[f"{label} ({_x2_lib(base)[0]})"] = base
        cases[f"xoroshiro {label} ({_x2_lib(xoro)[0]})"] = xoro
    result["x2"] = run("xoro_variants_x2", X2_SOURCE, x2, cases, _x2_lib)
    (ROOT / "smoke_out" / "xoro_variants.json").write_text(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
