#!/usr/bin/env python3
"""Time variants of the wide exact kernel (K2w, tpusim_torch/csrc/
event_loop_exact.cu) on one NVIDIA card, in turns.

Each variant is an edit of the kernel's source, built and timed on one busy
chunk of each case by the harness in scripts/kernel_variants.py; a time
includes the two permutes of cp. A variant that must compute the same
function is held against the checkout's kernel.

    python3 scripts/k2w_variants.py

Variants: the checkout; the warps a run fixed at 1, 2, 4 and 8 (the
checkout derives them from the runs an SM's shared memory holds); and, not
the same function, the kernel without the cp row copies of an adopting
event, and without those and the own_cp update. Cases: hetero32 (path W2)
with int16 and with int32 counts, a 20-miner roster with a 40 % selfish
miner, and 40 honest miners with int32 counts (cp in device memory).
"""

from __future__ import annotations

import dataclasses

from kernel_variants import ROOT, run, sub
from tpusim_torch import sweep
from tpusim_torch.config import MinerConfig, NetworkConfig, SimConfig

SOURCE = ROOT / "tpusim_torch" / "csrc" / "event_loop_exact.cu"
WARPS = "static constexpr int kRunWarps = clamp_int(16 / kRunsPerSm, 1, 4);"
COPY = ("      // cp: the pairs (i, j) with an adopter, each a row of kW words, spread",
        "      // Adoption of the rest of the state.\n")
OWN_CP = "for (int j = 0; j < M; ++j) {\n            const bool aj = miner_bit(amask, j);"


def _cut(text: str, start: str, end: str) -> str:
    i = text.index(start)
    return text[:i] + text[text.index(end, i):]


#: name -> (edit of the source, whether it computes the same function).
VARIANTS = {
    "checkout": (lambda s: s, True),
    **{f"{n} warps": ((lambda s, n=n: sub(s, WARPS, f"static constexpr int kRunWarps = {n};")),
                      True) for n in (1, 2, 4, 8)},
    "no row copies": (lambda s: _cut(s, *COPY), False),
    "no row copies, no own_cp": (
        lambda s: sub(_cut(s, *COPY), OWN_CP, OWN_CP.replace("j < M", "j < 0")), False),
}


def _roster(hashrates, delays, selfish=()) -> NetworkConfig:
    return NetworkConfig(miners=tuple(
        MinerConfig(hashrate_pct=h, propagation_ms=d, selfish=i in selfish)
        for i, (h, d) in enumerate(zip(hashrates, delays))))


def _cases() -> dict[str, SimConfig]:
    h32 = sweep.baseline_sweeps()["hetero32"]()[0][1]
    s20 = _roster((40,) + (4,) * 3 + (3,) * 16, [1000] * 20, selfish=(0,))
    h40 = _roster((3,) * 20 + (2,) * 20, [int(100 * 600 ** (i / 39)) for i in range(40)])
    return {"hetero32 int16": h32,
            "hetero32 int32": dataclasses.replace(h32, state_dtype="int32"),
            "selfish20 int16": SimConfig(network=s20),
            "honest40 int32": SimConfig(network=h40, state_dtype="int32")}


if __name__ == "__main__":
    run("k2w_variants", SOURCE, VARIANTS, _cases(),
        lambda cfg: ("event_loop_exact_wide", cfg.network.n_miners, 2))
