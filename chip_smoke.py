#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpusim_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

On a host with more than one card, ``python3 chip_smoke.py cards`` runs
the device phase and then K6 across the cards alone (``cards_main``):
the kernels of the two 9-miner years built, each year unsharded on card 0
and as one shard a card over 2, 4 and all cards, equal key for key, with
run-years/s by card count (``smoke_out/chip_smoke_cards.json``).

Phases, each of which raises on failure (exit code 1, and no result line):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA kernel of the port from the sources in this checkout,
   K1, K2, their flight-recorder variants K3f and K3x, their packed-grid
   variants K4f and K4x and the packed grid with the recorder (K4 x K3), at
   two group slots, and the generic group slots (K5c) at K = 3 and 4, for
   the miner counts this script runs (9 and 4), and the wide variants (K1w,
   K2w) for the 17- to 40-miner rosters, the raw-word (K5a) and one-hot
   (K5b) variants and both (at M = 9 plain, with the ring and packed, exact
   at K = 4, packed at M = 4, wide at 32 miners) and the layout
   micro-benchmarks (S1), and the xoroshiro path's row sampler (X1) and
   consumed-row event loops (X2: fast and exact, each with the ring, and
   exact packed with the ring, at M = 9), and the fast kernel's selfish
   form (K1s, with the ring K3fs, packed K4fs, and both, at M = 9 and 4),
   one ``nvcc`` per library, all
   started together, each library's registers and spills printed, and
   X1's launch shape, shared memory a block and the instructions its loops
   issue (``smoke_out/xoroshiro.sass``, against ``XORO_PIPES``);
3. sampler: threefry words, winner indices and the interval mapping on the
   card bit-equal to the CPU's (the mapping over all 2^24 uniforms at the
   600 s and 60 s means);
4. kernels against their plain PyTorch versions on the card, for the
   fast-mode kernel K1 and the exact-mode kernel K2 each: one chunk at 1000
   runs x 192 steps (``CMP_STEPS``) with ragged chunk ends in several state
   and roster variants, a 256-run x 2-day batch key for key, and one chunk
   at the main path's shape (8192 runs x 1856 steps; for K2 on the selfish
   and on an honest roster), its plain version on the chunk's first 1,024
   runs (``PLAIN_RUNS``, as for every main-path chunk below; the kernel on
   those runs is also held against its own full-width result), timed, its
   bound counted by replaying it one step per launch;
   then a small batch on the card against the same batch on the CPU, key
   for key, per mode; then the same for the flight-recorder kernels K3f and
   K3x (every state leaf, counter and ring leaf, max |err| 0): one chunk at
   1000 runs in each variant at ring capacities 64 (the ring wraps within
   the chunk) and 2048, from a mid-run state, a 256-run x 2-day batch, the
   main path's chunk with a 1024-row ring (201 MB), timed, its bound
   counted with the ring's bytes and its rows, and a 64-run x 2-day batch
   on the card against the CPU whose JSONL event logs are byte-identical;
   then the same for the packed-grid kernels K4f and K4x (with and without
   SELFISH), with per-run delays from 100 ms to 60 s and per-run selfish
   flags (some lanes wholly honest): one chunk at 1000 runs in each pack
   variant, a 4-point x 64-run x 2-day packed dispatch, the main path's
   chunks (the selfish-hashrate sweep's first dispatch, K4x, and the
   propagation sweep's fast pack, K4f, each 8192 runs), timed and counted,
   and a 3-point x 64-run x 2-day packed grid on the card against the CPU;
   then K5c at K = 3 and 4 in fast and exact mode (honest and selfish),
   int16 and int32, on a crowded 4-miner roster (the buffer fills and, at
   K = 3, overflows) and the 9-miner rosters, and at K = 4 with the ring,
   packed and packed with the ring: one chunk at 1000 runs each, the main
   path's chunks at K = 4 in each mode, timed and counted, and a 64-run
   K = 4 batch on the card against the CPU; then K4 x K3, fast and exact
   with and without SELFISH, rings of 64 and 2048: one chunk at 1000 runs
   each, the main path's chunks (the selfish-hashrate dispatch and the
   propagation sweep's fast pack, each with a 1024-row ring), timed and
   counted, and a 3-point x 64-run x 2-day packed flight grid on the card
   against the CPU, every point's event log included; then the wide
   variants K1w (17, 24 and 32 miners) and K2w (hetero32, 20 miners with a
   40 % selfish miner, 33 miners with a selfish one in the second slot of
   lane 0, 40 honest miners: no miner set in a 32-bit mask, and with int32
   counts the form that keeps cp in device memory), int16 and int32, with
   the ring, packed (four 32-miner lane groups) and at K = 4: one chunk at
   1000 runs each, the main path's chunks (path W1's roster, K1w;
   hetero32, K2w), timed and counted, and a 2-day batch of each roster (64
   runs; hetero32 16) on the card against the CPU; then the raw-word (K5a) and one-hot (K5b)
   variants: the raw-word mapping alone over all 2^24 uniforms at four
   means, and the thresholds' edge words, against ``sampling``'s; the main
   path's chunk for each knob in each mode (default roster fast, selfish
   roster exact), timed and counted (the bound adds the mapping's
   operations per find, or the contraction's cp loads); one chunk at 1000
   runs of each knob and of both together, with the ring, packed (per-run
   thresholds and means), at K = 4 and wide at 32 miners;
5. main paths, each through ``tpusim_torch.api.run_simulation`` at full
   width (9 miners, one year, 32,768 runs in batches of 8,192) with the
   launch counts set to 0 just before and read just after: the reference
   selfish roster (40 % selfish miner 0, 1 s propagation, exact mode, K2),
   the honest roster at 10 s propagation (exact mode, K2 without the
   selfish branches), the default honest roster (1 s, fast mode, K1), then
   the flight path, the selfish and the default roster with a 1024-row ring
   (K3x, K3f), whose statistics must equal the same rosters' without it;
   path A, the selfish and the default roster at K = 4 group slots (K5c),
   whose statistics must equal the K = 2 runs' when neither overflows.
   Each run's kernel must have launched once per chunk and no other kernel;
   the results are checked against the reference's README figures and for
   sanity (these phases keep to one card: ``use_all_devices=False``). Then
   K6, run-axis sharding: the selfish (K2s) and default (K1) rosters,
   32,768 runs x one year, as one ``Engine(cfg, devices=[cuda:0] * 4)``
   batch (8,192 runs a shard on this card) against the unsharded
   ``run_batch`` of the same keys, key for key, its integer telemetry
   equal to the main path's four batches' sums, one kernel launch a shard
   chunk, one shard call timed and shard 0 held against its plain version;
   the flight ring (K3x) at 8,192 runs x 30 days as 4 shards; the runner
   with a remainder (8,195 runs: one sharded batch and 3 runs unsharded)
   against the unsharded runner; and on a host with more than one card
   the same years over every card against one card's, with run-years/s
   per card count (on one card a line says that part did not run). Then
   the flight paths, and last the trace entry point
   (``tpusim_torch.flight_export.main``) on the selfish roster, 1024 runs
   x 2 days: no ring overflowed, the stale rows and their depths tie out
   with the counters of a run without the recorder, and the Perfetto JSON
   passes the schema check;
6. packed sweeps, through ``tpusim_torch.sweep.run_sweep`` at one simulated
   year a run and 2,048 runs a point (``runs_scale = 2**-9``), the launch
   counts set to 0 just before each and read just after: selfish-hashrate
   (9 points) sequentially (K2 only) and packed (K4x only, three
   dispatches), whose rows must be equal, the 40 % point's selfish share
   within 1 % of the README's 46.68 %; then propagation packed (two packs:
   K4f for 100 ms and 1 s, K4x without SELFISH for 10 s and 60 s), the 10 s
   point's stale rates within 4x the main path's tolerances of the README's.
   Every batch's busy chunks are logged: each kernel launched once a chunk;
7. path B, the packed flight grid: the first three selfish-hashrate points
   at 2,048 runs, 30 days and a 1024-row ring through ``packed.run_grid``,
   one dispatch of K4 x K3 launched once a chunk and nothing else, each
   point's event log equal to its own sequential trace's;
8. wide paths: path W1, hetero32's 32 hashrates at 1 s (fast mode, K1w),
   8,192 runs x one year through ``api.run_simulation``; path W2, the
   hetero32 grid (32 miners, 100 ms to 60 s, exact mode) at 8,192 runs x
   its full year, through ``sweep.run_sweep`` sequentially (K2w only)
   and packed (K2w packed only), whose rows must be equal, miner 31's
   stale rate above miner 0's; then the trace entry point on hetero32,
   1024 runs x 2 days (K2w with the ring);
9. the legacy knobs' paths: the selfish and the default roster at 8,192
   runs x one year through ``python -m tpusim_torch --config``
   (``cli.main``) with ``rng_batch`` off (K5a), ``consensus_gather`` off
   (K5b) and both off with un-rebased int32 counts (the reference's LEGACY
   configuration), each launching its variant once a chunk and nothing
   else, each output JSON equal to the knobs-on run's; a packed
   propagation grid of three points with ``rng_batch`` off (the packed
   raw-word variants), rows equal to the knobs-on rows; and the trace
   command on the selfish roster with both knobs off, its JSONL
   byte-identical to the knobs-on trace's;
10. the layout micro-benchmarks (S1) through ``python -m tpusim_torch.micro``
   (``micro.main``) at R = 8,192 lanes and N = 512 iterations, then each
   op's kernel against its plain version, sel_flat, sel3 and contract
   scaling with N (not floor-limited), each op's share of its bound
   printed (``MICRO_PIPES``; phase 2 prints each S1 kernel's registers and
   the instructions its loop issues, from ``smoke_out/micro.sass``);
11. the xoroshiro path (``rng="xoroshiro"``) and the native oracle: X1
   against its plain version on a main-path chunk (8,192 runs x 1,856
   steps, from chunk 0's streams and consumed counts), every row and
   stream word, timed beside the thread-a-run kernel's time it replaced,
   its bound counted by pipe (``xoro_pipes``); its interval
   mapping alone over 2^24 words at the 600 s, 60 s and 1 s means against
   the CPU's, and the card's own float64 ``log1p`` against glibc's (what
   the transcription buys), and the transcription against this machine's
   C library; X2 against its plain version in each form the paths run
   (fast, exact selfish and honest, with the ring, packed with the ring)
   at 1,000 runs with ragged ends, and the fast and exact main-path
   chunks on ``PLAIN_RUNS``, timed and counted as K1's and K2's, and
   printed beside K1's and K2s's times in this run; the
   selfish and default years with xoroshiro (32,768 runs) through
   ``api.run_simulation``, X1 and X2 each launched once a chunk and
   nothing else, within the main path's tolerances of the README's
   figures; then against the native oracle, built here from
   ``native/simcore.cpp`` (``tpusim_torch.native``): the sums at 256 runs
   x 30 days, selfish and default; ``trace --rng xoroshiro`` on the card
   at 64 runs x 2 days byte-identical to ``trace --backend cpp`` (``trace
   diff`` exit 0), both rosters; a 3-point packed xoroshiro grid with
   rings, each point's row and log its sequential run's and its log the
   native oracle's;
12. run-until-confident: (i) the default roster's year through ``cli.main``
   with ``--ci-target-stat blocks_share --ci-target CI_TARGET --telemetry``
   on a 32,768-run budget in batches of 8,192 (K1), which must stop on its
   target after batch 2 (``stop_reason`` ``ci_target`` in the ledger's run
   span), K1 launched once a chunk and nothing else, its sums (the
   checkpoint's npz) and output JSON key for key those of a run of as many
   runs with no target; (ii) BASELINE.json configs[4], the selfish-threshold
   grid (150, 300 and 600 s x 25-45 % selfish, 15 points), cut to 30 days
   and a budget of 4,096 runs a point, its chunk budget pinned to 1,856
   steps so the 15 points form one pack, through
   ``packed.run_grid_adaptive`` at 8,192 lanes, ``blocks_share`` to
   ``GRID_CI_TARGET``, at most 6 rounds: every point converged, the lanes
   unequal in round 2, K4x launched once a chunk of each round's one
   dispatch and nothing else, and each point's sums and moments those of
   ``packed.run_grid`` over the runs it ran, key for key. The runner
   dispatches batch b + 1 before it finalizes batch b, so (i)'s K1
   launches are the two batches' busy chunks and the chunks the third
   batch ran before the stop cancelled it (``Engine._step`` counted);
13. dispatch paths: (i) the device loop, ``run_batch(pipelined=True)``,
   ``run_batch(host_loop=True)`` and ``run_batch_async(keys)()`` key for
   key at 256 runs x 2 days (``BATCH_DAYS``) for K1, K2s, K3x with a
   64-row ring, X2 fast (and X1) and K6 as 4 shards on this card, and a
   3-point selfish-hashrate grid (K4x) through ``packed.run_grid`` with
   ``host_loop=True`` and ``pipelined=True`` against its device loop, each
   path's launches printed (the busy chunks; pipelined at most two more a
   batch, a shard); (ii) the xoroshiro default year (32,768 runs in
   batches of 8,192) in run-years/s through ``run_simulation_config`` (the
   depth-1 batch pipeline) and hand loops of ``run_batch`` on each path,
   in turns, equal results, and the pipeline's ``stall_s`` a batch; (iii)
   the device's idle share: one 8,192-run batch of the xoroshiro year and
   of the threefry default at 30 days under ``Profiler.trace``, device loop
   and pipelined, the union of the GPU kernels' intervals over the batch's
   window (a ``record_function``) from the ``torch.profiler`` trace;
14. measurement harness: (i) ``cli.main(["perf", "run"])``, the full
   protocol's six default scenarios at the reference's shapes (chained
   fast, exact and year-long fast: K1, K2s; the selfish-threshold sweep
   sequential and packed, with checkpoints and with xoroshiro: K2s, K4x,
   X1, X2 exact and packed), into ``smoke_out/perf_gpu.jsonl``, every row
   schema-valid at the full shape, its ``env`` naming this card and its
   power limit, each kernel of the path launched; (ii) ``perf compare`` of
   that ledger against itself exits 0 and against a copy with
   ``chained_exact`` slowed 2x (or twice the gate's margin, where the
   samples spread past 50 %) exits 1, and ``perf report`` renders; (iii) the
   chain of (i) at 64 runs x 2 chunks x 256 steps, fast and exact, threefry
   and xoroshiro, on the card equal to the CPU's key for key (state,
   counters, streams, checksum); (iv) ``python -m tpusim_torch.roofline``'s
   points for fast and exact at 8,192 runs and the main path's chunk budget
   with the copy probe (at most 105 % of the HBM3 peak; every point at most
   1.05 of its roof), and the count of implicit syncs the sync debug mode
   reports in a 2-chunk chain of each;
15. fast mode on a selfish roster and the dashboards: (i) the fast kernel's
   selfish form against its plain version, K1s and K3fs (ring of 64) at
   1,000 runs x 192 steps with ragged ends, K4fs and K4 x K3fs on per-run
   flags (one lane group wholly honest), a 256-run batch, card == CPU (the
   ring's too), and the main-path chunks of K1s, K3fs (1,024-row ring) and
   K4fs (four selfish-hashrate points at --mode fast, 8,192 runs), timed
   and counted (``fast_selfish_ops``: K1's operations plus the race and
   the reveal), printed beside K1's, K4f's and K3f's times in this run,
   with the warp-steps of K1s's and K4fs's chunks in which a run of the
   warp reveals or holds its private chain (``fast_selfish_step``); (ii)
   the main paths: the fast selfish year (32,768 runs)
   through ``api.run_simulation``, K1s once a chunk and nothing else,
   miner 0's share and stale rate within the exact year's tolerances of
   the README's; ``trace --mode fast`` on the selfish roster with
   ``--telemetry`` (K3fs; its ledger's trace span carries the trace's
   run_id); the selfish-hashrate grid's 37-46 % points at --mode fast,
   2,048 runs a point, sequential (K1s) and packed (K4fs), rows equal,
   each with ``--telemetry`` (a sweep_point span a point under one
   run_id); (iii) a fresh process's CLI run with ``--telemetry``, whose
   ledger holds its library's compile span; (iv) ``report`` on phase 12's
   ledger, on these ledgers and on phase 13's kept trace dir (the card's
   kernels, X1's and X2's by name, among its top ops), ``watch --once``,
   and ``trace timeline`` on the smoke's ledgers (no fleet: exit 2) and on
   the fresh run's ledger as the one worker of a fleet.

Every plain version of the event loop that the script runs on the card
replays one step's ops from a CUDA graph (``event_loop_chunk_plain`` on a
CUDA tensor): the same ops, without the host's enqueue of each.

Each phase's end is stamped (``[time]``) with the seconds its compare,
replay and time helpers took. The last two lines of standard output are
the kernels' JSON line and ``{"ok": true, "device": {...}}``. The build
log (with the compiler's register and spill report) and a JSON record of
every number printed go to ``smoke_out/`` (ignored by git).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "smoke_out"

#: Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth,
#: and the int32 rate taken as a quarter of the 67 TFLOP/s float32 rate
#: (half as many int32 lanes as float32 lanes, and no fused multiply-add):
#: the rate of one of the two pipes that take integer work, the ALU pipe
#: and the FMA pipe (IMAD, and IMAD.IADD for an add), which run side by side.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
FP32_FLOPS_PER_S = 67e12
#: The float64 rate outside the tensor cores (NVIDIA's data sheet, H100 SXM).
FP64_FLOPS_PER_S = 34e12

#: A chunk compared at this many runs (125 blocks of the narrow kernels'
#: 8 runs, 250 of the wide fast kernel's 4); tests/test_torch_cuda.py holds
#: every event-loop kernel at 1, 3, 17 and 1,000 runs, ragged blocks
#: included.
RUNS_CMP = 1000
#: hetero32's hashrates (BASELINE.json configs[3]); path W1 runs them at the
#: default 1 s propagation.
H32 = (14, 11, 9, 8, 6, 5, 4, 3) + (2,) * 16 + (1,) * 8
#: Durations of the compared chunks' configurations (1 day) and of the
#: compared K1-K3 and packed batches (2 days: one or two 640-step chunks),
#: cut from 30 days to keep the script well inside its time limit: a plain
#: version's time goes with its steps, not its runs.
CMP_DAYS, BATCH_DAYS = 1, 2
#: The compared chunks' step budget, pinned for every roster, since the
#: ones with short intervals (50 ms, 1 s, 20 s) take 4,096 steps by default
#: whatever the duration. 192 steps still wrap a 64-row ring (270-340 rows
#: a chunk), re-base the counts after chunk 0 and overflow the crowded
#: roster's 3 slots.
CMP_STEPS = 192
#: A main-path chunk's (and a K6 shard call's) plain version runs on this
#: many of its 8,192 runs: the plain versions take seconds of host-bound
#: torch ops a chunk, and the kernel on those runs is also held against its
#: own full-width result.
PLAIN_RUNS = 1024
#: Phase 12's targets, relative 95 % CI half-widths of ``blocks_share``:
#: (i) between the default year's ``rel_hw_max`` after batches 1 and 2 of
#: 8,192 runs (9.36e-4 and 6.65e-4 on an H100), so the run stops after
#: batch 2; (ii) above the widest point's at its 4,096-run budget (the
#: 600 s, 45 % selfish point: 4.42e-3), so every point converges, and
#: under the 600 s points' after round 1's 546 runs, so round 2 splits the
#: lanes unequally. The runs are seeded, so each is a constant.
CI_TARGET = 7.5e-4
GRID_CI_TARGET = 5.0e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def fast_kernel_ops(m: int, active: int, finds: int, k: int = 2) -> int:
    """int32 operations the event loops need outside the adoption, for
    ``active`` events of which ``finds`` are block finds, at ``k`` group
    slots, counted from csrc/event_loop.cu: on every active event 9 k + 11
    per miner (6 k + 1 for the flush, the shift of the slots and the
    published height, 7 for the best chain, 3 for the adoption test, 3 k for
    the cut-through: 29 at k = 2) and 20 per event (gates, clock, counters);
    on every find, 5 k + 20 more for the winner's own count and arrival group
    (30 at k = 2). The fast kernels add :func:`fast_adoption_ops`, the exact
    ones their own adoption (:func:`exact_kernel_ops`)."""
    return active * ((9 * k + 11) * m + 20) + finds * (5 * k + 20)


def fast_adoption_ops(m: int, adopts: int, adopts_sq: int, k: int = 2) -> int:
    """int32 operations of the fast-mode adoption, counted from
    csrc/event_loop.cu: 3 M + 2 k + 5 for each (miner, event) pair in which
    the miner adopts (its own_cp row, its column in the other rows, its
    own_in column, its own count, height, base, stale counts and k slots),
    less a^2 on each event with a adopters (``adopts_sq`` sums them): an
    own_cp entry whose row and column both adopt is written once, so the
    event writes a (2 M - a) own_cp entries, not 2 a M."""
    return adopts * (3 * m + 2 * k + 5) - adopts_sq


def fast_selfish_ops(finds: int, sel_active: int, active: int, sel_finds: int,
                     sel_adopts: int, reveals: int, k: int = 2) -> int:
    """int32 operations the fast kernel's selfish form (K1s, K3fs, K4fs)
    adds to K1's, counted from the TPUSIM_FAST_SELFISH branches of
    csrc/event_loop.cu for the selfish miners only: an honest miner holds
    no private block, so it never races, reveals or resets a count, and the
    flags come as one operand. On every active event 10 for each selfish
    miner of the run (``sel_active`` sums them: the private count out of
    the published height; the reveal test and count: the lead, four
    compares, two more and a select and a subtraction for the count) and 1
    for bhp; on every find 1 for the winner's flag, and 5 more when the
    winner is selfish (npriv == 1, bhp == height, the private append and
    the push count: a race's push of two is the find's own push, which
    :func:`fast_kernel_ops` counts); 1 for each selfish (miner, event)
    pair that adopts (npriv reset); and a push, as a find's 5 k + 20, for
    each reveal the chunk's data made (races not among them)."""
    return (sel_active * 10 + active + finds + sel_finds * 5 + sel_adopts
            + reveals * (5 * k + 20))


def fast_selfish_step(torch, sel_mr, ow, adopted, active, npriv0, npriv1, bhp0, h0) -> dict:
    """One step of the fast kernel's selfish form replayed by itself: the
    (miner, run) selfish flags ``sel_mr``, the step's winner ``ow``, who
    ``adopted``, the ``active`` runs, the private counts before and after
    the step, ``bhp`` and the heights at entry. A selfish find appends (+1)
    or races (-1, its push the find's); a private count below that without
    an adoption is a reveal (a reveal and an adoption exclude each other).
    Returns 0-d tensors: the selfish finds, races and reveal pushes, and the
    warp-steps (runs 2w and 2w + 1 share a warp, ``RunPair``) that are
    active, in which any run of the warp reveals (how often a reveal branch
    the whole warp takes is taken), and in which any run holds a private
    block at entry or finds selfishly (how often the warp needs the private
    chain at all)."""
    sw = ow & sel_mr
    race = sw & (npriv0 == 1) & (bhp0 == h0)
    reveal = (npriv1.long() < npriv0.long() + sw.long() - 2 * race.long()) & ~adopted

    def warps(run):  # (R,) -> the warps in which any run holds
        return torch.cat([run, run.new_zeros(run.numel() % 2)]).view(-1, 2).any(1).sum()

    return dict(sel_finds=sw.sum(), races=race.sum(), reveals=reveal.sum(),
                warp_steps=warps(active), reveal_warp_steps=warps(reveal.any(0)),
                private_warp_steps=warps(((npriv0 > 0) | sw).any(0)))


def exact_kernel_ops(m: int, active: int, finds: int, adopts: int, cp_accesses: int,
                     k: int = 2) -> int:
    """int32 operations the exact-mode event loop needs, counted from
    csrc/event_loop_exact.cu: K1's per-event and per-find work at ``k``
    group slots plus one per miner for the private count in the published
    height, 10 more per find for the selfish race test, 6 M + 10 for each
    (miner, event) pair in which the miner adopts (its own_cp row and column,
    own_in row and scalars), and the ``cp_accesses`` of the cp update
    (:func:`cp_update_accesses`)."""
    return (fast_kernel_ops(m, active, finds, k) + active * m + finds * 10
            + adopts * (6 * m + 10) + cp_accesses)


def flight_ops(m: int, active: int, adopt_steps: int, k: int = 2) -> int:
    """int32 operations the flight rows add to K1's or K2's, counted from
    the FLIGHT branches of csrc/*.cu: 2 k per miner on every active event
    (the step-entry slots' minimum and its owner) and 3 per miner on every
    event in which some miner adopts (the deepest adopter)."""
    return active * 2 * k * m + adopt_steps * 3 * m


def cp_update_accesses(torch, m: int, a):
    """cp entries one event's update must store and load, for ``a`` adopting
    miners (per run): the adopters' rows (a M^2) and their columns in the
    other rows ((M - a) a M) are written; of these only copies of cp[b, p, :]
    for the M - a - 1 miners p that neither adopt nor are b are read, each
    row once (the rest is b's published count row, already in registers)."""
    return torch.where(a > 0, a * m * m + (m - a) * a * m + (m - a - 1) * m, 0)


#: The raw-word mapping of one find's two words (K5a), counted from
#: event_loop_common.cuh: log1p_neg and the interval's scaling take 87 float32
#: operations (a multiply-add counted as two), and the threshold compares 4
#: int32 operations a miner plus 5 for the bits of the interval word.
RAW_MAP_FLOPS = 87


def raw_map_int_ops(m: int) -> int:
    return 4 * m + 5


#: X1's own work, as (ALU, FMA, FP64) pipe instructions a lane, read off the
#: X1 library's SASS (``smoke_out/xoroshiro.sass``; phase 2 prints the
#: loops): on the integer ALU pipe LOP3, SHF, ISETP, SEL, IADD3, VIADD, LEA
#: and the float compares and selects FSETP and FSEL; on the FMA pipe IMAD
#: in its arithmetic forms (SHL, X) and FFMA; on the FP64 pipe DADD, DMUL,
#: DFMA, DSETP, FRND and the conversions I2F.F64 and F2I.F64. Only the
#: function's own instructions count, as in MICRO_PIPES: not the loop
#: counters, the address arithmetic, the loads and stores of shared and
#: device memory (the ring's, the thresholds', the rows'), the register and
#: constant moves, the branches, nor MUFU.RCP64H (on none of the three).
#: - advance: a generator step that only moves the state, a stream;
#: - draw: a generator step that also gives its word;
#: - threshold: a threshold compared with the winner's word and the winner
#:   selected (two ISETPs and a SEL);
#: - pair: a mapped pair's uniform (the word's top 53 bits to float64,
#:   scaled and negated), log1p's entry tests, and after it the ns and ms
#:   (the scaling by the mean, a division by 1e6 in its inline sequence,
#:   two floors, the cap and the conversion);
#: - interval_k0 and interval_k: log1p's body on its two paths, k = 0 (-u >
#:   -0.2929) and the normalized reduction, each division its inline
#:   sequence (the rare slow-path call not counted); where the reduction
#:   branches on the data (hu < 0x6a09e), the shorter side.
XORO_PIPES = dict(advance=(9, 1, 0), draw=(15, 3, 0), threshold=(3, 0, 0),
                  pair=(9, 1, 17), interval_k0=(4, 1, 27), interval_k=(13, 2, 44))
#: An interval word takes log1p's k = 0 path when -log1p(-u) < -log1p(-0.2929).
XORO_K0_LOG = -math.log1p(-0.29289)
#: X1's time on the main path's chunk as the kernel it replaced, a thread a
#: run, ran there (NVIDIA H100 80GB HBM3, 700.00 W): printed beside the new
#: time, not part of the record.
X1_THREAD_A_RUN_MS = 1.4204
#: X2r's main-path chunks as the design it replaced ran them, each find's
#: words drawn and mapped as it came (ms, registers; NVIDIA H100 80GB HBM3,
#: 700.00 W): printed beside the tile's, not part of the record.
X2R_PER_FIND_MAP = {"event_loop_fast_xoro": (4.890, "69"),
                    "event_loop_exact_xoro": (8.545, "79-80")}


def xoro_pipes(m: int, consumed: int, words: int, k0_words: int) -> tuple[int, int, int]:
    """X1's (ALU, FMA, FP64) instructions, in lanes: both streams advanced by
    the ``consumed`` draws and ``words`` pairs drawn (``XORO_PIPES``), each
    winner against M - 1 thresholds, ``k0_words`` of the interval words on
    log1p's k = 0 path."""
    counts = [(XORO_PIPES["advance"], 2 * consumed), (XORO_PIPES["draw"], 2 * words),
              (XORO_PIPES["threshold"], words * (m - 1)), (XORO_PIPES["pair"], words),
              (XORO_PIPES["interval_k0"], k0_words),
              (XORO_PIPES["interval_k"], words - k0_words)]
    return tuple(round(sum(per[p] * n for per, n in counts)) for p in range(3))


def x2r_pipes(m: int, finds: int, k0_finds: int) -> tuple[int, int, int]:
    """The per-event xoroshiro draw's own work in a chunk (X2r, beyond K1's
    or K2's), as (ALU, FMA, FP64) instructions in lanes, counted as X1's
    (``XORO_PIPES``; the draw and the mappings are the same device functions,
    ``xoroshiro_draw.cuh``): on each of ``finds`` finds both streams give a
    word, the winner word meets M - 1 thresholds and the interval word is
    mapped, ``k0_finds`` of them on log1p's k = 0 path."""
    counts = [(XORO_PIPES["draw"], 2 * finds), (XORO_PIPES["threshold"], finds * (m - 1)),
              (XORO_PIPES["pair"], finds), (XORO_PIPES["interval_k0"], k0_finds),
              (XORO_PIPES["interval_k"], finds - k0_finds)]
    return tuple(round(sum(per[p] * n for per, n in counts)) for p in range(3))


def onehot_cp_loads(torch, m: int, a):
    """cp loads the one-hot read of the cp plane adds on an event with ``a``
    adopting miners (per run; K5b): the contraction reads all M^3 entries of
    cp where the gather reads only the M - a - 1 rows it copies
    (:func:`cp_update_accesses`)."""
    return torch.where(a > 0, m**3 - (m - a - 1) * m, 0)


def onehot_ops(m: int, adopt_steps: int, contraction_loads: int) -> int:
    """int32 operations of the one-hot reads (K5b): on every event in which
    some miner adopts, 2 M + 2 reads of b's entries (height, own count, the
    own_cp column and own_in row) as contractions of M multiply-adds, two
    operations each; and two per contraction load of cp."""
    return adopt_steps * (2 * m + 2) * 2 * m + 2 * contraction_loads


def fast_smem_bytes(m: int, count_bytes: int) -> int:
    """Dynamic shared memory of one 128-thread block of the fast kernel,
    computed from the formula of ``Tables<M, C>::kSmem`` in
    csrc/event_loop.cu (not read from the library): whether a run takes 16
    lanes (8 runs a block) or a warp (4 runs a block, the flight and wide
    variants), each lane holds a row of own_cp and one of own_in transposed
    for each of its P miners (P = 1 up to 32 miners in either width), each
    row an odd number of 4-byte words."""
    p = -(-m // 32)
    words = (-(-m * count_bytes // 4)) | 1
    return 2 * 128 * p * words * 4


def narrow_exact_smem_bytes(m: int, count_bytes: int) -> int:
    """Dynamic shared memory of one block of the narrow exact kernel
    (csrc/event_loop_exact.cu, ``Tables``): 8 runs, each with b's published
    count row and own_cp, own_in and cp in the count type, b_pub and each cp
    row padded to 16 bytes."""
    vec = 16 // count_bytes
    row = -(-m // vec) * vec
    cp_at = -(-(row + 2 * m * m) // vec) * vec
    return 8 * (cp_at + m * m * row) * count_bytes


def wide_exact_smem(m: int, count_bytes: int) -> tuple[int, bool, int]:
    """Dynamic shared memory of one block (one run) of the wide exact kernel
    (csrc/event_loop_exact.cu, ``WideTables``), whether cp is in it, and the
    block's warps: b's published count row and cp's rows padded to 16 bytes,
    own_cp's rows M + 1 counts apart, own_in, and cp when the whole region
    fits the 227 KB a block may take (else cp stays in device memory); about
    16 warps an SM, 1 to 4 a run."""
    vec = 16 // count_bytes
    row = -(-m // vec) * vec
    cp_at = -(-(row + m * (m + 1) + m * m) // vec) * vec
    whole = (cp_at + m * m * row) * count_bytes
    smem = whole if whole <= 232448 else cp_at * count_bytes
    return smem, whole <= 232448, min(4, max(1, 16 // (233472 // (smem + 1024))))


#: Instructions an S1 op issues a lane-iteration with csrc/micro.cu's guard in
#: place (M = 9), on the SM's integer ALU pipe and on its FMA pipe, read off
#: the micro library's SASS (``smoke_out/micro.sass``): sel3 an IADD (FMA)
#: and two ISETPs (ALU) an (i, j), two SELs (ALU) and an IADD (FMA) an
#: entry; sel_flat the same six an entry; reshape one IADD3 (x + acc + 1)
#: an entry; repeat and tile one IADD a head row (the broadcast moves no
#: arithmetic); segsum eight IADD3s and an IADD a row (its 17 adds);
#: contract one IMAD a cp entry. The threads' own copies of acc[0]'s chain
#: and the loop counter are not the op's work and are not counted.
MICRO_PIPES = dict(sel3=(81 * 2 + 729 * 2, 81 + 729), sel_flat=(729 * 4, 729 * 2),
                   reshape=(81, 0), repeat=(0, 9), tile=(0, 9), segsum=(9 * 8, 9),
                   contract=(0, 729))


def micro_ops(op: str, r: int, iters: int) -> int:
    """int32 instructions of ``iters`` iterations of an S1 op at ``r`` lanes
    on the busier of its two pipes (``MICRO_PIPES``): each pipe takes 16
    lanes an SM sub-partition a clock and the two run side by side, so the
    busier one bounds the op at ``INT32_OPS_PER_S``."""
    return max(MICRO_PIPES[op]) * r * iters


def _micro_kernel(entry: str, ops) -> str:
    """The S1 op whose kernel a mangled entry name of csrc/micro.cu names."""
    return next(op for op in ops if f"{len(op) + 7}{op}_kernel" in entry)


def micro_ptxas(log: str, ops) -> dict[str, tuple[int, int]]:
    """Each S1 kernel's registers and spill stores (bytes) from ptxas's
    report in the micro library's build log."""
    out = {}
    for chunk in log.split("Compiling entry function")[1:]:
        out[_micro_kernel(chunk.split("'")[1], ops)] = (
            int(re.search(r"Used (\d+) registers", chunk).group(1)),
            int(re.search(r"(\d+) bytes spill stores", chunk).group(1)))
    return out


def sass_loops(func: str) -> list[dict[str, int]]:
    """The loops of one function's SASS (each span from a backward branch's
    target to the branch: a loop unrolled 4 times, then its remainder of one
    iteration, or the one loop; an outer loop's span holds its inner ones)
    as opcode counts, predicates dropped."""
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
    found = []
    for i, (addr, text) in enumerate(ins):
        m = re.search(r"BRA\b.*0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            counts: dict[str, int] = {}
            for at, body in ins[:i + 1]:
                if at >= int(m.group(1), 16):
                    opcode = re.sub(r"^@!?U?P\w+\s+", "", body).split()[0]
                    counts[opcode] = counts.get(opcode, 0) + 1
            found.append(counts)
    return found


def micro_loop_opcodes(sass: str, ops) -> dict[str, list[dict[str, int]]]:
    """Each S1 kernel's iteration loops in the micro library's SASS
    (:func:`sass_loops`): what the loop issues on the thread's entries, its
    copy of acc[0]'s chain and the loop counter."""
    return {_micro_kernel(func.splitlines()[0], ops): sass_loops(func)
            for func in re.split(r"\n\s*Function : ", sass)[1:]}


def timed(torch, fn, repeat: int) -> float:
    """Mean ms of ``fn`` over ``repeat`` calls, after one warm-up call, by
    CUDA events on the current stream."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat


def timed_once(torch, fn):
    """``fn()`` and its ms, by CUDA events on the current stream."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _flat(out) -> tuple:
    """An event loop's ``(leaves, counters, flight)`` result, and with
    consumed rows the consumed counts, as one tuple."""
    return out[0] + out[1] + (out[2] or ()) + tuple(out[3:])


def max_abs_err(got, want, what: str) -> int:
    """Largest difference between two ``(leaves, counters, flight)`` results;
    fails unless they are equal in layout and value."""
    err = 0
    check(len(_flat(got)) == len(_flat(want)), f"{what}: leaf count differs")
    for g, w in zip(_flat(got), _flat(want)):
        check(g.dtype == w.dtype and g.shape == w.shape, f"{what}: leaf layout differs")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    check(err == 0, f"{what}: kernel differs from its plain version by {err}")
    return err


def equal_sums(a: dict, b: dict, what: str) -> None:
    check(a.keys() == b.keys(), f"{what}: keys differ")
    for k in a:
        check(bool((a[k] == b[k]).all()), f"{what}: {k} differs")


def sharded_run(torch, Engine, event_loop, e, keys):
    """``e.run_batch(keys)`` with the launch counts and the shards' chunk
    count set to 0 just before and read just after: ``(output, seconds,
    launches, shard chunks)``."""
    steps_run = [0]
    real_step = Engine._step

    def counted_step(self, lp):
        steps_run[0] += 1
        return real_step(self, lp)

    for k in event_loop.launches:
        event_loop.launches[k] = 0
    Engine._step = counted_step
    try:
        out, ms = timed_once(torch, lambda: e.run_batch(keys))
    finally:
        Engine._step = real_step
    return out, ms / 1e3, dict(event_loop.launches), steps_run[0]


def launched_per_shard_chunk(launches, chunks: int, kernel: str, label: str) -> None:
    check(launches[kernel] == chunks > 0,
          f"{label}: {kernel} launched {launches[kernel]} times for {chunks} shard chunks")
    others = {k: v for k, v in launches.items() if k != kernel and v}
    check(not others, f"{label}: other kernels launched: {others}")


def cross_cards(torch, Engine, event_loop, unsharded: dict, card: str) -> dict:
    """K6 across the cards of this host: each year of ``unsharded`` (roster
    -> kernel, config, keys, card 0's unsharded output and seconds) as one
    shard a card on 2, 4, 8 and all cards, key for key equal to card 0's,
    each kernel launched once a shard chunk. A day of 256 runs a card,
    sharded over every card, runs first, so that no timed run pays for a
    card's context or its first kernel load. Returns run-years/s by card
    count (1: card 0 unsharded) per roster."""
    n_cards = torch.cuda.device_count()
    by_count = {}
    for roster, (kernel, base, keys, want, one_s) in unsharded.items():
        warm = dataclasses.replace(base, runs=256 * n_cards, duration_ms=86_400_000)
        all_cards = [torch.device("cuda", i) for i in range(n_cards)]
        Engine(warm, devices=all_cards).run_batch(keys[:warm.runs])
        years = base.runs * base.duration_ms / (365.2425 * 86_400_000)
        by_count[roster] = {1: years / one_s}
        for c in sorted({c for c in (2, 4, 8) if c < n_cards} | {n_cards}):
            if base.runs % c:
                continue
            cards = [torch.device("cuda", i) for i in range(c)]
            got, secs, launches, chunks = sharded_run(torch, Engine, event_loop,
                                                      Engine(base, devices=cards), keys)
            launched_per_shard_chunk(launches, chunks, kernel, f"K6 {roster} over {c} cards")
            equal_sums(got, want, f"K6 {roster} over {c} cards vs one card")
            by_count[roster][c] = years / secs
        print(f"[K6 cards {roster}] {base.runs} runs x 1 year over 1-{n_cards} cards == one "
              f"card's key for key; run-years/s by card count: "
              f"{ {c: round(v, 1) for c, v in by_count[roster].items()} }; on {card}")
    return by_count


def cards_main(torch, card: str, kind: str) -> None:
    """``cards``: K6 across this host's cards alone. Builds the kernels of
    the two 9-miner years (K2s for the selfish roster, K1 for the default),
    runs each year (32,768 runs) unsharded on card 0, then
    :func:`cross_cards`."""
    from tpusim_torch import event_loop
    from tpusim_torch.config import SimConfig, default_network, reference_selfish_network
    from tpusim_torch.csrc import build
    from tpusim_torch.engine import Engine

    n_cards = torch.cuda.device_count()
    check(n_cards > 1, f"chip_smoke.py cards needs more than one CUDA device; this host has {n_cards}")
    t0 = time.perf_counter()
    for lib in build.build([(name, 9, 2) for name in ("event_loop_exact", "event_loop_fast")]):
        build.load_library(*lib)
    print(f"[build] event_loop_exact and event_loop_fast, M = 9, in "
          f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    unsharded = {}
    for kernel, roster, net in (("event_loop_exact", "selfish", reference_selfish_network()),
                                ("event_loop_fast", "default", default_network())):
        base = SimConfig(network=net)
        one = Engine(base, dev)
        keys = one.make_keys(0, base.runs)
        one.run_batch(keys[:256])  # the kernel's first load on card 0
        want, ms = timed_once(torch, lambda: one.run_batch(keys))
        unsharded[roster] = (kernel, base, keys, want, ms / 1e3)
    by_count = cross_cards(torch, Engine, event_loop, unsharded, card)
    (OUT / "chip_smoke_cards.json").write_text(json.dumps(
        dict(card=card, cards=n_cards, run_years_per_s=by_count), indent=1))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": n_cards}}))


def main() -> None:
    if sys.argv[1:] not in ([], ["cards"]):
        fail("usage: python3 chip_smoke.py [cards]")
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not installed: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke test runs the port's kernels on the card")
    try:
        import numpy as np

        from tpusim_torch import (
            api, cli, event_loop, flight_export, micro, native, packed, sweep, telemetry,
            threefry, xoroshiro,
        )
        from tpusim_torch.config import (
            MinerConfig, NetworkConfig, SimConfig, default_network, hetero_selfish_network,
            reference_selfish_network,
        )
        from tpusim_torch.csrc import build
        from tpusim_torch.engine import Engine, _Dispatch, counters_to_kernel
        from tpusim_torch.event_loop import (
            event_loop_chunk_plain, make_sampler, map_raw_words, state_to_kernel,
        )
        from tpusim_torch.flight import flight_to_kernel
        from tpusim_torch.sampling import interval_from_bits, winners_from_bits
    except ImportError as e:
        fail(f"run from the root of the repository (tpusim_torch not importable: {e})")
    OUT.mkdir(exist_ok=True)
    record: dict = {}
    t_all = time.perf_counter()

    # -- 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(card)
    print(f"[device] torch {torch.__version__} (CUDA {torch.version.cuda}): {kind}, "
          f"{torch.cuda.device_count()} device(s)")
    record["card"] = card
    if sys.argv[1:] == ["cards"]:
        return cards_main(torch, card, kind)

    # -- 2. build ------------------------------------------------------------
    # The libraries this script runs, for the 9-miner main paths and the
    # 4-miner comparison rosters: every kernel at two group slots (K1-K4 and
    # K4 x K3); the generic slots (K5c) at K = 3 and 4 in both modes; and at
    # K = 4 the exact kernel's flight, packed and packed flight variants.
    t0 = time.perf_counter()
    libs = [(name, m, 2) for name in build.SOURCES
            if not any(v in name for v in ("_wide", "_raw", "_onehot", "_consumed", "_xoro"))
            for m in (9, 4)]
    libs += [(name, m, k) for name in ("event_loop_fast", "event_loop_exact") for m in (9, 4)
             for k in (3, 4)]
    libs += [(name, 4, 4) for name in ("event_loop_exact_flight", "event_loop_exact_packed",
                                       "event_loop_exact_packed_flight")]
    # The wide variants (K1w, K2w) for the 17-, 20-, 24-, 32-, 33- and
    # 40-miner rosters, the ring and packed forms at 32, and K = 4 at 32 in
    # each mode.
    libs += [("event_loop_fast_wide", m, 2) for m in (17, 24, 32)]
    libs += [("event_loop_exact_wide", m, 2) for m in (20, 32, 33, 40)]
    libs += [(f"event_loop_{mode}_wide{v}", 32, 2) for mode in ("fast", "exact")
             for v in ("_flight", "_packed")]
    libs += [(f"event_loop_{mode}_wide", 32, 4) for mode in ("fast", "exact")]
    # The raw-word (K5a) and one-hot (K5b) variants: each mode at M = 9
    # plain, with the ring and packed, exact mode at K = 4; packed at M = 4
    # (per-run means); wide at 32 miners; both knobs at M = 9, and with the ring in
    # exact mode (the legacy trace); and the layout micro-benchmarks (S1).
    libs += [(f"event_loop_{mode}{knobs}{v}", 9, 2) for mode in ("fast", "exact")
             for knobs in ("_raw", "_onehot") for v in ("", "_flight", "_packed")]
    libs += [(f"event_loop_exact{knobs}", 9, 4) for knobs in ("_raw", "_onehot")]
    libs += [(f"event_loop_{mode}_raw_packed", 4, 2) for mode in ("fast", "exact")]
    libs += [(f"event_loop_{mode}_wide{knobs}", 32, 2) for mode in ("fast", "exact")
             for knobs in ("_raw", "_onehot")]
    libs += [(name, 9, 2) for name in ("event_loop_fast_raw_onehot", "event_loop_exact_raw_onehot",
                                       "event_loop_exact_raw_onehot_flight")]
    libs += [(build.MICRO, 0, 0)]
    # The xoroshiro path (phase 11): the row sampler X1, and the consumed-row
    # event loops X2 in the forms its paths run, at M = 9: fast and exact,
    # each with the ring (the trace), exact packed with the ring (the packed
    # xoroshiro grid), and exact packed (phase 14's xoroshiro sweep).
    libs += [(build.XORO, 0, 0)] + [
        (f"event_loop_{mode}_consumed{v}", 9, 2) for mode, v in (
            ("fast", ""), ("exact", ""), ("fast", "_flight"), ("exact", "_flight"),
            ("exact", "_packed_flight"), ("exact", "_packed"))]
    # The per-event xoroshiro draw (phase 16, X2r) in the forms its paths
    # run: fast and exact, each with the ring and one-hot, exact packed with
    # and without the ring, at M = 9, and wide at 32 miners.
    libs += [(f"event_loop_{mode}_xoro{v}", 9, 2) for mode in ("fast", "exact")
             for v in ("", "_flight", "_onehot")]
    libs += [(f"event_loop_exact_xoro{v}", 9, 2) for v in ("_packed", "_packed_flight")]
    libs += [(f"event_loop_{mode}_wide_xoro", 32, 2) for mode in ("fast", "exact")]
    built = build.build(libs)
    for lib in built:
        if lib[0] not in (build.MICRO, build.XORO):
            build.load_library(*lib)
    build.load_micro()
    xlib = build.load_xoro()
    record["build_s"] = time.perf_counter() - t0
    (OUT / "chip_smoke_build.log").write_text("".join(
        f"== {n}, M = {m}, K = {k}\n{log}"
        for (n, m, k), (_, _, log) in built.items()))
    for (name, m, k), (path, secs, log) in built.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        smem = ""
        if name.startswith("event_loop_fast"):
            smem = (f"; shared memory a block, computed from Tables' formula, "
                    f"{fast_smem_bytes(m, 2)} B (int16 counts), "
                    f"{fast_smem_bytes(m, 4)} B (int32)")
        elif name.startswith("event_loop_exact") and "_wide" not in name:
            smem = (f"; shared memory a block {narrow_exact_smem_bytes(m, 2)} B (int16 counts), "
                    f"{narrow_exact_smem_bytes(m, 4)} B (int32)")
        elif name.startswith("event_loop_exact"):
            smem = "; shared memory a block (one run) " + ", ".join(
                f"{b} B and {w} warps ({kind} counts{'' if whole else ', cp in device memory'})"
                for kind, (b, whole, w) in (("int16", wide_exact_smem(m, 2)),
                                            ("int32", wide_exact_smem(m, 4))))
        if name == build.MICRO:
            smem = "; " + ", ".join(f"{op} {r} registers, spill stores {sp} B" for op, (r, sp)
                                    in micro_ptxas(log, micro.OPS).items())
        print(f"[build] {name} M = {m} K = {k} -> {path.name} "
              f"({secs:.1f} s compiling): {max(regs, default=0)} registers, spill stores "
              f"{min(spills, default=0)}-{max(spills, default=0)} B over {len(regs)} "
              f"instantiations{smem}")
        record[f"build_{name}_m{m}_k{k}"] = dict(s=secs, registers=regs, spill_stores=spills)
    print(f"[build] {len(built)} libraries in {record['build_s']:.1f} s in all, one nvcc per "
          f"library in parallel")
    # The one-hot exact kernel (K5b) against the gather one: whether nvcc
    # kept the contraction's M-plane loads of cp or folded them to one plane.
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    for name in ("event_loop_exact", "event_loop_exact_onehot"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(built[name, 9, 2][0])],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        record[f"sass_global_loads_{name}_m9"] = sass.count("LDG")
        print(f"[build] {name} M = 9: {sass.count('LDG')} global loads (LDG) in its SASS")
    # S1: each kernel's iteration loop as issued, against MICRO_PIPES.
    sass = subprocess.run([str(cuobjdump), "-sass", str(built[build.MICRO, 0, 0][0])],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    (OUT / "micro.sass").write_text(sass)
    record["micro_loop_opcodes"] = micro_loop_opcodes(sass, micro.OPS)
    for op, loops in record["micro_loop_opcodes"].items():
        print(f"[build] S1 {op}: its loops issue " + "; ".join(
            f"{sum(c.values())} instructions a thread {c}" for c in loops))
    # X1: its shared memory a block, and its loops as issued, against
    # XORO_PIPES (the advance, the draws, the mapping and its thresholds).
    sass = subprocess.run([str(cuobjdump), "-sass", str(built[build.XORO, 0, 0][0])],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    (OUT / "xoroshiro.sass").write_text(sass)
    record["xoroshiro_loop_opcodes"] = sass_loops(sass)
    shape = build.xoro_shape(xlib)
    x_smem = [build.xoro_smem_bytes(xlib, 9, per_run) for per_run in (False, True)]
    print(f"[build] X1 {shape}: {32 * (shape['kGenWarps'] + shape['kMapWarps'])} threads a "
          f"block, shared memory a block as its launcher asks {x_smem[0]} B (9 miners), "
          f"{x_smem[1]} B (per run); its loops issue " + "; ".join(
              f"{sum(c.values())} instructions a thread {c}"
              for c in record["xoroshiro_loop_opcodes"]))

    #: Seconds and calls of each timed helper since the last stamp.
    helper_s: dict[str, list] = {}

    def add_helper_s(name: str, secs: float) -> None:
        acc = helper_s.setdefault(name, [0.0, 0])
        acc[0] += secs
        acc[1] += 1

    def timed_helper(fn):
        """``fn``, its seconds and calls added to the phase's helper times."""
        def wrapped(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                add_helper_s(fn.__name__, time.perf_counter() - t)
        return wrapped

    def stamp(phase: str) -> None:
        """Seconds since the start at the end of ``phase``, printed and kept
        with its helpers' seconds and calls."""
        t = time.perf_counter() - t_all
        record.setdefault("phase_end_s", {})[phase] = t
        record.setdefault("phase_helper_s", {})[phase] = {
            k: [round(v[0], 2), v[1]] for k, v in helper_s.items()}
        print(f"[time] {phase}: done at {t:.1f} s" + (" (" + ", ".join(
            f"{k} {v[0]:.1f} s x {v[1]}" for k, v in helper_s.items()) + ")" if helper_s else ""))
        helper_s.clear()

    # -- 3. sampler ----------------------------------------------------------
    cfg = SimConfig(network=default_network())
    eng = Engine(cfg, dev)
    steps = eng.chunk_steps
    keys_d = threefry.make_run_keys(cfg.seed, 0, RUNS_CMP, dev)
    keys_h = threefry.make_run_keys(cfg.seed, 0, RUNS_CMP, "cpu")
    check(torch.equal(keys_d.cpu(), keys_h), "run keys differ between the card and the CPU")
    words_d = threefry.chunk_words(keys_d, 0, steps)
    words_h = threefry.chunk_words(keys_h, 0, steps)
    check(torch.equal(words_d.cpu(), words_h), "threefry words differ between card and CPU")
    thr = eng.params.thresholds
    check(torch.equal(winners_from_bits(words_d[:, 0], thr).cpu(),
                      winners_from_bits(words_h[:, 0], thr.cpu())),
          "winner indices differ between card and CPU")
    all_words = torch.arange(2**24, dtype=torch.int64) << 8
    for mean in (600_000.0, 60_000.0):
        mis = int((interval_from_bits(all_words.to(dev), mean).cpu()
                   != interval_from_bits(all_words, mean)).sum())
        record[f"interval_mismatches_{int(mean)}ms"] = mis
        check(mis == 0, f"interval mapping at mean {mean} ms: {mis} of 2^24 differ card vs CPU")
    print(f"[sampler] keys, {words_d.numel()} words and winners bit-equal card vs CPU; "
          f"interval mapping bit-equal card vs CPU over all 2^24 uniforms at 600 s and 60 s")
    del all_words
    stamp("build and sampler")

    # -- 4. kernels against their plain versions -----------------------------
    tcap = torch.full((RUNS_CMP,), 2**29, dtype=torch.int32, device=dev)
    # Ragged chunk ends for the compared chunk: runs frozen from the start,
    # runs that freeze within the chunk, and runs that never do.
    ragged_cap = torch.randint(0, 2**29, (RUNS_CMP,), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(5))
    ragged_cap[:50] = 0
    ragged_cap[50:300] = torch.randint(1, 400_000, (250,), dtype=torch.int32,
                                       generator=torch.Generator().manual_seed(6))
    ragged_cap = ragged_cap.to(dev)
    # A 50 ms interval with 0-3 ms delays: same-ms finds, merges, overflows.
    bursty = NetworkConfig(miners=tuple(
        MinerConfig(hashrate_pct=p, propagation_ms=d)
        for p, d in ((40, 0), (30, 3), (20, 0), (10, 1))), block_interval_s=0.05)
    hetero_selfish = hetero_selfish_network()
    selfish_net = reference_selfish_network()
    FAST_HEIGHT = event_loop.FAST_LEAVES.index("height")

    def chunk_args(e, keys, state, aux, chunk, cap):
        """The event loop's arguments for chunk ``chunk``, the flight
        recorder's leaves last (None without it); with xoroshiro the rows are
        X1's from the aux's streams and consumed counts."""
        ctr, fr = aux[:2]
        prop, selfish = e.roster()
        rows = (xoroshiro.xoro_rows(aux[3], aux[4], e.xoro_sampler(), e.chunk_steps)[0]
                if e.xoro else e._rows(keys, chunk))
        return (rows, cap, prop, state_to_kernel(state), counters_to_kernel(ctr),
                selfish, None if fr is None else flight_to_kernel(fr))

    def loop_kw(e) -> dict:
        """The event loop's keyword operands for engine ``e``: its knobs'
        (:meth:`Engine.loop_options`), and consumed rows with xoroshiro."""
        return dict(e.loop_options(), **({"consumed_rows": True} if e.xoro else {}))

    @timed_helper
    def compare_variants(kernel: str, variants, mode: str, capacities=(0,), slots: int = 2,
                         knobs: dict | None = None) -> int:
        """One chunk of ``kernel`` at ``RUNS_CMP`` runs against its plain
        version, in each (state dtype, count re-base, roster) of
        ``variants`` at each ring capacity; ``knobs`` (``rng_batch``,
        ``consensus_gather``) select the raw-word and one-hot variants."""
        err = 0
        for state_dtype, rebase, net in variants:
            for capacity in capacities:
                vcfg = SimConfig(network=net, duration_ms=CMP_DAYS * 86_400_000, mode=mode,
                                 state_dtype=state_dtype, count_rebase=rebase,
                                 flight_capacity=capacity, group_slots=slots,
                                 chunk_steps=CMP_STEPS, **(knobs or {}))
                ve = Engine(vcfg, dev)
                check(ve.exact == kernel.startswith("event_loop_exact"),
                      f"{vcfg} runs the other mode")
                vkeys = ve.make_keys(0, RUNS_CMP)
                state, aux = ve._init(vkeys)
                state, aux, _ = ve._chunk(state, aux, tcap, vkeys, 0)
                if capacity and rebase:
                    check(bool(aux[1].h_base.any()), f"{kernel}: h_base still 0 after a chunk")
                args, kw = chunk_args(ve, vkeys, state, aux, 1, ragged_cap), ve.loop_options()
                before = event_loop.launches[kernel]
                got = event_loop.event_loop_chunk(*args, **kw)
                check(event_loop.launches[kernel] == before + 1, f"{kernel} did not launch")
                err = max(err, max_abs_err(got, event_loop_chunk_plain(*args, **kw),
                                           f"{kernel} chunk {state_dtype} rebase={rebase} "
                                           f"capacity={capacity} {net}"))
                if capacity == 64:
                    rows_in_chunk = got[2][1].long() - args[6][1].long()
                    check(int(rows_in_chunk.max()) > 64, f"{kernel}: the ring did not wrap")
        print(f"[{kernel}] one chunk x {RUNS_CMP} runs x {CMP_STEPS} steps ({CMP_DAYS} d "
              f"config): kernel == plain in {len(variants)} state/roster variants"
              + (f" x ring capacities {capacities}" if capacities != (0,) else "")
              + (f" at K = {slots} group slots" if slots != 2 else "")
              + (f", {knobs}" if knobs else ""))
        return err

    @timed_helper
    def compare_batch(kernel: str, network, capacity: int = 0, mode: str = "auto") -> None:
        bcfg = SimConfig(network=network, duration_ms=BATCH_DAYS * 86_400_000, runs=256,
                         batch_size=256, seed=7, flight_capacity=capacity, mode=mode)
        bk, bp = Engine(bcfg, dev), Engine(bcfg, dev, event_loop=event_loop_chunk_plain)
        out_k = bk.run_batch(bk.make_keys(0, 256))
        check(("flight_buf" in out_k) == bool(capacity), f"{kernel}: flight keys")
        equal_sums(out_k, bp.run_batch(bp.make_keys(0, 256)), f"{kernel} run_batch")
        print(f"[{kernel}] run_batch 256 runs x {BATCH_DAYS} d: kernel == plain key for key "
              f"({int(out_k['tele_chunks_max'])} chunks"
              + (f", ring capacity {capacity}" if capacity else "") + ")")

    @timed_helper
    def held_on_first_runs(kernel: str, args, kw, got, runs: int, what: str):
        """The plain version on the first :data:`PLAIN_RUNS` of a chunk's
        ``runs`` runs, held against the kernel on the same runs and against
        the kernel's full-width result ``got`` cut to them. Returns (max
        |err|, the plain version's ms for those runs)."""
        cut = lambda x: x[..., :PLAIN_RUNS].contiguous() if torch.is_tensor(x) and (
            x.shape[-1] == runs) else x
        sub = tuple(tuple(cut(x) for x in a) if isinstance(a, tuple) else cut(a) for a in args)
        kw_sub = dict(kw, sampler=kw["sampler"] and type(kw["sampler"])(
            *(cut(x) for x in kw["sampler"])))
        want, plain_ms = timed_once(torch, lambda: event_loop_chunk_plain(*sub, **kw_sub))
        err = max_abs_err(event_loop.event_loop_chunk(*sub, **kw_sub), want,
                          f"{kernel} {what}, first {PLAIN_RUNS} runs")
        err = max(err, max_abs_err(tuple(cut(part) if torch.is_tensor(part) else tuple(
            cut(x) for x in part) if part else part for part in got), want,
                                   f"{kernel} {what} against its own first {PLAIN_RUNS} runs"))
        return err, plain_ms

    @timed_helper
    def main_chunk(kernel: str, me, label: str, repeat: int = 5) -> dict:
        """One busy chunk at the main path's shape on engine ``me`` (chunk
        1, from the state after chunk 0): its plain version on the chunk's
        first :data:`PLAIN_RUNS` runs (:func:`held_on_first_runs`; its time
        is for that many), timed, and replayed one step per launch to count
        its finds, adopting (miner, event) pairs and cp accesses for the
        bound; with the flight recorder also its recorded rows and the steps
        in which some miner adopts."""
        runs, m = me.config.batch_size, me.n_miners
        mkeys = me.make_keys(0, runs)
        mcap = torch.full((runs,), 2**29, dtype=torch.int32, device=dev)
        state, aux = me._init(mkeys)
        state, aux, _ = me._chunk(state, aux, mcap, mkeys, 0)
        args, kw = chunk_args(me, mkeys, state, aux, 1, mcap), loop_kw(me)
        rows, _, prop, leaves, counters, selfish, fl = args
        got = event_loop.event_loop_chunk(*args, **kw)
        err, plain_ms = held_on_first_runs(kernel, args, kw, got, runs, "main-path chunk")
        kernel_ms = timed(torch, lambda: event_loop.event_loop_chunk(*args, **kw), repeat=repeat)
        active = int((got[1][2].long() - counters[2].long()).sum())
        h_idx = event_loop.EXACT_LEAVES.index("height") if me.exact else FAST_HEIGHT
        midx = torch.arange(m, device=dev)[:, None]
        finds = torch.zeros((), dtype=torch.int64, device=dev)
        adopts = torch.zeros((), dtype=torch.int64, device=dev)
        adopts_sq = torch.zeros((), dtype=torch.int64, device=dev)
        adopt_steps = torch.zeros((), dtype=torch.int64, device=dev)
        fast_selfish = not me.exact and me.any_selfish
        # Fast selfish: the (miner, run) selfish flags, and the counts its
        # bound needs (:func:`fast_selfish_ops`).
        sel_mr = (selfish.bool() if torch.is_tensor(selfish) else torch.tensor(
            [bool(x) for x in selfish], device=dev)[:, None].expand(m, runs)) \
            if fast_selfish else None
        sel_active, sel_adopts = (torch.zeros((), dtype=torch.int64, device=dev)
                                  for _ in range(2))
        sel_counts = dict.fromkeys(("sel_finds", "races", "reveals", "warp_steps",
                                    "reveal_warp_steps", "private_warp_steps"), 0)
        np_idx = event_loop.FAST_SELFISH_LEAVES.index("npriv")
        bhp_idx = event_loop.FAST_SELFISH_LEAVES.index("bhp")
        cp_accesses = torch.zeros((), dtype=torch.int64, device=dev)
        contraction_loads = torch.zeros((), dtype=torch.int64, device=dev)
        out = (leaves, counters, fl)
        used = torch.zeros((runs,), dtype=torch.int64, device=dev)  # consumed rows (X2)
        t_replay = time.perf_counter()
        for s in range(me.chunk_steps):
            lv, lv_ctr = out[0], out[1][2]
            found = (lv[0][0] < mcap) & (lv[0][0] == lv[1][0])
            # The step's row: row s, or with consumed rows each run's next.
            step_rows = rows.gather(0, used.view(1, 1, runs).expand(1, 2, runs)) if me.xoro \
                else rows[s:s + 1]
            # The step's winner: the row's, or mapped from its raw word.
            wq = step_rows[0, 0] if kw["sampler"] is None else winners_from_bits(
                rows[s, 0].long() & 0xFFFFFFFF, me.params.thresholds)
            ow = (midx == wq[None]) & found
            h0 = lv[h_idx]
            res = event_loop.event_loop_chunk(step_rows, mcap, prop, *out[:2], selfish,
                                              out[2], **kw)
            out = res[:3]
            if me.xoro:
                used += res[3].long()
            finds += found.sum()
            # A miner adopts iff its height rose past its own find.
            adopted = (out[0][h_idx].long() - h0.long() - ow.long()) > 0
            a = adopted.sum(0)  # adopters per run
            if fast_selfish:
                got_step = fast_selfish_step(
                    torch, sel_mr, ow, adopted, lv[0][0] < mcap, lv[np_idx], out[0][np_idx],
                    lv[bhp_idx], h0)
                sel_counts = {k: v + got_step[k] for k, v in sel_counts.items()}
                sel_active += (sel_mr.sum(0) * (out[1][2].long() - lv_ctr.long())).sum()
                sel_adopts += (adopted & sel_mr).sum()
            adopts += a.sum()
            adopts_sq += (a * a).sum()
            adopt_steps += (a > 0).sum()
            if me.exact:
                cp_accesses += cp_update_accesses(torch, m, a).sum()
                if kw["onehot"]:
                    contraction_loads += onehot_cp_loads(torch, m, a).sum()
        max_abs_err(out + ((used.int(),) if me.xoro else ()), got,
                    f"{kernel} main-path chunk replayed one step per launch")
        add_helper_s("main_chunk replay", time.perf_counter() - t_replay)
        finds, adopts, cp_accesses = int(finds), int(adopts), int(cp_accesses)
        sel_counts = {k: int(v) for k, v in sel_counts.items()}
        reveals, sel_finds = sel_counts["reveals"], sel_counts["sel_finds"]
        sel_active, sel_adopts = int(sel_active), int(sel_adopts)
        adopts_sq = int(adopts_sq)
        adopt_steps, contraction_loads = int(adopt_steps), int(contraction_loads)
        del out
        ring = fl or ()
        recorded = int((got[2][1].long() - fl[1].long()).sum()) if fl else 0
        per_run_selfish = (selfish,) if torch.is_tensor(selfish) else ()
        nbytes = sum(x.numel() * x.element_size() for x in (rows, mcap, prop) + per_run_selfish)
        # Each input read once and each output written once: the ring's
        # recorded rows land in its output copy, so they are inside it.
        nbytes += 2 * sum(x.numel() * x.element_size() for x in leaves + counters + ring)
        nbytes += sum(x.numel() * x.element_size() for x in kw["sampler"] or ())
        nbytes += 4 * runs if me.xoro else 0  # the consumed counts written
        # cp's per-event accesses are not device-memory bytes: a kernel that
        # takes the runs in waves keeps each run's cp on the chip (in shared
        # memory) between its copy in and out, which the leaves above count.
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        k = me.group_slots
        ops = (exact_kernel_ops(m, active, finds, adopts, cp_accesses, k) if me.exact
               else fast_kernel_ops(m, active, finds, k)
               + fast_adoption_ops(m, adopts, adopts_sq, k))
        if fl:
            ops += flight_ops(m, active, adopt_steps, k)
        if fast_selfish:
            ops += fast_selfish_ops(finds, sel_active, active, sel_finds, sel_adopts, reveals, k)
        if kw["onehot"]:
            ops += onehot_ops(m, adopt_steps, contraction_loads)
        ops_ms = ops / INT32_OPS_PER_S * 1e3
        if kw["sampler"] is not None:
            # The mapping of each find's words: float32 at the card's float
            # rate, the threshold compares at its int32 rate.
            ops += finds * raw_map_int_ops(m)
            ops_ms += finds * (raw_map_int_ops(m) / INT32_OPS_PER_S
                               + RAW_MAP_FLOPS / FP32_FLOPS_PER_S) * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        ring_note = (f", ring capacity {fl[0].shape[0]}: {recorded} rows recorded, "
                     f"{adopt_steps} adopting events" if fl else "")
        if kw["onehot"]:
            ring_note += f", {adopt_steps} adopting events, {contraction_loads} contraction loads"
        if fast_selfish:
            ring_note += (f", {sel_active} selfish (miner, event) pairs, {sel_finds} selfish "
                          f"finds, {sel_counts['races']} races, {sel_adopts} selfish "
                          f"adoptions, {reveals} reveal pushes; of "
                          f"{sel_counts['warp_steps']} "
                          + ("steps of run pairs" if fl else "warp-steps (two runs a warp)")
                          + f" {sel_counts['reveal_warp_steps']} reveal and "
                          f"{sel_counts['private_warp_steps']} hold a private block or "
                          "find selfishly")
        plain_note = f" on its first {PLAIN_RUNS} runs"
        print(f"[{label}] main-path chunk ({runs} runs x {me.chunk_steps} steps, M = {m}, "
              f"K = {k}, {active} active events, {finds} finds, {adopts} adopting pairs "
              f"(sum of squares {adopts_sq}), "
              f"{cp_accesses} cp accesses{ring_note}): kernel {kernel_ms:.3f} "
              f"ms, plain {plain_ms:.1f} ms{plain_note}, bound {bound_ms:.4f} ms by {bound_by} "
              f"({nbytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; {ops} ops -> {ops_ms:.4f} ms) "
              f"on {card}")
        # The same chunk by layer: the sampler's rows, and the whole chunk
        # (rows, layout moves, kernel, clock and count re-base).
        sampler_ms = timed(torch, (lambda: xoroshiro.xoro_rows(
            aux[3], aux[4], me.xoro_sampler(), me.chunk_steps)) if me.xoro
            else lambda: me._rows(mkeys, 1), repeat=3)
        chunk_ms = timed(torch, lambda: me._chunk(state, aux, mcap, mkeys, 1), repeat=3)
        print(f"[layers] {label} main-path chunk: whole chunk {chunk_ms:.3f} ms = sampler "
              f"{sampler_ms:.3f} ms + kernel {kernel_ms:.3f} ms + layout and re-base "
              f"{chunk_ms - sampler_ms - kernel_ms:.3f} ms; on {card}")
        return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                    plain_runs=PLAIN_RUNS, bound_ms=bound_ms,
                    bound_by=bound_by, chunk_active_events=active, chunk_finds=finds,
                    chunk_adopting_pairs=adopts, chunk_adopting_pairs_sq=adopts_sq,
                    chunk_cp_accesses=cp_accesses,
                    chunk_adopting_events=adopt_steps, chunk_rows_recorded=recorded,
                    chunk_reveals=reveals, chunk_selfish=sel_counts if fast_selfish else None,
                    chunk_bytes=nbytes, chunk_ops=ops, chunk_contraction_loads=contraction_loads,
                    bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms, sampler_ms=sampler_ms,
                    chunk_ms=chunk_ms)

    @timed_helper
    def card_equals_cpu(kernel: str, network, capacity: int = 0, runs: int = 64,
                        slots: int = 2, mode: str = "auto") -> None:
        """A small batch through the kernel on the card against the plain
        version on the CPU: the port's own reference end to end; with the
        flight recorder, the two event logs byte for byte too."""
        scfg = SimConfig(network=network, duration_ms=2 * 86_400_000, runs=runs, batch_size=runs,
                         seed=4, flight_capacity=capacity, group_slots=slots, mode=mode)
        on_card, on_cpu = Engine(scfg, dev), Engine(scfg, "cpu")
        a = on_card.run_batch(on_card.make_keys(0, runs))
        b = on_cpu.run_batch(on_cpu.make_keys(0, runs))
        equal_sums(a, b, f"{kernel} card vs CPU")
        note = ""
        if capacity:
            jsonl = [flight_export.events_jsonl(flight_export.decode_flight(x).events)
                     for x in (a, b)]
            check(jsonl[0] == jsonl[1] and len(jsonl[0]) > 0,
                  f"{kernel}: event logs differ card vs CPU")
            note = f"; JSONL event logs byte-identical ({len(jsonl[0].encode())} bytes)"
        print(f"[{kernel}] run_batch {runs} runs x 2 d at K = {slots}: card == CPU key for "
              f"key{note}")

    stats = {}
    err1 = compare_variants("event_loop_fast", (
        ("int16", True, default_network()), ("int32", True, default_network()),
        ("auto", True, bursty),
    ), "fast")
    compare_batch("event_loop_fast", default_network())
    stats["event_loop_fast"] = main_chunk("event_loop_fast", Engine(cfg, dev), "event_loop_fast")
    stats["event_loop_fast"]["max_abs_err"] = max(err1, stats["event_loop_fast"]["max_abs_err"])
    card_equals_cpu("event_loop_fast", default_network())
    stamp("K1")

    err2 = compare_variants("event_loop_exact", (
        ("int16", True, selfish_net), ("int16", False, selfish_net),
        ("int32", False, default_network(10_000)), ("auto", True, hetero_selfish),
    ), "auto")
    compare_batch("event_loop_exact", selfish_net)
    scfg = SimConfig(network=selfish_net)
    stats["event_loop_exact"] = main_chunk("event_loop_exact", Engine(scfg, dev),
                                           "event_loop_exact selfish")
    stats["event_loop_exact"]["max_abs_err"] = max(err2, stats["event_loop_exact"]["max_abs_err"])
    # The same kernel on an honest exact roster (SELFISH = false): the
    # reference's 10 s propagation configuration, race ratio 0.0167.
    hcfg = SimConfig(network=default_network(10_000))
    stats["event_loop_exact_honest"] = main_chunk("event_loop_exact", Engine(hcfg, dev),
                                                  "event_loop_exact honest")
    card_equals_cpu("event_loop_exact", selfish_net)
    stamp("K2")

    # The flight-recorder variants (K3f, K3x) on the same kinds of variants,
    # each at a ring that wraps within the chunk and one that does not.
    err3f = max(compare_variants("event_loop_fast_flight", (
        ("int16", True, default_network()), ("auto", True, bursty),
    ), "fast", capacities=(64,)), compare_variants(
        "event_loop_fast_flight", (("auto", True, bursty),), "fast", capacities=(2048,)))
    compare_batch("event_loop_fast_flight", default_network(), capacity=1024)
    fcfg = dataclasses.replace(cfg, flight_capacity=1024)
    stats["event_loop_fast_flight"] = main_chunk("event_loop_fast_flight", Engine(fcfg, dev),
                                                 "event_loop_fast_flight")
    stats["event_loop_fast_flight"]["max_abs_err"] = max(
        err3f, stats["event_loop_fast_flight"]["max_abs_err"])
    card_equals_cpu("event_loop_fast_flight", default_network(), capacity=1024)
    stamp("K3f")

    err3x = max(compare_variants("event_loop_exact_flight", (
        ("int16", False, selfish_net), ("auto", True, hetero_selfish),
        ("auto", True, default_network(10_000)),
    ), "auto", capacities=(64,)), compare_variants(
        "event_loop_exact_flight", (("int32", True, selfish_net),), "auto", capacities=(2048,)))
    compare_batch("event_loop_exact_flight", selfish_net, capacity=1024)
    sfcfg = dataclasses.replace(scfg, flight_capacity=1024)
    stats["event_loop_exact_flight"] = main_chunk("event_loop_exact_flight", Engine(sfcfg, dev),
                                                  "event_loop_exact_flight selfish")
    stats["event_loop_exact_flight"]["max_abs_err"] = max(
        err3x, stats["event_loop_exact_flight"]["max_abs_err"])
    card_equals_cpu("event_loop_exact_flight", selfish_net, capacity=1024)
    stamp("K3x")

    # The packed-grid kernels (K4f, K4x): per-run delays and flags, lane
    # groups with propagation from 100 ms to 60 s; in the selfish pack the
    # flags differ per group and one group is wholly honest.
    def lane_configs(kind: str, m: int, **kwargs) -> list:
        selfish_kind = kind in ("selfish", "fast_selfish")
        flags = ((0,), (), (2,), (0,)) if selfish_kind else ((),) * 4
        props = (100, 1000, 10_000, 60_000)
        if m == 9:
            nets = [default_network(p, selfish_ids=f) for p, f in zip(props, flags)]
        elif m == 32:
            nets = [default_network(p, selfish_ids=f, hashrates=H32) for p, f in zip(props, flags)]
        else:
            nets = [NetworkConfig(miners=tuple(
                MinerConfig(hashrate_pct=h, propagation_ms=p, selfish=j in f)
                for j, h in enumerate((40, 30, 20, 10))), block_interval_s=(600.0, 300.0)[i % 2])
                for i, (p, f) in enumerate(zip(props, flags))]
        return [SimConfig(network=n, mode="fast" if kind in ("fast", "fast_selfish") else "exact",
                          **kwargs) for n in nets]

    def packed_engine(cfgs, counts, **kwargs):
        """A packed engine on the card holding ``counts[i]`` runs of
        ``cfgs[i]``, as packed._dispatch sets it up."""
        pe = Engine(cfgs[0], dev, packed=True, **kwargs)
        pe.params = packed.stack_params(cfgs, counts, dev)
        pe.run_durations = np.repeat([c.duration_ms for c in cfgs], counts)
        return pe

    @timed_helper
    def compare_packed(kernel: str, variants, slots: int = 2, capacity: int = 0,
                       knobs: dict | None = None) -> int:
        err = 0
        for kind, m, state_dtype, rebase in variants:
            cfgs = lane_configs(kind, m, duration_ms=CMP_DAYS * 86_400_000, state_dtype=state_dtype,
                                count_rebase=rebase, group_slots=slots, flight_capacity=capacity,
                                chunk_steps=CMP_STEPS, **(knobs or {}))
            pe = packed_engine(cfgs, [300, 200, 250, 250])
            pkeys = pe.make_keys(0, RUNS_CMP)
            state, aux = pe._init(pkeys)
            state, aux, _ = pe._chunk(state, aux, tcap, pkeys, 0)
            args, kw = chunk_args(pe, pkeys, state, aux, 1, ragged_cap), pe.loop_options()
            check(tuple(args[2].shape) == (m, RUNS_CMP)
                  and torch.is_tensor(args[5]) == (kind in ("selfish", "fast_selfish")),
                  f"{kernel}: the {kind} pack's per-run operands")
            before = event_loop.launches[kernel]
            got = event_loop.event_loop_chunk(*args, **kw)
            check(event_loop.launches[kernel] == before + 1, f"{kernel} did not launch")
            err = max(err, max_abs_err(got, event_loop_chunk_plain(*args, **kw),
                                       f"{kernel} chunk {kind} M = {m} K = {slots} "
                                       f"{state_dtype} rebase={rebase} capacity={capacity}"))
            if capacity == 64:
                check(int((got[2][1].long() - args[6][1].long()).max()) > 64,
                      f"{kernel}: the ring did not wrap")
        print(f"[{kernel}] one chunk x {RUNS_CMP} runs x {CMP_STEPS} steps ({CMP_DAYS} d "
              f"configs), per-run delays "
              f"100 ms to 60 s: kernel == plain in {len(variants)} pack variants"
              + (f" at K = {slots} group slots" if slots != 2 else "")
              + (f", ring capacity {capacity}" if capacity else "")
              + (f", {knobs}" if knobs else ""))
        return err

    @timed_helper
    def compare_packed_batch(kernel: str, kind: str) -> None:
        cfgs = lane_configs(kind, 9, duration_ms=BATCH_DAYS * 86_400_000, runs=64,
                            batch_size=64, seed=7)
        pieces = [packed._Piece(i, 0, 64) for i in range(len(cfgs))]
        a = packed._dispatch(Engine(cfgs[0], dev, packed=True), cfgs, pieces, 256)
        b = packed._dispatch(Engine(cfgs[0], dev, packed=True,
                                    event_loop=event_loop_chunk_plain), cfgs, pieces, 256)
        equal_sums(a, b, f"{kernel} packed dispatch")
        print(f"[{kernel}] packed dispatch of 4 points x 64 runs x {BATCH_DAYS} d: kernel == "
              f"plain key for key ({int(a['tele_chunks_max'])} chunks)")

    err4f = compare_packed("event_loop_fast_packed", (
        ("fast", 9, "int32", False), ("fast", 4, "auto", True)))
    compare_packed_batch("event_loop_fast_packed", "fast")
    err4x = compare_packed("event_loop_exact_packed", (
        ("selfish", 9, "auto", True), ("selfish", 4, "int32", False),
        ("exact", 4, "int32", True)))
    compare_packed_batch("event_loop_exact_packed", "selfish")
    # The main path's chunks: the first packed dispatch of the
    # selfish-hashrate sweep at 2,048 runs a point (4 points, K4x with
    # SELFISH) and the propagation sweep's fast pack (100 ms and 1 s, K4f),
    # each 8,192 runs wide.
    grids = sweep.baseline_sweeps()
    sh_cfgs = [c for _, c in grids["selfish-hashrate"]()]
    fast_cfgs = [c for _, c in grids["propagation"]()][:2]
    stats["event_loop_exact_packed"] = main_chunk(
        "event_loop_exact_packed", packed_engine(sh_cfgs[:4], [2048] * 4),
        "event_loop_exact_packed selfish-hashrate")
    stats["event_loop_fast_packed"] = main_chunk(
        "event_loop_fast_packed", packed_engine(fast_cfgs, [4096] * 2),
        "event_loop_fast_packed propagation")
    stats["event_loop_exact_packed"]["max_abs_err"] = max(
        err4x, stats["event_loop_exact_packed"]["max_abs_err"])
    stats["event_loop_fast_packed"]["max_abs_err"] = max(
        err4f, stats["event_loop_fast_packed"]["max_abs_err"])

    # A small packed grid on the card against the same grid on the CPU.
    cc_pts = [(n, dataclasses.replace(c, runs=64, duration_ms=2 * 86_400_000))
              for n, c in grids["selfish-hashrate"]()[:3]]
    for a, b in zip(packed.run_grid(cc_pts, device=dev), packed.run_grid(cc_pts, device="cpu")):
        equal_sums(a["sums"], b["sums"], f"packed grid card vs CPU, {a['name']}")
        equal_sums({k: np.asarray(v) for k, v in a["tele"].items()},
                   {k: np.asarray(v) for k, v in b["tele"].items()},
                   f"packed grid card vs CPU counters, {a['name']}")
        check(a["moments"].n == b["moments"].n and all(
            np.array_equal(a["moments"].m2[st], b["moments"].m2[st]) for st in b["moments"].m2),
            f"packed grid card vs CPU moments, {a['name']}")
    print(f"[event_loop_exact_packed] packed grid of {len(cc_pts)} points x 64 runs x 2 d: "
          f"card == CPU, sums, moments and counters")
    stamp("K4f and K4x")
    record["kernels"] = stats

    # The generic group slots (K5c) at K = 3 and 4, in both modes: a 4-miner
    # roster whose groups crowd (a 1 s interval with delays up to 10 s: the
    # buffer fills, and at K = 3 it overflows) and the 9-miner rosters.
    crowded = NetworkConfig(miners=tuple(
        MinerConfig(hashrate_pct=p, propagation_ms=d)
        for p, d in ((40, 10_000), (30, 100), (20, 1500), (10, 0))), block_interval_s=1.0)
    err5 = {}
    for k in (3, 4):
        for kernel, variants, mode in (
            ("event_loop_fast", (("auto", True, crowded),
                                 ("int16", False, default_network(10_000))), "fast"),
            ("event_loop_exact", (("int16", True, selfish_net), ("int32", False, selfish_net),
                                  ("int32", False, crowded)), "auto"),
        ):
            err5[kernel, k] = compare_variants(kernel, variants[-1:] if k == 3 else variants,
                                               mode, slots=k)
    # At K = 4 also with the ring, packed, and packed with the ring.
    err5["event_loop_exact", 4] = max(
        err5["event_loop_exact", 4],
        compare_variants("event_loop_exact_flight", (("auto", True, crowded),), "auto",
                         capacities=(64,), slots=4),
        compare_packed("event_loop_exact_packed", (("selfish", 4, "auto", True),), slots=4),
        compare_packed("event_loop_exact_packed_flight", (("selfish", 4, "auto", True),),
                       slots=4, capacity=64))
    # The main-path chunks at K = 4 (path A's; K = 3 is on no main path and
    # is only compared) in each mode: the default roster (fast), the honest
    # 10 s roster and the selfish roster (exact).
    for k in (4,):
        for kernel, base, roster in (("event_loop_exact", scfg, "selfish"),
                                     ("event_loop_exact", hcfg, "honest"),
                                     ("event_loop_fast", cfg, "default")):
            st = main_chunk(kernel, Engine(dataclasses.replace(base, group_slots=k), dev),
                            f"{kernel} K = {k} {roster}")
            st["max_abs_err"] = max(st["max_abs_err"], err5[kernel, k])
            stats[f"{kernel}_k{k}_{roster}"] = st
    card_equals_cpu("event_loop_exact", selfish_net, runs=64, slots=4)
    stamp("K5c")

    # Packed grids with the flight recorder (K4 x K3): the K4 lane groups,
    # per-run delays from 100 ms to 60 s and selfish flags mixed per lane,
    # with a ring that wraps within the chunk and one that does not.
    err43 = max(
        compare_packed("event_loop_fast_packed_flight",
                       (("fast", 9, "auto", True), ("fast", 4, "int32", False)), capacity=64),
        compare_packed("event_loop_exact_packed_flight",
                       (("selfish", 9, "auto", True), ("selfish", 4, "int16", False),
                        ("exact", 9, "int32", True)), capacity=64),
        compare_packed("event_loop_exact_packed_flight", (("selfish", 9, "auto", True),),
                       capacity=2048))
    # The main path's chunk: the packed flight grid's dispatch of the
    # selfish-hashrate points with a 1,024-row ring, 8,192 runs wide.
    sh_flight = [dataclasses.replace(c, flight_capacity=1024) for c in sh_cfgs[:4]]
    stats["event_loop_exact_packed_flight"] = main_chunk(
        "event_loop_exact_packed_flight", packed_engine(sh_flight, [2048] * 4),
        "event_loop_exact_packed_flight selfish-hashrate")
    stats["event_loop_exact_packed_flight"]["max_abs_err"] = max(
        err43, stats["event_loop_exact_packed_flight"]["max_abs_err"])
    # And the fast form: the propagation sweep's fast pack with the ring.
    fast_flight = [dataclasses.replace(c, flight_capacity=1024) for c in fast_cfgs]
    stats["event_loop_fast_packed_flight"] = main_chunk(
        "event_loop_fast_packed_flight", packed_engine(fast_flight, [4096] * 2),
        "event_loop_fast_packed_flight propagation")
    # A small packed flight grid on the card against the same grid on the
    # CPU, the per-point event logs included.
    cf_pts = [(n, dataclasses.replace(c, runs=64, duration_ms=2 * 86_400_000,
                                       flight_capacity=1024))
              for n, c in grids["selfish-hashrate"]()[:3]]
    for a, b in zip(packed.run_grid(cf_pts, device=dev), packed.run_grid(cf_pts, device="cpu")):
        equal_sums(a["sums"], b["sums"], f"packed flight grid card vs CPU, {a['name']}")
        check(a["flight"].events == b["flight"].events and len(a["flight"].events) > 0
              and a["flight"].dropped == b["flight"].dropped,
              f"packed flight grid card vs CPU: {a['name']}'s event log differs")
    print(f"[event_loop_exact_packed_flight] packed flight grid of {len(cf_pts)} points x 64 "
          f"runs x 2 d, ring 1024: card == CPU, sums and every point's event log")
    stamp("K4 x K3")

    # The wide variants (K1w, K2w): fast rosters of 17, 24 and 32 miners
    # (path W1's roster: hetero32's hashrates at 1 s), hetero32 itself in
    # exact mode (path W2), 20 miners with a 40 % selfish miner, and 40
    # honest miners with delays to 60 s (no miner set fits a 32-bit mask);
    # int16 and int32, with the ring, packed (four 32-miner lane groups,
    # 100 ms to 60 s), and at K = 4.
    hetero32 = sweep.baseline_sweeps()["hetero32"]()[0][1]
    w1_net = default_network(hashrates=H32)
    wide_roster = lambda hs, delays, selfish=(): NetworkConfig(miners=tuple(
        MinerConfig(hashrate_pct=h, propagation_ms=d, selfish=i in selfish)
        for i, (h, d) in enumerate(zip(hs, delays))))
    r17 = wide_roster((7,) * 9 + (5,) * 5 + (4,) * 3, [1000] * 17)
    r24 = wide_roster((6,) * 4 + (5,) * 4 + (4,) * 8 + (3,) * 8, [1000] * 24)
    selfish20 = wide_roster((40,) + (4,) * 3 + (3,) * 16, [1000] * 20, selfish=(0,))
    # 33 miners: lane 0 of a warp owns miners 0 and 32, the selfish one.
    selfish33 = wide_roster((3,) * 2 + (2,) * 30 + (34,),
                            [int(100 * 600 ** (i / 32)) for i in range(33)], selfish=(32,))
    honest40 = wide_roster((3,) * 20 + (2,) * 20,
                           [int(100 * 600 ** (i / 39)) for i in range(40)])
    err1w = max(
        compare_variants("event_loop_fast_wide", (
            ("int32", True, r17), ("int16", True, r24), ("int16", True, w1_net),
            ("int32", False, w1_net),
        ), "fast"),
        compare_variants("event_loop_fast_wide_flight", (("auto", True, w1_net),), "fast",
                         capacities=(1024,)),
        compare_packed("event_loop_fast_wide_packed", (("fast", 32, "auto", True),)),
        compare_variants("event_loop_fast_wide", (("auto", True, w1_net),), "fast", slots=4))
    err2w = max(
        compare_variants("event_loop_exact_wide", (
            ("int32", False, hetero32.network), ("auto", True, selfish20),
            ("auto", True, selfish33), ("auto", True, honest40), ("int32", True, honest40),
        ), "auto"),
        compare_variants("event_loop_exact_wide_flight", (
            ("auto", True, hetero32.network), ("auto", True, selfish20)), "auto",
            capacities=(64,)),
        compare_packed("event_loop_exact_wide_packed", (("selfish", 32, "auto", True),
                                                        ("exact", 32, "int32", True))),
        compare_variants("event_loop_exact_wide", (("auto", True, hetero32.network),), "auto",
                         slots=4))
    # One busy chunk of each at 8,192 runs x 1,856 steps: path W1's roster
    # (K1w) and hetero32 (K2w).
    stats["event_loop_fast_wide"] = main_chunk(
        "event_loop_fast_wide", Engine(SimConfig(network=w1_net), dev), "event_loop_fast_wide W1")
    stats["event_loop_exact_wide"] = main_chunk(
        "event_loop_exact_wide", Engine(hetero32, dev), "event_loop_exact_wide hetero32")
    stats["event_loop_fast_wide"]["max_abs_err"] = max(
        err1w, stats["event_loop_fast_wide"]["max_abs_err"])
    stats["event_loop_exact_wide"]["max_abs_err"] = max(
        err2w, stats["event_loop_exact_wide"]["max_abs_err"])
    card_equals_cpu("event_loop_fast_wide", w1_net)
    card_equals_cpu("event_loop_exact_wide", hetero32.network, runs=16)
    stamp("K1w and K2w")

    # The raw-word (K5a) and one-hot (K5b) variants. (a) The raw-word
    # mapping alone on the card: every one of the 2^24 uniforms at the four
    # means equals sampling.interval_from_bits, and the words at each
    # threshold, one below and one above, 0 and 2^32 - 1 give the winner
    # that winners_from_bits gives.
    thr = eng.params.thresholds
    uniforms = torch.arange(2**24, dtype=torch.int64, device=dev) << 8
    both_words = threefry.to_int32(torch.stack([uniforms, uniforms]))
    for mean in (600_000.0, 60_000.0, 1_000.0, 3_600_000.0):
        mapped = map_raw_words(both_words, make_sampler(thr, mean))
        mis = int((mapped[1] != interval_from_bits(uniforms, mean)).sum())
        record[f"raw_map_mismatches_{int(mean)}ms"] = mis
        check(mis == 0, f"raw-word mapping at mean {mean} ms: {mis} of 2^24 differ")
    edge = torch.cat([thr - 1, thr, thr + 1, torch.tensor([0, 2**32 - 1], device=dev)])
    mapped = map_raw_words(threefry.to_int32(torch.stack([edge, edge])), make_sampler(thr, 6e5))
    check(torch.equal(mapped[0], winners_from_bits(edge, thr)),
          "raw-word mapping: an edge word's winner differs from winners_from_bits")
    print(f"[event_loop raw words] the device mapping == sampling's over all 2^24 uniforms at "
          f"600 s, 60 s, 1 s and 3,600 s; {edge.numel()} edge words' winners equal")
    del uniforms, both_words, mapped
    # (b) Each variant's chunk against its plain version: the main path's
    # shape for each knob in each mode (the default roster, fast; the
    # selfish roster, exact), timed and counted; then at RUNS_CMP runs with
    # the ring, packed (per-run thresholds and means at M = 4), exact at
    # K = 4, wide at 32 miners, and both knobs together.
    raw, onehot = dict(rng_batch=False), dict(consensus_gather=False)
    both = dict(rng_batch=False, consensus_gather=False)
    for knobs, tag in ((raw, "raw"), (onehot, "onehot")):
        for mode, base, roster in (("fast", cfg, "default"), ("exact", scfg, "selfish")):
            name = f"event_loop_{mode}_{tag}"
            stats[name] = main_chunk(name, Engine(dataclasses.replace(base, **knobs), dev),
                                     f"{name} {roster}")
    racy = default_network(10_000)
    for knobs, tag in ((raw, "raw"), (onehot, "onehot"), (both, "raw_onehot")):
        err5ab = max(
            compare_variants(f"event_loop_fast_{tag}", (
                ("int32", False, racy), ("int16", True, default_network()))[:2 - (tag != "raw")],
                "fast", knobs=knobs),
            compare_variants(f"event_loop_exact_{tag}", (
                ("int16", True, selfish_net), ("auto", True, racy),
                ("int32", False, selfish_net))[:3 - (tag != "raw") - (tag == "raw_onehot")],
                "auto", knobs=knobs),
            compare_variants(f"event_loop_exact_{tag}_flight", (("auto", True, selfish_net),),
                             "auto", capacities=(64,), knobs=knobs))
        if tag != "raw_onehot":
            err5ab = max(
                err5ab,
                compare_variants(f"event_loop_fast_{tag}_flight", (("auto", True, racy),), "fast",
                                 capacities=(64,), knobs=knobs),
                compare_packed(f"event_loop_fast_{tag}_packed", (("fast", 9, "auto", True),),
                               knobs=knobs),
                compare_packed(f"event_loop_exact_{tag}_packed", (("selfish", 9, "auto", True),),
                               knobs=knobs),
                compare_variants(f"event_loop_exact_{tag}", (("auto", True, selfish_net),),
                                 "auto", slots=4, knobs=knobs),
                compare_variants(f"event_loop_fast_wide_{tag}", (("auto", True, w1_net),), "fast",
                                 knobs=knobs),
                compare_variants(f"event_loop_exact_wide_{tag}", (
                    ("auto", True, hetero32.network),), "auto", knobs=knobs))
            for mode in ("fast", "exact"):
                st = stats[f"event_loop_{mode}_{tag}"]
                st["max_abs_err"] = max(st["max_abs_err"], err5ab)
        if tag == "raw":
            # Per-run thresholds and means: the 4-miner lane groups alternate
            # 600 s and 300 s intervals.
            err5ab = max(err5ab, compare_packed("event_loop_fast_raw_packed", (
                ("fast", 4, "auto", True),), knobs=knobs), compare_packed(
                "event_loop_exact_raw_packed", (("selfish", 4, "int32", True),), knobs=knobs))
            for mode in ("fast", "exact"):
                st = stats[f"event_loop_{mode}_raw"]
                st["max_abs_err"] = max(st["max_abs_err"], err5ab)
        record[f"K5_{tag}_max_abs_err"] = err5ab
    stamp("K5a and K5b")

    # -- 5. main paths -------------------------------------------------------
    def main_path(kernel: str, run_cfg, label: str):
        tele: list[dict] = []
        for k in event_loop.launches:
            event_loop.launches[k] = 0
        xoroshiro.launches["xoroshiro_rows"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.run_simulation(run_cfg, device="cuda", use_all_devices=False,
                                 batch_telemetry=tele.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(event_loop.launches)
        chunks = sum(int(t["tele_chunks_max"]) for t in tele)
        check(launches[kernel] > 0, f"the {kernel} path launched no kernel")
        check(launches[kernel] == chunks,
              f"{kernel} launches {launches[kernel]} != chunks {chunks}")
        others = {k: v for k, v in launches.items() if k != kernel}
        check(not any(others.values()), f"the {kernel} path launched other kernels: {others}")
        x1 = xoroshiro.launches["xoroshiro_rows"]
        check(x1 == (chunks if run_cfg.rng == "xoroshiro" and run_cfg.rng_batch else 0),
              f"the {kernel} path launched X1 {x1} times for {chunks} chunks")
        print(res.table())
        check(res.runs == run_cfg.runs, f"ran {res.runs} runs")
        vals = [res.best_height_mean] + [
            v for ms in res.miners
            for v in (ms.blocks_found_mean, ms.blocks_share_mean, ms.stale_rate_mean)
        ]
        check(all(math.isfinite(v) for v in vals), "non-finite statistic")
        share_sum = sum(ms.blocks_share_mean for ms in res.miners)
        check(abs(share_sum - 1) < 1e-4, f"shares sum to {share_sum}")
        run_years = res.runs * run_cfg.duration_ms / (365.2425 * 86_400_000)
        active_total = sum(int(t["tele_active_steps_sum"]) for t in tele)
        print(f"[main {label}] {res.runs} runs x 1 year in {wall:.2f} s wall = "
              f"{run_years / wall:.1f} simulated run-years/s; {launches[kernel]} kernel launches "
              f"= {chunks} chunks over {len(tele)} batches ({active_total} active events); "
              f"{wall / chunks * 1e3:.1f} ms wall per chunk; on {card}")
        record[f"main_{label.replace(' ', '_')}"] = dict(
            wall_s=wall, run_years_per_s=run_years / wall, launches=launches[kernel],
            chunks=chunks, batches=len(tele), active_events=active_total,
            overflow_total=res.overflow_total, results=res.to_dict())
        return res, launches[kernel], tele

    res_s, launches_exact, tele_s = main_path("event_loop_exact", scfg,
                                              "event_loop_exact selfish")
    expected_h = scfg.duration_ms / (scfg.network.block_interval_s * 1e3)
    selfish_share = res_s.miners[0].blocks_share_mean
    # A 40 % gamma = 0 selfish miner earns more than its hashrate (the
    # reference's README: 46.68 % of the blocks, stale rate 27.47 %) and
    # orphans honest blocks, so the best chain is shorter than the finds.
    check(abs(selfish_share - 0.4668) < 0.01, f"selfish miner's share {selfish_share}")
    check(abs(res_s.miners[0].stale_rate_mean - 0.2747) < 0.005,
          f"selfish miner's stale rate {res_s.miners[0].stale_rate_mean} vs 27.47 %")
    check(0.6 < res_s.best_height_mean / expected_h < 1.0,
          f"selfish best height {res_s.best_height_mean} vs {expected_h:.0f} finds expected")
    print(f"[main event_loop_exact selfish] selfish miner 0 (40 % hashrate): share "
          f"{selfish_share * 100:.4f} %, stale rate {res_s.miners[0].stale_rate_mean * 100:.4f} %; "
          f"on {card}")

    res_h, _, _ = main_path("event_loop_exact", hcfg, "event_loop_exact honest")
    # The reference's README at 10 s propagation: stale rates 1.0092 %
    # (miner 0, 30 %) and 1.9989 % (miner 8, 1 %).
    for ms, want, tol in ((res_h.miners[0], 0.010092, 0.0005), (res_h.miners[8], 0.019989, 0.002)):
        check(abs(ms.stale_rate_mean - want) < tol,
              f"10 s roster: miner {ms.miner_id} stale {ms.stale_rate_mean} vs {want}")
    for ms in res_h.miners:
        check(abs(ms.blocks_share_mean - ms.hashrate_pct / 100) < 0.005,
              f"10 s roster: miner {ms.miner_id} share {ms.blocks_share_mean}")

    res_f, launches_fast, tele_f = main_path("event_loop_fast", cfg, "event_loop_fast")
    expected_h = cfg.duration_ms / (cfg.network.block_interval_s * 1e3)
    check(abs(res_f.best_height_mean / expected_h - 1) < 0.01,
          f"best height {res_f.best_height_mean} vs {expected_h:.0f} expected")
    for ms in res_f.miners:
        check(abs(ms.blocks_share_mean - ms.hashrate_pct / 100) < 0.005,
              f"miner {ms.miner_id} share {ms.blocks_share_mean}")
        check(0 <= ms.stale_rate_mean < 0.01, f"miner {ms.miner_id} stale {ms.stale_rate_mean}")

    # Path A: the generic group slots (K5c) at K = 4, the selfish roster in
    # exact mode and the default roster in fast mode. With no overflow merge
    # at K = 2 a buffer never held more than two groups, so K = 4 runs the
    # same events: then every statistic and counter equals the K = 2 run's.
    strip = lambda r: dataclasses.replace(r, elapsed_s=None, compile_s=None)
    k4_launches = {}
    for kernel, base, res2, tele2, label in (
        ("event_loop_exact", scfg, res_s, tele_s, "K=4 selfish"),
        ("event_loop_fast", cfg, res_f, tele_f, "K=4 default"),
    ):
        res4, k4_launches[kernel], tele4 = main_path(
            kernel, dataclasses.replace(base, group_slots=4), f"{kernel} {label}")
        same = strip(res4) == strip(res2) and len(tele4) == len(tele2) and all(
            a.keys() == b.keys() and all(bool((a[k] == b[k]).all()) for k in a)
            for a, b in zip(tele4, tele2))
        if res4.overflow_total == res2.overflow_total == 0:
            check(same, f"{label}: no overflow at K = 2 or 4, yet the statistics differ")
        record[f"main_{kernel}_{label.replace(' ', '_')}"].update(
            k2_overflow=res2.overflow_total, equal_to_k2=same)
        print(f"[main {kernel} {label}] overflow_sum {res4.overflow_total} at K = 4, "
              f"{res2.overflow_total} at K = 2; statistics and counters "
              f"{'==' if same else '!='} the K = 2 run's; on {card}")
        if kernel == "event_loop_exact":
            s4 = res4.miners[0]
            check(abs(s4.blocks_share_mean - 0.4668) < 0.01,
                  f"K = 4: selfish miner's share {s4.blocks_share_mean}")
            check(abs(s4.stale_rate_mean - 0.2747) < 0.005,
                  f"K = 4: selfish miner's stale rate {s4.stale_rate_mean} vs 27.47 %")
            print(f"[main {kernel} {label}] selfish miner 0 (40 % hashrate): share "
                  f"{s4.blocks_share_mean * 100:.4f} %, stale rate "
                  f"{s4.stale_rate_mean * 100:.4f} %; on {card}")

    stamp("main paths")

    # -- 5b. K6: run-axis sharding -------------------------------------------
    # The selfish (K2s) and default (K1) rosters, 32,768 runs x one year, as
    # one batch sharded four ways on this card (8,192 runs a shard, the
    # reference's mesh with four forced host devices), against the
    # unsharded run_batch of the same keys, key for key. Shard i's keys are
    # those of the main path's batch i above, so the batch's integer
    # telemetry must also equal the sum of those four batches'.
    k6_shards = 4
    k6_launches = {}
    k6_years = {}
    k6_unsharded = {}
    for kernel, base, tele_main, roster in (("event_loop_exact", scfg, tele_s, "selfish"),
                                            ("event_loop_fast", cfg, tele_f, "default")):
        runs = base.runs
        one = Engine(base, dev)
        keys = one.make_keys(0, runs)
        want, one_s = timed_once(torch, lambda: one.run_batch(keys))
        one_s /= 1e3
        sharded = Engine(base, devices=[dev] * k6_shards)
        got, sh_s, launches, chunks = sharded_run(torch, Engine, event_loop, sharded, keys)
        launched_per_shard_chunk(launches, chunks, kernel, f"K6 {roster}")
        equal_sums(got, want, f"K6 {roster}: {k6_shards} shards vs unsharded")
        check(all(got[k].dtype == want[k].dtype for k in want), f"K6 {roster}: dtypes differ")
        for k in tele_main[0]:
            whole = (max if k.endswith("_max") else sum)(np.asarray(t[k]) for t in tele_main)
            check(np.array_equal(got[k], whole), f"K6 {roster}: {k} != the main path's batches'")
        k6_unsharded[roster] = (kernel, base, keys, want, one_s)
        # One shard call timed: the chunk-1 kernel of every shard, enqueued
        # back to back on the card, per shard; shard 0's inputs are those of
        # phase 4's main-path chunk (keys 0-8,191, cap 2^29 after chunk 0),
        # so its bound is that chunk's. Shard 0 against its plain version.
        loops = sharded._start_shards(keys)
        sharded._lock_step(loops)
        check(all(bool((lp.hi > 0).all()) for _, lp in loops), "K6: a year's ledger ran out")
        shard_args = [(chunk_args(sh, lp.keys, lp.state, lp.aux, 1, torch.full_like(lp.lo, 2**29)),
                       sh.loop_options()) for sh, lp in loops]
        shard_ms = timed(torch, lambda: [event_loop.event_loop_chunk(*a, **kw)
                                         for a, kw in shard_args], repeat=3) / k6_shards
        a0, kw0 = shard_args[0]
        got0 = event_loop.event_loop_chunk(*a0, **kw0)
        err, plain_ms = held_on_first_runs(kernel, a0, kw0, got0, runs // k6_shards,
                                           f"K6 {roster}: shard 0's chunk")
        del loops, shard_args, got0
        years = runs * base.duration_ms / (365.2425 * 86_400_000)
        k6_years[roster] = {1: years / one_s}
        name = f"k6_{kernel}_sharded"
        k6_launches[name] = launches[kernel]
        stats[name] = dict(max_abs_err=err, ms=shard_ms, plain_ms=plain_ms,
                              bound_ms=stats[kernel]["bound_ms"],
                              bound_by=stats[kernel]["bound_by"])
        record[f"k6_{roster}"] = dict(shards=k6_shards, runs=runs, launches=launches[kernel],
                                      shard_chunks=chunks, chunks_max=int(got["tele_chunks_max"]),
                                      sharded_s=sh_s, unsharded_s=one_s, shard_ms=shard_ms,
                                      plain_ms=plain_ms, max_abs_err=err)
        print(f"[K6 {roster}] {runs} runs x 1 year as {k6_shards} shards of {runs // k6_shards} on "
              f"one card == unsharded run_batch key for key ({len(want)} keys), integer "
              f"telemetry == the main path's 4 batches'; {launches[kernel]} {kernel} launches = "
              f"{chunks} shard chunks (max {int(got['tele_chunks_max'])} a shard); "
              f"{years / sh_s:.1f} run-years/s sharded vs {years / one_s:.1f} unsharded; one "
              f"shard call {shard_ms:.3f} ms, shard 0 == plain ({plain_ms:.1f} ms); on {card}")

    # The flight ring (K3x) sharded: 8,192 runs x 30 days, 4 shards, every
    # ring row equal to the unsharded batch's.
    rcfg = dataclasses.replace(sfcfg, runs=8192, duration_ms=30 * 86_400_000)
    one = Engine(rcfg, dev)
    rkeys = one.make_keys(0, rcfg.runs)
    want = one.run_batch(rkeys)
    got, _, launches, chunks = sharded_run(torch, Engine, event_loop,
                                           Engine(rcfg, devices=[dev] * k6_shards), rkeys)
    launched_per_shard_chunk(launches, chunks, "event_loop_exact_flight", "K6 ring")
    equal_sums(got, want, "K6 ring: 4 shards vs unsharded")
    check(int(got["flight_count"].sum()) > 0, "K6 ring: nothing recorded")
    print(f"[K6 ring] {rcfg.runs} runs x 30 d, ring 1024, 4 shards == unsharded: flight_buf "
          f"{tuple(got['flight_buf'].shape)} and flight_count equal ({int(got['flight_count'].sum())}"
          f" rows); {launches['event_loop_exact_flight']} K3x launches = {chunks} shard chunks")

    # The runner with a remainder: 8,195 runs in batches of 8,192, so one
    # batch as 4 shards of 2,048 and a trailing 3-run batch on an unsharded
    # engine, against the unsharded runner.
    mcfg = dataclasses.replace(scfg, runs=8195, duration_ms=30 * 86_400_000)
    res_sh = api.run_simulation(mcfg, devices=[dev] * k6_shards)
    res_one = api.run_simulation(mcfg, device=dev)
    check(strip(res_sh) == strip(res_one) and res_sh.runs == mcfg.runs,
          "K6 runner: the sharded run's results differ from the unsharded run's")
    print(f"[K6 runner] {mcfg.runs} runs x 30 d: one batch of 8192 as 4 shards and a 3-run "
          f"remainder unsharded == the unsharded runner's SimResults")

    # Across cards: only where the host has more than one.
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        for roster, rates in cross_cards(torch, Engine, event_loop, k6_unsharded, card).items():
            k6_years[roster].update(rates)
    else:
        print(f"[K6 cards] this host has {n_cards} CUDA device: the cross-card run (one shard "
              f"a card) did not run; the sharded path ran as {k6_shards} shards on one card")
    record["k6_run_years_per_s"] = k6_years
    stamp("K6")
    # The flight path: the same two rosters with a 1024-row ring (K3x, K3f).
    # Recording is observational, so every statistic and counter must equal
    # the run without it.
    flight_launches = {}
    for kernel, run_cfg, label, res_off, tele_off, off_label in (
        ("event_loop_exact_flight", sfcfg, "flight selfish", res_s, tele_s,
         "event_loop_exact selfish"),
        ("event_loop_fast_flight", fcfg, "flight default", res_f, tele_f, "event_loop_fast"),
    ):
        res_on, flight_launches[kernel], tele_on = main_path(kernel, run_cfg, label)
        check(strip(res_on) == strip(res_off), f"{label}: statistics differ from {off_label}")
        check(len(tele_on) == len(tele_off) and all(
            a.keys() == b.keys() and all(bool((a[k] == b[k]).all()) for k in a)
            for a, b in zip(tele_on, tele_off)), f"{label}: counters differ from {off_label}")
        on, off = record[f"main_{label.replace(' ', '_')}"], record[
            f"main_{off_label.replace(' ', '_')}"]
        print(f"[main {label}] statistics and counters == the run without the ring; "
              f"{on['run_years_per_s']:.1f} run-years/s with the ring vs "
              f"{off['run_years_per_s']:.1f} without; on {card}")

    stamp("flight paths")
    # The trace entry point itself, on the selfish roster.
    trace_runs, trace_days = 1024, 2
    events_out, trace_out = OUT / "trace_events.jsonl", OUT / "trace.json"
    trace_flags = ["--hashrates", "40,19,12,11,8,5,3,1,1", "--selfish", "0",
                   "--runs", str(trace_runs), "--days", str(trace_days), "--seed", "5"]
    captured = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rc = flight_export.main(trace_flags + [
            "--device", "cuda", "--flight-capacity", "1024",
            "--events-out", str(events_out), "--trace-out", str(trace_out)])
    trace_wall = time.perf_counter() - t0
    print(captured.getvalue(), end="")
    check(rc == 0, f"trace exited {rc}")
    trace = json.loads(trace_out.read_text())
    n_trace = flight_export.validate_perfetto(trace)
    check(trace["otherData"]["dropped"] == {}, "trace: a run's ring overflowed")
    events = flight_export.load_events_jsonl(events_out)
    check(n_trace == len(events) > 0, "trace: the timeline and the event log differ")
    # The counters of the same runs without the recorder.
    tcfg = SimConfig(network=selfish_net, duration_ms=trace_days * 86_400_000,
                     runs=trace_runs, seed=5)
    teng = Engine(tcfg, dev)
    counted = teng.run_batch(teng.make_keys(0, trace_runs))
    stale_rows = [e for e in events if e["kind"] == "stale"]
    check(len(stale_rows) == int(counted["tele_stale_events_sum"]) > 0,
          f"trace: {len(stale_rows)} stale rows vs {int(counted['tele_stale_events_sum'])}")
    depth_hist = [0] * len(counted["tele_reorg_depth_hist_sum"])
    for e in stale_rows:
        depth_hist[min(e["depth"], len(depth_hist)) - 1] += 1
    check(depth_hist == [int(x) for x in counted["tele_reorg_depth_hist_sum"]],
          f"trace: stale depths {depth_hist} vs {counted['tele_reorg_depth_hist_sum']}")
    print(f"[trace] {trace_runs} runs x {trace_days} d, selfish roster, ring 1024: "
          f"{len(events)} events, none dropped; {len(stale_rows)} stale rows and their "
          f"depths {depth_hist} == the counters; Perfetto schema valid; {trace_wall:.2f} s "
          f"for the whole command on {card}")
    record["trace"] = dict(wall_s=trace_wall, events=len(events), stale_rows=len(stale_rows),
                           depth_hist=depth_hist, output=captured.getvalue())
    stamp("trace")

    # -- 6. packed sweeps ----------------------------------------------------
    # The sweep entry point at one simulated year a run and 2,048 runs a point:
    # every batch's busy-chunk count is logged beside the kernel launches.
    # Every device-loop batch, whether through run_batch or the runner's
    # run_batch_async, ends in its _Dispatch's finalize.
    chunk_log: list[tuple[bool, int]] = []
    real_run_batch = _Dispatch.__call__

    def logged_run_batch(self):
        out = real_run_batch(self)
        chunk_log.append((self.eng.exact, int(out["tele_chunks_max"])))
        return out

    def sweep_path(points, packed_run: bool, label: str, runs: int = 2048,
                   telemetry_path=None):
        """``points`` through ``sweep.run_sweep`` at ``runs`` runs a point,
        the launch counts set to 0 just before and read just after; with
        ``telemetry_path`` the sweep's span ledger."""
        for k in event_loop.launches:
            event_loop.launches[k] = 0
        chunk_log.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = sweep.run_sweep(points, device=dev, runs_scale=runs / points[0][1].runs,
                               quiet=True, packed=packed_run, use_all_devices=False,
                               telemetry_path=telemetry_path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(event_loop.launches)
        run_years = sum(r["runs"] * r["duration_ms"] for r in rows) / (365.2425 * 86_400_000)
        for r in rows:
            vals = [r["best_height_mean"]] + [v for ms in r["miners"] for v in (
                ms["blocks_found_mean"], ms["blocks_share_mean"], ms["stale_rate_mean"])]
            check(r["runs"] == runs and all(math.isfinite(v) for v in vals),
                  f"{label}: point {r['point']} ran {r['runs']} runs or is not finite")
            share_sum = sum(ms["blocks_share_mean"] for ms in r["miners"])
            check(abs(share_sum - 1) < 1e-4, f"{label}: {r['point']} shares sum to {share_sum}")
        days = rows[0]["duration_ms"] / 86_400_000
        print(f"[sweep {label}] {len(rows)} points x {runs} runs x {days:g} d in {wall:.2f} s wall = "
              f"{run_years / wall:.1f} simulated run-years/s; {len(chunk_log)} batches, "
              f"{sum(c for _, c in chunk_log)} chunks; launches "
              f"{ {k: v for k, v in launches.items() if v} }; on {card}")
        record[f"sweep_{label.replace(' ', '_')}"] = dict(
            wall_s=wall, run_years_per_s=run_years / wall, launches=launches,
            batches=chunk_log[:], rows=rows)
        return rows, launches

    def launched_once_per_chunk(launches, label, kernels) -> None:
        """``kernels`` maps each kernel to the mode (exact or not) of the
        batches it must have served, one launch per busy chunk."""
        for kernel, exact in kernels.items():
            chunks = sum(c for e, c in chunk_log if e == exact)
            check(chunks > 0 and launches[kernel] == chunks,
                  f"{label}: {kernel} launched {launches[kernel]} times for {chunks} chunks")
        others = {k: v for k, v in launches.items() if k not in kernels and v}
        check(not others, f"{label}: other kernels launched: {others}")

    _Dispatch.__call__ = logged_run_batch
    try:
        seq_rows, seq_launches = sweep_path(grids["selfish-hashrate"](), False,
                                              "selfish-hashrate sequential")
        launched_once_per_chunk(seq_launches, "sequential sweep", {"event_loop_exact": True})
        check(len(chunk_log) == 9, f"sequential sweep: {len(chunk_log)} batches")
        pk_rows, pk_launches = sweep_path(grids["selfish-hashrate"](), True,
                                            "selfish-hashrate packed")
        launched_once_per_chunk(pk_launches, "packed sweep", {"event_loop_exact_packed": True})
        check(len(chunk_log) == 3, f"packed sweep: {len(chunk_log)} dispatches, not 3")
        strip = lambda rows: [{k: v for k, v in r.items() if k not in ("elapsed_s", "compile_s")}
                              for r in rows]
        check(strip(pk_rows) == strip(seq_rows), "packed rows differ from the sequential rows")
        s40 = next(r for r in pk_rows if r["point"] == "selfish-40pct")["miners"][0]
        check(abs(s40["blocks_share_mean"] - 0.4668) < 0.01,
              f"selfish-40pct share {s40['blocks_share_mean']} vs 46.68 %")
        seq_rate, pk_rate = (record[f"sweep_selfish-hashrate_{w}"]["run_years_per_s"]
                             for w in ("sequential", "packed"))
        print(f"[sweep selfish-hashrate] packed rows == sequential rows (9 points); selfish "
              f"miner at 40 %: share {s40['blocks_share_mean'] * 100:.4f} %; packed "
              f"{pk_rate:.1f} run-years/s vs sequential {seq_rate:.1f} "
              f"({pk_rate / seq_rate:.2f}x); on {card}")
        pr_rows, pr_launches = sweep_path(grids["propagation"](), True, "propagation packed")
        launched_once_per_chunk(pr_launches, "propagation sweep",
                                {"event_loop_fast_packed": False, "event_loop_exact_packed": True})
        check(len(chunk_log) == 2, f"propagation sweep: {len(chunk_log)} dispatches, not 2")
    finally:
        _Dispatch.__call__ = real_run_batch
    # The 10 s point against the reference README's 1.0092 % (miner 0) and
    # 1.9989 % (miner 8), at 4x the 32,768-run tolerances: sqrt(32768 / 2048).
    p10 = next(r for r in pr_rows if r["point"] == "prop-10000ms")["miners"]
    for i, want, tol in ((0, 0.010092, 0.002), (8, 0.019989, 0.008)):
        check(abs(p10[i]["stale_rate_mean"] - want) < tol,
              f"prop-10000ms: miner {i} stale {p10[i]['stale_rate_mean']} vs {want}")
    print(f"[sweep propagation] 10 s point: stale {p10[0]['stale_rate_mean'] * 100:.4f} % "
          f"(miner 0) and {p10[8]['stale_rate_mean'] * 100:.4f} % (miner 8) vs the README's "
          f"1.0092 % and 1.9989 %; on {card}")
    stamp("sweeps")

    # -- 7. packed flight grid (path B) --------------------------------------
    # The selfish-hashrate grid's first three points, 2,048 runs a point,
    # 30 days, with a 1,024-row ring, as one packed dispatch (K4 x K3). Each
    # point's decoded log must equal its own sequential trace's (K3x), run
    # for run, dropped rows and capacity included.
    days = 30
    pf_pts = [(n, dataclasses.replace(c, runs=2048, duration_ms=days * 86_400_000,
                                       flight_capacity=1024))
              for n, c in grids["selfish-hashrate"]()[:3]]
    for k in event_loop.launches:
        event_loop.launches[k] = 0
    chunk_log.clear()
    _Dispatch.__call__ = logged_run_batch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pf_rows = packed.run_grid(pf_pts, device=dev)
        torch.cuda.synchronize()
        pf_wall = time.perf_counter() - t0
        pf_launches = dict(event_loop.launches)
        launched_once_per_chunk(pf_launches, "packed flight grid",
                                {"event_loop_exact_packed_flight": True})
        check(len(chunk_log) == 1, f"packed flight grid: {len(chunk_log)} dispatches, not 1")
    finally:
        _Dispatch.__call__ = real_run_batch
    pf_years = sum(c.runs * c.duration_ms for _, c in pf_pts) / (365.2425 * 86_400_000)
    n_events = 0
    for (name, pcfg), row in zip(pf_pts, pf_rows):
        seng = Engine(pcfg, dev)
        seq = flight_export.decode_flight(seng.run_batch(seng.make_keys(0, pcfg.runs)))
        seq.events.sort(key=lambda e: (e["run"], e["seq"]))
        log = row["flight"]
        check(log.events == seq.events and log.dropped == seq.dropped
              and log.capacity == seq.capacity == 1024 and len(seq.events) > 0,
              f"packed flight grid: {name}'s log differs from its sequential trace")
        n_events += len(log.events)
    print(f"[packed flight] {len(pf_pts)} points x 2048 runs x {days} d, ring 1024: "
          f"{pf_wall:.2f} s wall = {pf_years / pf_wall:.1f} simulated run-years/s; "
          f"{pf_launches['event_loop_exact_packed_flight']} K4 x K3 launches = "
          f"{chunk_log[0][1]} chunks, no other kernel; {n_events} events, every point's "
          f"log == its sequential trace's; on {card}")
    record["packed_flight"] = dict(wall_s=pf_wall, run_years_per_s=pf_years / pf_wall,
                                   launches=pf_launches, chunks=chunk_log[0][1],
                                   events=n_events)
    stamp("packed flight")

    # -- 8. wide paths -------------------------------------------------------
    # Path W1: hetero32's 32 hashrates at the default 1 s propagation (race
    # ratio 0.0017: fast mode, K1w), 8,192 runs x one year in one batch,
    # through api.run_simulation.
    w1_cfg = SimConfig(network=w1_net, runs=8192, batch_size=8192)
    res_w1, launches_w1, _ = main_path("event_loop_fast_wide", w1_cfg, "event_loop_fast_wide W1")
    expected_h = w1_cfg.duration_ms / (w1_cfg.network.block_interval_s * 1e3)
    check(abs(res_w1.best_height_mean / expected_h - 1) < 0.01,
          f"W1: best height {res_w1.best_height_mean} vs {expected_h:.0f} expected")
    for ms in res_w1.miners:
        check(abs(ms.blocks_share_mean - ms.hashrate_pct / 100) < 0.005,
              f"W1: miner {ms.miner_id} share {ms.blocks_share_mean}")
        check(0 <= ms.stale_rate_mean < 0.01, f"W1: miner {ms.miner_id} stale {ms.stale_rate_mean}")
    # Path W2: the hetero32 grid (BASELINE.json configs[3]: 32 miners,
    # propagation 100 ms to 60 s, exact mode, K2w) through sweep.run_sweep at
    # 8,192 runs x its full year, sequentially and packed.
    w2_pts = grids["hetero32"]()
    _Dispatch.__call__ = logged_run_batch
    try:
        w2_seq, w2_seq_launches = sweep_path(w2_pts, False, "hetero32 sequential", runs=8192)
        launched_once_per_chunk(w2_seq_launches, "hetero32 sequential",
                                {"event_loop_exact_wide": True})
        w2_pk, w2_pk_launches = sweep_path(w2_pts, True, "hetero32 packed", runs=8192)
        launched_once_per_chunk(w2_pk_launches, "hetero32 packed",
                                {"event_loop_exact_wide_packed": True})
    finally:
        _Dispatch.__call__ = real_run_batch
    check(strip(w2_pk) == strip(w2_seq), "hetero32: packed rows differ from the sequential rows")
    m0, m31 = w2_seq[0]["miners"][0], w2_seq[0]["miners"][31]
    check(m31["stale_rate_mean"] > m0["stale_rate_mean"] > 0,
          f"hetero32: stale {m0['stale_rate_mean']} (100 ms) vs {m31['stale_rate_mean']} (60 s)")
    print(f"[sweep hetero32] packed row == sequential row; stale rate of miner 0 (100 ms, 14 %) "
          f"{m0['stale_rate_mean'] * 100:.4f} %, of miner 31 (60 s, 1 %) "
          f"{m31['stale_rate_mean'] * 100:.4f} %; on {card}")
    record["hetero32_stale"] = dict(miner0=m0["stale_rate_mean"], miner31=m31["stale_rate_mean"])
    # And the trace command on the hetero32 roster: the flight rings of a
    # wide roster (K2w with FLIGHT).
    w2_trace = OUT / "hetero32_trace.json"
    w2_trace.write_text(dataclasses.replace(
        hetero32, runs=1024, batch_size=1024, duration_ms=2 * 86_400_000, seed=5,
        flight_capacity=1024).to_json())
    for k in event_loop.launches:
        event_loop.launches[k] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = flight_export.main(["--config", str(w2_trace), "--device", "cuda",
                                 "--events-out", str(OUT / "hetero32_events.jsonl"),
                                 "--trace-out", str(OUT / "hetero32_trace_out.json")])
    w2_trace_s = time.perf_counter() - t0
    check(rc == 0 and event_loop.launches["event_loop_exact_wide_flight"] > 0,
          f"hetero32 trace: exit {rc}, launches {event_loop.launches}")
    w2_events = flight_export.load_events_jsonl(OUT / "hetero32_events.jsonl")
    w2_stale = sum(e["kind"] == "stale" for e in w2_events)
    check(w2_stale > 0 and max(e["miner"] for e in w2_events) == 31,
          f"hetero32 trace: {w2_stale} stale rows")
    jsonl_sha = hashlib.sha256((OUT / "hetero32_events.jsonl").read_bytes()).hexdigest()
    print(f"[trace hetero32] 1024 runs x 2 d, ring 1024: {len(w2_events)} events "
          f"({w2_stale} stale), {event_loop.launches['event_loop_exact_wide_flight']} K2w "
          f"flight launches, {w2_trace_s:.2f} s; JSONL sha256 {jsonl_sha}; on {card}")
    record["hetero32_trace"] = dict(seconds=w2_trace_s, events=len(w2_events), stale=w2_stale,
                                    jsonl_sha256=jsonl_sha)
    stamp("wide paths")

    # -- 9. the legacy knobs' paths (K5a, K5b) -------------------------------
    # Paths 1-3: the selfish and the default roster at 8,192 runs x one year
    # through `python -m tpusim_torch --config` (cli.main), with rng_batch
    # off (K5a), consensus_gather off (K5b), and the reference's LEGACY
    # configuration with the raw words (both off, un-rebased int32 counts).
    # Each run launches its variant once a chunk and no other kernel, and
    # its output JSON equals the same seed's run with the knobs on.
    legacy = dict(both, count_rebase=False, state_dtype="int32")
    wall_keys = ("elapsed_s", "compile_s")

    def cli_path(run_cfg, label: str, kernel: str) -> tuple[dict, int]:
        cfg_path, json_path = OUT / f"{label}.json", OUT / f"{label}_results.json"
        cfg_path.write_text(run_cfg.to_json())
        for k in event_loop.launches:
            event_loop.launches[k] = 0
        chunk_log.clear()
        _Dispatch.__call__ = logged_run_batch
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["--config", str(cfg_path), "--device", "cuda", "--quiet",
                               "--single-device", "--json", str(json_path)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            _Dispatch.__call__ = real_run_batch
        check(rc == 0, f"{label}: exit {rc}")
        launches = dict(event_loop.launches)
        launched_once_per_chunk(launches, label, {kernel: run_cfg.resolved_mode == "exact"})
        out = {k: v for k, v in json.loads(json_path.read_text()).items() if k not in wall_keys}
        years = run_cfg.runs * run_cfg.duration_ms / (365.2425 * 86_400_000)
        print(f"[legacy {label}] {run_cfg.runs} runs x 1 year through the CLI in {wall:.2f} s = "
              f"{years / wall:.1f} run-years/s; {launches[kernel]} {kernel} launches = "
              f"{sum(c for _, c in chunk_log)} chunks, no other kernel; on {card}")
        record[f"legacy_{label}"] = dict(wall_s=wall, run_years_per_s=years / wall,
                                         launches=launches[kernel])
        return out, launches[kernel]

    legacy_launches = {}
    for mode, base, roster in (("exact", scfg, "selfish"), ("fast", cfg, "default")):
        base = dataclasses.replace(base, runs=8192, batch_size=8192)
        want, _ = cli_path(base, f"{roster}_knobs_on", f"event_loop_{mode}")
        for knobs, tag in ((raw, "raw"), (onehot, "onehot"), (legacy, "raw_onehot")):
            name = f"event_loop_{mode}_{tag}"
            got, legacy_launches[name] = cli_path(dataclasses.replace(base, **knobs),
                                                  f"{roster}_{tag}", name)
            check(got == want, f"{roster} roster, {knobs}: the output JSON differs from the "
                               f"knobs-on run's")
        if roster == "selfish":
            share = want["miners"][0]["blocks_share_mean"]
            check(abs(share - 0.4668) < 0.01, f"selfish share {share}")
            print(f"[legacy selfish] every knob set's output == the knobs-on run's; selfish "
                  f"miner 0's share {share * 100:.2f} % (README 46.68 %); on {card}")
    # Path 4: a packed propagation grid of three points (a fast pack of two,
    # an exact one) with rng_batch off, against the same grid with it on;
    # then the trace command on the selfish roster with both knobs off,
    # whose JSONL must be byte-identical to the knobs-on trace's above.
    prop3 = grids["propagation"]()[:3]
    _Dispatch.__call__ = logged_run_batch
    try:
        on_rows, _ = sweep_path(prop3, True, "propagation 3 points packed")
        off_rows, off_launches = sweep_path(
            [(n, dataclasses.replace(c, **raw)) for n, c in prop3], True,
            "propagation 3 points packed rng_batch off")
        launched_once_per_chunk(off_launches, "packed rng_batch off", {
            "event_loop_fast_raw_packed": False, "event_loop_exact_raw_packed": True})
    finally:
        _Dispatch.__call__ = real_run_batch
    check(strip(off_rows) == strip(on_rows), "packed grid: rng_batch off rows differ")
    trace_cfg = dataclasses.replace(cli.config_from_args(cli.build_parser().parse_args(
        trace_flags)), flight_capacity=1024, **both)
    (OUT / "trace_knobs_off.json").write_text(trace_cfg.to_json())
    for k in event_loop.launches:
        event_loop.launches[k] = 0
    with contextlib.redirect_stdout(io.StringIO()):
        rc = flight_export.main(["--config", str(OUT / "trace_knobs_off.json"), "--device",
                                 "cuda", "--events-out", str(OUT / "trace_events_off.jsonl"),
                                 "--trace-out", str(OUT / "trace_off.json")])
    off_trace = {k: v for k, v in event_loop.launches.items() if v}
    check(rc == 0 and list(off_trace) == ["event_loop_exact_raw_onehot_flight"],
          f"knobs-off trace: exit {rc}, launches {off_trace}")
    check((OUT / "trace_events_off.jsonl").read_bytes() == events_out.read_bytes(),
          "knobs-off trace: the JSONL differs from the knobs-on trace's")
    off_launches = {k: v for k, v in off_launches.items() if v}
    print(f"[legacy path 4] packed propagation grid (3 points x 2048 runs) with rng_batch off: "
          f"rows == the knobs-on rows, launches {off_launches}; trace with both knobs off: "
          f"{off_trace}, JSONL byte-identical to the knobs-on trace's; on {card}")
    stamp("legacy paths")

    # -- 10. layout micro-benchmarks (S1) ------------------------------------
    # `python -m tpusim_torch.micro` at R = 8,192 lanes and N = 512
    # iterations (micro.main), the launch counts set to 0 just before and read
    # just after; then each op's kernel against its plain version on the same
    # inputs, the plain version timed. sel_flat, sel3 and contract do enough
    # work a launch to scale with N: a loop the compiler folded would read
    # floor-limited there.
    micro_r, micro_n = 8192, 512
    for k in micro.launches:
        micro.launches[k] = 0
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        rc = micro.main(["--r", str(micro_r), "--iters", str(micro_n)])
    check(rc == 0, f"tpusim_torch.micro exited {rc}")
    micro_rows = [json.loads(line) for line in captured.getvalue().splitlines()]
    micro_launches = dict(micro.launches)
    for op, row in zip(micro.OPS, micro_rows[1:]):
        ins = micro.make_inputs(op, micro_r, dev)
        got = micro.run(op, ins, micro_n)
        want, plain_ms = timed_once(torch, lambda: micro.run_plain(op, ins, micro_n))
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"S1 {op}: kernel differs from its plain version by {err}")
        ops = micro_ops(op, micro_r, micro_n)
        nbytes = sum(x.numel() * 4 for x in ins) + got.numel() * 4
        bound_ms, bound_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                                 (ops / INT32_OPS_PER_S * 1e3, "operations"))
        ms = row["us_per_iter"] * micro_n / 1e3
        check(op not in ("sel_flat", "sel3", "contract") or not row["floor_limited"],
              f"S1 {op}: floor-limited at N = {micro_n} (N/8 scaling ratio "
              f"{row['scaling_ratio_8x']:.2f}): the loop does not scale with N")
        stats[f"micro_{op}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, share_of_bound=bound_ms / ms, row=row)
        print(f"[S1 {op}] R = {micro_r}, N = {micro_n}: kernel == plain; {row['us_per_iter']:.4f} "
              f"us/iter ({ms:.4f} ms a launch), N/8 scaling ratio {row['scaling_ratio_8x']:.2f}"
              f"{' (floor-limited)' if row['floor_limited'] else ''}; plain {plain_ms:.1f} ms; "
              f"bound {bound_ms:.4f} ms by {bound_by} ({MICRO_PIPES[op]} ALU and FMA pipe "
              f"instructions a lane-iteration), {100 * bound_ms / ms:.1f} % of it; "
              f"{micro_launches[op]} launches by the command; on {card}")
    stamp("S1")

    # -- 11. the xoroshiro path (X1, X2) and the native oracle ---------------
    # X1 against its plain version on a main-path chunk (the selfish roster,
    # 8,192 runs x 1,856 steps, from the streams and consumed counts after
    # chunk 0): every row and stream word; its interval mapping alone over
    # 2^24 words at three means against the CPU's; glibc's log1p (the native
    # oracle's) against the card's own, to show what the transcription buys.
    xcfg = dataclasses.replace(scfg, rng="xoroshiro")
    xdcfg = dataclasses.replace(cfg, rng="xoroshiro")
    xe = Engine(xcfg, dev)
    runs_x = xcfg.batch_size
    xkeys = xe.make_keys(0, runs_x)
    xcap = torch.full((runs_x,), 2**29, dtype=torch.int32, device=dev)
    xstate, xaux = xe._chunk(*xe._init(xkeys), xcap, xkeys, 0)[:2]
    xsmp = xe.xoro_sampler()
    x_args = (xaux[3], xaux[4], xsmp, xe.chunk_steps)
    x_got = xoroshiro.xoro_rows(*x_args)
    x_want, x1_plain_ms = timed_once(torch, lambda: xoroshiro.xoro_rows_plain(*x_args))
    x1_err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(x_got, x_want))
    check(x1_err == 0, f"X1: kernel differs from its plain version by {x1_err}")
    x1_ms = timed(torch, lambda: xoroshiro.xoro_rows(*x_args), repeat=5)
    x_consumed = int(xaux[4].long().sum())
    x_words = runs_x * xe.chunk_steps
    k0_words = int((x_got[0][:, 1].double() < XORO_K0_LOG * xcfg.network.block_interval_s
                    * 1e3).sum())
    x_alu, x_fma, x_fp64 = xoro_pipes(xe.n_miners, x_consumed, x_words, k0_words)
    x_bytes = 2 * xaux[3].numel() * 4 + xaux[4].numel() * 4 + x_got[0].numel() * 4 + sum(
        x.numel() * x.element_size() for x in xsmp)
    x_bytes_ms = x_bytes / HBM_BYTES_PER_S * 1e3
    # The three pipes issue side by side: the least time is the busiest
    # one's. The FP64 pipe issues one instruction a lane where the data
    # sheet's rate counts a multiply-add as two operations.
    x_ops_ms = max(x_alu / INT32_OPS_PER_S, x_fma / INT32_OPS_PER_S,
                   x_fp64 / (FP64_FLOPS_PER_S / 2)) * 1e3
    x1_bound_ms, x1_bound_by = max((x_bytes_ms, "bytes"), (x_ops_ms, "operations"))
    stats["xoroshiro_rows"] = dict(max_abs_err=x1_err, ms=x1_ms, plain_ms=x1_plain_ms,
                                   bound_ms=x1_bound_ms, bound_by=x1_bound_by,
                                   consumed=x_consumed, words=x_words, k0_words=k0_words,
                                   alu=x_alu, fma=x_fma, fp64=x_fp64, bytes=x_bytes)
    print(f"[X1] main-path chunk ({runs_x} runs x {xe.chunk_steps} steps, {x_consumed} draws "
          f"consumed by chunk 0): kernel == plain, every row and stream word; kernel "
          f"{x1_ms:.4f} ms (a thread a run: {X1_THREAD_A_RUN_MS} ms), plain "
          f"{x1_plain_ms:.1f} ms, bound {x1_bound_ms:.4f} ms by {x1_bound_by} "
          f"({100 * x1_bound_ms / x1_ms:.1f} % of it; {x_bytes / 1e6:.1f} MB -> "
          f"{x_bytes_ms:.4f} ms; ALU {x_alu}, FMA {x_fma}, FP64 {x_fp64} instruction lanes, "
          f"{k0_words} interval words on log1p's k = 0 path -> {x_ops_ms:.4f} ms); on {card}")
    del x_got, x_want
    # The mapping alone: the first interval word of 2^24 runs' streams.
    n_map = 2**24
    m_streams = torch.from_numpy(xoroshiro.pack_run_streams(101, 0, n_map).view(np.int32))
    _, hi_h, lo_h = xoroshiro.next_words(tuple(m_streams[:, i].long() & 0xFFFFFFFF
                                               for i in range(4)))
    u_h = xoroshiro.uniform_from_word(hi_h, lo_h)
    lg_h = xoroshiro.log1p(-u_h)  # the CPU's: glibc's, transcribed
    lg_card_own = torch.log1p(-u_h.to(dev)).cpu()  # the card's libdevice log1p
    zero_d = torch.zeros((n_map,), dtype=torch.int32, device=dev)
    mis_map, mis_card_own = {}, {}
    for mean in (600_000.0, 60_000.0, 1_000.0):
        smp1 = xoroshiro.XoroSampler(torch.tensor([-1], dtype=torch.int32, device=dev),
                                     torch.tensor([-1], dtype=torch.int32, device=dev),
                                     torch.tensor([mean], dtype=torch.float64, device=dev))
        got_ms = xoroshiro.xoro_rows(m_streams.to(dev), zero_d, smp1, 1)[0][0, 1].cpu()
        ms_of = lambda lg: torch.clamp_max(torch.floor(
            torch.floor(-lg * (mean * 1e6) + 0.5) / 1e6), 2.0**27).int()
        mis_map[mean] = int((got_ms != ms_of(lg_h)).sum())
        mis_card_own[mean] = int((ms_of(lg_card_own) != ms_of(lg_h)).sum())
        check(mis_map[mean] == 0, f"X1 interval mapping at mean {mean} ms: {mis_map[mean]} of "
                                  f"2^24 words differ card vs CPU")
    ulp_card_own = int((lg_card_own != lg_h).sum())
    del m_streams, hi_h, lo_h, u_h, lg_h, lg_card_own
    # The transcription against this machine's C library, as native calls it.
    import ctypes
    import ctypes.util

    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.log1p.restype, libm.log1p.argtypes = ctypes.c_double, [ctypes.c_double]
    w_s = xoroshiro.reference_words(5, 2**16)
    u_s = xoroshiro.uniform_from_word(
        torch.from_numpy((w_s >> np.uint64(32)).astype(np.int64)),
        torch.from_numpy((w_s & np.uint64(0xFFFFFFFF)).astype(np.int64)))
    lg_s = xoroshiro.log1p(-u_s).numpy()
    libm_mis = int(sum(a != libm.log1p(-b) for a, b in zip(lg_s.tolist(), u_s.tolist())))
    check(libm_mis == 0, f"log1p: {libm_mis} of 2^16 values differ from this machine's C "
                         f"library's")
    record["xoro_mapping"] = dict(mismatches=mis_map, card_log1p_ulp_diffs=ulp_card_own,
                                  card_log1p_ms_diffs=mis_card_own, libm_mismatches=libm_mis)
    print(f"[X1] interval mapping over 2^24 words == the CPU's at 600 s, 60 s and 1 s; the "
          f"card's own float64 log1p differs from glibc's in {ulp_card_own} of 2^24 values "
          f"(ms moved: {mis_card_own}); the transcription == this machine's C library on "
          f"2^16 values; on {card}")

    # X2 against its plain version in each form the paths run, one chunk at
    # 1,000 runs from a mid-run state with ragged ends; then the main-path
    # chunks (default roster fast, selfish roster exact) on PLAIN_RUNS,
    # timed and counted as the base kernels'.
    @timed_helper
    def compare_consumed(kernel: str, e) -> int:
        keys = e.make_keys(0, RUNS_CMP)
        st, ax = e._init(keys)
        st, ax, _ = e._chunk(st, ax, tcap, keys, 0)
        args, kw = chunk_args(e, keys, st, ax, 1, ragged_cap), loop_kw(e)
        before = dict(event_loop.launches)
        got = event_loop.event_loop_chunk(*args, **kw)
        check(event_loop.launches[kernel] == before[kernel] + 1, f"{kernel}: not launched")
        err = max_abs_err(got, event_loop_chunk_plain(*args, **kw), f"{kernel} 1000-run chunk")
        check(int(got[3].max()) > 0, f"{kernel}: no find consumed a row")
        return err

    x2_cmp = {}
    cmp_len = dict(duration_ms=CMP_DAYS * 86_400_000, chunk_steps=CMP_STEPS)
    for kernel, e in (
        ("event_loop_fast_consumed", Engine(dataclasses.replace(xdcfg, **cmp_len), dev)),
        ("event_loop_exact_consumed", Engine(dataclasses.replace(xcfg, **cmp_len), dev)),
        ("event_loop_exact_consumed", Engine(SimConfig(
            network=default_network(10_000), rng="xoroshiro", **cmp_len), dev)),
        ("event_loop_fast_consumed_flight", Engine(dataclasses.replace(
            xdcfg, flight_capacity=64, **cmp_len), dev)),
        ("event_loop_exact_consumed_flight", Engine(dataclasses.replace(
            xcfg, flight_capacity=64, **cmp_len), dev)),
    ):
        x2_cmp[f"{kernel} {e.config.network.miners[0].propagation_ms}"] = compare_consumed(
            kernel, e)
    pk_cfgs = [dataclasses.replace(c, flight_capacity=64, rng="xoroshiro", **cmp_len)
               for c in lane_configs("selfish", 9)]
    x2_cmp["event_loop_exact_consumed_packed_flight"] = compare_consumed(
        "event_loop_exact_consumed_packed_flight",
        packed_engine(pk_cfgs, [RUNS_CMP // 4] * 4))
    print(f"[X2] one chunk at {RUNS_CMP} runs (ragged ends, from a mid-run state) == the plain "
          f"version in every form: {sorted(x2_cmp)}")
    stats["event_loop_fast_consumed"] = main_chunk("event_loop_fast_consumed", Engine(xdcfg, dev),
                                                   "event_loop_fast_consumed")
    stats["event_loop_exact_consumed"] = main_chunk("event_loop_exact_consumed", xe,
                                                    "event_loop_exact_consumed")
    x2_over_k1 = stats["event_loop_fast_consumed"]["ms"] / stats["event_loop_fast"]["ms"] - 1
    stats["event_loop_fast_consumed"]["over_k1"] = x2_over_k1
    print(f"[X2] fast main-path chunk {stats['event_loop_fast_consumed']['ms']:.3f} ms against "
          f"K1's {stats['event_loop_fast']['ms']:.3f} ms in this run ({100 * x2_over_k1:+.1f} %); "
          f"exact {stats['event_loop_exact_consumed']['ms']:.3f} ms against K2s's "
          f"{stats['event_loop_exact']['ms']:.3f} ms; on {card}")
    stamp("X1 and X2 against their plain versions")

    # The full-width years: the selfish roster (exact) and the default
    # roster (fast) with rng="xoroshiro", 32,768 runs x one year through
    # api.run_simulation, X1 and X2 each launched once a chunk and nothing
    # else, the statistics within the main path's tolerances of the README.
    res_xs, x2_launches_s, _ = main_path("event_loop_exact_consumed", xcfg,
                                         "event_loop_exact_consumed selfish")
    xs0 = res_xs.miners[0]
    check(abs(xs0.blocks_share_mean - 0.4668) < 0.01, f"xoroshiro selfish share "
                                                      f"{xs0.blocks_share_mean}")
    check(abs(xs0.stale_rate_mean - 0.2747) < 0.005, f"xoroshiro selfish stale rate "
                                                     f"{xs0.stale_rate_mean} vs 27.47 %")
    res_xd, x2_launches_f, _ = main_path("event_loop_fast_consumed", xdcfg,
                                         "event_loop_fast_consumed")
    expected_h = xdcfg.duration_ms / (xdcfg.network.block_interval_s * 1e3)
    check(abs(res_xd.best_height_mean / expected_h - 1) < 0.01,
          f"xoroshiro default: best height {res_xd.best_height_mean}")
    for ms in res_xd.miners:
        check(abs(ms.blocks_share_mean - ms.hashrate_pct / 100) < 0.005,
              f"xoroshiro default: miner {ms.miner_id} share {ms.blocks_share_mean}")
        check(0 <= ms.stale_rate_mean < 0.01,
              f"xoroshiro default: miner {ms.miner_id} stale {ms.stale_rate_mean}")
    x1_launches = x2_launches_s + x2_launches_f  # X1 launched once a chunk in each (main_path)
    print(f"[main xoroshiro selfish] selfish miner 0: share {xs0.blocks_share_mean * 100:.4f} % "
          f"(README 46.68 %), stale rate {xs0.stale_rate_mean * 100:.4f} % (27.47 %); X1 and X2 "
          f"each launched once a chunk in both years; on {card}")
    stamp("xoroshiro main paths")

    # Against the native oracle, built here from native/simcore.cpp: the
    # sums at 256 runs x 30 days, the trace at 64 runs x 2 days byte for
    # byte, and a 3-point packed xoroshiro grid with rings, each point's
    # rows and log its sequential run's, and its log the native trace's.
    t0 = time.perf_counter()
    native.load()
    native_build_s = time.perf_counter() - t0
    for roster, base in (("selfish", xcfg), ("default", xdcfg)):
        ncfg = dataclasses.replace(base, runs=256, batch_size=256, duration_ms=30 * 86_400_000)
        ne = Engine(ncfg, dev)
        got = ne.run_batch(ne.make_keys(0, 256))
        want = native.run_simulation_cpp(ncfg)
        for key, field in (("blocks_found_sum", "blocks_found_mean"),
                           ("stale_blocks_sum", "stale_blocks_mean")):
            check(np.array_equal(got[key], [round(getattr(m, field) * 256)
                                            for m in want.miners]),
                  f"xoroshiro {roster}: {key} differs from the native oracle's")
        check(int(got["best_height_sum"]) == round(want.best_height_mean * 256),
              f"xoroshiro {roster}: best height differs from the native oracle's")
        for key, field in (("blocks_share_sum", "blocks_share_mean"),
                           ("stale_rate_sum", "stale_rate_mean")):
            worst = max(abs(g / 256 - getattr(m, field)) for g, m in zip(got[key], want.miners))
            check(worst < 5e-7, f"xoroshiro {roster}: {key} off the native oracle's by {worst}")
        print(f"[native {roster}] 256 runs x 30 d: blocks found, stale blocks and best height "
              f"== the native oracle's; ratio means within float32 rounding; on {card}")
    trace_sha = {}
    for roster, flags in (("selfish", trace_flags[:4]), ("default", [])):
        base = ["--runs", "64", "--days", "2", "--quiet"] + flags
        a, b = OUT / f"xoro_trace_{roster}.jsonl", OUT / f"native_trace_{roster}.jsonl"
        for k in event_loop.launches:
            event_loop.launches[k] = 0
        rc = flight_export.main(base + ["--rng", "xoroshiro", "--device", "cuda",
                                        "--events-out", str(a),
                                        "--trace-out", str(OUT / "xoro_trace.json")])
        flight_kernel = f"event_loop_{'exact' if roster == 'selfish' else 'fast'}_consumed_flight"
        traced = {k: v for k, v in event_loop.launches.items() if v}
        check(rc == 0 and list(traced) == [flight_kernel], f"xoroshiro trace {roster}: exit {rc}, "
                                                           f"launches {traced}")
        check(flight_export.main(base + ["--backend", "cpp", "--events-out", str(b)]) == 0,
              f"native trace {roster} failed")
        with contextlib.redirect_stdout(io.StringIO()):
            diff_rc = flight_export.diff_main([str(a), str(b)])
        check(a.read_bytes() == b.read_bytes() and diff_rc == 0,
              f"xoroshiro trace {roster}: the card's log differs from the native oracle's")
        trace_sha[roster] = hashlib.sha256(a.read_bytes()).hexdigest()
        print(f"[native trace {roster}] 64 runs x 2 d on the card ({flight_kernel}): "
              f"{len(a.read_bytes().splitlines())} events, byte-identical to the native "
              f"oracle's, trace diff exit 0; on {card}")
    xp_pts = [(n, dataclasses.replace(c, runs=256, duration_ms=2 * 86_400_000,
                                       flight_capacity=2048, rng="xoroshiro"))
              for n, c in grids["selfish-hashrate"]()[:3]]
    for k in event_loop.launches:
        event_loop.launches[k] = 0
    xp_rows = packed.run_grid(xp_pts, device=dev)
    xp_launches = {k: v for k, v in event_loop.launches.items() if v}
    check(list(xp_launches) == ["event_loop_exact_consumed_packed_flight"],
          f"packed xoroshiro grid: launches {xp_launches}")
    for (name, pcfg), row in zip(xp_pts, xp_rows):
        seq_res = api.run_simulation(pcfg, device="cuda", use_all_devices=False)
        check(dataclasses.replace(row["results"], elapsed_s=None, compile_s=None)
              == dataclasses.replace(seq_res, elapsed_s=None, compile_s=None),
              f"packed xoroshiro grid: {name}'s row differs from its sequential run's")
        seng = Engine(pcfg, dev)
        seq = flight_export.decode_flight(seng.run_batch(seng.make_keys(0, pcfg.runs)))
        seq.events.sort(key=lambda e: (e["run"], e["seq"]))
        check(row["flight"].events == seq.events and not seq.dropped,
              f"packed xoroshiro grid: {name}'s log differs from its sequential trace")
        nat = OUT / f"native_{name}.jsonl"
        native.run_events_cpp(pcfg, nat)
        check(flight_export.events_jsonl(seq.events).encode() == nat.read_bytes(),
              f"packed xoroshiro grid: {name}'s log differs from the native oracle's")
    print(f"[packed xoroshiro] {len(xp_pts)} points x 256 runs x 2 d, ring 2048: "
          f"launches {xp_launches}; each point's row and log == its sequential run's, and its "
          f"log == the native oracle's; native built in {native_build_s:.1f} s; on {card}")
    record["xoroshiro"] = dict(x2_compared=x2_cmp, trace_sha256=trace_sha,
                               native_build_s=native_build_s)
    stamp("xoroshiro against the native oracle")

    # -- 12. run-until-confident ---------------------------------------------
    # (i) The default roster's year through the CLI on a 32,768-run budget,
    # stopped by its blocks_share target after batch 2; its sums against a
    # run of as many runs with no target, key for key (the checkpoints).
    rdir = OUT / "run_until_confident"
    shutil.rmtree(rdir, ignore_errors=True)
    rdir.mkdir()
    budget, ledger = 32_768, rdir / "spans.jsonl"

    real_step = Engine._step

    def cli_run(flags: list[str], tag: str) -> tuple[float, dict, int]:
        """``cli.main`` on the card with ``flags``, its checkpoint and JSON
        under ``tag``; returns its seconds, its launches and the chunks of
        the batch the stop abandoned in flight (the runner's batch
        pipeline: K1 launched once a chunk enqueued, the finalized
        batches' busy chunks and those)."""
        for k in event_loop.launches:
            event_loop.launches[k] = 0
        chunk_log.clear()
        steps = [0]

        def counted_step(self, lp):
            steps[0] += 1
            return real_step(self, lp)

        _Dispatch.__call__ = logged_run_batch
        Engine._step = counted_step
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(flags + ["--single-device", "--quiet",
                                       "--checkpoint", str(rdir / f"{tag}.npz"),
                                       "--json", str(rdir / f"{tag}.json")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            _Dispatch.__call__ = real_run_batch
            Engine._step = real_step
        check(rc == 0, f"run-until-confident {tag}: exit {rc}")
        launches = dict(event_loop.launches)
        busy = sum(c for _, c in chunk_log)
        check(launches["event_loop_fast"] == steps[0] >= busy > 0,
              f"run-until-confident {tag}: event_loop_fast launched {launches['event_loop_fast']} "
              f"times for {steps[0]} chunks enqueued, {busy} busy")
        others = {k: v for k, v in launches.items() if k != "event_loop_fast" and v}
        check(not others, f"run-until-confident {tag}: other kernels launched: {others}")
        return wall, launches, steps[0] - busy

    ci_s, ci_launches, ci_abandoned = cli_run(
        ["--runs", str(budget), "--ci-target-stat", "blocks_share", "--ci-target",
         repr(CI_TARGET), "--telemetry", str(ledger)], "target")

    ci_chunks = [c for _, c in chunk_log]
    spans = telemetry.load_spans(ledger)
    rels = [sp["attrs"]["stats"]["blocks_share"]["rel_hw_max"]
            for sp in spans if sp["span"] == "stats"]
    run_span = [sp for sp in spans if sp["span"] == "run"]
    print(f"[run-until-confident] default roster, budget {budget} runs in batches of 8192: "
          f"blocks_share rel_hw_max by batch {rels} against the target {CI_TARGET}")
    check(len(run_span) == 1, f"run-until-confident: {len(run_span)} run spans")
    run_attrs = run_span[0]["attrs"]
    ran = run_attrs["runs"]
    check(run_attrs["stop_reason"] == "ci_target" and run_attrs["converged"] is True
          and ran == 2 * 8192 and len(rels) == 2 and rels[1] <= CI_TARGET < rels[0],
          f"run-until-confident: stop {run_attrs['stop_reason']} after {ran} runs, rel {rels}")
    check(run_attrs["platform"] == "gpu" and run_attrs["device_kind"] == kind,
          f"run-until-confident: the run span's device {run_attrs.get('device_kind')}")
    fixed_s, _, fixed_abandoned = cli_run(["--runs", str(ran)], "fixed")
    check(fixed_abandoned == 0, f"run-until-confident: the fixed run abandoned "
                                f"{fixed_abandoned} chunks")
    with np.load(rdir / "target.npz") as a, np.load(rdir / "fixed.npz") as b:
        check(sorted(a.files) == sorted(b.files), "run-until-confident: checkpoint keys differ")
        for k in a.files:
            check(np.array_equal(a[k], b[k]), f"run-until-confident: {k} differs from the "
                                              f"run of {ran} runs with no target")
        n_keys = len(a.files)
    got, want = ({k: v for k, v in json.loads((rdir / f"{t}.json").read_text()).items()
                  if k not in wall_keys} for t in ("target", "fixed"))
    check(got == want, "run-until-confident: the output JSON differs from the fixed run's")
    ci_k1 = ci_launches["event_loop_fast"]
    print(f"[run-until-confident] stopped by its target after {ran} of {budget} runs "
          f"({budget - ran} runs saved) in {ci_s:.2f} s through the CLI (the fixed run of "
          f"{ran} runs: {fixed_s:.2f} s); {ci_k1} event_loop_fast launches = "
          f"{sum(ci_chunks)} busy chunks + {ci_abandoned} of the batch abandoned in flight, "
          f"no other kernel; its {n_keys} checkpoint keys and "
          f"output JSON == the fixed run's; run span {run_span[0]['dur_s']:.2f} s; on {card}")
    record["run_until_confident"] = dict(
        target=CI_TARGET, rel_by_batch=rels, runs=ran, budget=budget, wall_s=ci_s,
        abandoned_chunks=ci_abandoned,
        fixed_wall_s=fixed_s, run_span_s=run_span[0]["dur_s"], launches=ci_k1)

    # (ii) The selfish-threshold grid through run_grid_adaptive at 8,192
    # lanes: every point converged within 6 rounds, and each point's sums
    # and moments those of run_grid over the runs it ran.
    grid_budget, grid_days = 4096, 30
    st_pts = [(n, dataclasses.replace(c, runs=grid_budget, duration_ms=grid_days * 86_400_000,
                                      chunk_steps=1856))
              for n, c in grids["selfish-threshold"]()]
    st_packs, st_seq = packed.plan_packs(st_pts)
    check(len(st_packs) == 1 and not st_seq, f"selfish-threshold: {len(st_packs)} packs")
    grid_ledger = rdir / "adaptive.jsonl"
    rec = telemetry.TelemetryRecorder(grid_ledger)
    for k in event_loop.launches:
        event_loop.launches[k] = 0
    chunk_log.clear()
    _Dispatch.__call__ = logged_run_batch
    printed = io.StringIO()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            ad_rows = packed.run_grid_adaptive(
                st_pts, ci_target_stat="blocks_share", ci_target_rel=GRID_CI_TARGET,
                lanes=8192, max_rounds=6, device=dev, telemetry=rec, quiet=False)
        torch.cuda.synchronize()
        ad_s = time.perf_counter() - t0
    finally:
        _Dispatch.__call__ = real_run_batch
        rec.close()
    ad_launches = dict(event_loop.launches)
    rounds = ad_rows[0]["rounds"]
    lanes_by_round = [[sp["attrs"]["lanes"] for sp in telemetry.load_spans(grid_ledger)
                       if sp["span"] == "stats" and sp["attrs"]["round"] == r]
                      for r in range(1, rounds + 1)]
    print(printed.getvalue(), end="")
    print(f"[adaptive] selfish-threshold, {len(st_pts)} points x {grid_days} d, budget "
          f"{grid_budget} runs a point, 8192 lanes: {rounds} rounds in {ad_s:.2f} s, lanes by "
          f"round {[sum(x) for x in lanes_by_round]} ({lanes_by_round}), runs "
          f"{[r['results'].runs for r in ad_rows]}, rel {[r['rel'] for r in ad_rows]}, "
          f"converged {[r['converged'] for r in ad_rows]}")
    launched_once_per_chunk(ad_launches, "adaptive grid", {"event_loop_exact_packed": True})
    check(len(chunk_log) == rounds and rounds <= 6, f"adaptive grid: {len(chunk_log)} "
                                                    f"dispatches in {rounds} rounds")
    check(all(r["converged"] for r in ad_rows), "adaptive grid: a point did not converge")
    check(rounds >= 2 and len(set(lanes_by_round[1])) > 1,
          f"adaptive grid: round 2's lanes {lanes_by_round[1:2]} are not unequal")
    check(all(sum(x) <= 8192 for x in lanes_by_round), "adaptive grid: a round passed 8192")
    ran_pts = [(n, dataclasses.replace(c, runs=r["results"].runs))
               for (n, c), r in zip(st_pts, ad_rows)]
    for got, want in zip(ad_rows, packed.run_grid(ran_pts, device=dev)):
        equal_sums(got["sums"], want["sums"], f"adaptive grid, {got['name']}, against run_grid")
        check(got["moments"].n == want["moments"].n and all(
            np.array_equal(got["moments"].m1[st], want["moments"].m1[st])
            and np.array_equal(got["moments"].m2[st], want["moments"].m2[st])
            for st in want["moments"].m1),
            f"adaptive grid, {got['name']}: moments differ from run_grid's")
    ad_k4x = ad_launches["event_loop_exact_packed"]
    print(f"[adaptive] every point converged; {ad_k4x} event_loop_exact_packed launches = "
          f"{sum(c for _, c in chunk_log)} busy chunks over {rounds} dispatches, no other "
          f"kernel; each point's sums and moments == run_grid's over its runs; on {card}")
    record["adaptive_grid"] = dict(
        target=GRID_CI_TARGET, rounds=rounds, lanes_by_round=lanes_by_round, wall_s=ad_s,
        runs=[r["results"].runs for r in ad_rows], rel=[r["rel"] for r in ad_rows],
        launches=ad_k4x)
    stats["event_loop_fast_run_until_confident"] = stats["event_loop_fast"]
    stats["event_loop_exact_packed_adaptive"] = stats["event_loop_exact_packed"]
    stamp("run-until-confident")

    # -- 13. dispatch paths --------------------------------------------------
    # (i) The four paths key for key on the card: the device loop,
    # run_batch(pipelined=True), run_batch(host_loop=True) and
    # run_batch_async(keys)(), each with its launches.
    def path_launches(fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after: its output and the kernels it launched."""
        for k in event_loop.launches:
            event_loop.launches[k] = 0
        xoroshiro.launches["xoroshiro_rows"] = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in {**event_loop.launches, **xoroshiro.launches}.items() if v}

    dispatch_launches: dict = {}

    def four_paths(eng, keys, label: str, kernel: str) -> None:
        calls = {"device": lambda: eng.run_batch(keys),
                 "pipelined": lambda: eng.run_batch(keys, pipelined=True),
                 "host_loop": lambda: eng.run_batch(keys, host_loop=True),
                 "async": lambda: eng.run_batch_async(keys)()}
        outs, launches = {}, {}
        for path, call in calls.items():
            outs[path], launches[path] = path_launches(call)
            if path != "device":
                equal_sums(outs[path], outs["device"], f"dispatch {label}: {path} vs the "
                                                       f"device loop")
        busy, shards = int(outs["device"]["tele_chunks_max"]), len(eng.shards)
        for path, got in launches.items():
            n = got.get(kernel, 0)
            top = {"pipelined": shards * (busy + Engine._PIPELINE_DEPTH),
                   "host_loop": shards * busy}.get(path, shards * busy)
            low = shards * busy if path == "host_loop" else busy
            check(low <= n <= top and (shards > 1 or path == "pipelined" or n == busy),
                  f"dispatch {label}: {path} launched {kernel} {n} times for {busy} busy chunks")
            others = {k: v for k, v in got.items() if k != kernel
                      and not (k == "xoroshiro_rows" and v == n)}
            check(not others, f"dispatch {label}: {path} launched other kernels: {others}")
        dispatch_launches[label] = dict(busy=busy, shards=shards, **{
            p: got.get(kernel, 0) for p, got in launches.items()})
        print(f"[dispatch {label}] {keys.shape[0]} runs x {BATCH_DAYS} d: pipelined, host loop "
              f"and async == the device loop key for key; {kernel} launches by path "
              f"{ {p: got.get(kernel, 0) for p, got in launches.items()} } for {busy} busy "
              f"chunks{f' a shard, {shards} shards' if shards > 1 else ''}; on {card}")

    bdays = BATCH_DAYS * 86_400_000
    for label, dcfg, kernel, shards in (
            ("K1", dataclasses.replace(cfg, duration_ms=bdays), "event_loop_fast", 1),
            ("K2s", dataclasses.replace(scfg, duration_ms=bdays), "event_loop_exact", 1),
            ("K3x", dataclasses.replace(scfg, duration_ms=bdays, flight_capacity=64),
             "event_loop_exact_flight", 1),
            ("X2 fast", dataclasses.replace(xdcfg, duration_ms=bdays),
             "event_loop_fast_consumed", 1),
            ("K6", dataclasses.replace(scfg, duration_ms=bdays), "event_loop_exact", 4)):
        deng = Engine(dcfg, dev) if shards == 1 else Engine(dcfg, devices=[dev] * shards)
        four_paths(deng, deng.make_keys(0, 256), label, kernel)
    grid3 = [(n, dataclasses.replace(c, runs=256, batch_size=256, duration_ms=bdays))
             for n, c in grids["selfish-hashrate"]()[:3]]
    grid_out = {}
    for path in ("device", "host_loop", "pipelined"):
        kw = {} if path == "device" else {path: True}
        grid_out[path] = path_launches(lambda: packed.run_grid(grid3, device=dev, **kw))
    for path in ("host_loop", "pipelined"):
        for got, want in zip(grid_out[path][0], grid_out["device"][0]):
            equal_sums(got["sums"], want["sums"], f"dispatch K4x grid {got['name']}: {path}")
    k4x = {p: o[1].get("event_loop_exact_packed", 0) for p, o in grid_out.items()}
    check(k4x["host_loop"] == k4x["device"] > 0
          and k4x["device"] <= k4x["pipelined"] <= k4x["device"] + 2 * len(grid3),
          f"dispatch K4x grid: launches by path {k4x}")
    check(all(set(o[1]) == {"event_loop_exact_packed"} for o in grid_out.values()),
          "dispatch K4x grid: other kernels launched")
    dispatch_launches["K4x grid"] = k4x
    print(f"[dispatch K4x grid] {len(grid3)} selfish-hashrate points x 256 runs x {BATCH_DAYS} "
          f"d through run_grid: host loop and pipelined rows == the device loop's; "
          f"event_loop_exact_packed launches by path {k4x}; on {card}")
    record["dispatch_launches"] = dispatch_launches

    # (ii) The xoroshiro default year (32,768 runs in batches of 8,192) in
    # run-years/s through the runner's depth-1 pipeline and hand loops of
    # run_batch on each path, in turns (A B C D D C B A), each form's
    # results equal to the others'.
    from tpusim_torch import profiling
    from tpusim_torch.runner import _zero_sums, run_simulation_config
    from tpusim_torch.stats import SimResults

    year_runs = xdcfg.runs * xdcfg.duration_ms / (365.2425 * 86_400_000)
    stall_by_run: list = []

    def year_form(form: str):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if form == "pipeline":
            rec = telemetry.TelemetryRecorder(OUT / "dispatch_spans.jsonl")
            res = run_simulation_config(xdcfg, device=dev, use_all_devices=False, telemetry=rec)
            rec.close()
        else:
            yeng = Engine(xdcfg, dev)
            kw = {} if form == "sequential" else {form: True}
            sums = None
            for start in range(0, xdcfg.runs, xdcfg.batch_size):
                out = yeng.run_batch(yeng.make_keys(start, xdcfg.batch_size), **kw)
                out = {k: v for k, v in out.items() if not k.startswith(("tele_", "stats_"))}
                sums = _zero_sums(out) if sums is None else sums
                for k in sums:
                    sums[k] = sums[k] + out[k]
            res = SimResults.from_sums(sums, xdcfg, mode=xdcfg.resolved_mode, elapsed_s=0.0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    forms = ("pipeline", "sequential", "pipelined", "host_loop")
    year_rate: dict[str, list] = {f: [] for f in forms}
    year_want = None
    (OUT / "dispatch_spans.jsonl").unlink(missing_ok=True)
    for form in forms + forms[::-1]:
        res, wall = year_form(form)
        got = {k: v for k, v in res.to_dict().items() if k not in wall_keys}
        year_want = got if year_want is None else year_want
        check(got == year_want, f"dispatch year: {form}'s results differ from the pipeline's")
        year_rate[form].append(year_runs / wall)
    for sp in telemetry.load_spans(OUT / "dispatch_spans.jsonl"):
        if sp["span"] == "batch":
            stall_by_run.append(sp["attrs"]["stall_s"])
    print(f"[dispatch year] xoroshiro default, {xdcfg.runs} runs x 1 year in batches of "
          f"{xdcfg.batch_size}, results equal in every form; run-years/s in turns "
          f"{ {f: [round(v, 1) for v in r] for f, r in year_rate.items()} }; the pipeline's "
          f"batch stall_s {stall_by_run}; on {card}")
    record["dispatch_year"] = dict(run_years_per_s=year_rate, stall_s=stall_by_run)

    # (iii) The device's idle share: one batch under Profiler.trace, the
    # union of the GPU kernels' intervals over the batch's window (a
    # record_function around it), device loop and pipelined, for the
    # xoroshiro default year and the threefry default at 30 days. The trace
    # of KEPT_TRACE stays for phase 15 to render, which then deletes it.
    KEPT_TRACE = "xoroshiro year, device loop"

    def idle_share(eng, keys, label: str, **kw) -> dict:
        tdir = OUT / "dispatch_trace" / label
        shutil.rmtree(tdir, ignore_errors=True)
        prof = profiling.Profiler(trace_dir=str(tdir))
        torch.cuda.synchronize()
        with prof.trace():
            with torch.profiler.record_function("tpusim_batch"):
                eng.run_batch(keys, **kw)
                torch.cuda.synchronize()
        files = list(tdir.glob("*.pt.trace.json"))
        check(len(files) == 1, f"idle share {label}: {len(files)} trace files")
        events = json.loads(files[0].read_text())["traceEvents"]
        win = [e for e in events if e.get("name") == "tpusim_batch" and e.get("ph") == "X"
               and not str(e.get("cat", "")).startswith("gpu")]
        check(len(win) == 1, f"idle share {label}: {len(win)} batch windows in the trace")
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        spans = {cat: sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in events
                             if e.get("cat") == cat and e.get("ph") == "X")
                 for cat in ("kernel", "gpu_memcpy", "gpu_memset")}

        def union(iv) -> float:
            total, end = 0.0, -math.inf
            for a, b in iv:
                if b <= max(a, end):
                    continue
                total += b - max(a, end)
                end = b
            return total

        busy = union(spans["kernel"])
        out = dict(window_ms=(w1 - w0) / 1e3, kernels=len(spans["kernel"]),
                   kernel_busy_ms=busy / 1e3,
                   idle_share=None if not spans["kernel"] else 1 - busy / (w1 - w0),
                   copy_ms=union(spans["gpu_memcpy"] + spans["gpu_memset"]) / 1e3,
                   trace_mb=files[0].stat().st_size / 2**20)
        if label != KEPT_TRACE:
            shutil.rmtree(tdir, ignore_errors=True)
        print(f"[idle share {label}] batch window {out['window_ms']:.1f} ms under the profiler, "
              f"{out['kernels']} GPU kernels busy {out['kernel_busy_ms']:.1f} ms (union): idle "
              + ("not measured (no device activity in the trace)" if out["idle_share"] is None
                 else f"{out['idle_share'] * 100:.2f} %") +
              f"; copies and fills {out['copy_ms']:.2f} ms; on {card}")
        return out

    idle = {}
    tcfg = dataclasses.replace(cfg, runs=8192, batch_size=8192, duration_ms=30 * 86_400_000)
    for label, icfg in (("xoroshiro year", dataclasses.replace(xdcfg, runs=8192)),
                        ("threefry 30 d", tcfg)):
        ieng = Engine(icfg, dev)
        ikeys = ieng.make_keys(0, 8192)
        for path, kw in (("device loop", {}), ("pipelined", {"pipelined": True})):
            idle[f"{label}, {path}"] = idle_share(ieng, ikeys, f"{label}, {path}", **kw)
    record["idle_share"] = idle
    stamp("dispatch paths")

    # -- 14. measurement harness ---------------------------------------------
    # (i) perf run: the full protocol, the six default scenarios at the
    # reference's shapes, through cli.main, the launch counts set to 0 just
    # before and read just after.
    import warnings

    from tpusim_torch import perf, profiling, roofline

    ledger = OUT / "perf_gpu.jsonl"
    ledger.unlink(missing_ok=True)
    for k in event_loop.launches:
        event_loop.launches[k] = 0
    xoroshiro.launches["xoroshiro_rows"] = 0
    t0 = time.perf_counter()
    check(cli.main(["perf", "run", "--out", str(ledger)]) == 0, "perf run failed")
    perf_s = time.perf_counter() - t0
    perf_launches = {k: v for k, v in {**event_loop.launches, **xoroshiro.launches}.items() if v}
    rows = perf.load_rows(ledger)
    check([r["scenario"] for r in rows] == [
        "chained_fast", "chained_exact", "chained_fast_yearlong", "sweep_sequential",
        "sweep_packed", "sweep_packed_ckpt", "sweep_packed_xoro"],
        f"perf run: rows {[r['scenario'] for r in rows]}")
    for r in rows:
        env = r["env"]
        check(env.get("platform") == "gpu" and env.get("device_kind") == kind
              and f"{env.get('gpu_name')}, {env.get('gpu_power_limit')}" == card,
              f"perf run: {r['scenario']}'s env names {env}, not {card}")
        check(r.get("protocol") == "full", f"perf run: {r['scenario']} not at the full shape")
        print(f"[perf {r['scenario']}] {r['value']:g} {r['unit']}, samples {r['samples']}"
              + (f", enqueue {r['enqueue_s_per_chunk']:g} s/chunk, {r['us_per_step']:g} us/step"
                 if "enqueue_s_per_chunk" in r else f", speedup {r.get('speedup_x')}")
              + f"; shape {r['shape']}; on {env['gpu_name']}, {env['gpu_power_limit']}")
    for kernel in ("event_loop_fast", "event_loop_exact", "event_loop_exact_packed",
                   "xoroshiro_rows", "event_loop_exact_consumed",
                   "event_loop_exact_consumed_packed"):
        check(perf_launches.get(kernel, 0) > 0, f"perf run: {kernel} never launched")
    print(f"[perf] 7 rows from the full protocol in {perf_s:.1f} s, launches {perf_launches}; "
          f"on {card}")
    # (ii) The noise gate: the ledger against itself passes; against a copy
    # whose chained_exact row (and its samples) is slowed, it fails; the
    # report renders. The gate flags a ratio above 1 + its margin, the
    # margin being max(25 %, 2 x the samples' relative spread); a
    # host-paced chain can spread past 50 % (0.0069-0.0112 s in one call),
    # and at a margin of 1 or more a 2x regression is within it: the copy
    # is slowed 2x, or 1 + twice the margin where the margin reaches 1.
    check(cli.main(["perf", "compare", str(ledger), str(ledger)]) == 0, "perf compare: self")
    ex = next(r for r in rows if r["scenario"] == "chained_exact")["samples"]
    margin = max(0.25, 2 * (max(ex) - min(ex)) / min(ex))
    slow = 2.0 if margin < 1.0 else 1 + 2 * margin
    worse = [dict(r, value=slow * r["value"], samples=[slow * x for x in r["samples"]])
             if r["scenario"] == "chained_exact" else r for r in rows]
    (OUT / "perf_gpu_2x.jsonl").write_text("".join(json.dumps(r) + "\n" for r in worse))
    check(cli.main(["perf", "compare", str(ledger), str(OUT / "perf_gpu_2x.jsonl")]) == 1,
          f"perf compare: a {slow:.2f}x regression of chained_exact passed the gate")
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        check(cli.main(["perf", "report", str(ledger)]) == 0, "perf report failed")
    check(all(f"== {r['scenario']} ==" in report.getvalue() for r in rows), "perf report")
    print(f"[perf] compare: self exit 0, chained_exact slowed {slow:.2f}x (margin {margin:.2f}) "
          f"exit 1; report renders")
    # (iii) The chain of (i) at 64 runs x 2 chunks x 256 steps, fast and
    # exact, threefry and xoroshiro, on the card and on the CPU: state,
    # counters (and the streams and consumed counts) and checksum key for key.
    chain_cfgs = {
        "fast": SimConfig(network=default_network(), runs=64, batch_size=64, seed=7,
                          chunk_steps=256, state_dtype="int32", count_rebase=False),
        "exact": SimConfig(network=selfish_net, runs=64, batch_size=64, seed=7,
                           chunk_steps=256, state_dtype="int32", count_rebase=False),
    }
    chain_sums = {}
    for (mode, ccfg), rng in ((m, r) for m in chain_cfgs.items()
                              for r in ("threefry", "xoroshiro")):
        ccfg = dataclasses.replace(ccfg, rng=rng)
        got = [profiling.chained_chunks(e, e.make_keys(0, 64), 2)
               for e in (Engine(ccfg, dev), Engine(ccfg, "cpu"))]
        (gs, ga, gf), (ws, wa, wf) = got
        for name, g, w in [*zip(gs._fields, gs, ws), *(
                (f"aux {i}", g, w) for i, (g, w) in enumerate(zip(
                    (*ga[0], *ga[3:]), (*wa[0], *wa[3:]))))]:
            check((g is None) == (w is None) and (g is None or torch.equal(g.cpu(), w)),
                  f"chain {mode} {rng}: {name} differs between the card and the CPU")
        check(int(gf) == int(wf), f"chain {mode} {rng}: checksum {int(gf)} != {int(wf)}")
        chain_sums[f"{mode} {rng}"] = int(gf)
    print(f"[perf chain] 64 runs x 2 chunks x 256 steps: card == CPU key for key (state, "
          f"counters, streams) in fast and exact, threefry and xoroshiro; checksums "
          f"{chain_sums}")
    # (iv) Roofline points at the main path's width and chunk budget, the copy
    # probe beside them, and the chain under the sync debug mode.
    rl_steps = Engine(cfg, dev).chunk_steps
    with contextlib.redirect_stdout(io.StringIO()):  # its summary line is JSON
        rl_rc = roofline.main(["--batch-list", "8192", "--chunk-steps", str(rl_steps),
                               "--n-chunks", "4", "--repeats", "3", "--packed-days", "0",
                               "--out", str(OUT / "roofline_gpu.json"),
                               "--md", str(OUT / "roofline.md")])
    check(rl_rc == 0, "roofline failed")
    doc = json.loads((OUT / "roofline_gpu.json").read_text())
    check(0 < doc["bandwidth_gbps"] <= 1.05 * HBM_BYTES_PER_S / 1e9,
          f"copy probe read {doc['bandwidth_gbps']} GB/s, over 105 % of the HBM3 peak")
    check(len(doc["points"]) == 4 and all(0 < p["fraction_of_roof"] <= 1.05
                                          for p in doc["points"]),
          f"roofline points: {[p.get('fraction_of_roof') for p in doc['points']]}")
    for pt in doc["points"]:
        print(f"[roofline {pt['mode']} {pt['state_dtype']}{'+rebase' if pt['count_rebase'] else ''}"
              f"] {pt['runs']} runs x {pt['chunk_steps']} steps: {pt['s_per_chunk']:g} s/chunk "
              f"(enqueue {pt['enqueue_s_per_chunk']:g}), {pt['us_per_step']:g} us/step, "
              f"{pt['events_per_s']:,.0f} events/s, {pt['bytes_per_event']} bytes/event, roof "
              f"{pt['roof_events_per_s']:,.0f}: {100 * pt['fraction_of_roof']:.3f} % of it; "
              f"on {card}")
    syncs = {}
    for mode in ("fast", "exact"):
        seng = Engine(cfg if mode == "fast" else scfg, dev)
        skeys = seng.make_keys(0, 8192)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                forced = profiling.chained_chunks(seng, skeys, 2)[2]
            finally:
                torch.cuda.set_sync_debug_mode(0)
        int(forced)
        syncs[mode] = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                       if "synchroniz" in str(w.message)]
    print(f"[roofline] copy probe {doc['bandwidth_gbps']} GB/s "
          f"({100 * doc['bandwidth_gbps'] * 1e9 / HBM_BYTES_PER_S:.1f} % of the HBM3 peak); "
          f"implicit syncs in a 2-chunk chain of 8,192 runs by the sync debug mode, where "
          f"called: {syncs}; "
          f"on {card}")
    record["perf"] = dict(
        seconds=perf_s, launches=perf_launches, chain_checksums=chain_sums, syncs=syncs,
        rows=[{k: r[k] for k in ("scenario", "value", "unit", "samples", "shape") if k in r}
              | {k: r[k] for k in ("enqueue_s_per_chunk", "us_per_step", "spread_pct",
                                   "speedup_x", "sequential_best") if k in r} for r in rows],
        roofline=doc)
    stamp("measurement harness")

    # -- 15. fast mode on a selfish roster, and the dashboards ---------------
    # (i) The fast kernel's selfish form against its plain version: K1s and
    # K3fs at 1,000 runs with ragged ends, K4fs (and with the ring) on
    # per-run flags with one lane group wholly honest, a batch and card ==
    # CPU; then the main-path chunks (8,192 runs x 1,856 steps), timed and
    # counted.
    fs_cfg = SimConfig(network=selfish_net, mode="fast")
    err_fs = max(
        compare_variants("event_loop_fast_selfish", (
            ("int16", True, selfish_net), ("int32", False, hetero_selfish)), "fast"),
        compare_variants("event_loop_fast_selfish_flight", (
            ("int16", True, selfish_net), ("auto", True, hetero_selfish)), "fast",
            capacities=(64,)))
    err_fsp = max(
        compare_packed("event_loop_fast_selfish_packed", (
            ("fast_selfish", 9, "auto", True), ("fast_selfish", 4, "int32", False))),
        compare_packed("event_loop_fast_selfish_packed_flight", (
            ("fast_selfish", 9, "auto", True),), capacity=64))
    compare_batch("event_loop_fast_selfish", selfish_net, mode="fast")
    card_equals_cpu("event_loop_fast_selfish", selfish_net, runs=256, mode="fast")
    card_equals_cpu("event_loop_fast_selfish_flight", selfish_net, capacity=1024, mode="fast")
    stats["event_loop_fast_selfish"] = main_chunk(
        "event_loop_fast_selfish", Engine(fs_cfg, dev), "event_loop_fast_selfish")
    stats["event_loop_fast_selfish_flight"] = main_chunk(
        "event_loop_fast_selfish_flight",
        Engine(dataclasses.replace(fs_cfg, flight_capacity=1024), dev),
        "event_loop_fast_selfish_flight")
    fs_grid = [(n, dataclasses.replace(c, mode="fast"))
               for n, c in grids["selfish-hashrate"]()[4:8]]
    stats["event_loop_fast_selfish_packed"] = main_chunk(
        "event_loop_fast_selfish_packed", packed_engine([c for _, c in fs_grid], [2048] * 4),
        "event_loop_fast_selfish_packed selfish-hashrate")
    for name, err in (("event_loop_fast_selfish", err_fs),
                      ("event_loop_fast_selfish_flight", err_fs),
                      ("event_loop_fast_selfish_packed", err_fsp)):
        stats[name]["max_abs_err"] = max(err, stats[name]["max_abs_err"])
    print(f"[fast selfish] K1s {stats['event_loop_fast_selfish']['ms']:.3f} ms a busy chunk "
          f"against K1 {stats['event_loop_fast']['ms']:.3f} and K2s "
          f"{stats['event_loop_exact']['ms']:.3f}; K4fs "
          f"{stats['event_loop_fast_selfish_packed']['ms']:.3f} against K4f "
          f"{stats['event_loop_fast_packed']['ms']:.3f} (the propagation sweep's fast mix); "
          f"K3fs {stats['event_loop_fast_selfish_flight']['ms']:.3f} against K3f "
          f"{stats['event_loop_fast_flight']['ms']:.3f}; in this run, on {card}")
    for name in ("event_loop_fast_selfish", "event_loop_fast_selfish_packed"):
        c = stats[name]["chunk_selfish"]
        print(f"[fast selfish] {name}: a busy chunk's {c['warp_steps']} warp-steps, "
              f"{c['reveal_warp_steps']} ({c['reveal_warp_steps'] / c['warp_steps']:.2%}) in "
              f"which a run reveals ({c['reveals']} reveal pushes), "
              f"{c['private_warp_steps']} ({c['private_warp_steps'] / c['warp_steps']:.2%}) "
              "in which a run holds a private block or finds selfishly")

    # (ii) The main paths: the fast selfish year (K1s) through
    # api.run_simulation, miner 0's share and stale rate the exact year's
    # (the fast approximation differs only in the honest miners' stale
    # counts); the trace command at --mode fast (K3fs) with --telemetry; the
    # selfish-hashrate grid's 37-46 % points at --mode fast, sequential
    # (K1s) and packed (K4fs), rows equal, each with --telemetry.
    res_fs, fs_launches, _ = main_path("event_loop_fast_selfish", fs_cfg,
                                       "event_loop_fast_selfish")
    check(abs(res_fs.miners[0].blocks_share_mean - 0.4668) < 0.01,
          f"fast selfish: miner 0's share {res_fs.miners[0].blocks_share_mean}")
    check(abs(res_fs.miners[0].stale_rate_mean - 0.2747) < 0.005,
          f"fast selfish: miner 0's stale rate {res_fs.miners[0].stale_rate_mean}")
    print(f"[main event_loop_fast_selfish] selfish miner 0 (40 %): share "
          f"{res_fs.miners[0].blocks_share_mean * 100:.4f} %, stale rate "
          f"{res_fs.miners[0].stale_rate_mean * 100:.4f} % (exact year: "
          f"{res_s.miners[0].blocks_share_mean * 100:.4f} %, "
          f"{res_s.miners[0].stale_rate_mean * 100:.4f} %); on {card}")
    fdir = OUT / "fast_selfish"
    shutil.rmtree(fdir, ignore_errors=True)
    fdir.mkdir()
    for k in event_loop.launches:
        event_loop.launches[k] = 0
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        rc = cli.main(["trace", "--mode", "fast"] + trace_flags + [
            "--device", "cuda", "--flight-capacity", "1024", "--quiet",
            "--trace-out", str(fdir / "trace.json"), "--telemetry", str(fdir / "trace.jsonl")])
    check(rc == 0, f"trace --mode fast exited {rc}")
    fs_trace_launches = event_loop.launches["event_loop_fast_selfish_flight"]
    others = {k: v for k, v in event_loop.launches.items()
              if v and k != "event_loop_fast_selfish_flight"}
    check(fs_trace_launches > 0 and not others,
          f"trace --mode fast: K3fs {fs_trace_launches} launches, others {others}")
    fs_trace = json.loads((fdir / "trace.json").read_text())
    n_fs = flight_export.validate_perfetto(fs_trace)
    trace_spans = telemetry.load_spans(fdir / "trace.jsonl")
    check([(sp["span"], sp["run_id"]) for sp in trace_spans]
          == [("trace", fs_trace["otherData"]["run_id"])]
          and trace_spans[0]["attrs"]["events"] == n_fs > 0,
          f"trace --telemetry: {trace_spans}")
    print(f"[trace fast selfish] {trace_runs} runs x {trace_days} d: {n_fs} events, K3fs "
          f"launched {fs_trace_launches} times; its span ledger holds the trace span with "
          f"the trace's run_id; on {card}")
    _Dispatch.__call__ = logged_run_batch
    try:
        fs_seq, fs_seq_l = sweep_path(fs_grid, False, "fast selfish sequential",
                                      telemetry_path=fdir / "sweep_seq.jsonl")
        launched_once_per_chunk(fs_seq_l, "fast selfish sweep",
                                {"event_loop_fast_selfish": False})
        fs_pk, fs_pk_l = sweep_path(fs_grid, True, "fast selfish packed",
                                    telemetry_path=fdir / "sweep_packed.jsonl")
        launched_once_per_chunk(fs_pk_l, "fast selfish packed sweep",
                                {"event_loop_fast_selfish_packed": False})
    finally:
        _Dispatch.__call__ = real_run_batch
    fs_packed_launches = fs_pk_l["event_loop_fast_selfish_packed"]
    strip = lambda rows: [{k: v for k, v in r.items() if k not in ("elapsed_s", "compile_s")}
                          for r in rows]
    check(strip(fs_pk) == strip(fs_seq), "fast selfish: packed rows differ from sequential")
    for name in ("sweep_seq", "sweep_packed"):
        sp = telemetry.load_spans(fdir / f"{name}.jsonl")
        points = [x["attrs"]["point"] for x in sp if x["span"] == "sweep_point"]
        check(points == [n for n, _ in fs_grid] and len({x["run_id"] for x in sp}) == 1,
              f"{name} ledger: points {points}")
    print(f"[sweep fast selfish] {len(fs_grid)} points: packed rows == sequential rows; "
          f"K4fs launched {fs_packed_launches} times; both span ledgers hold a sweep_point "
          f"span a point under one run_id; on {card}")

    # (iii) A fresh process: the CLI's fast selfish run with --telemetry
    # opens its kernel's library (loaded from the build directory), so its
    # ledger holds the compile span and the run span the ledger's totals.
    fs_ledger = fdir / "cli.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "tpusim_torch", "--hashrates", "40,19,12,11,8,5,3,1,1",
         "--selfish", "0", "--mode", "fast", "--runs", "8192", "--days", "30", "--quiet",
         "--single-device", "--telemetry", str(fs_ledger)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"the fast selfish CLI run failed: {proc.stderr[-2000:]}")
    cli_spans = telemetry.load_spans(fs_ledger)
    compiles = [sp for sp in cli_spans if sp["span"] == "compile"]
    check([sp["attrs"]["event"] for sp in compiles] == ["event_loop_fast_selfish-m9-k2"]
          and compiles[0]["attrs"]["built"] is False,
          f"compile spans: {[sp['attrs'] for sp in compiles]}")
    cli_run_span = [sp for sp in cli_spans if sp["span"] == "run"][-1]["attrs"]
    check(cli_run_span["compiles"] == 1, f"run span: {cli_run_span.get('compiles')} compiles")
    print(f"[telemetry] a fresh process's ledger: compile span "
          f"{compiles[0]['attrs']['event']} {compiles[0]['dur_s'] * 1e3:.1f} ms (loaded, not "
          f"built), {sum(sp['span'] == 'batch' for sp in cli_spans)} batch spans; on {card}")

    # (iv) The dashboards on the card's ledgers and traces: report on phase
    # 12's ledger, on the sweeps' and the trace's ledgers and on phase 13's
    # kept --trace-dir (the card's kernels, the hand-written ones by name,
    # among its top ops); watch --once; trace timeline on the smoke's
    # ledgers (no fleet: exit 2, the reference's rule) and on the fresh
    # run's ledger as one worker of a fleet.
    def dashboard(argv: list[str], rc_want: int = 0) -> str:
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        check(rc == rc_want, f"{' '.join(argv[:2])}: exit {rc} ({err.getvalue()[-500:]})")
        return out.getvalue() + err.getvalue()

    ci_ledger = OUT / "run_until_confident" / "spans.jsonl"
    text = dashboard(["report", str(ci_ledger)])
    check("Convergence (stats spans)" in text and "CI narrowing" in text,
          "report of phase 12's ledger")
    for name in ("sweep_seq", "sweep_packed", "trace", "cli"):
        text = dashboard(["report", str(fdir / f"{name}.jsonl"), "--format", "md"])
        check(text.startswith("# tpusim telemetry report"), f"report of the {name} ledger")
    check("XLA compiles & engine cache" in dashboard(["report", str(fs_ledger)]),
          "report: the compile panel")
    frame = dashboard(["watch", "--once", str(ci_ledger)])
    check(frame.startswith("tpusim watch — ") and "COMPLETED" in frame, "watch --once")
    tdir = OUT / "dispatch_trace" / KEPT_TRACE
    text = dashboard(["report", str(tdir), "--top", "10"])
    top = [ln for ln in text.splitlines() if "%  x" in ln]
    check("summed on device tracks" in text and any("event_loop_kernel" in ln for ln in top)
          and any("xoro_rows_kernel" in ln for ln in top),
          f"report of the trace dir: {text[:2000]}")
    shutil.rmtree(OUT / "dispatch_trace", ignore_errors=True)
    (OUT / "fast_selfish_trace_report.txt").write_text(text)
    print("[report] the trace dir's top ops on the card:\n" + "\n".join(top[:6]))
    dashboard(["trace", "timeline", str(fdir)], rc_want=2)
    fleet_dir = fdir / "fleet"
    fleet_dir.mkdir()
    (fleet_dir / "worker.jsonl").write_text("".join(json.dumps(sp) + "\n" for sp in (
        dict(sp, trace_id="smokefleet", parent_span="w000") for sp in cli_spans)))
    t_first = min(sp["t_mono"] - sp["dur_s"] for sp in cli_spans)
    t_last = max(sp["t_mono"] for sp in cli_spans)
    offset = cli_spans[0]["t_start"] + cli_spans[0]["dur_s"] - cli_spans[0]["t_mono"]
    sup = [dict(run_id="smokefleet", span=span, t_start=round(offset + t, 6),
                t_mono=round(t, 6), dur_s=0.0, schema=2, process="psup",
                trace_id="smokefleet", attrs=attrs)
           for span, t, attrs in (
               ("fleet_spawn", t_first - 0.5, {"worker": "w000", "target": "fast-selfish",
                                               "attempt": 0}),
               ("fleet_done", t_last + 0.1, {"worker": "w000", "target": "fast-selfish",
                                             "attempt": 0}))]
    (fleet_dir / "supervisor.jsonl").write_text("".join(json.dumps(sp) + "\n" for sp in sup))
    text = dashboard(["trace", "timeline", str(fleet_dir), "--out", str(fdir / "timeline.json")])
    # The library's load is a compile slice on the worker's host track; it
    # falls inside the batch's host stall, so the critical path need not
    # show it.
    timeline = json.loads((fdir / "timeline.json").read_text())["traceEvents"]
    check("Wall-clock attribution" in text and "dispatch" in text
          and any(ev.get("name") == "compile" and ev.get("tid") == 2 for ev in timeline),
          f"trace timeline: {text[:2000]}")
    print("[timeline] the fresh run's ledger as one worker: " + " ".join(
        ln.strip() for ln in text.splitlines() if "attributed" in ln))
    record["fast_selfish"] = dict(
        launches=dict(year=fs_launches, trace=fs_trace_launches, packed=fs_packed_launches),
        results=res_fs.to_dict(), trace_events=n_fs)
    stamp("fast selfish and the dashboards")
    # -- 16. the per-event xoroshiro draw (X2r), the chaos and provenance planes
    # (i) X2r against its plain version at CMP_STEPS in each form the paths
    # launch, from a mid-run state with ragged ends; the fast and exact
    # main-path chunks on PLAIN_RUNS, timed, each key for key the X1 + X2
    # chunk of the same streams, its bound K1's or K2s's counted operations
    # (phase 11's X2 chunk is the same chunk) plus each find's draws and
    # mappings (``x2r_pipes``).
    from tpusim_torch import perf as perf_mod
    from tpusim_torch import provenance
    from tpusim_torch.chaos import as_injector
    from tpusim_torch.event_loop import XoroDraw

    def x2r_args(e, state, aux, cap):
        """An X2r engine's event-loop arguments and keywords for the chunk
        after ``state``, ``aux``."""
        ctr, fr = aux[:2]
        prop, selfish = e.roster()
        kw = dict(onehot=not e.config.consensus_gather,
                  xoro=XoroDraw(aux[3], e.xoro_sampler(), e.chunk_steps))
        return (None, cap, prop, state_to_kernel(state), counters_to_kernel(ctr), selfish,
                None if fr is None else flight_to_kernel(fr)), kw

    @timed_helper
    def compare_x2r(kernel: str, e) -> int:
        keys = e.make_keys(0, RUNS_CMP)
        st, ax = e._init(keys)
        st, ax, _ = e._chunk(st, ax, tcap, keys, 0)
        args, kw = x2r_args(e, st, ax, ragged_cap)
        before = dict(event_loop.launches)
        got = event_loop.event_loop_chunk(*args, **kw)
        check(event_loop.launches[kernel] == before[kernel] + 1, f"{kernel}: not launched")
        err = max_abs_err(got, event_loop_chunk_plain(*args, **kw), f"{kernel} 1000-run chunk")
        check(bool((got[3] != ax[3]).any()), f"{kernel}: no stream moved")
        return err

    x2r = dict(rng="xoroshiro", rng_batch=False)
    x2r_cmp = {}
    cmp16 = dict(duration_ms=CMP_DAYS * 86_400_000, chunk_steps=CMP_STEPS, **x2r)
    for kernel, ecfg in (
        ("event_loop_fast_xoro", dataclasses.replace(cfg, **cmp16)),
        ("event_loop_exact_xoro", dataclasses.replace(scfg, **cmp16)),
        ("event_loop_exact_xoro", SimConfig(network=default_network(10_000), **cmp16)),
        ("event_loop_fast_xoro_flight", dataclasses.replace(cfg, flight_capacity=64, **cmp16)),
        ("event_loop_exact_xoro_flight", dataclasses.replace(scfg, flight_capacity=64,
                                                             **cmp16)),
        ("event_loop_fast_xoro_onehot", dataclasses.replace(cfg, consensus_gather=False,
                                                            **cmp16)),
        ("event_loop_exact_xoro_onehot", dataclasses.replace(scfg, consensus_gather=False,
                                                             **cmp16)),
        ("event_loop_fast_wide_xoro", SimConfig(network=default_network(hashrates=H32),
                                                **cmp16)),
        ("event_loop_exact_wide_xoro", SimConfig(network=default_network(hashrates=H32),
                                                 mode="exact", **cmp16)),
    ):
        x2r_cmp[f"{kernel} {ecfg.network.n_miners} {ecfg.network.miners[0].propagation_ms}"] = \
            compare_x2r(kernel, Engine(ecfg, dev))
    for v, cap in (("_packed_flight", 64), ("_packed", 0)):
        pk = [dataclasses.replace(c, flight_capacity=cap, **cmp16)
              for c in lane_configs("selfish", 9)]
        x2r_cmp[f"event_loop_exact_xoro{v}"] = compare_x2r(
            f"event_loop_exact_xoro{v}", packed_engine(pk, [RUNS_CMP // 4] * 4))
    print(f"[X2r] one chunk at {RUNS_CMP} runs x {CMP_STEPS} steps (ragged ends, from a mid-run "
          f"state) == the plain version, max |err| 0, in every form: {sorted(x2r_cmp)}")

    @timed_helper
    def x2r_main_chunk(kernel: str, me, x2: dict, label: str) -> dict:
        """X2r's main-path chunk (chunk 1 after chunk 0) on engine ``me``:
        its plain version on PLAIN_RUNS, timed, key for key the X1 + X2
        chunk of the same streams (``x2``, phase 11's stats of that chunk,
        gives its counted operations), and its bound."""
        runs, m = me.config.batch_size, me.n_miners
        mkeys = me.make_keys(0, runs)
        mcap = torch.full((runs,), 2**29, dtype=torch.int32, device=dev)
        state, aux = me._chunk(*me._init(mkeys), mcap, mkeys, 0)[:2]
        args, kw = x2r_args(me, state, aux, mcap)
        got = event_loop.event_loop_chunk(*args, **kw)
        cut = lambda x: x[..., :PLAIN_RUNS].contiguous() if torch.is_tensor(x) and (
            x.shape[-1] == runs) else x
        sub = tuple(tuple(cut(x) for x in a) if isinstance(a, tuple) else cut(a) for a in args)
        kw_sub = dict(kw, xoro=kw["xoro"]._replace(streams=aux[3][:PLAIN_RUNS].contiguous()))
        want, plain_ms = timed_once(torch, lambda: event_loop_chunk_plain(*sub, **kw_sub))
        err = max_abs_err(event_loop.event_loop_chunk(*sub, **kw_sub), want,
                          f"{kernel} main-path chunk, first {PLAIN_RUNS} runs")
        err = max(err, max_abs_err(
            (tuple(cut(x) for x in got[0]), tuple(cut(x) for x in got[1]), None,
             got[3][:PLAIN_RUNS]), want, f"{kernel} against its own first {PLAIN_RUNS} runs"))
        kernel_ms = timed(torch, lambda: event_loop.event_loop_chunk(*args, **kw), repeat=5)
        # The same chunk through X1 and X2 (the batched path), from the same
        # keys: every leaf, and X1's streams advanced by X2's counts.
        be = Engine(dataclasses.replace(me.config, rng_batch=True), dev)
        bstate, baux = be._chunk(*be._init(mkeys), mcap, mkeys, 0)[:2]
        bargs = chunk_args(be, mkeys, bstate, baux, 1, mcap)
        bgot = event_loop.event_loop_chunk(*bargs, **loop_kw(be))
        max_abs_err(got[:3], bgot[:3], f"{kernel} against X1 + X2 on the same streams")
        check(torch.equal(got[3], xoroshiro.xoro_rows(aux[3], bgot[3], me.xoro_sampler(), 1)[1]),
              f"{kernel}: streams differ from their advance by X2's counts")
        active = int((got[1][2].long() - counters_to_kernel(aux[0])[2].long()).sum())
        finds = int(bgot[3].long().sum())
        check((active, finds) == (x2["chunk_active_events"], x2["chunk_finds"]),
              f"{kernel}: not phase 11's X2 chunk ({active}, {finds})")
        # The finds' interval words on log1p's k = 0 path: each run's first
        # c rows of X1 from the chunk's streams are its c consumed draws.
        rows = xoroshiro.xoro_rows(aux[3], torch.zeros_like(bgot[3]), me.xoro_sampler(),
                                   me.chunk_steps)[0]
        taken = torch.arange(me.chunk_steps, device=dev)[:, None] < bgot[3].long()[None]
        k0 = int(((rows[:, 1].double() < XORO_K0_LOG * me.config.network.block_interval_s
                   * 1e3) & taken).sum())
        alu, fma, fp64 = x2r_pipes(m, finds, k0)
        prop, leaves, counters = args[2], args[3], args[4]
        nbytes = sum(x.numel() * x.element_size() for x in (mcap, prop, *kw["xoro"].sampler))
        nbytes += 2 * sum(x.numel() * x.element_size()
                          for x in (*leaves, *counters, kw["xoro"].streams))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops = x2["chunk_ops"] + alu + fma
        ops_ms = (ops / INT32_OPS_PER_S + fp64 / (FP64_FLOPS_PER_S / 2)) * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        regs = lambda name: max(record.get(f"build_{name}_m{m}_k2", {}).get("registers") or [0])
        old_ms, old_regs = X2R_PER_FIND_MAP[kernel]
        print(f"[{label}] main-path chunk ({runs} runs x {me.chunk_steps} steps, {active} "
              f"active events, {finds} finds, {k0} interval words on log1p's k = 0 path): "
              f"kernel {kernel_ms:.3f} ms, {regs(kernel)} registers (X1 + X2 in phase 11: "
              f"{stats['xoroshiro_rows']['ms']:.3f} + {x2['ms']:.3f} ms, "
              f"{regs(kernel.replace('_xoro', '_consumed'))} registers in X2; the per-find "
              f"map's design {old_ms:.3f} ms, {old_regs} "
              f"registers), plain "
              f"{plain_ms:.1f} ms on its first {PLAIN_RUNS} runs, == X1 + X2 key for key; "
              f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB -> "
              f"{bytes_ms:.4f} ms; {ops} int32 ops and {fp64} FP64 instructions -> "
              f"{ops_ms:.4f} ms); on {card}")
        return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, plain_runs=PLAIN_RUNS,
                    registers=regs(kernel), bound_ms=bound_ms, bound_by=bound_by,
                    chunk_active_events=active,
                    chunk_finds=finds, chunk_k0_words=k0, chunk_bytes=nbytes, chunk_ops=ops,
                    chunk_fp64=fp64, bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms)

    x2rf_cfg = dataclasses.replace(xdcfg, rng_batch=False)
    x2rs_cfg = dataclasses.replace(xcfg, rng_batch=False)
    stats["event_loop_fast_xoro"] = x2r_main_chunk(
        "event_loop_fast_xoro", Engine(x2rf_cfg, dev), stats["event_loop_fast_consumed"],
        "event_loop_fast_xoro")
    stats["event_loop_exact_xoro"] = x2r_main_chunk(
        "event_loop_exact_xoro", Engine(x2rs_cfg, dev), stats["event_loop_exact_consumed"],
        "event_loop_exact_xoro selfish")
    for name in ("event_loop_fast_xoro", "event_loop_exact_xoro"):
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], *x2r_cmp.values())

    # (ii) X2r against X1 + X2, 256 runs x 2 days, on each dispatch path.
    x2r_paths = {}
    for roster, base in (("default", xdcfg), ("selfish", xcfg)):
        bcfg = dataclasses.replace(base, runs=256, batch_size=256,
                                   duration_ms=BATCH_DAYS * 86_400_000)
        want_e = Engine(bcfg, dev)
        keys = want_e.make_keys(0, 256)
        want = want_e.run_batch(keys)
        xe16 = Engine(dataclasses.replace(bcfg, rng_batch=False), dev)
        sharded = Engine(dataclasses.replace(bcfg, rng_batch=False), devices=[dev] * 4)
        kernel = f"event_loop_{'exact' if roster == 'selfish' else 'fast'}_xoro"
        for path, call in (("device", lambda: xe16.run_batch(keys)),
                           ("pipelined", lambda: xe16.run_batch(keys, pipelined=True)),
                           ("host_loop", lambda: xe16.run_batch(keys, host_loop=True)),
                           ("async", lambda: xe16.run_batch_async(keys)()),
                           ("sharded", lambda: sharded.run_batch(keys))):
            for k in event_loop.launches:
                event_loop.launches[k] = 0
            x1_before = xoroshiro.launches["xoroshiro_rows"]
            got = call()
            launched = {k: v for k, v in event_loop.launches.items() if v}
            check(list(launched) == [kernel] and
                  xoroshiro.launches["xoroshiro_rows"] == x1_before,
                  f"X2r {roster} {path}: launches {launched}, X1 launched")
            equal_sums(got, want, f"X2r {roster} {path} against X1 + X2")
            x2r_paths[f"{roster} {path}"] = launched[kernel]
    print(f"[X2r] 256 runs x {BATCH_DAYS} d, default and selfish, on the device loop, "
          f"pipelined, host loop, async and 4 shards: == X1 + X2 key for key, X2r alone "
          f"launched (per path {x2r_paths}); on {card}")
    stamp("X2r against its plain versions and X1 + X2")

    # (iii) The two xoroshiro years at rng_batch=False, timed: equal to
    # phase 11's rng_batch=True years; and the sums at 256 runs x 30 days
    # equal to the native oracle's.
    res_rs, x2r_launches_s, _ = main_path("event_loop_exact_xoro", x2rs_cfg,
                                          "event_loop_exact_xoro selfish")
    res_rd, x2r_launches_f, _ = main_path("event_loop_fast_xoro", x2rf_cfg,
                                          "event_loop_fast_xoro")
    strip = lambda r: dataclasses.replace(r, elapsed_s=None, compile_s=None)
    check(strip(res_rs) == strip(res_xs), "X2r selfish year differs from the X1 + X2 year")
    check(strip(res_rd) == strip(res_xd), "X2r default year differs from the X1 + X2 year")
    for roster, base in (("selfish", x2rs_cfg), ("default", x2rf_cfg)):
        ncfg = dataclasses.replace(base, runs=256, batch_size=256, duration_ms=30 * 86_400_000)
        ne = Engine(ncfg, dev)
        got = ne.run_batch(ne.make_keys(0, 256))
        want = native.run_simulation_cpp(ncfg)
        for key, field in (("blocks_found_sum", "blocks_found_mean"),
                           ("stale_blocks_sum", "stale_blocks_mean")):
            check(np.array_equal(got[key], [round(getattr(m, field) * 256)
                                            for m in want.miners]),
                  f"X2r {roster}: {key} differs from the native oracle's")
        check(int(got["best_height_sum"]) == round(want.best_height_mean * 256),
              f"X2r {roster}: best height differs from the native oracle's")
    print(f"[X2r years] selfish and default, 32,768 runs x 1 year at rng_batch=False: results "
          f"== the rng_batch=True years', X2r once a chunk ({x2r_launches_s}, {x2r_launches_f} "
          f"launches) and no X1; 256 runs x 30 d == the native oracle's sums; on {card}")
    # The device's idle share of one 8,192-run batch of each X2r year on the
    # device loop (phase 13 measures X1 + X2's default year the same way).
    for label, icfg in (("X2r selfish year", x2rs_cfg), ("X2r default year", x2rf_cfg)):
        ieng = Engine(dataclasses.replace(icfg, runs=8192), dev)
        idle[f"{label}, device loop"] = idle_share(ieng, ieng.make_keys(0, 8192),
                                                   f"{label}, device loop")
    record["idle_share"] = idle
    stamp("X2r years")

    # (iv) The committed drills through the port's CLI on the card.
    ddir = OUT / "drills"
    shutil.rmtree(ddir, ignore_errors=True)
    ddir.mkdir()
    drill_run = ["--runs", "4096", "--batch-size", "1024", "--days", "2", "--quiet",
                 "--single-device"]
    strip_json = lambda p: {k: v for k, v in json.loads(p.read_text()).items()
                            if k not in ("elapsed_s", "compile_s")}
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli.main(drill_run + ["--json", str(ddir / "clean.json")]) == 0, "clean run")
    plan = ddir / "dispatch.json"
    plan.write_text(json.dumps({"faults": [{"point": "engine.dispatch", "kind": "transient",
                                            "when": {"batch": 1}}]}))
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli.main(drill_run + ["--chaos", str(plan), "--telemetry",
                                    str(ddir / "dispatch.jsonl"),
                                    "--json", str(ddir / "dispatch_out.json")]) == 0,
              "engine.dispatch drill")
    drill_spans = [sp["span"] for sp in telemetry.load_spans(ddir / "dispatch.jsonl")
                   if sp["span"] in ("chaos", "retry")]
    check(drill_spans == ["chaos", "retry"] and
          strip_json(ddir / "dispatch_out.json") == strip_json(ddir / "clean.json"),
          f"engine.dispatch drill: spans {drill_spans}, or results differ")
    ck = ddir / "ck.npz"
    killed = subprocess.run(
        [sys.executable, "-m", "tpusim_torch", *drill_run, "--checkpoint", str(ck),
         "--chaos", str(ROOT / "drills" / "sigkill-pre-replace.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(killed.returncode == -9 and ck.with_suffix(".tmp.npz").exists() and not ck.exists(),
          f"sigkill-pre-replace: exit {killed.returncode}: {killed.stderr[-2000:]}")
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli.main(drill_run + ["--checkpoint", str(ck), "--json",
                                    str(ddir / "resumed.json")]) == 0, "re-run after SIGKILL")
    check(not ck.with_suffix(".tmp.npz").exists() and
          strip_json(ddir / "resumed.json") == strip_json(ddir / "clean.json"),
          "sigkill-pre-replace: the re-run differs from the clean run")
    hcfg16 = dataclasses.replace(cfg, runs=1024, batch_size=1024,
                                 duration_ms=BATCH_DAYS * 86_400_000)
    he = Engine(hcfg16, dev)
    hkeys = he.make_keys(0, 1024)
    hwant = he.run_batch(hkeys)
    he.chaos = as_injector(ROOT / "drills" / "hang-fetch.json")
    equal_sums(he.run_batch(hkeys, pipelined=True), hwant, "hang-fetch drill")
    check(he.chaos.fired == [{"point": "pipeline.flag_fetch", "kind": "hang"}],
          f"hang-fetch drill fired {he.chaos.fired}")
    import logging

    warned: list = []
    handler = logging.Handler()
    handler.emit = lambda rec: warned.append(rec.getMessage())
    logging.getLogger("tpusim_torch").addHandler(handler)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            check(cli.main(drill_run + ["--telemetry", str(ddir / "enospc.jsonl"), "--chaos",
                                        str(ROOT / "drills" / "enospc-telemetry.json"),
                                        "--json", str(ddir / "enospc_out.json")]) == 0,
                  "enospc drill")
    finally:
        logging.getLogger("tpusim_torch").removeHandler(handler)
    disabled = [w for w in warned if "disabling the recorder" in w]
    check(len(disabled) == 1 and
          strip_json(ddir / "enospc_out.json") == strip_json(ddir / "clean.json"),
          f"enospc drill: {len(disabled)} warnings, or results differ")
    print(f"[chaos] on the card, {drill_run[1]} runs x 2 d: an engine.dispatch transient "
          f"retried (chaos, retry spans) and bit-equal; sigkill-pre-replace killed the run "
          f"(exit -9, a stale temp file) and the re-run swept it and came out bit-equal; "
          f"hang-fetch on the pipelined path re-ran synchronously, bit-equal; "
          f"enospc-telemetry: one warning, the run completed bit-equal; on {card}")

    # (v) The provenance plane armed on the card: a checkpointed run, a
    # sequential and a packed sweep at rng_batch=False (X2r, and its packed
    # form), a perf row and a trace; then the audit green, a mutated record
    # red, a sweep row walked to its run, and a bundle round trip.
    pdir = OUT / "provenance"
    shutil.rmtree(pdir, ignore_errors=True)
    pdir.mkdir()
    lineage = pdir / "lineage.jsonl"
    os.environ[provenance.PROVENANCE_ENV] = str(lineage)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            check(cli.main(drill_run + ["--checkpoint", str(pdir / "run.npz"), "--json",
                                        str(pdir / "run.json")]) == 0, "armed run")
        check(strip_json(pdir / "run.json") == strip_json(ddir / "clean.json"),
              "the armed run differs from the disarmed one")
        ppts = [(n, dataclasses.replace(c, runs=512, duration_ms=BATCH_DAYS * 86_400_000,
                                         **x2r))
                for n, c in grids["selfish-hashrate"]()[:2]]
        for k in event_loop.launches:
            event_loop.launches[k] = 0
        prow = {pk: sweep.run_sweep(ppts, device=dev, quiet=True, packed=pk,
                                    use_all_devices=False,
                                    out_path=pdir / f"rows{int(pk)}.jsonl",
                                    checkpoint_dir=pdir / f"ck{int(pk)}")
                for pk in (False, True)}
        swept = {k: v for k, v in event_loop.launches.items() if v}
        check(set(swept) == {"event_loop_exact_xoro", "event_loop_exact_xoro_packed"},
              f"armed sweeps launched {swept}")
        wall = ("elapsed_s", "compile_s")
        check([{k: v for k, v in r.items() if k not in wall} for r in prow[False]]
              == [{k: v for k, v in r.items() if k not in wall} for r in prow[True]],
              "the armed sweep's packed rows differ from its sequential rows")
        perf_mod.append_rows(pdir / "perf.jsonl", [perf_mod.perf_row(
            "smoke_x2r_chunk", "ms", stats["event_loop_fast_xoro"]["ms"], unit="ms",
            samples=[stats["event_loop_fast_xoro"]["ms"]], device=dev)])
        check(flight_export.main(["--runs", "64", "--days", "2", "--quiet", "--device", "cuda",
                                  "--trace-out", str(pdir / "trace.json"),
                                  "--events-out", str(pdir / "events.jsonl")]) == 0,
              "armed trace")
    finally:
        del os.environ[provenance.PROVENANCE_ENV]
    records = provenance.load_lineage(lineage, strict=True)
    kinds = sorted({r["kind"] for r in records})
    check(set(kinds) == {"run", "checkpoint", "sweep_row", "perf_row", "flight_export"},
          f"lineage kinds {kinds}")
    audit = lambda *a: cli.main(["audit", *a, "--lineage", str(lineage), "--quiet"])
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        green = audit(str(pdir))
        bad = OUT / "provenance_mutated"
        shutil.rmtree(bad, ignore_errors=True)
        shutil.copytree(pdir, bad)
        lines = (bad / "lineage.jsonl").read_text().splitlines()
        rec = json.loads(lines[0])
        rec["runs"] = rec.get("runs", 0) + 1
        (bad / "lineage.jsonl").write_text("\n".join([json.dumps(rec)] + lines[1:]) + "\n")
        red = cli.main(["audit", str(bad), "--lineage", str(bad / "lineage.jsonl"), "--quiet"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        shown = cli.main(["lineage", "show", str(pdir / "rows0.jsonl"), "--line", "1",
                          "--lineage", str(lineage)])
    walk = out.getvalue().splitlines()
    evidence = pdir / "evidence.tar"
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        sealed = cli.main(["bundle", "create", str(evidence), str(pdir / "rows0.jsonl"),
                           str(lineage)])
        verified = cli.main(["bundle", "verify", str(evidence)])
        blob = bytearray(evidence.read_bytes())
        blob[blob.index(b'"point"', 1024) + 2] ^= 1
        evidence.write_bytes(bytes(blob))
        flipped = cli.main(["bundle", "verify", str(evidence)])
    check((green, red, shown, sealed, verified, flipped) == (0, 1, 0, 0, 0, 1),
          f"audit {green}, mutated {red}, lineage show {shown}, bundle {sealed} {verified} "
          f"{flipped}")
    check(len(walk) >= 2 and walk[0].startswith("sweep_row ") and
          walk[1].startswith("└─ run "), f"lineage show: {walk}")
    print(f"[provenance] armed on the card: {len(records)} records ({kinds}); the armed run "
          f"== the disarmed one; the sweep's packed rows == its sequential rows ({swept}); "
          f"audit exit 0, a mutated record exit 1; lineage show: {walk[0][:40]}... -> "
          f"{walk[1][:30]}...; bundle create/verify 0, a flipped byte 1; on {card}")
    record["x2r"] = dict(compared=x2r_cmp, paths=x2r_paths,
                         years=dict(selfish=res_rs.to_dict(), default=res_rd.to_dict()),
                         lineage_records=len(records))
    stamp("X2r, chaos drills and provenance")
    record["smoke_s"] = time.perf_counter() - t_all
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=2))

    kernels = []
    for name, source, replaces, launches in (
        ("event_loop_fast", "tpusim_torch/csrc/event_loop.cu", "tpusim/pallas_engine.py:150",
         launches_fast),
        ("event_loop_exact", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/pallas_engine.py:150", launches_exact),
        ("event_loop_fast_flight", "tpusim_torch/csrc/event_loop.cu",
         "tpusim/pallas_engine.py:548", flight_launches["event_loop_fast_flight"]),
        ("event_loop_exact_flight", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/pallas_engine.py:548", flight_launches["event_loop_exact_flight"]),
        ("event_loop_fast_packed", "tpusim_torch/csrc/event_loop.cu",
         "tpusim/pallas_engine.py:1065", pr_launches["event_loop_fast_packed"]),
        ("event_loop_exact_packed", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/pallas_engine.py:1065", pk_launches["event_loop_exact_packed"]),
        ("event_loop_exact_k4_selfish", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/pallas_engine.py:233", k4_launches["event_loop_exact"]),
        ("event_loop_fast_k4_default", "tpusim_torch/csrc/event_loop.cu",
         "tpusim/pallas_engine.py:233", k4_launches["event_loop_fast"]),
        ("event_loop_exact_packed_flight", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/pallas_engine.py:548", pf_launches["event_loop_exact_packed_flight"]),
        ("event_loop_fast_wide", "tpusim_torch/csrc/event_loop.cu",
         "tpusim/pallas_engine.py:150", launches_w1),
        ("event_loop_exact_wide", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/engine.py:335", w2_seq_launches["event_loop_exact_wide"]),
        ("event_loop_fast_raw", "tpusim_torch/csrc/event_loop.cu",
         "tpusim/pallas_engine.py:293", legacy_launches["event_loop_fast_raw"]),
        ("event_loop_exact_raw", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/pallas_engine.py:293", legacy_launches["event_loop_exact_raw"]),
        ("event_loop_fast_onehot", "tpusim_torch/csrc/event_loop.cu",
         "tpusim/pallas_engine.py:442", legacy_launches["event_loop_fast_onehot"]),
        ("event_loop_exact_onehot", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/pallas_engine.py:442", legacy_launches["event_loop_exact_onehot"]),
        *((f"micro_{op}", "tpusim_torch/csrc/micro.cu", "scripts/mosaic_micro.py:110",
           micro_launches[op]) for op in micro.OPS),
        ("k6_event_loop_exact_sharded", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/pallas_engine.py:828", k6_launches["k6_event_loop_exact_sharded"]),
        ("k6_event_loop_fast_sharded", "tpusim_torch/csrc/event_loop.cu",
         "tpusim/pallas_engine.py:828", k6_launches["k6_event_loop_fast_sharded"]),
        ("xoroshiro_rows", "tpusim_torch/csrc/xoroshiro.cu", "tpusim/engine.py:599",
         x1_launches),
        ("event_loop_fast_consumed", "tpusim_torch/csrc/event_loop.cu", "tpusim/engine.py:588",
         x2_launches_f),
        ("event_loop_exact_consumed", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/engine.py:588", x2_launches_s),
        ("event_loop_fast_run_until_confident", "tpusim_torch/csrc/event_loop.cu",
         "tpusim/pallas_engine.py:150", ci_k1),
        ("event_loop_exact_packed_adaptive", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/pallas_engine.py:1065", ad_k4x),
        ("event_loop_fast_selfish", "tpusim_torch/csrc/event_loop.cu", "tpusim/engine.py:335",
         fs_launches),
        ("event_loop_fast_selfish_flight", "tpusim_torch/csrc/event_loop.cu",
         "tpusim/engine.py:335", fs_trace_launches),
        ("event_loop_fast_selfish_packed", "tpusim_torch/csrc/event_loop.cu",
         "tpusim/engine.py:335", fs_packed_launches),
        ("event_loop_fast_xoro", "tpusim_torch/csrc/event_loop.cu", "tpusim/engine.py:625",
         x2r_launches_f),
        ("event_loop_exact_xoro", "tpusim_torch/csrc/event_loop_exact.cu",
         "tpusim/engine.py:625", x2r_launches_s),
    ):
        st = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": None,
        })
    print(f"[smoke] {record['smoke_s']:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
