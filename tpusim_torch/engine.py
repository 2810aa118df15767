"""Chunked batch executor: the port's counterpart of ``tpusim/engine.py`` on
its single-device threefry path.

A batch of runs advances in fixed-step chunks. Each chunk draws every run's
threefry words (``fold_in(run_key, 1 + chunk)``), maps them to pre-mapped
int32 (winner, interval ms) rows (or, with ``rng_batch=False``, hands the
raw words to the kernel's raw-word variant, which maps them per event),
runs the event-loop kernel for ``chunk_steps`` events, and re-bases clocks
and block counts, all on the device. The remaining-time ledger stays on
the device as a base-2^30 int32 pair, as in the reference's
``_device_loop``; the host loop only reads one
"any run unfinished" flag per chunk. After the last chunk, ``final_stats``
runs on the device and the host reduces in int64/float64.

This slice covers fast mode for honest rosters and exact mode for any
roster (the selfish race and reveal included), of any width (rosters of
more than 16 miners run the kernels' wide variants), with the default threefry
generator and any number of group slots (``group_slots``: 2 on the
kernels' split slots, 3 and more on their generic K-slot buffer), with or
without the flight recorder (``flight_capacity > 0``: the ring rides the
chunk through the kernel's flight variant and comes back per run as
``flight_buf``/``flight_count``), and packed grids (``packed=True``,
:mod:`tpusim_torch.packed`: per-run params, durations and raw per-run
outputs, through the kernel's packed variant, with or without the ring);
anything else raises a ValueError that names its ROADMAP.md item.
Pipelined dispatch, meshes and chaos seams are later slices. The reference's
legacy knobs run the kernels they name: ``rng_batch=False`` the raw-word
variant (K5a) and ``consensus_gather=False`` the one-hot variant (K5b),
each with the same results as the default. ``superstep`` only unrolls the
reference's step loop, which a thread's loop over events has no counterpart
of, so the port accepts it.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import sampling, threefry
from .config import SimConfig
from .convergence import STATS as MOMENT_STATS, moment_keys
from .event_loop import (
    DEPTH_BUCKETS, event_loop_chunk, make_sampler, state_from_kernel, state_to_kernel,
)
from .flight import (
    FlightRecorder, advance_base, advance_height_base, flight_from_kernel, flight_to_kernel,
    init_recorder,
)
from .state import (
    COUNT_DTYPES, TIME_CAP, SimState, final_stats, init_state, make_params,
    rebase, rebase_counts,
)

__all__ = [
    "Engine", "SimCounters", "DEPTH_BUCKETS", "combine_sums", "counters_to_kernel",
    "counters_from_kernel", "default_n_steps", "resolve_device", "apply_count_rebase",
]

I32 = torch.int32

#: Per-batch int32 block-count sums stay exact below this many blocks.
_I32_SUM_GUARD = 2**31 - 1

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU. Without a CUDA device the default raises; it never drops to the CPU
    quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"tpusim_torch runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev


class SimCounters(NamedTuple):
    """Device-side per-run telemetry counters (``tpusim.engine.SimCounters``),
    runs first, all int32."""

    reorg_max: torch.Tensor  # [R] max own blocks popped by one reorg
    stale_events: torch.Tensor  # [R] events with >= 1 stale block
    active_steps: torch.Tensor  # [R] events with t < cap
    stale_by_miner: torch.Tensor  # [R, M] events in which miner m lost blocks
    reorg_depth_hist: torch.Tensor  # [R, DEPTH_BUCKETS]


def init_counters(n_runs: int, n_miners: int, device=None) -> SimCounters:
    z = lambda *shape: torch.zeros(shape, dtype=I32, device=device)
    return SimCounters(z(n_runs), z(n_runs), z(n_runs), z(n_runs, n_miners),
                       z(n_runs, DEPTH_BUCKETS))


def counters_to_kernel(ctr: SimCounters) -> tuple[torch.Tensor, ...]:
    """Runs-first counters -> the kernel's runs-last counter leaves
    (event_loop.TELE_LEAVES)."""
    tr = lambda x: torch.movedim(x, 0, -1).contiguous()
    return (ctr.reorg_max[None, :], ctr.stale_events[None, :], ctr.active_steps[None, :],
            tr(ctr.stale_by_miner), tr(ctr.reorg_depth_hist))


def counters_from_kernel(leaves) -> SimCounters:
    bk = lambda x: torch.movedim(x, -1, 0)
    return SimCounters(leaves[0][0], leaves[1][0], leaves[2][0], bk(leaves[3]), bk(leaves[4]))


def combine_sums(a: dict[str, np.ndarray], b: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Merge two run_batch outputs over disjoint run sets: elementwise max
    for the ``*_max`` keys, run-axis concatenation for ``*_per_run`` leaves,
    addition for everything else (exact for the int64 moment keys)."""
    def merge(k):
        if k.startswith("flight_") or k.endswith("_per_run"):
            return np.concatenate([np.asarray(a[k]), np.asarray(b[k])])
        if k.endswith("_max"):
            return np.maximum(a[k], b[k])
        return a[k] + b[k]

    return {k: merge(k) for k in a}


def _host_reduce_telemetry(out: dict[str, np.ndarray], busy_chunks: int) -> None:
    """Collapse the per-run counter leaves into the telemetry summary keys,
    in host int64."""
    out["tele_reorg_depth_max"] = np.int64(np.max(out.pop("tele_reorg_depth_per_run")))
    out["tele_stale_events_sum"] = np.int64(
        out.pop("tele_stale_events_per_run").astype(np.int64).sum()
    )
    out["tele_active_steps_sum"] = np.int64(
        out.pop("tele_active_steps_per_run").astype(np.int64).sum()
    )
    out["tele_stale_by_miner_sum"] = (
        out.pop("tele_stale_by_miner_per_run").astype(np.int64).sum(axis=0)
    )
    out["tele_reorg_depth_hist_sum"] = (
        out.pop("tele_reorg_depth_hist_per_run").astype(np.int64).sum(axis=0)
    )
    out["tele_chunks_max"] = np.int64(busy_chunks)


def _host_reduce_sums(out: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Sum the per-run float32 ratio leaves in float64 and add the exact
    int64 streaming-moment keys (tpusim_torch.convergence)."""
    per: dict[str, np.ndarray] = {}
    for name, _, _ in MOMENT_STATS:
        per_run = out.pop(name + "_per_run", None)
        if per_run is not None:
            per[name] = per_run
    for name in ("blocks_share", "stale_rate"):
        if name in per:
            out[name + "_sum"] = per[name].astype(np.float64).sum(axis=0)
    if per:
        if len(per) != len(MOMENT_STATS):
            raise RuntimeError(
                f"streaming-moment wiring incomplete: finalize produced "
                f"per-run leaves {sorted(per)} but convergence.STATS declares "
                f"{[n for n, _, _ in MOMENT_STATS]}"
            )
        out.update(moment_keys(per))
    return out


def apply_count_rebase(state: SimState, cb: torch.Tensor, fr: FlightRecorder | None):
    """The chunk-boundary count re-base: re-base the count leaves, fold the
    subtracted per-owner base into the carried ``cb`` accumulator, and
    advance the flight recorder's absolute height origin by its total.
    Returns ``(state, cb, fr)``."""
    state, delta = rebase_counts(state)
    if fr is not None:
        fr = advance_height_base(fr, delta.sum(-1, dtype=I32))
    return state, cb + delta, fr


def default_n_steps(duration_ms: int, block_interval_s: float) -> int:
    """Upper bound on event-loop iterations for one run: found + arrival
    events <= 2x the block count, at mean + 8 sigma of the Poisson count."""
    mu = duration_ms / (block_interval_s * 1000.0)
    return int(2.0 * (mu + 8.0 * math.sqrt(mu + 1.0))) + 16


def _not_ported(what: str, item: str) -> ValueError:
    return ValueError(f"{what} is not yet ported to tpusim_torch (ROADMAP.md {item})")


def check_supported(config: SimConfig) -> None:
    """Raise for a configuration outside this slice of the port."""
    if config.network.any_selfish and config.resolved_mode != "exact":
        # As pallas_engine.PallasEngine refuses it: the reference keeps its
        # fast-mode selfish approximation on the scan engine alone.
        raise _not_ported(
            "mode='fast' on a selfish roster (the reference's fast-mode selfish "
            "approximation runs on its scan engine only)", "Queue 1, item 13"
        )
    if config.rng != "threefry":
        raise _not_ported("rng='xoroshiro'", "Queue 1, item 6")


class Engine:
    """Chunked batch executor for one SimConfig on one device.

    ``event_loop`` is the per-chunk event loop: the kernel wrapper
    :func:`tpusim_torch.event_loop.event_loop_chunk` by default; a
    comparison run passes the plain version.

    ``packed`` (``tpusim.engine.Engine(packed=True)``) makes the scenario
    parameters per-run tensors: the packed dispatcher
    (:mod:`tpusim_torch.packed`) sets :attr:`params` to leaves with a
    leading runs axis and :attr:`run_durations` to each run's duration
    before every batch, and :meth:`run_batch` returns the raw per-run
    leaves for it to reduce per grid point. The per-run compute is the
    sequential engine's, so every run's results are bit-equal to it."""

    #: Base of the on-device remaining-time ledger: hi * 2^30 + lo.
    _LEDGER_BASE = 1 << 30

    def __init__(self, config: SimConfig, device=None, *,
                 event_loop: Callable = event_loop_chunk, packed: bool = False):
        check_supported(config)
        self.packed = packed
        #: Per-run int64 durations (packed engines; None keeps the config's).
        self.run_durations: np.ndarray | None = None
        self.config = config
        self.device = resolve_device(device)
        self.event_loop = event_loop
        self.params = make_params(config, self.device)
        self._sampler = None
        self.n_miners = config.network.n_miners
        self.group_slots = config.resolved_group_slots
        self.count_dtype = COUNT_DTYPES[config.resolved_count_dtype]
        self.count_rebase = config.count_rebase
        self.exact = config.resolved_mode == "exact"
        self.any_selfish = config.network.any_selfish
        #: Host flags, baked into the kernel launch as the reference bakes
        #: them into its Pallas kernel.
        self.selfish = tuple(mc.selfish for mc in config.network.miners)
        self.flight_capacity = config.flight_capacity
        bound = default_n_steps(config.duration_ms, config.network.block_interval_s)
        self.chunk_steps = config.resolved_chunk_steps
        # Generous against the per-run 8-sigma bound because the loop must
        # cover the batch max; the second term covers runs that freeze at
        # TIME_CAP and re-base repeatedly.
        self.max_chunks = (
            (bound + 4 * self.chunk_steps) // self.chunk_steps
            + config.duration_ms // TIME_CAP
            + 4
        )

    def make_keys(self, start: int, count: int) -> torch.Tensor:
        """Threefry run keys (count, 2) for global run indices [start, start+count)."""
        return threefry.make_run_keys(self.config.seed, start, count, self.device)

    def _init(self, keys: torch.Tensor):
        n, m = keys.shape[0], self.n_miners
        state = init_state(n, m, self.group_slots, self.count_dtype,
                           self.count_rebase, self.device, exact=self.exact,
                           any_selfish=self.any_selfish)
        words = threefry.init_words(keys)
        nbt = sampling.interval_from_bits(words[1], self.params.mean_interval_ms)
        cb = torch.zeros((n, m), dtype=I32, device=self.device) if self.count_rebase else None
        fr = init_recorder(n, self.flight_capacity, self.device) if self.flight_capacity else None
        return state._replace(next_block_time=nbt), (init_counters(n, m, self.device), fr, cb)

    def _rows(self, keys: torch.Tensor, chunk_idx: int) -> torch.Tensor:
        """Chunk ``chunk_idx``'s pre-mapped (winner, interval ms) rows,
        int32 (steps, 2, R); with ``rng_batch=False`` its raw words as int32
        bit patterns, which the kernel maps (:meth:`loop_options`)."""
        words = threefry.chunk_words(keys, chunk_idx, self.chunk_steps)
        if not self.config.rng_batch:
            return threefry.to_int32(words)
        return torch.stack(
            [
                sampling.winners_from_bits(words[:, 0], self.params.thresholds),
                sampling.interval_from_bits(words[:, 1], self.params.mean_interval_ms),
            ],
            dim=1,
        )

    def roster(self) -> tuple:
        """The event loop's ``prop`` and ``selfish`` operands: the config's
        (M,) delays and host flags, or for a packed engine the per-run
        params runs-last, (M, R) int32, as the Pallas kernel's packed refs
        (pallas_engine.py:1075-1076). An honest pack passes its all-honest
        host flags, so it runs the kernel's honest variant."""
        if not self.packed:
            return self.params.prop_ms, self.selfish
        prop = self.params.prop_ms.t().contiguous()
        if not self.any_selfish:
            return prop, self.selfish
        return prop, self.params.selfish.t().to(I32).contiguous()

    def loop_options(self) -> dict:
        """The event loop's keyword operands for this config's legacy knobs:
        ``sampler`` (the winner thresholds and mean interval, per run when
        packed) when ``rng_batch`` is off, so the kernel maps the raw words
        (K5a); ``onehot`` when ``consensus_gather`` is off (K5b)."""
        sampler = None
        if not self.config.rng_batch:
            # Made once per params (a packed dispatch sets new ones).
            if self._sampler is None or self._sampler[0] is not self.params:
                p = self.params
                self._sampler = (p, make_sampler(p.thresholds, p.mean_interval_ms))
            sampler = self._sampler[1]
        return dict(sampler=sampler, onehot=not self.config.consensus_gather)

    def _chunk(self, state: SimState, aux, cap: torch.Tensor, keys: torch.Tensor,
               chunk_idx: int):
        """One chunk: draw, run the event loop, re-base. ``aux`` is
        ``(counters, flight recorder or None, count base or None)``, as in
        the reference. Returns ``(state, aux, elapsed)``."""
        ctr, fr, cb = aux
        prop, selfish = self.roster()
        leaves, counters, flight = self.event_loop(
            self._rows(keys, chunk_idx), cap, prop,
            state_to_kernel(state), counters_to_kernel(ctr), selfish,
            flight=None if fr is None else flight_to_kernel(fr), **self.loop_options(),
        )
        ctr = counters_from_kernel(counters)
        state, elapsed = rebase(state_from_kernel(state, leaves))
        if fr is not None:
            fr = advance_base(flight_from_kernel(flight), elapsed)
        if self.count_rebase:
            state, cb, fr = apply_count_rebase(state, cb, fr)
        return state, (ctr, fr, cb), elapsed

    def _finalize(self, state: SimState, t_end: torch.Tensor, cbase) -> dict:
        per_run = final_stats(state, t_end, cbase)
        if self.packed:
            # A packed batch mixes grid points: nothing is reduced over the
            # runs axis here; the dispatcher reduces per point on the host.
            return {f"{k}_per_run": per_run[k] for k in (
                "blocks_found", "stale_blocks", "best_height", "overflow",
                "blocks_share", "stale_rate")}
        return {
            "blocks_found_sum": per_run["blocks_found"].sum(0, dtype=I32),
            "stale_blocks_sum": per_run["stale_blocks"].sum(0, dtype=I32),
            "best_height_sum": per_run["best_height"].sum(dtype=I32),
            "overflow_sum": per_run["overflow"].sum(dtype=I32),
            "blocks_share_per_run": per_run["blocks_share"],
            "stale_rate_per_run": per_run["stale_rate"],
            "blocks_found_per_run": per_run["blocks_found"],
        }

    def _ledger_init(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Split ``duration_ms``, or each run's ``run_durations``, into the
        per-run (hi, lo) int32 ledger pair: a packed grid's ragged horizons
        are just per-run budgets."""
        shift = self._LEDGER_BASE.bit_length() - 1
        if self.run_durations is not None:
            dur = np.asarray(self.run_durations, dtype=np.int64)
            if dur.shape != (n,):
                raise ValueError(f"run_durations shape {dur.shape} != batch ({n},)")
            limb = lambda v: torch.from_numpy(v.astype(np.int32)).to(self.device)
            return limb(dur >> shift), limb(dur & (self._LEDGER_BASE - 1))
        dur = int(self.config.duration_ms)
        full = lambda v: torch.full((n,), v, dtype=I32, device=self.device)
        return full(dur >> shift), full(dur & (self._LEDGER_BASE - 1))

    def _device_loop(self, keys: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor) -> dict:
        """The whole batch on the device: init, every chunk, finalize. The
        ledger arithmetic is the reference's: a chunk's elapsed time is
        below 2^30, so one borrow per chunk suffices."""
        state, aux = self._init(keys)
        i = 0
        while i < self.max_chunks and bool(((hi > 0) | (lo > 0)).any()):
            cap = torch.clamp_min(torch.where(hi > 0, TIME_CAP, torch.clamp_max(lo, TIME_CAP)), 0)
            state, aux, elapsed = self._chunk(state, aux, cap, keys, i)
            lo = lo - elapsed
            borrow = (lo < 0) & (hi > 0)
            hi = torch.where(borrow, hi - 1, hi)
            lo = torch.where(borrow, lo + self._LEDGER_BASE, lo)
            i += 1
        ctr, fr, cb = aux
        sums = self._finalize(state, hi * self._LEDGER_BASE + lo, cb)
        sums["tele_reorg_depth_per_run"] = ctr.reorg_max
        sums["tele_stale_events_per_run"] = ctr.stale_events
        sums["tele_active_steps_per_run"] = ctr.active_steps
        sums["tele_stale_by_miner_per_run"] = ctr.stale_by_miner
        sums["tele_reorg_depth_hist_per_run"] = ctr.reorg_depth_hist
        if fr is not None:
            # The rings, per run, for the host's decode (tpusim_torch.flight_export).
            sums["flight_buf"] = fr.buf
            sums["flight_count"] = fr.count
        sums["n_chunks"] = i
        sums["unfinished"] = bool(((hi > 0) | (lo > 0)).any())
        return sums

    def _batch_guard(self, n: int) -> None:
        if self.run_durations is not None:
            # Packed: the bound sums each run's expected block count.
            mi = self.params.mean_interval_ms.double().cpu().numpy()
            dur = np.asarray(self.run_durations, dtype=np.float64)
            blocks_bound = float(np.sum(dur / np.maximum(mi, 1.0))) * 1.1
            if blocks_bound > _I32_SUM_GUARD:
                raise ValueError(
                    f"packed batch of {n} runs overflows int32 block-count sums "
                    f"({blocks_bound:.3g} expected blocks); lower the pack width"
                )
            return
        duration = self.config.duration_ms
        blocks_bound = n * (duration / (self.config.network.block_interval_s * 1000.0)) * 1.1
        if blocks_bound > _I32_SUM_GUARD:
            raise ValueError(
                f"batch of {n} runs x {duration} ms overflows int32 block-count "
                f"sums; lower batch_size below {int(_I32_SUM_GUARD / (blocks_bound / n))}"
            )

    def run_batch(self, keys: torch.Tensor) -> dict[str, np.ndarray]:
        """Simulate one batch of runs to completion; returns the stat sums,
        key for key those of ``tpusim.engine.Engine.run_batch`` (a packed
        engine's: the raw per-run leaves and the busy-chunk count)."""
        n = keys.shape[0]
        self._batch_guard(n)
        hi0, lo0 = self._ledger_init(n)
        sums = self._device_loop(keys, hi0, lo0)
        n_chunks, unfinished = sums.pop("n_chunks"), sums.pop("unfinished")
        if unfinished:
            raise RuntimeError(
                f"batch did not finish within {n_chunks} chunks of "
                f"{self.chunk_steps} steps (limit {self.max_chunks}) — "
                f"event count beyond the Poisson bound"
            )
        out = {k: v.cpu().numpy() for k, v in sums.items()}
        if self.packed:
            out["tele_chunks_max"] = np.int64(n_chunks)
        else:
            out = _host_reduce_sums(out)
            _host_reduce_telemetry(out, n_chunks)
        out["runs"] = np.int64(n)
        return out
