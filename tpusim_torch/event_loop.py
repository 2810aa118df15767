"""The event loop: one chunk of ``chunk_steps`` events for every run, as
hand-written CUDA kernels and as their plain PyTorch versions.

Counterpart of ``tpusim/pallas_engine.py::_make_kernel`` (gather reads,
pre-mapped (winner, interval) rows by default), in its two modes:

* fast mode (K1, ``csrc/event_loop.cu``): the pairwise ``own_cp``/``own_in``
  approximation, honest rosters only;
* exact mode (K2, ``csrc/event_loop_exact.cu``): the ``cp (M, M, M)``
  common-prefix statistic, ``n_private``/``best_height_prev``, and for
  selfish rosters the race, private append and reveal;

in either mode with the flight recorder (K3, the same two sources with
``FLIGHT``): up to two ring rows per step (:mod:`tpusim_torch.flight`); and
in either mode for packed grids (K4, the same two sources with ``PACKED``):
propagation delays and selfish flags per run, (M, R) runs-last, where the
other variants take one roster for every run; and with both (K4 x K3).
Each of these runs at any number K of arrival-group slots: K = 2 on split
slots (the reference's split-slot specialization), K >= 3 on the generic
K-slot buffer (K5c, the sources built with ``TPUSIM_GROUP_SLOTS``). Rosters
of up to 16 miners (:data:`NARROW_MAX_MINERS`) run the kernels that give a
run a group of 16 lanes, lane m miner m's leaves in registers; wider ones
run every variant's wide form (K1w, K2w, the sources built with
``TPUSIM_WIDE``), which give a run a warp, lane l miners l, l + 32, ...;
both keep a run's tables in shared memory, and K2w takes ``cp`` run-major
(``_launch`` permutes it in and out).
The reference's two legacy knobs have variants of their own, each of every
variant above: with ``sampler`` (``SimConfig.rng_batch=False``,
K5a, the sources built with ``TPUSIM_RAW_WORDS``) the rows hold the raw
threefry words and the kernel maps them per event from the winner
thresholds and the mean interval; with ``onehot``
(``SimConfig.consensus_gather=False``, K5b, ``TPUSIM_ONEHOT``) every read
indexed by the best chain's owner b is a one-hot contraction over the
miner axis. Both give the same values as the default variants.

Both versions take the state runs-last (``(..., R)``, the Pallas kernel's
layout), so the kernels' block copies of a table entry, one thread a run,
read neighbouring addresses.
``own_cp`` stays ``[i, j]`` in both modes: the reference's transposed exact
``own_cp`` exists only for Mosaic's layouts.

:func:`event_loop_chunk` is the wrapper the engine calls; the mode follows
from the number of state leaves. It launches the kernel for CUDA tensors and
takes the plain version only for tensors that lie on the CPU; anything else
raises. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from .csrc.build import NARROW_MAX_MINERS, SOURCES
from .flight import FLIGHT_LEAVES, KIND_ARRIVAL, KIND_FIND, KIND_REORG, KIND_STALE, N_FIELDS
from .sampling import interval_from_bits, winners_from_bits
from .state import INF_TIME, NEG_TIME_CAP, SimState
from .threefry import MASK, to_int32

__all__ = [
    "NARROW_MAX_MINERS", "DEPTH_BUCKETS", "Sampler", "event_loop_chunk", "event_loop_chunk_plain",
    "make_sampler", "map_raw_words", "map_raw_words_plain", "state_to_kernel",
    "state_from_kernel", "leaf_shapes", "leaf_dtypes",
]

I32 = torch.int32

#: State leaf order in the kernels' argument lists (pallas_engine._FAST_LEAVES
#: and _EXACT_LEAVES).
FAST_LEAVES = (
    "t", "nbt", "height", "stale", "base", "garr", "gcnt", "ocp", "oin", "ocnt", "ovf",
)
EXACT_LEAVES = (
    "t", "nbt", "bhp", "height", "npriv", "stale", "base", "garr", "gcnt",
    "cp", "ocp", "oin", "ocnt", "ovf",
)
#: SimCounters leaves, runs-last, after the state (pallas_engine._TELE_LEAVES):
#: reorg_max, stale_events, active_steps, stale_by_miner, reorg_depth_hist.
TELE_LEAVES = ("mre", "sev", "act", "sbm", "rdh")
#: State leaves that hold block counts (int16 when the count bound fits).
COUNT_LEAVES = frozenset(
    {"bhp", "height", "npriv", "stale", "gcnt", "cp", "ocp", "oin", "ocnt"}
)

#: Reorg-depth histogram buckets (the ``rdh`` counter leaf): depths 1..7 get
#: their own bucket, the last counts depth >= 8. Compiled into the kernels.
DEPTH_BUCKETS = 8

#: Kernel launches so far, by kernel (``csrc.build.SOURCES``: the wide,
#: raw-word and one-hot variants under names of their own, and
#: ``map_raw_words``); each wrapper adds one per launch of its kernel and
#: nothing else.
launches = dict.fromkeys([*SOURCES, "map_raw_words"], 0)


class Sampler(NamedTuple):
    """The raw-word variants' sampler operands (K5a; the reference's
    ``rng_batch=False`` kernel bakes them in, pallas_engine.py:293-309):
    the winner intervals ``[lo[m], hi[m])`` as int32 bit patterns of the
    uint32 thresholds, (M,) or per run (M, R) runs-last, and the mean
    interval in ms, float32 (1,) or per run (R,)."""

    lo: torch.Tensor
    hi: torch.Tensor
    mean: torch.Tensor


def make_sampler(thresholds: torch.Tensor, mean_interval_ms) -> Sampler:
    """The :class:`Sampler` of a roster's params: ``thresholds`` int64
    uint32 values (M,) or per run (R, M), ``mean_interval_ms`` a float or a
    float32 (R,) tensor (``state.SimParams``)."""
    lo = torch.cat([torch.zeros_like(thresholds[..., :1]), thresholds[..., :-1]], dim=-1)
    per_run = thresholds.dim() == 2
    as_kernel = lambda x: to_int32(x.t() if per_run else x).contiguous()
    mean = torch.as_tensor(mean_interval_ms, dtype=torch.float32, device=thresholds.device)
    return Sampler(as_kernel(lo), as_kernel(thresholds), mean.reshape(-1).contiguous())


def leaf_shapes(m: int, k: int, exact: bool = False) -> list[tuple[int, ...]]:
    """Per-leaf shapes of :data:`FAST_LEAVES` or :data:`EXACT_LEAVES`
    without the trailing runs axis."""
    if exact:
        return [
            (1,), (1,), (1,), (m,), (m,), (m,), (m,), (m, k), (m, k),
            (m, m, m), (m, m), (m, m), (m,), (1,),
        ]
    return [(1,), (1,), (m,), (m,), (m,), (m, k), (m, k), (m, m), (m, m), (m,), (1,)]


def leaf_dtypes(count_dtype, count_rebase: bool, exact: bool = False) -> list:
    """Per-leaf dtypes parallel to :func:`leaf_shapes`; under count re-basing
    ``stale`` stays int32 (the one monotone accumulator the re-base does not
    shift)."""
    counts = COUNT_LEAVES - {"stale"} if count_rebase else COUNT_LEAVES
    return [count_dtype if n in counts else I32 for n in (EXACT_LEAVES if exact else FAST_LEAVES)]


def state_to_kernel(state: SimState) -> tuple[torch.Tensor, ...]:
    """Runs-first SimState -> the ordered, contiguous runs-last leaf tuple
    (exact-mode leaves when the state has ``cp``)."""
    tr = lambda x: torch.movedim(x, 0, -1).contiguous()
    row = lambda x: x[None, :].contiguous()
    if state.cp is not None:
        return (
            row(state.t), row(state.next_block_time), row(state.best_height_prev),
            tr(state.height), tr(state.n_private), tr(state.stale),
            tr(state.base_tip_arrival), tr(state.group_arrival), tr(state.group_count),
            tr(state.cp), tr(state.own_cp), tr(state.own_in), tr(state.own_cnt),
            row(state.overflow),
        )
    return (
        row(state.t), row(state.next_block_time),
        tr(state.height), tr(state.stale), tr(state.base_tip_arrival),
        tr(state.group_arrival), tr(state.group_count),
        tr(state.own_cp), tr(state.own_in), tr(state.own_cnt),
        row(state.overflow),
    )


def state_from_kernel(state: SimState, leaves) -> SimState:
    bk = lambda x: torch.movedim(x, -1, 0)
    if len(leaves) == len(EXACT_LEAVES):
        (t, nbt, bhp, height, npriv, stale, base, garr, gcnt, cp,
         ocp, oin, ocnt, ovf) = leaves
        return state._replace(
            t=t[0], next_block_time=nbt[0], best_height_prev=bhp[0],
            height=bk(height), n_private=bk(npriv), stale=bk(stale),
            base_tip_arrival=bk(base), group_arrival=bk(garr), group_count=bk(gcnt),
            cp=bk(cp), own_cp=bk(ocp), own_in=bk(oin), own_cnt=bk(ocnt), overflow=ovf[0],
        )
    t, nbt, height, stale, base, garr, gcnt, ocp, oin, ocnt, ovf = leaves
    return state._replace(
        t=t[0], next_block_time=nbt[0], height=bk(height), stale=bk(stale),
        base_tip_arrival=bk(base), group_arrival=bk(garr), group_count=bk(gcnt),
        own_cp=bk(ocp), own_in=bk(oin), own_cnt=bk(ocnt), overflow=ovf[0],
    )


def event_loop_chunk(rows, cap, prop, leaves, counters, selfish: Sequence[bool] = (),
                     flight=None, *, sampler: Sampler | None = None, onehot: bool = False):
    """Run ``rows.shape[0]`` events for every run.

    ``rows`` int32 (steps, 2, R): pre-mapped (winner index, interval ms) per
    step, or with ``sampler`` (a :class:`Sampler`: per-run thresholds and
    means when ``prop`` is per run) the step's two raw threefry words as
    int32 bit patterns, which selects the raw-word variant (K5a); ``cap``
    int32 (R,): each run's chunk-relative end; ``prop`` int32 (M,):
    propagation delays, or per run (M, R) for a packed grid, which
    selects the kernel's packed variant; ``leaves`` the 11 fast-mode or 14
    exact-mode state leaves and ``counters`` the 5 counter leaves,
    runs-last; ``selfish`` the M per-miner selfish flags (exact mode; fast
    mode is honest only), host values as the reference bakes them into its
    kernel, or with a per-run ``prop`` an int32 (M, R) tensor of per-run
    flags; ``flight`` None, or the flight recorder's three runs-last leaves
    (:data:`tpusim_torch.flight.FLIGHT_LEAVES`), which select the kernel's
    flight variant; ``onehot`` selects the one-hot variant (K5b). Returns
    new ``(leaves, counters, flight)`` tuples (``flight`` None when it was
    None); the inputs are not modified."""
    per_run_selfish = (selfish,) if torch.is_tensor(selfish) else ()
    tensors = (rows, cap, prop, *leaves, *counters, *(flight or ()), *per_run_selfish,
               *(sampler or ()))
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"event_loop_chunk: tensors on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if per_run_selfish and prop.dim() != 2:
        raise ValueError("event_loop_chunk: per-run selfish flags need a per-run prop (M, R)")
    if device.type == "cpu":
        return event_loop_chunk_plain(rows, cap, prop, leaves, counters, selfish, flight,
                                      sampler=sampler, onehot=onehot)
    if device.type != "cuda":
        raise ValueError(f"event_loop_chunk runs on CUDA or the CPU, not {device}")
    return _launch(rows, cap, prop, tuple(leaves), tuple(counters), selfish,
                   None if flight is None else tuple(flight), sampler, onehot)


def _check(name: str, x: torch.Tensor, shape: tuple, dtypes) -> None:
    if tuple(x.shape) != shape:
        raise ValueError(f"event_loop_chunk: {name} has shape {tuple(x.shape)}, expected {shape}")
    if x.dtype not in dtypes:
        raise ValueError(f"event_loop_chunk: {name} has dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"event_loop_chunk: {name} is not contiguous")


def _exact(leaves) -> bool:
    if len(leaves) not in (len(FAST_LEAVES), len(EXACT_LEAVES)):
        raise ValueError(f"event_loop_chunk: {len(leaves)} state leaves, expected "
                         f"{len(FAST_LEAVES)} (fast) or {len(EXACT_LEAVES)} (exact)")
    return len(leaves) == len(EXACT_LEAVES)


def _selfish_mask(selfish: Sequence[bool], m: int) -> int:
    """The selfish flags as a bit mask (bit i for miner i)."""
    if len(selfish) != m:
        raise ValueError(f"exact mode needs {m} selfish flags, got {len(selfish)}")
    return sum(1 << i for i, s in enumerate(selfish) if s)


def _per_run_selfish(selfish, m: int, r: int):
    """The packed exact kernel's selfish operand: the per-run flags, int32
    (M, R), or None for all-honest host flags (the kernel's
    ``SELFISH = false``)."""
    if torch.is_tensor(selfish):
        _check("selfish", selfish, (m, r), (I32,))
        return selfish
    if _selfish_mask(selfish, m):
        raise ValueError("event_loop_chunk: with a per-run prop, selfish flags are per run "
                         "(M, R) int32")
    return None


def _selfish_flags(selfish: Sequence[bool], m: int, device):
    """The wide exact kernel's uniform selfish operand: the flags as an (M,)
    int32 tensor on ``device``, or None when no miner is selfish (the
    kernel's ``SELFISH = false``). No bit mask, so no width limit."""
    if not _selfish_mask(selfish, m):
        return None
    # From pinned memory without a wait: a plain copy would hold the host
    # until the card's queue drains, and a sharded run's other cards with it.
    flags = torch.tensor([int(bool(x)) for x in selfish], dtype=I32)
    return flags.pin_memory().to(device, non_blocking=True)


def _check_flight(flight, r: int) -> int:
    """Validate the flight leaves; returns the ring capacity."""
    if len(flight) != len(FLIGHT_LEAVES):
        raise ValueError(f"event_loop_chunk: {len(flight)} flight leaves, expected "
                         f"{len(FLIGHT_LEAVES)} {FLIGHT_LEAVES}")
    capacity = flight[0].shape[0]
    if capacity < 1:
        raise ValueError("event_loop_chunk: the flight ring needs a capacity >= 1")
    for name, x, shape in zip(FLIGHT_LEAVES, flight, [(capacity, N_FIELDS), (1,), (3,)]):
        _check(name, x, shape + (r,), (I32,))
    return capacity


def _check_sampler(sampler: Sampler, m: int, r: int, packed: bool) -> None:
    if len(sampler) != len(Sampler._fields):
        raise ValueError(f"event_loop_chunk: the sampler has {len(sampler)} operands, "
                         f"expected {Sampler._fields}")
    for name, x in zip(("lo", "hi"), sampler[:2]):
        _check(name, x, (m, r) if packed else (m,), (I32,))
    _check("mean", sampler.mean, (r,) if packed else (1,), (torch.float32,))


def _launch(rows, cap, prop, leaves, counters, selfish, flight, sampler=None, onehot=False):
    from .csrc.build import entry_point, load_library

    exact = _exact(leaves)
    names = EXACT_LEAVES if exact else FAST_LEAVES
    steps, _, r = rows.shape
    m, k = leaves[names.index("height")].shape[0], leaves[names.index("garr")].shape[1]
    if k < 2:
        raise ValueError(f"the event-loop kernels need 2 or more group slots, not {k}")
    if m < 1:
        raise ValueError(f"the event-loop kernels need 1 or more miners, not {m}")
    wide = m > NARROW_MAX_MINERS
    cdt = leaves[names.index("height")].dtype
    if cdt not in (torch.int16, I32):
        raise ValueError(f"count leaves must be int16 or int32, not {cdt}")
    packed = prop.dim() == 2
    _check("rows", rows, (steps, 2, r), (I32,))
    _check("cap", cap, (r,), (I32,))
    _check("prop", prop, (m, r) if packed else (m,), (I32,))
    if exact and packed:
        sel_arg = _per_run_selfish(selfish, m, r)
    elif exact and wide:
        sel_arg = _selfish_flags(selfish, m, rows.device)
    # `stale` is int32 under count re-basing and the count type otherwise.
    stale_dt = leaves[names.index("stale")].dtype
    for name, x, shape, dt in zip(
        names, leaves, leaf_shapes(m, k, exact),
        leaf_dtypes(cdt, count_rebase=stale_dt == I32, exact=exact),
    ):
        _check(name, x, shape + (r,), (dt,))
    for name, x, shape in zip(TELE_LEAVES, counters, [(1,), (1,), (1,), (m,), (DEPTH_BUCKETS,)]):
        _check(name, x, shape + (r,), (I32,))
    capacity = None if flight is None else _check_flight(flight, r)
    if sampler is not None:
        _check_sampler(sampler, m, r, packed)

    outs = tuple(torch.empty_like(x) for x in leaves + counters)
    k_in, k_out = leaves + counters, outs
    if exact and wide:
        # The wide exact kernel takes cp run-major, (R, M, M, M): a run's M^3
        # counts are one contiguous block, which its threads copy in and out
        # with consecutive threads on consecutive words (and, where a run's
        # tables do not fit a block's shared memory, update in place).
        at = names.index("cp")
        cp_rm = leaves[at].permute(3, 0, 1, 2).contiguous()
        cp_rm_out = torch.empty_like(cp_rm)
        k_in = k_in[:at] + (cp_rm,) + k_in[at + 1:]
        k_out = k_out[:at] + (cp_rm_out,) + k_out[at + 1:]
    ptrs = lambda xs: (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
    kernel = "event_loop_exact" if exact else "event_loop_fast"
    if wide:
        kernel += "_wide"
    if sampler is not None:
        kernel += "_raw"
    if onehot:
        kernel += "_onehot"
    if packed:
        kernel += "_packed"
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        if flight is not None:
            kernel += "_flight"
            # The kernel writes only the rows it records, into a copy of the
            # input ring; count and origins are written whole.
            flight_out = (flight[0].clone(), torch.empty_like(flight[1]),
                          torch.empty_like(flight[2]))
        lib = load_library(kernel, m, k)
        args = [rows.data_ptr(), cap.data_ptr(), prop.data_ptr(), ptrs(k_in), ptrs(k_out), m,
                int(cdt == torch.int16), int(stale_dt == torch.int16), steps, r]
        if exact and (packed or wide):
            args.insert(6, None if sel_arg is None else sel_arg.data_ptr())
        elif exact:
            args.insert(6, _selfish_mask(selfish, m))
        if flight is not None:
            args += [ptrs((flight[1], flight[2]) + flight_out), capacity]
        if sampler is not None:
            args += [x.data_ptr() for x in sampler]
        err = getattr(lib, entry_point(kernel))(*args, stream)
        if exact and wide and not err:
            outs[at].copy_(cp_rm_out.permute(1, 2, 3, 0))
    if err:
        raise RuntimeError(
            f"{kernel} kernel launch failed: {lib.tpusim_cuda_error_string(err).decode()}"
        )
    launches[kernel] += 1
    return outs[: len(leaves)], outs[len(leaves):], None if flight is None else flight_out


def event_loop_chunk_plain(rows, cap, prop, leaves, counters, selfish: Sequence[bool] = (),
                           flight=None, *, sampler: Sampler | None = None,
                           onehot: bool = False):
    """The plain PyTorch version of :func:`event_loop_chunk`, in the mode its
    leaves give: a transcription of the Pallas ``step``
    (pallas_engine.py:271-628, gather reads) over (M, R) tensors, with the
    arrival groups on split slots at K = 2 and on the generic (M, K, R)
    buffer at K >= 3 (:class:`_SplitGroups`, :class:`_Groups`).
    Exact mode adds ``cp``, ``n_private`` and ``best_height_prev``, and, when
    one of the ``selfish`` flags is set, the race, private append and
    reveal; ``own_cp`` stays ``[i, j]`` in both modes. With ``flight`` each
    step also writes its ring rows (pallas_engine.py:548-609). A per-run
    ``prop`` and ``selfish`` (M, R) broadcast per lane exactly as the (M,)
    ones do (the packed grid, pallas_engine.py:1065-1077). With ``sampler``
    each step maps its raw words itself, the winner by the threshold
    intervals and the interval by ``sampling.interval_from_bits``
    (pallas_engine.py:293-309); with ``onehot`` b's rows and cp plane are
    read as contractions with the one-hot of b (pallas_engine.py:442-449,
    459-461, 477-479).

    Computes in int32 and stores each leaf in its own dtype: every count
    stays within ``SimConfig.count_bound``, so the values are those of the
    reference's int16 arithmetic. ``cp`` stays in its count type throughout
    (it is only ever copied, never computed on), which halves the memory
    traffic of its two selects per step."""
    exact = _exact(leaves)
    names = EXACT_LEAVES if exact else FAST_LEAVES
    dtypes = [x.dtype for x in (*leaves, *counters)]
    lv = {n: x.to(I32) for n, x in zip(names, leaves) if n != "cp"}
    t, nbt, ovf = lv["t"][0], lv["nbt"][0], lv["ovf"][0]
    height, stale, base = lv["height"], lv["stale"], lv["base"]
    ocp, oin, ocnt = lv["ocp"], lv["oin"], lv["ocnt"]
    mre, sev, act, sbm, rdh = (x.to(I32) for x in counters)
    mre, sev, act = mre[0], sev[0], act[0]
    m, r = height.shape
    dev = height.device
    midx = torch.arange(m, dtype=I32, device=dev)[:, None]  # (M, 1)
    bidx = torch.arange(rdh.shape[0], dtype=I32, device=dev)[:, None]
    prop = prop.to(I32) if prop.dim() == 2 else prop.to(I32)[:, None]  # (M, R) or (M, 1)
    groups = (_SplitGroups if lv["garr"].shape[1] == 2 else _Groups)(lv["garr"], lv["gcnt"])
    inf, neg_gate = INF_TIME, NEG_TIME_CAP - 1
    take = lambda arr: arr.gather(0, b[None, :])[0]  # arr[b] per run
    any_selfish = False  # fast mode is honest only
    if exact:
        cp, bhp, npriv = leaves[names.index("cp")], lv["bhp"][0], lv["npriv"]
        if torch.is_tensor(selfish):
            sel = selfish.to(torch.bool)  # per run (M, R)
        else:
            _selfish_mask(selfish, m)
            sel = torch.tensor([bool(x) for x in selfish], dtype=torch.bool, device=dev)[:, None]
        any_selfish = bool(sel.any())
        diag = torch.arange(m, device=dev)
        eye = (diag[:, None] == diag[None, :])[:, :, None]  # (M, M, 1)
    if sampler is not None:
        # The winner intervals as uint32 values, (M, 1) or per run (M, R).
        lo, hi = (x.long() & MASK for x in sampler[:2])
        if lo.dim() == 1:
            lo, hi = lo[:, None], hi[:, None]
    if flight is not None:
        _check_flight(flight, r)
        fbuf, fcnt = flight[0].clone(), flight[1][0]
        b_hi, b_lo, h_b = flight[2]
        ridx = torch.arange(r, device=dev)

        def push_row(fbuf, fcnt, rec, kind, miner, hgt, depth):
            # Row fields: kind, miner, height, depth, t_hi, t_lo (flight.py);
            # the time is the un-normalized (b_hi, b_lo + t) of step entry.
            row = torch.stack([kind, miner, hgt + h_b, depth, b_hi, b_lo + told], dim=1)
            slot = torch.remainder(fcnt, fbuf.shape[0]).long()
            fbuf[slot, :, ridx] = torch.where(rec[:, None], row.to(I32), fbuf[slot, :, ridx])
            return fcnt + rec.to(I32)

    for s in range(rows.shape[0]):
        active = t < cap
        # An inactive step changes nothing, and inactivity lasts to the end
        # of the chunk (t moves only while active): stopping is exact. An
        # inactive step records nothing either.
        if not bool(active.any()):
            break
        # Step-entry clock, and the earliest group each miner has arrived
        # by then, for the arrival row.
        told = t
        if flight is not None:
            pmin_per = groups.arrived_min(t)
        found_due = active & (t == nbt)
        if sampler is None:
            wq, dt = rows[s, 0], rows[s, 1]
            ow = (midx == wq) & found_due  # (M, R)
        else:
            # The raw words: miner m wins when lo[m] <= w < hi[m], the last
            # interval closed.
            bw = rows[s, 0].long() & MASK
            ow = (bw >= lo) & ((bw < hi) | (midx == m - 1)) & found_due
            dt = interval_from_bits(rows[s, 1].long() & MASK, sampler.mean)
        owi = ow.to(I32)

        # FoundBlock: the own-count vector and one arrival group move. A
        # selfish winner appends privately, except that a find on top of its
        # one private block while the public chain is level with it (bhp)
        # publishes both: the race, a push of count 2.
        ocnt = ocnt + owi
        push_do, push_count = ow, 1
        if any_selfish:
            sel_w = (ow & sel).any(0)
            npriv_w = (npriv * owi).sum(0, dtype=I32)
            height_w = (height * owi).sum(0, dtype=I32)
            is_race = sel_w & (npriv_w == 1) & (bhp == height_w)
            private_append = sel_w & ~is_race
            push_do = ow & ~private_append
            push_count = torch.where(is_race, 2, 1).to(I32)
            npriv = npriv + torch.where(
                ow, torch.where(private_append, 1, torch.where(is_race, -1, 0)), 0
            )
        ovf = ovf + groups.push(t + prop, push_count, push_do)
        height = height + owi
        h_found = height  # after the find, before any adoption
        nbt = torch.where(found_due, t + dt, nbt)

        # Notify sweep, gated: deferred while another find is due this ms.
        do = active & ~(found_due & (nbt == t))
        t_flush = torch.where(do, t, neg_gate)
        base, unarrived = groups.flush(t_flush, base)

        # Best published chain (private blocks excluded), first-seen
        # tiebreak, lowest miner index.
        pub = height - unarrived
        if exact:
            pub = pub - npriv
        best_h = pub.amax(0)
        cand = pub == best_h
        tipm = torch.where(cand, base, inf)
        best_tip = tipm.amin(0)
        b = torch.where(cand & (tipm == best_tip), midx, m).amin(0).long()  # (R,)
        onehot_b = midx == b
        b32 = onehot_b.to(I32)

        if any_selfish:
            # Selfish reveal, before the reorg: publish enough private
            # blocks to match or beat the best chain.
            lead = height - best_h
            can_reveal = sel & (lead >= 0) & (npriv > lead) & do
            reveal_n = torch.where((npriv > 1) & (lead == 1), npriv, npriv - lead)
            ovf = ovf + groups.push(t + prop, reveal_n, can_reveal)
            npriv = torch.where(can_reveal, npriv - reveal_n, npriv)

        # Reorg: adopt when strictly longer than the whole local chain;
        # reads of b's rows (gathers, or contractions with the one-hot of
        # b) with the diagonal corrections.
        adopt = (best_h > height) & do
        if onehot:
            at_b = lambda arr: (arr * b32).sum(0, dtype=I32)  # arr[b] as a contraction
            oc_b = (ocp * b32[None]).sum(1, dtype=I32)  # own_cp[:, b]
            row_b = (oin * b32[:, None]).sum(0, dtype=I32)  # own_in[b, :]
        else:
            at_b = take
            oc_b = ocp.gather(1, b.view(1, 1, r).expand(m, 1, r))[:, 0]  # own_cp[:, b]
            row_b = oin.gather(0, b.view(1, 1, r).expand(1, m, r))[0]  # own_in[b, :]
        unpub_b = at_b(height) - best_h
        cnt_b = at_b(ocnt)
        oc_b = oc_b + b32 * (cnt_b - at_b(oc_b))
        d_stale = torch.where(adopt, ocnt - oc_b, 0)
        stale = stale + d_stale
        row_b = row_b + b32 * (cnt_b - at_b(row_b))
        row_bpub = row_b - unpub_b * b32
        if exact:
            # cpb[j, o] = cp[b, j, o]; its j == b row is stale but every
            # consumer masks it out. Factored update (tpusim.state.notify):
            #   Y[j] = (a_j | b_j) ? b_pub : cpb[j];  W[i] = b_i ? b_pub : cpb[i]
            #   cp[i, j] = a_i ? Y[j] : (a_j ? W[i] : cp[i, j])
            if onehot:
                # Contractions in the count type: one term is nonzero.
                bc = onehot_b.to(cp.dtype)[:, None, None]
                cpb = (cp * bc).sum(0, dtype=cp.dtype).to(I32)  # (M, M, R)
                cpb_diag = torch.where(eye, cpb, 0).sum(1, dtype=I32)  # (M, R) cp[b, i, i]
            else:
                cpb = cp.gather(0, b.view(1, 1, 1, r).expand(1, m, m, r))[0].to(I32)
                cpb_diag = cpb[diag, diag]  # (M, R) cp[b, i, i]
            y_val = torch.where((adopt | onehot_b)[:, None], row_bpub[None], cpb)
            w_val = torch.where(onehot_b[:, None], row_bpub[None], cpb)
            cp = torch.where(
                adopt[:, None, None], y_val[None].to(cp.dtype),
                torch.where(adopt[None, :, None], w_val[:, None].to(cp.dtype), cp),
            )
            # own_cp[i, j] = cp[i, j, i]: the a_i case is Y[j, i], the a_j
            # case W[i, i].
            wo = torch.where(onehot_b, row_bpub, cpb_diag)
            ocp = torch.where(
                adopt[:, None], y_val.transpose(0, 1),
                torch.where(adopt[None, :], wo[:, None], ocp),
            )
            npriv = torch.where(adopt, 0, npriv)
            bhp = torch.where(do, best_h, bhp)
        else:
            col_cp = oc_b - unpub_b * b32
            ocp = torch.where(
                adopt[:, None] | adopt[None],
                torch.where(adopt, row_bpub, col_cp)[:, None],
                ocp,
            )
        oin = torch.where(adopt[:, None], row_bpub[None], oin)
        ocnt = torch.where(adopt, row_bpub, ocnt)
        height = torch.where(adopt, best_h, height)
        base = torch.where(adopt, best_tip, base)
        groups.clear(adopt)

        # Cut-through to the next event.
        earliest = groups.earliest(t)
        t = torch.where(active, torch.maximum(torch.minimum(nbt, earliest), t), t)

        dmax = d_stale.amax(0)
        mre = torch.maximum(mre, dmax)
        sev = sev + (dmax > 0).to(I32)
        act = act + active.to(I32)
        sbm = sbm + (d_stale > 0).to(I32)
        rdh = rdh + ((bidx == torch.clamp_max(dmax, rdh.shape[0]) - 1) & (dmax > 0)).to(I32)

        if flight is not None:
            # Row 1, the find or the arrival: arrivals are classified on the
            # step-entry groups; the arrival miner owns the earliest flushed
            # group (lowest index on ties).
            pmin = pmin_per.amin(0)
            arr_miner = torch.where(pmin_per == pmin, midx, m).amin(0)
            rec1 = found_due | (do & (pmin < inf))
            kind1 = torch.where(found_due, KIND_FIND, KIND_ARRIVAL)
            miner1 = torch.where(found_due, (midx * owi).sum(0, dtype=I32), arr_miner)
            h_src = torch.where(found_due, h_found, height)
            h1 = torch.where(midx == miner1, h_src, 0).sum(0, dtype=I32)
            fcnt = push_row(fbuf, fcnt, rec1, kind1, miner1, h1, torch.zeros_like(dmax))
            # Row 2, the adoption: stale if it popped own blocks, else reorg;
            # the adopter with the deepest pop, lowest index on ties.
            score = torch.where(adopt, d_stale, -1)
            miner2 = torch.where(adopt & (score == score.amax(0)), midx, m).amin(0)
            h2 = torch.where(midx == miner2, height, 0).sum(0, dtype=I32)
            kind2 = torch.where(dmax > 0, KIND_STALE, KIND_REORG)
            fcnt = push_row(fbuf, fcnt, adopt.any(0), kind2, miner2, h2, dmax)

    garr, gcnt = groups.stacked()
    new = dict(
        t=t[None], nbt=nbt[None], height=height, stale=stale, base=base, garr=garr, gcnt=gcnt,
        ocp=ocp, oin=oin, ocnt=ocnt, ovf=ovf[None],
    )
    if exact:
        new.update(bhp=bhp[None], npriv=npriv, cp=cp)
    out = (*(new[n] for n in names), mre[None], sev[None], act[None], sbm, rdh)
    out = tuple(x.to(dt).contiguous() for x, dt in zip(out, dtypes))
    if flight is not None:
        flight = (fbuf, fcnt[None].contiguous(), flight[2].clone())
    return out[: len(leaves)], out[len(leaves):], flight


class _SplitGroups:
    """The arrival-group buffer at K = 2 as split (M, R) slots, the
    reference's split-slot specialization (pallas_engine.py:251-269, 358-366,
    525-533)."""

    def __init__(self, garr, gcnt):
        self.a0, self.a1 = garr[:, 0], garr[:, 1]
        self.c0, self.c1 = gcnt[:, 0], gcnt[:, 1]

    def push(self, arrival, count, do):
        """Append an (arrival, count) group per miner where ``do`` is set
        (pallas push_groups2): the first empty slot, an equal arrival merged
        into the last occupied slot, slot 1 accumulating on overflow.
        Returns the overflow count per run."""
        a0, a1, c0, c1 = self.a0, self.a1, self.c0, self.c1
        e0, e1 = c0 > 0, c1 > 0
        last_arr = torch.where(e1, a1, a0)
        merge = do & e0 & (last_arr == arrival)
        overflowed = do & ~merge & e1
        w0 = do & (~e0 | (merge & ~e1))
        w1 = do & e0 & (e1 | ~merge)
        accum = merge | overflowed
        self.a0 = torch.where(w0, arrival, a0)
        self.c0 = torch.where(w0, torch.where(accum, c0 + count, count), c0)
        self.a1 = torch.where(w1, arrival, a1)
        self.c1 = torch.where(w1, torch.where(accum, c1 + count, count), c1)
        return overflowed.to(I32).sum(0, dtype=I32)

    def flush(self, t_flush, base):
        """Flush the groups arrived by ``t_flush``: the last one's arrival
        becomes the miner's ``base``. Returns ``(base, unarrived count)``."""
        a0, a1, c0, c1 = self.a0, self.a1, self.c0, self.c1
        f0, f1 = a0 <= t_flush, a1 <= t_flush
        base = torch.where(f1, a1, torch.where(f0, a0, base))
        self.a0 = torch.where(f1, INF_TIME, torch.where(f0, a1, a0))
        self.a1 = torch.where(f0, INF_TIME, a1)
        self.c0 = torch.where(f1, 0, torch.where(f0, c1, c0))
        self.c1 = torch.where(f0, 0, c1)
        return base, self.c0 + self.c1

    def clear(self, adopt):
        self.a0 = torch.where(adopt, INF_TIME, self.a0)
        self.a1 = torch.where(adopt, INF_TIME, self.a1)
        self.c0, self.c1 = torch.where(adopt, 0, self.c0), torch.where(adopt, 0, self.c1)

    def earliest(self, t):
        """The earliest pending arrival after ``t`` over all miners (R,)."""
        p0 = torch.where(self.a0 > t, self.a0, INF_TIME)
        p1 = torch.where(self.a1 > t, self.a1, INF_TIME)
        return torch.minimum(p0, p1).amin(0)

    def arrived_min(self, t):
        """Each miner's earliest group arrived by ``t`` (INF if none), (M, R)."""
        return torch.minimum(torch.where(self.a0 <= t, self.a0, INF_TIME),
                             torch.where(self.a1 <= t, self.a1, INF_TIME))

    def stacked(self):
        return torch.stack([self.a0, self.a1], dim=1), torch.stack([self.c0, self.c1], dim=1)


class _Groups:
    """The arrival-group buffer at K >= 3, (M, K, R) (K5c: the reference's
    generic K-slot machinery, pallas_engine.py:233-249, 367-379, 535-539)."""

    def __init__(self, garr, gcnt):
        self.garr, self.gcnt = garr, gcnt
        self.k = garr.shape[1]
        self.kidx = torch.arange(self.k, dtype=I32, device=garr.device)[:, None]  # (K, 1)

    def push(self, arrival, count, do):
        """pallas push_groups: append at the first empty slot; an equal
        arrival merges into the last occupied slot; a full buffer merges
        into its last slot (the overflow, counted). Returns the overflow
        count per run."""
        k = self.k
        n = (self.gcnt > 0).sum(1, dtype=I32)  # (M, R) occupied slots
        last = torch.clamp_min(n - 1, 0)
        last_arr = self.garr.gather(1, last[:, None].long())[:, 0]
        merge = do & (n > 0) & (last_arr == arrival)
        overflowed = do & ~merge & (n == k)
        write = torch.where(merge | overflowed, last, torch.clamp_max(n, k - 1))
        onehot = (self.kidx == write[:, None]) & do[:, None]  # (M, K, R)
        accum = (merge | overflowed)[:, None]
        cnt = torch.broadcast_to(torch.as_tensor(count, dtype=I32, device=do.device),
                                 do.shape)[:, None]
        self.garr = torch.where(onehot, arrival[:, None], self.garr)
        self.gcnt = torch.where(onehot, torch.where(accum, self.gcnt + cnt, cnt), self.gcnt)
        return overflowed.to(I32).sum(0, dtype=I32)

    def flush(self, t_flush, base):
        """Flush the n_f groups arrived by ``t_flush``: the last one's
        arrival becomes the miner's ``base``, and the rest shift left by
        n_f (INF arrivals and 0 counts fill the tail). Returns ``(base,
        unarrived count)``."""
        n_f = (self.garr <= t_flush).sum(1, dtype=I32)  # (M, R)
        tip = self.garr.gather(1, torch.clamp_min(n_f - 1, 0)[:, None].long())[:, 0]
        base = torch.where(n_f > 0, tip, base)
        src = self.kidx + n_f[:, None]  # (M, K, R): slot d takes slot d + n_f
        keep = src < self.k
        src = torch.clamp_max(src, self.k - 1).long()
        self.garr = torch.where(keep, self.garr.gather(1, src), INF_TIME)
        self.gcnt = torch.where(keep, self.gcnt.gather(1, src), 0)
        return base, self.gcnt.sum(1, dtype=I32)

    def clear(self, adopt):
        self.garr = torch.where(adopt[:, None], INF_TIME, self.garr)
        self.gcnt = torch.where(adopt[:, None], 0, self.gcnt)

    def earliest(self, t):
        return torch.where(self.garr > t, self.garr, INF_TIME).amin(1).amin(0)

    def arrived_min(self, t):
        return torch.where(self.garr <= t, self.garr, INF_TIME).amin(1)

    def stacked(self):
        return self.garr, self.gcnt


def map_raw_words(words: torch.Tensor, sampler: Sampler) -> torch.Tensor:
    """The raw-word variants' mapping alone (K5a's device functions, built
    into every raw-word library): ``words`` int32 bit patterns (2, N), the
    winner words then the interval words, to int32 (2, N), the winners then
    the intervals, for one roster's ``sampler``. Launches the mapping kernel
    for CUDA tensors and takes :func:`map_raw_words_plain` only for tensors
    on the CPU."""
    devices = {x.device for x in (words, *sampler)}
    if len(devices) != 1:
        raise ValueError(f"map_raw_words: tensors on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return map_raw_words_plain(words, sampler)
    if device.type != "cuda":
        raise ValueError(f"map_raw_words runs on CUDA or the CPU, not {device}")
    from .csrc.build import MAP_ENTRY, NARROW_MAX_MINERS as narrow, load_library

    m, n = sampler.lo.shape[0], words.shape[1]
    _check("words", words, (2, n), (I32,))
    _check_sampler(sampler, m, n, packed=False)
    out = torch.empty_like(words)
    kernel = "event_loop_fast" + "_wide" * (m > narrow) + "_raw"
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        lib = load_library(kernel, m, 2)
        err = getattr(lib, MAP_ENTRY[0])(words.data_ptr(), *[x.data_ptr() for x in sampler], n,
                                         out.data_ptr(), stream)
    if err:
        raise RuntimeError(
            f"map_raw_words kernel launch failed: {lib.tpusim_cuda_error_string(err).decode()}")
    launches["map_raw_words"] += 1
    return out


def map_raw_words_plain(words: torch.Tensor, sampler: Sampler) -> torch.Tensor:
    """The plain PyTorch version of :func:`map_raw_words`: the sampler's own
    mappings, ``sampling.winners_from_bits`` over the thresholds (``hi``)
    and ``sampling.interval_from_bits``."""
    w = words.long() & MASK
    return torch.stack([winners_from_bits(w[0], sampler.hi.long() & MASK),
                        interval_from_bits(w[1], sampler.mean)])
