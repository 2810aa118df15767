"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX (the machine with the card has none), so on the card run it without
the suite's conftest, which configures JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

``-k micro`` runs the layout micro-benchmarks' tests alone (S1: one nvcc,
seconds); ``-k 'xoro or consumed'`` the xoroshiro path's (X1, X2 and X2r);
``-k fast_selfish`` the fast kernel's selfish form's (K1s, K3fs, K4fs).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusim_torch import event_loop, packed, threefry
from tpusim_torch.config import (
    MinerConfig, NetworkConfig, SimConfig, default_network, hetero_selfish_network,
    reference_selfish_network,
)
from tpusim_torch.engine import Engine, counters_to_kernel
from tpusim_torch.event_loop import event_loop_chunk_plain, state_to_kernel
from tpusim_torch.flight import FLIGHT_LEAVES, flight_to_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _mid_run(cfg: SimConfig, runs: int, chunks: int):
    """Engine, keys, state and aux after ``chunks`` plain-version chunks."""
    eng = Engine(cfg, "cuda", event_loop=event_loop_chunk_plain)
    keys = eng.make_keys(0, runs)
    state, aux = eng._init(keys)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    for i in range(chunks):
        state, aux, _ = eng._chunk(state, aux, cap, keys, i)
    return eng, keys, state, aux, cap


#: A 50 ms interval with 0-3 ms delays: same-ms finds, merges, overflows.
BURSTY = NetworkConfig(
    miners=tuple(MinerConfig(hashrate_pct=p, propagation_ms=d)
                 for p, d in ((40, 0), (30, 3), (20, 0), (10, 1))),
    block_interval_s=0.05,
)


@pytest.mark.parametrize(
    "state_dtype,count_rebase,network",
    [("int16", True, default_network()), ("int32", True, default_network()),
     ("int16", False, default_network()), ("int16", True, default_network(10_000)),
     ("auto", True, BURSTY)],
    ids=["int16", "int32", "int16-stale16", "racy", "bursty"],
)
def test_kernel_chunk_equals_plain(cuda, state_dtype, count_rebase, network):
    cfg = SimConfig(network=network, duration_ms=30 * 86_400_000,
                    mode="fast", state_dtype=state_dtype, count_rebase=count_rebase)
    # 1000 runs: not a multiple of the kernel's 64-thread block.
    eng, keys, state, aux, cap = _mid_run(cfg, 1000, 1)
    # Ragged chunk ends: frozen from the start, freezing within the chunk.
    cap = cap.clone()
    cap[:50] = 0
    cap[50:300] = torch.arange(1, 250 * 1600, 1600, dtype=torch.int32, device="cuda")
    rows = eng._rows(keys, 1)
    counters = counters_to_kernel(aux[0])
    leaves = state_to_kernel(state)
    before = event_loop.launches["event_loop_fast"]
    got = event_loop.event_loop_chunk(rows, cap, eng.params.prop_ms, leaves, counters)
    torch.cuda.synchronize()
    assert event_loop.launches["event_loop_fast"] == before + 1
    want = event_loop_chunk_plain(rows, cap, eng.params.prop_ms, leaves, counters)
    for name, g, w in zip(event_loop.FAST_LEAVES + event_loop.TELE_LEAVES,
                          got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


def test_run_batch_kernel_equals_plain(cuda):
    cfg = SimConfig(network=default_network(), duration_ms=10 * 86_400_000, runs=256,
                    batch_size=256, seed=3)
    kern = Engine(cfg, "cuda")
    plain = Engine(cfg, "cuda", event_loop=event_loop_chunk_plain)
    a = kern.run_batch(kern.make_keys(0, 256))
    b = plain.run_batch(plain.make_keys(0, 256))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize(
    "state_dtype,count_rebase,network",
    [("auto", True, reference_selfish_network()), ("int32", True, reference_selfish_network()),
     ("int16", False, reference_selfish_network()), ("auto", True, default_network(10_000)),
     ("int32", False, default_network(10_000)), ("auto", True, hetero_selfish_network())],
    ids=["selfish", "selfish-int32", "selfish-stale16", "honest", "honest-int32", "hetero"],
)
def test_exact_kernel_chunk_equals_plain(cuda, state_dtype, count_rebase, network):
    cfg = SimConfig(network=network, duration_ms=30 * 86_400_000, state_dtype=state_dtype,
                    count_rebase=count_rebase)
    eng, keys, state, aux, cap = _mid_run(cfg, 1000, 1)
    assert eng.exact
    cap = cap.clone()
    cap[:50] = 0
    cap[50:300] = torch.arange(1, 250 * 1600, 1600, dtype=torch.int32, device="cuda")
    args = (eng._rows(keys, 1), cap, eng.params.prop_ms, state_to_kernel(state),
            counters_to_kernel(aux[0]), eng.selfish)
    before = event_loop.launches["event_loop_exact"]
    got = event_loop.event_loop_chunk(*args)
    torch.cuda.synchronize()
    assert event_loop.launches["event_loop_exact"] == before + 1
    want = event_loop_chunk_plain(*args)
    for name, g, w in zip(event_loop.EXACT_LEAVES + event_loop.TELE_LEAVES,
                          got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


def test_exact_run_batch_kernel_equals_plain(cuda):
    cfg = SimConfig(network=reference_selfish_network(), duration_ms=10 * 86_400_000,
                    runs=256, batch_size=256, seed=3)
    kern = Engine(cfg, "cuda")
    plain = Engine(cfg, "cuda", event_loop=event_loop_chunk_plain)
    a = kern.run_batch(kern.make_keys(0, 256))
    b = plain.run_batch(plain.make_keys(0, 256))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize(
    "network,mode,state_dtype,count_rebase,capacity",
    [(default_network(), "fast", "int16", True, 64), (BURSTY, "fast", "auto", True, 2048),
     (reference_selfish_network(), "auto", "int16", True, 64),
     (hetero_selfish_network(), "auto", "auto", False, 64),
     (default_network(10_000), "auto", "int32", True, 2048)],
    ids=["fast-wraps", "fast-bursty", "selfish-wraps", "hetero-wraps", "honest-exact"],
)
def test_flight_kernel_chunk_equals_plain(cuda, network, mode, state_dtype, count_rebase,
                                          capacity):
    """K3f and K3x: every state leaf, counter and ring leaf equal to the
    plain version's, from a mid-run state (h_base != 0 under re-basing)."""
    cfg = SimConfig(network=network, duration_ms=30 * 86_400_000, mode=mode,
                    state_dtype=state_dtype, count_rebase=count_rebase,
                    flight_capacity=capacity)
    eng, keys, state, aux, cap = _mid_run(cfg, 1000, 1)
    ctr, fr, _ = aux
    assert bool(fr.h_base.any()) == count_rebase
    cap = cap.clone()
    cap[:50] = 0
    cap[50:300] = torch.arange(1, 250 * 1600, 1600, dtype=torch.int32, device="cuda")
    flight = flight_to_kernel(fr)
    args = (eng._rows(keys, 1), cap, eng.params.prop_ms, state_to_kernel(state),
            counters_to_kernel(ctr), eng.selfish, flight)
    kernel = "event_loop_exact_flight" if eng.exact else "event_loop_fast_flight"
    before = dict(event_loop.launches)
    got = event_loop.event_loop_chunk(*args)
    torch.cuda.synchronize()
    assert event_loop.launches == {**before, kernel: before[kernel] + 1}
    want = event_loop_chunk_plain(*args)
    names = (event_loop.EXACT_LEAVES if eng.exact else event_loop.FAST_LEAVES)
    for name, g, w in zip(names + event_loop.TELE_LEAVES + FLIGHT_LEAVES,
                          got[0] + got[1] + got[2], want[0] + want[1] + want[2]):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    assert int((got[2][1] - flight[1]).max()) > 64  # a 64-row ring wrapped


@pytest.mark.parametrize("network", [default_network(), reference_selfish_network()],
                         ids=["fast", "selfish"])
def test_flight_run_batch_kernel_equals_plain(cuda, network):
    cfg = SimConfig(network=network, duration_ms=10 * 86_400_000, runs=256, batch_size=256,
                    seed=3, flight_capacity=512)
    kern = Engine(cfg, "cuda")
    plain = Engine(cfg, "cuda", event_loop=event_loop_chunk_plain)
    a = kern.run_batch(kern.make_keys(0, 256))
    b = plain.run_batch(plain.make_keys(0, 256))
    assert a.keys() == b.keys() and "flight_buf" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_interval_mapping_cuda_equals_cpu(cuda):
    from tpusim_torch.sampling import interval_from_bits

    words = torch.arange(2**24, dtype=torch.int64) << 8
    for mean in (600_000.0, 60_000.0):
        assert torch.equal(interval_from_bits(words.to(cuda), mean).cpu(),
                           interval_from_bits(words, mean))


def test_threefry_words_cuda_equal_cpu(cuda):
    keys_c = threefry.make_run_keys(11, 0, 512, cuda)
    keys_h = threefry.make_run_keys(11, 0, 512, "cpu")
    assert torch.equal(keys_c.cpu(), keys_h)
    assert torch.equal(threefry.chunk_words(keys_c, 3, 64).cpu(),
                       threefry.chunk_words(keys_h, 3, 64))


DAY = 86_400_000


def _lane_configs(kind: str, **kwargs) -> list[SimConfig]:
    """Four lane groups of one packed batch, 30 days, propagation from
    100 ms to 60 s; in the selfish pack the flags differ per group and one
    group is wholly honest (it must take no selfish branch)."""
    props = (100, 1000, 10_000, 60_000)
    if kind == "selfish":
        nets = [default_network(props[0], selfish_ids=(0,)), default_network(props[1]),
                default_network(props[2], selfish_ids=(2,)), reference_selfish_network()]
    else:
        nets = [default_network(p) for p in props]
    mode = kwargs.pop("mode", "fast" if kind == "fast" else "exact")
    kwargs.setdefault("duration_ms", 30 * DAY)
    return [SimConfig(network=n, mode=mode, **kwargs) for n in nets]


def _packed_engine(cfgs, counts, **kwargs) -> Engine:
    eng = Engine(cfgs[0], "cuda", packed=True, **kwargs)
    eng.params = packed.stack_params(cfgs, counts, "cuda")
    eng.run_durations = np.repeat([c.duration_ms for c in cfgs], counts)
    return eng


@pytest.mark.parametrize("kind", ["fast", "exact", "selfish"])
def test_packed_kernel_chunk_equals_plain(cuda, kind):
    """K4f and K4x (with and without SELFISH): per-run delays and flags,
    from a mid-run state, with ragged chunk ends."""
    runs, counts = 1000, [300, 200, 250, 250]
    eng = _packed_engine(_lane_configs(kind), counts, event_loop=event_loop_chunk_plain)
    keys = eng.make_keys(0, runs)
    state, aux = eng._init(keys)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    cap[:50] = 0
    cap[50:300] = torch.arange(1, 250 * 1600, 1600, dtype=torch.int32, device="cuda")
    prop, selfish = eng.roster()
    assert prop.shape == (9, runs)
    assert torch.is_tensor(selfish) == (kind == "selfish")
    args = (eng._rows(keys, 1), cap, prop, state_to_kernel(state), counters_to_kernel(aux[0]),
            selfish)
    kernel = "event_loop_fast_packed" if kind == "fast" else "event_loop_exact_packed"
    before = dict(event_loop.launches)
    got = event_loop.event_loop_chunk(*args)
    torch.cuda.synchronize()
    assert event_loop.launches == {**before, kernel: before[kernel] + 1}
    want = event_loop_chunk_plain(*args)
    names = event_loop.FAST_LEAVES if kind == "fast" else event_loop.EXACT_LEAVES
    for name, g, w in zip(names + event_loop.TELE_LEAVES, got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("kind", ["fast", "selfish"])
def test_packed_dispatch_kernel_equals_plain(cuda, kind):
    cfgs = _lane_configs(kind, runs=64, batch_size=64, seed=5)
    pieces = [packed._Piece(i, 0, 64) for i in range(len(cfgs))]
    kern = packed._dispatch(Engine(cfgs[0], "cuda", packed=True), cfgs, pieces, 256)
    plain = packed._dispatch(Engine(cfgs[0], "cuda", packed=True,
                                    event_loop=event_loop_chunk_plain), cfgs, pieces, 256)
    assert kern.keys() == plain.keys() and "stale_rate_per_run" in kern
    for k in kern:
        np.testing.assert_array_equal(kern[k], plain[k], err_msg=k)


def test_packed_grid_card_equals_cpu(cuda):
    cfgs = _lane_configs("fast", runs=16, batch_size=8, seed=2)[:3]
    pts = [(f"p{i}", dataclasses.replace(c, duration_ms=DAY)) for i, c in enumerate(cfgs)]
    on_card = packed.run_grid(pts, device="cuda")
    on_cpu = packed.run_grid(pts, device="cpu")
    for a, b in zip(on_card, on_cpu):
        for k in b["sums"]:
            np.testing.assert_array_equal(a["sums"][k], b["sums"][k], err_msg=k)


#: A 1 s interval with delays up to 10 s: several groups in flight per
#: miner, so three slots overflow and a fourth fills.
CROWDED = NetworkConfig(
    miners=tuple(MinerConfig(hashrate_pct=p, propagation_ms=d)
                 for p, d in ((40, 10_000), (30, 100), (20, 1500), (10, 0))),
    block_interval_s=1.0,
)


def _compare_chunk(eng, keys, state, aux, cap, kernel: str) -> tuple:
    """The kernel's chunk 1 against the plain version's, every state leaf,
    counter and ring leaf; asserts ``kernel`` launched once and no other."""
    ctr, fr, _ = aux
    prop, selfish = eng.roster()
    args = (eng._rows(keys, 1), cap, prop, state_to_kernel(state), counters_to_kernel(ctr),
            selfish, None if fr is None else flight_to_kernel(fr))
    kw = eng.loop_options()
    before = dict(event_loop.launches)
    got = event_loop.event_loop_chunk(*args, **kw)
    torch.cuda.synchronize()
    assert event_loop.launches == {**before, kernel: before[kernel] + 1}
    want = event_loop_chunk_plain(*args, **kw)
    names = event_loop.LEAVES[event_loop.state_form(state)]
    names += event_loop.TELE_LEAVES + (FLIGHT_LEAVES if fr is not None else ())
    assert len(names) == len(got[0] + got[1] + (got[2] or ()))
    for name, g, w in zip(names, got[0] + got[1] + (got[2] or ()),
                          want[0] + want[1] + (want[2] or ())):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    return got


def _ragged(cap):
    cap = cap.clone()
    cap[:50] = 0
    cap[50:300] = torch.arange(1, 250 * 1600, 1600, dtype=torch.int32, device="cuda")
    return cap


@pytest.mark.parametrize(
    "network,mode,k,state_dtype,count_rebase",
    [(default_network(10_000), "fast", 3, "int16", True), (CROWDED, "fast", 4, "int32", False),
     (CROWDED, "exact", 3, "auto", True), (default_network(10_000), "auto", 4, "int32", True),
     (reference_selfish_network(), "auto", 3, "int16", False),
     (reference_selfish_network(), "auto", 4, "auto", True)],
    ids=["fast-k3", "fast-crowded-k4", "exact-crowded-k3", "honest-k4", "selfish-k3",
         "selfish-k4"],
)
def test_group_slots_kernel_chunk_equals_plain(cuda, network, mode, k, state_dtype,
                                               count_rebase):
    """K5c in both modes: the generic K-slot buffer, overflow merges included."""
    cfg = SimConfig(network=network, duration_ms=2 * DAY, mode=mode, group_slots=k,
                    state_dtype=state_dtype, count_rebase=count_rebase)
    eng, keys, state, aux, cap = _mid_run(cfg, 1000, 1)
    got = _compare_chunk(eng, keys, state, aux, _ragged(cap),
                         "event_loop_exact" if eng.exact else "event_loop_fast")
    if network is CROWDED:
        names = event_loop.EXACT_LEAVES if eng.exact else event_loop.FAST_LEAVES
        ovf = got[0][names.index("ovf")]
        assert bool((ovf > state.overflow[None]).any())


@pytest.mark.parametrize(
    "kind,k,capacity",
    [("fast", 2, 64), ("exact", 2, 64), ("selfish", 2, 2048), ("selfish", 4, 0),
     ("selfish", 4, 64)],
    ids=["fast-ring", "exact-ring", "selfish-ring", "selfish-k4", "selfish-k4-ring"],
)
def test_packed_flight_and_k4_kernel_chunk_equals_plain(cuda, kind, k, capacity):
    """K4 x K3 (the packed chunk with the ring) and K5c packed, from a
    mid-run state with ragged chunk ends."""
    runs, counts = 1000, [300, 200, 250, 250]
    eng = _packed_engine(_lane_configs(kind, duration_ms=2 * DAY, group_slots=k,
                                       flight_capacity=capacity), counts,
                         event_loop=event_loop_chunk_plain)
    keys = eng.make_keys(0, runs)
    state, aux = eng._init(keys)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    kernel = ("event_loop_fast" if kind == "fast" else "event_loop_exact") + "_packed"
    got = _compare_chunk(eng, keys, state, aux, _ragged(cap),
                         kernel + ("_flight" if capacity else ""))
    if capacity == 64:
        assert int((got[2][1] - aux[1].count[None]).max()) > 64  # the ring wrapped


def test_group_slots_flight_kernel_chunk_equals_plain(cuda):
    cfg = SimConfig(network=reference_selfish_network(), duration_ms=2 * DAY, group_slots=4,
                    flight_capacity=64)
    eng, keys, state, aux, cap = _mid_run(cfg, 1000, 1)
    _compare_chunk(eng, keys, state, aux, _ragged(cap), "event_loop_exact_flight")


#: Four miners of equal hashrate with 1 ms delays and a 200 ms interval:
#: equal best published heights and first-seen tips in every run, finds
#: that collide, and adopters popping equally deep (miner 0 selfish).
TIES = NetworkConfig(
    miners=tuple(MinerConfig(hashrate_pct=25, propagation_ms=1, selfish=i == 0)
                 for i in range(4)),
    block_interval_s=0.2,
)
#: The narrow exact kernel's variants (K2s, K2h, K3x, K4x with the ring,
#: K5c, K5a, K5b): network (or "packed" for the selfish lane groups), group
#: slots, ring capacity and config options.
NARROW_EXACT_CASES = {
    "selfish": (reference_selfish_network(), 2, 0, {}),
    "honest": (default_network(10_000), 2, 0, dict(state_dtype="int32", count_rebase=False)),
    "ties-ring": (TIES, 2, 64, {}),
    "selfish-k4-ring": (reference_selfish_network(), 4, 64, {}),
    "crowded-k3": (CROWDED, 3, 0, {}),
    "packed-ring": ("packed", 2, 64, {}),
    "packed-raw": ("packed", 2, 0, dict(rng_batch=False)),
    "raw": (reference_selfish_network(), 2, 0, dict(rng_batch=False)),
    "onehot": (TIES, 2, 0, dict(consensus_gather=False)),
}


@pytest.fixture(scope="module")
def narrow_exact_libraries():
    """The libraries of NARROW_EXACT_CASES, built at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from tpusim_torch.csrc import build

    build.build([("event_loop_exact", 9, 2), ("event_loop_exact", 4, 2),
                 ("event_loop_exact_flight", 4, 2), ("event_loop_exact_flight", 9, 4),
                 ("event_loop_exact", 4, 3), ("event_loop_exact_packed_flight", 9, 2),
                 ("event_loop_exact_raw", 9, 2), ("event_loop_exact_onehot", 4, 2)])


@pytest.mark.parametrize("runs", [1, 3, 17, 1000])
@pytest.mark.parametrize("case", list(NARROW_EXACT_CASES))
def test_narrow_exact_kernel_at_any_run_count(cuda, narrow_exact_libraries, case, runs):
    """The narrow exact kernel (a 16-lane group a run, 8 runs a block) at
    run counts below one block, of a partial last block and of many blocks,
    every run's chunk end somewhere else (stopped at once, within the chunk,
    or never): every leaf equal to the plain version's."""
    network, k, capacity, options = NARROW_EXACT_CASES[case]
    if network == "packed":
        cfgs = _lane_configs("selfish", duration_ms=2 * DAY, flight_capacity=capacity,
                             chunk_steps=320)
        cfgs = cfgs[:min(runs, len(cfgs))]
        counts = [runs // len(cfgs) + (i < runs % len(cfgs)) for i in range(len(cfgs))]
        eng = _packed_engine(cfgs, counts, event_loop=event_loop_chunk_plain)
        keys = eng.make_keys(0, runs)
        state, aux = eng._init(keys)
        cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
        state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
        kernel = "event_loop_exact_packed_flight"
    else:
        cfg = SimConfig(network=network, duration_ms=2 * DAY, mode="exact", group_slots=k,
                        flight_capacity=capacity, chunk_steps=320, **options)
        eng, keys, state, aux, cap = _mid_run(cfg, runs, 1)
        kernel = ("event_loop_exact" + ("_raw" if "rng_batch" in options else "")
                  + ("_onehot" if "consensus_gather" in options else "")
                  + ("_flight" if capacity else ""))
    i = torch.arange(runs, device="cuda", dtype=torch.int32)
    cap = torch.where(i % 3 == 1, (i + 1) * 1600, cap)  # early in the chunk
    cap = torch.where(i % 7 == 2, (i + 1) * (2**28 // runs), cap)  # anywhere in it
    cap = torch.where(i % 5 == 4, 0, cap).to(torch.int32)  # at once
    _compare_chunk(eng, keys, state, aux, cap, kernel)


def test_group_slots_run_batch_card_equals_cpu(cuda):
    cfg = SimConfig(network=reference_selfish_network(), duration_ms=2 * DAY, runs=256,
                    batch_size=256, seed=3, group_slots=4)
    a, b = Engine(cfg, "cuda"), Engine(cfg, "cpu")
    x, y = a.run_batch(a.make_keys(0, 256)), b.run_batch(b.make_keys(0, 256))
    assert x.keys() == y.keys()
    for key in x:
        np.testing.assert_array_equal(x[key], y[key], err_msg=key)


def test_packed_flight_grid_card_equals_cpu(cuda):
    # The selfish lane groups (one shape: the second group is honest).
    cfgs = _lane_configs("selfish", runs=16, batch_size=8, seed=2, flight_capacity=256)
    cfgs = [c for c in cfgs if c.network.any_selfish]
    pts = [(f"p{i}", dataclasses.replace(c, duration_ms=DAY)) for i, c in enumerate(cfgs)]
    on_card = packed.run_grid(pts, device="cuda")
    on_cpu = packed.run_grid(pts, device="cpu")
    for a, b in zip(on_card, on_cpu):
        for k in b["sums"]:
            np.testing.assert_array_equal(a["sums"][k], b["sums"][k], err_msg=k)
        assert a["flight"].events == b["flight"].events and a["flight"].events


#: Wide rosters (more than 16 miners: K1w and K2w). hetero32's hashrates at
#: the default 1 s (fast mode, path W1), the hetero32 roster itself (exact,
#: path W2), a 20-miner roster with a 40 % selfish miner, and 40 honest
#: miners with delays up to 60 s (no miner set fits a 32-bit mask).
H32 = (14, 11, 9, 8, 6, 5, 4, 3) + (2,) * 16 + (1,) * 8


def _wide_roster(hashrates, delays, selfish=()) -> NetworkConfig:
    return NetworkConfig(miners=tuple(
        MinerConfig(hashrate_pct=h, propagation_ms=d, selfish=i in selfish)
        for i, (h, d) in enumerate(zip(hashrates, delays))))


def _hetero32() -> NetworkConfig:
    from tpusim_torch.sweep import baseline_sweeps

    return baseline_sweeps()["hetero32"]()[0][1].network


W1 = default_network(hashrates=H32)
SELFISH20 = _wide_roster((40,) + (4,) * 3 + (3,) * 16, [1000] * 20, selfish=(0,))
HONEST40 = _wide_roster((3,) * 20 + (2,) * 20, [int(100 * 600 ** (i / 39)) for i in range(40)])


@pytest.mark.parametrize(
    "network,k,state_dtype,capacity",
    [(W1, 2, "auto", 0), (W1, 2, "int32", 0), (W1, 4, "auto", 0), (W1, 2, "auto", 64),
     ("hetero32", 2, "auto", 0), ("hetero32", 2, "int32", 0), ("hetero32", 2, "auto", 64),
     (SELFISH20, 4, "auto", 0), (SELFISH20, 2, "int16", 64), (HONEST40, 2, "auto", 0)],
    ids=["w1", "w1-int32", "w1-k4", "w1-ring", "hetero32", "hetero32-int32", "hetero32-ring",
         "selfish20-k4", "selfish20-ring", "honest40"],
)
def test_wide_kernel_chunk_equals_plain(cuda, network, k, state_dtype, capacity):
    """K1w and K2w (with FLIGHT, at K = 4, int16 and int32), from a
    mid-run state with ragged chunk ends, at 512 runs."""
    network = _hetero32() if network == "hetero32" else network
    cfg = SimConfig(network=network, duration_ms=2 * DAY, group_slots=k,
                    state_dtype=state_dtype, flight_capacity=capacity)
    eng, keys, state, aux, cap = _mid_run(cfg, 512, 1)
    kernel = ("event_loop_exact" if eng.exact else "event_loop_fast") + "_wide"
    _compare_chunk(eng, keys, state, aux, _ragged(cap), kernel + ("_flight" if capacity else ""))


@pytest.mark.parametrize("kind,capacity", [("fast", 0), ("fast", 64), ("selfish", 0),
                                           ("selfish", 64)],
                         ids=["fast", "fast-ring", "selfish", "selfish-ring"])
def test_wide_packed_kernel_chunk_equals_plain(cuda, kind, capacity):
    """K1w and K2w packed (with and without the ring): per-run delays and
    selfish flags, one lane group wholly honest."""
    if kind == "fast":
        nets = [W1, default_network(2000, hashrates=H32)]
        counts = [300, 212]
    else:
        hs = (40,) + (4,) * 3 + (3,) * 16
        nets = [SELFISH20, _wide_roster(hs, [10_000] * 20),
                _wide_roster(hs, [60_000] * 20, selfish=(2,))]
        counts = [200, 200, 112]
    cfgs = [SimConfig(network=n, mode="fast" if kind == "fast" else "exact", duration_ms=2 * DAY,
                      flight_capacity=capacity) for n in nets]
    eng = _packed_engine(cfgs, counts, event_loop=event_loop_chunk_plain)
    runs = sum(counts)
    keys = eng.make_keys(0, runs)
    state, aux = eng._init(keys)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    kernel = ("event_loop_fast" if kind == "fast" else "event_loop_exact") + "_wide_packed"
    _compare_chunk(eng, keys, state, aux, _ragged(cap), kernel + ("_flight" if capacity else ""))


def test_hetero32_run_batch_card_equals_cpu(cuda):
    cfg = SimConfig(network=_hetero32(), duration_ms=2 * DAY, runs=64, batch_size=64, seed=3)
    a, b = Engine(cfg, "cuda"), Engine(cfg, "cpu")
    x, y = a.run_batch(a.make_keys(0, 64)), b.run_batch(b.make_keys(0, 64))
    assert x.keys() == y.keys()
    for key in x:
        np.testing.assert_array_equal(x[key], y[key], err_msg=key)


#: 33 miners: lane 0 of the wide exact kernel's warp owns miners 0 and 32,
#: the selfish one.
SELFISH33 = _wide_roster((3,) * 2 + (2,) * 30 + (34,),
                         [int(100 * 600 ** (i / 32)) for i in range(33)], selfish=(32,))
#: The wide exact kernel's variants (K2w: ±SELFISH, FLIGHT, PACKED, K >= 3,
#: raw words, one-hot, int16 and int32; M = 20, 32, 33 and 40, at M = 40
#: with int32 counts the form that keeps cp in device memory): network (or
#: "packed" for 20-miner lane groups), group slots, ring capacity and
#: config options.
WIDE_EXACT_CASES = {
    "hetero32": ("hetero32", 2, 0, {}),
    "hetero32-int32": ("hetero32", 2, 0, dict(state_dtype="int32")),
    "selfish20": (SELFISH20, 2, 0, {}),
    "selfish33": (SELFISH33, 2, 0, {}),
    "selfish33-int32-ring": (SELFISH33, 2, 64, dict(state_dtype="int32")),
    "honest40": (HONEST40, 2, 0, {}),
    "honest40-int32": (HONEST40, 2, 0, dict(state_dtype="int32", count_rebase=False)),
    "hetero32-ring": ("hetero32", 2, 64, {}),
    "hetero32-k4": ("hetero32", 4, 0, {}),
    "selfish20-k3-ring": (SELFISH20, 3, 64, {}),
    "packed": ("packed", 2, 0, {}),
    "packed-ring": ("packed", 2, 64, {}),
    "packed-raw": ("packed", 2, 0, dict(rng_batch=False)),
    "raw": (SELFISH20, 2, 0, dict(rng_batch=False)),
    "onehot": (SELFISH33, 2, 0, dict(consensus_gather=False)),
    "onehot-int32-global": (HONEST40, 2, 0, dict(consensus_gather=False, state_dtype="int32")),
    "raw-onehot-ring": (SELFISH20, 2, 64, dict(rng_batch=False, consensus_gather=False)),
}


def _wide_exact_kernel(network, capacity: int, options: dict) -> str:
    return ("event_loop_exact_wide" + ("_raw" if "rng_batch" in options else "")
            + ("_onehot" if "consensus_gather" in options else "")
            + ("_packed" if network == "packed" else "") + ("_flight" if capacity else ""))


@pytest.fixture(scope="module")
def wide_exact_libraries():
    """The libraries of WIDE_EXACT_CASES, built at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from tpusim_torch.csrc import build

    libs = set()
    for network, k, capacity, options in WIDE_EXACT_CASES.values():
        m = 20 if network == "packed" else 32 if network == "hetero32" else network.n_miners
        libs.add((_wide_exact_kernel(network, capacity, options), m, k))
    build.build(sorted(libs))


@pytest.mark.parametrize("runs", [1, 3, 17, 1000])
@pytest.mark.parametrize("case", list(WIDE_EXACT_CASES))
def test_wide_exact_kernel_at_any_run_count(cuda, wide_exact_libraries, case, runs):
    """The wide exact kernel (a warp a run, one run a block) at run counts
    of one, a few and many waves, every run's chunk end somewhere else
    (stopped at once, within the chunk, or never): every leaf equal to the
    plain version's."""
    network, k, capacity, options = WIDE_EXACT_CASES[case]
    if network == "packed":
        hs = (40,) + (4,) * 3 + (3,) * 16
        nets = [SELFISH20, _wide_roster(hs, [10_000] * 20),
                _wide_roster(hs, [60_000] * 20, selfish=(2,))]
        nets = nets[:min(runs, len(nets))]
        counts = [runs // len(nets) + (i < runs % len(nets)) for i in range(len(nets))]
        cfgs = [SimConfig(network=n, mode="exact", duration_ms=2 * DAY, group_slots=k,
                          flight_capacity=capacity, chunk_steps=320, **options) for n in nets]
        eng = _packed_engine(cfgs, counts, event_loop=event_loop_chunk_plain)
        keys = eng.make_keys(0, runs)
        state, aux = eng._init(keys)
        cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
        state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    else:
        cfg = SimConfig(network=_hetero32() if network == "hetero32" else network,
                        duration_ms=2 * DAY, mode="exact", group_slots=k,
                        flight_capacity=capacity, chunk_steps=320, **options)
        eng, keys, state, aux, cap = _mid_run(cfg, runs, 1)
    i = torch.arange(runs, device="cuda", dtype=torch.int32)
    cap = torch.where(i % 3 == 1, (i + 1) * 1600, cap)  # early in the chunk
    cap = torch.where(i % 7 == 2, (i + 1) * (2**28 // runs), cap)  # anywhere in it
    cap = torch.where(i % 5 == 4, 0, cap).to(torch.int32)  # at once
    _compare_chunk(eng, keys, state, aux, cap, _wide_exact_kernel(network, capacity, options))


def _spread(m: int) -> tuple[int, ...]:
    """m integer hashrate percentages summing to 100, unequal."""
    w = [m - i + i % 3 for i in range(m)]
    hs = [max(1, 100 * x // sum(w)) for x in w]
    return (hs[0] + 100 - sum(hs),) + tuple(hs[1:])


def _fast_roster(m: int, crowded: bool = False) -> NetworkConfig:
    """m honest miners with delays from 100 ms to 30 s; ``crowded`` at a
    1 s interval with delays up to 10 s, so that most events fork."""
    if crowded:
        return NetworkConfig(miners=tuple(
            MinerConfig(hashrate_pct=h, propagation_ms=(i * 7919) % 10_000)
            for i, h in enumerate(_spread(m))), block_interval_s=1.0)
    return _wide_roster(_spread(m), [int(100 * 300 ** (i / max(m - 1, 1))) for i in range(m)])


#: m honest miners of equal hashrate with 1 ms delays at a 200 ms interval:
#: equal best heights and first-seen tips, adopters popping equally deep.
def _fast_ties(m: int) -> NetworkConfig:
    hs = [100 // m] * m
    return NetworkConfig(miners=tuple(
        MinerConfig(hashrate_pct=h + (i == 0) * (100 - sum(hs)), propagation_ms=1)
        for i, h in enumerate(hs)), block_interval_s=0.2)


#: The fast kernel's variants (K1, K3f, K4f, K4 x K3, K5c, K5a, K5b and the
#: wide forms, int16 and int32 counts; M = 2 to 40, at 33 and 40 two miners
#: a lane): network (or "packed" for 9-miner lane groups), group slots,
#: ring capacity and config options.
FAST_CASES = {
    "m2": (_fast_roster(2), 2, 0, {}),
    "m2-int32": (_fast_roster(2, True), 2, 0, dict(state_dtype="int32", count_rebase=False)),
    "m4-bursty-ring": (BURSTY, 2, 64, {}),
    "m4-crowded-k3": (CROWDED, 3, 0, {}),
    "m9": (default_network(), 2, 0, {}),
    "m9-int32": (_fast_roster(9, True), 2, 0, dict(state_dtype="int32")),
    "m9-ties-ring": (_fast_ties(9), 2, 64, {}),
    "m9-k4-ring": (_fast_roster(9, True), 4, 64, {}),
    "m9-raw": (default_network(), 2, 0, dict(rng_batch=False)),
    "m9-onehot": (_fast_ties(9), 2, 0, dict(consensus_gather=False)),
    "m13": (_fast_roster(13, True), 2, 0, {}),
    "m16-int32-k4": (_fast_roster(16, True), 4, 0, dict(state_dtype="int32",
                                                         count_rebase=False)),
    "packed-ring": ("packed", 2, 64, {}),
    "packed-raw": ("packed", 2, 0, dict(rng_batch=False)),
    "m17": (_fast_roster(17, True), 2, 0, {}),
    "m24-k4": (_fast_roster(24), 4, 0, {}),
    "w1": (W1, 2, 0, {}),
    "w1-int32-ring": (W1, 2, 64, dict(state_dtype="int32")),
    "m32-crowded-onehot": (_fast_roster(32, True), 2, 0, dict(consensus_gather=False)),
    "m33": (_fast_ties(33), 2, 0, {}),
    "m33-int32-ring": (_fast_roster(33, True), 2, 64, dict(state_dtype="int32")),
    "m40": (_fast_roster(40, True), 2, 0, {}),
    "m40-int32-raw-onehot": (_fast_roster(40), 2, 0, dict(
        state_dtype="int32", count_rebase=False, rng_batch=False, consensus_gather=False)),
}


def _fast_kernel(m: int, capacity: int, options: dict, packed_run: bool) -> str:
    return ("event_loop_fast" + ("_wide" if m > event_loop.NARROW_MAX_MINERS else "")
            + ("_raw" if "rng_batch" in options else "")
            + ("_onehot" if "consensus_gather" in options else "")
            + ("_packed" if packed_run else "") + ("_flight" if capacity else ""))


@pytest.fixture(scope="module")
def fast_libraries():
    """The libraries of FAST_CASES, built at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from tpusim_torch.csrc import build

    libs = set()
    for network, k, capacity, options in FAST_CASES.values():
        m = 9 if network == "packed" else network.n_miners
        libs.add((_fast_kernel(m, capacity, options, network == "packed"), m, k))
    build.build(sorted(libs))


@pytest.mark.parametrize("runs", [1, 3, 17, 1000])
@pytest.mark.parametrize("case", list(FAST_CASES))
def test_fast_kernel_at_any_run_count(cuda, fast_libraries, case, runs):
    """The fast kernel (a group of lanes a run: 16 up to 16 miners, 8 runs
    a block; a warp above, 4 runs a block) at run counts below one block,
    of a partial last block and of many blocks, every run's chunk end
    somewhere else (stopped at once, within the chunk, or never): every
    leaf equal to the plain version's."""
    network, k, capacity, options = FAST_CASES[case]
    if network == "packed":
        cfgs = _lane_configs("fast", duration_ms=2 * DAY, flight_capacity=capacity,
                             chunk_steps=320, **options)
        cfgs = cfgs[:min(runs, len(cfgs))]
        counts = [runs // len(cfgs) + (i < runs % len(cfgs)) for i in range(len(cfgs))]
        eng = _packed_engine(cfgs, counts, event_loop=event_loop_chunk_plain)
        keys = eng.make_keys(0, runs)
        state, aux = eng._init(keys)
        cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
        state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    else:
        cfg = SimConfig(network=network, duration_ms=2 * DAY, mode="fast", group_slots=k,
                        flight_capacity=capacity, chunk_steps=320, **options)
        eng, keys, state, aux, cap = _mid_run(cfg, runs, 1)
    i = torch.arange(runs, device="cuda", dtype=torch.int32)
    cap = torch.where(i % 3 == 1, (i + 1) * 1600, cap)  # early in the chunk
    cap = torch.where(i % 7 == 2, (i + 1) * (2**28 // runs), cap)  # anywhere in it
    cap = torch.where(i % 5 == 4, 0, cap).to(torch.int32)  # at once
    m = eng.n_miners
    _compare_chunk(eng, keys, state, aux, cap,
                   _fast_kernel(m, capacity, options, network == "packed"))


# ---------------------------------------------------------------------------
# The raw-word (K5a) and one-hot (K5b) variants, the layout micro-benchmarks
# (S1), and the SASS of the libraries that predate them.

KNOBS = {"raw": dict(rng_batch=False), "onehot": dict(consensus_gather=False),
         "raw_onehot": dict(rng_batch=False, consensus_gather=False)}
KNOB_CASES = {
    "fast": (default_network(), "fast", 2, 0),
    "fast-ring": (BURSTY, "fast", 2, 64),
    "fast-k4": (default_network(10_000), "fast", 4, 0),
    "selfish": (reference_selfish_network(), "auto", 2, 0),
    "selfish-ring": (reference_selfish_network(), "auto", 2, 64),
    "selfish-k4": (reference_selfish_network(), "auto", 4, 0),
    "hetero-selfish": (hetero_selfish_network(), "auto", 2, 0),
    "w1": (W1, "fast", 2, 0),
    "hetero32": ("hetero32", "auto", 2, 0),
}


def _knob_kernel(network: NetworkConfig, exact: bool, knobs: str, capacity: int,
                 packed_run: bool = False) -> str:
    return (("event_loop_exact" if exact else "event_loop_fast")
            + ("_wide" if network.n_miners > event_loop.NARROW_MAX_MINERS else "")
            + f"_{knobs}" + ("_packed" if packed_run else "") + ("_flight" if capacity else ""))


@pytest.fixture(scope="module")
def knob_libraries():
    """Every library the knob tests below launch, built at once (one nvcc
    each, in parallel) rather than one at a time at first use."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from tpusim_torch.csrc import build

    libs = set()
    for knobs in KNOBS:
        for network, mode, k, capacity in KNOB_CASES.values():
            network = _hetero32() if network == "hetero32" else network
            exact = SimConfig(network=network, mode=mode).resolved_mode == "exact"
            libs.add((_knob_kernel(network, exact, knobs, capacity), network.n_miners, k))
        for exact in (False, True):
            libs.add((_knob_kernel(default_network(), exact, knobs, 0, True), 9, 2))
    build.build(sorted(libs))


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("case", list(KNOB_CASES))
def test_knob_kernel_chunk_equals_plain(cuda, knob_libraries, knobs, case):
    """K5a, K5b and both, in each mode, with the ring, at K = 4 and wide,
    from a mid-run state with ragged chunk ends, at 512 runs."""
    network, mode, k, capacity = KNOB_CASES[case]
    network = _hetero32() if network == "hetero32" else network
    cfg = SimConfig(network=network, duration_ms=2 * DAY, mode=mode, group_slots=k,
                    flight_capacity=capacity, **KNOBS[knobs])
    eng, keys, state, aux, cap = _mid_run(cfg, 512, 1)
    _compare_chunk(eng, keys, state, aux, _ragged(cap),
                   _knob_kernel(network, eng.exact, knobs, capacity))


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("kind", ["fast", "selfish"])
def test_knob_packed_kernel_chunk_equals_plain(cuda, knob_libraries, knobs, kind):
    """The packed raw-word and one-hot variants: per-run thresholds and
    means (one lane group at a 300 s interval), delays and flags."""
    cfgs = _lane_configs(kind, duration_ms=2 * DAY, **KNOBS[knobs])
    cfgs[1] = dataclasses.replace(
        cfgs[1], network=dataclasses.replace(cfgs[1].network, block_interval_s=300.0))
    eng = _packed_engine(cfgs, [300, 200, 250, 250], event_loop=event_loop_chunk_plain)
    keys = eng.make_keys(0, 1000)
    state, aux = eng._init(keys)
    cap = torch.full((1000,), 2**29, dtype=torch.int32, device="cuda")
    state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    _compare_chunk(eng, keys, state, aux, _ragged(cap),
                   _knob_kernel(default_network(), kind != "fast", knobs, 0, True))


@pytest.mark.parametrize("knobs", ["raw", "onehot"])
def test_knob_run_batch_card_equals_cpu(cuda, knob_libraries, knobs):
    cfg = SimConfig(network=reference_selfish_network(), duration_ms=2 * DAY, runs=64,
                    batch_size=64, seed=3, **KNOBS[knobs])
    a, b = Engine(cfg, "cuda"), Engine(cfg, "cpu")
    x, y = a.run_batch(a.make_keys(0, 64)), b.run_batch(b.make_keys(0, 64))
    assert x.keys() == y.keys()
    for key in x:
        np.testing.assert_array_equal(x[key], y[key], err_msg=key)


def test_raw_word_mapping_over_all_uniforms(cuda, knob_libraries):
    """K5a's device mapping: all 2^24 uniforms at four means, and the
    thresholds' edge words, as ``sampling`` maps them."""
    from tpusim_torch.sampling import interval_from_bits, winners_from_bits
    from tpusim_torch.state import make_params

    thr = make_params(SimConfig(network=default_network()), "cuda").thresholds
    words = torch.arange(2**24, dtype=torch.int64, device="cuda") << 8
    both = threefry.to_int32(torch.stack([words, words]))
    for mean in (600_000.0, 60_000.0, 1_000.0, 3_600_000.0):
        got = event_loop.map_raw_words(both, event_loop.make_sampler(thr, mean))
        assert torch.equal(got[1], interval_from_bits(words, mean)), mean
        assert torch.equal(got[0], winners_from_bits(words, thr)), mean
    edge = torch.cat([thr - 1, thr, thr + 1, torch.tensor([0, 2**32 - 1], device="cuda")])
    got = event_loop.map_raw_words(threefry.to_int32(torch.stack([edge, edge])),
                                   event_loop.make_sampler(thr, 600_000.0))
    assert torch.equal(got[0], winners_from_bits(edge, thr))


@pytest.fixture(scope="module")
def micro_library():
    """The layout micro-benchmarks' library alone (S1), so that ``-k micro``
    builds nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from tpusim_torch.csrc import build

    build.build([(build.MICRO, 0, 0)])


@pytest.mark.parametrize("iters", [0, 1, 64])
@pytest.mark.parametrize("lanes", [1, 127, 129, 1000, 8193])
@pytest.mark.parametrize("op", ["sel3", "sel_flat", "reshape", "repeat", "tile", "segsum",
                                "contract"])
def test_micro_kernel_equals_plain(cuda, micro_library, op, lanes, iters):
    """Each S1 kernel == its plain version: one lane, a ragged last block
    (127, 129, 1,000) and a group of entries split across blocks (8,193
    lanes), at 0, 1 and 64 iterations."""
    from tpusim_torch import micro

    inputs = micro.make_inputs(op, lanes, "cuda")
    before = micro.launches[op]
    got = micro.run(op, inputs, iters)
    torch.cuda.synchronize()
    assert micro.launches[op] == before + 1
    assert torch.equal(got, micro.run_plain(op, inputs, iters))


#: Digests of the SASS (``cuobjdump -sass``, addresses, encodings and the
#: path-derived hash in anonymous-namespace names stripped) of the
#: libraries that predate the raw-word and one-hot variants, for one nvcc
#: release: the fast ones as the group-of-lanes fast kernel compiles them,
#: the narrow exact ones as the group-per-run exact kernel compiles them,
#: the wide exact ones as the warp-per-run exact kernel does.
SASS_PIN = Path(__file__).with_name("torch_sass_digests.json")


def _sass_digest(path) -> str:
    import hashlib
    import re
    import subprocess

    from tpusim_torch.csrc import build

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    lines = []
    for line in text.splitlines():
        line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
        line = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", line)
        line = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", line).strip()
        if line:
            lines.append(line)
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def test_existing_libraries_keep_their_sass(cuda):
    """The 39 libraries of the variants that predate K5a and K5b compile to
    their pinned instructions: the 18 fast and wide fast libraries to the
    kernel that runs a group of lanes a run (16 up to 16 miners, a warp
    above), the 15 narrow exact ones to the kernel that runs a 16-lane group
    a run, the 6 wide exact ones to the kernel that runs a warp a run."""
    import subprocess

    from tpusim_torch.csrc import build

    pin = json.loads(SASS_PIN.read_text())
    release = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    if release != pin["nvcc"]:
        pytest.skip(f"SASS pinned for {pin['nvcc']}, this is {release}")
    libs = {}
    for key in pin["digests"]:
        name, m, k = key.rsplit("-", 2)
        libs[name, int(m[1:]), int(k[1:])] = key
    built = build.build(libs)
    changed = [key for lib, key in libs.items()
               if _sass_digest(built[lib][0]) != pin["digests"][key]]
    assert not changed, f"SASS changed: {changed}"


# ---------------------------------------------------------------------------
# Run-axis sharding (K6): shards that share one card, and shards on every card.


def _sharded_equals_unsharded(devices, network, capacity=0, runs=384):
    cfg = SimConfig(network=network, duration_ms=10 * 86_400_000, runs=runs, batch_size=runs,
                    seed=13, flight_capacity=capacity)
    one = Engine(cfg, devices[0])
    sharded = Engine(cfg, devices=devices)
    a = one.run_batch(one.make_keys(0, runs))
    for k in event_loop.launches:
        event_loop.launches[k] = 0
    b = sharded.run_batch(sharded.make_keys(0, runs))
    assert sum(event_loop.launches.values()) >= len(devices)  # every shard launched
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("kind", ["fast", "selfish", "ring"])
def test_shards_on_one_card_equal_unsharded(cuda, shards, kind):
    network = default_network() if kind == "fast" else reference_selfish_network()
    _sharded_equals_unsharded(["cuda:0"] * shards, network, capacity=64 if kind == "ring" else 0)


def test_shards_on_every_card_equal_one_card(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 or more CUDA devices, this host has {n}")
    for network in (default_network(), reference_selfish_network()):
        _sharded_equals_unsharded([f"cuda:{i}" for i in range(n)], network, runs=128 * n)


# ---------------------------------------------------------------------------
# The xoroshiro path: the row sampler X1 and the consumed-row event loops X2.

#: X1's cases: run counts of one run, of a partial last 32-run block, of
#: many blocks and a partial one; uniform and per-run rosters; 1 step, a
#: tile less and more one step (the tile as the built kernel gives it), and
#: several tiles (the ring wraps).
@pytest.mark.parametrize("steps", ["1", "tile-1", "tile+1", "320"])
@pytest.mark.parametrize("runs", [1, 17, 1000, 8193])
@pytest.mark.parametrize("per_run", [False, True], ids=["uniform", "per-run"])
def test_xoro_rows_kernel_equals_plain(cuda, runs, per_run, steps):
    """X1 from mid-run streams (each run a different number of draws
    consumed, 0 and the whole chunk included): every row and every stream
    word equal to the plain version's."""
    from tpusim_torch import xoroshiro
    from tpusim_torch.csrc import build

    tile = build.xoro_shape(build.load_xoro())["kTile"]
    steps = {"1": 1, "tile-1": tile - 1, "tile+1": tile + 1, "320": 320}[steps]
    streams = torch.from_numpy(xoroshiro.pack_run_streams(7, 5, runs).view(np.int32)).cuda()
    consumed = torch.from_numpy(
        np.random.default_rng(runs).integers(0, steps + 1, runs).astype(np.int32)).cuda()
    consumed[:: max(runs // 3, 1)] = 0
    consumed[1:: max(runs // 3, 1)] = steps
    if per_run:
        cfgs = [SimConfig(network=n) for n in (
            default_network(), reference_selfish_network(),
            default_network(hashrates=(20, 20, 20, 10, 10, 10, 5, 4, 1)),
            NetworkConfig(miners=default_network().miners, block_interval_s=1.0))]
        counts = [runs // 4 + (i < runs % 4) for i in range(4)]
        smp = xoroshiro.make_xoro_sampler(packed.stack_params(cfgs, counts, "cuda"))
    else:
        smp = xoroshiro.make_xoro_sampler(Engine(SimConfig(network=BURSTY), "cuda").params)
    before = xoroshiro.launches["xoroshiro_rows"]
    rows, out = xoroshiro.xoro_rows(streams, consumed, smp, steps)
    torch.cuda.synchronize()
    assert xoroshiro.launches["xoroshiro_rows"] == before + 1
    want_rows, want_out = xoroshiro.xoro_rows_plain(streams, consumed, smp, steps)
    assert torch.equal(out, want_out)
    assert torch.equal(rows, want_rows)


def test_xoro_interval_mapping_card_equals_cpu(cuda):
    """X1's interval mapping alone: the first rows of 2^20 runs' streams on
    the card against the CPU's plain version, at the 600 s, 60 s and 1 s
    means."""
    from tpusim_torch import xoroshiro

    n = 2**20
    streams = torch.from_numpy(xoroshiro.pack_run_streams(11, 0, n).view(np.int32))
    consumed = torch.zeros((n,), dtype=torch.int32)
    for mean in (600_000.0, 60_000.0, 1_000.0):
        smp = xoroshiro.XoroSampler(torch.tensor([-1], dtype=torch.int32),
                                    torch.tensor([-1], dtype=torch.int32),
                                    torch.tensor([mean], dtype=torch.float64))
        want = xoroshiro.xoro_rows_plain(streams, consumed, smp, 2)[0]
        got = xoroshiro.xoro_rows(streams.cuda(), consumed.cuda(),
                                  xoroshiro.XoroSampler(*(x.cuda() for x in smp)), 2)[0]
        assert torch.equal(got.cpu(), want), mean


#: X2's forms: (network or "packed", mode, group slots, ring capacity,
#: config options).
CONSUMED_CASES = {
    "fast": (default_network(), "fast", 2, 0, {}),
    "fast-bursty-ring": (BURSTY, "fast", 2, 64, {}),
    "fast-k4-onehot": (_fast_roster(9, True), "fast", 4, 0, dict(consensus_gather=False)),
    "fast-packed": ("packed", "fast", 2, 0, {}),
    "fast-packed-ring": ("packed", "fast", 2, 64, {}),
    "fast-w1": (W1, "fast", 2, 0, {}),
    "selfish": (reference_selfish_network(), "exact", 2, 0, {}),
    "selfish-ring": (reference_selfish_network(), "exact", 2, 64, {}),
    "selfish-k4-onehot": (reference_selfish_network(), "exact", 4, 0,
                          dict(consensus_gather=False)),
    "honest": (default_network(10_000), "exact", 2, 0, dict(state_dtype="int32")),
    "selfish-packed": ("packed", "selfish", 2, 0, {}),
    "selfish-packed-ring": ("packed", "selfish", 2, 64, {}),
    "selfish20": (SELFISH20, "exact", 2, 0, {}),
    "hetero32-ring": ("hetero32", "exact", 2, 64, {}),
}


def _consumed_kernel(m: int, mode: str, capacity: int, options: dict, packed_run: bool) -> str:
    return (f"event_loop_{'fast' if mode == 'fast' else 'exact'}"
            + ("_wide" if m > event_loop.NARROW_MAX_MINERS else "") + "_consumed"
            + ("_onehot" if "consensus_gather" in options else "")
            + ("_packed" if packed_run else "") + ("_flight" if capacity else ""))


def _consumed_case(case: str):
    network, mode, k, capacity, options = CONSUMED_CASES[case]
    m = 9 if network == "packed" else 32 if network == "hetero32" else network.n_miners
    return network, mode, k, capacity, options, m


@pytest.fixture(scope="module")
def consumed_libraries():
    """The libraries of CONSUMED_CASES and X1, built at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from tpusim_torch.csrc import build

    libs = {(build.XORO, 0, 0)}
    for case in CONSUMED_CASES:
        network, mode, k, capacity, options, m = _consumed_case(case)
        libs.add((_consumed_kernel(m, mode, capacity, options, network == "packed"), m, k))
    build.build(sorted(libs))


def _consumed_chunk(case: str, runs: int):
    """A CONSUMED_CASES engine after one plain chunk: the engine, its state,
    its aux and the chunk's rows (X1's plain version)."""
    from tpusim_torch.xoroshiro import xoro_rows_plain

    network, mode, k, capacity, options, m = _consumed_case(case)
    plain = dict(event_loop=event_loop_chunk_plain, row_sampler=xoro_rows_plain)
    kw = dict(duration_ms=2 * DAY, group_slots=k, flight_capacity=capacity, chunk_steps=320,
              rng="xoroshiro", **options)
    if network == "packed":
        cfgs = _lane_configs(mode, **kw)
        cfgs = cfgs[:min(runs, len(cfgs))]
        counts = [runs // len(cfgs) + (i < runs % len(cfgs)) for i in range(len(cfgs))]
        eng = _packed_engine(cfgs, counts, **plain)
    else:
        net = _hetero32() if network == "hetero32" else network
        eng = Engine(SimConfig(network=net, mode=mode, **kw), "cuda", **plain)
    keys = eng.make_keys(0, runs)
    state, aux = eng._init(keys)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    rows = xoro_rows_plain(aux[3], aux[4], eng.xoro_sampler(), eng.chunk_steps)[0]
    return eng, state, aux, rows


def _consumed_kernel_equals_plain(case: str, eng, rows, cap, leaves, aux):
    """X2 on the card against its plain version on one chunk: every leaf and
    the consumed counts; returns the counts."""
    network, mode, k, capacity, options, m = _consumed_case(case)
    ctr, fr = aux[:2]
    prop, selfish = eng.roster()
    args = (rows, cap, prop, leaves, counters_to_kernel(ctr), selfish,
            None if fr is None else flight_to_kernel(fr))
    opts = dict(onehot="consensus_gather" in options, consumed_rows=True)
    kernel = _consumed_kernel(m, mode, capacity, options, network == "packed")
    before = dict(event_loop.launches)
    got = event_loop.event_loop_chunk(*args, **opts)
    torch.cuda.synchronize()
    assert event_loop.launches == {**before, kernel: before[kernel] + 1}
    want = event_loop_chunk_plain(*args, **opts)
    names = event_loop.EXACT_LEAVES if eng.exact else event_loop.FAST_LEAVES
    names += event_loop.TELE_LEAVES + (FLIGHT_LEAVES if fr is not None else ()) + ("consumed",)
    for name, g, w in zip(names, got[0] + got[1] + (got[2] or ()) + got[3:],
                          want[0] + want[1] + (want[2] or ()) + want[3:]):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    return got[3]


@pytest.mark.parametrize("runs", [1, 3, 17, 1000])
@pytest.mark.parametrize("case", list(CONSUMED_CASES))
def test_consumed_row_kernel_at_any_run_count(cuda, consumed_libraries, case, runs):
    """X2 in each form the xoroshiro paths run, from a mid-run state (one
    plain chunk) with ragged chunk ends, on X1's rows: every leaf and the
    consumed counts equal to the plain version's."""
    eng, state, aux, rows = _consumed_chunk(case, runs)
    i = torch.arange(runs, device="cuda", dtype=torch.int32)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    cap = torch.where(i % 3 == 1, (i + 1) * 1600, cap)  # early in the chunk
    cap = torch.where(i % 7 == 2, (i + 1) * (2**28 // runs), cap)  # anywhere in it
    cap = torch.where(i % 5 == 4, 0, cap).to(torch.int32)  # at once
    used = _consumed_kernel_equals_plain(case, eng, rows, cap, state_to_kernel(state), aux)
    assert int(used.max()) > 0 or runs < 17


@pytest.mark.parametrize("runs", [3, 1000])
@pytest.mark.parametrize("case", ["fast", "fast-w1", "fast-bursty-ring", "fast-packed",
                                  "fast-packed-ring", "selfish"])
def test_consumed_row_kernel_on_consecutive_finds(cuda, consumed_libraries, case, runs):
    """X2 where runs find on consecutive steps: every other run's intervals
    are 0 ms, and every fourth starts the chunk on a find (its next block
    due now), so it finds on every step and consumes the chunk's last row
    (its count reaches the chunk's steps); the other runs are as X1 drew
    them. Every leaf and the consumed counts equal the plain version's."""
    eng, state, aux, rows = _consumed_chunk(case, runs)
    i = torch.arange(runs, device="cuda")
    rows[:, 1, i % 2 == 0] = 0
    leaves = list(state_to_kernel(state))
    leaves[1] = torch.where(i % 4 == 0, leaves[0], leaves[1]).contiguous()  # nbt = t
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    used = _consumed_kernel_equals_plain(case, eng, rows, cap, tuple(leaves), aux)
    assert bool((used[i % 4 == 0] == eng.chunk_steps).all())


@pytest.mark.parametrize("roster", ["default", "selfish"])
def test_xoroshiro_run_batch_card_equals_cpu(cuda, consumed_libraries, roster):
    """A 64-run x 2-day xoroshiro batch through X1 and X2 on the card, key for
    key equal to the plain versions' on the CPU, each kernel launched once a
    chunk."""
    from tpusim_torch import xoroshiro

    net = default_network() if roster == "default" else reference_selfish_network()
    cfg = SimConfig(network=net, duration_ms=2 * DAY, runs=64, batch_size=64, seed=5,
                    rng="xoroshiro")
    gpu, cpu = Engine(cfg, "cuda"), Engine(cfg, "cpu")
    for k in event_loop.launches:
        event_loop.launches[k] = 0
    before = xoroshiro.launches["xoroshiro_rows"]
    a = gpu.run_batch(gpu.make_keys(0, 64))
    kernel = f"event_loop_{'exact' if roster == 'selfish' else 'fast'}_consumed"
    assert {k: v for k, v in event_loop.launches.items() if v} == {kernel: a["tele_chunks_max"]}
    assert xoroshiro.launches["xoroshiro_rows"] - before == a["tele_chunks_max"]
    b = cpu.run_batch(cpu.make_keys(0, 64))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_consumed_row_libraries_keep_their_sass(cuda):
    """The consumed-row libraries and X1 compile to their pinned
    instructions (the ``xoroshiro`` set of torch_sass_digests.json), for the
    nvcc release they were pinned with."""
    import subprocess

    from tpusim_torch.csrc import build

    pin = json.loads(SASS_PIN.read_text())
    release = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    if release != pin["nvcc"]:
        pytest.skip(f"SASS pinned for {pin['nvcc']}, this is {release}")
    libs = {}
    for key in pin["xoroshiro"]:
        name, m, k = key.rsplit("-", 2)
        libs[name, int(m[1:]), int(k[1:])] = key
    built = build.build(libs)
    changed = [key for lib, key in libs.items()
               if _sass_digest(built[lib][0]) != pin["xoroshiro"][key]]
    assert not changed, f"SASS changed: {changed}"


# ---------------------------------------------------------------------------
# The dispatch paths on the card: the device loop, run_batch(pipelined=True),
# run_batch(host_loop=True) and run_batch_async(keys)(), key for key.

DISPATCH_ROSTERS = {
    "k1": (default_network(), {}, "event_loop_fast"),
    "k2s": (reference_selfish_network(), {}, "event_loop_exact"),
    "x2": (default_network(), {"rng": "xoroshiro"}, "event_loop_fast_consumed"),
}


@pytest.mark.parametrize("roster", list(DISPATCH_ROSTERS))
def test_dispatch_paths_agree_on_the_card(cuda, roster):
    """1,000 runs x 2 days on each path, key for key the device loop's;
    each path launches its kernel once a chunk it enqueues: the busy
    chunks, and on the pipelined path at most two no-op chunks behind
    them."""
    from tpusim_torch import xoroshiro

    net, kw, kernel = DISPATCH_ROSTERS[roster]
    cfg = SimConfig(network=net, duration_ms=2 * DAY, runs=1000, batch_size=1000, seed=11,
                    **kw)
    eng = Engine(cfg, "cuda")
    keys = eng.make_keys(0, 1000)
    outs, launches = {}, {}
    for path, call in (("device", lambda: eng.run_batch(keys)),
                       ("pipelined", lambda: eng.run_batch(keys, pipelined=True)),
                       ("host_loop", lambda: eng.run_batch(keys, host_loop=True)),
                       ("async", lambda: eng.run_batch_async(keys)())):
        for k in event_loop.launches:
            event_loop.launches[k] = 0
        x1 = xoroshiro.launches["xoroshiro_rows"]
        outs[path] = call()
        torch.cuda.synchronize()
        launches[path] = {k: v for k, v in event_loop.launches.items() if v}
        assert xoroshiro.launches["xoroshiro_rows"] - x1 == (
            launches[path][kernel] if "rng" in kw else 0)
    busy = int(outs["device"]["tele_chunks_max"])
    for path, got in outs.items():
        assert got.keys() == outs["device"].keys()
        for k in got:
            np.testing.assert_array_equal(got[k], outs["device"][k], err_msg=f"{path}: {k}")
        assert set(launches[path]) == {kernel}, path
        extra = launches[path][kernel] - busy
        assert extra in ((0, 1, 2) if path == "pipelined" else (0,)), (path, extra)


def test_dispatch_async_two_batches_in_flight(cuda):
    """Two 1,000-run batches dispatched before either is finalized, and a
    third dispatched then cancelled: each finalized batch equals its own
    synchronous run, and the cancelled one's thread is gone."""
    cfg = SimConfig(network=reference_selfish_network(), duration_ms=2 * DAY, runs=3000,
                    batch_size=1000, seed=12)
    eng = Engine(cfg, "cuda")
    ka, kb, kc = (eng.make_keys(i * 1000, 1000) for i in range(3))
    fa, fb = eng.run_batch_async(ka), eng.run_batch_async(kb)
    fc = eng.run_batch_async(kc)
    got_b, got_a = fb(), fa()
    fc.cancel()
    assert not fc._thread.is_alive()
    for got, keys in ((got_a, ka), (got_b, kb)):
        want = eng.run_batch(keys)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# The measurement harness on the card: the chained chunks against the CPU's,
# and the copy probe against the card's HBM3 peak; the plain version, replayed
# from a CUDA graph on the card, against its loop on the CPU.

#: HBM3 bandwidth of one H100 SXM (NVIDIA's data sheet), bytes/s.
HBM3_BYTES_PER_S = 3.35e12


@pytest.mark.parametrize("rng", ["threefry", "xoroshiro"])
@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_perf_chained_chunks_on_the_card_equal_the_cpu(cuda, mode, rng):
    """The perf protocol's chain (``profiling.chained_chunks``) at 64 runs x
    2 chunks x 256 steps: state, counters, streams and checksum on the card
    equal to the CPU's key for key, and its timing's checksum the same."""
    from tpusim_torch import profiling

    net = default_network() if mode == "fast" else reference_selfish_network()
    cfg = SimConfig(network=net, runs=64, batch_size=64, seed=7, chunk_steps=256,
                    state_dtype="int32", count_rebase=False, rng=rng)
    (gs, ga, gf), (ws, wa, wf) = (profiling.chained_chunks(e, e.make_keys(0, 64), 2)
                                  for e in (Engine(cfg, "cuda"), Engine(cfg, "cpu")))
    for g, w in [*zip(gs, ws), *zip((*ga[0], *ga[3:]), (*wa[0], *wa[3:]))]:
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g.cpu(), w)
    assert int(gf) == int(wf) > 0
    eng = Engine(cfg, "cuda")
    timing = profiling.time_chained_chunks(eng, eng.make_keys(0, 64), n_chunks=2, repeats=2)
    assert timing["checksum"] == int(wf) and timing["s_per_chunk"] > 0
    assert 0 < timing["enqueue_s_per_chunk"]


def test_perf_copy_probe_within_the_hbm3_peak(cuda):
    from tpusim_torch import profiling

    gbps = profiling.measure_copy_bandwidth_gbps()
    assert 0.3 * HBM3_BYTES_PER_S / 1e9 < gbps <= 1.05 * HBM3_BYTES_PER_S / 1e9, gbps


@pytest.mark.parametrize("variant", ["fast-ring", "selfish-k4", "raw", "xoro"])
def test_graph_replayed_plain_equals_the_cpu_loop(cuda, variant):
    """The plain version on the card (one step's ops captured in a CUDA
    graph, replayed a row) against the plain loop on the CPU, ragged caps."""
    from tpusim_torch import xoroshiro
    from tpusim_torch.flight import flight_to_kernel

    base = dict(duration_ms=2 * DAY, chunk_steps=192)
    cfg = {"fast-ring": SimConfig(network=default_network(), flight_capacity=64, **base),
           "selfish-k4": SimConfig(network=reference_selfish_network(), group_slots=4, **base),
           "raw": SimConfig(network=reference_selfish_network(), rng_batch=False, **base),
           "xoro": SimConfig(network=default_network(), rng="xoroshiro", **base)}[variant]
    eng, keys, state, aux, cap = _mid_run(cfg, 1000, 1)
    cap = cap.clone()
    cap[:50] = 0
    cap[50:300] = 200_000
    prop, selfish = eng.roster()
    rows = (xoroshiro.xoro_rows(aux[3], aux[4], eng.xoro_sampler(), eng.chunk_steps)[0]
            if eng.xoro else eng._rows(keys, 1))
    kw = dict(eng.loop_options(), **({"consumed_rows": True} if eng.xoro else {}))
    args = (rows, cap, prop, state_to_kernel(state), counters_to_kernel(aux[0]), selfish,
            None if aux[1] is None else flight_to_kernel(aux[1]))

    def on_cpu(x):
        if torch.is_tensor(x):
            return x.cpu()
        if isinstance(x, tuple):
            items = [on_cpu(v) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x

    got = event_loop_chunk_plain(*args, **kw)
    want = event_loop_chunk_plain(*on_cpu(args), **{k: on_cpu(v) for k, v in kw.items()})
    flat = lambda o: (*o[0], *o[1], *(o[2] or ()), *o[3:])
    for g, w in zip(flat(got), flat(want), strict=True):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# Fast mode on a selfish roster: the fast kernel's SELFISH form (K1s, with the
# ring K3fs, packed K4fs, and both) against its plain version, and the card
# against the CPU.

FAST_SELFISH_NETS = {"reference": reference_selfish_network(),
                     "hetero": hetero_selfish_network()}


@pytest.mark.parametrize(
    "net,state_dtype,count_rebase,capacity",
    [("reference", "int16", True, 0), ("hetero", "int32", False, 0),
     ("reference", "int16", True, 64), ("hetero", "auto", True, 2048)],
    ids=["k1s-int16", "k1s-hetero-int32", "k3fs-wraps", "k3fs-hetero"],
)
def test_fast_selfish_kernel_chunk_equals_plain(cuda, net, state_dtype, count_rebase, capacity):
    """K1s and K3fs at 1,000 runs from a mid-run state with ragged chunk
    ends: every state leaf (bhp and npriv included), counter and ring leaf
    equal to the plain version's."""
    cfg = SimConfig(network=FAST_SELFISH_NETS[net], duration_ms=30 * DAY, mode="fast",
                    state_dtype=state_dtype, count_rebase=count_rebase,
                    flight_capacity=capacity)
    eng, keys, state, aux, cap = _mid_run(cfg, 1000, 1)
    assert event_loop.state_form(state) == "fast_selfish"
    kernel = "event_loop_fast_selfish" + ("_flight" if capacity else "")
    got = _compare_chunk(eng, keys, state, aux, _ragged(cap), kernel)
    assert int(got[0][event_loop.FAST_SELFISH_LEAVES.index("npriv")].max()) > 0
    if capacity == 64:
        assert int((got[2][1] - flight_to_kernel(aux[1])[1]).max()) > 64  # the ring wrapped


@pytest.mark.parametrize("capacity", [0, 64], ids=["k4fs", "k4fs-ring"])
def test_fast_selfish_packed_kernel_chunk_equals_plain(cuda, capacity):
    """K4fs (and with the ring): per-run delays from 100 ms to 60 s and
    per-run selfish flags, one lane group wholly honest."""
    runs, counts = 1000, [300, 200, 250, 250]
    cfgs = _lane_configs("selfish", mode="fast", flight_capacity=capacity)
    eng = _packed_engine(cfgs, counts, event_loop=event_loop_chunk_plain)
    keys = eng.make_keys(0, runs)
    state, aux = eng._init(keys)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    prop, selfish = eng.roster()
    assert torch.is_tensor(selfish) and selfish.shape == (9, runs)
    kernel = "event_loop_fast_selfish_packed" + ("_flight" if capacity else "")
    _compare_chunk(eng, keys, state, aux, _ragged(cap), kernel)


@pytest.mark.parametrize("capacity", [0, 512], ids=["plain", "ring"])
def test_fast_selfish_run_batch_card_equals_cpu(cuda, capacity):
    """256 runs x 2 days of the reference's selfish roster in fast mode on
    the card (K1s; K3fs with the ring) against the same batch on the CPU,
    key for key, the rings included."""
    cfg = SimConfig(network=reference_selfish_network(), mode="fast", duration_ms=2 * DAY,
                    runs=256, batch_size=256, seed=3, flight_capacity=capacity)
    kernel = "event_loop_fast_selfish" + ("_flight" if capacity else "")
    before = event_loop.launches[kernel]
    a = Engine(cfg, "cuda").run_batch(Engine(cfg, "cuda").make_keys(0, 256))
    assert event_loop.launches[kernel] > before
    b = Engine(cfg, "cpu").run_batch(Engine(cfg, "cpu").make_keys(0, 256))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fast_selfish_packed_grid_card_equals_cpu(cuda):
    """Three fast selfish points through ``packed.run_grid`` (K4fs) on the
    card and on the CPU: sums and counters per point."""
    cfgs = _lane_configs("selfish", mode="fast", runs=32, batch_size=32, seed=2,
                         duration_ms=2 * DAY)
    pts = [(f"p{i}", c) for i, c in enumerate(cfgs) if c.network.any_selfish]
    before = event_loop.launches["event_loop_fast_selfish_packed"]
    on_card = packed.run_grid(pts, device="cuda")
    assert event_loop.launches["event_loop_fast_selfish_packed"] > before
    for a, b in zip(on_card, packed.run_grid(pts, device="cpu")):
        for k in b["sums"]:
            np.testing.assert_array_equal(a["sums"][k], b["sums"][k], err_msg=k)
        for k in b["tele"]:
            np.testing.assert_array_equal(a["tele"][k], b["tele"][k], err_msg=k)


def _private_pairs(eng, runs: int, steps: int, seed: int, device):
    """The event loop's arguments for a chunk from a seeded fast selfish
    state in which the two runs of each warp (runs 2w and 2w + 1) differ:
    run 2w's selfish miners hold 1-3 private blocks (their whole chains),
    run 2w + 1's none. In every fourth run the count is 1 and bhp level with
    it, and each run's first find is its lowest selfish miner's (miner 1 in
    an honest run): a race on the chunk's first step there, a private append
    in the other even runs. Then numpy-seeded rows, winners by the first
    roster's shares and intervals of 0-5 s."""
    from tpusim_torch.engine import init_counters
    from tpusim_torch.state import init_state

    m = eng.n_miners
    prop, selfish = eng.roster()
    sel = (selfish.bool() if torch.is_tensor(selfish) else torch.tensor(
        selfish, dtype=torch.bool, device=device)[:, None].expand(m, runs)).to(device)
    rng = np.random.default_rng(seed)
    ridx = torch.arange(runs, device=device)
    held = torch.from_numpy(rng.integers(1, 4, runs)).to(device)
    held = torch.where(ridx % 4 == 0, 1, torch.where(ridx % 2 == 1, 0, held))
    chain = (sel * held[None]).to(torch.int16)
    names = event_loop.FAST_SELFISH_LEAVES
    lv = dict(zip(names, state_to_kernel(
        init_state(runs, m, 2, torch.int16, False, device, any_selfish=True))))
    lv["npriv"], lv["height"], lv["ocnt"] = chain, chain.clone(), chain.clone()
    lv["bhp"] = (ridx % 4 == 0).to(torch.int16)[None]
    shares = np.array([mc.hashrate_pct for mc in eng.config.network.miners], float) / 100
    w = rng.choice(m, size=(steps, runs), p=shares / shares.sum()).astype(np.int32)
    first = torch.where(sel.any(0), sel.int().argmax(0), 1)
    w[0] = first.cpu().numpy()
    dt = rng.integers(0, 5000, size=(steps, runs)).astype(np.int32)
    dt[rng.random((steps, runs)) < 0.05] = 0
    rows = torch.from_numpy(np.stack([w, dt], axis=1)).to(device)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device=device)
    return (rows, cap, prop.to(device), tuple(lv[n] for n in names),
            counters_to_kernel(init_counters(runs, m, device)),
            selfish.to(device) if torch.is_tensor(selfish) else selfish)


def _reveals_by_step(args) -> list[torch.Tensor]:
    """The plain version on the CPU one step at a time: for each step, the
    (miner, run) pairs that revealed (a private count below the find's
    append or race without an adoption) and, at step 0, those that raced."""
    on_cpu = lambda x: x.cpu() if torch.is_tensor(x) else x
    rows, cap, prop, leaves, counters, selfish = (
        tuple(map(on_cpu, a)) if isinstance(a, tuple) else on_cpu(a) for a in args)
    names = event_loop.FAST_SELFISH_LEAVES
    h_i, np_i, bhp_i = (names.index(n) for n in ("height", "npriv", "bhp"))
    m = leaves[h_i].shape[0]
    sel = selfish.bool() if torch.is_tensor(selfish) else torch.tensor(
        selfish, dtype=torch.bool)[:, None]
    out, steps = (leaves, counters), []
    for s in range(rows.shape[0]):
        lv = out[0]
        ow = (torch.arange(m)[:, None] == rows[s, 0][None]) & (lv[0][0] == lv[1][0])
        out = event_loop_chunk_plain(rows[s:s + 1], cap, prop, *out, selfish)[:2]
        sw = ow & sel
        race = sw & (lv[np_i] == 1) & (lv[bhp_i] == lv[h_i])
        adopted = (out[0][h_i].long() - lv[h_i].long() - ow.long()) > 0
        steps.append(((out[0][np_i].long() < lv[np_i].long() + sw.long() - 2 * race.long())
                      & ~adopted, race))
    return steps


@pytest.mark.parametrize("packed_form", [False, True], ids=["k1s", "k4fs"])
def test_fast_selfish_reveal_diverging_in_a_warp_equals_plain(cuda, packed_form):
    """K1s and K4fs on chunks in which the two runs of a warp take the
    reveal branch apart: private blocks seeded in one run of each pair
    (:func:`_private_pairs`), a race on the chunk's first step, a reveal on
    its last; 250 runs (a partial block), every leaf and counter equal to
    the plain version's."""
    runs, steps = 250, 96
    if packed_form:
        eng = _packed_engine(_lane_configs("selfish", mode="fast"), [64, 62, 62, 62])
    else:
        eng = Engine(SimConfig(network=reference_selfish_network(), mode="fast",
                               state_dtype="int16"), "cuda")
    args = _private_pairs(eng, runs, steps, 17, cuda)
    kernel = "event_loop_fast_selfish" + ("_packed" if packed_form else "")
    before = dict(event_loop.launches)
    got = event_loop.event_loop_chunk(*args)
    torch.cuda.synchronize()
    assert event_loop.launches == {**before, kernel: before[kernel] + 1}
    want = event_loop_chunk_plain(*args)
    names = event_loop.FAST_SELFISH_LEAVES + event_loop.TELE_LEAVES
    for name, g, w in zip(names, got[0] + got[1], want[0] + want[1], strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    by_step = _reveals_by_step(args)
    assert by_step[0][1].any(), "no race on the chunk's first step"
    assert by_step[-1][0].any(), "no reveal on the chunk's last step"
    pairs = [rev.any(0).view(-1, 2) for rev, _ in by_step]
    assert any((p[:, 0] != p[:, 1]).any() for p in pairs), "no warp's runs diverge"


def test_fast_selfish_libraries_keep_their_sass(cuda):
    """The fast selfish libraries compile to their pinned instructions (the
    ``fast_selfish`` set of torch_sass_digests.json), for the nvcc release
    they were pinned with; the other sets are pinned by the tests above."""
    import subprocess

    from tpusim_torch.csrc import build

    pin = json.loads(SASS_PIN.read_text())
    release = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    if release != pin["nvcc"]:
        pytest.skip(f"SASS pinned for {pin['nvcc']}, this is {release}")
    libs = {}
    for key in pin["fast_selfish"]:
        name, m, k = key.rsplit("-", 2)
        libs[name, int(m[1:]), int(k[1:])] = key
    built = build.build(libs)
    changed = [key for lib, key in libs.items()
               if _sass_digest(built[lib][0]) != pin["fast_selfish"][key]]
    assert not changed, f"SASS changed: {changed}"


# ---------------------------------------------------------------------------
# The per-event xoroshiro draw (X2r, rng_batch=False on the xoroshiro path):
# every form X2 has, against its plain version, from X2's cases.


def _xoro_words_kernel(case: str) -> str:
    network, mode, k, capacity, options, m = _consumed_case(case)
    return _consumed_kernel(m, mode, capacity, options, network == "packed").replace(
        "_consumed", "_xoro")


@pytest.fixture(scope="module")
def xoro_words_libraries():
    """The X2r libraries of CONSUMED_CASES, built at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from tpusim_torch.csrc import build

    build.build(sorted({(_xoro_words_kernel(c), _consumed_case(c)[5], _consumed_case(c)[2])
                        for c in CONSUMED_CASES}))


def _xoro_words_chunk(case: str, runs: int):
    """A CONSUMED_CASES engine with ``rng_batch=False`` after one plain
    chunk: the engine, its state and its aux (the streams last)."""
    network, mode, k, capacity, options, m = _consumed_case(case)
    plain = dict(event_loop=event_loop_chunk_plain)
    kw = dict(duration_ms=2 * DAY, group_slots=k, flight_capacity=capacity, chunk_steps=320,
              rng="xoroshiro", rng_batch=False, **options)
    if network == "packed":
        cfgs = _lane_configs(mode, **kw)
        cfgs = cfgs[:min(runs, len(cfgs))]
        counts = [runs // len(cfgs) + (i < runs % len(cfgs)) for i in range(len(cfgs))]
        eng = _packed_engine(cfgs, counts, **plain)
    else:
        net = _hetero32() if network == "hetero32" else network
        eng = Engine(SimConfig(network=net, mode=mode, **kw), "cuda", **plain)
    keys = eng.make_keys(0, runs)
    state, aux = eng._init(keys)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    return eng, state, aux


def _xoro_words_kernel_equals_plain(case: str, eng, cap, leaves, aux):
    """X2r on the card against its plain version on one chunk: every leaf
    and the advanced streams; returns the streams."""
    ctr, fr = aux[:2]
    prop, selfish = eng.roster()
    args = (None, cap, prop, leaves, counters_to_kernel(ctr), selfish,
            None if fr is None else flight_to_kernel(fr))
    opts = dict(onehot=not eng.config.consensus_gather,
                xoro=event_loop.XoroDraw(aux[3], eng.xoro_sampler(), eng.chunk_steps))
    kernel = _xoro_words_kernel(case)
    before = dict(event_loop.launches)
    got = event_loop.event_loop_chunk(*args, **opts)
    torch.cuda.synchronize()
    assert event_loop.launches == {**before, kernel: before[kernel] + 1}
    want = event_loop_chunk_plain(*args, **opts)
    names = event_loop.EXACT_LEAVES if eng.exact else event_loop.FAST_LEAVES
    names += event_loop.TELE_LEAVES + (FLIGHT_LEAVES if fr is not None else ()) + ("streams",)
    for name, g, w in zip(names, got[0] + got[1] + (got[2] or ()) + got[3:],
                          want[0] + want[1] + (want[2] or ()) + want[3:]):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    return got[3]


@pytest.mark.parametrize("runs", [1, 3, 17, 1000])
@pytest.mark.parametrize("case", list(CONSUMED_CASES))
def test_xoro_word_kernel_at_any_run_count(cuda, xoro_words_libraries, case, runs):
    """X2r in each form the xoroshiro paths run at ``rng_batch=False``, from a
    mid-run state (one plain chunk) with ragged chunk ends: every leaf and
    the advanced streams equal to the plain version's."""
    eng, state, aux = _xoro_words_chunk(case, runs)
    i = torch.arange(runs, device="cuda", dtype=torch.int32)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    cap = torch.where(i % 3 == 1, (i + 1) * 1600, cap)  # early in the chunk
    cap = torch.where(i % 7 == 2, (i + 1) * (2**28 // runs), cap)  # anywhere in it
    cap = torch.where(i % 5 == 4, 0, cap).to(torch.int32)  # at once
    streams = _xoro_words_kernel_equals_plain(case, eng, cap, state_to_kernel(state), aux)
    assert bool((streams != aux[3]).any()) or runs < 17


@pytest.mark.parametrize("roster", ["default", "selfish"])
def test_xoro_words_run_batch_card_equals_x1_x2(cuda, roster):
    """A 64-run x 2-day xoroshiro batch at ``rng_batch=False`` on the card:
    X2r alone, once a chunk, and no X1 launch; key for key the ``rng_batch=True``
    batch's (X1 and X2) on the card and the plain versions' on the CPU."""
    from tpusim_torch import xoroshiro

    net = default_network() if roster == "default" else reference_selfish_network()
    cfg = SimConfig(network=net, duration_ms=2 * DAY, runs=64, batch_size=64, seed=5,
                    rng="xoroshiro", rng_batch=False)
    gpu = Engine(cfg, "cuda")
    for k in event_loop.launches:
        event_loop.launches[k] = 0
    before = xoroshiro.launches["xoroshiro_rows"]
    a = gpu.run_batch(gpu.make_keys(0, 64))
    kernel = f"event_loop_{'exact' if roster == 'selfish' else 'fast'}_xoro"
    assert {k: v for k, v in event_loop.launches.items() if v} == {kernel: a["tele_chunks_max"]}
    assert xoroshiro.launches["xoroshiro_rows"] == before
    batched = Engine(dataclasses.replace(cfg, rng_batch=True), "cuda")
    cpu = Engine(cfg, "cpu")
    for b in (batched.run_batch(batched.make_keys(0, 64)), cpu.run_batch(cpu.make_keys(0, 64))):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_xoro_words_dispatch_paths_agree_on_the_card(cuda):
    """X2r on each dispatch path (1,000 runs x 2 days), key for key the
    device loop's, and a 4-shard batch on one card the unsharded one's."""
    cfg = SimConfig(network=default_network(), duration_ms=2 * DAY, runs=1000,
                    batch_size=1000, seed=11, rng="xoroshiro", rng_batch=False)
    eng = Engine(cfg, "cuda")
    keys = eng.make_keys(0, 1000)
    want = eng.run_batch(keys)
    sharded = Engine(cfg, devices=["cuda:0"] * 4)
    for path, got in (("pipelined", eng.run_batch(keys, pipelined=True)),
                      ("host_loop", eng.run_batch(keys, host_loop=True)),
                      ("async", eng.run_batch_async(keys)()),
                      ("sharded", sharded.run_batch(keys))):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}: {k}")


def test_xoro_words_libraries_keep_their_sass(cuda):
    """The X2r libraries compile to their pinned instructions (the
    ``xoro_words`` set of torch_sass_digests.json), for the nvcc release
    they were pinned with."""
    import subprocess

    from tpusim_torch.csrc import build

    pin = json.loads(SASS_PIN.read_text())
    release = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    if release != pin["nvcc"]:
        pytest.skip(f"SASS pinned for {pin['nvcc']}, this is {release}")
    libs = {}
    for key in pin["xoro_words"]:
        name, m, k = key.rsplit("-", 2)
        libs[name, int(m[1:]), int(k[1:])] = key
    built = build.build(libs)
    changed = [key for lib, key in libs.items()
               if _sass_digest(built[lib][0]) != pin["xoro_words"][key]]
    assert not changed, f"SASS changed: {changed}"
