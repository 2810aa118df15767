"""The port's raw-word variants (``rng_batch=False``, K5a: the kernel maps
the raw threefry words per event) against the reference on the CPU, in one
process: one chunk of the event loop's plain version against the Pallas
kernel with ``rng_batch=False`` in interpret mode (fast, exact honest and
selfish, K = 2 and 4, int16 and int32, with the flight ring); whole
batches against ``tpusim.engine.Engine`` with the knob off, key for key, a
wide roster included; a packed grid against ``tpusim.packed.run_grid``
(whose Pallas engine refuses a packed raw-word kernel, so the reference
runs the grid on its scan engine); the raw-word mapping alone against
``sampling``'s, and the reference kernel's own in-kernel interval mapping
over all 2^24 uniforms against ``sampling``'s. Every comparison is
bit-equal (tolerance 0)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpusim import packed as ref_packed
from tpusim.config import SimConfig as RefConfig
from tpusim.engine import Engine as RefEngine
from tpusim.pallas_engine import PallasEngine
from tpusim.runner import make_run_keys as ref_run_keys
from tpusim_torch import convert, event_loop, packed, threefry
from tpusim_torch.config import (
    MinerConfig, NetworkConfig, SimConfig, default_network, reference_selfish_network,
)
from tpusim_torch.engine import Engine
from tpusim_torch.sampling import interval_from_bits, winners_from_bits

DAY = 86_400_000
RUNS = 128
KNOB = dict(rng_batch=False)


def _np(tree) -> dict:
    return {k: (None if v is None else np.asarray(v)) for k, v in tree._asdict().items()}


def _chunk_case(cfg: SimConfig, start_chunk: int = 1):
    """One chunk of the port's engine against the Pallas kernel in
    interpret mode (tile 128, step block 32), from the reference's state
    after ``start_chunk`` full chunks, with ragged chunk ends. Asserts every
    state leaf, counter, ring leaf, count base and elapsed time equal;
    returns the port's state and counters as numpy."""
    ref_cfg = RefConfig.from_json(cfg.to_json())
    pe = PallasEngine(ref_cfg, tile_runs=128, step_block=32, interpret=True)
    port = Engine(cfg, device="cpu")
    assert port.chunk_steps == pe.chunk_steps
    keys = ref_run_keys(cfg.seed, 0, RUNS)
    state, aux = pe._init(keys, pe.params)
    for c in range(start_chunk):
        state, aux, _ = pe._chunk(state, aux, jnp.full((RUNS,), 2**29, jnp.int32), keys,
                                  jnp.uint32(c), pe.params)
    cap = np.random.default_rng(start_chunk).integers(0, 2**29, RUNS).astype(np.int32)
    cap[:8] = 0
    cap[8:40] = np.random.default_rng(1).integers(1, 200_000, 32)
    ctr, fr, cb = aux
    p_aux = (convert.counters_from_numpy(_np(ctr)),
             None if fr is None else convert.recorder_from_numpy(_np(fr)),
             None if cb is None else torch.from_numpy(np.array(cb)))
    want_state, (want_ctr, want_fr, want_cb), want_el = pe._chunk(
        state, aux, jnp.asarray(cap), keys, jnp.uint32(start_chunk), pe.params)
    got_state, (got_ctr, got_fr, got_cb), got_el = port._chunk(
        convert.state_from_numpy(_np(state)), p_aux, torch.from_numpy(cap),
        convert.keys_from_numpy(jax.random.key_data(keys)), start_chunk)
    got = convert.state_to_numpy(got_state)
    for name, want in _np(want_state).items():
        if want is None:
            assert got[name] is None, name
            continue
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    got_ctr = convert.counters_to_numpy(got_ctr)
    for name, want in _np(want_ctr).items():
        np.testing.assert_array_equal(got_ctr[name], want, err_msg=name)
    if fr is not None:
        got_rec = convert.recorder_to_numpy(got_fr)
        for name, want in _np(want_fr).items():
            np.testing.assert_array_equal(got_rec[name], want, err_msg=name)
    if cb is not None:
        np.testing.assert_array_equal(got_cb.numpy(), np.asarray(want_cb))
    np.testing.assert_array_equal(got_el.numpy(), np.asarray(want_el))
    assert got_ctr["active_steps"].sum() > RUNS  # the chunk did real work
    return got, got_ctr


#: Chunk cases: (network, mode, group slots, state dtype, count re-base,
#: flight capacity).
CHUNK_CASES = {
    "fast-int16": (default_network(propagation_ms=10_000), "fast", 2, "int16", True, 0),
    "fast-k4-int32": (default_network(propagation_ms=10_000), "fast", 4, "int32", False, 0),
    "honest": (default_network(propagation_ms=10_000), "exact", 2, "auto", True, 0),
    "selfish-int16": (reference_selfish_network(), "auto", 2, "int16", True, 0),
    "selfish-k4-int32": (reference_selfish_network(), "auto", 4, "int32", False, 0),
    "selfish-ring": (reference_selfish_network(), "auto", 2, "auto", True, 16),
}


def chunk_case_config(case: str, **knobs) -> SimConfig:
    net, mode, k, dtype, rebase, capacity = CHUNK_CASES[case]
    return SimConfig(network=net, duration_ms=2 * DAY, runs=RUNS, batch_size=RUNS, mode=mode,
                     group_slots=k, state_dtype=dtype, count_rebase=rebase,
                     flight_capacity=capacity, chunk_steps=64, seed=43, **knobs)


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_bit_equal_to_pallas_interpret(case):
    got, ctr = _chunk_case(chunk_case_config(case, **KNOB))
    if "selfish" in case:
        assert got["n_private"].sum() > 0
    if case != "fast-int16":
        assert ctr["stale_events"].sum() > 0


def run_both(cfg: RefConfig) -> dict:
    """``run_batch`` of the reference's scan engine and of the port on the
    CPU, asserted key for key equal; returns the port's."""
    want = RefEngine(cfg).run_batch(ref_run_keys(cfg.seed, 0, cfg.runs))
    eng = Engine(SimConfig.from_json(cfg.to_json()), device="cpu")
    got = eng.run_batch(eng.make_keys(0, cfg.runs))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    return got


#: A 20-miner roster with a 40 % selfish miner: the wide exact kernel (K2w).
WIDE_SELFISH = NetworkConfig(miners=tuple(
    MinerConfig(hashrate_pct=h, propagation_ms=1000, selfish=i == 0)
    for i, h in enumerate((40,) + (4,) * 3 + (3,) * 16)))

BATCH_CASES = {
    "default": (default_network(), "auto", 3),
    "racy-exact": (default_network(propagation_ms=10_000), "exact", 2),
    "selfish": (reference_selfish_network(), "auto", 3),
    "wide-selfish-20": (WIDE_SELFISH, "auto", 2),
}


def batch_case_config(case: str, **knobs) -> RefConfig:
    net, mode, days = BATCH_CASES[case]
    return RefConfig(network=net, duration_ms=days * DAY, runs=32, batch_size=32, mode=mode,
                     chunk_steps=128, seed=29, **knobs)


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_run_batch_bit_equal(case):
    got = run_both(batch_case_config(case, **KNOB))
    assert got["blocks_found_sum"].sum() > 0


def grid_points(**knobs) -> list[tuple[str, RefConfig]]:
    """Three points of two shapes (a fast pack of two, an exact one), per-run
    propagation and intervals, small enough for the CPU."""
    return [
        ("p-100ms", RefConfig(network=default_network(propagation_ms=100), duration_ms=2 * DAY,
                              runs=24, batch_size=16, mode="fast", seed=5, **knobs)),
        ("p-1s-300s", RefConfig(network=dataclasses.replace(default_network(),
                                                            block_interval_s=300.0),
                                duration_ms=DAY, runs=20, batch_size=16, mode="fast", seed=6,
                                **knobs)),
        ("p-10s", RefConfig(network=default_network(propagation_ms=10_000), duration_ms=2 * DAY,
                            runs=24, batch_size=24, mode="exact", seed=7, **knobs)),
    ]


def check_grid(points) -> list[dict]:
    """``packed.run_grid`` of the port against the reference's, pack by pack
    (``plan_packs``), each point's sums, moments and counters equal."""
    packs, sequential = ref_packed.plan_packs(points)
    assert not sequential
    want, got = [], []
    for pack in packs:
        pts = [points[i] for i in pack.indices]
        want += ref_packed.run_grid(pts)
        got += packed.run_grid([(n, SimConfig.from_json(c.to_json())) for n, c in pts],
                               device="cpu")
    for a, b in zip(got, want):
        assert a["name"] == b["name"]
        assert a["sums"].keys() == b["sums"].keys()
        for k in b["sums"]:
            np.testing.assert_array_equal(a["sums"][k], np.asarray(b["sums"][k]), err_msg=k)
        for k in b["tele"]:
            np.testing.assert_array_equal(np.asarray(a["tele"][k]), np.asarray(b["tele"][k]),
                                          err_msg=k)
        assert a["moments"].n == b["moments"].n
        for st in b["moments"].m2:
            np.testing.assert_array_equal(a["moments"].m2[st], b["moments"].m2[st])
    return got


def test_packed_grid_bit_equal():
    check_grid(grid_points(**KNOB))


def test_packed_engine_runs_the_raw_word_variant():
    """A packed engine with the knob off hands the kernel per-run
    thresholds (M, R) and means (R,)."""
    cfgs = [SimConfig.from_json(c.to_json()) for _, c in grid_points(**KNOB)[:2]]
    eng = Engine(cfgs[0], device="cpu", packed=True)
    eng.params = packed.stack_params(cfgs, [3, 5])
    smp = eng.loop_options()["sampler"]
    assert smp.lo.shape == smp.hi.shape == (9, 8) and smp.mean.shape == (8,)
    np.testing.assert_array_equal(smp.mean.numpy(), [600_000.0] * 3 + [300_000.0] * 5)
    assert (smp.lo[1:] == smp.hi[:-1]).all() and (smp.lo[0] == 0).all()


def test_mapping_equals_the_sampler():
    """The raw-word mapping alone (the plain version of the kernel's device
    functions): every threshold +-1, 0 and 2^32 - 1, and random words, give
    ``winners_from_bits`` and ``interval_from_bits``."""
    eng = Engine(SimConfig(network=default_network()), device="cpu")
    thr = eng.params.thresholds
    edge = torch.cat([thr - 1, thr, thr + 1, torch.tensor([0, 2**32 - 1])])
    words = torch.cat([edge, torch.from_numpy(
        np.random.default_rng(3).integers(0, 2**32, 4096, dtype=np.int64))])
    smp = event_loop.make_sampler(thr, 600_000.0)
    got = event_loop.map_raw_words(threefry.to_int32(torch.stack([words, words])), smp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), winners_from_bits(words, thr).numpy())
    np.testing.assert_array_equal(got[1].numpy(), interval_from_bits(words, 600_000.0).numpy())


@pytest.mark.parametrize("mean_ms", [600_000.0, 1_000.0])
def test_in_kernel_interval_mapping_equals_the_sampler(mean_ms):
    """The reference's raw-word kernel maps intervals with its own in-kernel
    log1p (XLA:CPU inside a Pallas body in interpret mode,
    pallas_engine.py:305-309); over all 2^24 uniforms it gives what
    ``sampling.interval_from_bits`` gives, so the raw-word variants, which
    transcribe the latter, follow the reference kernel."""
    words = np.arange(2**24, dtype=np.uint32) << 8

    def body(w_ref, o_ref):
        u = (w_ref[...] >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) * jnp.float32(
            2.0**-24)
        o_ref[...] = jnp.minimum(-jnp.log1p(-u) * jnp.float32(mean_ms),
                                 jnp.float32(2**27)).astype(jnp.int32)

    grid = jnp.asarray(words.reshape(2**12, 2**12))
    want = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(grid.shape, jnp.int32),
                          interpret=True)(grid)
    got = interval_from_bits(torch.from_numpy(words.astype(np.int64)), mean_ms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1))


def test_words_narrow_to_their_bit_patterns():
    words = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    got = threefry.to_int32(words)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), words.numpy().astype(np.uint32))
