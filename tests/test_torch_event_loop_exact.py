"""One exact-mode chunk of the port's event loop (the kernel's plain PyTorch
version, as the CPU runs it) against the reference Pallas kernel in interpret
mode, fed the same state and keys: every state leaf, counter, ring leaf,
count base and elapsed time bit-equal, on selfish and honest exact rosters,
and on a roster built for ties (equal hashrates, 1 ms delays: equal best
published heights, equal first-seen tips, several adopters popping equally
deep) with runs that stop at different steps of the chunk."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusim.config import SimConfig as RefConfig
from tpusim.pallas_engine import PallasEngine
from tpusim.runner import make_run_keys as ref_run_keys
from tpusim_torch import convert, event_loop
from tpusim_torch.config import (
    MinerConfig, NetworkConfig, SimConfig, default_network, hetero_selfish_network,
    reference_selfish_network,
)
from tpusim_torch.engine import Engine, counters_to_kernel

RUNS = 128

NETWORKS = {
    "selfish": reference_selfish_network(),
    "racy": default_network(propagation_ms=10_000),  # auto -> exact, honest
    "hetero": hetero_selfish_network(),
}


def _np(tree) -> dict:
    return {k: (None if v is None else np.asarray(v)) for k, v in tree._asdict().items()}


def _chunk_against_pallas(port_cfg: SimConfig, start_chunk: int, cap: np.ndarray):
    """Chunk ``start_chunk`` of the port's engine (the plain version) and of
    the Pallas kernel in interpret mode, from the reference's state after the
    chunks before it; asserts every state leaf, counter, ring leaf, count
    base and elapsed time equal. Returns the port's state, counters and
    ring (None without one) and its entry counters, as numpy."""
    cfg = RefConfig.from_json(port_cfg.to_json())
    assert cfg.resolved_mode == "exact"
    pe = PallasEngine(cfg, tile_runs=128, step_block=32, interpret=True)
    keys = ref_run_keys(cfg.seed, 0, RUNS)
    state, aux = pe._init(keys, pe.params)
    for c in range(start_chunk):
        state, aux, _ = pe._chunk(state, aux, jnp.full((RUNS,), 2**29, jnp.int32), keys,
                                  jnp.uint32(c), pe.params)

    # Carry the reference's state across to the port.
    port = Engine(port_cfg, device="cpu")
    assert port.exact and port.chunk_steps == pe.chunk_steps
    ctr, fr, cb = aux
    p_state = convert.state_from_numpy(_np(state))
    p_aux = (convert.counters_from_numpy(_np(ctr)),
             None if fr is None else convert.recorder_from_numpy(_np(fr)),
             None if cb is None else torch.from_numpy(np.array(cb)))
    p_keys = convert.keys_from_numpy(jax.random.key_data(keys))

    want_state, (want_ctr, want_fr, want_cb), want_elapsed = pe._chunk(
        state, aux, jnp.asarray(cap), keys, jnp.uint32(start_chunk), pe.params
    )
    got_state, (got_ctr, got_fr, got_cb), got_elapsed = port._chunk(
        p_state, p_aux, torch.from_numpy(cap), p_keys, start_chunk
    )

    got = convert.state_to_numpy(got_state)
    for name, want in _np(want_state).items():
        assert want is not None, name  # exact mode has every leaf
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    for name, want in _np(want_ctr).items():
        np.testing.assert_array_equal(convert.counters_to_numpy(got_ctr)[name], want,
                                      err_msg=name)
    got_rec = None
    if fr is not None:
        got_rec = convert.recorder_to_numpy(got_fr)
        for name, want in _np(want_fr).items():
            assert got_rec[name].dtype == want.dtype, name
            np.testing.assert_array_equal(got_rec[name], want, err_msg=name)
    if cb is not None:
        np.testing.assert_array_equal(got_cb.numpy(), np.asarray(want_cb))
    np.testing.assert_array_equal(got_elapsed.numpy(), np.asarray(want_elapsed))
    # And back: the port's state is a valid reference state.
    back = type(want_state)(**{k: jnp.asarray(v) for k, v in got.items()})
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want_state)
    return got, convert.counters_to_numpy(got_ctr), got_rec, _np(ctr)


@pytest.mark.parametrize(
    "net,state_dtype,count_rebase,start_chunk",
    [
        ("selfish", "auto", True, 0),  # int16 counts, stale int32
        ("selfish", "int32", False, 2),  # from a mid-run state carried across
        ("selfish", "int16", False, 1),  # stale int16 too
        ("racy", "auto", True, 0),
        ("racy", "int32", True, 2),
        ("hetero", "auto", True, 0),
        ("hetero", "int32", False, 2),
        ("hetero", "int16", True, 3),
    ],
)
def test_exact_chunk_bit_equal_to_pallas_interpret(net, state_dtype, count_rebase, start_chunk):
    port_cfg = SimConfig(
        network=NETWORKS[net], duration_ms=3 * 86_400_000, runs=RUNS, batch_size=RUNS,
        state_dtype=state_dtype, count_rebase=count_rebase, chunk_steps=320, seed=31,
    )
    # Ragged chunk ends: some runs freeze early in the chunk, some at once.
    cap = np.random.default_rng(start_chunk + len(net)).integers(0, 2**29, RUNS).astype(np.int32)
    cap[:8] = 0
    cap[8:40] = np.random.default_rng(1).integers(1, 200_000, 32)
    got, ctr, _, _ = _chunk_against_pallas(port_cfg, start_chunk, cap)
    # The chunk did real work: events ran, blocks went stale, and on a
    # selfish roster private blocks were held.
    assert int(ctr["active_steps"].sum()) > RUNS
    assert int(ctr["stale_events"].sum()) > 0
    if port_cfg.network.any_selfish:
        assert int(got["n_private"].sum()) > 0


def _ties(selfish: bool) -> NetworkConfig:
    """Four miners of equal hashrate, 1 ms delays and a 200 ms interval: in
    every run several miners share the best published height and the
    first-seen tip, finds collide, and an arrival makes several miners adopt
    with pops of equal depth; miner 0 selfish or not."""
    return NetworkConfig(
        miners=tuple(MinerConfig(hashrate_pct=25, propagation_ms=1, selfish=selfish and i == 0)
                     for i in range(4)),
        block_interval_s=0.2,
    )


@pytest.mark.parametrize(
    "selfish,k,capacity",
    [(False, 2, 0), (True, 2, 0), (True, 2, 64), (False, 4, 64), (True, 4, 64)],
    ids=["honest", "selfish", "selfish-ring", "honest-k4-ring", "selfish-k4-ring"],
)
def test_tie_chunk_bit_equal_to_pallas_interpret(selfish, k, capacity):
    """The ties that a group reduction over miners resolves (the lowest
    miner among equal best heights and tips, the lowest adopter among equal
    deepest pops), with runs that stop at every point of the chunk: the
    plain version equals the reference, which holds the kernel to it."""
    port_cfg = SimConfig(
        network=_ties(selfish), duration_ms=86_400_000, runs=RUNS, batch_size=RUNS,
        mode="exact", group_slots=k, flight_capacity=capacity, chunk_steps=320, seed=61,
    )
    # Per-run chunk ends spread over the chunk's whole span of time: runs
    # stop after 0, a few, half and nearly all of their events.
    cap = np.random.default_rng(7).integers(0, 2**29, RUNS).astype(np.int32)
    cap[:RUNS // 2] = np.linspace(0, 60_000, RUNS // 2).astype(np.int32)
    got, ctr, rec, entry = _chunk_against_pallas(port_cfg, 1, cap)
    steps_run = ctr["active_steps"] - entry["active_steps"]
    assert steps_run.min() == 0 and steps_run.max() == 320
    assert len(set(steps_run.tolist())) > RUNS // 4  # runs stopped at many different steps
    assert int(ctr["stale_events"].sum()) > 0
    # Ties: in most runs some miners share a height and a first-seen tip.
    h, base = got["height"], got["base_tip_arrival"]
    same = (h[:, :, None] == h[:, None, :]) & (base[:, :, None] == base[:, None, :])
    assert (same.sum((1, 2)) > 4).mean() > 0.5
    if capacity:
        assert int(rec["count"].sum()) > 0


def test_exact_wrapper_takes_the_plain_version_only_on_the_cpu():
    port = Engine(SimConfig(network=reference_selfish_network(), duration_ms=86_400_000,
                            runs=8, batch_size=8), device="cpu")
    keys = port.make_keys(0, 8)
    state, (ctr, _, _) = port._init(keys)
    leaves = event_loop.state_to_kernel(state)
    assert len(leaves) == len(event_loop.EXACT_LEAVES)
    args = (port._rows(keys, 0), torch.full((8,), 2**29, dtype=torch.int32),
            port.params.prop_ms, leaves, counters_to_kernel(ctr))
    before = dict(event_loop.launches)
    got = event_loop.event_loop_chunk(*args, port.selfish)
    want = event_loop.event_loop_chunk_plain(*args, port.selfish)
    assert event_loop.launches == before  # the plain version is no launch
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="9 selfish flags"):
        event_loop.event_loop_chunk(*args, (True,))
