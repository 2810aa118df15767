"""Wide rosters (more than 16 miners: the kernels' wide variants K1w and K2w
on the card, their plain PyTorch version here) against the reference on the
CPU, in one process: one 24-miner fast chunk of the event loop's plain
version against the Pallas kernel in interpret mode (K1 wide: int16 and
int32 counts, with the flight ring, packed); whole batches key for key
against ``tpusim.engine.Engine`` (the scan engine that runs wide exact
rosters on the TPU) at 17, 20, 24, 32 and 40 miners, the ``hetero32`` grid's
roster included; a packed grid of two 32-miner points; the ``hetero32``
sweep; the trace command on a 32-miner roster; and ``convert`` at 32
miners. Every comparison is bit-equal (tolerance 0), minus the wall-clock
fields."""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusim import flight_export as ref_export
from tpusim import packed as ref_packed
from tpusim import sweep as ref_sweep
from tpusim.config import SimConfig as RefConfig
from tpusim.pallas_engine import PallasEngine
from tpusim.runner import make_engine as ref_make_engine, make_run_keys as ref_run_keys
from tpusim.state import init_state as ref_init_state, make_params as ref_make_params
from tpusim_torch import convert, flight_export, packed, sweep
from tpusim_torch.config import MinerConfig, NetworkConfig, SimConfig, default_network
from tpusim_torch.engine import Engine
from tpusim_torch.state import COUNT_DTYPES, init_state, make_params

DAY = 86_400_000
RUNS = 128
_WALL = ("elapsed_s", "compile_s", "backend")

#: The reference's compiled engines, shared by this file's reference calls
#: (the hetero32 batch and the hetero32 sweep share one program).
REF_CACHE: dict = {}

#: hetero32's hashrates (BASELINE.json configs[3]).
H32 = (14, 11, 9, 8, 6, 5, 4, 3) + (2,) * 16 + (1,) * 8


def _log_delays(n: int) -> list[int]:
    """n delays log-spaced from 100 ms to 60 s, as hetero32's."""
    return [int(100 * 600 ** (i / (n - 1))) for i in range(n)]


def _roster(hashrates, delays, selfish=()) -> NetworkConfig:
    return NetworkConfig(miners=tuple(
        MinerConfig(hashrate_pct=h, propagation_ms=d, selfish=i in selfish)
        for i, (h, d) in enumerate(zip(hashrates, delays))))


#: Path W1's roster: hetero32's hashrates at the default 1 s (fast mode).
W1 = default_network(hashrates=H32)
R17 = _roster((7,) * 9 + (5,) * 5 + (4,) * 3, [1000] * 17)
HS24 = (6,) * 4 + (5,) * 4 + (4,) * 8 + (3,) * 8
R24 = _roster(HS24, [1000] * 24)
SELFISH20 = _roster((40,) + (4,) * 3 + (3,) * 16, [1000] * 20, selfish=(0,))
HONEST40 = _roster((3,) * 20 + (2,) * 20, _log_delays(40))
#: 33 miners: in the wide exact kernel's warp lane 0 owns miners 0 and 32,
#: the selfish one.
SELFISH33 = _roster((3,) * 2 + (2,) * 30 + (34,), _log_delays(33), selfish=(32,))
#: 33 honest miners, delays from 100 ms to 60 s: in the wide fast kernel
#: lane 0 owns miners 0 and 32.
R33 = _roster((4,) + (3,) * 32, _log_delays(33))


def _hetero32() -> NetworkConfig:
    return sweep.baseline_sweeps()["hetero32"]()[0][1].network


def _np(tree) -> dict:
    return {k: (None if v is None else np.asarray(v)) for k, v in tree._asdict().items()}


def _ref(cfg: SimConfig) -> RefConfig:
    return RefConfig.from_json(cfg.to_json())


# ---------------------------------------------------------------------------
# One chunk against the Pallas kernel in interpret mode (K1 wide).


def _chunk_case(cfgs: list[SimConfig], counts=None):
    """One chunk of the port's engine against the Pallas kernel in
    interpret mode, from the reference's state after one full chunk, with
    ragged chunk ends; ``counts`` packs ``cfgs``. Every state leaf, counter,
    ring leaf, count base and elapsed time must be equal."""
    rep, is_packed = cfgs[0], counts is not None
    ref_cfgs = [_ref(c) for c in cfgs]
    pe = PallasEngine(ref_cfgs[0], tile_runs=128, step_block=32, interpret=True,
                      packed=is_packed)
    port = Engine(rep, device="cpu", packed=is_packed)
    params = pe.params
    if is_packed:
        params = ref_packed.stack_params(ref_cfgs, list(counts))
        port.params = packed.stack_params(cfgs, list(counts))
    keys = ref_run_keys(rep.seed, 0, RUNS)
    state, aux = pe._init(keys, params)
    state, aux, _ = pe._chunk(state, aux, jnp.full((RUNS,), 2**29, jnp.int32), keys,
                              jnp.uint32(0), params)
    cap = np.random.default_rng(3).integers(0, 2**29, RUNS).astype(np.int32)
    cap[:8] = 0
    cap[8:40] = np.random.default_rng(1).integers(1, 200_000, 32)
    ctr, fr, cb = aux
    p_aux = (convert.counters_from_numpy(_np(ctr)),
             None if fr is None else convert.recorder_from_numpy(_np(fr)),
             None if cb is None else torch.from_numpy(np.array(cb)))
    want_state, (want_ctr, want_fr, want_cb), want_el = pe._chunk(
        state, aux, jnp.asarray(cap), keys, jnp.uint32(1), params)
    got_state, (got_ctr, got_fr, got_cb), got_el = port._chunk(
        convert.state_from_numpy(_np(state)), p_aux, torch.from_numpy(cap),
        convert.keys_from_numpy(jax.random.key_data(keys)), 1)

    got = convert.state_to_numpy(got_state)
    assert got["own_cp"].shape == (RUNS, rep.network.n_miners, rep.network.n_miners)
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
        assert (got_rec["count"] > 64).any()  # the ring wrapped
    if cb is not None:
        np.testing.assert_array_equal(got_cb.numpy(), np.asarray(want_cb))
    np.testing.assert_array_equal(got_el.numpy(), np.asarray(want_el))
    assert got_ctr["stale_events"].sum() > 0  # adoptions with stale blocks ran


def _r24(**kwargs) -> SimConfig:
    return SimConfig(network=R24, duration_ms=3 * DAY, runs=RUNS, batch_size=RUNS,
                     mode="fast", chunk_steps=320, seed=71, **kwargs)


@pytest.mark.parametrize(
    "kwargs", [dict(state_dtype="auto"),
               dict(state_dtype="int32", count_rebase=False, flight_capacity=64)],
    ids=["int16", "int32-ring"])
def test_24_miner_chunk_bit_equal_to_pallas_interpret(kwargs):
    _chunk_case([_r24(**kwargs)])


def test_24_miner_packed_chunk_bit_equal_to_pallas_interpret():
    """Two lane groups with different delays (1 s and 10 s), packed."""
    slow = _roster(HS24, [10_000] * 24)
    _chunk_case([_r24(), dataclasses.replace(_r24(), network=slow)], counts=(72, 56))


# ---------------------------------------------------------------------------
# Whole batches against the reference's engine.


def _run_both(cfg: SimConfig) -> dict:
    ref = ref_make_engine(_ref(cfg), cache=REF_CACHE)
    want = ref.run_batch(ref_run_keys(cfg.seed, 0, cfg.runs))
    eng = Engine(cfg, device="cpu")
    got = eng.run_batch(eng.make_keys(0, cfg.runs))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    return got


@pytest.mark.parametrize(
    "network,mode,runs,days,slots",
    [
        (R17, "fast", 32, 2, 2),
        (W1, "auto", 32, 2, 2),  # path W1's roster: fast
        (SELFISH20, "auto", 32, 2, 2),  # exact, selfish
        ("hetero32", "auto", 16, 2, 2),  # path W2's roster: exact
        (HONEST40, "auto", 8, 1, 2),  # exact, delays up to 60 s
        (_roster(HS24, _log_delays(24)), "auto", 16, 2, 4),
        (SELFISH33, "auto", 8, 1, 2),  # exact, two miners a lane, selfish
        (R33, "fast", 8, 1, 2),  # fast, two miners a lane
    ],
    ids=["17-fast", "32-fast", "20-selfish", "hetero32", "40-honest", "24-k4", "33-selfish",
         "33-fast"],
)
def test_run_batch_bit_equal(network, mode, runs, days, slots):
    if network == "hetero32":
        network = _hetero32()
    cfg = SimConfig(network=network, mode=mode, duration_ms=days * DAY, runs=runs,
                    batch_size=runs, group_slots=slots, seed=37)
    got = _run_both(cfg)
    assert got["stale_blocks_sum"].sum() > 0


def test_wide_batch_runs_the_wide_modes():
    """The rosters above resolve as the paths they stand for: W1 to fast
    mode, hetero32 and the 40-miner roster to exact mode."""
    assert Engine(SimConfig(network=W1), device="cpu").exact is False
    assert Engine(SimConfig(network=_hetero32()), device="cpu").exact is True
    assert Engine(SimConfig(network=HONEST40), device="cpu").exact is True


# ---------------------------------------------------------------------------
# Entry points: a packed grid, the hetero32 sweep, the trace command.


def test_packed_grid_of_two_32_miner_points_equals_the_reference():
    h32 = _hetero32()
    half = _roster(H32, [m.propagation_ms // 2 for m in h32.miners])
    pts = [(name, SimConfig(network=net, runs=12, batch_size=8, duration_ms=DAY, seed=5))
           for name, net in (("hetero32", h32), ("hetero32-half", half))]
    assert len(packed.plan_packs(pts)[0]) == 1  # one pack of both points
    want = ref_packed.run_grid([(n, _ref(c)) for n, c in pts], engine_cache={})
    got = packed.run_grid(pts, device="cpu")
    assert [e["name"] for e in got] == [e["name"] for e in want]
    for g, w in zip(got, want):
        for k in w["sums"]:
            np.testing.assert_array_equal(g["sums"][k], w["sums"][k], err_msg=k)
        for k in w["tele"]:
            np.testing.assert_array_equal(g["tele"][k], w["tele"][k], err_msg=k)
        gd, wd = g["results"].to_dict(), w["results"].to_dict()
        for k in _WALL:
            gd.pop(k, None)
            wd.pop(k, None)
        assert gd == wd


def _tiny_hetero32():
    return [(n, dataclasses.replace(c, runs=16, duration_ms=2 * DAY, batch_size=16))
            for n, c in sweep.baseline_sweeps()["hetero32"]()]


@pytest.fixture(scope="module")
def hetero32_ref_rows():
    pts = [(n, _ref(c)) for n, c in _tiny_hetero32()]
    return ref_sweep.run_sweep(pts, quiet=True, engine_cache=REF_CACHE)


@pytest.mark.parametrize("packed_run", [False, True], ids=["sequential", "packed"])
def test_hetero32_sweep_rows_equal_the_reference(hetero32_ref_rows, packed_run):
    want = hetero32_ref_rows
    got = sweep.run_sweep(_tiny_hetero32(), device="cpu", quiet=True, packed=packed_run)
    strip = lambda rows: [{k: v for k, v in r.items() if k not in _WALL} for r in rows]
    assert strip(got) == strip(want) and got[0]["point"] == "hetero32"
    assert len(got[0]["miners"]) == 32


def test_trace_on_a_32_miner_roster_writes_the_reference_event_log(tmp_path, capsys):
    path = tmp_path / "cfg.json"
    path.write_text(SimConfig(network=_hetero32(), duration_ms=DAY // 2, runs=4,
                              batch_size=4, seed=6, flight_capacity=128).to_json())
    for name, main in (("ref", ref_export.main), ("port", flight_export.main)):
        extra = ["--device", "cpu"] if name == "port" else []
        assert main(["--config", str(path)] + extra + [
            "--events-out", str(tmp_path / f"{name}.jsonl"),
            "--trace-out", str(tmp_path / f"{name}.json")]) == 0
    capsys.readouterr()
    got = (tmp_path / "port.jsonl").read_bytes()
    assert got == (tmp_path / "ref.jsonl").read_bytes()
    miners = {json.loads(line)["miner"] for line in got.decode().splitlines()}
    assert max(miners) > 16  # rows of the wide miners


def test_convert_carries_wide_params_and_state():
    cfg = SimConfig(network=_hetero32(), runs=8, batch_size=8)
    ref = {k: (v if k == "mean_interval_ms" else np.asarray(v))
           for k, v in ref_make_params(_ref(cfg))._asdict().items()}
    got, want = convert.params_from_numpy(ref), make_params(cfg)
    for name in ("thresholds", "prop_ms", "selfish"):
        assert getattr(got, name).shape[0] == 32
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    back = convert.params_to_numpy(got)
    for name in ("thresholds", "prop_ms", "selfish"):
        np.testing.assert_array_equal(back[name], ref[name], err_msg=name)
    # The reference's initial exact state at 32 miners, batched, carried
    # across: equal to the port's own, and back unchanged.
    count = COUNT_DTYPES[cfg.resolved_count_dtype]
    one = ref_init_state(32, 2, True, jnp.int16 if count == torch.int16 else jnp.int32,
                         any_selfish=False, count_rebase=cfg.count_rebase)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (8,) + x.shape), one)
    fields = _np(batched)
    state = convert.state_from_numpy(fields)
    own = init_state(8, 32, 2, count, cfg.count_rebase, "cpu", exact=True, any_selfish=False)
    assert state.cp.shape == (8, 32, 32, 32)
    for name, leaf in own._asdict().items():
        other = getattr(state, name)
        assert (leaf is None) == (other is None), name
        if leaf is not None:
            assert other.dtype == leaf.dtype and torch.equal(other, leaf), name
    for name, arr in convert.state_to_numpy(state).items():
        if arr is not None:
            np.testing.assert_array_equal(arr, fields[name], err_msg=name)


def test_wide_rosters_select_the_wide_libraries():
    """Above 16 miners the wrapper's kernels are the wide variants: libraries
    of their own (``-DTPUSIM_WIDE=1``), counted under their own names, whose
    exact entry points take the selfish flags' address, not a bit mask."""
    from tpusim_torch import event_loop
    from tpusim_torch.csrc import build

    assert event_loop.NARROW_MAX_MINERS == build.NARROW_MAX_MINERS == 16
    wide = [n for n in build.SOURCES if "_wide" in n]
    # Eight variants, each also raw-word, one-hot and both (K5a, K5b).
    assert len(wide) == 32 and set(wide) <= set(event_loop.launches)
    for name in wide:
        assert "-DTPUSIM_WIDE=1" in build._flags(name, 32, 2)
        assert "-DTPUSIM_WIDE=1" not in build._flags(name.replace("_wide", ""), 9, 2)
        assert build._target(name, 32, 2) != build._target(name.replace("_wide", ""), 32, 2)
    assert build._ENTRY["event_loop_exact"][1][6] is not build._ENTRY["event_loop_exact_wide"][1][6]
    with pytest.raises(ValueError, match="no kernel library"):
        build.build([("event_loop_exact", 17, 2)])
