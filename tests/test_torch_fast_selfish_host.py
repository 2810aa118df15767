"""The fast kernel's selfish per-lane rules (``tpusim_torch/csrc/
fast_selfish_step.cuh``: the race test and private append of a find, the
reveal's predicate and count, the private count's moves) on the CPU,
against the plain version's rule (``event_loop.event_loop_chunk_plain``'s
find and reveal).

``tests/cuda_host/fast_selfish_host.cpp`` is built with g++ against the host
stand-in for the CUDA runtime (``tests/cuda_host/cuda_runtime.h``). It steps
one miner's lane through one step as the kernel's selfish form does: the
helpers, with the kernel's own group helpers (``push2``, ``flush2``) for
the find's push, the notify's flush and the reveal's push, then the
adoption and bhp, given the best published height of the other miners. The
plain version steps a two-miner chunk of one step whose runs are the same
cases: miner 0 the lane's miner (selfish per run), miner 1 an honest rival
whose published height sets the best chain. The lane's private count, its
arrival groups, the overflows and bhp must equal the plain version's, over
every combination of lead -2..3, private count 0-4, bhp level with the
height or not, selfish or not, a notify or not, a find by the miner or not,
and five states of its groups (empty, pending, pending at the push's own
arrival, both slots full, one arrived), and over hypothesis-drawn heights,
times, delays and groups. It says nothing about what nvcc makes of the
source (``tests/test_torch_cuda.py -k fast_selfish`` holds the kernels on
the card).
"""

from __future__ import annotations

import ctypes
import itertools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tpusim_torch import event_loop
from tpusim_torch.engine import counters_to_kernel, init_counters
from tpusim_torch.state import INF_TIME, init_state

CSRC = Path(event_loop.__file__).resolve().parent / "csrc"
SHIM = Path(__file__).resolve().parent / "cuda_host"

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ unavailable")

#: A case's fields, in the host program's order (its ``In``), and what it
#: returns (its ``Out``).
IN = ("won", "sel", "npriv", "bhp", "height", "a0", "a1", "c0", "c1", "t", "prop", "notify",
      "rival_pub")
OUT = ("npriv", "a0", "a1", "c0", "c1", "ovf", "bhp", "pushed", "lead", "reveal", "revealed")
#: The rival's delay: its own find's group stays unarrived through the step.
RIVAL_PROP = 700


@pytest.fixture(scope="module")
def host_lane(tmp_path_factory):
    """``fast_selfish_host.cpp`` built for the host, its entry point bound."""
    lib = tmp_path_factory.mktemp("fast_selfish_host") / "libfast_selfish_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{SHIM}", f"-I{CSRC}",
                    "-o", str(lib), str(SHIM / "fast_selfish_host.cpp")],
                   check=True, capture_output=True, text=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).tpusim_fast_selfish_host
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int

    def run(cases: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        ins = np.ascontiguousarray(np.stack([cases[k] for k in IN], axis=1), dtype=np.int32)
        out = np.zeros((len(ins), len(OUT)), dtype=np.int32)
        assert fn(len(ins), len(IN), len(OUT), ins.ctypes.data, out.ctypes.data) == 0
        return dict(zip(OUT, out.T))

    return run


def _plain(cases: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """One step of a two-miner chunk through the plain version, a run a
    case: miner 0 the case's miner, miner 1 an honest rival at
    ``rival_pub`` with no groups, who finds where miner 0 does not and the
    step holds no notify (a find at the same ms defers it)."""
    r = len(cases["t"])
    c = {k: torch.from_numpy(np.asarray(v, dtype=np.int32)) for k, v in cases.items()}
    won, notify = c["won"].bool(), c["notify"].bool()
    names = event_loop.FAST_SELFISH_LEAVES
    lv = dict(zip(names, event_loop.state_to_kernel(
        init_state(r, 2, 2, torch.int32, False, "cpu", any_selfish=True))))
    lv["t"] = c["t"][None]
    lv["nbt"] = torch.where(won | ~notify, c["t"], c["t"] + 50)[None]
    lv["height"] = torch.stack([c["height"], c["rival_pub"]])
    lv["ocnt"] = lv["height"].clone()
    lv["garr"] = torch.stack([torch.stack([c["a0"], c["a1"]]),
                              torch.full((2, r), INF_TIME, dtype=torch.int32)])
    lv["gcnt"] = torch.stack([torch.stack([c["c0"], c["c1"]]),
                              torch.zeros((2, r), dtype=torch.int32)])
    lv["npriv"] = torch.stack([c["npriv"], torch.zeros(r, dtype=torch.int32)])
    lv["bhp"] = c["bhp"][None]
    rows = torch.stack([torch.where(won, 0, 1), torch.where(notify, 1000, 0)]).to(torch.int32)
    prop = torch.stack([c["prop"], torch.full((r,), RIVAL_PROP, dtype=torch.int32)])
    selfish = torch.stack([c["sel"], torch.zeros(r, dtype=torch.int32)])
    leaves, _, _ = event_loop.event_loop_chunk_plain(
        rows[None], torch.full((r,), 2**29, dtype=torch.int32), prop,
        tuple(lv[n] for n in names), counters_to_kernel(init_counters(r, 2, "cpu")), selfish)
    out = dict(zip(names, leaves))
    return {"npriv": out["npriv"][0], "a0": out["garr"][0, 0], "a1": out["garr"][0, 1],
            "c0": out["gcnt"][0, 0], "c1": out["gcnt"][0, 1], "ovf": out["ovf"][0],
            "bhp": out["bhp"][0]}


def _held(host_lane, cases: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    got, want = host_lane(cases), _plain(cases)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w.numpy(), err_msg=name)
    return got


def test_selfish_rules_equal_the_plain_version_on_every_small_case(host_lane):
    """Every combination of the rules' inputs at one height: lead -2..3
    (the rival at the miner's height after its find less the lead), private
    count 0-4, bhp level or not, selfish or not, notify or not, won or not,
    five group states."""
    h, t, prop = 20, 10_000, 1000
    groups = ((INF_TIME, INF_TIME, 0, 0), (t + 5, INF_TIME, 5, 0), (t + prop, INF_TIME, 5, 0),
              (t + 5, t + 9, 2, 3), (t - 3, t + 9, 1, 4))
    rows = [dict(won=won, sel=sel, npriv=n, bhp=h if level else h + 1, height=h,
                 a0=g[0], a1=g[1], c0=g[2], c1=g[3], t=t, prop=prop, notify=notify,
                 rival_pub=h + won - lead)
            for lead, n, level, sel, notify, won, g in itertools.product(
                range(-2, 4), range(5), (True, False), (0, 1), (0, 1), (0, 1), groups)]
    got = _held(host_lane, {k: np.array([row[k] for row in rows]) for k in IN})
    reveal = got["reveal"].astype(bool)
    # Every branch of the rules ran: races, private appends, reveals at
    # each lead that reveals, of one block and more, and overflows.
    assert (got["pushed"] == 2).any() and ((got["pushed"] == 0) & (np.array(
        [r["won"] for r in rows]) == 1)).any()
    assert set(got["lead"][reveal]) == {0, 1, 2, 3}
    assert {1, 2, 3, 4} <= set(got["revealed"][reveal])
    assert (got["ovf"] > 0).any()


@st.composite
def _cases(draw) -> list[dict[str, int]]:
    out = []
    for _ in range(draw(st.integers(1, 48))):
        t = draw(st.integers(1, 2**28))
        prop = draw(st.integers(1, 20_000))
        height = draw(st.integers(0, 2**14))
        won = draw(st.integers(0, 1))
        slots = draw(st.integers(0, 2))
        arrivals = sorted(draw(st.one_of(st.just(t + prop), st.integers(t - 50, t + 20_000)))
                          for _ in range(slots))
        arrivals += [INF_TIME] * (2 - slots)
        counts = [draw(st.integers(1, 6)) for _ in range(slots)] + [0] * (2 - slots)
        out.append(dict(won=won, sel=draw(st.integers(0, 1)), npriv=draw(st.integers(0, 6)),
                        bhp=height + draw(st.integers(-2, 2)), height=height,
                        a0=arrivals[0], a1=arrivals[1], c0=counts[0], c1=counts[1], t=t,
                        prop=prop, notify=draw(st.integers(0, 1)),
                        rival_pub=height + won - draw(st.integers(-3, 4))))
    return out


@settings(max_examples=40, deadline=None)
@given(rows=_cases())
def test_selfish_rules_equal_the_plain_version_on_drawn_heights(host_lane, rows):
    _held(host_lane, {k: np.array([row[k] for row in rows]) for k in IN})
