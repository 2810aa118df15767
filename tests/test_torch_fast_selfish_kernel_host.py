"""The fast kernel's selfish form (``tpusim_torch/csrc/event_loop.cu`` with
``TPUSIM_FAST_SELFISH``: K1s, K3fs, K4fs) run on the CPU, against its plain
version.

The kernel's source is built with g++ against ``tests/cuda_host/fibers/
cuda_runtime.h``, which runs a block's threads as fibers and each warp
collective as a barrier over its mask's lanes (a lane that meets its mask's
lanes at another collective, or a block in which no thread can move,
aborts the build's process: on the card the one is undefined and the other
a hang). Its wrapper, ``event_loop._launch``, takes CPU tensors with the
library swapped in, and every state leaf, counter and ring leaf must equal
the plain version's: K1s from a mid-run state with int16 and int32 counts
and ragged chunk ends, K3fs with a 64-row ring on the hetero roster, K4fs
on per-run flags (one lane group wholly honest), and K1s and K4fs from a
state in which the two runs of each warp differ, one holding private
blocks and the other none, so that they take the reveal's branch apart
(``test_torch_cuda._private_pairs``). It says nothing about speed or what
nvcc makes of the source (``tests/test_torch_cuda.py -k fast_selfish`` on
the card).
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusim_torch import event_loop, packed
from tpusim_torch.config import SimConfig, hetero_selfish_network, reference_selfish_network
from tpusim_torch.csrc import build
from tpusim_torch.engine import Engine, counters_to_kernel
from tpusim_torch.event_loop import event_loop_chunk_plain, state_to_kernel
from tpusim_torch.flight import FLIGHT_LEAVES, flight_to_kernel

from test_torch_cuda import _lane_configs, _private_pairs

CSRC = Path(event_loop.__file__).resolve().parent / "csrc"
FIBERS = Path(__file__).resolve().parent / "cuda_host" / "fibers"

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ unavailable")

#: Each kernel's build flags beside -DTPUSIM_MINERS.
FLAGS = {"event_loop_fast_selfish": (),
         "event_loop_fast_selfish_flight": ("-DTPUSIM_FLIGHT=1",),
         "event_loop_fast_selfish_packed": ("-DTPUSIM_PACKED=1",)}


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """(kernel name, miners) -> the kernel's host build, bound as
    ``build.load_library`` binds it: every kernel at 9 miners, K3fs at 4 too
    (the hetero roster)."""
    d = tmp_path_factory.mktemp("fast_selfish_kernel_host")
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, d)
    text = (CSRC / "event_loop.cu").read_text()
    text, n_launch = re.subn(r"kernel<<<grid, block, T::kSmem, stream>>>\(",
                             "host_launch(kernel, grid, block, T::kSmem, ", text)
    text, n_smem = re.subn(r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
                           "unsigned char* smem = host_smem();", text)
    assert n_launch == n_smem == 1, "event_loop.cu's launch or shared memory moved"
    (d / "event_loop.cu").write_text(text)
    keys = [(name, 9) for name in FLAGS] + [("event_loop_fast_selfish_flight", 4)]
    procs = {(name, m): subprocess.Popen(
        ["g++", "-x", "c++", "-std=c++17", "-O1", "-fPIC", "-shared", f"-I{FIBERS}", f"-I{d}",
         f"-DTPUSIM_MINERS={m}", "-DTPUSIM_FAST_SELFISH=1", *FLAGS[name], "-o",
         str(d / f"{name}-m{m}.so"), str(d / "event_loop.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, m in keys}
    libs = {}
    for (name, m), proc in procs.items():
        log = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(d / f"{name}-m{m}.so"))
        entry, argtypes = build._ENTRY[name]
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        lib.tpusim_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
        libs[name, m] = lib
    return libs


def _mid_run(eng: Engine, runs: int) -> tuple:
    """The event loop's arguments for chunk 1 after a plain chunk 0, with
    ragged chunk ends (runs frozen from the start and within the chunk)."""
    keys = eng.make_keys(0, runs)
    state, aux = eng._init(keys)
    cap = torch.full((runs,), 2**29, dtype=torch.int32)
    state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    cap = cap.clone()
    cap[:3] = 0
    cap[3:9] = torch.arange(1, 6 * 1600, 1600, dtype=torch.int32)
    prop, selfish = eng.roster()
    ctr, fr = aux[:2]
    return (eng._rows(keys, 1), cap, prop, state_to_kernel(state), counters_to_kernel(ctr),
            selfish, None if fr is None else flight_to_kernel(fr))


def _packed(counts: list[int], **kwargs) -> Engine:
    cfgs = _lane_configs("selfish", mode="fast", **kwargs)
    eng = Engine(cfgs[0], "cpu", packed=True)
    eng.params = packed.stack_params(cfgs, counts, "cpu")
    eng.run_durations = np.repeat([c.duration_ms for c in cfgs], counts)
    return eng


def _case(case: str) -> tuple[str, tuple]:
    small = dict(chunk_steps=160, batch_size=37, runs=37)
    if case in ("k1s-int16", "k1s-int32"):
        cfg = SimConfig(network=reference_selfish_network(), mode="fast",
                        state_dtype=case[-5:], **small)
        return "event_loop_fast_selfish", _mid_run(Engine(cfg, "cpu"), 37)
    if case == "k3fs-hetero":
        cfg = SimConfig(network=hetero_selfish_network(), mode="fast", flight_capacity=64,
                        **small)
        return "event_loop_fast_selfish_flight", _mid_run(Engine(cfg, "cpu"), 37)
    if case == "k4fs":
        eng = _packed([10, 10, 10, 10], chunk_steps=160, batch_size=40, runs=40)
        return "event_loop_fast_selfish_packed", _mid_run(eng, 40)
    if case == "k1s-pairs":
        eng = Engine(SimConfig(network=reference_selfish_network(), mode="fast",
                               state_dtype="int16"), "cpu")
        return "event_loop_fast_selfish", _private_pairs(eng, 42, 96, 17, "cpu") + (None,)
    return ("event_loop_fast_selfish_packed",
            _private_pairs(_packed([12, 10, 10, 10]), 42, 96, 17, "cpu") + (None,))


@pytest.mark.parametrize("case", ["k1s-int16", "k1s-int32", "k3fs-hetero", "k4fs",
                                  "k1s-pairs", "k4fs-pairs"])
def test_fast_selfish_kernel_on_the_host_equals_plain(host_kernels, monkeypatch, case):
    kernel, args = _case(case)
    m = args[3][event_loop.FAST_SELFISH_LEAVES.index("height")].shape[0]
    monkeypatch.setattr(build, "load_library", lambda *_: host_kernels[kernel, m])
    monkeypatch.setattr(torch.cuda, "device", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda _=None: types.SimpleNamespace(cuda_stream=0))
    before = event_loop.launches[kernel]
    got = event_loop._launch(*args)
    assert event_loop.launches[kernel] == before + 1
    want = event_loop_chunk_plain(*args)
    names = (event_loop.FAST_SELFISH_LEAVES + event_loop.TELE_LEAVES
             + (FLIGHT_LEAVES if args[6] is not None else ()))
    flat = lambda out: (*out[0], *out[1], *(out[2] or ()))
    assert len(flat(got)) == len(names)
    for name, g, w in zip(names, flat(got), flat(want), strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), name
