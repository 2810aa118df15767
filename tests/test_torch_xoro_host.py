"""X1's CUDA source (``tpusim_torch/csrc/xoroshiro.cu``) on the CPU, against
its plain version.

The source is built with g++ against a host stand-in for the CUDA runtime
(``tests/cuda_host/cuda_runtime.h``: the double intrinsics as plain
operations and ``fma``, ``__double2hiint`` and its kin by ``memcpy``, a
launch as a loop over blocks whose threads are host threads, the kernel's
``__syncthreads`` and named barriers as ``std::barrier``), with
``-ffp-contract=off`` so that g++ fuses nothing the card does not. Its
entry point ``tpusim_xoro_rows`` then runs on CPU tensors, and every row and
every stream word must equal :func:`tpusim_torch.xoroshiro.xoro_rows_plain`'s:
for one run, a partial block and several blocks; 1 step, a tile less and
more one step, a whole tile and a few hundred steps (the ring wraps); no
draw consumed, the whole chunk consumed and mixed; uniform and per-run
rosters. It shows that the generator and mapping warps hand every tile over
and that the ring's slots are neither skipped nor overwritten early; it
says nothing about speed, registers or what nvcc makes of the source
(``tests/test_torch_cuda.py`` holds the kernel on the card).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusim_torch import packed, xoroshiro
from tpusim_torch.config import MinerConfig, NetworkConfig, SimConfig, default_network
from tpusim_torch.config import reference_selfish_network
from tpusim_torch.csrc import build
from tpusim_torch.engine import Engine

SOURCE = Path(xoroshiro.__file__).resolve().parent / "csrc" / "xoroshiro.cu"
SHIM = Path(__file__).resolve().parent / "cuda_host"

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ unavailable")

#: Run counts by the kernel's runs a block and step counts by its steps a
#: tile, as the built kernel gives them.
RUNS = {"1": lambda block: 1, "block+13": lambda block: block + 13,
        "3 blocks": lambda block: 3 * block}
STEPS = {"1": lambda tile: 1, "tile-1": lambda tile: tile - 1, "tile": lambda tile: tile,
         "tile+1": lambda tile: tile + 1, "300": lambda tile: 300}

#: (runs, steps, consumed, per-run roster): every run count, step count,
#: consumed pattern and roster kind, each with several of the others.
CASES = [
    ("1", "1", "none", False),
    ("1", "tile+1", "all", True),
    ("1", "300", "mixed", False),
    ("block+13", "1", "all", True),
    ("block+13", "tile-1", "mixed", False),
    ("block+13", "tile", "mixed", True),
    ("block+13", "tile+1", "mixed", True),
    ("block+13", "300", "all", False),
    ("3 blocks", "tile-1", "none", True),
    ("3 blocks", "tile+1", "all", False),
    ("3 blocks", "300", "mixed", False),
    ("3 blocks", "300", "mixed", True),
]


@pytest.fixture(scope="module")
def host_x1(tmp_path_factory):
    """``xoroshiro.cu`` built for the host, its entry points bound."""
    lib = tmp_path_factory.mktemp("xoro_host") / "libxoroshiro_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", "-x", "c++", f"-I{SHIM}", "-o", str(lib), str(SOURCE)],
                   check=True, capture_output=True, text=True, timeout=300)
    return build.bind_xoro(ctypes.CDLL(str(lib)))


def _sampler(runs: int, per_run: bool) -> xoroshiro.XoroSampler:
    if not per_run:
        bursty = NetworkConfig(miners=tuple(
            MinerConfig(hashrate_pct=p, propagation_ms=d)
            for p, d in ((40, 0), (30, 3), (20, 0), (10, 1))), block_interval_s=0.05)
        return xoroshiro.make_xoro_sampler(Engine(SimConfig(network=bursty), "cpu").params)
    cfgs = [SimConfig(network=n) for n in (
        default_network(), reference_selfish_network(),
        default_network(hashrates=(20, 20, 20, 10, 10, 10, 5, 4, 1)),
        NetworkConfig(miners=default_network().miners, block_interval_s=1.0))]
    counts = [runs // 4 + (i < runs % 4) for i in range(4)]
    return xoroshiro.make_xoro_sampler(packed.stack_params(cfgs, counts, "cpu"))


@pytest.mark.parametrize("runs,steps,consumed_kind,per_run", CASES)
def test_host_build_of_x1_equals_plain(host_x1, runs, steps, consumed_kind, per_run):
    shape = build.xoro_shape(host_x1)
    runs, steps = RUNS[runs](shape["kRuns"]), STEPS[steps](shape["kTile"])
    streams = torch.from_numpy(xoroshiro.pack_run_streams(7, 5, runs).view(np.int32))
    rng = np.random.default_rng(runs * 1000 + steps)
    consumed = {"none": np.zeros(runs), "all": np.full(runs, steps),
                "mixed": rng.integers(0, steps + 1, runs)}[consumed_kind]
    consumed = torch.from_numpy(consumed.astype(np.int32))
    if consumed_kind == "mixed":
        consumed[::3] = 0
        consumed[1::3] = steps
    smp = _sampler(runs, per_run)
    m = smp.thr_hi.shape[0]
    rows = torch.full((steps, 2, runs), -7, dtype=torch.int32)
    out = torch.full_like(streams, -7)
    err = host_x1.tpusim_xoro_rows(streams.data_ptr(), consumed.data_ptr(), smp.thr_hi.data_ptr(),
                  smp.thr_lo.data_ptr(), smp.mean.data_ptr(), m, int(per_run), steps, runs,
                  rows.data_ptr(), out.data_ptr(), None)
    assert err == 0
    want_rows, want_out = xoroshiro.xoro_rows_plain(streams, consumed, smp, steps)
    assert torch.equal(out, want_out)
    assert torch.equal(rows, want_rows)
