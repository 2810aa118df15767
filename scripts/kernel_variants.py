"""The harness of the kernel-variant timing scripts (scripts/k2w_variants.py,
scripts/fast_variants.py, scripts/exact_variants.py, scripts/xoro_variants.py):
time edits of one kernel source on one NVIDIA card, in turns.

Each variant is an edit of the source (or of it and its shared headers),
built with the port's own nvcc flags
(tpusim_torch.csrc.build), one nvcc a (variant, library) and all started
together, into the git-ignored smoke_out/<tag>/ (:func:`build_variants`).
:func:`in_turns` swaps each variant's library in for the checkout's and
times a call: the mean of a few calls by CUDA events, the better of two
turns (variants in order, then reversed); a variant that computes the same
function is held against the checkout's kernel bit for bit. :func:`run`
does this for an event-loop kernel, through
tpusim_torch.event_loop.event_loop_chunk on one busy chunk (chunk 1, 8,192
runs x 1,856 steps) of each case, a case a configuration or, for a packed
grid, a tuple of them.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpusim_torch import event_loop, packed  # noqa: E402
from tpusim_torch.config import SimConfig  # noqa: E402
from tpusim_torch.csrc import build  # noqa: E402
from tpusim_torch.engine import Engine, counters_to_kernel  # noqa: E402
from tpusim_torch.event_loop import state_to_kernel  # noqa: E402
from tpusim_torch.flight import flight_to_kernel  # noqa: E402

#: What k2w_variants.py, fast_variants.py, exact_variants.py and
#: xoro_variants.py import.
__all__ = ("ROOT", "X2R_PER_FIND", "X2R_TILE_VARIANTS", "build_variants", "card", "in_turns",
           "run", "sub")

#: X2r's variants of the draw-ahead tile (xoro_tile.cuh): its draw loop
#: rolled (smaller code for the rarely run refill), and the kernels without
#: their bound of 64 registers a thread (8 blocks an SM: 8,192 runs in one
#: wave of 1,024 blocks).
_DRAW = "#pragma unroll\n    for (int j = 0; j < G; ++j) {"
_FAST_BOUNDS = "#define TPUSIM_FAST_BOUNDS __launch_bounds__(kBlockThreads, 8)"
_EXACT_BOUNDS = "#if TPUSIM_FLIGHT || TPUSIM_XORO_WORDS\n"
_UNBOUNDED = {
    "event_loop.cu": lambda s: sub(s, _FAST_BOUNDS, _FAST_BOUNDS.replace(", 8)", ")")),
    "event_loop_exact.cu": lambda s: sub(s, _EXACT_BOUNDS, "#if TPUSIM_FLIGHT\n")}
X2R_TILE_VARIANTS = {
    "x2r draw loop rolled": {"xoro_tile.cuh": lambda s: sub(
        s, _DRAW, _DRAW.replace("unroll", "unroll 1"))},
    "x2r tile unbounded": _UNBOUNDED,
}

#: The per-event xoroshiro kernels' first design (X2r, until the draw-ahead
#: tile of xoro_tile.cuh): every thread of a run keeps a copy of both
#: streams and, on each find, draws a word of each and maps them itself, the
#: exact kernels' winner by the run's thresholds read from global memory.
#: The definitions its kernel bodies use, after the common header.
X2R_PER_FIND = """
#if TPUSIM_XORO_WORDS
namespace {
struct XoroRun {
  Xoro xi{0ull, 0ull}, xw{0ull, 0ull};
  double mean_ns = 0.0;
  __device__ __forceinline__ void load(const XoroOperands& xo, long r, bool packed) {
    xi.load(xo.streams_in + 8 * r);
    xw.load(xo.streams_in + 8 * r + 4);
    mean_ns = __dmul_rn(xo.mean[packed ? r : 0], 1e6);
  }
  __device__ __forceinline__ void store(const XoroOperands& xo, long r) const {
    xi.store(xo.streams_out + 8 * r);
    xw.store(xo.streams_out + 8 * r + 4);
  }
};
template <int M>
__device__ __forceinline__ int winner_from_word64(const XoroOperands& xo, long off, long stride,
                                                  unsigned long long w) {
  int win = M - 1;
#pragma unroll 4
  for (int m = M - 2; m >= 0; --m) {
    if (threshold64(xo, m * stride + off) > w) win = m;
  }
  return win;
}
}  // namespace
#endif
"""

#: A library as csrc/build.py keys it: (kernel, miners, group slots).
Lib = tuple[str, int, int]
#: An edit of the source, or a dict of edits by file name (the source's or a
#: shared header's).
Edit = Callable[[str], str] | dict[str, Callable[[str], str]]
#: name -> (edit, whether it computes the checkout's function).
Variants = dict[str, tuple[Edit, bool]]


def sub(text: str, old: str, new: str) -> str:
    """``text`` with its one occurrence of ``old`` replaced by ``new``."""
    if text.count(old) != 1:
        raise SystemExit(f"kernel_variants: the source no longer holds {old[:60]!r}")
    return text.replace(old, new)


def _start(source: Path, out: Path, variant: str, edit, lib: Lib):
    d = out / re.sub(r"\W+", "_", f"{variant}_{lib[0]}_m{lib[1]}_k{lib[2]}")
    d.mkdir(parents=True, exist_ok=True)
    edits = edit if isinstance(edit, dict) else {source.name: edit}
    for f in (*source.parent.glob("*.cuh"), source):
        text = f.read_text()
        (d / f.name).write_text(edits[f.name](text) if f.name in edits else text)
    return d, subprocess.Popen(
        [build.nvcc(), *build._flags(*lib), "-o", str(d / "lib.so"), str(d / source.name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(key: tuple[str, Lib], d: Path, proc: subprocess.Popen,
          bind: Callable[[ctypes.CDLL], ctypes.CDLL]) -> tuple[ctypes.CDLL, int, int]:
    log = proc.communicate()[0]
    if proc.returncode:
        raise SystemExit(f"kernel_variants: {key} did not build\n{log}")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"[build] {key}: registers {regs}, spill stores {spills} B", flush=True)
    return bind(ctypes.CDLL(str(d / "lib.so"))), max(regs), max(spills)


def _bind_event_loop(kernel: str) -> Callable[[ctypes.CDLL], ctypes.CDLL]:
    def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
        entry, argtypes = build._ENTRY[kernel]
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        lib.tpusim_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
        return lib
    return bind


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them, printed."""
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(name, flush=True)
    return name


def build_variants(tag: str, source: Path, edits: dict[str, Edit],
                   libs, bind=None) -> dict[tuple[str, Lib], tuple[ctypes.CDLL, int, int]]:
    """Every variant's edit of ``source`` built for every library in
    ``libs``, one nvcc each, all started together, into smoke_out/<tag>/:
    (variant, library) -> (the library bound by ``bind``, or as its event-loop
    kernel's entry point, its most registers, its most spill stores in B)."""
    out = ROOT / "smoke_out" / tag
    started = {(v, lib): _start(source, out, v, edit, lib) for v, edit in edits.items()
               for lib in libs}
    return {key: _load(key, *proc, bind or _bind_event_loop(key[1][0]))
            for key, proc in started.items()}


def in_turns(tag: str, label: str, libs: dict[str, ctypes.CDLL], hook: str,
             call: Callable[[], tuple], want: tuple, exact, reps: int) -> dict[str, float]:
    """Each variant's ms a ``call()`` with its library in ``libs`` answering
    ``build.<hook>``: the mean of ``reps`` calls by CUDA events, the better of
    two turns (variants in order, then reversed). Fails unless each variant
    named in ``exact`` returns ``want``, the checkout's outputs."""
    real = getattr(build, hook)
    times: dict[str, list[float]] = {}
    try:
        for turn in range(2):
            for name in (list(libs) if turn == 0 else list(libs)[::-1]):
                setattr(build, hook, lambda *_, lib=libs[name]: lib)
                got = call()
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                for _ in range(reps):
                    call()
                b.record()
                torch.cuda.synchronize()
                if name in exact and not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise SystemExit(f"{tag}: {name} differs from the checkout on {label}")
                times.setdefault(name, []).append(a.elapsed_time(b) / reps)
    finally:
        setattr(build, hook, real)
    return {name: min(t) for name, t in times.items()}


def _engine(cfg: SimConfig | tuple[SimConfig, ...]) -> Engine:
    """An engine on the card for ``cfg``, or for a tuple of configurations a
    packed one that shares their first's batch out evenly among them, as
    packed._dispatch sets it up."""
    if isinstance(cfg, SimConfig):
        return Engine(cfg, "cuda")
    eng = Engine(cfg[0], "cuda", packed=True)
    counts = [eng.config.batch_size // len(cfg)] * len(cfg)
    eng.params = packed.stack_params(list(cfg), counts, "cuda")
    eng.run_durations = np.repeat([c.duration_ms for c in cfg], counts)
    return eng


def _busy_chunk(cfg: SimConfig | tuple[SimConfig, ...]):
    """The event loop's arguments and options for chunk 1 of ``cfg`` (a
    tuple: a packed grid of those points, :func:`_engine`); with
    ``rng="xoroshiro"`` its rows are X1's and the loop its consumed-row form,
    and with ``rng_batch=False`` as well there are no rows: the loop draws
    the words itself (X2r)."""
    eng = _engine(cfg)
    runs = eng.config.batch_size
    keys = eng.make_keys(0, runs)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    state, aux = eng._init(keys)
    state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    ctr, fr = aux[:2]
    prop, selfish = eng.roster()
    kw = eng.loop_options()
    if eng.xoro_words:
        rows = None
        kw["xoro"] = event_loop.XoroDraw(aux[3], eng.xoro_sampler(), eng.chunk_steps)
    elif eng.xoro:
        rows = eng.row_sampler(aux[3], aux[4], eng.xoro_sampler(), eng.chunk_steps)[0]
        kw["consumed_rows"] = True
    else:
        rows = eng._rows(keys, 1)
    args = (rows, cap, prop, state_to_kernel(state), counters_to_kernel(ctr), selfish,
            None if fr is None else flight_to_kernel(fr))
    return args, kw


def _outputs(x) -> tuple:
    return x[0] + x[1] + (x[2] or ()) + tuple(x[3:])


def run(tag: str, source: Path, variants: Variants, cases: dict[str, SimConfig | tuple],
        lib_of: Callable[[SimConfig | tuple], Lib]) -> dict[str, dict[str, float]]:
    """Build every variant for every case's library and print, for each case,
    each variant's time a busy chunk; returns them, case -> variant -> ms."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tag}: needs a CUDA device")
    name = card()
    built = build_variants(tag, source, {v: edit for v, (edit, _) in variants.items()},
                           sorted({lib_of(c) for c in cases.values()}))
    exact = {v for v, (_, same) in variants.items() if same}
    best = {}
    for label, cfg in cases.items():
        args, kw = _busy_chunk(cfg)

        def call(args=args, kw=kw) -> tuple:
            return _outputs(event_loop.event_loop_chunk(*args, **kw))

        best[label] = in_turns(tag, label, {v: built[v, lib_of(cfg)][0] for v in variants},
                               "load_library", call, call(), exact, reps=3)
        print(f"[{label}] ms a busy chunk, the better of two turns: " + ", ".join(
            f"{v} {ms:.3f}" for v, ms in best[label].items()) + f"; on {name}", flush=True)
    return best
