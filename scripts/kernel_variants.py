"""The harness of the kernel-variant timing scripts (scripts/k2w_variants.py,
scripts/fast_variants.py, scripts/xoro_variants.py): time edits of one
kernel source on one NVIDIA card, in turns.

Each variant is an edit of the source, built with the port's own nvcc flags
(tpusim_torch.csrc.build), one nvcc a (variant, library) and all started
together, into the git-ignored smoke_out/<tag>/ (:func:`build_variants`).
:func:`in_turns` swaps each variant's library in for the checkout's and
times a call: the mean of a few calls by CUDA events, the better of two
turns (variants in order, then reversed); a variant that computes the same
function is held against the checkout's kernel bit for bit. :func:`run`
does this for an event-loop kernel, through
tpusim_torch.event_loop.event_loop_chunk on one busy chunk (chunk 1, 8,192
runs x 1,856 steps) of each case.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from tpusim_torch import event_loop  # noqa: E402
from tpusim_torch.config import SimConfig  # noqa: E402
from tpusim_torch.csrc import build  # noqa: E402
from tpusim_torch.engine import Engine, counters_to_kernel  # noqa: E402
from tpusim_torch.event_loop import state_to_kernel  # noqa: E402
from tpusim_torch.flight import flight_to_kernel  # noqa: E402

#: What k2w_variants.py, fast_variants.py and xoro_variants.py import.
__all__ = ("ROOT", "build_variants", "card", "in_turns", "run", "sub")

#: A library as csrc/build.py keys it: (kernel, miners, group slots).
Lib = tuple[str, int, int]
#: name -> (edit of the source, whether it computes the checkout's function).
Variants = dict[str, tuple[Callable[[str], str], bool]]


def sub(text: str, old: str, new: str) -> str:
    """``text`` with its one occurrence of ``old`` replaced by ``new``."""
    if text.count(old) != 1:
        raise SystemExit(f"kernel_variants: the source no longer holds {old[:60]!r}")
    return text.replace(old, new)


def _start(source: Path, out: Path, variant: str, edit, lib: Lib):
    d = out / re.sub(r"\W+", "_", f"{variant}_{lib[0]}_m{lib[1]}_k{lib[2]}")
    d.mkdir(parents=True, exist_ok=True)
    for header in source.parent.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    (d / source.name).write_text(edit(source.read_text()))
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


def build_variants(tag: str, source: Path, edits: dict[str, Callable[[str], str]],
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


def _busy_chunk(cfg: SimConfig):
    """The event loop's arguments and options for chunk 1 of ``cfg``; with
    ``rng="xoroshiro"`` its rows are X1's and the loop its consumed-row form."""
    eng = Engine(cfg, "cuda")
    runs = eng.config.batch_size
    keys = eng.make_keys(0, runs)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    state, aux = eng._init(keys)
    state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    ctr, fr = aux[:2]
    prop, selfish = eng.roster()
    kw = eng.loop_options()
    if eng.xoro:
        rows = eng.row_sampler(aux[3], aux[4], eng.xoro_sampler(), eng.chunk_steps)[0]
        kw["consumed_rows"] = True
    else:
        rows = eng._rows(keys, 1)
    args = (rows, cap, prop, state_to_kernel(state), counters_to_kernel(ctr), selfish,
            None if fr is None else flight_to_kernel(fr))
    return args, kw


def _outputs(x) -> tuple:
    return x[0] + x[1] + (x[2] or ()) + tuple(x[3:])


def run(tag: str, source: Path, variants: Variants, cases: dict[str, SimConfig],
        lib_of: Callable[[SimConfig], Lib]) -> dict[str, dict[str, float]]:
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
