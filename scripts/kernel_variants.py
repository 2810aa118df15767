"""The harness of the kernel-variant timing scripts (scripts/k2w_variants.py,
scripts/fast_variants.py): time edits of one event-loop kernel source on one
NVIDIA card, in turns.

Each variant is an edit of the source, built with the port's own nvcc flags
(tpusim_torch.csrc.build), one nvcc a (variant, library) and all started
together, into the git-ignored smoke_out/<tag>/, and launched through
tpusim_torch.event_loop.event_loop_chunk on one busy chunk (chunk 1, 8,192
runs x 1,856 steps) of each case. Its time is the mean of three launches by
CUDA events, the better of two turns (variants in order, then reversed). A
variant that computes the same function is held against the checkout's
kernel bit for bit.
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

#: What k2w_variants.py and fast_variants.py import.
__all__ = ("ROOT", "run", "sub")

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


def _load(key: tuple[str, Lib], d: Path, proc: subprocess.Popen) -> ctypes.CDLL:
    log = proc.communicate()[0]
    if proc.returncode:
        raise SystemExit(f"kernel_variants: {key} did not build\n{log}")
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    print(f"[build] {key}: registers {regs}, spill stores {spills} B", flush=True)
    lib = ctypes.CDLL(str(d / "lib.so"))
    entry, argtypes = build._ENTRY[key[1][0]]
    getattr(lib, entry).argtypes = argtypes
    getattr(lib, entry).restype = ctypes.c_int
    lib.tpusim_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _busy_chunk(cfg: SimConfig):
    """The event loop's arguments and options for chunk 1 of ``cfg``."""
    eng = Engine(cfg, "cuda")
    runs = eng.config.batch_size
    keys = eng.make_keys(0, runs)
    cap = torch.full((runs,), 2**29, dtype=torch.int32, device="cuda")
    state, aux = eng._init(keys)
    state, aux, _ = eng._chunk(state, aux, cap, keys, 0)
    ctr, fr, _ = aux
    prop, selfish = eng.roster()
    args = (eng._rows(keys, 1), cap, prop, state_to_kernel(state), counters_to_kernel(ctr),
            selfish, None if fr is None else flight_to_kernel(fr))
    return args, eng.loop_options()


def _outputs(x) -> tuple:
    return x[0] + x[1] + (x[2] or ())


def run(tag: str, source: Path, variants: Variants, cases: dict[str, SimConfig],
        lib_of: Callable[[SimConfig], Lib]) -> None:
    """Build every variant for every case's library and print, for each case,
    each variant's time a busy chunk."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tag}: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    out = ROOT / "smoke_out" / tag
    started = {(v, lib): _start(source, out, v, edit, lib) for v, (edit, _) in variants.items()
               for lib in sorted({lib_of(c) for c in cases.values()})}
    libs = {key: _load(key, *proc) for key, proc in started.items()}
    real = build.load_library
    for label, cfg in cases.items():
        args, kw = _busy_chunk(cfg)
        want = _outputs(event_loop.event_loop_chunk(*args, **kw))
        times = {}
        for turn in range(2):
            for name in (list(variants) if turn == 0 else list(variants)[::-1]):
                build.load_library = lambda *_, lib=libs[name, lib_of(cfg)]: lib
                try:
                    got = _outputs(event_loop.event_loop_chunk(*args, **kw))
                    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    a.record()
                    for _ in range(3):
                        event_loop.event_loop_chunk(*args, **kw)
                    b.record()
                    torch.cuda.synchronize()
                finally:
                    build.load_library = real
                if variants[name][1] and not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise SystemExit(f"{tag}: {name} differs from the checkout on {label}")
                times.setdefault(name, []).append(a.elapsed_time(b) / 3)
        print(f"[{label}] ms a busy chunk, the better of two turns: " + ", ".join(
            f"{name} {min(t):.3f}" for name, t in times.items()) + f"; on {card}", flush=True)
