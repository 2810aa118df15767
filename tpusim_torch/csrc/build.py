"""Build and load the port's CUDA kernels.

Each kernel's source (``SOURCES``) is compiled by ``nvcc`` for ``sm_90a``
into shared libraries with a plain C interface, one per miner count M and
group-slot count K (the kernels unroll their per-miner and per-slot loops
over a compile-time M and K, and a run needs one of each), loaded with
``ctypes`` (pointers and the stream are passed as integers). The
flight-recorder variants are the same sources built with
``-DTPUSIM_FLIGHT=1``, the packed-grid variants with ``-DTPUSIM_PACKED=1``,
the packed grid with the recorder with both, and K >= 3 adds
``-DTPUSIM_GROUP_SLOTS=<K>`` (a K = 2 build takes no flag), each into a
library of its own, so they compile in parallel with the others. The wide
variants (``*_wide*``, for rosters of more than 16 miners) are each of
these built with ``-DTPUSIM_WIDE=1``, for any M; the others take 1..16
miners. Each of these again has a raw-word form (``*_raw*``,
``-DTPUSIM_RAW_WORDS=1``, K5a: the kernel maps the raw threefry words
itself and takes the thresholds and the mean), a one-hot form
(``*_onehot*``, ``-DTPUSIM_ONEHOT=1``, K5b: b-indexed reads as one-hot
contractions) and both, and a consumed-row form (``*_consumed*``,
``-DTPUSIM_CONSUMED_ROWS=1``, X2: a run reads the row of its finds so far
in the chunk and returns their count, for the xoroshiro path), alone and
with the one-hot one; a library without these flags is built with the
same ``nvcc`` command as before they existed. A library is named after its
kernel, M, K and a hash of its source, the shared headers (``*.cuh``) and
the flags, so an edited source is never served by a stale build. The
builds run at first use, into ``tpusim_torch/csrc/build/`` (ignored by
git); :func:`build` starts one ``nvcc`` per library asked for, all at
once.

The layout micro-benchmarks (S1, ``micro.cu``) are one library of their
own, ``MICRO``, with no miner or slot count (:func:`load_micro`), and so is
the xoroshiro row sampler (X1, ``xoroshiro.cu``), ``XORO``
(:func:`load_xoro`).

Run ``python -m tpusim_torch.csrc.build [M ...]`` (default M = 9) to build
the K = 2 libraries ahead of time (the wide ones for M > 16) and print the
compiler's register and spill report.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

__all__ = [
    "SOURCES", "BUILD_DIR", "NVCC_FLAGS", "NARROW_MAX_MINERS", "MAP_ENTRY", "MICRO", "XORO",
    "XORO_SHAPE", "bind_xoro", "build", "entry_point", "load_library", "load_micro", "load_xoro",
    "xoro_shape", "xoro_smem_bytes",
]

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC / "build"
#: Kernel name -> its source: each mode's kernel, then with ``_wide`` its
#: wide variant, with ``_raw``, ``_onehot`` and ``_consumed`` its raw-word,
#: one-hot and consumed-row variants, then with ``_packed`` and ``_flight``
#: its packed-grid and flight-recorder variants.
SOURCES = {
    f"event_loop_{mode}{wide}{knobs}{variant}": CSRC / src
    for mode, src in (("fast", "event_loop.cu"), ("exact", "event_loop_exact.cu"))
    for wide in ("", "_wide")
    for knobs in ("", "_raw", "_onehot", "_raw_onehot", "_consumed", "_consumed_onehot")
    for variant in ("", "_flight", "_packed", "_packed_flight")
}
#: The layout micro-benchmarks' library (S1): ``(MICRO, 0, 0)`` in :func:`build`.
MICRO = "micro"
#: The xoroshiro row sampler's library (X1): ``(XORO, 0, 0)`` in :func:`build`.
XORO = "xoroshiro"
#: The libraries with no miner or slot count, and their sources.
_STANDALONE = {MICRO: CSRC / "micro.cu", XORO: CSRC / "xoroshiro.cu"}
#: Narrow kernels hold a run's state in registers, up to this many miners.
NARROW_MAX_MINERS = 16
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_vp, _i, _pp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
_FAST_ARGS = [_vp, _vp, _vp, _pp, _pp, _i, _i, _i, _i, _i]
_EXACT_ARGS = [_vp, _vp, _vp, _pp, _pp, _i, ctypes.c_uint, _i, _i, _i, _i]
#: The exact kernel's arguments with the selfish flags' address (or NULL)
#: where the uniform narrow variants take the flags' bit mask: the packed
#: variants' per-run (M, R) flags, and every wide variant's.
_EXACT_PTR_ARGS = _EXACT_ARGS[:6] + [_vp] + _EXACT_ARGS[7:]
#: Kernel name -> (C entry point, its argument types; the stream last).
_ENTRY = {
    "event_loop_fast": ("tpusim_event_loop_chunk", _FAST_ARGS + [_vp]),
    "event_loop_exact": ("tpusim_event_loop_exact_chunk", _EXACT_ARGS + [_vp]),
    # The flight leaves' pointers and the ring capacity, before the stream.
    "event_loop_fast_flight": ("tpusim_event_loop_flight_chunk", _FAST_ARGS + [_pp, _i, _vp]),
    "event_loop_exact_flight": (
        "tpusim_event_loop_exact_flight_chunk", _EXACT_ARGS + [_pp, _i, _vp]),
    # prop is (M, R), and the exact kernel takes per-run selfish flags.
    "event_loop_fast_packed": ("tpusim_event_loop_packed_chunk", _FAST_ARGS + [_vp]),
    "event_loop_exact_packed": ("tpusim_event_loop_exact_packed_chunk", _EXACT_PTR_ARGS + [_vp]),
    # Both: the packed operands, then the flight leaves before the stream.
    "event_loop_fast_packed_flight": (
        "tpusim_event_loop_packed_flight_chunk", _FAST_ARGS + [_pp, _i, _vp]),
    "event_loop_exact_packed_flight": (
        "tpusim_event_loop_exact_packed_flight_chunk", _EXACT_PTR_ARGS + [_pp, _i, _vp]),
}
# The wide variants: the same entry points; every exact one takes the flags'
# address.
_ENTRY.update({
    name.replace("_fast", "_fast_wide").replace("_exact", "_exact_wide"):
    (entry, [_vp if a is ctypes.c_uint else a for a in args])
    for name, (entry, args) in list(_ENTRY.items())
})
# The raw-word, one-hot and consumed-row variants: the same entry points; a
# raw-word one takes the thresholds' and the mean's addresses (lo, hi, mean)
# before the stream, a consumed-row one the consumed counts' (R,) int32.
_ENTRY.update({
    re.sub(r"^(event_loop_(fast|exact)(_wide)?)", rf"\1{knobs}", name):
    (entry, args[:-1] + [_vp] * (3 if "_raw" in knobs else 1 if "_consumed" in knobs else 0)
     + args[-1:])
    for name, (entry, args) in list(_ENTRY.items())
    for knobs in ("_raw", "_onehot", "_raw_onehot", "_consumed", "_consumed_onehot")
})
#: The raw-word libraries' mapping alone (K5a's device functions), its C
#: entry point and argument types: words, lo, hi, mean, n, out, stream.
MAP_ENTRY = ("tpusim_map_raw_words", [_vp, _vp, _vp, _vp, _i, _vp, _vp])


def nvcc() -> str:
    """The CUDA compiler: PyTorch's CUDA_HOME first, then the PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.access(os.path.join(CUDA_HOME, "bin", "nvcc"), os.X_OK):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _flags(name: str, miners: int, slots: int) -> tuple[str, ...]:
    if name in _STANDALONE:
        return NVCC_FLAGS
    packed = ("-DTPUSIM_PACKED=1",) if "_packed" in name else ()
    group = (f"-DTPUSIM_GROUP_SLOTS={slots}",) if slots != 2 else ()
    wide = ("-DTPUSIM_WIDE=1",) if "_wide" in name else ()
    raw = ("-DTPUSIM_RAW_WORDS=1",) if "_raw" in name else ()
    onehot = ("-DTPUSIM_ONEHOT=1",) if "_onehot" in name else ()
    consumed = ("-DTPUSIM_CONSUMED_ROWS=1",) if "_consumed" in name else ()
    return (*NVCC_FLAGS, f"-DTPUSIM_MINERS={miners}",
            f"-DTPUSIM_FLIGHT={int(name.endswith('_flight'))}", *packed, *group, *wide, *raw,
            *onehot, *consumed)


def _source(name: str) -> Path:
    return _STANDALONE.get(name) or SOURCES[name]


def _target(name: str, miners: int, slots: int) -> Path:
    digest = hashlib.sha256(_source(name).read_bytes())
    if name in _STANDALONE:
        digest.update(" ".join(_flags(name, miners, slots)).encode())
        return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_flags(name, miners, slots)).encode())
    k = f"-k{slots}" if slots != 2 else ""
    return BUILD_DIR / f"lib{name}-m{miners}{k}-{digest.hexdigest()[:16]}.so"


def build(libs) -> dict[tuple[str, int, int], tuple[Path, float, str]]:
    """Compile the ``(kernel name, miner count, group slots)`` libraries in
    ``libs`` that lack a current build, one ``nvcc`` each, all started
    together. Returns, per library, ``(path, seconds from the start of the
    build until it was done, compiler log)``; raises with the compiler's
    output if a build fails."""
    libs = list(libs)
    for name, miners, slots in libs:
        if name in _STANDALONE and (miners, slots) == (0, 0):
            continue
        too_wide = "_wide" not in name and miners > NARROW_MAX_MINERS
        if name not in SOURCES or miners < 1 or too_wide or slots < 2:
            raise ValueError(f"no kernel library {name!r} for {miners} miners and "
                             f"{slots} group slots")
    done = {lib: (_target(*lib), 0.0, "") for lib in libs if _target(*lib).exists()}
    todo = [lib for lib in libs if lib not in done]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        t0 = time.perf_counter()
        procs = {}
        for lib in todo:
            tmp = _target(*lib).with_suffix(f".{os.getpid()}.tmp")
            procs[lib] = (tmp, subprocess.Popen(
                [compiler, *_flags(*lib), "-o", str(tmp), str(_source(lib[0]))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failed = []
        for lib, (tmp, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{lib[0]} ({_source(lib[0]).name}, M = {lib[1]}, K = {lib[2]}): "
                              f"nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, _target(*lib))  # atomic: a concurrent loader sees all or nothing
            done[lib] = (_target(*lib), time.perf_counter() - t0, log)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {lib: done[lib] for lib in libs}


def entry_point(name: str) -> str:
    """The C function that launches the named kernel."""
    return _ENTRY[name][0]


@functools.cache
def load_library(name: str, miners: int, slots: int) -> ctypes.CDLL:
    """The named kernel's library for ``miners`` miners and ``slots`` group
    slots, built on first use."""
    lib = ctypes.CDLL(str(build([(name, miners, slots)])[name, miners, slots][0]))
    entry, argtypes = _ENTRY[name]
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = _i
    if "_raw" in name:
        fn = getattr(lib, MAP_ENTRY[0])
        fn.argtypes = MAP_ENTRY[1]
        fn.restype = _i
    lib.tpusim_cuda_error_string.argtypes = [_i]
    lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_micro() -> ctypes.CDLL:
    """The layout micro-benchmarks' library (``micro.cu``), built on first
    use: ``tpusim_micro_launch(op, ins, out, iters, runs, stream)``."""
    lib = ctypes.CDLL(str(build([(MICRO, 0, 0)])[MICRO, 0, 0][0]))
    lib.tpusim_micro_launch.argtypes = [_i, _pp, _vp, _i, _i, _vp]
    lib.tpusim_micro_launch.restype = _i
    lib.tpusim_cuda_error_string.argtypes = [_i]
    lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_xoro() -> ctypes.CDLL:
    """The xoroshiro row sampler's library (X1, ``xoroshiro.cu``), built on
    first use: ``tpusim_xoro_rows(streams_in, consumed, thr_hi, thr_lo,
    mean, n_miners, per_run, steps, n_runs, rows, streams_out, stream)``."""
    return bind_xoro(ctypes.CDLL(str(build([(XORO, 0, 0)])[XORO, 0, 0][0])))


#: X1's launch shape, in the order ``tpusim_xoro_shape`` gives it: runs a
#: block, steps a tile, tiles in the ring, generator and mapping warps.
XORO_SHAPE = ("kRuns", "kTile", "kRing", "kGenWarps", "kMapWarps")


def xoro_shape(lib: ctypes.CDLL) -> dict[str, int]:
    """X1's launch shape as ``lib``, a build of ``xoroshiro.cu``, launches it."""
    shape = (ctypes.c_int * len(XORO_SHAPE))()
    lib.tpusim_xoro_shape(shape)
    return dict(zip(XORO_SHAPE, shape))


def xoro_smem_bytes(lib: ctypes.CDLL, n_miners: int, per_run: bool) -> int:
    """The dynamic shared memory of one X1 block, as ``lib``'s launcher
    asks for it at ``n_miners`` miners, uniform or per run."""
    return lib.tpusim_xoro_smem_bytes(n_miners, int(per_run))


def bind_xoro(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``xoroshiro.cu``, with its entry points' types set."""
    lib.tpusim_xoro_rows.argtypes = [_vp] * 5 + [_i] * 4 + [_vp] * 3
    lib.tpusim_xoro_rows.restype = _i
    lib.tpusim_cuda_error_string.argtypes = [_i]
    lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
    return lib


if __name__ == "__main__":
    miner_counts = [int(a) for a in sys.argv[1:]] or [9]
    for (name, miners, _), (path, secs, log) in build(
        (n, m, 2) for n in SOURCES for m in miner_counts
        if ("_wide" in n) == (m > NARROW_MAX_MINERS)
    ).items():
        print(f"{name} ({SOURCES[name].name}, M = {miners}): {path.name} built in {secs:.1f} s")
        sys.stdout.write(log)
