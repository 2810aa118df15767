"""Layout micro-benchmarks (S1): the seven int32 ops of
``scripts/mosaic_micro.py`` as hand-written CUDA kernels
(``csrc/micro.cu``) and as their plain PyTorch versions.

Each op runs ``iters`` chained iterations in one launch, the accumulator of
one iteration feeding the next, on the exact kernel's shapes at M = 9
miners and R lanes: ``sel3`` (the 3-level select on (M, M, M, R)),
``sel_flat`` (the same on (M^3, R) rows), ``reshape`` ((M, M, R) <->
(M^2, R) around two adds), ``repeat`` and ``tile`` ((M, R) -> (M^2, R)),
``segsum`` ((M^2, R) -> (M, R) by 9-row sums) and ``contract`` (the cpb
contraction over the leading axis of (M, M, M, R) with a one-hot-shaped
(M, 1, 1, R) operand). Inputs are int32 in [0, 3) from
``numpy.random.default_rng(0)``, one generator per op, as the reference
draws them. Sums wrap mod 2^32 as the reference's int32 does.

    python -m tpusim_torch.micro                      # on the card, R = 8192
    python -m tpusim_torch.micro --device cpu --r 256 --iters 64

prints one JSON line per op: the time per iteration (``us_per_iter``, from
``iters`` iterations, the least of three launches), the ratio of that time
to the time at ``iters // 8`` (``scaling_ratio_8x``: about 8 when the
iterations' work, not the launch, sets the time) and ``floor_limited``
(ratio below 4), as the reference reports them. ``--out`` appends the rows
to a file the caller names. On the CPU the rows time the plain versions.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

__all__ = ["OPS", "ROW_NAMES", "M", "make_inputs", "run", "run_plain", "launches", "main"]

#: Miners: the shapes are the exact kernel's at the reference's roster.
M = 9

#: Op name -> (input shapes, accumulator shape), each without the lanes
#: axis, in the reference's argument order; the index is the kernel's op
#: number.
OPS: dict[str, tuple[list[tuple[int, ...]], tuple[int, ...]]] = {
    "sel3": ([(M, M, M), (M, M, 1), (M, M, 1), (M,)], (M, M, M)),
    "sel_flat": ([(M**3,)] * 4, (M**3,)),
    "reshape": ([(M, M)], (M, M)),
    "repeat": ([(M,)], (M * M,)),
    "tile": ([(M,)], (M * M,)),
    "segsum": ([(M * M,)], (M,)),
    "contract": ([(M, M, M), (M, 1, 1)], (M, M)),
}
#: The reference's row names (scripts/mosaic_micro.py).
ROW_NAMES = {
    "sel3": "sel3_status_quo", "sel_flat": "sel_flat_prebuilt",
    "reshape": "reshape_roundtrip_9x9", "repeat": "expand_repeat", "tile": "expand_tile",
    "segsum": "segsum_reshape", "contract": "contract_cpb",
}

#: The device-side wait ahead of each timed launch, in clock cycles (about
#: 1 ms at 2 GHz): longer than the host takes to dispatch the call.
_DISPATCH_WAIT_CYCLES = 2_000_000

#: Kernel launches so far, by op; the wrapper adds one per launch.
launches = dict.fromkeys(OPS, 0)


def make_inputs(op: str, r: int, device=None) -> list[torch.Tensor]:
    """The op's inputs at ``r`` lanes, runs-last int32, as the reference
    draws them: a fresh ``default_rng(0)``, integers in [0, 3)."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(0, 3, size=s + (r,), dtype=np.int32)).to(device)
            for s in OPS[op][0]]


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 values with the same low 32 bits, kept in
    int64 (the reference's int32 wrap-around)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _bodies(r: int) -> dict[str, Callable]:
    """One iteration of each op on int64 tensors (the reference's jnp
    bodies, scripts/mosaic_micro.py:161-211)."""
    where = torch.where

    def sel3(cp, c1, c2, val, acc):
        x = where(_wrap(c1 + acc[:1, :1, :1]) > 1, val[None, None], where(c2 > 1, cp, acc))
        return x + cp

    def sel_flat(cp, c1, c2, val, acc):
        x = where(_wrap(c1 + acc[:1]) > 1, val, where(c2 > 1, cp, acc))
        return x + cp

    def reshape(x, acc):
        flat = torch.reshape(x + acc, (M * M, r))
        return torch.reshape(flat + 1, (M, M, r))

    def repeat(src, acc):
        return torch.broadcast_to((src + acc[:M])[:, None], (M, M, r)).reshape(M * M, r)

    def tile(src, acc):
        return torch.broadcast_to((src + acc[:M])[None], (M, M, r)).reshape(M * M, r)

    def segsum(x, acc):
        return torch.reshape(x + acc[:1], (M, M, r)).sum(1)

    def contract(cp, b, acc):
        return (cp * b).sum(0) + acc

    return dict(sel3=sel3, sel_flat=sel_flat, reshape=reshape, repeat=repeat, tile=tile,
                segsum=segsum, contract=contract)


def run_plain(op: str, inputs: list[torch.Tensor], iters: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`run`: ``iters`` iterations of the
    op from a zero accumulator, in int64 wrapped to int32 every iteration."""
    r = inputs[0].shape[-1]
    body = _bodies(r)[op]
    xs = [x.long() for x in inputs]
    acc = torch.zeros(OPS[op][1] + (r,), dtype=torch.int64, device=inputs[0].device)
    for _ in range(iters):
        acc = _wrap(body(*xs, acc))
    return acc.to(torch.int32)


def run(op: str, inputs: list[torch.Tensor], iters: int) -> torch.Tensor:
    """``iters`` chained iterations of ``op`` from a zero accumulator, in one
    launch of its kernel for CUDA tensors; the plain version only for
    tensors on the CPU. Returns the int32 accumulator, runs-last."""
    shapes, acc_shape = OPS[op]
    if len(inputs) != len(shapes):
        raise ValueError(f"{op} takes {len(shapes)} inputs, got {len(inputs)}")
    r = inputs[0].shape[-1]
    devices = {x.device for x in inputs}
    if len(devices) != 1:
        raise ValueError(f"{op}: tensors on several devices {sorted(map(str, devices))}")
    for x, s in zip(inputs, shapes):
        if tuple(x.shape) != s + (r,) or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{op}: input of shape {tuple(x.shape)}, {x.dtype}; expected "
                             f"contiguous int32 {s + (r,)}")
    device = devices.pop()
    if device.type == "cpu":
        return run_plain(op, inputs, iters)
    if device.type != "cuda":
        raise ValueError(f"tpusim_torch.micro runs on CUDA or the CPU, not {device}")
    from .csrc.build import load_micro

    out = torch.empty(acc_shape + (r,), dtype=torch.int32, device=device)
    ins = (ctypes.c_void_p * len(inputs))(*[x.data_ptr() for x in inputs])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = load_micro()
        err = lib.tpusim_micro_launch(list(OPS).index(op), ins, out.data_ptr(), iters, r, stream)
    if err:
        raise RuntimeError(f"{op} kernel launch failed: "
                           f"{lib.tpusim_cuda_error_string(err).decode()}")
    launches[op] += 1
    return out


def time_op(op: str, inputs: list[torch.Tensor], iters: int, repeats: int = 3) -> list[float]:
    """Seconds of ``repeats`` calls of :func:`run` after one warm-up call: by
    CUDA events on the card, by the host clock on the CPU. On the card each
    timed launch is queued behind a short wait on the device
    (``torch.cuda._sleep``), so the host's dispatch of the call (tens of µs
    of Python and ctypes) falls inside the wait and the events hold the
    launch alone."""
    cuda = inputs[0].is_cuda
    run(op, inputs, iters)
    if cuda:
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  for _ in range(repeats)]
        for start, end in events:
            torch.cuda._sleep(_DISPATCH_WAIT_CYCLES)
            start.record()
            run(op, inputs, iters)
            end.record()
        torch.cuda.synchronize()
        return [start.elapsed_time(end) / 1e3 for start, end in events]
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(op, inputs, iters)
        times.append(time.perf_counter() - t0)
    return times


def bench(op: str, r: int, iters: int, device) -> dict:
    """One row: the op at ``iters`` and ``iters // 8`` iterations."""
    inputs = make_inputs(op, r, device)
    times = time_op(op, inputs, iters)
    small = min(time_op(op, inputs, max(1, iters // 8)))
    best = min(times)
    ratio = best / small if small > 0 else float("inf")
    return {"name": ROW_NAMES[op], "us_per_iter": best / iters * 1e6,
            "repeats_s": times, "scaling_ratio_8x": ratio, "floor_limited": bool(ratio < 4.0)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="tpusim_torch.micro", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--r", type=int, default=8192, help="lanes (runs)")
    ap.add_argument("--iters", type=int, default=512, help="op iterations per launch")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", type=Path, default=None,
                    help="append the rows to this JSON-lines file")
    args = ap.parse_args(argv)
    from .engine import resolve_device

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rows = [{"date": time.strftime("%Y-%m-%d"), "device": name, "r": args.r,
             "iters": args.iters}]
    print(json.dumps(rows[0]), flush=True)
    for op in OPS:
        rows.append(bench(op, args.r, args.iters, device))
        print(json.dumps(rows[-1]), flush=True)
    if args.out is not None:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(row) + "\n" for row in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
