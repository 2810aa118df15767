#!/usr/bin/env python3
"""Time source variants of the layout micro-benchmark kernels (S1,
tpusim_torch/csrc/micro.cu) on one NVIDIA card, in turns.

Each variant is an edit of micro.cu, built with the port's nvcc flags into
the git-ignored smoke_out/micro_variants/ (one nvcc a variant, all started
together) and run through ``tpusim_torch.micro`` with its library swapped
in, at R = 8,192 lanes and N = 512 iterations: each op's time by
``micro.time_op`` (the least of three launches), the better of two turns
(variants in order, then reversed), beside its bound
(``chip_smoke.micro_ops``), the registers of its kernel and the
instructions its iteration loops issue (``chip_smoke.micro_loop_opcodes``).
Every variant computes the same function and is held against the
checkout's kernel bit for bit.

    python3 scripts/micro_variants.py

Variants: the checkout; repeat's, tile's and segsum's iteration loops
unrolled four times like the others (ptxas sees through the empty-asm guard
and folds or shares their work across the copies); no loop unrolled;
sel3 and sel_flat comparing c2 with the constant 1 (ptxas hoists the
compare); sel3 with one (i, j) pair a thread (81 threads a lane, each
repeating acc[0]'s chain); segsum with 8 threads a lane (2 sums each) and
with one (all 9 rows, the chain its row 0); contract with 1 and with 9 of
its entries a thread. The numbers also go to smoke_out/micro_variants.json.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tpusim_torch import micro  # noqa: E402
from tpusim_torch.csrc import build  # noqa: E402

SOURCE = ROOT / "tpusim_torch" / "csrc" / "micro.cu"
OUT = ROOT / "smoke_out" / "micro_variants"
R, N = 8192, 512


def sub(old: str, new: str, count: int = 1):
    """An edit that replaces the ``count`` occurrences of ``old``."""
    def edit(text: str) -> str:
        if text.count(old) != count:
            raise SystemExit(f"micro_variants: micro.cu no longer holds {count} x {old[:60]!r}")
        return text.replace(old, new)
    return edit


VARIANTS = {
    "checkout": lambda text: text,
    "all_unrolled_4": sub("#pragma unroll 1\n", "#pragma unroll 4\n", 3),
    "none_unrolled": sub("#pragma unroll 4\n", "#pragma unroll 1\n", 4),
    "c2_vs_constant_1": lambda text: sub("as_int(c2[p]) > as_int(one)", "as_int(c2[p]) > 1")(
        sub("as_int(c2) > as_int(one)", "as_int(c2) > 1")(text)),
    "sel3_1_pair": sub("kSel3Pairs = 3,", "kSel3Pairs = 1,"),
    "segsum_8_threads": sub("kSegsumRows = 4,", "kSegsumRows = 1,"),
    "segsum_1_thread": sub("kSegsumRows = 4,", "kSegsumRows = 8,"),
    "contract_1_entry": sub("kContractGroup = 3,", "kContractGroup = 1,"),
    "contract_9_entries": sub("kContractGroup = 3,", "kContractGroup = 9,"),
}


def _build() -> dict[str, tuple[ctypes.CDLL, str, str]]:
    """Every variant's library, its ptxas report and its SASS."""
    procs = {}
    for name, edit in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE.name).write_text(edit(SOURCE.read_text()))
        procs[name] = (d, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / SOURCE.name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"micro_variants: {name} did not build\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.tpusim_micro_launch.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
        lib.tpusim_micro_launch.restype = ctypes.c_int
        lib.tpusim_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpusim_cuda_error_string.restype = ctypes.c_char_p
        sass = subprocess.run([str(cuobjdump), "-sass", str(d / "lib.so")], capture_output=True,
                              text=True, check=True).stdout
        libs[name] = (lib, log, sass)
    return libs


def _turn(lib: ctypes.CDLL, inputs: dict) -> tuple[dict[str, float], dict]:
    """Each op's ms and result with ``lib`` as the micro library."""
    load_micro = build.load_micro
    build.load_micro = lambda: lib
    try:
        ms = {op: min(micro.time_op(op, ins, N)) * 1e3 for op, ins in inputs.items()}
        out = {op: micro.run(op, ins, N) for op, ins in inputs.items()}
    finally:
        build.load_micro = load_micro
    torch.cuda.synchronize()
    return ms, out


def main() -> int:
    if not torch.cuda.is_available():
        print("micro_variants: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {card.strip()}", flush=True)
    libs = _build()
    inputs = {op: micro.make_inputs(op, R, "cuda") for op in micro.OPS}
    best: dict[str, dict[str, float]] = {name: {} for name in VARIANTS}
    want = None
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for name in order:
            ms, out = _turn(libs[name][0], inputs)
            want = out if want is None else want
            for op, got in out.items():
                if not torch.equal(got, want[op]):
                    raise SystemExit(f"micro_variants: {name} {op} differs from the checkout")
            for op, t in ms.items():
                best[name][op] = min(best[name].get(op, t), t)
    rows = {}
    for name, (_, log, sass) in libs.items():
        regs = chip_smoke.micro_ptxas(log, micro.OPS)
        loops = chip_smoke.micro_loop_opcodes(sass, micro.OPS)
        rows[name] = {}
        for op in micro.OPS:
            bound = chip_smoke.micro_ops(op, R, N) / chip_smoke.INT32_OPS_PER_S * 1e3
            rows[name][op] = dict(ms=best[name][op], bound_ms=bound, registers=regs[op][0],
                                  spill_stores=regs[op][1], loop=loops[op])
            print(f"[{name}] {op}: {best[name][op]:.4f} ms, {100 * bound / best[name][op]:.1f} % "
                  f"of its {bound:.4f} ms bound; {regs[op][0]} registers, spill stores "
                  f"{regs[op][1]} B; loops of " + "; ".join(
                      f"{sum(c.values())} instructions {c}" for c in loops[op]), flush=True)
    OUT.parent.mkdir(exist_ok=True)
    (OUT.parent / "micro_variants.json").write_text(json.dumps(
        dict(card=card.strip(), r=R, iters=N, variants=rows), indent=2))
    print(f"[micro_variants] every variant == the checkout, bit for bit, at R = {R}, N = {N}; "
          f"on {card.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
