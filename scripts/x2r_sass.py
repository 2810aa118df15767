#!/usr/bin/env python3
"""What the per-event xoroshiro kernels (X2r) issue, from their SASS, beside
the consumed-row kernels (X2) that do the same event loop on X1's rows, on
one NVIDIA card; with ``--lib``, what any event-loop library issues.

    python3 scripts/x2r_sass.py [--parent DIR] [--time]
    python3 scripts/x2r_sass.py --lib event_loop_fast --lib event_loop_fast_selfish \
        [--parent DIR]
    python3 scripts/x2r_sass.py --read smoke_out/x2r_sass

Builds the default and selfish rosters' libraries (9 miners, K = 2):
``event_loop_fast_xoro`` and ``event_loop_exact_xoro`` (X2r),
``event_loop_fast_consumed`` and ``event_loop_exact_consumed`` (X2), with
the port's nvcc flags into the git-ignored smoke_out/x2r_sass/ (each
library's ``cuobjdump -sass`` kept beside it), and prints for each kernel
instantiation (count type, stale type) its instructions by class: all,
float64 (DADD, DMUL, DFMA, DSETP, the F64 conversions and MUFU.RCP64H),
shuffles (SHFL), the addresses of the first and last float64 instruction,
how many float64 instructions sit inside the kernel's loops (each span from
a backward branch's target to the branch, as chip_smoke.py's ``sass_loops``
finds them), and for those the fewest and most shuffles on every path from
the kernel's entry to them (a shortest path in the graph of its basic
blocks, by their branches, calls and exits, each block weighing its
shuffles). The
float64 map is one inlined copy in every design; a map under the
draw-ahead tile's refill has its 4 G draw shuffles on every path to it,
one run on each find has none.

Each kernel's step loop (the loop that spans the most instructions) is
also counted by class (``STEP_CLASSES``: the integer ALU, IMAD on the FMA
pipe, the collectives, memory, control, moves, the uniform datapath and
the rest), with the fewest and the most instructions on any one pass
through it from its head to its back edge (the basic blocks' weights
summed along the lightest and the heaviest path; the heaviest only where
the loop holds no inner loop): the fewest are what a step that takes no
optional branch issues, in every lane of the warp. ``--lib NAME`` (any
number of times; ``NAME`` a library of ``tpusim_torch/csrc/build.py``,
at 9 miners and K = 2 unless written ``NAME-mM-kK``) counts those
libraries in place of X2r's four, and with ``--parent`` the parent's
builds of them too: so ``--lib event_loop_fast --lib
event_loop_fast_selfish`` gives what the fast kernel's selfish form adds
to a step (K1 against K1s; ``_packed`` for K4f against K4fs).

With ``--parent DIR`` (a ``git archive`` of an earlier commit unpacked in
DIR) that commit's X2r sources are built and counted too. With ``--time``
the checkout's four kernels (and the parent's two X2r ones) are timed on
one busy chunk of each roster (chunk 1, 8,192 runs x 1,856 steps, the
better of two turns of the mean of three calls, CUDA events), and X2r's
time beyond X2's is printed as a share of X2r's: the draw and the map's
share of the kernel, which issue bounds. The numbers also go to
smoke_out/x2r_sass.json (smoke_out/lib_sass.json with ``--lib``).
``--read DIR`` counts the kept ``.sass`` files of an earlier run again,
with no card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

from kernel_variants import ROOT, card, in_turns

import torch  # noqa: E402

from tpusim_torch import event_loop  # noqa: E402
from tpusim_torch.config import SimConfig, default_network, reference_selfish_network  # noqa: E402
from tpusim_torch.csrc import build  # noqa: E402

OUT = ROOT / "smoke_out" / "x2r_sass"
KERNELS = ("event_loop_fast_xoro", "event_loop_exact_xoro", "event_loop_fast_consumed",
           "event_loop_exact_consumed")
FP64_ROOTS = {"DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX"}
#: The step loop's instruction classes, by opcode root (a root that starts
#: with U, the uniform datapath, is "uniform"; any root not named "other").
STEP_CLASSES = {
    "int_alu": {"IADD3", "LOP3", "ISETP", "SEL", "IMNMX", "VIMNMX", "SHF", "LEA", "PRMT",
                "IABS", "FLO", "POPC", "BREV", "PLOP3", "P2R", "R2P", "SGXT", "BMSK", "LOP",
                "IADD", "VIADD", "ISCADD"},
    "imad": {"IMAD"},
    "collective": {"SHFL", "VOTE", "REDUX", "MATCH"},
    "memory": {"LDS", "STS", "LDG", "STG", "LD", "ST", "LDC", "ATOMS", "ATOM", "RED"},
    "control": {"BRA", "BSSY", "BSYNC", "WARPSYNC", "EXIT", "BREAK", "CALL", "RET", "NOP",
                "BAR", "YIELD"},
    "move": {"MOV", "S2R", "CS2R", "MOVM"},
}


def _is_fp64(opcode: str) -> bool:
    root = opcode.split(".")[0]
    return root in FP64_ROOTS or ("64" in opcode and root in {"MUFU", "F2F", "I2F", "F2I",
                                                               "FRND"})


def _lib_key(text: str) -> tuple[str, int, int]:
    """``NAME`` or ``NAME-mM-kK`` as (kernel, miners, group slots)."""
    m = re.fullmatch(r"(\w+?)(?:-m(\d+))?(?:-k(\d+))?", text)
    if m is None or m.group(1) not in build.SOURCES:
        raise SystemExit(f"x2r_sass: no library {text!r} in tpusim_torch/csrc/build.py")
    return m.group(1), int(m.group(2) or 9), int(m.group(3) or 2)


def _start(tree: Path, tag: str, key: tuple[str, int, int]) -> tuple[Path, subprocess.Popen]:
    name, miners, slots = key
    src = tree / "tpusim_torch" / "csrc" / build.SOURCES[name].name
    lib = OUT / (f"{tag}_{name}_m{miners}" + (f"_k{slots}" if slots != 2 else "") + ".so")
    OUT.mkdir(parents=True, exist_ok=True)
    return lib, subprocess.Popen([build.nvcc(), *build._flags(name, miners, slots), "-o",
                                  str(lib), str(src)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(key, lib: Path, proc: subprocess.Popen) -> list[int]:
    log = proc.communicate(timeout=900)[0]
    if proc.returncode:
        raise SystemExit(f"x2r_sass: {key} did not build\n{log}")
    return [int(x) for x in re.findall(r"Used (\d+) registers", log)]


def _loops(ins: list[tuple[int, str]]) -> list[tuple[int, int]]:
    spans = []
    for addr, text in ins:
        m = re.search(r"BRA\b.*0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    return spans


def _blocks(ins: list[tuple[int, str]]) -> tuple[list[list[int]], dict[int, list[int]]]:
    """The function's basic blocks (each a list of instruction indices) and
    each block's successors, from its branches, calls, returns and exits."""
    nxt = {i: i + 1 for i in range(len(ins) - 1)}
    at = {a: i for i, (a, _) in enumerate(ins)}
    leaders, jumps = {0}, {}
    for i, (_, text) in enumerate(ins):
        body = re.sub(r"^@!?U?P\w+\s+", "", text)
        op = body.split()[0] if body else ""
        cond = body != text or ".DIV" in op
        if op.startswith(("EXIT", "RET", "BPT")):
            jumps[i] = [nxt[i]] if cond and i in nxt else []
        elif op.startswith(("BRA", "CALL")):
            m = re.search(r"0x([0-9a-f]+)", body)
            target = [at[int(m.group(1), 16)]] if m and int(m.group(1), 16) in at else []
            leaders.update(target)
            jumps[i] = target + ([nxt[i]] if (cond or op.startswith("CALL")) and i in nxt else [])
        else:
            continue
        if i in nxt:
            leaders.add(nxt[i])
    starts = sorted(leaders)
    blocks = [list(range(a, b)) for a, b in zip(starts, starts[1:] + [len(ins)])]
    of = {i: k for k, blk in enumerate(blocks) for i in blk}
    succ = {}
    for k, blk in enumerate(blocks):
        last = blk[-1]
        succ[k] = sorted({of[j] for j in jumps[last]}) if last in jumps else (
            [of[last + 1]] if last + 1 < len(ins) else [])
    return blocks, succ


def shuffles_above(ins: list[tuple[int, str]], is_fp64) -> list[int]:
    """For each float64 instruction, the fewest shuffles on any path to it
    from the function's entry (a shortest path over the basic blocks, each
    weighing its shuffles, then those before it in its own block). The
    tile's map sits under the refill's draw (4 G shuffles, and 2 M for the
    thresholds); a map run on each find under none of the draw's."""
    import heapq

    blocks, succ = _blocks(ins)
    shfl = [sum("SHFL" in ins[i][1] for i in blk) for blk in blocks]
    dist = [float("inf")] * len(blocks)
    dist[0] = 0
    heap = [(0, 0)]
    while heap:
        d, k = heapq.heappop(heap)
        if d > dist[k]:
            continue
        for j in succ[k]:
            if d + shfl[k] < dist[j]:
                dist[j] = d + shfl[k]
                heapq.heappush(heap, (dist[j], j))
    out = []
    for k, blk in enumerate(blocks):
        for i in blk:
            op = (re.sub(r"^@!?U?P\w+\s+", "", ins[i][1]).split() or [""])[0]
            if is_fp64(op):
                out.append(dist[k] + sum("SHFL" in ins[j][1] for j in blk if j < i))
    return out


def _class(opcode: str) -> str:
    root = opcode.split(".")[0]
    if root.startswith("U"):
        return "uniform"
    return next((c for c, roots in STEP_CLASSES.items() if root in roots), "other")


def step_loop(raw: list[tuple[int, str]]) -> dict | None:
    """The step loop's instructions by class, and the fewest and most on one
    pass through it (None for a function without a loop)."""
    ins = [(a, re.sub(r"^@!?U?P\w+\s+", "", t)) for a, t in raw]
    loops = _loops(ins)
    if not loops:
        return None
    lo, hi = max(loops, key=lambda span: span[1] - span[0])
    ops = [t.split()[0] for a, t in ins if lo <= a <= hi and t]
    by_class = {c: 0 for c in (*STEP_CLASSES, "uniform", "other")}
    for op in ops:
        by_class[_class(op)] += 1
    blocks, succ = _blocks(raw)
    inside = {k for k, blk in enumerate(blocks) if lo <= raw[blk[0]][0] <= hi}
    head = next(k for k in inside if raw[blocks[k][0]][0] == lo)
    tail = next(k for k in inside if raw[blocks[k][0]][0] <= hi <= raw[blocks[k][-1]][0])
    weight = {k: len(blocks[k]) for k in inside}
    # The pass's edges: inside the loop, none back to its head.
    edges = {k: [j for j in succ[k] if j in inside and j != head] for k in inside}
    fewest = _lightest(head, tail, edges, weight)
    order, seen, cyclic = [], {}, False

    def visit(k: int) -> None:
        nonlocal cyclic
        seen[k] = 1
        for j in edges[k]:
            if seen.get(j) == 1:
                cyclic = True
            elif j not in seen:
                visit(j)
        seen[k] = 2
        order.append(k)

    visit(head)
    most = None if cyclic else _heaviest(head, tail, edges, weight, order[::-1])
    return {"instructions": len(ops), "by_class": by_class, "fewest_per_step": fewest,
            "most_per_step": most}


def _lightest(head: int, tail: int, edges: dict, weight: dict) -> int | None:
    """The least sum of block weights on a path from head to tail (None if
    there is none): Dijkstra's."""
    import heapq

    best, heap = {head: weight[head]}, [(weight[head], head)]
    while heap:
        d, k = heapq.heappop(heap)
        if k == tail:
            return d
        if d > best[k]:
            continue
        for j in edges[k]:
            if d + weight[j] < best.get(j, float("inf")):
                best[j] = d + weight[j]
                heapq.heappush(heap, (best[j], j))
    return None


def _heaviest(head: int, tail: int, edges: dict, weight: dict, order: list[int]) -> int | None:
    """The greatest sum of block weights on a path from head to tail, over
    the blocks' topological ``order`` (the edges hold no cycle)."""
    best = {head: weight[head]}
    for k in order:
        if k in best:
            for j in edges[k]:
                best[j] = max(best.get(j, 0), best[k] + weight[j])
    return best.get(tail)


def count(lib: Path) -> list[dict]:
    """Each kernel function's instructions by class, its SASS kept beside
    the library."""
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    lib.with_suffix(".sass").write_text(sass)
    return count_text(sass)


def count_text(sass: str) -> list[dict]:
    """Each kernel function's instructions by class, from ``cuobjdump -sass``."""
    out = []
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.splitlines()[0].strip()
        if "event_loop" not in name or "kernel" not in name:
            continue
        raw = [(int(a, 16), t.strip())
               for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        ins = [(a, re.sub(r"^@!?U?P\w+\s+", "", t)) for a, t in raw]
        ops = [(a, t.split()[0]) for a, t in ins if t]
        fp = [a for a, op in ops if _is_fp64(op)]
        loops = _loops(ins)
        in_loops = [any(lo <= a <= hi for lo, hi in loops) for a in fp]
        above = [n for n, inside in zip(shuffles_above(raw, _is_fp64), in_loops) if inside]
        out.append({
            "function": re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", name)[-60:],
            "instructions": len(ops),
            "fp64": len(fp),
            "shfl": sum(op.startswith("SHFL") for _, op in ops),
            "fp64_span": [hex(fp[0]), hex(fp[-1])] if fp else None,
            "loops": len(loops),
            "fp64_in_loops": sum(in_loops),
            "fp64_in_loops_shfl_above": [min(above), max(above)] if above else None,
            "step_loop": step_loop(raw),
        })
    return out


def _cases() -> dict[str, SimConfig]:
    return {"default": SimConfig(network=default_network(), rng="xoroshiro"),
            "selfish": SimConfig(network=reference_selfish_network(), rng="xoroshiro")}


def time_chunks(libs: dict[tuple[str, str], Path]) -> dict[str, dict[str, float]]:
    """Each roster's busy chunk by X2 and by each X2r library, in turns."""
    import ctypes
    import dataclasses

    from kernel_variants import _bind_event_loop, _busy_chunk, _outputs

    times = {}
    for roster, cfg in _cases().items():
        mode = "fast" if roster == "default" else "exact"
        row = {}
        for form, rng_batch in (("X2", True), ("X2r", False)):
            args, kw = _busy_chunk(dataclasses.replace(cfg, rng_batch=rng_batch))
            kernel = f"event_loop_{mode}_{'consumed' if rng_batch else 'xoro'}"
            mine = {tag: _bind_event_loop(kernel)(ctypes.CDLL(str(path)))
                    for (tag, name), path in libs.items() if name == kernel}

            def call(args=args, kw=kw) -> tuple:
                return _outputs(event_loop.event_loop_chunk(*args, **kw))

            exact = set(mine) if form == "X2r" else {"checkout"}
            got = in_turns("x2r_sass", roster, mine, "load_library", call,
                           _reference(call, mine), exact, reps=3)
            row.update({f"{form} {tag}": ms for tag, ms in got.items()})
        times[roster] = row
        print(f"[time] {roster}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items())
              + f"; X2r beyond X2: {1 - row['X2 checkout'] / row['X2r checkout']:.1%} of X2r",
              flush=True)
    return times


def _reference(call, mine: dict) -> tuple:
    """The checkout's outputs, which every X2r tree must give."""
    real = build.load_library
    build.load_library = lambda *_: mine["checkout"]
    try:
        return call()
    finally:
        build.load_library = real


def _print(what: str, f: dict) -> None:
    print(f"[sass] {what} {f['function']}: {f['instructions']} instructions, {f['fp64']} "
          f"float64 ({f['fp64_in_loops']} inside loops, at {f['fp64_span']}, each with "
          f"{f['fp64_in_loops_shfl_above']} shuffles on every path to it), {f['shfl']} SHFL, "
          f"{f['loops']} loops", flush=True)
    step = f["step_loop"]
    if step:
        print(f"[step] {what} {f['function']}: {step['instructions']} instructions in the step "
              f"loop ({', '.join(f'{c} {n}' for c, n in step['by_class'].items())}); "
              f"{step['fewest_per_step']} on the lightest pass, {step['most_per_step']} on the "
              "heaviest", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description="X2r's SASS by instruction class.")
    ap.add_argument("--parent", type=Path, help="an earlier checkout to count beside this one")
    ap.add_argument("--time", action="store_true", help="time the busy chunks too")
    ap.add_argument("--read", type=Path, help="count the .sass files of an earlier run in "
                    "this directory instead, with no card")
    ap.add_argument("--lib", action="append", default=[], type=_lib_key,
                    help="count this library (NAME or NAME-mM-kK) in place of X2r's four")
    args = ap.parse_args()
    if args.lib and args.time:
        raise SystemExit("x2r_sass: --time times X2r's four libraries, not --lib ones")
    if args.read:
        for path in sorted(args.read.glob("*.sass")):
            for f in count_text(path.read_text()):
                _print(path.stem, f)
        return
    if not torch.cuda.is_available():
        raise SystemExit("x2r_sass: needs a CUDA device")
    name = card()
    trees = {"checkout": ROOT, **({"parent": args.parent} if args.parent else {})}
    record: dict = {"card": name, "sass": {}}
    keys = args.lib or [(kernel, 9, 2) for kernel in KERNELS]
    started = {(tag, key): _start(tree, tag, key) for tag, tree in trees.items()
               for key in keys if tag == "checkout" or args.lib or "_xoro" in key[0]}
    libs = {}
    for (tag, key), (path, proc) in started.items():
        regs = _finish((tag, key), path, proc)
        what = f"{tag} {key[0]}" + (f"-m{key[1]}-k{key[2]}" if args.lib else "")
        libs[tag, key[0]] = path
        funcs = count(path)
        record["sass"][what] = {"registers": regs, "functions": funcs}
        for f in funcs:
            _print(what, f)
        print(f"[sass] {what}: registers {regs}", flush=True)
    if args.time:
        record["time_ms"] = time_chunks(libs)
    (ROOT / "smoke_out" / ("lib_sass.json" if args.lib else "x2r_sass.json")).write_text(
        json.dumps(record, indent=1))
    print(json.dumps({"x2r_sass": "ok", "card": name}))


if __name__ == "__main__":
    main()
