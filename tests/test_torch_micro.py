"""The layout micro-benchmarks (S1, ``tpusim_torch.micro``) against the
reference's on the CPU: each op's plain version, ``iters`` chained
iterations from a zero accumulator, against the same jnp body run through
``pl.pallas_call(..., interpret=True)`` as ``scripts/mosaic_micro.py``
builds it (its bodies are nested in ``main()`` and cannot be imported, and
running the script writes into ``artifacts/``, so the bodies are copied
here from :161-211). Equal bit for bit (tolerance 0), the int32
wrap-around of ``segsum`` included; then the command line on the CPU."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpusim_torch import micro

M, R, ITERS = 9, 128, 24


def _reference_bodies(R: int = R):
    """scripts/mosaic_micro.py's op bodies, verbatim but for the names, at
    ``R`` lanes."""
    def sel3(cp, c1, c2, val, acc):
        x = jnp.where((c1 + acc[:1, :1, :1, :]) > 1, val[None, None, :, :],
                      jnp.where(c2 > 1, cp, acc))
        return x + cp

    def sel_flat(cp, c1, c2, val, acc):
        x = jnp.where((c1 + acc[:1, :]) > 1, val, jnp.where(c2 > 1, cp, acc))
        return x + cp

    def reshape(x, acc):
        flat = jnp.reshape(x + acc, (M * M, R))
        return jnp.reshape(flat + 1, (M, M, R))

    def repeat(src, acc):
        return jnp.reshape(
            jnp.broadcast_to((src + acc[:M, :])[:, None, :], (M, M, R)), (M * M, R))

    def tile(src, acc):
        return jnp.reshape(
            jnp.broadcast_to((src + acc[:M, :])[None, :, :], (M, M, R)), (M * M, R))

    def segsum(x, acc):
        return jnp.sum(jnp.reshape(x + acc[:1, :], (M, M, R)), axis=1)

    def contract(cp, b, acc):
        return jnp.sum(cp * b, axis=0) + acc

    return dict(sel3=sel3, sel_flat=sel_flat, reshape=reshape, repeat=repeat, tile=tile,
                segsum=segsum, contract=contract)


def _reference(op: str, arrays: list[np.ndarray], iters: int) -> np.ndarray:
    """The reference's kernel (bench.make_kernel) in interpret mode."""
    r = arrays[0].shape[-1]
    body = _reference_bodies(r)[op]

    def kernel(*refs):
        *ins, out = refs
        vals = [r[...] for r in ins]
        out[...] = jax.lax.fori_loop(0, iters, lambda i, acc: body(*vals, acc),
                                     jnp.zeros_like(out[...]))

    shape = micro.OPS[op][1] + (r,)
    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
                          interpret=True)
    return np.asarray(call(*[jnp.asarray(a) for a in arrays]))


@pytest.mark.parametrize("op", list(micro.OPS))
def test_plain_version_equals_the_reference(op):
    inputs = micro.make_inputs(op, R)
    # The reference's draws: one default_rng(0) per op, integers in [0, 3).
    rng = np.random.default_rng(0)
    want_in = [rng.integers(0, 3, size=s + (R,), dtype=np.int32) for s in micro.OPS[op][0]]
    for got, want in zip(inputs, want_in):
        np.testing.assert_array_equal(got.numpy(), want)
    got = micro.run(op, inputs, ITERS)  # CPU tensors: the plain version
    want = _reference(op, want_in, ITERS)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if op == "segsum":
        assert (np.abs(want.astype(np.int64)) > 2**20).any()  # the sums wrapped


def _read_set(op: str, entry: tuple[int, ...]) -> list[np.ndarray]:
    """Masks over each input of ``op`` (lanes axis left out) of what
    accumulator entry ``entry`` reads, in its own lane, over any number of
    iterations: its own inputs and those of acc[0]'s chain (entry 0 reads
    only itself), the decomposition csrc/micro.cu's threads rely on."""
    masks = [np.zeros(shape, dtype=bool) for shape in micro.OPS[op][0]]
    if op == "sel3":
        i, j, o = entry
        for (a, b, c) in ((i, j, o), (0, 0, 0)):
            masks[0][a, b, c] = masks[1][a, b, 0] = masks[2][a, b, 0] = masks[3][c] = True
    elif op == "sel_flat":
        for mask in masks:
            mask[entry[0]] = mask[0] = True
    elif op == "reshape":
        masks[0][entry] = True
    elif op == "repeat":
        masks[0][entry[0] // M] = masks[0][0] = True
    elif op == "tile":
        masks[0][entry[0] % M] = True
    elif op == "segsum":
        masks[0][entry[0] * M:(entry[0] + 1) * M] = masks[0][:M] = True
    else:  # contract
        masks[0][:, entry[0], entry[1]] = masks[1][:] = True
    return masks


@pytest.mark.parametrize("op", list(micro.OPS))
def test_an_entry_reads_only_its_read_set(op):
    """Lane s of 16 holds a sampled accumulator entry e_s (entry 0 and the
    last among them). Every input outside e_s's read set in lane s, and
    every input of the other lanes outside theirs, is redrawn to another
    value; after 8 iterations e_s is unchanged, in the plain version and in
    the reference's kernel, while the accumulator as a whole changes."""
    r, iters = 16, 8
    acc_shape = micro.OPS[op][1]
    rng = np.random.default_rng(1)
    n = int(np.prod(acc_shape))
    flat = np.concatenate([[0, n - 1], rng.integers(0, n, r - 2)])
    entries = [tuple(int(i) for i in np.unravel_index(k, acc_shape)) for k in flat]
    base = [x.numpy() for x in micro.make_inputs(op, r)]
    redrawn = [(x + rng.integers(1, 3, size=x.shape, dtype=np.int32)) % 3 for x in base]
    for lane, entry in enumerate(entries):
        for x, y, mask in zip(base, redrawn, _read_set(op, entry)):
            y[mask, lane] = x[mask, lane]
    for run in (lambda xs: micro.run_plain(op, [torch.from_numpy(x) for x in xs], iters).numpy(),
                lambda xs: _reference(op, xs, iters)):
        got_base, got_redrawn = run(base), run(redrawn)
        assert (got_base != got_redrawn).any()
        for lane, entry in enumerate(entries):
            assert got_base[entry + (lane,)] == got_redrawn[entry + (lane,)], (entry, lane)


def test_main_prints_one_row_an_op(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    assert micro.main(["--device", "cpu", "--r", "16", "--iters", "8", "--out", str(out)]) == 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed[0]["device"] == "cpu" and printed[0]["r"] == 16
    assert [row["name"] for row in printed[1:]] == list(micro.ROW_NAMES.values())
    for row in printed[1:]:
        assert row["us_per_iter"] > 0 and len(row["repeats_s"]) == 3
        assert row["floor_limited"] == (row["scaling_ratio_8x"] < 4.0)
    assert [json.loads(line) for line in out.read_text().splitlines()] == printed


def test_run_refuses_wrong_inputs():
    inputs = micro.make_inputs("contract", R)
    with pytest.raises(ValueError, match="takes 2 inputs"):
        micro.run("contract", inputs[:1], 1)
    with pytest.raises(ValueError, match="expected contiguous int32"):
        micro.run("contract", [inputs[0].long(), inputs[1]], 1)
