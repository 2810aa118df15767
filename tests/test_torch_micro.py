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


def _reference_bodies():
    """scripts/mosaic_micro.py's op bodies, verbatim but for the names."""
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
    body = _reference_bodies()[op]

    def kernel(*refs):
        *ins, out = refs
        vals = [r[...] for r in ins]
        out[...] = jax.lax.fori_loop(0, iters, lambda i, acc: body(*vals, acc),
                                     jnp.zeros_like(out[...]))

    shape = micro.OPS[op][1] + (R,)
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
