"""The port's one-hot variants (``consensus_gather=False``, K5b: every read
indexed by the best chain's owner b is a contraction with the one-hot of
b) against the reference on the CPU, in one process, with the cases of
tests/test_torch_raw_words.py: one chunk of the plain version against the
Pallas kernel with ``consensus_gather=False`` in interpret mode; whole
batches against ``tpusim.engine.Engine``, a wide roster included; a packed
grid against ``tpusim.packed.run_grid``; and the reference's ``LEGACY``
configuration (one-hot reads, un-rebased int32 counts,
tests/test_consensus_gather.py) with the raw words as well: every knob as
it was before the reference added them. Every comparison is bit-equal
(tolerance 0)."""

from __future__ import annotations

import dataclasses

import pytest

from test_torch_raw_words import (
    BATCH_CASES, CHUNK_CASES, _chunk_case, batch_case_config, check_grid, chunk_case_config,
    grid_points, run_both,
)
from tpusim_torch.config import SimConfig, reference_selfish_network
from tpusim_torch.engine import Engine

KNOB = dict(consensus_gather=False)
#: Every knob as before the reference added them: the one-hot reads and the
#: raw words, un-rebased int32 counts.
LEGACY = dict(consensus_gather=False, rng_batch=False, count_rebase=False, state_dtype="int32")


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_bit_equal_to_pallas_interpret(case):
    got, ctr = _chunk_case(chunk_case_config(case, **KNOB))
    if case != "fast-int16":
        assert ctr["stale_events"].sum() > 0


@pytest.mark.parametrize("case", ["honest", "selfish-int16"])
def test_legacy_chunk_bit_equal_to_pallas_interpret(case):
    _chunk_case(dataclasses.replace(chunk_case_config(case), **LEGACY))


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_run_batch_bit_equal(case):
    got = run_both(batch_case_config(case, **KNOB))
    assert got["blocks_found_sum"].sum() > 0


@pytest.mark.parametrize("case", ["default", "selfish"])
def test_legacy_run_batch_bit_equal(case):
    got = run_both(batch_case_config(case, **LEGACY))
    assert got["stale_blocks_sum"].sum() > 0


def test_packed_grid_bit_equal():
    check_grid(grid_points(**KNOB))


def test_legacy_packed_grid_bit_equal():
    check_grid(grid_points(**LEGACY))


def test_engine_selects_the_variants():
    """The knobs reach the event loop as its keyword operands: a sampler
    without ``rng_batch``, ``onehot`` without ``consensus_gather``."""
    base = SimConfig(network=reference_selfish_network())
    for knobs, raw, onehot in ((dict(), False, False), (KNOB, False, True),
                               (dict(rng_batch=False), True, False), (LEGACY, True, True)):
        opts = Engine(dataclasses.replace(base, **knobs), device="cpu").loop_options()
        assert (opts["sampler"] is not None, opts["onehot"]) == (raw, onehot), knobs
