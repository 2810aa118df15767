"""JAX's threefry2x32 counter-based generator, as the reference engine uses it.

The reference draws every run's words with ``jax.random`` under
``jax_threefry_partitionable=True``:

  * ``random.key(seed)`` holds the key words ``[0, seed mod 2^32]``;
  * ``fold_in(key, d)`` is the hash of the counter pair ``(0, d)`` under
    ``key``: its two output words are the new key;
  * ``random.bits(key, shape, uint32)`` hashes the counter pair
    ``(0, i)`` for every row-major flat index ``i`` of ``shape`` and returns
    the XOR of the two output words.

So the words are a pure function of (seed, run index, chunk index, step),
which is what makes every draw independent of batching and execution order.

torch's uint32 support is partial, so words live in int64 tensors holding
values in [0, 2^32): every add is masked back to 32 bits and rotations use
the masked int64 shifts. Keys are runs-first ``(R, 2)`` like the
reference's ``key_data``; the per-chunk block comes out runs-last
``(steps, 2, R)``, the layout the event-loop kernel reads.
"""

from __future__ import annotations

import torch

__all__ = [
    "MASK", "threefry2x32", "key", "fold_in", "bits", "make_run_keys",
    "init_words", "chunk_words", "to_int32",
]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block cipher on broadcastable int64 tensors
    of 32-bit words; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s key words, int64 ``(2,)``."""
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of every key in ``keys`` (..., 2) with ``data``
    (an int, or a tensor broadcastable against ``keys[..., 0]``)."""
    if not torch.is_tensor(data):
        data = torch.tensor(data & MASK, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data & MASK)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)`` for every key of ``keys`` (R, 2),
    runs-last: int64 ``(n, R)``. Flat indices stay below 2^32, so the high
    counter word is 0."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)[:, None]
    y0, y1 = threefry2x32(keys[None, :, 0], keys[None, :, 1], torch.zeros_like(idx), idx)
    return y0 ^ y1


def make_run_keys(seed: int, start: int, count: int, device=None) -> torch.Tensor:
    """Per-run keys ``fold_in(key(seed), i)`` for global run indices
    ``[start, start + count)`` (``tpusim.runner.make_run_keys``): independent
    of batching, so a resumed or re-batched run samples identically."""
    idx = torch.arange(start, start + count, dtype=torch.int64, device=device) & MASK
    return fold_in(key(seed, device)[None, :], idx)


def init_words(keys: torch.Tensor) -> torch.Tensor:
    """The init draw ``bits(fold_in(run_key, 0), (2,))``, runs-last (2, R)."""
    return bits(fold_in(keys, 0), 2)


def chunk_words(keys: torch.Tensor, chunk_idx: int, steps: int) -> torch.Tensor:
    """Chunk ``chunk_idx``'s word block ``bits(fold_in(run_key, 1 + chunk),
    (steps, 2))`` for every run, runs-last int64 ``(steps, 2, R)``: row
    ``[s, 0]`` is step s's winner word, ``[s, 1]`` its interval word."""
    return bits(fold_in(keys, 1 + chunk_idx), 2 * steps).reshape(steps, 2, -1)


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words holding uint32 values -> int32 tensors of the same bit
    patterns (the raw-word kernels read them back as uint32): bit 31 is
    sign-extended by the flip-and-subtract identity, so every value is in
    int32's range before the cast."""
    return (((words & MASK) ^ 0x80000000) - 0x80000000).to(torch.int32)
