"""The JAX package's random stream, in numpy on the host.

The bandit's key is a (2,) uint32 array, as a raw ``jax.random.PRNGKey``
is.  These functions reproduce, bit for bit, the ``jax.random`` calls the
JAX package's policies make on it, in the partitionable Threefry form
(``jax_threefry_partitionable``, the default since jax 0.5):

  * ``split(key, n)``: Threefry-2x32 of the counters (0, i), i < n — the
    two output words are the new key;
  * ``uniform(key)``: one float32 in [0, 1) — the 32 bits are ``x0 ^ x1``
    of the counter (0, 0); the top 23 become the mantissa of a float in
    [1, 2), less 1;
  * ``choice(key, n, p)``: ``jax.random.choice(key, n, p=p)`` with
    replacement — float32 cumulative sum, ``r = c[-1] * (1 - u)``, the
    first index whose sum reaches ``r`` (``searchsorted``, side left).

The stream costs a few microseconds a call, and a decision draws a few
times, so it stays on the host: the card never waits on it.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple:
    """Threefry-2x32 with 20 rounds of the counters (x0, x1) under
    ``key``; uint32 in, uint32 out, elementwise over the counters."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: (n, 2) uint32 keys."""
    zeros = np.zeros(n, np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, zeros, np.arange(n, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def uniform(key: np.ndarray) -> np.float32:
    """``jax.random.uniform(key)``: one float32 in [0, 1)."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, np.zeros(1, np.uint32),
                              np.zeros(1, np.uint32))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32)[0] - np.float32(1.0)


def choice(key: np.ndarray, n: int, p: np.ndarray) -> int:
    """``jax.random.choice(key, n, p=p)`` for a float32 ``p`` of length
    ``n``: one index, drawn with replacement."""
    p = np.asarray(p, np.float32)
    if p.shape != (n,):
        raise ValueError(f"p has shape {p.shape}, expected ({n},)")
    c = np.cumsum(p, dtype=np.float32)
    r = c[-1] * (np.float32(1.0) - uniform(key))
    return int(np.searchsorted(c, r, side="left"))
