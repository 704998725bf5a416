"""Threefry-2x32 in numpy: the per-env keys that JAX derives from a seed.

The engine seeds every env from ``fold_in(PRNGKey(seed), env_index)``
(``tetris_gymnasium_tpu/parallel/mesh.py:47``).  With JAX's default
``threefry2x32`` implementation:

* ``PRNGKey(s)`` for a 32-bit seed ``0 <= s < 2**32`` is ``[0, s]``;
* ``fold_in(k, i)`` is one threefry block ``threefry_2x32(k, [0, i])``.

This module computes the same words in numpy so that the port's envs play
the same games as the JAX package's from the same seed.
"""
from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry_2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """One 20-round Threefry-2x32 block per lane: returns ``(y0, y1)``.

    ``key`` is ``uint32[2]``; ``x0`` and ``x1`` are uint32 arrays of one
    shape (the two counter words).
    """
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, dtype=np.uint32) + ks[0]
    x1 = np.asarray(x1, dtype=np.uint32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3]  # array + scalar: wraps without a warning
        x1 = x1 + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed ``0 <= seed < 2**32``."""
    seed = int(seed)
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return np.array([0, seed], dtype=np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for uint32 ``data`` of any shape:
    returns ``uint32[*data.shape, 2]``."""
    data = np.asarray(data, dtype=np.uint32)
    y0, y1 = threefry_2x32(key, np.zeros_like(data), data)
    return np.stack([y0, y1], axis=-1)
