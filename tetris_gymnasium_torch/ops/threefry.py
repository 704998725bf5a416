"""Threefry-2x32 and the ``jax.random`` draws built on it, bit-equal to JAX.

The engine seeds every env from ``fold_in(PRNGKey(seed), env_index)``
(``tetris_gymnasium_tpu/parallel/mesh.py:47``), and PPO draws its actions
and minibatch shuffles from ``jax.random`` (``tetris_gymnasium_tpu/rl/
ppo.py:132-133, :184-186, :262-263``).  With JAX's default ``threefry2x32``
implementation and ``jax_threefry_partitionable = True``:

* ``PRNGKey(s)`` for a 32-bit seed ``0 <= s < 2**32`` is ``[0, s]``;
* ``fold_in(k, i)`` is one threefry block ``threefry_2x32(k, [0, i])``;
* ``split(k, n)`` is block ``i`` of ``threefry_2x32(k, [0, i])`` for
  ``i < n``, the same words as ``fold_in(k, i)``;
* ``random_bits(k, 32, shape)`` is ``y0 ^ y1`` of ``threefry_2x32(k, [0, i])``
  over the row-major flat index ``i``;
* ``uniform`` puts the top 23 bits into the mantissa of a float in
  ``[1, 2)``, subtracts 1, scales to ``[minval, maxval)`` and clamps at
  ``minval``; ``gumbel`` (mode ``"low"``) is ``-log(-log(uniform(tiny, 1)))``;
* ``permutation(k, n)`` sorts ``arange(n)`` stably by fresh 32-bit keys,
  ``ceil(3 ln n / ln(2**32 - 1))`` rounds, splitting the key each round;
* ``randint(k, (n,), 0, maxval)`` (int32) splits ``k`` in two, draws 32
  bits ``hi`` from the first half and ``lo`` from the second, and returns
  ``(hi % span * m + lo % span) % span`` in wrapping uint32 arithmetic,
  with ``span = maxval`` (1 when ``maxval <= 0``) and
  ``m = (2**16 % span)**2 % span``, the square wrapping in uint32 too.

Host functions work on numpy ``uint32``; the ``*_lanes`` functions are their
PyTorch twins on int64 lanes holding 32-bit values (PyTorch has no
``uint32`` arithmetic on the CPU), for tensors on any device, with one
host key; the ``*_keyed`` functions take a key per lane instead, int64
lanes ``[..., 2]``, as the compat engine's per-env streams need.
"""
from __future__ import annotations

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MASK32 = 0xFFFFFFFF
TINY = float(np.finfo(np.float32).tiny)  # gumbel's lower bound, a float32 value


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry_2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """One 20-round Threefry-2x32 block per lane: returns ``(y0, y1)``.

    ``key`` is ``uint32[2]``; ``x0`` and ``x1`` are uint32 arrays of one
    shape (the two counter words).
    """
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    with np.errstate(over="ignore"):  # uint32 adds wrap, as intended
        x0 = np.asarray(x0, dtype=np.uint32) + ks[0]
        x1 = np.asarray(x1, dtype=np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r)
                x1 = x1 ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3]
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


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: ``uint32[n, 2]``."""
    return fold_in(key, np.arange(n, dtype=np.uint32))


def random_bits32(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,), uint32)``: ``uint32[n]``."""
    y0, y1 = threefry_2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return y0 ^ y1


def bits_to_uniform(bits: np.ndarray, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """JAX's float32 mapping of 32 random bits into ``[minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    return np.maximum(lo, f * (hi - lo) + lo)


def uniform(key: np.ndarray, n: int, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``."""
    return bits_to_uniform(random_bits32(key, n), minval, maxval)


def gumbel(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.gumbel(key, (n,), float32)`` (mode ``"low"``)."""
    return -np.log(-np.log(uniform(key, n, TINY, 1.0)))


def shuffle_rounds(n: int) -> int:
    """Sort rounds of ``jax.random.permutation`` over ``n`` items (2 once n > 1625)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: ``int64[n]``."""
    x = np.arange(n, dtype=np.int64)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        x = x[np.argsort(random_bits32(sub, n), kind="stable")]
    return x


def randint_span(maxval: int):
    """``(span, multiplier)`` of ``randint(.., 0, maxval)`` for an int32 ``maxval``."""
    span = int(maxval) if int(maxval) > 0 else 1
    m = (2**16 % span) ** 2 % 2**32 % span  # the square wraps in uint32, as in JAX
    return span, m


def randint(key: np.ndarray, n: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), 0, maxval)`` (int32): ``int32[n]``."""
    span, m = randint_span(maxval)
    k_hi, k_lo = split(key)
    hi, lo = random_bits32(k_hi, n), random_bits32(k_lo, n)
    span32, m32 = np.uint32(span), np.uint32(m)
    with np.errstate(over="ignore"):  # uint32 products and sums wrap, as in JAX
        off = (hi % span32) * m32 + lo % span32
    return (off % span32).astype(np.int32)


# ---------------------------------------------------------------------------
# PyTorch twins on int64 lanes
# ---------------------------------------------------------------------------


def _rotl_lanes(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK32) | (x >> (32 - r))


def _threefry_lanes(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """The rounds of :func:`threefry_2x32` on int64 lanes; the key words
    ``k0`` and ``k1`` are ints or int64 lanes that broadcast with ``x0``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl_lanes(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def threefry_2x32_lanes(key, x0: torch.Tensor, x1: torch.Tensor):
    """:func:`threefry_2x32` on int64 lanes of 32-bit counter words.

    ``key`` is a host ``uint32[2]``; returns ``(y0, y1)`` as int64 lanes.
    """
    return _threefry_lanes(int(key[0]), int(key[1]), x0, x1)


def random_bits32_lanes(key, counters: torch.Tensor) -> torch.Tensor:
    """``y0 ^ y1`` of block ``[0, counter]`` for int64 ``counters < 2**32``."""
    y0, y1 = threefry_2x32_lanes(key, torch.zeros_like(counters), counters)
    return y0 ^ y1


def bits_to_uniform_lanes(bits: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """:func:`bits_to_uniform` on int64 lanes: float32 of ``bits``' shape."""
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * scale + lo, lo)


def uniform_lanes(key, n: int, device, start: int = 0) -> torch.Tensor:
    """Elements ``[start, start + n)`` of :func:`uniform` (``[0, 1)``) over
    a larger batch, computed on ``device``: ``float32[n]``."""
    counters = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return bits_to_uniform_lanes(random_bits32_lanes(key, counters))


def gumbel_lanes(key, counters: torch.Tensor) -> torch.Tensor:
    """Gumbel noise (mode ``"low"``) at the flat indices ``counters``."""
    u = bits_to_uniform_lanes(random_bits32_lanes(key, counters), TINY, 1.0)
    return -torch.log(-torch.log(u))


def randint_lanes(key, n: int, maxval: int, device, start: int = 0) -> torch.Tensor:
    """Elements ``[start, start + n)`` of :func:`randint` over a larger
    batch, computed on ``device``: ``int64[n]`` in ``[0, maxval)``.

    The two halves of the key come from the host.  The products stay below
    ``2**62`` (both factors are below ``span <= 2**31``), so int64 lanes
    masked to 32 bits wrap as uint32 does.
    """
    span, m = randint_span(maxval)
    k_hi, k_lo = split(key)
    counters = torch.arange(start, start + n, dtype=torch.int64, device=device)
    hi = random_bits32_lanes(k_hi, counters)
    lo = random_bits32_lanes(k_lo, counters)
    off = ((hi % span) * m + lo % span) & _MASK32
    return off % span


def permutation_lanes(key, n: int, device) -> torch.Tensor:
    """:func:`permutation` computed on ``device``: ``int64[n]``.

    The round keys come from the host; the sort keys and the stable sorts
    run where ``device`` says, so a caller on the card waits for nothing.
    """
    counters = torch.arange(n, dtype=torch.int64, device=device)
    x = counters
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        order = torch.sort(random_bits32_lanes(sub, counters), stable=True).indices
        x = x[order]
    return x


# ---------------------------------------------------------------------------
# A key per lane: int64 lanes [..., 2]
# ---------------------------------------------------------------------------


def _blocks_keyed(keys: torch.Tensor, n: int):
    """``(y0, y1)``, int64 ``[..., n]``: block ``[0, i]`` of each lane's key for ``i < n``."""
    c = torch.arange(n, dtype=torch.int64, device=keys.device)
    return _threefry_lanes(keys[..., :1], keys[..., 1:], torch.zeros_like(c), c)


def split_keyed(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """:func:`split` of every lane's key: ``[..., 2]`` -> ``[..., n, 2]``."""
    y0, y1 = _blocks_keyed(keys, n)
    return torch.stack([y0, y1], dim=-1)


def random_bits32_keyed(keys: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`random_bits32` of every lane's key: ``[..., 2]`` -> ``[..., n]``."""
    y0, y1 = _blocks_keyed(keys, n)
    return y0 ^ y1


def permutation_keyed(keys: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`permutation` of every lane's key: ``[..., 2]`` -> int64 ``[..., n]``."""
    x = torch.arange(n, dtype=torch.int64, device=keys.device).expand(keys.shape[:-1] + (n,))
    for _ in range(shuffle_rounds(n)):
        halves = split_keyed(keys)
        keys, sub = halves[..., 0, :], halves[..., 1, :]
        order = torch.sort(random_bits32_keyed(sub, n), dim=-1, stable=True).indices
        x = x.gather(-1, order)
    return x


def randint_keyed(keys: torch.Tensor, n: int, maxval: int) -> torch.Tensor:
    """:func:`randint` of every lane's key: ``[..., 2]`` -> int64 ``[..., n]``
    in ``[0, maxval)``, wrapping as uint32 does (see :func:`randint_lanes`)."""
    span, m = randint_span(maxval)
    halves = split_keyed(keys)
    hi = random_bits32_keyed(halves[..., 0, :], n)
    lo = random_bits32_keyed(halves[..., 1, :], n)
    off = ((hi % span) * m + lo % span) & _MASK32
    return off % span
