"""Counter-based per-env RNG, plain PyTorch version.

Port of ``tetris_gymnasium_tpu/ops/rng.py:48-114``.  The per-env state is a
pair ``(counter, stream)`` of 32-bit words advanced as one 64-bit Weyl
sequence, whitened by the murmur3 finalizer.  The same arithmetic runs as
device functions inside the ``turbo_step`` CUDA kernel
(``csrc/turbo_step.cu``); these functions are its plain twin.

PyTorch has no usable ``uint32`` arithmetic on the CPU, so every function
here works on **int64 lanes holding 32-bit values** (``0 <= v < 2**32``):
additions and shifts are masked back to 32 bits, and multiplies are split
into 16-bit halves so that no product leaves the int64 range.  Keys are
``[2, *batch]`` with the batch minor, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9  # Weyl increment (2**32 / phi)
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35


def mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` for int64 lanes ``x < 2**32`` and a constant ``m``."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finalizer."""
    x = x ^ (x >> 16)
    x = mul32(x, M1)
    x = x ^ (x >> 13)
    x = mul32(x, M2)
    x = x ^ (x >> 16)
    return x


def next_bits(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance ``key [2, *batch]`` and emit one whitened 32-bit word."""
    c0 = (key[0] + GOLDEN) & MASK32
    carry = (c0 < key[0]).to(key.dtype)
    c1 = (key[1] + carry) & MASK32
    out = fmix32(c0 ^ fmix32(c1))
    return torch.stack([c0, c1]), out


def randint(key: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform int in ``[0, n)`` by multiply-shift on the top 16 bits."""
    key, bits = next_bits(key)
    hi = bits >> 16
    return key, ((hi * n) >> 16).to(torch.int32)


def shuffle(key: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fisher–Yates permutation of ``arange(n)``: ``int32[n, *batch]``.

    The same draw order as the JAX version (``i = n-1 .. 1``, one
    ``randint(i + 1)`` each), so per-env permutations are bit-equal.
    """
    batch = key.shape[1:]
    idx = torch.arange(n, dtype=torch.int32, device=key.device).reshape((n,) + (1,) * len(batch))
    perm = idx.expand((n,) + tuple(batch)).clone()
    for i in range(n - 1, 0, -1):
        key, j = randint(key, i + 1)
        vi = perm[i].clone()
        oh_j = idx == j
        vj = torch.where(oh_j, perm, 0).sum(dim=0, dtype=torch.int32)
        perm = torch.where(oh_j, vi, perm)
        perm[i] = vj
    return key, perm
