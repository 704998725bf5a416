"""Bit-packed board constants: row masks and the turbo packed piece table.

Port of the host-constant half of ``tetris_gymnasium_tpu/ops/bitboard.py``
(``row_bits_table :47``, ``side_mask :185``, ``play_mask :191``,
``empty_rows :246``) and of the turbo engine's ``_tables_for``
(``core/turbo.py:114``).  Each padded board row is one 32-bit mask, bit
``w`` = column ``w`` occupied.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tetris_gymnasium_torch.pieces import PIECES, PieceSet


def row_bits_table(pieces: PieceSet = PIECES) -> np.ndarray:
    """Per-(piece, rotation) row bitmasks ``uint32[n, 4, S]``.

    ``table[p, r, i]`` has bit ``j`` set iff ``matrices[p, r, i, j]`` is
    filled.
    """
    mats = np.asarray(pieces.matrices) > 0  # [n, 4, S, S]
    weights = (1 << np.arange(mats.shape[-1], dtype=np.uint32))[None, None, None, :]
    return np.sum(mats * weights, axis=-1).astype(np.uint32)


def side_mask(width: int, padding: int) -> int:
    """Bits of the left/right bedrock columns of a padded row."""
    lo = (1 << padding) - 1
    return lo | (lo << (padding + width))


def play_mask(width: int, padding: int) -> int:
    """Bits of the playfield columns of a padded row."""
    return ((1 << width) - 1) << padding


def empty_rows(height: int, width: int, padding: int) -> np.ndarray:
    """Packed rows ``uint32[height + padding]`` of an empty padded board."""
    side = side_mask(width, padding)
    full = (1 << (width + 2 * padding)) - 1
    rows = np.full((height + padding,), side, dtype=np.uint32)
    rows[height:] = full
    return rows


class Tables(NamedTuple):
    """Turbo engine constant tables."""

    packed: np.ndarray  # uint32[n*4]: row s of (piece, rotation) in bits [s*S, (s+1)*S)
    box: np.ndarray  # int32[n]
    size: int  # piece box side S
    n_pieces: int


def turbo_tables(pieces: PieceSet = PIECES) -> Tables:
    """The turbo engine's packed piece table (``core/turbo.py:_tables_for``).

    Only the single-word packing (``S * S <= 32``) is ported; the default
    4x4 set needs 16 bits per (piece, rotation).
    """
    rtab = row_bits_table(pieces)  # [n, 4, S]
    n, _, size = rtab.shape
    if size * size > 32:
        raise NotImplementedError(
            f"piece box side {size} needs a multi-word packed table, which the "
            "port does not have yet"
        )
    flat = rtab.reshape(n * 4, size).astype(np.uint64)
    packed = np.zeros((n * 4,), dtype=np.uint64)
    for s in range(size):
        packed |= flat[:, s] << np.uint64(s * size)
    return Tables(
        packed=packed.astype(np.uint32),
        box=np.asarray(pieces.box, dtype=np.int32),
        size=size,
        n_pieces=n,
    )
