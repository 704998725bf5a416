"""Multi-word bit-packed boards: the flagship engine's bit operations on
boards wider than one 32-bit word.

Port of ``tetris_gymnasium_tpu/ops/bitboard_wide.py``: every row operation
of :mod:`tetris_gymnasium_torch.ops.bitboard` over ``NW = ceil(padded_width
/ 32)`` words a row.  Bit ``w % 32`` of word ``w // 32`` is column ``w``; a
piece's x-shift splits into a low word and a carry word at a per-env word
index, hit maps OR across words, and the line masks are per-word constants.
The API is the single-word module's (same names and signatures), so the
flagship engine picks one of the two from its static geometry.

As in :mod:`~tetris_gymnasium_torch.ops.bitboard`, the operations are
batched with the batch leading: rows ``[B, H, NW]`` in int64 lanes holding
32-bit values (PyTorch has no ``uint32`` arithmetic on the CPU), piece row
masks ``[B, S]``, per-env ``x`` and ``y``.  The carry shift is guarded (a
shift by 32 is undefined in C++ as in XLA, and the carry is zero then), and
every shifted word is masked back to 32 bits, which the JAX version gets
from ``uint32`` wrap-around.  The compaction moves whole words, so bit 31
of word 0, a playfield column once ``padded_width >= 32``, survives it.
"""
from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch

# Shared with the single-word module: piece row masks fit one word, the
# hit-map consumers are word-free and id compaction never reads packed rows.
from tetris_gymnasium_torch.ops.bitboard import (  # noqa: F401  (re-exports)
    _compact,
    collision_at,
    compact_ids,
    drop_from_map,
    piece_row_bits,
    row_bits_table,
)
from tetris_gymnasium_torch.ops import bitboard
from tetris_gymnasium_torch.ops.board import clamp_start
from tetris_gymnasium_torch.ops.rng import MASK32
from tetris_gymnasium_torch.utils.device import constant


def n_words(width: int) -> int:
    """Words per packed row for a padded board ``width`` columns wide."""
    return (width + 31) // 32


def wide(width: int) -> bool:
    """Whether a row ``width`` padded columns wide takes more than one word
    (this module's rows ``[..., NW]``) or fits one (``ops/bitboard``'s
    ``[...]``): the one place that decides the row format."""
    return n_words(width) > 1


def row_ops(width: int):
    """The bit-operation module for rows ``width`` padded columns wide (JAX
    ``core/engine.py:_kb :46``): this one for multi-word rows, else
    :mod:`~tetris_gymnasium_torch.ops.bitboard`; both have one API."""
    return sys.modules[__name__] if wide(width) else bitboard


def pack_board(board: torch.Tensor) -> torch.Tensor:
    """Occupancy rows ``[B, H, NW]`` (int64 lanes) of id boards ``[B, H, W]``:
    bit ``w % 32`` of word ``w // 32`` is set iff ``board[b, r, w] > 0``."""
    W = board.shape[-1]
    occ = (board > 0).to(torch.int64)
    words = []
    for j in range(n_words(W)):
        lo, hi = 32 * j, min(32 * (j + 1), W)
        weights = torch.ones((), dtype=torch.int64, device=board.device) << torch.arange(
            hi - lo, device=board.device)
        words.append((occ[..., lo:hi] * weights).sum(dim=-1))
    return torch.stack(words, dim=-1)


def _mask_words(mask: int, nw: int) -> np.ndarray:
    """A Python big-int bitmask as ``uint32[nw]`` little-endian words."""
    return np.array([(mask >> (32 * j)) & 0xFFFFFFFF for j in range(nw)], dtype=np.uint32)


def side_mask_words(width: int, padding: int) -> np.ndarray:
    """Per-word bits of the left and right bedrock columns of a padded row."""
    lo = (1 << padding) - 1
    return _mask_words(lo | (lo << (padding + width)), n_words(width + 2 * padding))


def play_mask_words(width: int, padding: int) -> np.ndarray:
    """Per-word bits of the playfield columns of a padded row."""
    return _mask_words(((1 << width) - 1) << padding, n_words(width + 2 * padding))


def empty_rows(height: int, width: int, padding: int) -> np.ndarray:
    """Packed rows ``uint32[height + padding, NW]`` of an empty padded board."""
    pw = width + 2 * padding
    rows = np.tile(side_mask_words(width, padding), (height + padding, 1))
    rows[height:] = _mask_words((1 << pw) - 1, n_words(pw))
    return rows


def shift_piece(rb: torch.Tensor, x: torch.Tensor, width: int) -> torch.Tensor:
    """Piece row masks ``[B, S]`` at board columns: ``[B, S, NW]``.

    The clamped window start ``x`` puts each row's low word ``rb << (x %
    32)`` at word ``x // 32`` and its carry ``rb >> (32 - x % 32)`` at the
    next word; the carry is 0 where ``x % 32 == 0``.
    """
    size = rb.shape[-1]
    xc = clamp_start(x, width - size, width).to(torch.int64)
    word = (xc // 32)[:, None, None]
    off = (xc % 32)[:, None]
    lo = (rb << off) & MASK32
    hi = torch.where(off == 0, 0, rb >> (32 - off))
    j = torch.arange(n_words(width), device=rb.device)[None, None, :]
    return torch.where(j == word, lo[..., None], 0) | torch.where(j == word + 1, hi[..., None], 0)


def hit_map(rows: torch.Tensor, sp: torch.Tensor) -> torch.Tensor:
    """``bool[B, H]``: ``hm[:, y] = any_{i, j} rows[:, y + i, j] & sp[:, i, j]``
    (rows past the bottom are empty), the single-word module's hit map."""
    acc = rows & sp[:, :1]
    for i in range(1, sp.shape[1]):
        shifted = torch.cat([rows[:, i:], torch.zeros_like(rows[:, :i])], dim=1)
        acc = acc | (shifted & sp[:, i : i + 1])
    return (acc != 0).any(dim=2)


def collision(rows: torch.Tensor, rb: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
              width: int) -> torch.Tensor:
    """``bool[B]``: the piece overlaps the occupancy at window (x, y)."""
    return collision_at(hit_map(rows, shift_piece(rb, x, width)), y, rb.shape[-1])


def drop_distance(rows: torch.Tensor, rb: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  width: int) -> torch.Tensor:
    """Hard-drop distance ``int32[B]`` of the piece from window (x, y)."""
    return drop_from_map(hit_map(rows, shift_piece(rb, x, width)), y, rb.shape[-1])


def project(rows: torch.Tensor, rb: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            width: int) -> torch.Tensor:
    """OR the piece into the rows at the clamped window (x, y)."""
    H, size = rows.shape[1], rb.shape[-1]
    sp = shift_piece(rb, x, width)  # [B, S, NW]
    yc = clamp_start(y, H - size, H)[:, None, None]
    h = torch.arange(H, device=rows.device)[None, :, None]
    out = rows
    for i in range(size):
        out = out | torch.where(h == yc + i, sp[:, i : i + 1], 0)
    return out


def filled_rows(rows: torch.Tensor, height: int, width: int, padding: int) -> torch.Tensor:
    """``bool[B, height]``: playfield rows whose every cell is occupied (the
    per-word mask test AND-reduced across words)."""
    pm = constant(play_mask_words(width, padding).astype(np.int64), rows.device)
    return ((rows[:, :height] & pm) == pm).all(dim=2)


def clear_lines(rows: torch.Tensor, height: int, width: int,
                padding: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clear every filled row and compact down: ``(rows', n int32[B], filled)``;
    cleared rows come back as empty rows (side bits only) at the top."""
    filled = filled_rows(rows, height, width, padding)
    side = constant(side_mask_words(width, padding).astype(np.int64), rows.device)
    compacted = _compact(rows[:, :height], filled) | side
    n = filled.sum(dim=1, dtype=torch.int32)
    return torch.cat([compacted, rows[:, height:]], dim=1), n, filled
