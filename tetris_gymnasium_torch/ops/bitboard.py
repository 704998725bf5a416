"""Bit-packed boards: constants, the turbo packed piece table and the
flagship engine's bit operations.

Port of ``tetris_gymnasium_tpu/ops/bitboard.py``: the host constants
(``row_bits_table :47``, ``side_mask :185``, ``play_mask :191``,
``empty_rows :246``), the turbo engine's ``_tables_for``
(``core/turbo.py:114``), and the bit operations over a batch of packed
boards (``pack_board :35`` to ``compact_ids :230``) in plain PyTorch.  Each
padded board row is one 32-bit mask, bit ``w`` = column ``w`` occupied.

The batched operations take rows ``[B, H]`` with the batch leading, held
in int64 lanes (PyTorch has no ``uint32`` arithmetic on the CPU), piece
row masks ``[B, S]`` and per-env ``x``, ``y``.  Window starts are clamped
as ``lax.dynamic_slice`` clamps them, from the 4x4 padded matrix.  Boards
wider than one word (``padded_width > 32``) use the same operations over
multi-word rows, in :mod:`tetris_gymnasium_torch.ops.bitboard_wide`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from tetris_gymnasium_torch.ops.board import clamp_start
from tetris_gymnasium_torch.utils.device import constant

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

    packed: np.ndarray  # uint32[n*4, NW]: row s of (piece, rotation) in bits [s*S, (s+1)*S)
    #   of the words laid end to end (NW = 1 for the default pieces)
    box: np.ndarray  # int32[n]
    size: int  # piece box side S
    n_pieces: int
    n_words: int  # NW = ceil(S * S / 32)


def turbo_tables(pieces: PieceSet = PIECES) -> Tables:
    """The turbo engine's packed piece table (``core/turbo.py:_tables_for :114``).

    The ``S`` rows of ``S`` bits each are laid end to end over ``ceil(S * S
    / 32)`` words: one word for the default 4x4 set, two for a 6x6 set,
    whose rows then straddle a word boundary.
    """
    rtab = row_bits_table(pieces)  # [n, 4, S]
    n, _, size = rtab.shape
    if size > 32:
        raise NotImplementedError(
            f"piece box side {size} exceeds one 32-bit row mask; no Tetris "
            "variant needs pieces wider than 32 columns"
        )
    nw = (size * size + 31) // 32
    flat = rtab.reshape(n * 4, size).astype(np.uint64)
    packed = np.zeros((n * 4, nw), dtype=np.uint64)
    for s in range(size):
        w0, r = divmod(s * size, 32)
        packed[:, w0] |= (flat[:, s] << np.uint64(r)) & np.uint64(0xFFFFFFFF)
        if r + size > 32:
            packed[:, w0 + 1] |= flat[:, s] >> np.uint64(32 - r)
    return Tables(
        packed=packed.astype(np.uint32),
        box=np.asarray(pieces.box, dtype=np.int32),
        size=size,
        n_pieces=n,
        n_words=nw,
    )


# ---------------------------------------------------------------------------
# Batched bit operations (the flagship engine's plain versions)
# ---------------------------------------------------------------------------


def pack_board(board: torch.Tensor) -> torch.Tensor:
    """Occupancy rows ``[B, H]`` (int64 lanes) of id boards ``[B, H, W]``:
    bit ``w`` of row ``r`` is set iff ``board[b, r, w] > 0``."""
    W = board.shape[-1]
    weights = torch.ones((), dtype=torch.int64, device=board.device) << torch.arange(
        W, device=board.device)
    return ((board > 0).to(torch.int64) * weights).sum(dim=-1)


def piece_row_bits(table: np.ndarray, piece: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """Row masks ``[B, S]`` of ``piece`` at ``rotation`` from the ``uint32[n,
    4, S]`` table; an index outside the table gives zeros (the one-hot's)."""
    tab = constant(table.astype(np.int64), piece.device)
    n = tab.shape[0]
    ok = (piece >= 0) & (piece < n) & (rotation >= 0) & (rotation < 4)
    got = tab[piece.clamp(0, n - 1).long(), rotation.clamp(0, 3).long()]
    return torch.where(ok[:, None], got, 0)


def shift_piece(rb: torch.Tensor, x: torch.Tensor, width: int) -> torch.Tensor:
    """Row masks shifted to board columns at the clamped window start ``x``."""
    size = rb.shape[-1]
    return rb << clamp_start(x, width - size, width).to(torch.int64)[:, None]


def hit_map(rows: torch.Tensor, sp: torch.Tensor) -> torch.Tensor:
    """``bool[B, H]``: ``hm[:, y] = any_i rows[:, y + i] & sp[:, i]``; rows past the bottom are empty."""
    acc = rows & sp[:, :1]
    for i in range(1, sp.shape[-1]):
        shifted = torch.cat([rows[:, i:], torch.zeros_like(rows[:, :i])], dim=1)
        acc = acc | (shifted & sp[:, i : i + 1])
    return acc != 0


def collision_at(hm: torch.Tensor, y: torch.Tensor, size: int = 4) -> torch.Tensor:
    """``bool[B]``: the hit map at the clamped window start ``y``."""
    H = hm.shape[-1]
    return hm.gather(1, clamp_start(y, H - size, H).long()[:, None])[:, 0]


def collision(rows: torch.Tensor, rb: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
              width: int) -> torch.Tensor:
    """``bool[B]``: the piece overlaps the occupancy at window (x, y)."""
    return collision_at(hit_map(rows, shift_piece(rb, x, width)), y, rb.shape[-1])


def drop_from_map(hm: torch.Tensor, y: torch.Tensor, size: int = 4) -> torch.Tensor:
    """Hard-drop distance ``int32[B]`` from a hit map: the first hit at or
    after ``clip(y + 1)``; ``first_hit == 0`` gives 0."""
    H = hm.shape[-1]
    idx = torch.arange(H, dtype=torch.int32, device=hm.device)[None, :]
    z = (y + 1).clamp(0, H - size)[:, None]
    eligible = hm & (idx >= z) & (idx <= H - size)
    first_hit = torch.where(eligible, idx, 2 * H).amin(dim=1)
    dist = (first_hit - (y + 1)).clamp(0, H)
    return torch.where(first_hit == 0, 0, dist).to(torch.int32)


def drop_distance(rows: torch.Tensor, rb: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  width: int) -> torch.Tensor:
    """Hard-drop distance ``int32[B]`` of the piece rows ``rb`` at window
    (x, y) (``drop_distance :138``): the hit map of the shifted piece, then
    its first hit at or after ``clip(y + 1)``."""
    return drop_from_map(hit_map(rows, shift_piece(rb, x, width)), y, rb.shape[-1])


def project(rows: torch.Tensor, rb: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            width: int) -> torch.Tensor:
    """OR the piece into the rows at the clamped window (x, y)."""
    H, size = rows.shape[-1], rb.shape[-1]
    sp = shift_piece(rb, x, width)
    yc = clamp_start(y, H - size, H)[:, None]
    h = torch.arange(H, device=rows.device)[None, :]
    out = rows
    for i in range(size):
        out = out | torch.where(h == yc + i, sp[:, i : i + 1], 0)
    return out


def filled_rows(rows: torch.Tensor, height: int, width: int, padding: int) -> torch.Tensor:
    """``bool[B, height]``: playfield rows whose every cell is occupied."""
    pm = play_mask(width, padding)
    return (rows[:, :height] & pm) == pm


def _compact(inner: torch.Tensor, filled: torch.Tensor) -> torch.Tensor:
    """Kept rows of ``inner [B, height, ...]`` moved down past the filled
    ones below them; the rows left at the top are zeros."""
    height = filled.shape[1]
    keep = ~filled
    n = filled.sum(dim=1, keepdim=True)
    dest = keep.long().cumsum(dim=1) - 1 + n  # destination of each source row
    dest = torch.where(keep, dest, height)  # filled rows go to a discarded slot
    out = torch.zeros((inner.shape[0], height + 1) + inner.shape[2:], dtype=inner.dtype,
                      device=inner.device)
    index = dest.reshape(dest.shape + (1,) * (inner.ndim - 2)).expand(inner.shape)
    return out.scatter(1, index, inner)[:, :height]


def clear_lines(rows: torch.Tensor, height: int, width: int,
                padding: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clear every filled row and compact down: ``(rows', n int32[B], filled)``.

    Cleared rows become empty rows (side bits only) at the top; ``filled``
    is returned so that :func:`compact_ids` can move an id image the same way.
    """
    filled = filled_rows(rows, height, width, padding)
    compacted = _compact(rows[:, :height], filled) | side_mask(width, padding)
    n = filled.sum(dim=1, dtype=torch.int32)
    return torch.cat([compacted, rows[:, height:]], dim=1), n, filled


def compact_ids(inner: torch.Tensor, filled: torch.Tensor) -> torch.Tensor:
    """The compaction of ``filled`` applied to id images ``[B, height, W]``;
    cleared rows come back as zeros at the top."""
    return _compact(inner, filled)


ROW_BITS = row_bits_table(PIECES)  # uint32[7, 4, 4] of the default pieces (``:255``)
