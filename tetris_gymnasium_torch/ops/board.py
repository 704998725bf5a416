"""Id-board helpers of the flagship engine, batched, plain PyTorch.

Port of the half of ``tetris_gymnasium_tpu/ops/board.py`` that the flagship
engine uses: ``create_board :27``, ``_clamp_start :40`` (here
:func:`clamp_start`, which the bit operations and the turbo engine share),
``collision :62``,
``project :80`` and ``spawn_x_classic :276``.  A board is ``int8[B, H, W]``
(cell ids: 0 empty, 1 bedrock, 2.. pieces) with the batch leading; a piece
matrix is ``[B, S, S]`` and ``x``, ``y`` are ``int32[B]``.  The JAX
versions address the ``S x S`` window with one-hot contractions; here the
window is gathered and scattered directly, with the same start clamping.
"""
from __future__ import annotations

import torch

from tetris_gymnasium_torch.pieces import BEDROCK_ID


def create_board(height: int, width: int, padding: int, batch: int, device="cpu") -> torch.Tensor:
    """Empty padded boards ``int8[batch, height + padding, width + 2 * padding]``:
    zeros inside, bedrock on the left, right and bottom."""
    board = torch.full((batch, height + padding, width + 2 * padding), BEDROCK_ID,
                       dtype=torch.int8, device=device)
    board[:, :height, padding : padding + width] = 0
    return board


def clamp_start(v: torch.Tensor, limit: int, dim: int) -> torch.Tensor:
    """Slice-start normalisation of ``lax.dynamic_slice``: negative starts
    wrap by ``+dim``, then clip to ``[0, limit]``."""
    v = torch.where(v < 0, v + dim, v)
    return v.clamp(0, limit)


def _window(board: torch.Tensor, size: int, x: torch.Tensor, y: torch.Tensor):
    """Index tensors ``(b, rows, cols)`` of each env's clamped ``size x size`` window."""
    B, H, W = board.shape
    ar = torch.arange(size, device=board.device)
    rows = (clamp_start(y, H - size, H).long()[:, None] + ar)[:, :, None]  # [B, S, 1]
    cols = (clamp_start(x, W - size, W).long()[:, None] + ar)[:, None, :]  # [B, 1, S]
    b = torch.arange(B, device=board.device)[:, None, None]
    return b, rows, cols


def collision(board: torch.Tensor, piece: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``bool[B]``: a filled piece cell overlaps a cell ``> 0`` of the window at (x, y)."""
    window = board[_window(board, piece.shape[-1], x, y)]
    return ((window > 0) & (piece > 0)).flatten(1).any(dim=1)


def project(board: torch.Tensor, piece: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            cell_id) -> torch.Tensor:
    """``board`` with ``piece * cell_id`` ADDED at the clamped window (x, y).

    The sum wraps in the board's dtype, as the JAX version's does; an
    overlapping stamp adds to the cell below it.  ``cell_id`` is a scalar
    or ``[B]``.  Returns a new board.
    """
    idx = _window(board, piece.shape[-1], x, y)
    if isinstance(cell_id, torch.Tensor):
        cell_id = cell_id.to(torch.int32).reshape((-1, 1, 1) if cell_id.ndim else ())
    stamp = piece.to(torch.int32) * cell_id
    out = board.clone()
    out[idx] = (board[idx].to(torch.int32) + stamp).to(board.dtype)
    return out


def spawn_x_classic(padded_width: int, box: torch.Tensor) -> torch.Tensor:
    """Spawn column centred on the piece's square bounding box (``:276``)."""
    return (padded_width // 2 - box // 2).to(torch.int32)
