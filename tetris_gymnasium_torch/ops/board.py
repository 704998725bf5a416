"""Id-board helpers of the flagship and compat engines, batched, plain PyTorch.

Port of ``tetris_gymnasium_tpu/ops/board.py``: ``create_board :27``,
``_clamp_start :40`` (here :func:`clamp_start`, which the bit operations
and the turbo engine share), ``collision :62``, ``project :80``,
``drop_distance :116``, ``hard_drop :155``, ``clear_lines :166``,
``clear_lines_compat :203``, ``score_fn :242``, ``score_classic :253``,
``gravity_step :259``, ``spawn_xy_fn :267`` and ``spawn_x_classic :276``.
A board is ``int8[B, H, W]`` (cell ids: 0 empty, 1 bedrock, 2.. pieces)
with the batch leading; a piece matrix is ``[B, S, S]`` and ``x``, ``y``
are ``int32[B]``.  The JAX versions address the ``S x S`` window with
one-hot contractions; here the window is gathered and scattered directly,
with the same start clamping.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tetris_gymnasium_torch.pieces import BEDROCK_ID, MAX_SIZE


def create_board(height: int, width: int, padding: int, batch: int, device) -> torch.Tensor:
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


def window(board: torch.Tensor, size: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Each env's clamped ``size x size`` window of ``board``, ``[B, S, S]``
    (``lax.dynamic_slice`` at (y, x))."""
    return board[_window(board, size, x, y)]


def collision(board: torch.Tensor, piece: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``bool[B]``: a filled piece cell overlaps a cell ``> 0`` of the window at (x, y)."""
    return ((window(board, piece.shape[-1], x, y) > 0) & (piece > 0)).flatten(1).any(dim=1)


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


def drop_distance(board: torch.Tensor, piece: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """How far the piece falls from (x, y), ``int32[B]`` (``:116``).

    The collision test at every offset ``d`` in ``[0, H)``, its window start
    ``clip(y + 1 + d, 0, H - S)`` (a plain clip, no wrap), and the count of
    the collision-free prefix: a board without a floor gives ``H``.
    """
    B, H, W = board.shape
    S = piece.shape[-1]
    ar = torch.arange(S, device=board.device)
    cols = clamp_start(x, W - S, W).long()[:, None] + ar  # [B, S]
    occ = (board > 0).gather(2, cols[:, None, :].expand(B, H, S))  # occ[b, r, x + j]
    row_hit = (occ[:, :, None, :] & (piece > 0)[:, None, :, :]).any(dim=-1)  # [B, H, S]: row r under piece row i
    ys = (y.long()[:, None] + 1 + torch.arange(H, device=board.device)).clamp(0, H - S)  # [B, H]
    hit = row_hit.gather(1, ys[:, :, None] + ar).any(dim=-1)  # [B, H]: the window at ys[d]
    return torch.cumprod((~hit).to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)


def hard_drop(board: torch.Tensor, piece: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Drop to rest (``:155``): ``(new_y, reward = 2 per cell dropped)``, ``int32[B]`` each."""
    dist = drop_distance(board, piece, x, y)
    return (y + dist).to(torch.int32), 2 * dist


def clear_lines(board: torch.Tensor, height: int, width: int, padding: int):
    """Clear every full playfield row and compact the stack down (``:166``):
    ``(board, lines int32[B])``.  The rows that stay keep their order at the
    bottom, the cleared rows come back as zeros at the top, and the bottom
    padding and both side frames are rebuilt as bedrock."""
    inner = board[:, :-padding, padding:-padding]
    filled = (inner > 0).all(dim=2)  # [B, height]
    n = filled.sum(dim=1, dtype=torch.int32)
    keep = ~filled
    # a kept row goes to its rank among the kept rows plus n; a full row to a
    # spare row past the end, dropped (no host sync: a CUDA graph can hold it)
    dest = torch.where(keep, torch.cumsum(keep.to(torch.int64), dim=1) - 1 + n[:, None], height)
    out = torch.zeros((inner.shape[0], height + 1, width), dtype=inner.dtype, device=inner.device)
    out.scatter_(1, dest[:, :, None].expand(-1, -1, width), inner)
    return F.pad(out[:, :height], (padding, padding, 0, padding), value=BEDROCK_ID), n


def clear_lines_compat(board: torch.Tensor, height: int, width: int, padding: int):
    """The compat engine's line clear (``:203``): :func:`clear_lines`, but
    the ``n`` new top rows are copies of the pre-clear playfield row 0, not
    zeros (the reference's ``take`` wraps the cleared rows' index
    ``-height`` to row 0).  Returns ``(board, lines int32[B])``."""
    inner = board[:, :-padding, padding:-padding]
    cleared, n = clear_lines(board, height, width, padding)
    top = torch.arange(height, device=board.device)[None, :] < n[:, None]  # [B, height]
    rows = torch.where(top[:, :, None], inner[:, :1], cleared[:, :-padding, padding:-padding])
    return F.pad(rows, (padding, padding, 0, padding), value=BEDROCK_ID), n


def score_fn(rows_cleared: torch.Tensor) -> torch.Tensor:
    """The compat engine's line-clear score (``:242``): 1 -> 100, 2 -> 300,
    3 -> 500, 4 -> 800 (``rows * 200 - 100`` but for a tetris), ``int32``."""
    rows = rows_cleared.to(torch.int32)
    standard = torch.where(rows > 0, rows * 200 - 100, 0)
    return torch.where(rows == 4, 800, standard).to(torch.int32)


def score_classic(rows_cleared: torch.Tensor, width: int) -> torch.Tensor:
    """The flagship engine's score, ``rows ** 2 * width`` (``:253``), ``int32``."""
    rows = rows_cleared.to(torch.int32)
    return rows * rows * width


def gravity_step(board: torch.Tensor, piece: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One cell of gravity where the cell below is free (``:259``), ``int32[B]``."""
    blocked = collision(board, piece, x, y + 1)
    return torch.where(blocked, y, y + 1).to(torch.int32)


def spawn_xy_fn(config):
    """The compat engine's spawn ``(x, y)`` (``:267``): the column comes from
    the padded matrix width 4, so it does not depend on the piece."""
    return (config.width + 2 * config.padding) // 2 - MAX_SIZE // 2, 0


def spawn_x_classic(padded_width: int, box: torch.Tensor) -> torch.Tensor:
    """Spawn column centred on the piece's square bounding box (``:276``)."""
    return (padded_width // 2 - box // 2).to(torch.int32)
