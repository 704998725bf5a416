"""Tetromino piece tables, in numpy, and the batched matrix fetch.

Port of ``tetris_gymnasium_tpu/pieces.py:27-150``: seven pieces, each
pre-rotated into a ``[7, 4, 4, 4]`` int8 table, plus the bounding-box side
per piece, and ``piece_matrix :138`` over a batch.  Values are identical to
the JAX package's tables.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from tetris_gymnasium_torch.utils.device import constant

# Piece shapes in their canonical (rotation 0) orientation.
_SHAPES = {
    "I": ("....", "####", "....", "...."),
    "O": ("##", "##"),
    "T": (".#.", "###", "..."),
    "S": (".##", "##.", "..."),
    "Z": ("##.", ".##", "..."),
    "J": ("#..", "###", "..."),
    "L": ("..#", "###", "..."),
}
PIECE_ORDER = ("I", "O", "T", "S", "Z", "J", "L")

_COLORS = {
    "I": (0, 240, 240),
    "O": (240, 240, 0),
    "T": (160, 0, 240),
    "S": (0, 240, 0),
    "Z": (240, 0, 0),
    "J": (0, 0, 240),
    "L": (240, 160, 0),
}

# Cell ids: 0 = empty, 1 = bedrock, pieces start at 2.
EMPTY_ID = 0
BEDROCK_ID = 1
FIRST_PIECE_ID = 2
NUM_PIECES = len(PIECE_ORDER)
MAX_SIZE = 4  # all rotation matrices are padded to 4x4


def _shape_to_matrix(rows: Tuple[str, ...]) -> np.ndarray:
    return np.array([[1 if c == "#" else 0 for c in r] for r in rows], dtype=np.int8)


def _build_tables():
    mats = np.zeros((NUM_PIECES, 4, MAX_SIZE, MAX_SIZE), dtype=np.int8)
    boxes = np.zeros((NUM_PIECES,), dtype=np.int32)
    for p, name in enumerate(PIECE_ORDER):
        base = _shape_to_matrix(_SHAPES[name])
        k = base.shape[0]
        boxes[p] = k
        rot = base
        for r in range(4):
            # every base matrix is square, so rotating then padding keeps
            # the piece inside the same top-left k x k box
            mats[p, r, :k, :k] = rot
            rot = np.rot90(rot)
    return mats, boxes


_MATRICES_NP, _BOX_NP = _build_tables()


class PieceSet(NamedTuple):
    """Piece tables as numpy arrays.

    Attributes:
        ids: ``[7]`` int8 cell ids (2..8).
        colors: ``[7, 3]`` uint8 RGB colors.
        matrices: ``[7, 4, 4, 4]`` int8; ``matrices[p, r]`` is piece ``p``
            rotated ``r`` times, as a binary mask padded to 4x4.
        box: ``[7]`` int32 bounding-box side (I=4, O=2, rest=3).
        base_colors: ``[2, 3]`` uint8 colors for empty and bedrock cells.
    """

    ids: np.ndarray
    colors: np.ndarray
    matrices: np.ndarray
    box: np.ndarray
    base_colors: np.ndarray

    @property
    def palette(self) -> np.ndarray:
        """``[9, 3]`` uint8 palette indexed directly by cell id."""
        return np.concatenate([self.base_colors, self.colors], axis=0)


def make_pieces() -> PieceSet:
    """Build the default 7-piece set."""
    return PieceSet(
        ids=np.arange(FIRST_PIECE_ID, FIRST_PIECE_ID + NUM_PIECES, dtype=np.int8),
        colors=np.array([_COLORS[n] for n in PIECE_ORDER], dtype=np.uint8),
        matrices=_MATRICES_NP,
        box=_BOX_NP,
        base_colors=np.array([[0, 0, 0], [128, 128, 128]], dtype=np.uint8),
    )


PIECES = make_pieces()


def piece_matrix(pieces: PieceSet, piece: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """``int8[B, S, S]`` matrices of ``piece`` at ``rotation`` (``pieces.py:138``).

    An index outside the table gives an all-zero matrix, as the JAX
    version's one-hot contraction does.
    """
    mats = constant(pieces.matrices, piece.device)  # [n, 4, S, S]
    n = mats.shape[0]
    ok = (piece >= 0) & (piece < n) & (rotation >= 0) & (rotation < 4)
    got = mats[piece.clamp(0, n - 1).long(), rotation.clamp(0, 3).long()]
    return torch.where(ok[:, None, None], got, torch.zeros_like(got))
