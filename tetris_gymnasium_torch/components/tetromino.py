"""Piece data model: ``Pixel`` and ``Tetromino``.

Port of ``tetris_gymnasium_torch/components/tetromino.py``, kept as its own
copy so that the port never imports the JAX package: a list of
``Tetromino`` objects compiles into a
:class:`~tetris_gymnasium_torch.pieces.PieceSet`, the numpy tables the
engine reads.  The objects exist only at configuration time.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tetris_gymnasium_torch.pieces import PieceSet


@dataclasses.dataclass
class Pixel:
    """One cell type: an integer id and an RGB color.

    Ref parity: components/tetromino.py:8-18.
    """

    id: int
    color_rgb: List[int]

    def __copy__(self) -> "Pixel":
        return Pixel(self.id, list(self.color_rgb))


@dataclasses.dataclass
class Tetromino(Pixel):
    """A pixel with a binary occupancy matrix (ref: components/tetromino.py:22-52).

    The matrix may be any square ``[k, k]`` uint8 array; rectangular shapes
    are padded to square at compile time so rotation stays in-box (the same
    invariant the reference's precomputed rotation table relies on,
    ref: functional/tetrominoes.py:123-133).
    """

    matrix: np.ndarray

    def __post_init__(self):
        self.matrix = np.asarray(self.matrix, dtype=np.uint8)

    def __copy__(self) -> "Tetromino":
        return Tetromino(self.id, list(self.color_rgb), self.matrix.copy())


# The reference's default base pixels: empty and bedrock
# (ref: envs/tetris.py:45).
BASE_PIXELS = (Pixel(0, [0, 0, 0]), Pixel(1, [128, 128, 128]))

# The reference's default tetromino list (ref: envs/tetris.py:47-75): same
# ids-before-offset (0..6 -> 2..8 after base-pixel offset), colors and cell
# layouts as the functional tables in :mod:`tetris_gymnasium_torch.pieces`.
def default_tetrominoes() -> List[Tetromino]:
    """Fresh copies of the standard 7 tetrominoes (I, O, T, S, Z, J, L)."""
    from tetris_gymnasium_torch.pieces import PIECES, PIECE_ORDER

    return [
        Tetromino(
            int(PIECES.ids[i]) - 2,
            [int(c) for c in PIECES.colors[i]],
            np.asarray(PIECES.matrices[i, 0, : PIECES.box[i], : PIECES.box[i]]),
        )
        for i, _ in enumerate(PIECE_ORDER)
    ]


def _to_square(matrix: np.ndarray) -> np.ndarray:
    """Pad a piece matrix to square (rotation then stays inside the box)."""
    h, w = matrix.shape
    k = max(h, w)
    out = np.zeros((k, k), dtype=np.int8)
    out[:h, :w] = matrix
    return out


def pieces_from_tetrominoes(
    tetrominoes: Sequence[Tetromino],
    base_pixels: Optional[Sequence[Pixel]] = None,
) -> Tuple[PieceSet, int]:
    """Compile a ``Tetromino`` list into a :class:`PieceSet` + board padding.

    The reference's init-time table building (ref: envs/tetris.py:110-134):
    piece ids are offset past the base pixels,
    every matrix is padded to the common box size ``S`` and pre-rotated into a
    ``[n, 4, S, S]`` tensor, and the board padding is ``S`` (the reference
    uses ``max(matrix dims)``, envs/tetris.py:131).

    Returns:
        (pieces, padding) — the static tables and the bedrock frame width.
    """
    base = list(base_pixels) if base_pixels is not None else list(BASE_PIXELS)
    if len(base) != 2:
        raise ValueError("base_pixels must be [empty, bedrock] (2 pixels)")
    offset = len(base)

    squares = [_to_square(np.asarray(t.matrix)) for t in tetrominoes]
    size = max(m.shape[0] for m in squares)
    n = len(tetrominoes)

    mats = np.zeros((n, 4, size, size), dtype=np.int8)
    boxes = np.zeros((n,), dtype=np.int32)
    for p, m in enumerate(squares):
        k = m.shape[0]
        boxes[p] = k
        rot = (m > 0).astype(np.int8)
        for r in range(4):
            mats[p, r, :k, :k] = rot
            rot = np.rot90(rot)

    pieces = PieceSet(
        ids=np.asarray([t.id + offset for t in tetrominoes], dtype=np.int8),
        colors=np.asarray([t.color_rgb for t in tetrominoes], dtype=np.uint8),
        matrices=mats,
        box=boxes,
        base_colors=np.asarray([p.color_rgb for p in base], dtype=np.uint8),
    )
    return pieces, size
