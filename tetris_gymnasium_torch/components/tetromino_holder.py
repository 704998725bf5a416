"""Host-side tetromino holder (configuration-time handle).

Port of ``tetris_gymnasium_tpu/components/tetromino_holder.py``.  In the
engine the holder's state is the ``holder_piece``, ``holder_rotation`` and
``holder_count`` fields of ``EngineState``; this class carries the
configuration (``size``) into the Gymnasium shell, and is a standalone host
holder with the reference's API.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional


class TetrominoHolder:
    """Stores up to ``size`` pieces; FIFO swap semantics."""

    def __init__(self, size: int = 1):
        self.size = size
        self.queue: deque = deque(maxlen=size)

    def swap(self, tetromino) -> Optional[object]:
        """Store ``tetromino``; return the oldest stored piece only when full.

        Ref parity: components/tetromino_holder.py:31-48 — while the holder
        is below capacity the piece is absorbed and ``None`` returned.
        """
        if len(self.queue) < self.size:
            self.queue.append(tetromino)
            return None
        result = self.queue.popleft()
        self.queue.append(tetromino)
        return result

    def reset(self) -> None:
        """Empty the holder (ref: :51-53)."""
        self.queue.clear()

    def get_tetrominoes(self) -> List[object]:
        """All currently stored pieces, oldest first (ref: :55-57)."""
        return list(self.queue)

    def __copy__(self) -> "TetrominoHolder":
        new = TetrominoHolder(self.size)
        new.queue = deque(self.queue, maxlen=self.size)
        return new
