"""Host-side preview queue (configuration-time handle).

Port of ``tetris_gymnasium_torch/components/tetromino_queue.py``.  In the
engine the queue's state is the ``queue`` field of ``EngineState`` and the
pop-and-backfill is ``engine._queue_draw``; this class carries the
configuration (``size`` and the randomizer) into the Gymnasium shell, and
is a standalone host queue with the reference's API.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

from tetris_gymnasium_torch.components.tetromino_randomizer import Randomizer


class TetrominoQueue:
    """FIFO of upcoming piece indices, always kept full by a randomizer."""

    def __init__(self, randomizer: Randomizer, size: int = 4):
        self.randomizer = randomizer
        self.size = size
        self.queue: deque = deque(maxlen=size)

    def reset(self, seed: Optional[int] = None) -> None:
        """Seed the randomizer and prefill ``size`` pieces (ref: :24-33)."""
        self.randomizer.reset(seed)
        self.queue.clear()
        for _ in range(self.size):
            self.queue.append(self.randomizer.get_next_tetromino())

    def get_next_tetromino(self) -> int:
        """Pop the head and immediately backfill (ref: :35-42)."""
        piece = self.queue.popleft()
        self.queue.append(self.randomizer.get_next_tetromino())
        return piece

    def get_queue(self) -> List[int]:
        """All queued piece indices, next-up first (ref: :44-46)."""
        return list(self.queue)

    def copy(self, randomizer: Randomizer) -> "TetrominoQueue":
        """Copy with an (independently copied) randomizer (ref: :48-56)."""
        new = TetrominoQueue(randomizer, self.size)
        new.queue = deque(self.queue, maxlen=self.size)
        return new
