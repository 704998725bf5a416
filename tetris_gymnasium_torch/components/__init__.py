"""Pluggable game components: the piece model, queue, holder and randomizers.

Port of ``tetris_gymnasium_tpu/components``: configuration-time handles
that configure the engine when injected into the Gymnasium shell, and pure
draw strategies that the engine runs.
"""
from tetris_gymnasium_torch.components.tetromino import (
    BASE_PIXELS,
    Pixel,
    Tetromino,
    default_tetrominoes,
    pieces_from_tetrominoes,
)
from tetris_gymnasium_torch.components.tetromino_holder import TetrominoHolder
from tetris_gymnasium_torch.components.tetromino_queue import TetrominoQueue
from tetris_gymnasium_torch.components.tetromino_randomizer import (
    BagRandomizer,
    Randomizer,
    TrueRandomizer,
    bag_draw,
    get_draw_fn,
    register_randomizer,
    uniform_draw,
    unregister_randomizer,
)

__all__ = [
    "BASE_PIXELS",
    "Pixel",
    "Tetromino",
    "default_tetrominoes",
    "pieces_from_tetrominoes",
    "TetrominoHolder",
    "TetrominoQueue",
    "Randomizer",
    "BagRandomizer",
    "TrueRandomizer",
    "bag_draw",
    "uniform_draw",
    "register_randomizer",
    "unregister_randomizer",
    "get_draw_fn",
]
