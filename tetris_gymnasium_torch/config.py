"""Configuration layer: engine geometry, action and reward mappings.

PyTorch port of ``tetris_gymnasium_tpu/config.py:17-128``, kept as its own
copy so that the port never imports the JAX package.  Values and field
order are identical; the tests hold them equal.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple


class EnvConfig(NamedTuple):
    """Static geometry and rules of the compat functional engine
    (:mod:`tetris_gymnasium_torch.core.fn_env`).

    Attributes:
        width/height/padding: board geometry; ``padding`` is the bedrock
            frame on the left, right and bottom.
        queue_size: both the number of distinct pieces and the bag length
            (the reference functional queue's quirk).
        gravity_enabled: whether a gravity sub-step runs after each action.
    """

    width: int = 10
    height: int = 20
    padding: int = 4
    queue_size: int = 7
    gravity_enabled: bool = True

    @property
    def padded_width(self) -> int:
        return self.width + 2 * self.padding

    @property
    def padded_height(self) -> int:
        return self.height + self.padding


class EngineConfig(NamedTuple):
    """Static config of the engine (8 actions, holder, preview queue).

    Attributes:
        width/height/padding: board geometry; ``padding`` is the bedrock
            frame on the left, right and bottom.
        queue_size: preview queue length.
        holder_size: number of pieces the holder stores.
        gravity_enabled: gravity sub-step after each non-hard-drop action.
        auto_reset: a terminated env is re-initialised on the same step.
        queue_kind: piece randomizer, ``"bag"`` (7-bag) or ``"uniform"``.
    """

    width: int = 10
    height: int = 20
    padding: int = 4
    queue_size: int = 4
    holder_size: int = 1
    gravity_enabled: bool = True
    auto_reset: bool = False
    queue_kind: str = "bag"

    @property
    def padded_width(self) -> int:
        return self.width + 2 * self.padding

    @property
    def padded_height(self) -> int:
        return self.height + self.padding


@dataclasses.dataclass(frozen=True)
class ActionsMapping:
    """Action ids of the engine."""

    move_left: int = 0
    move_right: int = 1
    move_down: int = 2
    rotate_clockwise: int = 3
    rotate_counterclockwise: int = 4
    hard_drop: int = 5
    swap: int = 6
    no_op: int = 7


@dataclasses.dataclass(frozen=True)
class RewardsMapping:
    """Reward shaping constants."""

    alife: float = 1
    clear_line: float = 1
    game_over: float = 0
    invalid_action: float = -0.1


# Action ids of the compat functional engine: 7 actions, no swap, and a
# numbering of their own.
FN_ACTION_ID_TO_NAME = {
    0: "move_left",
    1: "move_right",
    2: "move_down",
    3: "rotate_counterclockwise",
    4: "rotate_clockwise",
    5: "do_nothing",
    6: "hard_drop",
}
