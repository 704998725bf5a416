"""Gymnasium shell over the flagship engine, one env.

Port of ``tetris_gymnasium_tpu/envs/gym_env.py`` with the same constructor
and one more argument, ``device`` (default ``"cuda"``): the state is a
batch of one env on that device, and every step is the engine's
(:mod:`tetris_gymnasium_torch.core.engine`) on it.  On the card a step is
the ``flagship_step`` kernel and the Dict observation the ``observe_dict``
kernel; ``render("rgb_array")`` adds ``compose_rgb``.  ``device="cpu"`` runs
the plain versions.

API of the reference ``Tetris(gym.Env)``: the Dict observation space
(``board``, ``active_tetromino_mask``, ``holder``, ``queue``),
``Discrete(8)`` actions, ``(lines ** 2) * width`` scoring, ``ansi`` /
``rgb_array`` / ``human`` rendering, ``get_state`` / ``set_state`` and
``info["lines_cleared"]``.
"""
from __future__ import annotations

import functools
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tetris_gymnasium_torch.components.tetromino import (
    Pixel,
    Tetromino as TetrominoPiece,
    default_tetrominoes,
    pieces_from_tetrominoes,
)
from tetris_gymnasium_torch.components.tetromino_holder import TetrominoHolder
from tetris_gymnasium_torch.components.tetromino_queue import TetrominoQueue
from tetris_gymnasium_torch.components.tetromino_randomizer import Randomizer
from tetris_gymnasium_torch.config import ActionsMapping, EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import engine
from tetris_gymnasium_torch.core.engine import EngineState
from tetris_gymnasium_torch.envs.api import gym, spaces
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.ops.observations import upscale_rgb
from tetris_gymnasium_torch.pieces import PIECES
from tetris_gymnasium_torch.utils.device import resolve_device

ACTION_NAMES = ("move_left", "move_right", "move_down", "rotate_clockwise",
                "rotate_counterclockwise", "hard_drop", "swap", "no_op")


def to_numpy(obs: dict) -> dict:
    """A batch-of-one Dict observation as the env's numpy arrays."""
    return {k: v[0].cpu().numpy() for k, v in obs.items()}


class Tetris(gym.Env):
    """Single-env Gymnasium view of the flagship engine.

    For RL at scale use the batched functional API
    (:mod:`tetris_gymnasium_torch.core.engine`,
    :class:`tetris_gymnasium_torch.envs.TetrisVectorEnv`); this class is for
    API compatibility, debugging and interactive play.
    """

    metadata = {"render_modes": ["ansi", "rgb_array", "human"], "render_fps": 1}

    def __init__(
        self,
        render_mode: Optional[str] = None,
        width: int = 10,
        height: int = 20,
        gravity: bool = True,
        queue_size: int = 4,
        holder_size: int = 1,
        actions_mapping: ActionsMapping = ActionsMapping(),
        rewards_mapping: RewardsMapping = RewardsMapping(),
        render_upscale: int = 10,
        randomizer=None,
        queue: Optional[TetrominoQueue] = None,
        holder: Optional[TetrominoHolder] = None,
        tetrominoes: Optional[Sequence[TetrominoPiece]] = None,
        base_pixels: Optional[Sequence[Pixel]] = None,
        device="cuda",
    ):
        """Pluggable components as in the reference constructor: a
        ``randomizer`` (a :class:`Randomizer`, whose ``engine_kind`` names
        the draw strategy, or a strategy name), ``queue`` / ``holder``
        handles (their sizes, and the queue's randomizer, configure the
        engine), and custom ``tetrominoes`` / ``base_pixels`` (board padding
        = the pieces' box size).  On the card the kernels are built for the
        configured geometry and pieces at first use."""
        if queue is not None:
            queue_size = queue.size
            if queue.randomizer is not None:  # the queue owns its randomizer
                randomizer = queue.randomizer
        if holder is not None:
            holder_size = holder.size
        if randomizer is None:
            randomizer = "bag"
        if isinstance(randomizer, str):
            queue_kind = randomizer
        else:
            if isinstance(randomizer, Randomizer) and not any(
                "engine_kind" in vars(klass)
                for klass in type(randomizer).__mro__[:-1]
                if klass is not Randomizer
            ) and type(randomizer) is not Randomizer:
                warnings.warn(
                    f"{type(randomizer).__name__} does not declare `engine_kind`; the engine "
                    "will use the inherited default ('bag') for its draws, which may not "
                    "match get_next_tetromino(). Set engine_kind explicitly on the subclass.",
                    RuntimeWarning,
                    stacklevel=2,
                )
            queue_kind = randomizer.engine_kind

        if tetrominoes is not None or base_pixels is not None:
            pieces, padding = pieces_from_tetrominoes(
                default_tetrominoes() if tetrominoes is None else tetrominoes, base_pixels)
        else:
            pieces, padding = PIECES, 4

        self.device = resolve_device(device)
        self.config = EngineConfig(
            width=width, height=height, padding=padding, queue_size=queue_size,
            holder_size=holder_size, gravity_enabled=gravity, queue_kind=queue_kind,
        )
        self.actions = actions_mapping
        self.rewards = rewards_mapping
        self.render_mode = render_mode
        self.render_scaling_factor = render_upscale
        self.pieces = pieces

        cfg = self.config
        pad = cfg.padding
        hw = (cfg.padded_height, cfg.padded_width)
        max_id = int(np.max(pieces.ids))
        self.observation_space = spaces.Dict(
            {
                "board": spaces.Box(0, max_id, hw, dtype=np.uint8),
                "active_tetromino_mask": spaces.Box(0, 1, hw, dtype=np.uint8),
                "holder": spaces.Box(0, max_id, (pad, pad * holder_size), dtype=np.uint8),
                "queue": spaces.Box(0, max_id, (pad, pad * queue_size), dtype=np.uint8),
            }
        )
        self.action_space = spaces.Discrete(8)

        # A custom action numbering is a host-side translation to the
        # engine's ids; it must be a bijection of 0..7.
        defaults = ActionsMapping()
        user_ids = {name: int(getattr(actions_mapping, name)) for name in ACTION_NAMES}
        bad = {n: i for n, i in user_ids.items() if not 0 <= i < 8}
        if bad:
            raise ValueError(f"actions_mapping ids must be in 0..7, got {bad}")
        if len(set(user_ids.values())) != 8:
            dupes = {
                i: [n for n, j in user_ids.items() if j == i]
                for i in set(user_ids.values())
                if sum(j == i for j in user_ids.values()) > 1
            }
            raise ValueError(f"actions_mapping ids must be distinct, got {dupes}")
        self._action_table = np.zeros(8, dtype=np.int32)
        for name in ACTION_NAMES:
            self._action_table[user_ids[name]] = getattr(defaults, name)

        if pieces is PIECES:
            self._step = engine.jit_step(cfg, rewards=rewards_mapping)
            self._reset = engine.jit_reset(cfg, device=self.device)
            self._rgb = engine.jit_render_rgb(cfg)
            self._observe = engine.jit_observe(cfg)
        else:
            self._step = functools.partial(engine.step, config=cfg, pieces=pieces,
                                           rewards=rewards_mapping)
            self._reset = functools.partial(engine.reset, config=cfg, pieces=pieces,
                                            device=self.device)
            self._rgb = functools.partial(engine.render_rgb, config=cfg, pieces=pieces)
            self._observe = functools.partial(engine.observe_dict, config=cfg, pieces=pieces)
        self.state: Optional[EngineState] = None
        self._window_open = False

    # -- Gymnasium API ------------------------------------------------------

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None
              ) -> Tuple[dict, dict]:
        """Start a new episode; the engine's stream is keyed from ``seed``."""
        super().reset(seed=seed)
        if seed is None:
            seed = int(self.np_random.integers(0, 2**31 - 1))
        self.state, obs = self._reset(threefry.prng_key(seed)[None])
        if self.render_mode == "human":
            self.render()
        return to_numpy(obs), {}

    def step(self, action: int) -> Tuple[dict, float, bool, bool, dict]:
        """One engine step; returns (obs, reward, terminated, truncated, info)."""
        if self.state is None:
            raise RuntimeError("Call reset() before step().")
        # an out-of-range id reaches the engine untranslated: a no-op there
        a = int(action)
        engine_action = self._action_table[a] if 0 <= a < 8 else a
        act = torch.tensor([engine_action], dtype=torch.int32, device=self.device)
        self.state, obs, reward, done, info = self._step(self.state, act)
        if self.render_mode == "human":
            self.render()
        return (to_numpy(obs), float(reward[0]), bool(done[0]), False,
                {"lines_cleared": int(info["lines_cleared"][0])})

    def render(self):
        """Render the current state (``ansi`` string / ``rgb_array`` / window)."""
        if self.render_mode == "ansi":
            return self._render_ansi()
        rgb = self._rgb(self.state)[0].cpu().numpy()
        if self.render_mode == "rgb_array":
            return rgb
        if self.render_mode == "human":
            import cv2

            img = upscale_rgb(torch.from_numpy(rgb), self.render_scaling_factor).numpy()
            cv2.imshow("Tetris", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            cv2.waitKey(1)
            self._window_open = True
        return None

    def close(self):
        """Close any render window."""
        if self._window_open:
            import cv2

            cv2.destroyAllWindows()
            self._window_open = False

    # -- state cloning --------------------------------------------------------

    def get_state(self) -> EngineState:
        """Snapshot of the full env state (the engine never writes a state in place)."""
        return self.state

    def set_state(self, state: EngineState) -> None:
        """Restore a snapshot taken with :meth:`get_state`."""
        self.state = state

    # -- helpers ------------------------------------------------------------

    def _render_ansi(self) -> str:
        """Cell ids as characters (``.`` for empty), padding cropped."""
        board = self._observe(self.state)["board"][0].cpu().numpy()
        pad = self.config.padding
        projection = board[:-pad, pad:-pad]
        char_field = np.where(projection == 0, ".", projection.astype(str))
        return "\n".join("".join(row) for row in char_field)
