"""Observation wrappers for the Gymnasium shell.

Port of ``tetris_gymnasium_tpu/wrappers/observation.py``: the pixel and
feature math is the engine's own (:mod:`tetris_gymnasium_torch.ops.observations`),
on the env's device (the ``compose_rgb`` and ``feature_vector`` kernels on
the card); the wrapper is only the numpy boundary.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tetris_gymnasium_torch.core import engine
from tetris_gymnasium_torch.envs.api import gym, spaces
from tetris_gymnasium_torch.ops.observations import (
    FeatureFlags,
    compose_rgb,
    feature_vector,
    n_features,
    sidebar_width,
    upscale_rgb,
)
from tetris_gymnasium_torch.pieces import PIECES


def _device_of(env: gym.Env) -> torch.device:
    return getattr(env.unwrapped, "device", torch.device("cpu"))


class RgbObservation(gym.ObservationWrapper, gym.utils.RecordConstructorArgs):
    """Dict obs -> one RGB image (board left, queue and holder sidebar right)."""

    def __init__(self, env: gym.Env):
        gym.utils.RecordConstructorArgs.__init__(self)
        super().__init__(env)
        cfg = env.unwrapped.config
        side = sidebar_width(cfg.padding, cfg.queue_size, cfg.holder_size)
        self.observation_space = spaces.Box(
            0, 255, (cfg.padded_height, cfg.padded_width + side, 3), dtype=np.uint8)
        # the env's own piece set: custom pieces change the palette
        pieces = getattr(env.unwrapped, "pieces", PIECES)
        self._pieces = pieces
        self._device = _device_of(env)
        self._render_rgb = functools.partial(engine.render_rgb, config=cfg, pieces=pieces)

    def observation(self, observation: dict) -> np.ndarray:
        """Composite the Dict observation into one RGB frame."""
        parts = [torch.as_tensor(np.asarray(observation[k]))[None].to(self._device)
                 for k in ("board", "queue", "holder")]
        return compose_rgb(*parts, self._pieces)[0].cpu().numpy()

    def render(self):
        """Upscaled RGB rendering of the composite observation."""
        rgb = self._render_rgb(self.env.unwrapped.state)[0]
        img = upscale_rgb(rgb, self.env.unwrapped.render_scaling_factor).cpu().numpy()
        if self.render_mode == "rgb_array":
            return img
        if self.render_mode == "human":
            import cv2

            cv2.imshow("Tetris", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            cv2.waitKey(1)
        return None


class FeatureVectorObservation(gym.ObservationWrapper, gym.utils.RecordConstructorArgs):
    """Dict obs -> the feature vector (heights, max height, holes, bumpiness)
    of the locked stack: the engine state's board, without the active piece."""

    def __init__(self, env: gym.Env, report_height: bool = True, report_max_height: bool = True,
                 report_holes: bool = True, report_bumpiness: bool = True):
        gym.utils.RecordConstructorArgs.__init__(
            self, report_height=report_height, report_max_height=report_max_height,
            report_holes=report_holes, report_bumpiness=report_bumpiness)
        super().__init__(env)
        cfg = env.unwrapped.config
        self.flags = FeatureFlags(height=report_height, max_height=report_max_height,
                                  holes=report_holes, bumpiness=report_bumpiness)
        # bounds that hold every reachable value: heights <= H, holes <= H * W,
        # bumpiness <= H * (W - 1)
        high = cfg.height * cfg.width
        dtype = np.uint8 if high <= np.iinfo(np.uint8).max else np.int32
        self.observation_space = spaces.Box(0, high, (n_features(cfg.width, self.flags),),
                                            dtype=dtype)
        self._pad = cfg.padding
        self._device = _device_of(env)

    def _features(self, board: torch.Tensor) -> np.ndarray:
        """Features of padded boards ``[N, H_pad, W_pad]``, as the space's dtype."""
        pad = self._pad
        out = feature_vector(board[:, :-pad, pad:-pad], self.flags)
        return out.cpu().numpy().astype(self.observation_space.dtype)

    def observation(self, observation: dict) -> np.ndarray:
        """Feature vector of the engine state's raw board (the stack without the piece)."""
        return self._features(self.env.unwrapped.state.board)[0]

    def features_of_board(self, board) -> np.ndarray:
        """Feature vector of an explicit padded board ``[H_pad, W_pad]`` (no
        active piece), or the vectors ``[N, n]`` of a stack ``[N, H_pad,
        W_pad]`` in one call: the grouped wrapper's host chain hands all its
        candidate boards here at once."""
        board = np.asarray(board)
        if self._device.type == "cuda" and board.dtype != np.int8:
            board = board.astype(np.int8)  # the kernel reads int8 ids
        one = board.ndim == 2
        out = self._features(torch.as_tensor(board[None] if one else board).to(self._device))
        return out[0] if one else out
