"""Grouped (placement) action wrapper for the Gymnasium shell.

Port of ``tetris_gymnasium_tpu/wrappers/grouped.py``: ``Discrete(width *
4)`` actions encoded ``column * 4 + rotation``, per-candidate observations,
the legality mask in ``info["action_mask"]``, illegal actions either
terminating or penalised.  The placements of all candidates are one call of
:mod:`tetris_gymnasium_torch.core.grouped` on the env's device (the
``grouped_flagship`` kernel on the card).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tetris_gymnasium_torch.core import grouped
from tetris_gymnasium_torch.core.grouped import GroupedState
from tetris_gymnasium_torch.envs.api import gym, spaces
from tetris_gymnasium_torch.envs.gym_env import to_numpy
from tetris_gymnasium_torch.ops.observations import sidebar_width
from tetris_gymnasium_torch.wrappers.observation import (
    FeatureVectorObservation,
    RgbObservation,
)


class GroupedActionsObservations(gym.Wrapper, gym.utils.RecordConstructorArgs):
    """Placement-MDP view: actions are (column, rotation) pairs."""

    def __init__(self, env: gym.Env, observation_wrappers: Optional[Sequence[gym.ObservationWrapper]] = None,
                 terminate_on_illegal_action: bool = True, mode: Optional[str] = None):
        gym.utils.RecordConstructorArgs.__init__(
            self, observation_wrappers=observation_wrappers,
            terminate_on_illegal_action=terminate_on_illegal_action, mode=mode)
        super().__init__(env)
        cfg = env.unwrapped.config
        self.config = cfg
        self.terminate_on_illegal_action = terminate_on_illegal_action
        self.observation_wrappers = list(observation_wrappers or [])
        self._device = env.unwrapped.device

        # The inner observation wrappers apply to every candidate, rebuilt as
        # a Dict obs (candidate board, zero active mask, live queue and
        # holder).  A single FeatureVectorObservation or RgbObservation runs
        # batched on the device ("features" / "rgb"); any other chain of
        # observation wrappers runs on the host ("host"); anything else raises.
        if mode is None:
            ws = self.observation_wrappers
            if not ws:
                mode = "boards"
            elif len(ws) == 1 and isinstance(ws[0], FeatureVectorObservation):
                mode = "features"
            elif len(ws) == 1 and isinstance(ws[0], RgbObservation):
                mode = "rgb"
            else:
                for w in ws:
                    if not callable(getattr(w, "observation", None)):
                        raise TypeError(
                            f"inner observation wrapper {w!r} has no .observation(); "
                            "GroupedActionsObservations can only honor "
                            "gym.ObservationWrapper-style inner wrappers")
                mode = "host"
        self.mode = mode

        n_actions = cfg.width * 4
        self.action_space = spaces.Discrete(n_actions)
        high = float(cfg.height * cfg.width)
        obs_dtype = np.float32
        if mode == "features":
            inner = (cfg.width + 3,)
        elif mode == "rgb":
            side = sidebar_width(cfg.padding, cfg.queue_size, cfg.holder_size)
            inner = (cfg.padded_height, cfg.padded_width + side, 3)
            high, obs_dtype = 255.0, np.uint8
        elif mode == "host":
            # the chain's last wrapper defines the per-candidate space, its
            # bounds and dtype, so the illegal sentinel (space.high) stays
            # out of band of ordinary boards
            last_space = self.observation_wrappers[-1].observation_space
            inner = tuple(last_space.shape)
            high = float(np.max(last_space.high))
            obs_dtype = last_space.dtype
        else:
            inner = (cfg.padded_height, cfg.padded_width)
        self.observation_space = spaces.Box(0, high, (n_actions, *inner), dtype=obs_dtype)
        self._obs_dtype = obs_dtype
        self.legal_actions_mask = np.ones(n_actions, dtype=np.float32)

        # the host chain reads the raw per-candidate id boards
        kernel_mode = "boards" if mode == "host" else mode
        self._observe = grouped.jit_observation(cfg, kernel_mode)
        self._step = grouped.jit_step(cfg, kernel_mode, terminate_on_illegal_action)
        self._gstate: Optional[GroupedState] = None

    def _board_info(self, base_obs: dict):
        """The base Dict obs through the inner observation wrappers (``info["board"]``)."""
        board = base_obs
        for wrapper in self.observation_wrappers:
            board = wrapper.observation(board)
        return board

    def _apply_candidates(self, boards: np.ndarray, base_obs: dict) -> np.ndarray:
        """The inner wrappers over every candidate board (the host chain):
        each candidate as a Dict obs (candidate board, zero active mask, the
        live holder and queue), then every wrapper's ``observation()`` in
        order; a FeatureVectorObservation computes from the boards it is
        handed (``features_of_board``, all candidates in one call), not
        from the live state."""
        outs: list = [{
            "board": np.asarray(board),
            "active_tetromino_mask": np.zeros_like(board),
            "holder": base_obs["holder"],
            "queue": base_obs["queue"],
        } for board in boards]
        for w in self.observation_wrappers:
            if isinstance(w, FeatureVectorObservation) and all(isinstance(o, dict) for o in outs):
                outs = list(w.features_of_board(np.stack([o["board"] for o in outs])))
            else:
                outs = [w.observation(o) for o in outs]
        return np.stack([np.asarray(o) for o in outs]).astype(self._obs_dtype)

    def _base_obs(self, env_state) -> dict:
        return to_numpy(self.env.unwrapped._observe(env_state))

    def reset(self, *, seed=None, options=None):
        """Reset the base env and enumerate the first piece's placements."""
        base_obs, info = self.env.reset(seed=seed, options=options)
        env_state = self.env.unwrapped.state
        obs, mask = self._observe(env_state)
        self._gstate = GroupedState(env=env_state, mask=mask)
        self.legal_actions_mask = mask[0].cpu().numpy()
        info["board"] = self._board_info(base_obs)
        info["action_mask"] = self.legal_actions_mask
        if self.mode == "host":
            return self._apply_candidates(obs[0].cpu().numpy(), base_obs), info
        return obs[0].cpu().numpy().astype(self._obs_dtype), info

    def step(self, action: int):
        """Place the active piece at the decoded (column, rotation)."""
        was_legal = bool(self.legal_actions_mask[int(action)])
        act = torch.tensor([int(action)], dtype=torch.int32, device=self._device)
        gstate, obs, reward, done, info = self._step(self._gstate, act)
        self._gstate = gstate
        self.env.unwrapped.state = gstate.env
        self.legal_actions_mask = gstate.mask[0].cpu().numpy()
        out_info = {"action_mask": self.legal_actions_mask,
                    "lines_cleared": int(info["lines_cleared"][0])}
        base_obs = None
        if was_legal:
            base_obs = self._base_obs(gstate.env)
            out_info["board"] = self._board_info(base_obs)
        if self.mode == "host":
            if not was_legal and self.terminate_on_illegal_action:
                # the sentinel: space.high everywhere, no wrapper chain
                obs_out = np.full(self.observation_space.shape,
                                  self.observation_space.high.flat[0], dtype=self._obs_dtype)
            else:
                if base_obs is None:  # the illegal no-op path still observes
                    base_obs = self._base_obs(gstate.env)
                obs_out = self._apply_candidates(obs[0].cpu().numpy(), base_obs)
        else:
            obs_out = obs[0].cpu().numpy().astype(self._obs_dtype)
        return obs_out, float(reward[0]), bool(done[0]), False, out_info

    @staticmethod
    def encode_action(x: int, r: int) -> int:
        """(column, rotation) -> action id."""
        return grouped.encode_action(x, r)

    @staticmethod
    def decode_action(action: int):
        """action id -> (column, rotation)."""
        return grouped.decode_action(np.int32(action))
