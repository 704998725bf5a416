"""Gymnasium ``VectorEnv`` adapter over the batched engines.

Port of ``tetris_gymnasium_tpu/envs/vector_env.py``: one object with the
``gymnasium.vector.VectorEnv`` API (numpy in, numpy out) whose ``step`` is
the whole batch on the card, ``impl="turbo"`` (the ``turbo_step`` kernel)
or ``impl="flagship"`` (``flagship_step``), with the board observation
``int8[B, height, width]``.

Autoreset is Gymnasium's ``AutoresetMode.SAME_STEP``: a terminated env's
returned observation is the first of its next episode, and the terminal one
is in ``infos["final_obs"]`` (an object array, None for the live envs) with
the ``infos["_final_obs"]`` mask.  The engine steps with
``auto_reset=False``; a fresh batch is initialised every step from
``fold_in(base_key, epoch)`` and selected in where ``done``, as the JAX
program does, so the host only moves observations.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.envs.api import AutoresetMode, VectorEnv, spaces
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.rl.engines import env_fns
from tetris_gymnasium_torch.utils.device import resolve_device
from tetris_gymnasium_torch.utils.tree import select_tree


def _programs(config: EngineConfig, impl: str, num_envs: int, pieces, device):
    """``(reset, step)`` over the whole batch.

    ``reset(base_key, epoch) -> (states, obs)``; ``step(states, actions,
    base_key, epoch) -> (states', obs', reward, terminated, final_obs,
    lines)``, where ``states'`` and ``obs'`` already hold the same-step
    restart of the terminated envs and ``final_obs`` is the observation
    before it.  Per-env keys are ``fold_in(fold_in(base_key, epoch), env)``.
    """
    init, step, observe = env_fns(config, impl, pieces=pieces, device=device)
    select = turbo.select_tree if impl == "turbo" else select_tree

    def keys_for(base_key, epoch):
        return batch_keys(threefry.fold_in(base_key, np.uint32(epoch)), num_envs, device=device)

    def reset_fn(base_key, epoch):
        states = init(keys_for(base_key, epoch))
        return states, observe(states)

    def step_fn(states, actions, base_key, epoch):
        states2, _, reward, done, info = step(states, actions)
        final_obs = observe(states2)
        fresh = init(keys_for(base_key, epoch))
        states3 = select(done, fresh, states2)
        return states3, observe(states3), reward, done, final_obs, info["lines_cleared"]

    return reset_fn, step_fn


class _KeyEpochs:
    """Host-side (base key, epoch) counter: one key per (re)seed and an
    epoch that counts the resets and steps."""

    __slots__ = ("base_key", "epoch")

    def __init__(self, seed: int):
        self.base_key = threefry.prng_key(seed)
        self.epoch = 0

    def next(self):
        e = self.epoch
        self.epoch += 1
        return self.base_key, e


class TetrisVectorEnv(VectorEnv):
    """A ``gymnasium.vector.VectorEnv`` whose batch lives on the card.

    Args:
        num_envs: batch size.
        config: engine geometry and behaviour, any width and height;
            ``auto_reset`` is ignored (the adapter restarts the envs
            itself, to report terminal observations).
        impl: ``"turbo"`` (bit-packed) or ``"flagship"`` (id boards).
        seed: base seed of the per-env streams.
        tetrominoes: optional custom piece list (``components.Tetromino``);
            it sets ``config.padding`` to the set's box size.  Both engines
            take any set; on the card the kernels are built for it at first
            use, within the limits of ``kernels.engine_defines``.
        device: where the batch lives (default ``"cuda"``).
    """

    metadata = {"autoreset_mode": AutoresetMode.SAME_STEP, "render_modes": []}

    def __init__(self, num_envs: int, config: EngineConfig = EngineConfig(), impl: str = "turbo",
                 seed: int = 0, tetrominoes=None, device="cuda"):
        config = config._replace(auto_reset=False)
        self._pieces = None
        if tetrominoes is not None:
            from tetris_gymnasium_torch.components.tetromino import pieces_from_tetrominoes

            self._pieces, pad = pieces_from_tetrominoes(tetrominoes)
            config = config._replace(padding=pad)
        self.num_envs = int(num_envs)
        self.config = config
        self.impl = impl
        self.device = resolve_device(device)
        self._keys = _KeyEpochs(seed)
        self._reset_fn, self._step_fn = _programs(config, impl, self.num_envs, self._pieces,
                                                  self.device)
        self._states = None

        H, W = config.height, config.width
        self.single_observation_space = spaces.Box(low=-1, high=1, shape=(H, W), dtype=np.int8)
        self.single_action_space = spaces.Discrete(8)
        self.observation_space = spaces.Box(low=-1, high=1, shape=(self.num_envs, H, W),
                                            dtype=np.int8)
        self.action_space = spaces.MultiDiscrete([8] * self.num_envs)

    # -- VectorEnv API -------------------------------------------------------
    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._keys = _KeyEpochs(seed)
        states, obs = self._reset_fn(*self._keys.next())
        self._states = states
        return obs.cpu().numpy(), {}

    def step(self, actions):
        if self._states is None:
            raise RuntimeError("call reset() before step()")
        actions = torch.as_tensor(np.asarray(actions, dtype=np.int32)).to(self.device)
        states, obs, reward, done, final_obs, lines = self._step_fn(
            self._states, actions, *self._keys.next())
        self._states = states
        terminated = done.cpu().numpy()
        infos = {
            "lines_cleared": lines.cpu().numpy(),
            "_lines_cleared": np.ones(self.num_envs, dtype=bool),
        }
        if terminated.any():
            # SAME_STEP's final_obs: an object array, None for the live envs
            fo = final_obs.cpu().numpy()
            obj = np.full(self.num_envs, None, dtype=object)
            for i in np.nonzero(terminated)[0]:
                obj[i] = fo[i]
            infos["final_obs"] = obj
            infos["_final_obs"] = terminated
        return (
            obs.cpu().numpy(),
            reward.cpu().numpy(),
            terminated,
            np.zeros(self.num_envs, dtype=bool),  # no truncation (no step limit)
            infos,
        )

    def render(self):
        raise NotImplementedError(
            "use tetris_gymnasium_torch.envs.gym_env or engine.render_rgb for rendering")

    def close_extras(self, **kwargs):
        self._states = None
