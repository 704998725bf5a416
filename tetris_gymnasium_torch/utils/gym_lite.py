"""Stand-ins for the part of the Gymnasium API that the shell, its wrappers
and the vector adapter build on, for a machine that has PyTorch and no
Gymnasium (the card's machine need not have it).

:mod:`tetris_gymnasium_torch.envs.api` takes Gymnasium where it is
installed and these classes where it is not.  They carry only what the port
uses: ``Env`` (its ``np_random`` seeded as Gymnasium seeds it,
``PCG64(SeedSequence(seed))``), ``Wrapper``, ``ObservationWrapper``,
``RecordConstructorArgs``, the ``Box``, ``Discrete``, ``MultiDiscrete`` and
``Dict`` spaces (bounds and ``contains``, no sampling), ``VectorEnv`` and
``AutoresetMode``.  ``gym.make`` and the registry are Gymnasium's alone.
``tests/test_torch_gym_env.py`` holds the shell, its wrappers and the vector
adapter on these stand-ins equal to the same classes on Gymnasium.
"""
from __future__ import annotations

import enum
from typing import Any, Optional

import numpy as np


# -- spaces -------------------------------------------------------------------


class Space:
    def __init__(self, shape=None, dtype=None):
        self.shape = None if shape is None else tuple(shape)
        self.dtype = None if dtype is None else np.dtype(dtype)


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        shape = tuple(shape) if shape is not None else np.shape(low)
        super().__init__(shape, dtype)
        self.low = np.full(shape, low, dtype=self.dtype)
        self.high = np.full(shape, high, dtype=self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all(x >= self.low) and np.all(x <= self.high))


class Discrete(Space):
    def __init__(self, n: int, start: int = 0):
        super().__init__((), np.int64)
        self.n, self.start = int(n), int(start)

    def contains(self, x) -> bool:
        return self.start <= int(x) < self.start + self.n


class MultiDiscrete(Space):
    def __init__(self, nvec, start=None):
        self.nvec = np.asarray(nvec, dtype=np.int64)
        super().__init__(self.nvec.shape, np.int64)
        self.start = np.zeros_like(self.nvec) if start is None else np.asarray(start, dtype=np.int64)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all((x >= self.start) & (x < self.start + self.nvec)))


class Dict(Space):
    def __init__(self, spaces: dict):
        super().__init__()
        self.spaces = dict(spaces)

    def __getitem__(self, key):
        return self.spaces[key]

    def contains(self, x) -> bool:
        return isinstance(x, dict) and x.keys() == self.spaces.keys() \
            and all(s.contains(x[k]) for k, s in self.spaces.items())


class _Spaces:
    """The ``gymnasium.spaces`` names."""

    Box, Discrete, MultiDiscrete, Dict = Box, Discrete, MultiDiscrete, Dict


spaces = _Spaces()


# -- environments and wrappers ----------------------------------------------------


class RecordConstructorArgs:
    def __init__(self, **kwargs: Any):
        if not hasattr(self, "_saved_kwargs"):
            self._saved_kwargs = kwargs


class _Utils:
    RecordConstructorArgs = RecordConstructorArgs


utils = _Utils()


class Env:
    render_mode: Optional[str] = None
    _np_random = None

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._np_random = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np.random.Generator(np.random.PCG64(np.random.SeedSequence()))
        return self._np_random

    @property
    def unwrapped(self) -> "Env":
        return self


class Wrapper(Env):
    def __init__(self, env: Env):
        self.env = env
        self._observation_space = None
        self._action_space = None

    @property
    def observation_space(self):
        return self._observation_space if self._observation_space is not None \
            else self.env.observation_space

    @observation_space.setter
    def observation_space(self, space):
        self._observation_space = space

    @property
    def action_space(self):
        return self._action_space if self._action_space is not None else self.env.action_space

    @action_space.setter
    def action_space(self, space):
        self._action_space = space

    @property
    def render_mode(self):
        return self.env.render_mode

    @property
    def unwrapped(self) -> Env:
        return self.env.unwrapped

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        return self.env.step(action)

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()


class ObservationWrapper(Wrapper):
    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self.observation(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self.observation(obs), reward, terminated, truncated, info

    def observation(self, observation):
        raise NotImplementedError


# -- the vector API -------------------------------------------------------------------


class AutoresetMode(enum.Enum):
    NEXT_STEP = "NextStep"
    SAME_STEP = "SameStep"
    DISABLED = "Disabled"


class VectorEnv:
    closed = False

    def close(self, **kwargs):
        if not self.closed:
            self.close_extras(**kwargs)
            self.closed = True

    def close_extras(self, **kwargs):
        pass

    @property
    def unwrapped(self) -> "VectorEnv":
        return self
