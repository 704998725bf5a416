"""Piece randomizers: pure draw functions and the host-side classes.

Port of ``tetris_gymnasium_tpu/components/tetromino_randomizer.py``: the
draw functions (``:35-110``), their registry, and the host classes
``Randomizer``, ``BagRandomizer`` and ``TrueRandomizer`` (``:123-204``),
seeded with numpy's ``default_rng(SeedSequence(seed))`` as the JAX
package's are, so that the host streams are equal.
A draw is ``(bag, bag_index, key) -> (piece, bag, bag_index, key)`` with
the batch as the minor axis: ``bag int32[n, B]``, ``bag_index int32[B]``,
``key [2, B]`` in int64 lanes (see :mod:`tetris_gymnasium_torch.ops.rng`).
The ``turbo_step`` CUDA kernel carries the same two strategies as device
functions.
"""
from __future__ import annotations

import warnings
from abc import abstractmethod
from typing import Callable, Tuple

import numpy as np
import torch

from tetris_gymnasium_torch.ops import rng as orng

DrawFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor],
    Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
]


def bag_draw(bag, bag_index, key):
    """7-bag draw: pop the bag, reshuffle it when it is exhausted.

    The key advances only on a refill, as in the JAX version.
    """
    n = bag.shape[0]
    need = bag_index >= n
    new_key, fresh = orng.shuffle(key, n)
    bag = torch.where(need, fresh, bag)
    idx = torch.where(need, 0, bag_index)
    lane = torch.arange(n, dtype=torch.int32, device=bag.device).reshape((n,) + (1,) * idx.ndim)
    piece = torch.where(lane == idx, bag, 0).sum(dim=0, dtype=torch.int32)
    key = torch.where(need, new_key, key)
    return piece, bag, (idx + 1).to(torch.int32), key


def uniform_draw(bag, bag_index, key):
    """Uniform i.i.d. draw over all pieces; the bag passes through."""
    key, piece = orng.randint(key, int(bag.shape[0]))
    return piece, bag, bag_index, key


_REGISTRY = {"bag": bag_draw, "uniform": uniform_draw}


def register_randomizer(name: str, draw: DrawFn) -> None:
    """Register a custom draw strategy under ``name`` (same signature as
    :func:`bag_draw`); ``EngineConfig(queue_kind=name)`` then selects it on
    the plain versions.  The kernels carry the built-in two only."""
    if name in _REGISTRY:
        warnings.warn(f"re-registering randomizer {name!r}", RuntimeWarning, stacklevel=2)
    _REGISTRY[name] = draw


def unregister_randomizer(name: str) -> None:
    """Remove a registered strategy (the built-in ``bag`` and ``uniform`` stay)."""
    if name not in ("bag", "uniform"):
        _REGISTRY.pop(name, None)


def get_draw_fn(name: str) -> DrawFn:
    """Resolve a draw strategy by its ``EngineConfig.queue_kind`` name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown queue_kind {name!r}; known: {sorted(_REGISTRY)}") from None


# -- host-side classes (reference API) ----------------------------------------


class Randomizer:
    """Abstract randomizer: yields the index of the next piece.

    The seed is honoured only on the first seeded ``reset`` after
    construction.  ``engine_kind`` names the registered draw strategy the
    engine uses when this randomizer is injected into the shell.
    """

    engine_kind: str = "bag"

    def __init__(self, size: int):
        self.size = size
        self.rng = None

    @abstractmethod
    def get_next_tetromino(self) -> int:
        """Return the index of the next piece (host-side sampling)."""

    def reset(self, seed=None):
        """Gymnasium-style seeding: only the first seeded reset re-keys."""
        if seed and seed > 0:
            self.rng = np.random.default_rng(np.random.SeedSequence(seed))
        elif self.rng is None:
            self.rng = np.random.default_rng()


class BagRandomizer(Randomizer):
    """7-bag randomizer."""

    engine_kind = "bag"

    def __init__(self, size: int):
        super().__init__(size)
        self.bag = np.arange(self.size, dtype=np.int8)
        self.index = 0

    def get_next_tetromino(self) -> int:
        piece = int(self.bag[self.index])
        self.index += 1
        if self.index >= len(self.bag):
            self.shuffle_bag()
        return piece

    def shuffle_bag(self):
        """Reshuffle in place and restart."""
        self.rng.shuffle(self.bag)
        self.index = 0

    def reset(self, seed=None):
        """Re-seed (first call only) and reshuffle a fresh bag."""
        super().reset(seed)
        self.bag = np.arange(self.size, dtype=np.int8)
        self.shuffle_bag()

    def __copy__(self) -> "BagRandomizer":
        new = BagRandomizer(self.size)
        new.rng = np.random.default_rng()
        new.rng.bit_generator.state = self.rng.bit_generator.state
        new.bag = self.bag.copy()
        new.index = self.index
        return new


class TrueRandomizer(Randomizer):
    """Uniform i.i.d. randomizer."""

    engine_kind = "uniform"

    def get_next_tetromino(self) -> int:
        return int(self.rng.integers(0, self.size))

    def reset(self, seed=None):
        """Only the RNG is (first-call) re-seeded; no other state exists."""
        super().reset(seed)

    def __copy__(self) -> "TrueRandomizer":
        new = TrueRandomizer(self.size)
        new.rng = np.random.default_rng()
        new.rng.bit_generator.state = self.rng.bit_generator.state
        return new
