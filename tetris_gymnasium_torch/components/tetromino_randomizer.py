"""Piece randomizers: pure draw functions, plain PyTorch versions.

Port of ``tetris_gymnasium_tpu/components/tetromino_randomizer.py:35-110``.
A draw is ``(bag, bag_index, key) -> (piece, bag, bag_index, key)`` with
the batch as the minor axis: ``bag int32[n, B]``, ``bag_index int32[B]``,
``key [2, B]`` in int64 lanes (see :mod:`tetris_gymnasium_torch.ops.rng`).
The ``turbo_step`` CUDA kernel carries the same two strategies as device
functions.
"""
from __future__ import annotations

from typing import Callable, Tuple

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


def get_draw_fn(name: str) -> DrawFn:
    """Resolve a draw strategy by its ``EngineConfig.queue_kind`` name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown queue_kind {name!r}; known: {sorted(_REGISTRY)}") from None
