"""The compat engine's piece queues: the 7-bag and the uniform sampler, batched.

Port of ``tetris_gymnasium_tpu/ops/queue.py`` (``QueueFns :31``,
``create_bag :41``, ``bag_next :50``, ``create_uniform :76``,
``uniform_next :90``), bit-equal to it on the port's threefry
(:mod:`tetris_gymnasium_torch.ops.threefry`).  Every function takes a batch:
``queue int32[B, queue_size]``, ``queue_index int32[B]`` and keys as int64
lanes ``[B, 2]`` holding 32-bit words (PyTorch has no ``uint32`` arithmetic
on the CPU; :func:`tetris_gymnasium_torch.core.turbo.u32_to_lanes` converts).

The key discipline is the reference's: on a refill (``queue_index >=
queue_size``) the key splits into ``(new_key, subkey)``, the fresh queue is
drawn with ``subkey`` and ``new_key`` is returned; otherwise the key passes
through.  ``queue_size`` is both the bag length and the number of distinct
pieces, and the uniform queue keeps the reference's off-by-one upper bound
``queue_size - 1``.  On the card the ``fn_reset`` and ``fn_step`` kernels
draw the queue themselves.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tetris_gymnasium_torch.ops import threefry


class QueueFns(NamedTuple):
    """A queue strategy: ``create(config, keys) -> (queue, queue_index)`` and
    ``next_piece(config, queue, queue_index, keys) -> (piece, queue, queue_index, keys)``."""

    create: Callable
    next_piece: Callable


def create_bag(config, key: torch.Tensor):
    """Fresh bags (``:41``): a permutation of ``arange(queue_size)`` per env."""
    queue = threefry.permutation_keyed(key, config.queue_size).to(torch.int32)
    return queue, torch.zeros(key.shape[:-1], dtype=torch.int32, device=key.device)


def create_uniform(config, key: torch.Tensor):
    """Uniform queues (``:76``): ``randint(0, queue_size - 1)`` per slot, so
    the last piece never appears (the reference's off-by-one)."""
    queue = threefry.randint_keyed(key, config.queue_size, config.queue_size - 1).to(torch.int32)
    return queue, torch.zeros(key.shape[:-1], dtype=torch.int32, device=key.device)


def _next(create, config, queue, queue_index, key):
    """Draw from the queue, refilled from ``create`` with the subkey where it is spent."""
    refill = queue_index >= config.queue_size
    halves = threefry.split_keyed(key)
    new_key, subkey = halves[..., 0, :], halves[..., 1, :]
    fresh, _ = create(config, subkey)
    out_queue = torch.where(refill[:, None], fresh, queue)
    idx = torch.where(refill, 0, queue_index)
    # JAX's dynamic index: a negative one wraps, then it is clamped
    n = out_queue.shape[1]
    at = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1).long()
    piece = out_queue.gather(1, at[:, None])[:, 0]
    out_key = torch.where(refill[:, None], new_key, key)
    return piece, out_queue, (idx + 1).to(torch.int32), out_key


def bag_next(config, queue: torch.Tensor, queue_index: torch.Tensor, key: torch.Tensor):
    """Draw the next piece from the bag, reshuffling when it is spent (``:50``):
    ``(piece, queue, queue_index, key)``."""
    return _next(create_bag, config, queue, queue_index, key)


def uniform_next(config, queue: torch.Tensor, queue_index: torch.Tensor, key: torch.Tensor):
    """Draw from the uniform queue, refilling when it is spent (``:90``)."""
    return _next(create_uniform, config, queue, queue_index, key)


BAG_QUEUE = QueueFns(create=create_bag, next_piece=bag_next)
UNIFORM_QUEUE = QueueFns(create=create_uniform, next_piece=uniform_next)
