"""Frame stacking: a rolling ``[B, K, H, W]`` window of the newest observations.

Port of ``tetris_gymnasium_tpu/ops/framestack.py`` (``init :29``, ``push
:37``).  The window is oldest first (``stack[:, -1]`` is the newest frame),
and a fresh episode's window is its first observation repeated K times,
Gymnasium ``FrameStack``'s reset.  Replay stores single frames and rebuilds
windows at sample time (:func:`tetris_gymnasium_torch.rl.buffers.sample_with_next_stacked`).

:func:`push` dispatches on the window's device: on CUDA the
``framestack_push`` kernel of :mod:`tetris_gymnasium_torch.kernels` runs, on
the CPU :func:`push_plain`.
"""
from __future__ import annotations

import torch


def init(obs: torch.Tensor, k: int) -> torch.Tensor:
    """Reset window: ``[B, H, W] -> [B, K, H, W]``, the first observation repeated K times."""
    return obs[:, None].repeat_interleave(k, dim=1)


def push_plain(stack: torch.Tensor, obs: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`push`, on any device."""
    rolled = torch.cat([stack[:, 1:], obs[:, None]], dim=1)
    fresh = init(obs, stack.shape[1])
    return torch.where(done.reshape((-1,) + (1,) * (stack.ndim - 1)), fresh, rolled)


def push(stack: torch.Tensor, obs: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """Roll ``obs`` in as the newest frame; restart the window where ``done``.

    Under auto-reset a ``done`` env's ``obs`` is the next episode's first
    observation, so its window restarts as that frame repeated K times
    instead of mixing two episodes.  Returns a new window.
    """
    if stack.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.framestack_push(stack, obs, done)
    return push_plain(stack, obs, done)
