"""Observation functions: the feature vector and the RGB composite, batched.

Port of ``tetris_gymnasium_tpu/ops/observations.py``: ``column_heights
:17``, ``max_height :29``, ``bumpiness :34``, ``holes :40``,
``FeatureFlags :48``, ``feature_vector :57``, ``sidebar_width :79``,
``compose_rgb :84`` and ``upscale_rgb :128``.  A playfield is ``[B, H, W]``
with the batch leading.

:func:`feature_vector` and :func:`compose_rgb` dispatch on the device of
their input: on CUDA tensors they launch the ``feature_vector`` and
``compose_rgb`` kernels of :mod:`tetris_gymnasium_torch.kernels` (or raise),
on CPU tensors they run the plain versions here (``*_plain``), which also
run on CUDA tensors when called by name.  The composite puts the board on
the left, the queue strip at the top right and the holder strip at the
bottom right, separated by bedrock, and colours the id image through the
palette.  On the card the whole chain from the engine state to the 84x84
gray frame is one more kernel, ``render_rgb84``
(:func:`tetris_gymnasium_torch.core.engine.render_rgb84`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tetris_gymnasium_torch.pieces import PieceSet
from tetris_gymnasium_torch.utils.device import constant


def column_heights(playfield: torch.Tensor) -> torch.Tensor:
    """Stack height per column, ``int32[B, W]``: ``H`` less the row of the
    topmost non-empty cell, 0 for an empty column."""
    H = playfield.shape[1]
    filled = playfield != 0
    heights = H - filled.to(torch.uint8).argmax(dim=1)  # the first filled row from the top
    return torch.where(filled.any(dim=1), heights, 0).to(torch.int32)


def max_height(playfield: torch.Tensor) -> torch.Tensor:
    """Tallest column, ``int32[B]``."""
    return column_heights(playfield).amax(dim=1)


def bumpiness(playfield: torch.Tensor) -> torch.Tensor:
    """Sum of the absolute height differences of neighbouring columns, ``int32[B]``."""
    return column_heights(playfield).diff(dim=1).abs().sum(dim=1, dtype=torch.int32)


def holes(playfield: torch.Tensor) -> torch.Tensor:
    """Empty cells with a filled cell somewhere above them, ``int32[B]``."""
    filled = playfield != 0
    covered = torch.cumsum(filled.to(torch.int32), dim=1) > 0
    return (~filled & covered).flatten(1).sum(dim=1, dtype=torch.int32)


class FeatureFlags(NamedTuple):
    """Which features to report."""

    height: bool = True
    max_height: bool = True
    holes: bool = True
    bumpiness: bool = True


def n_features(width: int, flags: FeatureFlags = FeatureFlags()) -> int:
    """Length of the feature vector of a ``width``-column playfield under ``flags``."""
    return (width if flags.height else 0) + int(flags.max_height) + int(flags.holes) \
        + int(flags.bumpiness)


def feature_vector_plain(playfield: torch.Tensor, flags: FeatureFlags = FeatureFlags()) -> torch.Tensor:
    """Plain version of :func:`feature_vector`, on any device."""
    parts = []
    if flags.height or flags.max_height:
        h = column_heights(playfield)
        if flags.height:
            parts.append(h)
        if flags.max_height:
            parts.append(h.amax(dim=1, keepdim=True))
    if flags.holes:
        parts.append(holes(playfield)[:, None])
    if flags.bumpiness:
        parts.append(bumpiness(playfield)[:, None])
    if not parts:
        return torch.zeros((playfield.shape[0], 0), dtype=torch.int32, device=playfield.device)
    return torch.cat(parts, dim=1).to(torch.int32)


def feature_vector(playfield: torch.Tensor, flags: FeatureFlags = FeatureFlags()) -> torch.Tensor:
    """Concatenated features of a cropped playfield ``[B, H, W]`` (no active
    piece): heights, max height, holes, bumpiness as ``flags`` ask,
    ``int32[B, n]``.  On CUDA tensors the ``feature_vector`` kernel computes
    them; it reads the crop of a padded board in place, at any row and batch
    stride."""
    if playfield.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.feature_vector(playfield, flags)
    return feature_vector_plain(playfield, flags)


def sidebar_width(padding: int, queue_size: int, holder_size: int) -> int:
    """Width of the queue and holder sidebar in the composite image."""
    return max(queue_size, holder_size) * padding


def compose_rgb_plain(board: torch.Tensor, queue_strip: torch.Tensor, holder_strip: torch.Tensor,
                      pieces: PieceSet, group: int = 1) -> torch.Tensor:
    """Plain version of :func:`compose_rgb`, on any device."""
    if group != 1:
        queue_strip = queue_strip.repeat_interleave(group, dim=0)
        holder_strip = holder_strip.repeat_interleave(group, dim=0)
    pad_h = queue_strip.shape[1]
    side_w = max(queue_strip.shape[2], holder_strip.shape[2])
    if board.shape[1] < 2 * pad_h:  # JAX's bedrock separator would have a negative height
        raise TypeError(f"compose_rgb: a board of {board.shape[1]} rows is lower than the "
                        f"sidebar's two {pad_h}-row strips")

    def widen(strip):
        return F.pad(strip, (0, side_w - strip.shape[2]), value=1)

    sep = torch.ones((board.shape[0], board.shape[1] - 2 * pad_h, side_w), dtype=board.dtype,
                     device=board.device)
    sidebar = torch.cat([widen(queue_strip), sep, widen(holder_strip)], dim=1)
    ids = torch.cat([board, sidebar], dim=2).long()
    palette = constant(pieces.palette, board.device)  # [n, 3] uint8
    n = palette.shape[0]
    rgb = palette[ids.clamp(max=n - 1)]
    return torch.where((ids < n)[..., None], rgb, torch.zeros_like(rgb))


def compose_rgb(board: torch.Tensor, queue_strip: torch.Tensor, holder_strip: torch.Tensor,
                pieces: PieceSet, group: int = 1) -> torch.Tensor:
    """One RGB image per board: ``uint8[N, H_pad, W_pad + sidebar, 3]``.

    ``board`` is ``uint8[N, H_pad, W_pad]`` (the active piece stamped in),
    ``queue_strip`` ``[M, padding, padding * queue_size]`` and
    ``holder_strip`` ``[M, padding, padding * holder_size]``, ``N = M *
    group``: board ``n`` takes the strips of ``n // group`` (the grouped
    engine's ``group`` candidates of one env).  An id outside the palette is
    black, as the JAX version's one-hot contraction gives.  The strips are
    widened with bedrock (id 1) to a common width and stacked with bedrock
    rows between them, beside the board.  On CUDA tensors the
    ``compose_rgb`` kernel computes it.
    """
    if board.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.compose_rgb(board, queue_strip, holder_strip, pieces, group)
    return compose_rgb_plain(board, queue_strip, holder_strip, pieces, group)


def upscale_rgb(rgb: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upscale of ``[..., H, W, C]`` images by ``factor``."""
    return rgb.repeat_interleave(factor, dim=-3).repeat_interleave(factor, dim=-2)
