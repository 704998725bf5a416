"""The RGB composite of the flagship engine's observation, batched, plain PyTorch.

Port of ``tetris_gymnasium_tpu/ops/observations.py`` (``sidebar_width :79``,
``compose_rgb :84``).  The composite puts the board on the left, the queue
strip at the top right and the holder strip at the bottom right, separated
by bedrock, and colours the id image through the palette.  On the card the
whole chain from the engine state to the 84x84 gray frame is one kernel,
``render_rgb84`` (:func:`tetris_gymnasium_torch.core.engine.render_rgb84`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tetris_gymnasium_torch.pieces import PieceSet
from tetris_gymnasium_torch.utils.device import constant


def sidebar_width(padding: int, queue_size: int, holder_size: int) -> int:
    """Width of the queue and holder sidebar in the composite image."""
    return max(queue_size, holder_size) * padding


def compose_rgb(board: torch.Tensor, queue_strip: torch.Tensor, holder_strip: torch.Tensor,
                pieces: PieceSet) -> torch.Tensor:
    """One RGB image per env: ``uint8[B, H_pad, W_pad + sidebar, 3]``.

    ``board`` is ``uint8[B, H_pad, W_pad]`` (the active piece stamped in),
    ``queue_strip`` ``[B, padding, padding * queue_size]`` and
    ``holder_strip`` ``[B, padding, padding * holder_size]``.  An id outside
    the palette is black, as the JAX version's one-hot contraction gives.
    The strips are widened with bedrock (id 1) to a common width and
    stacked with bedrock rows between them, beside the board.
    """
    pad_h = queue_strip.shape[1]
    side_w = max(queue_strip.shape[2], holder_strip.shape[2])

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
