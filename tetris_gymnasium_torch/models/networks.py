"""Networks: the conv trunk, the PPO actor-critic and the Q-nets.

Port of ``tetris_gymnasium_tpu/models/networks.py`` (``BoardEncoder :25``,
``QNetworkCNN :61``, ``AtariQNetwork :76``, ``AtariActorCritic :108``,
``ActorCriticCNN :146``, ``QMLP :174``, ``QGroupedBoardsCNN :193``).  As in
the JAX package, parameters are float32 and the trunk computes in ``dtype``
(bfloat16 by default) while the heads compute in float32.  Two details
keep the outputs equal to Flax's:

* Flax ``padding="SAME"`` pads a stride-2 convolution asymmetrically (the
  extra row or column goes at the end), so each convolution pads
  explicitly with ``F.pad`` and then runs with ``padding=0``;
* the dense layer after the trunk reads the features in NHWC order
  ``(h, w, c)``, as Flax flattens them.

The convolutions and dense layers are PyTorch's own operators; the JAX
package leaves them to XLA outside any kernel.  Weights from a Flax
checkpoint come in through :mod:`tetris_gymnasium_torch.models.convert`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int, int]:
    """Flax/XLA ``SAME`` padding ``(before, after)`` and the output size."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2, out


class BoardEncoder(nn.Module):
    """Conv trunk over a ``[B, H, W]`` board (values -1/0/1) or a ``[B, K, H, W]`` stack.

    Three 3x3 convolutions (strides (2,1), (2,2), (2,2) by default), each
    followed by ReLU, then a 512-wide dense layer with ReLU.
    """

    def __init__(
        self,
        in_channels: int = 1,
        features: Sequence[int] = (32, 64, 128),
        strides=None,
        board_shape: Tuple[int, int] = (20, 10),
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.dtype = dtype
        h, w = board_shape
        c = in_channels
        convs, pads = [], []
        for i, feat in enumerate(features):
            if strides is None:
                stride = (2, 1) if i == 0 else (2, 2)
            else:
                stride = tuple(strides[i])
            top, bottom, h = same_pads(h, 3, stride[0])
            left, right, w = same_pads(w, 3, stride[1])
            convs.append(nn.Conv2d(c, feat, 3, stride=stride))
            pads.append((left, right, top, bottom))
            c = feat
        self.convs = nn.ModuleList(convs)
        self.pads = pads
        self.dense = nn.Linear(c * h * w, 512)

    def forward(self, boards: torch.Tensor) -> torch.Tensor:
        x = boards.to(self.dtype)
        if x.ndim == 3:
            x = x[:, None]  # [B, 1, H, W]; a [B, K, H, W] stack is K channels already
        for conv, pad in zip(self.convs, self.pads):
            x = F.conv2d(
                F.pad(x, pad), conv.weight.to(self.dtype), conv.bias.to(self.dtype), conv.stride
            )
            x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten, as Flax
        x = F.linear(x, self.dense.weight.to(self.dtype), self.dense.bias.to(self.dtype))
        return F.relu(x)


class QNetworkCNN(nn.Module):
    """DQN value network: ``[B, H, W]`` board or ``[B, K, H, W]`` window -> Q ``f32[B, n_actions]``.

    A :class:`BoardEncoder` over ``in_channels`` (the frame stack's K) in
    ``dtype``, then a float32 head.
    """

    def __init__(
        self,
        n_actions: int = 8,
        in_channels: int = 1,
        board_shape: Tuple[int, int] = (20, 10),
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.encoder = BoardEncoder(in_channels, board_shape=board_shape, dtype=dtype)
        self.head = nn.Linear(512, n_actions)

    def forward(self, boards: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(boards).to(torch.float32))


class _AtariTrunk(nn.Module):
    """The Atari trunk over 84x84 gray frames that :class:`AtariQNetwork`
    and :class:`AtariActorCritic` share (JAX ``networks.py:105-141``).

    Convolutions 32@8x8/4, 64@4x4/2 and 64@3x3/1 with VALID padding, each
    followed by ReLU, then a 512-wide dense layer with ReLU, all in
    ``dtype``.  The input, ``[B, 84, 84]`` or a ``[B, K, 84, 84]`` window
    (uint8), is scaled as ``frames.to(dtype) / 255`` in ``dtype``, as Flax
    divides by a bf16 255; the dense layer reads the features in NHWC order.
    """

    PLAN = ((32, 8, 4), (64, 4, 2), (64, 3, 1))

    def __init__(self, in_channels: int, frame_shape, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        h, w = frame_shape
        c = in_channels
        convs = []
        for feat, k, stride in self.PLAN:
            convs.append(nn.Conv2d(c, feat, k, stride=stride))
            h, w, c = (h - k) // stride + 1, (w - k) // stride + 1, feat
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(c * h * w, 512)

    def trunk(self, frames: torch.Tensor) -> torch.Tensor:
        """The 512 features ``[B, 512]`` in ``dtype``."""
        x = frames.to(self.dtype)
        if x.ndim == 3:
            x = x[:, None]
        x = x / 255.0  # in dtype: 255 is exact in bf16, as Flax's bf16 divisor
        for conv in self.convs:
            x = F.relu(F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype), conv.stride))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten, as Flax
        return F.relu(F.linear(x, self.dense.weight.to(self.dtype), self.dense.bias.to(self.dtype)))


class AtariQNetwork(_AtariTrunk):
    """The reference CNN workload's Q-net over 84x84 gray frames: ``[B, 84,
    84]`` or a ``[B, K, 84, 84]`` window (uint8) -> Q ``f32[B, n_actions]``.

    The Atari trunk in ``dtype``, then a float32 head.
    """

    def __init__(self, n_actions: int = 8, in_channels: int = 1, frame_shape=(84, 84),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_channels, frame_shape, dtype)
        self.head = nn.Linear(512, n_actions)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(frames).to(torch.float32))


class AtariActorCritic(_AtariTrunk):
    """The reference PPO workload's agent over 84x84 gray frames (JAX
    ``networks.py:108``): ``[B, 84, 84]`` or a ``[B, K, 84, 84]`` window
    (uint8) -> ``(logits f32[B, n_actions], value f32[B])``.

    The Atari trunk in ``dtype``, then a float32 policy head and a float32
    value head over the float32 cast of its features.
    """

    def __init__(self, n_actions: int = 8, in_channels: int = 1, frame_shape=(84, 84),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_channels, frame_shape, dtype)
        self.policy = nn.Linear(512, n_actions)
        self.value = nn.Linear(512, 1)

    def forward(self, frames: torch.Tensor):
        h = self.trunk(frames).to(torch.float32)
        return self.policy(h), self.value(h).squeeze(-1)


class ActorCriticCNN(nn.Module):
    """PPO actor-critic: shared conv trunk, float32 policy and value heads.

    ``forward(boards) -> (logits f32[B, n_actions], value f32[B])``.
    """

    def __init__(
        self,
        n_actions: int = 8,
        features: Sequence[int] = (32, 64, 128),
        strides=None,
        in_channels: int = 1,
        board_shape: Tuple[int, int] = (20, 10),
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.encoder = BoardEncoder(in_channels, features, strides, board_shape, dtype)
        self.policy = nn.Linear(512, n_actions)
        self.value = nn.Linear(512, 1)

    def forward(self, boards: torch.Tensor):
        h = self.encoder(boards).to(torch.float32)
        return self.policy(h), self.value(h).squeeze(-1)


class QMLP(nn.Module):
    """Per-candidate Q-net over placement features: ``[..., F] -> [...]``.

    Dense layers of widths ``hidden`` with ReLU, then a scalar head, all in
    float32; applied to ``[B, A, F]`` it scores every candidate, ``[B, A]``.
    """

    def __init__(self, n_features: int = 13, hidden: Sequence[int] = (64, 64)):
        super().__init__()
        widths = [n_features, *hidden]
        self.hidden = nn.ModuleList(nn.Linear(i, o) for i, o in zip(widths, widths[1:]))
        self.head = nn.Linear(widths[-1], 1)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features.to(torch.float32)
        for layer in self.hidden:
            x = F.relu(layer(x))
        return self.head(x).squeeze(-1)


class QGroupedBoardsCNN(nn.Module):
    """Per-candidate board-image Q-net: ``[B, A, H, W] -> [B, A]``.

    The candidate axis folds into the conv batch, so all ``B * A`` boards
    go through one :class:`BoardEncoder` (``dtype`` trunk), then a float32
    scalar head.
    """

    def __init__(self, board_shape: Tuple[int, int] = (20, 10), dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.encoder = BoardEncoder(board_shape=board_shape, dtype=dtype)
        self.head = nn.Linear(512, 1)

    def forward(self, boards: torch.Tensor) -> torch.Tensor:
        lead = boards.shape[:-2]
        h = self.encoder(boards.reshape((-1,) + tuple(boards.shape[-2:]))).to(torch.float32)
        return self.head(h).reshape(lead)
