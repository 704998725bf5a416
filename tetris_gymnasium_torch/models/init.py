"""Flax's default initialisers for the PyTorch networks.

Port of the initialisers the networks get in the JAX package
(``tetris_gymnasium_tpu/models/networks.py``):

* every convolution and dense kernel: Flax's default ``lecun_normal``, a
  normal truncated at two standard deviations and rescaled so that its
  variance is ``1 / fan_in``, except
* ``ActorCriticCNN``'s and ``AtariActorCritic``'s policy heads,
  ``orthogonal(0.01)``, and value heads, ``orthogonal(1.0)`` (``:108-171``);
* every bias: zero.

``QNetworkCNN`` (``:61``), ``AtariQNetwork`` (``:76``), ``QMLP`` (``:174``)
and ``QGroupedBoardsCNN`` (``:193``) take the defaults throughout.

The draws come from an explicit ``torch.Generator``, so they match Flax's
in distribution, not bit for bit; parameters carried across from JAX go in
through :mod:`tetris_gymnasium_torch.models.convert` instead.
"""
from __future__ import annotations

import math

import torch
from torch import nn

# std of a standard normal truncated to [-2, 2] (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Truncated normal of variance ``1 / fan_in`` (fan_in = all dims but the first)."""
    std = math.sqrt(1.0 / math.prod(weight.shape[1:])) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_actor_critic_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise an :class:`ActorCriticCNN` or an :class:`AtariActorCritic`
    in place as Flax would; returns it.

    PyTorch's ``orthogonal_`` makes the rows of an ``[out, in]`` weight
    orthonormal, which are the columns of Flax's ``[in, out]`` kernel.
    """
    trunk = getattr(net, "encoder", net)  # the BoardEncoder, or the Atari net's own layers
    for layer in (*trunk.convs, trunk.dense):
        lecun_normal_(layer.weight, generator)
    nn.init.orthogonal_(net.policy.weight, 0.01, generator=generator)
    nn.init.orthogonal_(net.value.weight, 1.0, generator=generator)
    for layer in (*trunk.convs, trunk.dense, net.policy, net.value):
        nn.init.zeros_(layer.bias)
    return net


def init_lecun_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's defaults for every layer of ``net`` (a :class:`QMLP`,
    :class:`QGroupedBoardsCNN`, :class:`QNetworkCNN` or
    :class:`AtariQNetwork`): ``lecun_normal`` weights, zero biases; returns it."""
    for layer in net.modules():
        if isinstance(layer, (nn.Linear, nn.Conv2d)):
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
    return net
