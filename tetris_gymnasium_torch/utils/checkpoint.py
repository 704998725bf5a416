"""Load and save network checkpoints as flat ``.npz`` files.

The JAX package saves parameters as an orbax directory, which this port
cannot read without JAX.  ``tools/export_torch_params.py`` turns one into a
plain ``.npz`` of the flat Flax parameter paths
(``results/ppo_lines_params.npz`` for the committed PPO policy); this module
reads that file, and writes the same format for a network the port trained:
the actor-critics (:class:`ActorCriticCNN`, :class:`AtariActorCritic`), the
grouped DQN's :class:`QMLP` and
:class:`QGroupedBoardsCNN`, and the DQN's :class:`QNetworkCNN` and
:class:`AtariQNetwork`.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from tetris_gymnasium_torch.models.convert import from_flax_params, to_flax_params
from tetris_gymnasium_torch.models.networks import (
    ActorCriticCNN, AtariActorCritic, AtariQNetwork, QGroupedBoardsCNN, QMLP, QNetworkCNN,
)
from tetris_gymnasium_torch.utils.device import resolve_device


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """The flat ``{flax/path: array}`` dict of an exported ``.npz``."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def actor_critic_kind(net) -> str:
    """The converter's kind of an actor-critic (``models/convert.py``)."""
    return "atari_actor_critic" if isinstance(net, AtariActorCritic) else "actor_critic"


def flat_actor_critic_kind(flat: Dict[str, np.ndarray]) -> str:
    """The kind of an actor-critic's flat parameters: a value head ``Dense_2``
    beside an 8x8 ``Conv_0`` is the Atari agent's."""
    conv0 = flat.get("params/Conv_0/kernel")
    if "params/Dense_2/kernel" in flat and conv0 is not None and conv0.shape[:2] == (8, 8):
        return "atari_actor_critic"
    return "actor_critic"


def load_actor_critic(
    path: str, device="cuda", dtype: torch.dtype = torch.bfloat16
) -> Union[ActorCriticCNN, AtariActorCritic]:
    """An actor-critic with the exported weights, in eval mode on ``device``.

    The kind (:func:`flat_actor_critic_kind`), the actions, the input
    channels (the frame stack) and the board trunk's widths are read from
    the weights.
    """
    device = resolve_device(device)
    flat = load_flat(path)
    kind = flat_actor_critic_kind(flat)
    sd = from_flax_params(flat, kind)
    if kind == "atari_actor_critic":
        net = AtariActorCritic(n_actions=sd["policy.weight"].shape[0],
                               in_channels=sd["convs.0.weight"].shape[1], dtype=dtype)
    else:
        n = sum(1 for k in sd if k.startswith("encoder.convs.") and k.endswith(".weight"))
        net = ActorCriticCNN(
            n_actions=sd["policy.weight"].shape[0],
            features=[sd[f"encoder.convs.{i}.weight"].shape[0] for i in range(n)],
            in_channels=sd["encoder.convs.0.weight"].shape[1],
            dtype=dtype,
        )
    net.load_state_dict(sd)
    return net.to(device).eval()


def save_actor_critic(path: str, net: Union[ActorCriticCNN, AtariActorCritic]) -> None:
    """Write ``net``'s parameters as the flat float32 ``.npz`` that :func:`load_flat` reads."""
    np.savez(path, **to_flax_params(net.state_dict(), actor_critic_kind(net)))


def load_q_net(path: str, kind: str, device="cuda", dtype: torch.dtype = torch.bfloat16,
               board_shape=(20, 10)):
    """A Q-net with the exported weights, in eval mode on ``device``.

    ``kind`` is ``"qmlp"`` (widths read from the weights), ``"grouped_cnn"``
    (for boards of ``board_shape``, with a ``dtype`` trunk), ``"q_cnn"``
    (the same, with the frame stack and the actions read from the weights)
    or ``"atari_q"`` (84x84 frames; frame stack and actions from the weights).
    """
    device = resolve_device(device)
    sd = from_flax_params(load_flat(path), kind)
    if kind == "qmlp":
        n_hidden = sum(1 for k in sd if k.startswith("hidden.") and k.endswith(".weight"))
        net = QMLP(n_features=sd["hidden.0.weight"].shape[1],
                   hidden=[sd[f"hidden.{i}.weight"].shape[0] for i in range(n_hidden)])
    elif kind == "grouped_cnn":
        net = QGroupedBoardsCNN(board_shape=tuple(board_shape), dtype=dtype)
    elif kind == "q_cnn":
        net = QNetworkCNN(n_actions=sd["head.weight"].shape[0],
                          in_channels=sd["encoder.convs.0.weight"].shape[1],
                          board_shape=tuple(board_shape), dtype=dtype)
    elif kind == "atari_q":
        net = AtariQNetwork(n_actions=sd["head.weight"].shape[0],
                            in_channels=sd["convs.0.weight"].shape[1], dtype=dtype)
    else:
        raise ValueError(f"unknown Q-net kind {kind!r}")
    net.load_state_dict(sd)
    return net.to(device).eval()


def save_q_net(path: str, net, kind: str) -> None:
    """Write a Q-net's parameters as the flat float32 ``.npz`` that :func:`load_flat` reads."""
    np.savez(path, **to_flax_params(net.state_dict(), kind))
