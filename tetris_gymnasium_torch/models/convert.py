"""Carry network parameters between Flax and the PyTorch modules.

Flax stores a convolution kernel as HWIO and a dense kernel as
``[in, out]``; PyTorch wants OIHW and ``[out, in]``.  The flat keys are
the Flax parameter paths joined by ``/``, as
``tools/export_torch_params.py`` writes them.  ``kind`` names the network:

* ``"actor_critic"``: :class:`ActorCriticCNN` (``BoardEncoder_0``, the
  policy head ``Dense_0`` and the value head ``Dense_1``);
* ``"qmlp"``: :class:`QMLP` (``Dense_0`` .. ``Dense_{n-1}``, the last one
  the head);
* ``"grouped_cnn"``: :class:`QGroupedBoardsCNN` (``BoardEncoder_0`` and the
  head ``Dense_0``);
* ``"q_cnn"``: :class:`QNetworkCNN`, the same map as ``"grouped_cnn"``;
* ``"atari_q"``: :class:`AtariQNetwork` (``Conv_0`` .. ``Conv_2``, the
  dense layer ``Dense_0`` and the head ``Dense_1``);
* ``"atari_actor_critic"``: :class:`AtariActorCritic` (``Conv_0`` ..
  ``Conv_2``, the trunk's dense layer ``Dense_0``, the policy head
  ``Dense_1`` and the value head ``Dense_2``; unlike ``"actor_critic"``,
  where ``Dense_0`` is the policy head).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_ENC = "params/BoardEncoder_0/"
KINDS = ("actor_critic", "qmlp", "grouped_cnn", "q_cnn", "atari_q", "atari_actor_critic")
_ATARI = ("atari_q", "atari_actor_critic")


def _encoder_map(n_convs: int) -> Dict[str, str]:
    m = {}
    for i in range(n_convs):
        m[f"{_ENC}Conv_{i}/kernel"] = f"encoder.convs.{i}.weight"
        m[f"{_ENC}Conv_{i}/bias"] = f"encoder.convs.{i}.bias"
    m[f"{_ENC}Dense_0/kernel"] = "encoder.dense.weight"
    m[f"{_ENC}Dense_0/bias"] = "encoder.dense.bias"
    return m


def _dense(flax_name: str, torch_name: str) -> Dict[str, str]:
    return {f"params/{flax_name}/kernel": f"{torch_name}.weight",
            f"params/{flax_name}/bias": f"{torch_name}.bias"}


def _key_map(kind: str, n_layers: int) -> Dict[str, str]:
    """Flax path -> ``state_dict`` key; ``n_layers`` counts convolutions (the
    CNNs) or dense layers (``qmlp``)."""
    if kind == "actor_critic":
        return {**_encoder_map(n_layers), **_dense("Dense_0", "policy"), **_dense("Dense_1", "value")}
    if kind in ("grouped_cnn", "q_cnn"):
        return {**_encoder_map(n_layers), **_dense("Dense_0", "head")}
    if kind in _ATARI:
        m = {}
        for i in range(n_layers):
            m.update(_dense(f"Conv_{i}", f"convs.{i}"))
        heads = ({**_dense("Dense_1", "head")} if kind == "atari_q"
                 else {**_dense("Dense_1", "policy"), **_dense("Dense_2", "value")})
        return {**m, **_dense("Dense_0", "dense"), **heads}
    if kind == "qmlp":
        m = {}
        for i in range(n_layers - 1):
            m.update(_dense(f"Dense_{i}", f"hidden.{i}"))
        return {**m, **_dense(f"Dense_{n_layers - 1}", "head")}
    raise ValueError(f"unknown network kind {kind!r}; one of {KINDS}")


def _n_layers_flax(flat, kind: str) -> int:
    prefix = ("params/Dense_" if kind == "qmlp" else "params/Conv_" if kind in _ATARI
              else f"{_ENC}Conv_")
    return sum(1 for k in flat if k.startswith(prefix) and k.endswith("/kernel"))


def _n_layers_torch(state_dict, kind: str) -> int:
    if kind == "qmlp":
        return sum(1 for k in state_dict if k.startswith("hidden.") and k.endswith(".weight")) + 1
    prefix = "convs." if kind in _ATARI else "encoder.convs."
    return sum(1 for k in state_dict if k.startswith(prefix) and k.endswith(".weight"))


def from_flax_params(flat: Dict[str, np.ndarray], kind: str = "actor_critic") -> Dict[str, torch.Tensor]:
    """Flat Flax parameters -> a ``state_dict`` for the ``kind`` network.

    Raises ``KeyError`` on a missing or unexpected key.
    """
    key_map = _key_map(kind, _n_layers_flax(flat, kind))
    unexpected = sorted(set(flat) - set(key_map))
    missing = sorted(set(key_map) - set(flat))
    if unexpected or missing:
        raise KeyError(f"Flax parameters do not match: missing {missing}, unexpected {unexpected}")
    out = {}
    for fk, tk in key_map.items():
        v = np.asarray(flat[fk], dtype=np.float32)
        if fk.endswith("/kernel"):
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T  # HWIO -> OIHW, [in, out] -> [out, in]
        out[tk] = torch.tensor(np.ascontiguousarray(v))
    return out


def to_flax_params(state_dict: Dict[str, torch.Tensor], kind: str = "actor_critic") -> Dict[str, np.ndarray]:
    """Inverse of :func:`from_flax_params`: a ``state_dict`` -> flat float32 Flax parameters."""
    key_map = _key_map(kind, _n_layers_torch(state_dict, kind))
    unexpected = sorted(set(state_dict) - set(key_map.values()))
    missing = sorted(set(key_map.values()) - set(state_dict))
    if unexpected or missing:
        raise KeyError(f"state_dict does not match: missing {missing}, unexpected {unexpected}")
    out = {}
    for fk, tk in key_map.items():
        v = state_dict[tk].detach().to("cpu", torch.float32).numpy()
        if fk.endswith("/kernel"):
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T  # OIHW -> HWIO, [out, in] -> [in, out]
        out[fk] = np.ascontiguousarray(v)
    return out
