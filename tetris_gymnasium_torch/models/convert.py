"""Carry ``ActorCriticCNN`` parameters between Flax and the PyTorch module.

Flax stores a convolution kernel as HWIO and a dense kernel as
``[in, out]``; PyTorch wants OIHW and ``[out, in]``.  The flat keys are
the Flax parameter paths joined by ``/``, as
``tools/export_torch_params.py`` writes them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_ENC = "params/BoardEncoder_0/"


def _key_map(n_convs: int) -> Dict[str, str]:
    m = {}
    for i in range(n_convs):
        m[f"{_ENC}Conv_{i}/kernel"] = f"encoder.convs.{i}.weight"
        m[f"{_ENC}Conv_{i}/bias"] = f"encoder.convs.{i}.bias"
    m[f"{_ENC}Dense_0/kernel"] = "encoder.dense.weight"
    m[f"{_ENC}Dense_0/bias"] = "encoder.dense.bias"
    m["params/Dense_0/kernel"] = "policy.weight"
    m["params/Dense_0/bias"] = "policy.bias"
    m["params/Dense_1/kernel"] = "value.weight"
    m["params/Dense_1/bias"] = "value.bias"
    return m


def from_flax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat Flax parameters -> a ``state_dict`` for :class:`ActorCriticCNN`.

    Raises ``KeyError`` on a missing or unexpected key.
    """
    n_convs = sum(1 for k in flat if k.startswith(f"{_ENC}Conv_") and k.endswith("/kernel"))
    key_map = _key_map(n_convs)
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


def to_flax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`from_flax_params`: a ``state_dict`` -> flat float32 Flax parameters."""
    n_convs = sum(1 for k in state_dict if k.startswith("encoder.convs.") and k.endswith(".weight"))
    key_map = _key_map(n_convs)
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
