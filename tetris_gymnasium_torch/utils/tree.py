"""Per-env select over the fields of a batched state dataclass.

Port of ``tetris_gymnasium_tpu/utils/tree.py:8`` (``select_tree``).  Under
``vmap`` the JAX version's predicate is one scalar per env; here it is
``bool[B]``, broadcast over each field's batch axis: the leading axis, or
the minor one for the fields named in ``minor`` (a counter key ``[2, B]``).
``uint32`` fields are selected through an int32 view (same bits), since
PyTorch has no ``where`` for them on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch


def _where(cond: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint32:
        return torch.where(cond, x.view(torch.int32), y.view(torch.int32)).view(torch.uint32)
    return torch.where(cond, x, y)


def select_tree(pred: torch.Tensor, on_true, on_false, minor=("key",)):
    """Field-wise ``where(pred, on_true, on_false)`` of two dataclasses of one type."""
    out = {}
    for f in dataclasses.fields(on_true):
        x, y = getattr(on_true, f.name), getattr(on_false, f.name)
        if f.name in minor:
            cond = pred
        else:
            cond = pred.reshape(pred.shape + (1,) * (x.ndim - pred.ndim))
        out[f.name] = _where(cond, x, y)
    return type(on_true)(**out)
