"""Per-env keys, folded from one base key by global env index.

Port of ``batch_keys`` (``tetris_gymnasium_tpu/parallel/mesh.py:47``).  The
multi-device part of that module is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.utils.device import resolve_device


def batch_keys(base_key, n_envs: int, device="cuda") -> torch.Tensor:
    """Per-env keys ``uint32[n_envs, 2]``: env ``i`` gets ``fold_in(base, i)``.

    ``base_key`` is a ``uint32[2]`` key, e.g. ``threefry.prng_key(seed)``.
    """
    device = resolve_device(device)
    keys = threefry.fold_in(np.asarray(base_key, dtype=np.uint32), np.arange(n_envs, dtype=np.uint32))
    return torch.from_numpy(keys).to(device)
