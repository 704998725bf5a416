"""Device selection for the port's entry points, and constant tables on a device."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and absent.

    Every public entry point defaults to ``"cuda"``. There is no silent CPU
    path: callers that want the CPU (the tests) pass ``device="cpu"``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return device


_CONSTANTS: dict = {}


def constant(array, device, dtype=None) -> torch.Tensor:
    """The numpy table ``array`` as a tensor on ``device``, made once and
    cached: a plain version run on the card then copies no table from the
    host on each call, and can be captured in a CUDA graph."""
    a = np.asarray(array)
    key = (a.dtype.str, a.shape, a.tobytes(), str(torch.device(device)), dtype)
    hit = _CONSTANTS.get(key)
    if hit is None:
        hit = _CONSTANTS[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return hit
