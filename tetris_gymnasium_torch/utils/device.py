"""Device selection for the port's entry points."""
from __future__ import annotations

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
