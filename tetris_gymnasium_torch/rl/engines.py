"""Engine selection for the RL stacks.

Port of ``tetris_gymnasium_tpu/rl/engines.py:26``.  Only the turbo engine
with board observations is ported; the flagship engine and the ``rgb84``
pixel chain raise ``NotImplementedError`` until their slices land.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.utils.device import resolve_device


def env_fns(
    env_config: EngineConfig,
    impl: str = "turbo",
    rewards: Optional[RewardsMapping] = None,
    obs: str = "board",
    pieces=None,
    device="cuda",
) -> Tuple[Callable, Callable, Callable]:
    """``(init, step, observe)`` batched over the env axis.

    ``init(keys [B, 2])`` makes the state on ``device``; ``step`` and
    ``observe`` run where the state lies.
    """
    if obs not in ("board", "rgb84"):
        raise ValueError(f"unknown observation kind: {obs!r}")
    if impl not in ("turbo", "flagship"):
        raise ValueError(f"unknown engine impl: {impl!r}")
    if impl == "flagship" or obs == "rgb84":
        raise NotImplementedError(
            f"impl={impl!r}, obs={obs!r}: only the turbo engine with board "
            "observations is ported so far"
        )
    device = resolve_device(device)
    rkw = {} if rewards is None else {"rewards": rewards}
    pkw = {} if pieces is None else {"pieces": pieces}
    init = functools.partial(turbo.init, config=env_config, device=device, **pkw)
    step = functools.partial(turbo.step, config=env_config, **rkw, **pkw)
    observe = functools.partial(turbo.observe_board, config=env_config, **pkw)
    return init, step, observe
