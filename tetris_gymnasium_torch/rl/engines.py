"""Engine selection for the RL stacks: the turbo engine or the flagship engine.

Port of ``tetris_gymnasium_tpu/rl/engines.py:26``.  ``impl="turbo"`` is the
batch-minor bit-packed engine (:mod:`tetris_gymnasium_torch.core.turbo`);
``impl="flagship"`` the batch-leading engine with id boards
(:mod:`tetris_gymnasium_torch.core.engine`), which also renders the
reference CNN workload's frames.  Both take per-env keys ``uint32[B, 2]``
and give the same board observations.  ``obs`` is:

* ``"board"``: the ``int8[B, H, W]`` board with the active piece as -1;
* ``"rgb84"``: the reference chain RGB -> 84x84 INTER_AREA -> grayscale,
  ``uint8[B, 84, 84]`` (one ``render_rgb84`` kernel on the card); flagship
  only, since the turbo engine's rows carry no cell ids to colour.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import engine, turbo
from tetris_gymnasium_torch.utils.device import resolve_device


def env_fns(
    env_config: EngineConfig,
    impl: str = "turbo",
    rewards: Optional[RewardsMapping] = None,
    obs: str = "board",
    pieces=None,
    device="cuda",
    step_obs: bool = False,
) -> Tuple[Callable, Callable, Callable]:
    """``(init, step, observe)`` batched over the env axis.

    ``init(keys [B, 2])`` makes the state on ``device``; ``step`` and
    ``observe`` run where the state lies.  ``step`` returns ``(state, obs,
    reward, done, info)`` with ``obs`` None, except with ``step_obs`` on the
    turbo engine's board observation: there ``obs`` is ``observe(state)``,
    written by the step's own launch on the card.
    """
    if obs not in ("board", "rgb84"):
        raise ValueError(f"unknown observation kind: {obs!r}")
    if impl not in ("turbo", "flagship"):
        raise ValueError(f"unknown engine impl: {impl!r}")
    if obs == "rgb84" and impl != "flagship":
        raise ValueError(
            "obs='rgb84' needs the flagship engine (id boards for the RGB palette); "
            "the turbo engine stores binary rows only"
        )
    device = resolve_device(device)
    rkw = {} if rewards is None else {"rewards": rewards}
    pkw = {} if pieces is None else {"pieces": pieces}
    mod = turbo if impl == "turbo" else engine
    init = functools.partial(mod.init, config=env_config, device=device, **pkw)
    # the flagship step builds no Dict obs here: observe() makes the one asked for
    okw = {"obs_fn": engine.no_obs} if impl == "flagship" else {}
    if step_obs and impl == "turbo" and obs == "board":
        okw = {"obs_fn": turbo.observe_board}
    step = functools.partial(mod.step, config=env_config, **rkw, **pkw, **okw)
    observe_fn = engine.render_rgb84 if obs == "rgb84" else mod.observe_board
    observe = functools.partial(observe_fn, config=env_config, **pkw)
    return init, step, observe
