"""Where a ``TetrisVectorEnv`` step's time goes, on one CUDA card.

Repeats the body of ``TetrisVectorEnv.step`` (``envs/vector_env.py``: the
actions' copy to the card, the engine step, the terminal observation, the
fresh batch's keys and init, the restart select, the returned observation,
the copies back to numpy and the terminal observations' object array) part
by part, with the card synchronised after each part, so that a part's wall
time includes its kernels; also times the unsplit ``env.step``.  One JSON
line per (geometry, engine): each part's host ms to return (``enqueue``) and
ms until the card is done (``wall``), means over the steps.

    python tools/profile_vector_env.py [--envs 8192] [--steps 64]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from tetris_gymnasium_torch.config import EngineConfig  # noqa: E402
from tetris_gymnasium_torch.core import turbo  # noqa: E402
from tetris_gymnasium_torch.envs import TetrisVectorEnv  # noqa: E402
from tetris_gymnasium_torch.ops import threefry  # noqa: E402
from tetris_gymnasium_torch.parallel.mesh import batch_keys  # noqa: E402
from tetris_gymnasium_torch.rl.engines import env_fns  # noqa: E402
from tetris_gymnasium_torch.utils.tree import select_tree  # noqa: E402

class Parts:
    """Host and wall ms of named parts, the card synchronised after each."""

    def __init__(self):
        self.enqueue, self.wall = {}, {}

    def __call__(self, name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        self.enqueue[name] = self.enqueue.get(name, 0.0) + 1e3 * (t1 - t0)
        self.wall[name] = self.wall.get(name, 0.0) + 1e3 * (t2 - t0)
        return out


def split_step(env, fns, parts, actions):
    """``env.step(actions)``'s work, part by part (``vector_env._programs``'s
    ``step_fn`` and ``TetrisVectorEnv.step``)."""
    init, step, observe = fns
    select = turbo.select_tree if env.impl == "turbo" else select_tree
    base_key, epoch = env._keys.next()
    a = parts("actions_to_card", lambda: torch.as_tensor(np.asarray(actions, dtype=np.int32)).to(env.device))
    states2, _, reward, done, info = parts("engine_step", lambda: step(env._states, a))
    final_obs = parts("observe_terminal", lambda: observe(states2))
    keys = parts("fresh_keys", lambda: batch_keys(threefry.fold_in(base_key, np.uint32(epoch)),
                                                  env.num_envs, device=env.device))
    fresh = parts("fresh_init", lambda: init(keys))
    env._states = parts("restart_select", lambda: select(done, fresh, states2))
    obs = parts("observe", lambda: observe(env._states))
    terminated = parts("done_to_host", lambda: done.cpu().numpy())
    parts("lines_to_host", lambda: info["lines_cleared"].cpu().numpy())
    if terminated.any():
        fo = parts("final_obs_to_host", lambda: final_obs.cpu().numpy())

        def objects():
            obj = np.full(env.num_envs, None, dtype=object)
            for i in np.nonzero(terminated)[0]:
                obj[i] = fo[i]
            return obj

        parts("final_obs_objects", objects)
    parts("obs_to_host", lambda: obs.cpu().numpy())
    parts("reward_to_host", lambda: reward.cpu().numpy())


def profile(width, height, impl, n_envs, steps) -> dict:
    config = EngineConfig(width=width, height=height)
    env = TetrisVectorEnv(n_envs, config, impl=impl, seed=7, device="cuda")
    fns = env_fns(env.config, impl, pieces=None, device=env.device)
    rng = np.random.default_rng(7)
    acts = [rng.choice(8, n_envs, p=cs.FLAGSHIP_ACTION_P) for _ in range(2 * steps + 8)]
    env.reset(seed=7)
    for a in acts[:8]:  # warm: kernels built and loaded
        env.step(a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ends = 0
    for a in acts[8 : 8 + steps]:
        ends += int(env.step(a)[2].sum())
    whole = 1e3 * (time.perf_counter() - t0) / steps
    parts = Parts()
    for a in acts[8 + steps :]:
        split_step(env, fns, parts, a)
    return {"width": width, "height": height, "impl": impl, "B": n_envs, "steps": steps,
            "step_ms": whole, "episodes_ended_per_step": ends / steps,
            "split_sum_ms": sum(parts.wall.values()) / steps,
            "wall_ms": {k: v / steps for k, v in parts.wall.items()},
            "enqueue_ms": {k: v / steps for k, v in parts.enqueue.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_vector_env.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for width, height in ((10, 20), (30, 20)):
        for impl in ("turbo", "flagship"):
            print(json.dumps({**profile(width, height, impl, args.envs, args.steps), "nvidia_smi": smi}),
                  flush=True)


if __name__ == "__main__":
    main()
