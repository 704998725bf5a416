"""How far the small fp32 DQN trainings of ``chip_smoke.py`` (phases 18 and
23) spread between repeats: on the CPU at 1, 2, 4 and the default number of
threads, and on the card with cuDNN's default, deterministic and benchmarked
algorithms.  Each line compares one run's parameter changes with another's,
by leaf: the norm of the difference over the norm of the change, and the
largest single difference over the largest single change.

    python tools/parity_spread.py        # needs one CUDA card; CPU-only rows without
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from tetris_gymnasium_torch.config import EngineConfig  # noqa: E402
from tetris_gymnasium_torch.models.convert import to_flax_params  # noqa: E402
from tetris_gymnasium_torch.models.networks import AtariQNetwork, QNetworkCNN  # noqa: E402
from tetris_gymnasium_torch.ops.threefry import prng_key  # noqa: E402
from tetris_gymnasium_torch.rl import dqn  # noqa: E402
from tetris_gymnasium_torch.utils.checkpoint import load_flat  # noqa: E402


def run(kind, where, threads=None, deterministic=False, benchmark=False) -> dict:
    """Parameter changes of chip_smoke's phase 18 (``q_cnn``) or 23 (``atari_q``)."""
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic, benchmark
    default_threads = torch.get_num_threads()
    torch.set_num_threads(threads or default_threads)
    env_config = EngineConfig(auto_reset=True)
    if kind == "q_cnn":
        cfg, start, steps = dqn.DQNConfig(**cs.SMALL_DQN_CFG), load_flat(cs.DQN_INIT[4]), cs.SMALL_DQN_STEPS
        ts = dqn.init_dqn_state(prng_key(3), 64, env_config, cfg,
                                net=QNetworkCNN(in_channels=4, dtype=torch.float32), device=where,
                                params=start)
        step = dqn.make_train_step(env_config, cfg)
    else:
        cfg, start, steps = dqn.DQNConfig(**cs.SMALL_PIX_CFG), load_flat(cs.PIX_INIT), cs.SMALL_PIX_STEPS
        ts = dqn.init_dqn_state(prng_key(3), cs.SMALL_PIX_ENVS, env_config, cfg,
                                net=AtariQNetwork(in_channels=4, dtype=torch.float32),
                                impl="flagship", obs="rgb84", device=where, params=start)
        step = dqn.make_train_step(env_config, cfg, impl="flagship", obs="rgb84")
    for _ in range(steps):
        ts = step(ts)[0]
    torch.set_num_threads(default_threads)
    torch.backends.cudnn.deterministic = torch.backends.cudnn.benchmark = False
    params = to_flax_params(ts.net.state_dict(), kind)
    return {k: params[k] - p0 for k, p0 in start.items()}


def spread(a, b) -> dict:
    leaves = {}
    for k in b:
        d = a[k] - b[k]
        leaves[k] = {"norm": float(np.linalg.norm(d)) / max(float(np.linalg.norm(b[k])), 1e-30),
                     "elem": float(np.abs(d).max()) / max(float(np.abs(b[k]).max()), 1e-30)}
    return {"norm": max(v["norm"] for v in leaves.values()),
            "elem": max(v["elem"] for v in leaves.values()), "leaves": leaves}


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.is_available()
    for kind in ("q_cnn", "atari_q"):
        runs = {"cpu": run(kind, "cpu"), "cpu_again": run(kind, "cpu")}
        runs.update({f"cpu_{n}_threads": run(kind, "cpu", threads=n) for n in (1, 2, 4)})
        if card:
            runs.update({"cuda": run(kind, "cuda"), "cuda_again": run(kind, "cuda"),
                         "cuda_deterministic": run(kind, "cuda", deterministic=True),
                         "cuda_deterministic_again": run(kind, "cuda", deterministic=True),
                         "cuda_benchmark": run(kind, "cuda", benchmark=True)})
        pairs = [(name, "cpu") for name in runs if name != "cpu"]
        if card:
            pairs += [("cuda_again", "cuda"), ("cuda_deterministic", "cuda"),
                      ("cuda_deterministic_again", "cuda_deterministic")]
        for a, b in pairs:
            print(json.dumps({"net": kind, "run": a, "against": b, **spread(runs[a], runs[b])}),
                  flush=True)


if __name__ == "__main__":
    main()
