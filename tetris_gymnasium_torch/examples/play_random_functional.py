"""Random agent on the compat functional engine, ASCII-rendered.

Port of ``examples/play_random_functional.py``: one env, reset from
``PRNGKey(42)``, then random actions drawn as the JAX example draws them
(``key, sub = split(key)``, ``randint(sub, (), 0, 7)``) until game over,
printing the board every 50 steps.  It plays the same game as the JAX
example.  The env runs on the card (``--device cuda``, the default), where
``fn_reset`` and ``fn_step`` launch the kernels, or on the CPU with
``--device cpu``::

    python -m tetris_gymnasium_torch.examples.play_random_functional --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from tetris_gymnasium_torch.config import EnvConfig
from tetris_gymnasium_torch.core import fn_env
from tetris_gymnasium_torch.ops import threefry

CHARS = {0: ".", 1: "#", -1: "*"}
CONFIG = EnvConfig(width=10, height=20, padding=4, queue_size=7)


def render(obs) -> str:
    return "\n".join("".join(CHARS[int(c)] for c in row) for row in obs)


def play(device="cuda", max_steps=None, every: int = 0) -> dict:
    """Plays one game: ``{"steps", "score", "obs" (the last, int8 numpy),
    "seconds"}``; with ``every`` prints the board every ``every`` steps.
    ``max_steps`` stops a longer game early."""
    reset = fn_env.jit_reset(CONFIG, device)
    step = fn_env.jit_step(CONFIG)
    keys, state, obs = reset(threefry.prng_key(42)[None])
    key = keys[0].cpu().numpy()
    steps, t0 = 0, time.perf_counter()
    while not bool(state.game_over[0]) and (max_steps is None or steps < max_steps):
        key, sub = threefry.split(key)
        action = torch.tensor([threefry.randint(sub, 1, 7)[0]], dtype=torch.int32)
        state, obs, reward, terminated, info = step(state, action.to(state.board.device))
        steps += 1
        if every and steps % every == 0:
            print(f"--- step {steps}, score {float(state.score[0]):.0f} ---")
            print(render(obs[0].cpu()))
    seconds = time.perf_counter() - t0
    return {"steps": steps, "score": float(state.score[0]), "obs": obs[0].cpu().numpy(),
            "seconds": seconds}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    game = play(args.device, every=50)
    print(f"game over after {game['steps']} steps, score {game['score']:.0f}, "
          f"{game['steps'] / game['seconds']:.0f} steps/s (single env, host loop)")
    print(render(game["obs"]))
    return game


if __name__ == "__main__":
    main()
