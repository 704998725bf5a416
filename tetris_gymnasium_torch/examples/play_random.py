"""Random agent on the Gymnasium shell, ansi-rendered.

Twin of ``examples/play_random.py``.  The shell is constructed directly
(``Tetris(render_mode="ansi", device=...)``): the card's machine has no
Gymnasium, so no ``gym.make``.  The actions come from a numpy generator
seeded with 0 (the stand-in spaces draw no samples)::

    python -m tetris_gymnasium_torch.examples.play_random [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np


def play(device="cuda", every: int = 50):
    """Plays one game from ``reset(seed=42)``: ``(env, actions)``; prints the
    board every ``every`` steps and at the end."""
    from tetris_gymnasium_torch.envs.gym_env import Tetris

    env = Tetris(render_mode="ansi", device=device)
    env.reset(seed=42)
    rng = np.random.default_rng(0)
    actions, terminated = [], False
    while not terminated:
        action = int(rng.integers(0, env.action_space.n))
        _, _, terminated, _, _ = env.step(action)
        actions.append(action)
        if every and len(actions) % every == 0:
            print(env.render() + "\n")
    print(env.render())
    print(f"Game Over! ({len(actions)} steps)")
    return env, actions


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    return play(p.parse_args(argv).device)


if __name__ == "__main__":
    main()
