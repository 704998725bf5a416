"""Human keyboard play via an OpenCV window.

Twin of ``examples/play_interactive.py``, with its key map (a/d/s move, e/q
rotate, space hard drop, c swap, r restart, esc or x quit).  It constructs
``Tetris(render_mode="human", device=...)`` directly: the card's machine
has no Gymnasium.  Needs ``cv2`` and a display::

    python -m tetris_gymnasium_torch.examples.play_interactive [--device cpu]
"""
from __future__ import annotations

import argparse

KEY_TO_ACTION = {
    ord("a"): 0,  # left
    ord("d"): 1,  # right
    ord("s"): 2,  # down
    ord("e"): 3,  # rotate cw
    ord("q"): 4,  # rotate ccw
    ord(" "): 5,  # hard drop
    ord("c"): 6,  # swap
}


def play(device="cuda"):
    """Plays until game over or a quit key; returns the env."""
    import cv2

    from tetris_gymnasium_torch.envs.gym_env import Tetris

    env = Tetris(render_mode="human", device=device)
    env.reset(seed=42)
    terminated = False
    while not terminated:
        env.render()
        key = cv2.waitKey(0)
        if key == ord("r"):
            env.reset()
            continue
        if key in (27, ord("x")):  # esc / x: quit
            break
        action = KEY_TO_ACTION.get(key)
        if action is None:
            continue
        _, reward, terminated, _, _ = env.step(action)
    print("Game Over!")
    env.close()
    return env


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    return play(p.parse_args(argv).device)


if __name__ == "__main__":
    main()
