"""The Gymnasium names the shell, its wrappers and the vector adapter build on.

Gymnasium's where it is installed; where it is not, the stand-ins of
:mod:`tetris_gymnasium_torch.utils.gym_lite`, so that the shell runs on a
machine with the card and no Gymnasium.  ``VectorEnv`` is None under a
Gymnasium older than 1.1 (no ``AutoresetMode``): no vector adapter there.
"""
try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError:
    from tetris_gymnasium_torch.utils import gym_lite as gym
    from tetris_gymnasium_torch.utils.gym_lite import AutoresetMode, VectorEnv, spaces

    HAVE_GYMNASIUM = False
else:
    HAVE_GYMNASIUM = True
    try:
        from gymnasium.vector import AutoresetMode, VectorEnv
    except ImportError:  # pragma: no cover - gymnasium < 1.1
        AutoresetMode = VectorEnv = None

__all__ = ["gym", "spaces", "AutoresetMode", "VectorEnv", "HAVE_GYMNASIUM"]
