"""Gymnasium environment shell and its registration.

Registers ``"tetris_gymnasium_torch/Tetris"`` (the port of
``tetris_gymnasium_tpu/envs/__init__.py``; no ``max_episode_steps``, as in
the reference) where Gymnasium is installed.  ``gym.make(
"tetris_gymnasium_torch/Tetris", device="cpu")`` runs the plain versions;
the default device is the card.  Without Gymnasium the classes still run,
on the stand-ins of :mod:`tetris_gymnasium_torch.envs.api`.
"""
from tetris_gymnasium_torch.envs.api import HAVE_GYMNASIUM, VectorEnv
from tetris_gymnasium_torch.envs.gym_env import Tetris

# The vector adapter needs gymnasium >= 1.1 (AutoresetMode); the single-env
# shell keeps importing on an older gymnasium.
if VectorEnv is None:  # pragma: no cover - old gymnasium only
    __all__ = ["Tetris"]
else:
    from tetris_gymnasium_torch.envs.vector_env import TetrisVectorEnv

    __all__ = ["Tetris", "TetrisVectorEnv"]

if HAVE_GYMNASIUM:
    from gymnasium.envs.registration import register

    register(
        id="tetris_gymnasium_torch/Tetris",
        entry_point="tetris_gymnasium_torch.envs.gym_env:Tetris",
    )
