"""tetris_gymnasium_torch: the PyTorch and CUDA port of tetris_gymnasium_tpu.

The JAX package beside it is the reference; this package imports ``torch``
and ``numpy`` only, never JAX or the JAX package.  Module names mirror the
JAX package's so that each counterpart is easy to find.

Ported so far:

* ``config``, ``pieces``, ``ops.bitboard``, ``ops.board``: constants, tables
  and the bit operations;
* ``ops.rng``, ``ops.threefry``, ``components.tetromino_randomizer``,
  ``parallel.mesh.batch_keys``: the RNG streams and per-env keys;
* ``core.turbo``, ``core.turbo_grouped``, ``core.engine`` (the flagship
  engine with its id boards), ``core.grouped`` (its placement MDP) and
  ``core.fn_env`` (the compat functional engine, with ``ops.queue``),
  whose entry points launch the CUDA kernels of ``kernels`` (sources in
  ``csrc/``) on CUDA tensors and run plain PyTorch versions on CPU tensors;
* ``ops.observations``, ``ops.image``, ``ops.framestack``: the feature
  vector, the RGB composite, the 84x84 gray frames (and the exact
  grayscale) and frame stacks;
* ``envs`` (the Gymnasium shell ``Tetris``, registered as
  ``tetris_gymnasium_torch/Tetris``, and ``TetrisVectorEnv``), ``wrappers``
  and ``components`` (the host piece model, queue, holder, randomizers);
* ``models``: the networks and the Flax weight converter;
* ``rl`` (PPO, the grouped DQN, the DQN, replay, evaluation), ``examples``
  (the training scripts and ``play_random_functional``) and ``utils``.

Every public entry point takes ``device`` (default ``"cuda"``) and raises
when CUDA is asked for and absent.
"""

from tetris_gymnasium_torch.config import ActionsMapping, EngineConfig, EnvConfig, RewardsMapping
from tetris_gymnasium_torch.pieces import PIECES, PieceSet, make_pieces

__all__ = ["ActionsMapping", "EngineConfig", "EnvConfig", "RewardsMapping", "PIECES", "PieceSet", "make_pieces"]
