"""tetris_gymnasium_torch: the PyTorch and CUDA port of tetris_gymnasium_tpu.

The JAX package beside it is the reference; this package imports ``torch``
and ``numpy`` only, never JAX or the JAX package.  Module names mirror the
JAX package's so that each counterpart is easy to find.

Ported so far (the greedy evaluation of a PPO policy on the turbo engine):

* ``config``, ``pieces``, ``ops.bitboard``: constants and tables;
* ``ops.rng``, ``ops.threefry``, ``components.tetromino_randomizer``,
  ``parallel.mesh.batch_keys``: the RNG streams and per-env keys;
* ``core.turbo``: the turbo engine, whose ``init``, ``step`` and
  ``observe_board`` launch the CUDA kernels of ``kernels`` (sources in
  ``csrc/``) on CUDA tensors and run plain PyTorch versions on CPU tensors;
* ``models``: ``ActorCriticCNN`` and the Flax weight converter;
* ``utils.checkpoint``, ``rl.engines``, ``rl.evaluate``.

Every public entry point takes ``device`` (default ``"cuda"``) and raises
when CUDA is asked for and absent.
"""

from tetris_gymnasium_torch.config import ActionsMapping, EngineConfig, RewardsMapping
from tetris_gymnasium_torch.pieces import PIECES, PieceSet, make_pieces

__all__ = ["ActionsMapping", "EngineConfig", "RewardsMapping", "PIECES", "PieceSet", "make_pieces"]
