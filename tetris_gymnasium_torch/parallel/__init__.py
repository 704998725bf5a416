"""Env-batch sharding over ``torch.distributed``, per-env keys, the launcher.

The JAX package's ``env_sharding`` and ``replicated`` name XLA shardings;
here a rank holds its slice of an env-batched state (:func:`shard_env`,
:func:`gather_env`) and the whole of a replicated one.
"""
from tetris_gymnasium_torch.parallel.mesh import (
    EnvMesh,
    batch_keys,
    env_mesh,
    gather_env,
    initialize_distributed,
    shard_env,
    sharded_random_rollout,
    sharded_reset,
    sharded_step,
    state_checksum,
)

__all__ = [
    "EnvMesh",
    "batch_keys",
    "env_mesh",
    "gather_env",
    "initialize_distributed",
    "shard_env",
    "sharded_random_rollout",
    "sharded_reset",
    "sharded_step",
    "state_checksum",
]
