"""Export an orbax ``ActorCriticCNN`` checkpoint to a plain ``.npz`` for the PyTorch port.

The port (``tetris_gymnasium_torch``) does not import JAX, so it cannot read
orbax directories.  This tool restores the checkpoint with the JAX package,
using the template ``ActorCriticCNN().init(PRNGKey(0), zeros((1, H, W), int8))``,
and writes every parameter under its flat Flax path
(``params/BoardEncoder_0/Conv_0/kernel``, ...) as float32::

    python tools/export_torch_params.py --checkpoint results/ppo_lines.npz \\
        --out results/ppo_lines_params.npz
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def export(checkpoint: str, out: str, height: int = 20, width: int = 10) -> dict:
    """Restore ``checkpoint`` and write its flat float32 parameters to ``out``."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.models import ActorCriticCNN
    from tetris_gymnasium_tpu.utils import checkpoint as ckpt

    net = ActorCriticCNN()
    template = net.init(jax.random.PRNGKey(0), jnp.zeros((1, height, width), jnp.int8))
    params = ckpt.restore(checkpoint, template)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(str(p.key) for p in path)
        flat[name] = np.asarray(leaf, dtype=np.float32)
    np.savez(out, **flat)
    return flat


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=os.path.join(REPO, "results", "ppo_lines.npz"))
    p.add_argument("--out", default=os.path.join(REPO, "results", "ppo_lines_params.npz"))
    args = p.parse_args(argv)
    flat = export(args.checkpoint, args.out)
    for k, v in flat.items():
        print(f"{k} {v.shape}")


if __name__ == "__main__":
    main()
