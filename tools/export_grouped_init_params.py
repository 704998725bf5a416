"""Export the JAX grouped DQN's initial ``QMLP`` weights to a plain ``.npz`` for the PyTorch port.

``examples/train_lin_grouped.py --seed S`` starts from the weights that
``grouped_dqn.init_grouped_dqn_state(PRNGKey(S), ...)`` draws with Flax's
initialisers.  The port draws its own from a ``torch.Generator`` (equal in
distribution, not in value), so a run of the port that is to follow the JAX
run starts from this file instead
(``python -m tetris_gymnasium_torch.examples.train_lin_grouped --init-params``)::

    python tools/export_grouped_init_params.py --seed 1 \\
        --out results/grouped_qmlp_init_seed1.npz
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def export(seed: int, out: str) -> dict:
    """Write the flat float32 initial parameters of the default 10x20 run with ``seed`` to ``out``."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax

    from tetris_gymnasium_tpu.config import EngineConfig
    from tetris_gymnasium_tpu.models.networks import QMLP
    from tetris_gymnasium_tpu.rl import grouped_dqn

    # the parameters depend on the key and the observation's shape only
    ts = grouped_dqn.init_grouped_dqn_state(
        jax.random.PRNGKey(seed), 2, EngineConfig(gravity_enabled=False, auto_reset=True),
        grouped_dqn.GroupedDQNConfig(buffer_size=4), QMLP(),
    )
    flat = {
        "/".join(str(p.key) for p in path): np.asarray(leaf, dtype=np.float32)
        for path, leaf in jax.tree_util.tree_flatten_with_path(ts.params)[0]
    }
    np.savez(out, **flat)
    return flat


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default=os.path.join(REPO, "results", "grouped_qmlp_init_seed1.npz"))
    args = p.parse_args(argv)
    for k, v in export(args.seed, args.out).items():
        print(f"{k} {v.shape}")


if __name__ == "__main__":
    main()
