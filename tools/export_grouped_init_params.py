"""Export a JAX run's initial network weights to a plain ``.npz`` for the PyTorch port.

``examples/train_lin_grouped.py --seed S`` starts from the ``QMLP`` weights
that ``grouped_dqn.init_grouped_dqn_state(PRNGKey(S), ...)`` draws with
Flax's initialisers (``--net qmlp``), ``examples/train_cnn.py --seed S
[--frame-stack K]`` from the ``QNetworkCNN`` weights of
``dqn.init_dqn_state(PRNGKey(S), ..., impl="turbo")`` (``--net q_cnn``),
and ``examples/train_cnn.py --obs rgb84 --seed S [--frame-stack K]`` from
the ``AtariQNetwork`` weights of ``dqn.init_dqn_state(PRNGKey(S), ...,
AtariQNetwork(), impl="flagship", obs="rgb84")`` (``--net atari_q``);
``examples/train_ppo.py --seed S [--frame-stack K]`` from the
``ActorCriticCNN`` weights of ``ppo.init_train_state(PRNGKey(S), ...,
impl="turbo")`` (``--net actor_critic``), and ``examples/train_ppo.py
--obs rgb84 --seed S [--frame-stack K]`` from the ``AtariActorCritic``
weights of ``ppo.init_train_state(PRNGKey(S), ..., AtariActorCritic(),
impl="flagship", obs="rgb84")`` (``--net atari_actor_critic``).
The port draws its own from a ``torch.Generator`` (equal in distribution,
not in value), so a run of the port that is to follow the JAX run starts
from this file instead (``--init-params`` of
``python -m tetris_gymnasium_torch.examples.train_lin_grouped``,
``.train_cnn`` or ``.train_ppo``)::

    python tools/export_grouped_init_params.py --seed 1 \\
        --out results/grouped_qmlp_init_seed1.npz
    python tools/export_grouped_init_params.py --net q_cnn --seed 1 \\
        --out results/qcnn_init_seed1.npz
    python tools/export_grouped_init_params.py --net q_cnn --frame-stack 4 --seed 1 \\
        --out results/qcnn_k4_init_seed1.npz
    python tools/export_grouped_init_params.py --net atari_q --frame-stack 4 --seed 1 \\
        --out results/atari_q_k4_init_seed1.npz
    python tools/export_grouped_init_params.py --net actor_critic --seed 1 \\
        --out results/ppo_init_seed1.npz
    python tools/export_grouped_init_params.py --net atari_actor_critic --frame-stack 4 \\
        --seed 1 --out results/atari_actor_critic_k4_init_seed1.npz
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = ("qmlp", "q_cnn", "atari_q", "actor_critic", "atari_actor_critic")


def default_out(net: str, seed: int, frame_stack: int = 1) -> str:
    stack = '' if frame_stack == 1 else f'_k{frame_stack}'
    if net == "qmlp":
        name = f"grouped_qmlp_init_seed{seed}.npz"
    elif net in ("atari_q", "atari_actor_critic"):
        name = f"{net}{stack}_init_seed{seed}.npz"
    elif net == "actor_critic":
        name = f"ppo{stack}_init_seed{seed}.npz"
    else:
        name = f"qcnn{stack}_init_seed{seed}.npz"
    return os.path.join(REPO, "results", name)


def export(seed: int, out: str, net: str = "qmlp", frame_stack: int = 1) -> dict:
    """Write the flat float32 initial parameters of the default 10x20 run
    with ``seed`` of the ``net`` DQN or PPO agent to ``out``."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax

    from tetris_gymnasium_tpu.config import EngineConfig

    # the parameters depend on the key and the observation's shape only
    if net == "qmlp":
        from tetris_gymnasium_tpu.models.networks import QMLP
        from tetris_gymnasium_tpu.rl import grouped_dqn

        ts = grouped_dqn.init_grouped_dqn_state(
            jax.random.PRNGKey(seed), 2, EngineConfig(gravity_enabled=False, auto_reset=True),
            grouped_dqn.GroupedDQNConfig(buffer_size=4), QMLP(),
        )
    elif net == "q_cnn":
        from tetris_gymnasium_tpu.models.networks import QNetworkCNN
        from tetris_gymnasium_tpu.rl import dqn

        ts = dqn.init_dqn_state(
            jax.random.PRNGKey(seed), 2, EngineConfig(auto_reset=True),
            dqn.DQNConfig(buffer_size=2 * (frame_stack + 1), frame_stack=frame_stack),
            QNetworkCNN(), impl="turbo",
        )
    elif net == "atari_q":
        from tetris_gymnasium_tpu.models.networks import AtariQNetwork
        from tetris_gymnasium_tpu.rl import dqn

        ts = dqn.init_dqn_state(
            jax.random.PRNGKey(seed), 2, EngineConfig(auto_reset=True),
            dqn.DQNConfig(buffer_size=2 * (frame_stack + 1), frame_stack=frame_stack),
            AtariQNetwork(), impl="flagship", obs="rgb84",
        )
    elif net in ("actor_critic", "atari_actor_critic"):
        from tetris_gymnasium_tpu.models.networks import ActorCriticCNN, AtariActorCritic
        from tetris_gymnasium_tpu.rl import ppo

        pixels = net == "atari_actor_critic"
        ts = ppo.init_train_state(
            jax.random.PRNGKey(seed), 2, EngineConfig(auto_reset=True),
            ppo.PPOConfig(frame_stack=frame_stack),
            AtariActorCritic() if pixels else ActorCriticCNN(),
            impl="flagship" if pixels else "turbo", obs="rgb84" if pixels else "board",
        )
    else:
        raise ValueError(f"unknown net {net!r}: {', '.join(NETS)}")
    flat = {
        "/".join(str(p.key) for p in path): np.asarray(leaf, dtype=np.float32)
        for path, leaf in jax.tree_util.tree_flatten_with_path(ts.params)[0]
    }
    np.savez(out, **flat)
    return flat


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--net", choices=NETS, default="qmlp")
    p.add_argument("--frame-stack", type=int, default=1,
                   help="K of the net's input (every net but qmlp)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default=None,
                   help="default: results/grouped_qmlp_init_seed<S>.npz, "
                   "results/qcnn[_k<K>]_init_seed<S>.npz, results/atari_q[_k<K>]_init_seed<S>.npz, "
                   "results/ppo[_k<K>]_init_seed<S>.npz or "
                   "results/atari_actor_critic[_k<K>]_init_seed<S>.npz")
    args = p.parse_args(argv)
    out = args.out or default_out(args.net, args.seed, args.frame_stack)
    for k, v in export(args.seed, out, args.net, args.frame_stack).items():
        print(f"{k} {v.shape}")


if __name__ == "__main__":
    main()
