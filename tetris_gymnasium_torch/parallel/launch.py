"""Multi-process launcher: the env-sharded rollout, PPO and DQN.

Port of ``tetris_gymnasium_tpu/parallel/launch.py``.  Each process is one
rank of a ``torch.distributed`` process group and one device, and holds
an equal contiguous share of the global env batch (:mod:`.mesh`).  On one
host with W cards::

    torchrun --nproc-per-node W -m tetris_gymnasium_torch.parallel.launch \\
        --n-envs 65536 --horizon 256

or, without ``torchrun``, one command a rank::

    python -m tetris_gymnasium_torch.parallel.launch --coordinator localhost:29500 \\
        --num-processes W --process-id I [--backend auto|cpu|gloo-cuda]

With neither, it runs as one process.  The backend is the caller's and is
never swapped: ``auto`` is NCCL with one card a rank (``cuda:LOCAL_RANK``;
it raises where a rank has no card of its own), ``cpu`` is gloo on CPU
tensors (the tests), ``gloo-cuda`` is gloo on CUDA tensors, which lets
several ranks share one card.  JAX's ``--local-devices`` has no
counterpart: torch has no virtual devices, so W ranks are W processes.
Any failure to bring the group up propagates.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.parallel import mesh as pmesh

BACKENDS = {"auto": "nccl", "cpu": "gloo", "gloo-cuda": "gloo"}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _wall_time(mesh: pmesh.EnvMesh) -> float:
    """Seconds on the host clock, once the mesh's device has done its work."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return time.perf_counter()


def _identity(mesh: pmesh.EnvMesh) -> dict:
    return {"n_devices": mesh.world, "process_index": mesh.rank, "process_count": mesh.world,
            "backend": mesh.backend}


def run(mesh: pmesh.EnvMesh, config, n_envs: int, horizon: int, repeats: int,
        engine_kind: str = "engine") -> dict:
    """Reset, a warm-up rollout and ``repeats`` timed rollouts; returns metrics.

    The sequence is JAX's (``launch.py:28``): reset with key 0, the warm-up
    rollout with key 1, the timed ones with keys 2, 3, ...  Per-env streams
    fold on the global env index, rewards are whole numbers and the
    checksum is a wraparound sum, so every world size gives the same
    ``sum_reward``, ``sum_done`` and ``checksum``.  ``engine_kind="fn_env"``
    resets and steps the compat engine (``config`` an :class:`EnvConfig`).
    """
    if engine_kind == "fn_env":
        states, _ = pmesh.sharded_compat_reset(prng_key(0), n_envs, config, mesh)
    else:
        states, _ = pmesh.sharded_reset(prng_key(0), n_envs, config, mesh, obs="board")
    states, tot_r, tot_d = pmesh.sharded_random_rollout(
        states, prng_key(1), config, mesh, horizon, engine_kind)
    sum_r, sum_d = float(tot_r), int(tot_d)

    t0 = _wall_time(mesh)
    for i in range(repeats):
        states, tot_r, tot_d = pmesh.sharded_random_rollout(
            states, prng_key(2 + i), config, mesh, horizon, engine_kind)
        sum_r += float(tot_r)
        sum_d += int(tot_d)
    dt = _wall_time(mesh) - t0
    return {
        **_identity(mesh),
        "steps_per_sec": n_envs * horizon * repeats / dt if repeats else None,
        "sum_reward": sum_r,
        "sum_done": sum_d,
        "checksum": pmesh.state_checksum(states, mesh),
    }


def _params_checksum(net, mesh) -> dict:
    return pmesh.state_checksum(dict(net.state_dict()), mesh, sharded=False)


def run_ppo(mesh: pmesh.EnvMesh, config: EngineConfig, n_envs: int, iterations: int,
            rollout_len: int = 8, impl: str = "flagship", dtype=torch.bfloat16,
            params: Optional[dict] = None) -> dict:
    """Sharded PPO on the mesh (``launch.py:80``): JAX's
    ``PPOConfig(rollout_len, 1 epoch, 2 minibatches, shuffle_block 8)`` and
    ``ActorCriticCNN`` (trunk in ``dtype``; weights from ``params``, flat
    Flax names, or drawn from key 0), the env batch sharded, the learner
    replicated.  The first iteration is the warm-up, left out of the rate.
    """
    from tetris_gymnasium_torch.models.networks import ActorCriticCNN
    from tetris_gymnasium_torch.rl import ppo as rl_ppo

    pcfg = rl_ppo.PPOConfig(rollout_len=rollout_len, update_epochs=1, n_minibatches=2,
                            shuffle_block=8)
    ts = rl_ppo.init_train_state(prng_key(0), n_envs, config, pcfg,
                                 net=ActorCriticCNN(dtype=dtype), impl=impl, params=params,
                                 mesh=mesh)
    train_step = rl_ppo.make_train_step(config, pcfg, impl=impl, mesh=mesh)

    ts, metrics = train_step(ts)
    losses = [float(metrics["pg_loss"])]
    t0 = _wall_time(mesh)
    for _ in range(iterations - 1):
        ts, metrics = train_step(ts)
        losses.append(float(metrics["pg_loss"]))
    dt = _wall_time(mesh) - t0
    sps = n_envs * rollout_len * (iterations - 1) / dt if iterations > 1 else None
    return {
        **_identity(mesh),
        "train_steps_per_sec": sps,
        "pg_losses": losses,
        "final_entropy": float(metrics["entropy"]),
        "env_checksum": pmesh.state_checksum(ts.env_states, mesh),
        "param_checksum": _params_checksum(ts.net, mesh),
    }


def run_dqn(mesh: pmesh.EnvMesh, config: EngineConfig, n_envs: int, iterations: int,
            impl: str = "flagship", dtype=torch.bfloat16, params: Optional[dict] = None) -> dict:
    """Sharded DQN on the mesh (``launch.py:151``): JAX's ``DQNConfig``
    (buffer ``8 * n_envs``, batch 32, learning from step 2, target sync
    every 4, epsilon over ``iterations`` steps) and ``QNetworkCNN``, the env
    batch sharded, the learner and the replay buffer replicated.
    """
    from tetris_gymnasium_torch.models.networks import QNetworkCNN
    from tetris_gymnasium_torch.rl import dqn as rl_dqn

    cfg = rl_dqn.DQNConfig(buffer_size=n_envs * 8, batch_size=32, learning_starts=2,
                           target_update_every=4, exploration_steps=max(iterations, 1))
    ts = rl_dqn.init_dqn_state(prng_key(0), n_envs, config, cfg, QNetworkCNN(dtype=dtype),
                               impl=impl, params=params, mesh=mesh)
    train_step = rl_dqn.make_train_step(config, cfg, impl=impl, mesh=mesh)

    ts, metrics = train_step(ts)
    losses = [float(metrics["loss"])]
    t0 = _wall_time(mesh)
    for _ in range(iterations - 1):
        ts, metrics = train_step(ts)
        losses.append(float(metrics["loss"]))
    dt = _wall_time(mesh) - t0
    sps = n_envs * (iterations - 1) / dt if iterations > 1 else None
    return {
        **_identity(mesh),
        "train_steps_per_sec": sps,
        "losses": losses,
        "mean_q": float(metrics["mean_q"]),
        "env_checksum": pmesh.state_checksum(ts.env_states, mesh),
        "buffer_checksum": pmesh.state_checksum(ts.buffer, mesh, sharded=False),
        "param_checksum": _params_checksum(ts.net, mesh),
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-envs", type=int, default=65536, help="global env count")
    p.add_argument("--horizon", type=int, default=256)
    p.add_argument("--repeats", type=int, default=4)
    p.add_argument("--coordinator", type=str, default=None, help="host:port of rank 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--backend", choices=sorted(BACKENDS), default="auto",
                   help="auto: NCCL, a card a rank; cpu: gloo on CPU tensors; "
                        "gloo-cuda: gloo on CUDA tensors (ranks may share a card)")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds any collective may wait before the run fails")
    p.add_argument("--out", type=str, default=None, help="write this rank's metrics JSON here")
    p.add_argument("--train", choices=["none", "ppo", "dqn"], default="none",
                   help="sharded training instead of the random-policy rollout")
    p.add_argument("--train-iters", type=int, default=3)
    p.add_argument("--impl", choices=["flagship", "turbo"], default="flagship",
                   help="PPO's engine")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                   help="the networks' trunk (JAX's default bfloat16)")
    p.add_argument("--init-params", type=str, default=None,
                   help="the network's weights: an .npz of flat Flax parameters")
    return p.parse_args(argv)


def setup(args: argparse.Namespace) -> pmesh.EnvMesh:
    """Bring up the process group the arguments or the ``torchrun``
    variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
    describe, if any, and return this rank's mesh."""
    if args.coordinator is not None:
        if args.num_processes is None or args.process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        init = (f"tcp://{args.coordinator}", args.num_processes, args.process_id)
    elif all(v in os.environ for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        init = ("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]))
    else:
        init = None
    rank = 0 if init is None else init[2]
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if args.backend == "cpu":
        device = "cpu"
    elif args.backend == "auto":
        n_cards = torch.cuda.device_count()
        if local_rank >= n_cards:
            raise RuntimeError(
                f"--backend auto puts each rank on a card of its own, but local rank "
                f"{local_rank} has none of {n_cards}; use --backend gloo-cuda to share cards")
        device = f"cuda:{local_rank}"
    else:
        device = f"cuda:{local_rank % max(torch.cuda.device_count(), 1)}"
    if device.startswith("cuda"):
        torch.cuda.set_device(pmesh.resolve_device(device))
    if init is None:
        print("single-process run (no coordinator configured)")
        return pmesh.env_mesh(device)
    pmesh.initialize_distributed(BACKENDS[args.backend], init[0], init[1], init[2],
                                 timeout=args.timeout)
    return pmesh.env_mesh(device)


def main(argv=None) -> dict:
    args = parse_args(argv)
    mesh = setup(args)
    dtype = DTYPES[args.dtype]
    params = None
    if args.init_params:
        from tetris_gymnasium_torch.utils.checkpoint import load_flat

        params = load_flat(args.init_params)
    config = EngineConfig(auto_reset=True)
    if mesh.rank == 0:
        print(f"mesh: {mesh.world} ranks ({mesh.backend or 'no process group'}) on {mesh.device}")
    if args.train == "ppo":
        metrics = run_ppo(mesh, config, args.n_envs, args.train_iters, impl=args.impl,
                          dtype=dtype, params=params)
    elif args.train == "dqn":
        metrics = run_dqn(mesh, config, args.n_envs, args.train_iters, dtype=dtype,
                          params=params)
    else:
        metrics = run(mesh, config, args.n_envs, args.horizon, args.repeats)
    metrics["collectives"] = dict(mesh.counts)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f)
    if mesh.rank == 0:
        if args.train == "none":
            sps = metrics["steps_per_sec"]
            print(f"{sps:.3e} env-steps/s global ({sps / mesh.world:.3e} per rank), "
                  f"sum reward {metrics['sum_reward']:.0f}, episodes {metrics['sum_done']}")
        else:
            sps = metrics["train_steps_per_sec"]
            sps_txt = f"{sps:.3e}" if sps is not None else "n/a (1 iteration)"
            last = metrics["losses"][-1] if args.train == "dqn" else metrics["pg_losses"][-1]
            name = "loss" if args.train == "dqn" else "pg_loss"
            print(f"{sps_txt} trained env-steps/s, {name} {last:.5f}")
    return metrics


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
