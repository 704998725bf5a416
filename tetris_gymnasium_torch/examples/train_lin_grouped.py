"""Grouped placement DQN with the PyTorch port: envs, replay and learner on the card.

Twin of ``examples/train_lin_grouped.py``: gravity off, auto-reset, actions
are (column, rotation) placements and the Q-net scores every candidate
placement (:class:`QMLP` on features, or :class:`QGroupedBoardsCNN` on
binary boards with ``--mode boards``).  The host loop reads the metrics
once every ``--chunk`` steps and prints one JSONL record per chunk, with the
JAX script's keys::

    python -m tetris_gymnasium_torch.examples.train_lin_grouped --n-envs 1024 --steps 2000 \\
        --chunk 50 --exploration-steps 1500 --learning-starts 250
    python -m tetris_gymnasium_torch.examples.train_lin_grouped --device cpu --n-envs 8 \\
        --steps 20 --chunk 10 --learning-starts 5

``lines_per_step`` is the line-clear rate per env step, the learning signal.
Warm-start from an ``.npz`` of flat Flax parameters with ``--init-params``;
save with ``--save-params``.  ``--wandb`` mirrors the records to Weights &
Biases (one warning and no-op without wandb).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core.turbo_grouped import MODES
from tetris_gymnasium_torch.models.networks import QGroupedBoardsCNN
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.rl import evaluate, grouped_dqn
from tetris_gymnasium_torch.utils.checkpoint import load_flat, save_q_net
from tetris_gymnasium_torch.utils.device import resolve_device
from tetris_gymnasium_torch.utils.tracking import Tracker


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-envs", type=int, default=512)
    p.add_argument("--steps", type=int, default=20_000, help="batched env steps")
    p.add_argument("--chunk", type=int, default=100, help="steps between metric reads")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--exploration-steps", type=int, default=5_000)
    p.add_argument("--learning-starts", type=int, default=500)
    p.add_argument("--eval-every", type=int, default=0,
                   help="batched steps between greedy policy evals (0 = off)")
    p.add_argument("--eval-episodes", type=int, default=256)
    p.add_argument("--wandb", action="store_true",
                   help="mirror the JSONL records to Weights & Biases (no-op without wandb)")
    p.add_argument("--wandb-project", type=str, default="tetris-gymnasium-tpu")
    p.add_argument("--run-name", type=str, default=None)
    p.add_argument("--log-json", type=str, default=None, help="append JSONL here")
    p.add_argument("--mode", choices=MODES, default="features",
                   help="candidate observation: features (QMLP) or binary boards (QGroupedBoardsCNN)")
    p.add_argument("--save-params", type=str, default=None,
                   help="save the final Q-net parameters here (.npz)")
    p.add_argument("--init-params", type=str, default=None,
                   help="warm-start from an .npz of flat parameters (fresh optimizer and envs)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def setup(args: argparse.Namespace, marks=None):
    """``(train_state, train_step, env_config)`` for parsed ``args``."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    env_config = EngineConfig(gravity_enabled=False, auto_reset=True)
    cfg = grouped_dqn.GroupedDQNConfig(
        exploration_steps=args.exploration_steps, learning_starts=args.learning_starts,
    )
    net = QGroupedBoardsCNN(board_shape=(env_config.height, env_config.width)) \
        if args.mode == "boards" else None
    params = load_flat(args.init_params) if args.init_params else None
    ts = grouped_dqn.init_grouped_dqn_state(
        prng_key(args.seed), args.n_envs, env_config, cfg, net, mode=args.mode, device=device,
        params=params,
    )
    if params is not None:
        print(f"warm-started params from {args.init_params}", flush=True)
    train_step = grouped_dqn.make_train_step(env_config, cfg, mode=args.mode, marks=marks)
    return ts, train_step, env_config


def train(args: argparse.Namespace, marks=None):
    """Run ``args.steps // args.chunk`` chunks of steps; returns ``(train_state, records)``."""
    ts, train_step, env_config = setup(args, marks)
    log_f = None
    if args.log_json:
        os.makedirs(os.path.dirname(args.log_json) or ".", exist_ok=True)
        log_f = open(args.log_json, "a")
    tracker = Tracker(args.wandb, args.wandb_project, args.run_name, vars(args))
    records = []
    t0 = time.perf_counter()
    for it in range(args.steps // args.chunk):
        lines, rewards = [], []
        for _ in range(args.chunk):
            ts, m = train_step(ts)
            lines.append(m["lines_cleared"])
            rewards.append(m["mean_reward"])
        step = (it + 1) * args.chunk
        env_steps = step * args.n_envs
        rec = {
            "step": step,
            "env_steps": env_steps,
            "sps": round(env_steps / (time.perf_counter() - t0)),
            "lines_per_step": round(float(torch.stack(lines).sum()) / (args.chunk * args.n_envs), 5),
            "mean_reward": round(float(torch.stack(rewards).mean()), 4),
            "loss": round(float(m["loss"]), 5),
            "epsilon": round(float(m["epsilon"]), 4),
            "lines": int(torch.stack(lines).sum()),
        }
        if args.eval_every and step % args.eval_every == 0:
            ev = evaluate.evaluate_grouped(
                evaluate.greedy_masked_q(ts.net), args.eval_episodes, env_config,
                prng_key(2000 + it), mode=args.mode, device=args.device,
            )
            rec.update(
                eval_return=round(ev["return_mean"], 3),
                eval_length=round(ev["length_mean"], 2),
                eval_lines=round(ev["lines_mean"], 4),
                eval_episodes=int(ev["episodes_completed"]),
            )
        records.append(rec)
        print(json.dumps(rec), flush=True)
        tracker.log(rec, step)
        if log_f:
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()
    if args.save_params:
        save_q_net(args.save_params, ts.net, grouped_dqn.net_kind(ts.net))
        print(f"saved params to {args.save_params}", flush=True)
    if log_f:
        log_f.close()
    tracker.finish()
    return ts, records


def main(argv=None):
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
