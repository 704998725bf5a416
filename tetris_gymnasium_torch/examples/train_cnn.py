"""DQN with a CNN Q-net with the PyTorch port: envs, replay and learner on the card.

Twin of ``examples/train_cnn.py``.  On board observations
:class:`QNetworkCNN` (bf16 trunk) reads the board, or with ``--frame-stack
K`` a ``[B, K, H, W]`` window of the newest K boards; with ``--obs rgb84``
(which selects the flagship engine) :class:`AtariQNetwork` reads the
reference workload's 84x84 gray frames (RGB -> Resize(84, 84) -> Grayscale
-> FrameStack(K)).  The replay stores single frames and rebuilds the
windows at sample time.  The host loop reads the metrics once every
``--chunk`` steps and prints one JSONL record per chunk, with the JAX
script's keys::

    python -m tetris_gymnasium_torch.examples.train_cnn --n-envs 1024 --steps 20000 \\
        --frame-stack 4 --log-json results/dqn_torch_k4.jsonl
    python -m tetris_gymnasium_torch.examples.train_cnn --obs rgb84 --frame-stack 4 \\
        --n-envs 512 --steps 12000 --init-params results/atari_q_k4_init_seed1.npz
    python -m tetris_gymnasium_torch.examples.train_cnn --device cpu --obs rgb84 \\
        --frame-stack 4 --n-envs 4 --steps 20 --chunk 10 --learning-starts 4

``reward_per_step`` (rising) and ``steps_per_episode`` (falling) are the
learning signals.  Warm-start from an ``.npz`` of flat Flax parameters with
``--init-params`` (``tools/export_grouped_init_params.py --net q_cnn`` or
``--net atari_q`` writes the JAX run's initial weights); save with
``--save-params``.  ``--wandb`` mirrors the records to Weights & Biases (one
warning and no-op without wandb); ``--video-every N`` writes a greedy
episode every N steps to ``<log-json base>_ep{N}.gif`` (board observations
only).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.rl import dqn, evaluate
from tetris_gymnasium_torch.utils.checkpoint import load_flat, save_q_net
from tetris_gymnasium_torch.utils.device import resolve_device
from tetris_gymnasium_torch.utils.tracking import Tracker


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=20_000, help="batched env steps")
    p.add_argument("--chunk", type=int, default=100, help="steps between metric reads")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--exploration-steps", type=int, default=6_000)
    p.add_argument("--learning-starts", type=int, default=500)
    p.add_argument("--impl", choices=("flagship", "turbo"), default="turbo")
    p.add_argument("--frame-stack", type=int, default=1,
                   help="K: feed the net a [B, K, H, W] window (replay stores single frames)")
    p.add_argument("--obs", choices=("board", "rgb84"), default="board")
    p.add_argument("--eval-every", type=int, default=0,
                   help="batched steps between greedy policy evals (0 = off)")
    p.add_argument("--eval-episodes", type=int, default=256)
    p.add_argument("--wandb", action="store_true",
                   help="mirror the JSONL records to Weights & Biases (no-op without wandb)")
    p.add_argument("--wandb-project", type=str, default="tetris-gymnasium-tpu")
    p.add_argument("--run-name", type=str, default=None)
    p.add_argument("--video-every", type=int, default=0,
                   help="steps between greedy-episode GIF captures (0 = off)")
    p.add_argument("--log-json", type=str, default=None, help="append JSONL here")
    p.add_argument("--save-params", type=str, default=None,
                   help="save the final Q-net parameters here (.npz)")
    p.add_argument("--init-params", type=str, default=None,
                   help="warm-start from an .npz of flat parameters (fresh optimizer and envs)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.frame_stack < 1:
        p.error(f"--frame-stack must be >= 1, got {args.frame_stack}")
    if args.obs == "rgb84" and args.impl != "flagship":
        print("obs=rgb84 needs id boards; switching --impl to flagship", flush=True)
        args.impl = "flagship"
    return args


def setup(args: argparse.Namespace, marks=None):
    """``(train_state, train_step, env_config, cfg)`` for parsed ``args``."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    env_config = EngineConfig(auto_reset=True)
    cfg = dqn.DQNConfig(exploration_steps=args.exploration_steps,
                        learning_starts=args.learning_starts, frame_stack=args.frame_stack)
    params = load_flat(args.init_params) if args.init_params else None
    ts = dqn.init_dqn_state(prng_key(args.seed), args.n_envs, env_config, cfg, impl=args.impl,
                            obs=args.obs, device=device, params=params)
    if params is not None:
        print(f"warm-started params from {args.init_params}", flush=True)
    train_step = dqn.make_train_step(env_config, cfg, impl=args.impl, obs=args.obs, marks=marks)
    return ts, train_step, env_config, cfg


def train(args: argparse.Namespace, marks=None):
    """Run ``args.steps // args.chunk`` chunks of steps; returns ``(train_state, records)``."""
    ts, train_step, env_config, cfg = setup(args, marks)
    log_f = None
    if args.log_json:
        os.makedirs(os.path.dirname(args.log_json) or ".", exist_ok=True)
        log_f = open(args.log_json, "a")
    tracker = Tracker(args.wandb, args.wandb_project, args.run_name, vars(args))

    def capture_video(step_i):
        if args.obs == "rgb84":
            print("(--video-every is board-policy only; skipped for rgb84)")
            return
        from tetris_gymnasium_torch.utils import video

        base = os.path.splitext(args.log_json)[0] if args.log_json else "results/dqn"
        path = video.record_training_video(ts.net, f"{base}_ep{step_i}.gif", env_config,
                                           frame_stack=args.frame_stack, seed=args.seed + step_i)
        print(f"recorded greedy episode -> {path}", flush=True)
        tracker.log_video(path, step_i)

    records = []
    t0 = time.perf_counter()
    for it in range(args.steps // args.chunk):
        rewards, episodes = [], []
        for _ in range(args.chunk):
            ts, m = train_step(ts)
            rewards.append(m["mean_reward"])
            episodes.append(m["episodes_done"])
        step = (it + 1) * args.chunk
        env_steps = step * args.n_envs
        chunk_steps = args.chunk * args.n_envs
        rec = {
            "step": step,
            "env_steps": env_steps,
            "sps": round(env_steps / (time.perf_counter() - t0)),
            "reward_per_step": round(float(torch.stack(rewards).mean()), 4),
            "steps_per_episode": round(chunk_steps / max(float(torch.stack(episodes).sum()), 1.0), 2),
            "loss": round(float(m["loss"]), 5),
            "epsilon": round(float(m["epsilon"]), 4),
        }
        if args.eval_every and step % args.eval_every == 0:
            ev = evaluate.evaluate_q_checkpoint(
                ts.net, args.eval_episodes, env_config, seed=args.seed + it, impl=args.impl,
                frame_stack=cfg.frame_stack, obs=args.obs, device=args.device,
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
        if args.video_every and step % args.video_every == 0:
            capture_video(step)
        if log_f:
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()
    if log_f:
        log_f.close()
    tracker.finish()
    if args.save_params:
        save_q_net(args.save_params, ts.net, dqn.net_kind(ts.net))
        print(f"saved params to {args.save_params}", flush=True)
    return ts, records


def main(argv=None):
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
