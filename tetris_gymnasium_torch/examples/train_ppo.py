"""PPO with the PyTorch port: envs, rollout and learner on the card.

Twin of ``examples/train_ppo.py``: board observations on the turbo engine
or (``--impl flagship``) the flagship engine (``ActorCriticCNN`` with a bf16
trunk), or with ``--obs rgb84`` the reference's 84x84 gray frames on the
flagship engine (``AtariActorCritic`` with a bf16 trunk); ``--frame-stack
K`` feeds the net ``[B, K, H, W]`` windows.  One iteration is
``rollout_len * n_envs`` env steps; the host loop calls the train step and
reads the metrics every ``--chunk`` iterations::

    python -m tetris_gymnasium_torch.examples.train_ppo --n-envs 8192 --iterations 100
    python -m tetris_gymnasium_torch.examples.train_ppo --obs rgb84 --frame-stack 4
    python -m tetris_gymnasium_torch.examples.train_ppo --device cpu --n-envs 8 \\
        --rollout-len 4 --iterations 2

Warm-start from an exported ``.npz`` (``tools/export_torch_params.py``, or a
file this script saved) with ``--init-params``; save with ``--save-params``.
Records go to stdout and, with ``--log-json``, to a JSONL file.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.models.networks import ActorCriticCNN, AtariActorCritic
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.rl import evaluate, ppo
from tetris_gymnasium_torch.utils.checkpoint import load_flat, save_actor_critic
from tetris_gymnasium_torch.utils.device import resolve_device

# options of the JAX script that this port does not have yet, with the
# ROADMAP.md queue 1 item that brings each
_NOT_PORTED = {
    "wandb": "--wandb (utils/tracking) comes with ROADMAP.md queue 1 item 12",
    "video_every": "--video-every (utils/video) comes with ROADMAP.md queue 1 item 12",
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-envs", type=int, default=2048)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument(
        "--chunk", type=int, default=1,
        help="iterations between metric reads to the host (each read waits for the card); "
        "logging granularity becomes the chunk",
    )
    p.add_argument("--rollout-len", type=int, default=128)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument(
        "--anneal", action="store_true",
        help="linearly decay the learning rate to 0 and ent-coef to --ent-coef-final over the run",
    )
    p.add_argument("--ent-coef-final", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--gamma", type=float, default=0.999)
    p.add_argument("--update-epochs", type=int, default=6)
    p.add_argument("--n-minibatches", type=int, default=8)
    p.add_argument("--alife", type=float, default=1.0, help="RewardsMapping.alife")
    p.add_argument("--game-over-reward", type=float, default=0.0, help="RewardsMapping.game_over")
    p.add_argument("--eval-max-steps", type=int, default=2000)
    p.add_argument(
        "--net", choices=("default", "fullres"), default="default",
        help="actor-critic trunk: default (strided 32-64-128) or fullres (stride-1 convs)",
    )
    p.add_argument(
        "--obs", choices=("board", "rgb84"), default="board",
        help="observation: the board, or the reference's RGB -> 84x84 -> gray frames "
        "(selects the flagship engine and AtariActorCritic)",
    )
    p.add_argument("--frame-stack", type=int, default=1)
    p.add_argument("--save-params", type=str, default=None,
                   help="save the final actor-critic parameters here (.npz)")
    p.add_argument("--init-params", type=str, default=None,
                   help="warm-start from an .npz of flat parameters (fresh optimizer and envs)")
    p.add_argument("--impl", choices=("flagship", "turbo"), default="turbo")
    p.add_argument("--eval-every", type=int, default=0,
                   help="iterations between greedy policy evals (0 = off)")
    p.add_argument("--eval-episodes", type=int, default=256)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--video-every", type=int, default=0)
    p.add_argument("--log-json", type=str, default=None, help="append JSONL here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.chunk > 1:
        # a non-divisible chunk would change how many iterations run (breaking
        # the --anneal schedules), and a non-multiple eval cadence never fires
        if args.iterations % args.chunk:
            p.error(f"--iterations {args.iterations} must be a multiple of --chunk {args.chunk}")
        for name in ("eval_every", "video_every"):
            v = getattr(args, name)
            if v and v % args.chunk:
                p.error(f"--{name.replace('_', '-')} {v} must be a multiple of --chunk {args.chunk}")
    if args.frame_stack < 1:
        p.error(f"--frame-stack must be >= 1, got {args.frame_stack}")
    defaults = {"wandb": False, "video_every": 0}
    for name, default in defaults.items():
        if getattr(args, name) != default:
            raise NotImplementedError(_NOT_PORTED[name])
    if args.obs == "rgb84" and args.impl != "flagship":
        print("obs=rgb84 needs id boards; switching --impl to flagship", flush=True)
        args.impl = "flagship"
    return args


def setup(args: argparse.Namespace, marks=None):
    """``(train_state, train_step, env_config)`` for parsed ``args``."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    env_config = EngineConfig(auto_reset=True)
    ppo_cfg = ppo.PPOConfig(
        rollout_len=args.rollout_len,
        ent_coef=args.ent_coef,
        ent_coef_final=args.ent_coef_final,
        learning_rate=args.lr,
        gamma=args.gamma,
        update_epochs=args.update_epochs,
        n_minibatches=args.n_minibatches,
        total_iterations=args.iterations if args.anneal else 0,
        frame_stack=args.frame_stack,
    )
    rewards = RewardsMapping(alife=args.alife, game_over=args.game_over_reward)
    if args.obs == "rgb84":
        net = AtariActorCritic(in_channels=args.frame_stack)
    else:
        strides = ((1, 1), (1, 1), (1, 1)) if args.net == "fullres" else None
        net = ActorCriticCNN(strides=strides, in_channels=args.frame_stack)
    params = load_flat(args.init_params) if args.init_params else None
    ts = ppo.init_train_state(
        prng_key(args.seed), args.n_envs, env_config, ppo_cfg, net=net, impl=args.impl,
        obs=args.obs, device=device, params=params,
    )
    if params is not None:
        print(f"warm-started params from {args.init_params}", flush=True)
    train_step = ppo.make_train_step(
        env_config, ppo_cfg, impl=args.impl, rewards=rewards, obs=args.obs, marks=marks
    )
    return ts, train_step, env_config


def train(args: argparse.Namespace, marks=None):
    """Run ``args.iterations`` train steps; returns ``(train_state, records)``."""
    ts, train_step, env_config = setup(args, marks)
    log_f = None
    if args.log_json:
        os.makedirs(os.path.dirname(args.log_json) or ".", exist_ok=True)
        log_f = open(args.log_json, "a")
    steps_per_iter = args.n_envs * args.rollout_len
    records = []
    rewards, episodes = [], 0
    t0 = time.perf_counter()
    for it in range(1, args.iterations + 1):
        ts, metrics = train_step(ts)
        rewards.append(metrics["mean_reward"])
        episodes = episodes + metrics["episodes_done"]
        if it % args.chunk:
            continue
        if args.chunk > 1 or it % 5 == 0 or it == 1:
            # last iteration's losses, chunk-mean reward and chunk-sum episodes
            m = {k: float(v) for k, v in metrics.items()}
            m["mean_reward"] = float(torch.stack(rewards).mean())
            m["episodes_done"] = float(episodes)
            window = steps_per_iter * args.chunk
            rec = {
                "iteration": it,
                "env_steps": steps_per_iter * it,
                "sps": round(steps_per_iter * it / (time.perf_counter() - t0)),
                "reward_per_step": round(m["mean_reward"], 4),
                "steps_per_episode": round(window / max(m["episodes_done"], 1.0), 2),
                "pg_loss": round(m["pg_loss"], 5),
                "v_loss": round(m["v_loss"], 5),
                "entropy": round(m["entropy"], 4),
            }
            if args.eval_every and it % args.eval_every == 0:
                ev = evaluate.evaluate_policy(
                    evaluate.greedy_logits(ts.net), args.eval_episodes, env_config,
                    prng_key(1000 + it), impl=args.impl, max_steps=args.eval_max_steps,
                    frame_stack=args.frame_stack, obs=args.obs, device=args.device,
                )
                rec.update(
                    eval_return=round(ev["return_mean"], 3),
                    eval_length=round(ev["length_mean"], 2),
                    eval_lines=round(ev["lines_mean"], 4),
                    eval_episodes=int(ev["episodes_completed"]),
                )
            records.append(rec)
            print(json.dumps(rec), flush=True)
            if log_f:
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
        rewards, episodes = [], 0
    if args.save_params:
        save_actor_critic(args.save_params, ts.net)
        print(f"saved params to {args.save_params}", flush=True)
    if log_f:
        log_f.close()
    return ts, records


def main(argv=None):
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
