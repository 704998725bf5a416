"""Greedy evaluation of a policy: N fresh episodes stepped in lockstep.

Port of ``tetris_gymnasium_tpu/rl/evaluate.py`` (``_stats :30``,
``evaluate_policy :56``, ``evaluate_grouped :96``, ``greedy_q :124``,
``greedy_logits :132``, ``greedy_masked_q :141``, ``evaluate_q_checkpoint
:162``).  Episodes run with
``auto_reset=False``, so a finished game freezes and the engine state's own
accumulators (``score``, ``steps``, ``lines``) give the statistics at the
end.  Where JAX scans ``max_steps`` iterations, this loop also stops once
every game is over: frozen games do not change, so the statistics are the
same.

Run as a script it evaluates an exported checkpoint, the twin of
``examples/evaluate_checkpoint.py``: an actor-critic (``--net
actor-critic``, the default: an :class:`ActorCriticCNN` over boards, or with
``--obs rgb84`` an :class:`AtariActorCritic` over the flagship engine's
84x84 frames) or a Q-net (``--net q``: a :class:`QNetworkCNN` over boards,
or with ``--obs rgb84`` an :class:`AtariQNetwork`); ``--frame-stack K`` for
a net that reads K-frame windows; ``--width`` and ``--height`` for another
board::

    python -m tetris_gymnasium_torch.rl.evaluate \\
        --checkpoint results/ppo_lines_params.npz --episodes 512 --seed 0 --max-steps 2000
    python -m tetris_gymnasium_torch.rl.evaluate --net q --frame-stack 4 \\
        --checkpoint q.npz --episodes 512
    python -m tetris_gymnasium_torch.rl.evaluate --net q --obs rgb84 --frame-stack 4 \\
        --checkpoint results/atari_q_k4_init_seed1.npz --episodes 512
    python -m tetris_gymnasium_torch.rl.evaluate --obs rgb84 --frame-stack 4 \\
        --checkpoint results/atari_actor_critic_k4_init_seed1.npz --episodes 512
"""
from __future__ import annotations

import argparse
import json
from typing import Callable

import torch

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.ops import framestack
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.rl.engines import env_fns
from tetris_gymnasium_torch.utils.device import resolve_device

# How many iterations run between two checks that every game is over; each
# check waits for the card.
DONE_CHECK_EVERY = 32


def _stats(states, max_steps: int) -> dict:
    """Episodic statistics of frozen final states, as Python numbers."""
    done = states.game_over
    n_done = int(done.sum())
    safe = torch.tensor(float(max(n_done, 1)), dtype=torch.float32, device=done.device)

    def masked_mean(x):  # float32 throughout, as the JAX version
        return float(torch.where(done, x.to(torch.float32), 0.0).sum() / safe)

    def masked(x, fn):
        return float(fn(x[done])) if n_done else 0.0

    return {
        "episodes_completed": n_done,
        "completed_frac": n_done / done.shape[0],
        "return_mean": masked_mean(states.score),
        "return_min": masked(states.score, torch.min),
        "return_max": masked(states.score, torch.max),
        "length_mean": masked_mean(states.steps),
        "lines_mean": masked_mean(states.lines),
        # per-episode spread of the lines, so a caller can size its margins
        "lines_std": masked(states.lines.to(torch.float32), lambda v: v.std(unbiased=False)),
        "truncated": int((~done).sum()),
        "max_steps": int(max_steps),
    }


def evaluate_policy(
    act: Callable[[torch.Tensor], torch.Tensor],
    n_episodes: int,
    env_config: EngineConfig,
    key,
    impl: str = "turbo",
    max_steps: int = 2000,
    frame_stack: int = 1,
    obs: str = "board",
    device="cuda",
) -> dict:
    """Greedy-rollout statistics of ``act`` over ``n_episodes`` fresh games.

    ``act(obs) -> int32[B]`` is the policy; it sees the observation ``obs``
    names (the board ``int8[B, H, W]`` or the frame ``uint8[B, 84, 84]``),
    or with ``frame_stack`` K > 1 the window ``[B, K, ...]`` the training
    actor saw (pushed with each step's ``done``).  ``key`` is a
    ``uint32[2]`` base key (``threefry.prng_key(seed)``), folded into one key
    per episode exactly as the JAX package does.  The returned dict also
    holds ``iterations``, the number of steps the loop ran.
    """
    cfg = env_config._replace(auto_reset=False)
    init, step, observe = env_fns(cfg, impl, obs=obs, device=device, step_obs=True)
    states = init(batch_keys(key, n_episodes, device=device))
    stack = framestack.init(observe(states), frame_stack) if frame_stack > 1 else None
    it, seen = 0, None  # seen: the step's observation of states, where it made one
    while it < max_steps:
        if stack is None:
            states, seen, *_ = step(states, act(observe(states) if seen is None else seen))
        else:
            states, seen, _, done, _ = step(states, act(stack))
            stack = framestack.push(stack, observe(states) if seen is None else seen, done)
        it += 1
        if it % DONE_CHECK_EVERY == 0 and bool(states.game_over.all()):
            break
    out = _stats(states, max_steps)
    out["iterations"] = it
    return out


def evaluate_grouped(
    act: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    n_episodes: int,
    env_config: EngineConfig,
    key,
    mode: str = "features",
    max_steps: int = 512,
    device="cuda",
) -> dict:
    """Greedy placement-policy statistics on the turbo grouped engine.

    ``act(obs, mask f32[B, A]) -> int32[B]`` scores every candidate; an
    illegal choice ends its episode (``terminate_on_illegal``).  Like
    :func:`evaluate_policy`, the loop stops early once every game is over.
    """
    from tetris_gymnasium_torch.core import turbo_grouped

    cfg = env_config._replace(auto_reset=False)
    gstates, obs = turbo_grouped.reset(batch_keys(key, n_episodes, device=device), cfg, mode=mode,
                                       device=device)
    it = 0
    while it < max_steps:
        action = act(obs, gstates.mask.T)
        gstates, obs, *_ = turbo_grouped.step(gstates, action, cfg, mode=mode)
        it += 1
        if it % DONE_CHECK_EVERY == 0 and bool(gstates.env.game_over.all()):
            break
    out = _stats(gstates.env, max_steps)
    out["iterations"] = it
    return out


def greedy_masked_q(net) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Grouped policy: argmax of the candidates' Q over the legal ones (illegal at -inf).

    On the card the ``grouped_act`` kernel takes the masked argmax.
    """
    from tetris_gymnasium_torch.rl.grouped_dqn import act as masked_act

    def act(obs, mask):
        with torch.inference_mode():
            q = net(obs)
        return masked_act(q, mask, fill=float("-inf"))

    return act


def greedy_q(net) -> Callable[[torch.Tensor], torch.Tensor]:
    """Policy from a Q-network: argmax over the action values.

    On the card the ``dqn_act`` kernel takes the argmax.
    """
    from tetris_gymnasium_torch.rl.dqn import act as dqn_act

    def act(obs):
        with torch.inference_mode():
            q = net(obs)
        return dqn_act(q)

    return act


def evaluate_q_checkpoint(
    net,
    n_episodes: int,
    env_config: EngineConfig,
    seed: int = 0,
    impl: str = "turbo",
    max_steps: int = 2000,
    frame_stack: int = 1,
    obs: str = "board",
    device="cuda",
) -> dict:
    """Greedy statistics of a Q-net (its own weights) over ``n_episodes``
    fresh games from ``prng_key(seed)`` (``evaluate.py:162``)."""
    return evaluate_policy(greedy_q(net), n_episodes, env_config, prng_key(seed), impl=impl,
                           max_steps=max_steps, frame_stack=frame_stack, obs=obs, device=device)


def greedy_logits(net) -> Callable[[torch.Tensor], torch.Tensor]:
    """Policy from an actor-critic: argmax over the policy logits."""

    def act(obs):
        with torch.inference_mode():
            logits, _ = net(obs)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return act


def evaluate_file(
    checkpoint: str,
    net: str = "actor-critic",
    impl: str = "turbo",
    obs: str = "board",
    frame_stack: int = 1,
    episodes: int = 512,
    seed: int = 0,
    max_steps: int = 2000,
    width: int = 10,
    height: int = 20,
    dtype: str = "bfloat16",
    device="cuda",
) -> dict:
    """Greedy statistics of an exported ``.npz`` (``net`` ``"actor-critic"``
    or ``"q"``) over ``episodes`` fresh games from ``prng_key(seed)`` on a
    ``width`` x ``height`` board: what :func:`main` and
    ``examples/evaluate_checkpoint.py`` run."""
    from tetris_gymnasium_torch.utils.checkpoint import load_actor_critic, load_q_net

    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dtype)
    if obs == "rgb84":
        impl = "flagship"
    if net == "q":
        kind = "atari_q" if obs == "rgb84" else "q_cnn"
        act = greedy_q(load_q_net(checkpoint, kind, device=device, dtype=dtype,
                                  board_shape=(height, width)))
    else:  # the kind, ActorCriticCNN or AtariActorCritic, is read from the weights
        act = greedy_logits(load_actor_critic(checkpoint, device=device, dtype=dtype))
    return evaluate_policy(
        act, episodes, EngineConfig(width=width, height=height), prng_key(seed), impl=impl,
        max_steps=max_steps, frame_stack=frame_stack, obs=obs, device=device,
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True, help="exported .npz (tools/export_torch_params.py)")
    p.add_argument("--net", choices=("actor-critic", "q"), default="actor-critic",
                   help="the checkpoint's network: ActorCriticCNN or QNetworkCNN "
                   "(AtariActorCritic or AtariQNetwork with --obs rgb84)")
    p.add_argument("--impl", choices=("flagship", "turbo"), default="turbo",
                   help="engine (--obs rgb84 selects flagship)")
    p.add_argument("--obs", choices=("board", "rgb84"), default="board")
    p.add_argument("--frame-stack", type=int, default=1,
                   help="K: the net reads [B, K, H, W] windows")
    p.add_argument("--episodes", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=2000)
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--height", type=int, default=20)
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                   help="compute type of the conv trunk (the heads are float32)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    stats = evaluate_file(
        args.checkpoint, args.net, args.impl, args.obs, args.frame_stack, args.episodes,
        args.seed, args.max_steps, args.width, args.height, args.dtype, args.device,
    )
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in stats.items()}))
    return stats


if __name__ == "__main__":
    main()
