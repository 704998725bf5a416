"""Grouped-placement DQN: Q over (column, rotation) placements, on one card.

Port of ``tetris_gymnasium_tpu/rl/grouped_dqn.py``.  The Q-network scores
each candidate placement's observation (features with :class:`QMLP`, or
binary boards with :class:`QGroupedBoardsCNN`), exploration and the greedy
argmax respect the legality mask, and the replay stores every observation
once (:func:`buffers.sample_with_next`).  JAX traces a train step into one
XLA program; here the host enqueues it without waiting for the card:

* the masked epsilon-greedy is the ``grouped_act`` kernel (Gumbel noise with
  JAX's bits, both masked argmaxes and the exploration draw in one launch);
* the env step is :func:`turbo_grouped.step` (``turbo_step``,
  ``turbo_init`` and ``grouped_placements`` kernels);
* the replay write is one ``replay_add`` launch and the sample one
  ``replay_sample`` launch;
* the TD loss, its backward pass and Adam are PyTorch operators, as the JAX
  package leaves them to XLA and optax.

Every key of the JAX chain (the three-way split of the init key, the
four-way split per step) is computed on the host in numpy, and so are the
two conditions that depend only on the step count: whether the learner
updates (``lax.cond`` at ``:198``) and whether the target network syncs
(``:220``).  As in :mod:`tetris_gymnasium_torch.rl.ppo`, the network and
the optimizer of the state are updated in place.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import turbo_grouped
from tetris_gymnasium_torch.models.convert import from_flax_params
from tetris_gymnasium_torch.models.init import init_lecun_
from tetris_gymnasium_torch.models.networks import QGroupedBoardsCNN, QMLP
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.rl import buffers
from tetris_gymnasium_torch.utils.device import resolve_device

NEG_INF = -1e9


class GroupedDQNConfig(NamedTuple):
    """Static hyperparameters, the JAX package's fields and defaults (``grouped_dqn.py:34``)."""

    buffer_size: int = 131_072
    gamma: float = 0.99
    learning_rate: float = 2.5e-4
    batch_size: int = 256
    start_eps: float = 1.0
    end_eps: float = 0.05
    exploration_steps: int = 50_000
    learning_starts: int = 1_000
    target_update_every: int = 500


@dataclasses.dataclass
class GroupedDQNState:
    """Everything the grouped DQN loop carries."""

    net: nn.Module
    target_net: nn.Module
    optimizer: torch.optim.Adam
    buffer: buffers.ReplayBuffer
    env_states: turbo_grouped.TurboGroupedState
    obs: torch.Tensor  # float32 [B, A, F] or [B, A, H, W]
    step: int
    key: np.ndarray  # uint32[2], on the host

    def replace(self, **kw) -> "GroupedDQNState":
        return dataclasses.replace(self, **kw)


def net_kind(net: nn.Module) -> str:
    """The :mod:`~tetris_gymnasium_torch.models.convert` kind of a grouped Q-net."""
    if isinstance(net, QMLP):
        return "qmlp"
    if isinstance(net, QGroupedBoardsCNN):
        return "grouped_cnn"
    raise TypeError(f"not a grouped Q-net: {type(net).__name__}")


def epsilon_at(cfg: GroupedDQNConfig, step: int) -> np.float32:
    """The exploration rate of step ``step``, in float32 (``_epsilon :67``).

    Rounded as XLA compiles the JAX function: the division by the constant
    ``exploration_steps`` becomes a product with its float32 reciprocal,
    and the multiply-add is fused (one rounding, emulated in float64, where
    the product of two float32 values is exact).
    """
    recip = np.float32(1) / np.float32(cfg.exploration_steps)
    frac = np.float32(np.clip(np.float32(step) * recip, 0.0, 1.0))
    slope = np.float64(np.float32(cfg.end_eps - cfg.start_eps))
    return np.float32(np.float64(np.float32(cfg.start_eps)) + np.float64(frac) * slope)


def masked_q(net: nn.Module, obs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Q per candidate ``[B, A]``, illegal candidates at ``NEG_INF`` (``_masked_q :72``)."""
    return torch.where(mask > 0, net(obs), NEG_INF)


def act_plain(q: torch.Tensor, mask: torch.Tensor, act_key=None, eps_key=None,
              epsilon: float = 0.0, fill: float = NEG_INF) -> torch.Tensor:
    """Plain version of the ``grouped_act`` kernel: actions ``int32[B]``.

    ``q`` and ``mask`` are ``[B, A]``.  Without keys the action is the
    argmax of ``where(mask > 0, q, fill)``; with them an env explores where
    ``uniform(eps_key, [B]) < epsilon`` and then takes the argmax of
    ``where(mask > 0, gumbel(act_key, [B, A]), fill)`` (``train_step
    :165-174``, ``_masked_random :78``), JAX's draws bit for bit.
    """
    legal = mask > 0
    action = torch.argmax(torch.where(legal, q, fill), dim=-1)
    if act_key is not None:
        B, A = q.shape
        counters = torch.arange(B * A, dtype=torch.int64, device=q.device).reshape(B, A)
        noise = threefry.gumbel_lanes(act_key, counters)
        random_a = torch.argmax(torch.where(legal, noise, fill), dim=-1)
        u = threefry.bits_to_uniform_lanes(
            threefry.random_bits32_lanes(eps_key, torch.arange(B, dtype=torch.int64, device=q.device)))
        action = torch.where(u < float(np.float32(epsilon)), random_a, action)
    return action.to(torch.int32)


def act(q: torch.Tensor, mask: torch.Tensor, act_key=None, eps_key=None,
        epsilon: float = 0.0, fill: float = NEG_INF) -> torch.Tensor:
    """Masked epsilon-greedy actions: the ``grouped_act`` kernel on CUDA
    tensors, :func:`act_plain` on CPU tensors."""
    if q.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.grouped_act(q, mask, act_key, eps_key, epsilon, fill)
    return act_plain(q, mask, act_key, eps_key, epsilon, fill)


def init_grouped_dqn_state(
    key,
    n_envs: int,
    env_config: EngineConfig,
    cfg: GroupedDQNConfig,
    net: Optional[nn.Module] = None,
    mode: str = "features",
    device="cuda",
    params: Optional[Dict[str, np.ndarray]] = None,
) -> GroupedDQNState:
    """Fresh networks, empty buffer and a fresh grouped env batch, from a ``uint32[2]`` key.

    As in JAX, the key splits three ways into the carried key, the
    network's key and the env key, and env ``i`` starts from
    ``fold_in(env_key, i)``.  ``net`` defaults to :class:`QMLP` sized for
    ``env_config``; its weights are drawn with Flax's initialisers from a
    ``torch.Generator`` seeded with the network key, unless ``params``,
    flat Flax parameters (e.g. from a JAX state or an ``.npz``), are given.
    """
    device = resolve_device(device)
    key, net_key, env_key = threefry.split(np.asarray(key, dtype=np.uint32), 3)
    env_states, obs = turbo_grouped.reset(batch_keys(env_key, n_envs, device=device), env_config,
                                          mode=mode, device=device)
    net = (QMLP(n_features=turbo_grouped.n_features(env_config)) if net is None else net).cpu()
    if params is None:
        gen = torch.Generator()
        gen.manual_seed((int(net_key[0]) << 32) | int(net_key[1]))
        init_lecun_(net, gen)
    else:
        net.load_state_dict(from_flax_params(params, net_kind(net)))
    net = net.to(device)
    example = {
        "obs": obs,
        "mask": torch.zeros((n_envs, turbo_grouped.n_actions(env_config)), dtype=torch.float32,
                            device=device),
        "action": torch.zeros((n_envs,), dtype=torch.int32, device=device),
        "reward": torch.zeros((n_envs,), dtype=torch.float32, device=device),
        "done": torch.zeros((n_envs,), dtype=torch.bool, device=device),
    }
    return GroupedDQNState(
        net=net,
        target_net=copy.deepcopy(net),
        optimizer=torch.optim.Adam(net.parameters(), lr=cfg.learning_rate, eps=1e-8),
        buffer=buffers.create(example, cfg.buffer_size, n_envs),
        env_states=env_states,
        obs=obs,
        step=0,
        key=key,
    )


def td_loss(net: nn.Module, target_net: nn.Module, batch: Dict[str, torch.Tensor],
            gamma: float) -> torch.Tensor:
    """Mean squared TD error of the sampled transitions (``make_train_step :154-162``)."""
    q = masked_q(net, batch["obs"], batch["mask"])
    q_taken = q.gather(1, batch["action"].long()[:, None]).squeeze(1)
    with torch.no_grad():
        q_next = masked_q(target_net, batch["next_obs"], batch["next_mask"])
        # a terminal next state may have an all-illegal mask; clamp the max
        best_next = q_next.max(dim=-1).values.clamp_min(0.0)
        not_done = 1.0 - batch["done"].to(torch.float32)
        target = batch["reward"] + gamma * not_done * best_next
    return torch.mean((q_taken - target) ** 2)


def make_train_step(
    env_config: EngineConfig,
    cfg: GroupedDQNConfig,
    mode: str = "features",
    marks: Optional[Callable[[str], None]] = None,
):
    """The grouped DQN step: act, env step, replay add, learner update, target sync.

    ``env_config`` should have ``gravity_enabled=False`` and
    ``auto_reset=True``; ``mode`` must match :func:`init_grouped_dqn_state`.
    ``train_step(ts) -> (ts, metrics)``; ``metrics`` holds 0-dim tensors on
    the env's device with the JAX package's keys, and reading them is the
    only thing that waits for the card.  ``marks``, if given, is called with
    ``"start"``, ``"act"``, ``"env"``, ``"add"``, ``"update"`` and ``"sync"``
    as each part has been enqueued (a caller can record CUDA events there).
    """
    mark = marks or (lambda _name: None)

    def train_step(ts: GroupedDQNState):
        mark("start")
        key, eps_key, act_key, sample_key = threefry.split(ts.key, 4)
        n = ts.obs.shape[0]
        mask = ts.env_states.mask.T  # the engine keeps [A, B]; the network side reads [B, A]
        eps = epsilon_at(cfg, ts.step)
        with torch.no_grad():
            q = ts.net(ts.obs)
        action = act(q, mask, act_key, eps_key, eps)
        mark("act")
        env_states, next_obs, reward, done, info = turbo_grouped.step(
            ts.env_states, action, env_config, mode=mode, terminate_on_illegal=True)
        mark("env")
        # entry t + 1 holds this step's next_obs and mask, so the successor
        # entry is the transition's next state (buffers.sample_with_next)
        buffer = buffers.add(ts.buffer, {"obs": ts.obs, "mask": mask, "action": action,
                                         "reward": reward, "done": done})
        mark("add")
        # two blocks must be resident for the successor links: step >= 1
        learn = ts.step >= cfg.learning_starts and ts.step >= 1
        if learn:
            cur, nxt = buffers.sample_with_next(buffer, sample_key, cfg.batch_size, n)
            batch = {**cur, "next_obs": nxt["obs"], "next_mask": nxt["mask"]}
            loss = td_loss(ts.net, ts.target_net, batch, cfg.gamma)
            ts.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            ts.optimizer.step()
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=reward.device)
        mark("update")
        if learn and ts.step % cfg.target_update_every == 0:
            ts.target_net.load_state_dict(ts.net.state_dict())
        mark("sync")
        metrics = {
            "loss": loss,
            "epsilon": torch.full((), float(eps), dtype=torch.float32, device=reward.device),
            "mean_reward": reward.mean(),
            "episodes_done": done.sum(),
            "lines_cleared": info["lines_cleared"].sum(),
        }
        new_ts = ts.replace(buffer=buffer, env_states=env_states, obs=next_obs,
                            step=ts.step + 1, key=key)
        return new_ts, metrics

    return train_step
