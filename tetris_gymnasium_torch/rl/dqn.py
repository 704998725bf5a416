"""DQN with a CNN Q-net and an on-card replay buffer, optionally over frame stacks.

Port of ``tetris_gymnasium_tpu/rl/dqn.py``: on the turbo or the flagship
engine, over board observations (:class:`QNetworkCNN`) or the reference
workload's 84x84 gray frames (``obs="rgb84"``, flagship only,
:class:`AtariQNetwork`).  The algorithm, the hyperparameters and the random
draws are the JAX package's; JAX traces a train step into one XLA program,
and here the host enqueues it without waiting for the card:

* the epsilon-greedy is the ``dqn_act`` kernel (argmax, JAX's ``randint``
  and ``uniform`` draws and the select in one launch);
* the env step is the ``turbo_step`` or ``flagship_step`` kernel
  (auto-reset inside), the observation the ``observe_board``,
  ``flagship_observe_board`` or ``render_rgb84`` kernel, and with
  ``frame_stack`` K > 1 the window push the ``framestack_push`` kernel;
* the replay write is one ``replay_add`` launch (with K > 1 it stores the
  window's newest frame, read through a strided view); the sample is one
  ``replay_sample`` launch, or with K > 1 one ``replay_sample_stacked``
  launch that rebuilds the windows;
* the TD loss, its backward pass and Adam are PyTorch operators, as the JAX
  package leaves them to XLA and optax.

Every key of the JAX chain (the three-way split of the init key, the
four-way split per step) is computed on the host in numpy, and so are the
two conditions that depend only on the step count: whether the learner
updates (``lax.cond`` at ``:202``, from ``step >= learning_starts`` and
``step >= frame_stack``) and whether the target network syncs (``:210``,
every ``target_update_every`` env steps).  The network and the optimizer
of the state are updated in place.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.models.convert import from_flax_params
from tetris_gymnasium_torch.models.init import init_lecun_
from tetris_gymnasium_torch.models.networks import AtariQNetwork, QNetworkCNN
from tetris_gymnasium_torch.ops import framestack, threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.rl import buffers
from tetris_gymnasium_torch.rl.engines import env_fns
from tetris_gymnasium_torch.rl.grouped_dqn import epsilon_at  # the same schedule, end_eps 0.01
from tetris_gymnasium_torch.utils.device import resolve_device


class DQNConfig(NamedTuple):
    """Static hyperparameters, the JAX package's fields and defaults (``dqn.py:28``)."""

    buffer_size: int = 262_144
    gamma: float = 0.99
    learning_rate: float = 1e-4
    batch_size: int = 512
    start_eps: float = 1.0
    end_eps: float = 0.01
    exploration_steps: int = 100_000
    learning_starts: int = 1_000
    target_update_every: int = 500
    n_actions: int = 8
    frame_stack: int = 1


@dataclasses.dataclass
class DQNState:
    """Everything the DQN loop carries."""

    net: nn.Module
    target_net: nn.Module
    optimizer: torch.optim.Adam
    buffer: buffers.ReplayBuffer
    env_states: object  # turbo.TurboState or engine.EngineState
    obs: torch.Tensor  # int8 [B, H, W] or uint8 [B, 84, 84]; the window [B, K, ...] with K > 1
    step: int
    key: np.ndarray  # uint32[2], on the host

    def replace(self, **kw) -> "DQNState":
        return dataclasses.replace(self, **kw)


def act_plain(q: torch.Tensor, act_key=None, eps_key=None, epsilon: float = 0.0,
              env_offset: int = 0) -> torch.Tensor:
    """Plain version of the ``dqn_act`` kernel: actions ``int32[B]`` from ``q`` ``[B, A]``.

    Without keys the argmax; with them an env takes ``randint(act_key, (B,),
    0, A)`` where ``uniform(eps_key, (B,)) < epsilon`` (``train_step
    :143-147``), JAX's draws bit for bit.  Row ``b`` is global env
    ``env_offset + b``: its draws are elements ``env_offset + b`` of JAX's.
    """
    action = torch.argmax(q, dim=-1)
    if act_key is not None:
        B, A = q.shape
        random_a = threefry.randint_lanes(act_key, B, A, q.device, start=env_offset)
        u = threefry.uniform_lanes(eps_key, B, q.device, start=env_offset)
        action = torch.where(u < float(np.float32(epsilon)), random_a, action)
    return action.to(torch.int32)


def act(q: torch.Tensor, act_key=None, eps_key=None, epsilon: float = 0.0,
        env_offset: int = 0) -> torch.Tensor:
    """Epsilon-greedy actions: the ``dqn_act`` kernel on CUDA tensors,
    :func:`act_plain` on CPU tensors."""
    if q.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.dqn_act(q, act_key, eps_key, epsilon, env_offset=env_offset)
    return act_plain(q, act_key, eps_key, epsilon, env_offset)


def init_dqn_state(
    key,
    n_envs: int,
    env_config: EngineConfig,
    cfg: DQNConfig,
    net: Optional[nn.Module] = None,
    impl: str = "turbo",
    obs: str = "board",
    device="cuda",
    params: Optional[Dict[str, np.ndarray]] = None,
    mesh=None,
) -> DQNState:
    """Fresh networks, empty buffer and a fresh env batch, from a ``uint32[2]`` key.

    As in JAX, the key splits three ways into the carried key, the
    network's key and the env key, and env ``i`` starts from
    ``fold_in(env_key, i)``.  ``net`` defaults to :class:`QNetworkCNN`, or
    with ``obs="rgb84"`` to :class:`AtariQNetwork` (bf16 trunks), over
    ``cfg.frame_stack`` channels; its weights are drawn with Flax's
    initialisers from a ``torch.Generator`` seeded with the network key,
    unless ``params``, flat Flax parameters (e.g. from a JAX state or an
    ``.npz``), are given.  The replay stores single frames even when the net
    reads windows.

    With ``mesh`` (:class:`~tetris_gymnasium_torch.parallel.mesh.EnvMesh`)
    ``n_envs`` is the global count: the env state holds this rank's envs
    ``[lo, hi)`` on the mesh's device (``device`` is ignored), while the
    networks, the optimizer and the replay buffer, shaped for the global
    batch, are replicated (``dqn_state_shardings :202``).
    """
    lo, hi = (0, n_envs) if mesh is None else mesh.env_slice(n_envs)
    device = resolve_device(device if mesh is None else mesh.device)
    env_init, _, env_observe = env_fns(env_config, impl, obs=obs, device=device)
    key, net_key, env_key = threefry.split(np.asarray(key, dtype=np.uint32), 3)
    env_states = env_init(batch_keys(env_key, hi - lo, device=device, start=lo))
    raw_obs = env_observe(env_states)
    window = raw_obs if cfg.frame_stack == 1 else framestack.init(raw_obs, cfg.frame_stack)
    if net is None and obs == "rgb84":
        net = AtariQNetwork(n_actions=cfg.n_actions, in_channels=cfg.frame_stack)
    elif net is None:
        net = QNetworkCNN(n_actions=cfg.n_actions, in_channels=cfg.frame_stack,
                          board_shape=(env_config.height, env_config.width))
    net = net.cpu()
    if params is None:
        gen = torch.Generator()
        gen.manual_seed((int(net_key[0]) << 32) | int(net_key[1]))
        init_lecun_(net, gen)
    else:
        net.load_state_dict(from_flax_params(params, net_kind(net)))
    net = net.to(device)
    example = {
        "obs": raw_obs.new_empty((n_envs,) + tuple(raw_obs.shape[1:])),
        "action": torch.zeros((n_envs,), dtype=torch.int32, device=device),
        "reward": torch.zeros((n_envs,), dtype=torch.float32, device=device),
        "done": torch.zeros((n_envs,), dtype=torch.bool, device=device),
    }
    return DQNState(
        net=net,
        target_net=copy.deepcopy(net),
        optimizer=torch.optim.Adam(net.parameters(), lr=cfg.learning_rate, eps=1e-8),
        buffer=buffers.create(example, cfg.buffer_size, n_envs),
        env_states=env_states,
        obs=window,
        step=0,
        key=key,
    )


def net_kind(net: nn.Module) -> str:
    """The converter's kind of a DQN's Q-net (``models/convert.py``)."""
    return "atari_q" if isinstance(net, AtariQNetwork) else "q_cnn"


def td_loss(net: nn.Module, target_net: nn.Module, batch: Dict[str, torch.Tensor],
            next_obs: torch.Tensor, gamma: float, count: Optional[int] = None) -> torch.Tensor:
    """Mean squared TD error of the sampled transitions (``make_train_step :127-136``).

    ``next_obs`` is the same env's observation one step later; on a terminal
    transition it is the next episode's, masked out by ``not_done``.  With
    ``count`` the mean is the sum over ``count``: a rank's part of a global
    batch of ``count`` transitions.
    """
    q = net(batch["obs"])
    q_taken = q.gather(1, batch["action"].long()[:, None]).squeeze(1)
    with torch.no_grad():
        q_next = target_net(next_obs).max(dim=-1).values
        not_done = 1.0 - batch["done"].to(torch.float32)
        target = batch["reward"] + gamma * not_done * q_next
    sq = (q_taken - target) ** 2
    return torch.mean(sq) if count is None else sq.sum() / count


def _sharded_backward(net: nn.Module, target_net: nn.Module, batch: Dict[str, torch.Tensor],
                      next_obs: torch.Tensor, cfg: DQNConfig, mesh) -> torch.Tensor:
    """This rank's rows of the global batch through :func:`td_loss`, then
    one ``all_reduce`` of the flattened gradients with the loss appended;
    leaves the summed gradient in each parameter's ``.grad`` and returns
    the global loss."""
    size = cfg.batch_size
    if size % mesh.world:
        raise ValueError(f"batch_size {size} does not split evenly over {mesh.world} ranks")
    lo, hi = mesh.env_slice(size)
    part = {key: v[lo:hi] for key, v in batch.items()}
    loss = td_loss(net, target_net, part, next_obs[lo:hi], cfg.gamma, count=size)
    loss.backward()
    return mesh.sum_gradients(net.parameters(), loss.detach().reshape(1))[0]


def make_train_step(
    env_config: EngineConfig,
    cfg: DQNConfig,
    impl: str = "turbo",
    obs: str = "board",
    marks: Optional[Callable[[str], None]] = None,
    mesh=None,
):
    """The DQN step: act, env step, replay add, learner update, target sync.

    ``env_config.auto_reset`` should be True.  ``train_step(ts) -> (ts,
    metrics)``; ``metrics`` holds 0-dim tensors on the env's device with the
    JAX package's keys, and reading them is the only thing that waits for
    the card.  ``marks``, if given, is called with ``"start"``, ``"act"``,
    ``"env"``, ``"add"``, ``"update"`` and ``"sync"`` as each part has been
    enqueued (a caller can record CUDA events there).

    With ``mesh`` (the state from :func:`init_dqn_state` with the same mesh)
    each rank acts and steps its envs ``[lo, hi)`` at the global envs'
    counters, ``all_gather`` makes the step's global transition block, which
    every rank adds to its replicated buffer, and every rank samples the
    same global batch with the replicated key.  Each rank then takes its
    ``batch_size / world`` rows of it; one ``all_reduce`` sums the
    flattened gradients (and the loss), so every replica takes the same
    Adam step from the same summed gradient instead of recomputing it.  The
    metrics are the global ones.
    """
    # step and observe run where the state lies; the device only binds init
    _, env_step, observe = env_fns(env_config, impl, obs=obs, device="cpu", step_obs=True)
    mark = marks or (lambda _name: None)
    k = cfg.frame_stack

    def train_step(ts: DQNState):
        mark("start")
        key, eps_key, act_key, sample_key = threefry.split(ts.key, 4)
        n = ts.obs.shape[0]
        world = 1 if mesh is None else mesh.world
        eps = epsilon_at(cfg, ts.step)
        with torch.no_grad():
            q = ts.net(ts.obs)
        action = act(q, act_key, eps_key, eps, env_offset=0 if mesh is None else mesh.rank * n)
        mark("act")
        env_states, raw_next, reward, done, _ = env_step(ts.env_states, action)
        raw_next = observe(env_states) if raw_next is None else raw_next
        next_obs = raw_next if k == 1 else framestack.push(ts.obs, raw_next, done)
        mark("env")
        # single frames: the window's newest frame, a strided view
        stored = ts.obs if k == 1 else ts.obs[:, -1]
        block = {"obs": stored, "action": action, "reward": reward, "done": done}
        if mesh is not None:  # the global block, in global env order
            block = {k: mesh.all_gather(v) for k, v in block.items()}
        buffer = buffers.add(ts.buffer, block)
        mark("add")
        # enough blocks must be resident for the successor and lookback links
        learn = ts.step >= cfg.learning_starts and ts.step >= k
        if learn:
            if k == 1:
                batch, nxt = buffers.sample_with_next(buffer, sample_key, cfg.batch_size,
                                                      n * world)
            else:
                batch, nxt = buffers.sample_with_next_stacked(buffer, sample_key, cfg.batch_size,
                                                              n * world, k)
            ts.optimizer.zero_grad(set_to_none=True)
            if mesh is None:
                loss = td_loss(ts.net, ts.target_net, batch, nxt["obs"], cfg.gamma)
                loss.backward()
            else:
                loss = _sharded_backward(ts.net, ts.target_net, batch, nxt["obs"], cfg, mesh)
            ts.optimizer.step()
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=reward.device)
        mark("update")
        if learn and ts.step % cfg.target_update_every == 0:
            ts.target_net.load_state_dict(ts.net.state_dict())
        mark("sync")
        if mesh is None:
            mean_q, mean_reward, episodes_done = q.mean(), reward.mean(), done.sum()
        else:  # one all_reduce for the global sums
            sums = mesh.all_reduce(torch.stack([
                q.sum(dtype=torch.float64), reward.sum(dtype=torch.float64),
                done.sum().double()]))
            mean_q = (sums[0] / q.numel() / world).float()
            mean_reward = (sums[1] / (n * world)).float()
            episodes_done = sums[2].to(torch.int64)
        metrics = {
            "loss": loss,
            "mean_q": mean_q,
            "epsilon": torch.full((), float(eps), dtype=torch.float32, device=reward.device),
            "mean_reward": mean_reward,
            "episodes_done": episodes_done,
        }
        new_ts = ts.replace(buffer=buffer, env_states=env_states, obs=next_obs, step=ts.step + 1,
                            key=key)
        return new_ts, metrics

    return train_step
