"""PPO: envs, rollout buffer, policy and learner on one card.

Port of ``tetris_gymnasium_tpu/rl/ppo.py`` with board observations, on the
turbo or the flagship engine (``impl``), or with the reference's 84x84 gray
frames (``obs="rgb84"``, flagship engine, :class:`AtariActorCritic`), with or
without a frame stack.  The
algorithm, the hyperparameters and the random draws are the JAX package's;
what changes is the execution.  JAX traces a whole rollout-plus-update
iteration into one XLA program; here the host runs the loops and enqueues
work on the card without waiting for it:

* the rollout steps ``rollout_len`` times under ``torch.no_grad()``: the
  policy network (PyTorch operators), then on the turbo engine one
  ``turbo_step`` launch that samples the action and its log-prob from the
  logits, steps with auto-reset and writes the board observation
  (:func:`turbo_sample_step`); on the flagship engine one ``flagship_step``
  launch that samples the action and steps, then ``flagship_observe_board``
  (or ``render_rgb84`` for 84x84 frames; :func:`flagship_sample_step`;
  :func:`sample_step_fn` picks the route); with ``frame_stack`` K > 1 then
  the ``framestack_push`` kernel (the policy reads ``[B, K, H, W]``
  windows);
* GAE is the ``gae`` kernel, one launch per train step;
* the update is ``update_epochs`` passes over block-shuffled minibatches:
  the loss, its backward pass and Adam are PyTorch operators, as the JAX
  package leaves them to XLA and optax.

Every key of the JAX chain (``init_train_state``'s three-way split, the
per-step ``split`` for the action key, the per-epoch ``split`` for the
permutation key) is computed on the host in numpy
(:mod:`tetris_gymnasium_torch.ops.threefry`), so drawing a key never waits
for the card.  Each kernel's plain PyTorch version is in this module
(:func:`gae_plain`, :func:`sample_actions_plain`) or in ``core.turbo``; a
CPU tensor runs the plain version and a CUDA tensor launches the kernel.

Unlike the pure JAX ``train_step``, the port's updates the network and the
optimizer of the :class:`TrainState` it is given in place (no second copy
of the parameters and Adam moments); the returned state shares them.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import engine, turbo
from tetris_gymnasium_torch.models.convert import from_flax_params
from tetris_gymnasium_torch.models.init import init_actor_critic_
from tetris_gymnasium_torch.models.networks import ActorCriticCNN, AtariActorCritic
from tetris_gymnasium_torch.ops import framestack, threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.rl.engines import env_fns
from tetris_gymnasium_torch.utils.checkpoint import actor_critic_kind
from tetris_gymnasium_torch.utils.device import resolve_device

class PPOConfig(NamedTuple):
    """Static PPO hyperparameters, the JAX package's fields and defaults
    (``tetris_gymnasium_tpu/rl/ppo.py:34-71``)."""

    rollout_len: int = 128
    update_epochs: int = 6
    n_minibatches: int = 8
    gamma: float = 0.999
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.1
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    learning_rate: float = 2.5e-4
    # samples move in blocks of this many adjacent envs at one timestep
    shuffle_block: int = 64
    # annealing horizon in train steps; 0 disables both schedules
    total_iterations: int = 0
    ent_coef_final: float = 0.0
    frame_stack: int = 1


class Transition(NamedTuple):
    """One rollout, every field ``[T, B, ...]`` (``obs`` is ``int8[T, B, H, W]``, or
    ``int8[T, B, K, H, W]`` with a frame stack; frames are ``uint8[T, B, (K,) 84, 84]``)."""

    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=1e-5))``
    (``tetris_gymnasium_tpu/rl/ppo.py:97-116``) over ``params``.

    :meth:`step` reads every parameter's ``.grad`` and

    * clips in optax's form: with ``norm`` the global L2 norm of all
      gradients, each becomes ``g / norm * max_norm`` when
      ``norm >= max_norm`` and stays as it is otherwise (no epsilon, unlike
      ``torch.nn.utils.clip_grad_norm_``);
    * sets the learning rate of update ``count`` (0, 1, ...) from optax's
      linear schedule: ``lr * (1 - min(count, N) / N)`` in float32 with
      ``N = total_iterations * update_epochs * n_minibatches``, or ``lr``
      when ``total_iterations`` is 0;
    * takes one ``torch.optim.Adam(eps=1e-5)`` step, the same update as
      ``optax.adam``.

    No step reads a value back from the card.
    """

    def __init__(self, params, ppo: PPOConfig):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=ppo.learning_rate, eps=1e-5)
        self.max_norm = ppo.max_grad_norm
        self.learning_rate = ppo.learning_rate
        self.transition_steps = ppo.total_iterations * ppo.update_epochs * ppo.n_minibatches
        self.count = 0

    def lr(self, count: int) -> float:
        if self.transition_steps <= 0:
            return self.learning_rate
        n = np.float32(self.transition_steps)
        frac = np.float32(1) - np.float32(min(max(count, 0), self.transition_steps)) / n
        return float(np.float32(self.learning_rate) * frac)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:  # a parameter the loss does not reach has a zero gradient in JAX
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        self.adam.param_groups[0]["lr"] = self.lr(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        """Adam's state and the update count (the schedule's position)."""
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(ppo: PPOConfig, params) -> ClippedAdam:
    """Adam with global-norm clipping and the optional linear decay of the learning rate."""
    return ClippedAdam(params, ppo)


@dataclasses.dataclass
class TrainState:
    """Everything a PPO iteration carries."""

    net: torch.nn.Module  # ActorCriticCNN, or AtariActorCritic over 84x84 frames
    optimizer: ClippedAdam
    env_states: object  # turbo.TurboState or engine.EngineState
    last_obs: torch.Tensor  # [B, H, W], or the window [B, K, H, W] with frame_stack K > 1
    key: np.ndarray  # uint32[2], on the host
    update_i: int = 0  # train steps taken; drives the annealing schedules

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def init_train_state(
    key,
    n_envs: int,
    env_config: EngineConfig,
    ppo: PPOConfig,
    net: Optional[torch.nn.Module] = None,
    impl: str = "turbo",
    obs: str = "board",
    device="cuda",
    params: Optional[Dict[str, np.ndarray]] = None,
    mesh=None,
) -> TrainState:
    """Parameters, optimizer and a fresh env batch, from a ``uint32[2]`` key.

    As in JAX, the key splits three ways into the carried key, the network's
    key and the env key, and env ``i`` starts from ``fold_in(env_key, i)``.
    ``net`` gives the architecture (default :class:`ActorCriticCNN`, or with
    ``obs="rgb84"`` :class:`AtariActorCritic`, bf16 trunks, over
    ``ppo.frame_stack`` channels); with ``frame_stack`` K > 1 the carried
    observation is the first one repeated K times (``ppo.py:138``).  Its
    weights are drawn with Flax's initialisers from a ``torch.Generator``
    seeded with the network key, unless ``params``, flat Flax parameters
    (``{flax/path: array}``, e.g. from a JAX state or an ``.npz``), are given.

    With ``mesh`` (:class:`~tetris_gymnasium_torch.parallel.mesh.EnvMesh`)
    ``n_envs`` is the global count: the state holds this rank's envs ``[lo,
    hi)`` on the mesh's device (``device`` is ignored), and the network,
    drawn from the same key on every rank, is replicated.
    """
    lo, hi = (0, n_envs) if mesh is None else mesh.env_slice(n_envs)
    device = resolve_device(device if mesh is None else mesh.device)
    env_init, _, env_observe = env_fns(env_config, impl, obs=obs, device=device)
    key, net_key, env_key = threefry.split(np.asarray(key, dtype=np.uint32), 3)
    env_states = env_init(batch_keys(env_key, hi - lo, device=device, start=lo))
    raw = env_observe(env_states)
    obs_0 = raw if ppo.frame_stack == 1 else framestack.init(raw, ppo.frame_stack)
    if net is None:
        net = (AtariActorCritic if obs == "rgb84" else ActorCriticCNN)(in_channels=ppo.frame_stack)
    net = net.cpu()
    if params is None:
        gen = torch.Generator()
        gen.manual_seed((int(net_key[0]) << 32) | int(net_key[1]))
        init_actor_critic_(net, gen)
    else:
        net.load_state_dict(from_flax_params(params, actor_critic_kind(net)))
    net = net.to(device)
    return TrainState(
        net=net, optimizer=make_optimizer(ppo, net.parameters()), env_states=env_states,
        last_obs=obs_0, key=key, update_i=0,
    )


# ---------------------------------------------------------------------------
# GAE
# ---------------------------------------------------------------------------


def gae_plain(reward, value, done, last_value, gamma: float, gae_lambda: float):
    """Plain version of the ``gae`` kernel: ``(advantages, targets)``, ``f32[T, B]`` each.

    The reverse recursion of ``tetris_gymnasium_tpu/rl/ppo.py:_gae`` (:147)
    in JAX's order of operations, with ``gamma`` and ``gamma * gae_lambda``
    rounded to float32 once; on the card it is bit-equal to the kernel.
    """
    g = float(np.float32(gamma))
    gl = float(np.float32(gamma * gae_lambda))
    not_done = 1.0 - done.to(torch.float32)
    adv = torch.empty_like(reward)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(reward.shape[0] - 1, -1, -1):
        delta = reward[t] + g * next_value * not_done[t] - value[t]
        gae = delta + gl * not_done[t] * gae
        adv[t] = gae
        next_value = value[t]
    return adv, adv + value


def gae(ppo: PPOConfig, traj: Transition, last_value: torch.Tensor):
    """Advantages and value targets of a rollout (``ppo.py:_gae``): the
    ``gae`` kernel on CUDA tensors, :func:`gae_plain` on CPU tensors."""
    args = (traj.reward, traj.value, traj.done, last_value, ppo.gamma, ppo.gae_lambda)
    if traj.reward.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.gae(*args)
    return gae_plain(*args)


# ---------------------------------------------------------------------------
# Sampling tail of the policy step
# ---------------------------------------------------------------------------


def sample_actions_plain(logits: torch.Tensor, act_key, env_offset: int = 0):
    """Plain version of the ``ppo_sample`` kernel: ``(action int32[B], log_prob f32[B])``.

    ``jax.random.categorical(act_key, logits)`` (Gumbel-max, JAX's bits) and
    ``log_softmax(logits)[b, action]`` (``ppo.py:186-187``).  Row ``b`` is
    global env ``env_offset + b`` of a larger batch: its noise is at counters
    ``(env_offset + b) * A + a``, the rows of JAX's draw over the whole
    batch.  The sum of the log-softmax is taken pairwise (halves added, as
    the kernel's butterfly adds), so that on the card the two agree bit for
    bit.
    """
    B, A = logits.shape
    counters = torch.arange(env_offset * A, (env_offset + B) * A, dtype=torch.int64,
                            device=logits.device).reshape(B, A)
    action = torch.argmax(threefry.gumbel_lanes(act_key, counters) + logits, dim=-1)
    m = logits.max(dim=-1, keepdim=True).values
    z = logits - m
    s = torch.exp(z)
    width = 1 << max(A - 1, 0).bit_length()  # pad with exact zeros to a power of two
    s = F.pad(s, (0, width - A))
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[:, :h] + s[:, h:]
    log_prob = z.gather(1, action[:, None]).squeeze(1) - torch.log(s[:, 0])
    return action.to(torch.int32), log_prob


def sample_actions(logits: torch.Tensor, act_key, env_offset: int = 0):
    """Sampled actions and their log-probs: the ``ppo_sample`` kernel on CUDA
    tensors, :func:`sample_actions_plain` on CPU tensors."""
    if logits.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.sample_actions(logits, act_key, env_offset=env_offset)
    return sample_actions_plain(logits, act_key, env_offset)


def turbo_sample_step(state: turbo.TurboState, logits: torch.Tensor, act_key,
                      config: EngineConfig, rewards: RewardsMapping = turbo.REWARDS,
                      env_offset: int = 0):
    """The turbo engine's rollout step with the board observation: sample
    each env's action from ``logits`` ``f32[B, 8]`` with the step's
    ``uint32[2]`` key ``act_key`` (as :func:`sample_actions`, env ``b``
    being global env ``env_offset + b``), step with it and observe.

    Returns ``(state, obs, reward, done, info, action int32[B], log_prob
    f32[B])``.  On CUDA tensors it is one ``turbo_step`` launch, which
    samples, steps and writes the observation; on CPU tensors it is
    :func:`sample_actions_plain`, ``turbo.step_plain`` and
    ``turbo.observe_board_plain`` in turn.
    """
    if state.rows.is_cuda:
        from tetris_gymnasium_torch import kernels

        B = state.piece.shape[0]
        obs = torch.empty((B, config.height, config.width), dtype=torch.int8,
                          device=state.rows.device)
        stepped, reward, done, lines, action, log_prob = kernels.turbo_step(
            state, None, config, turbo.PIECES, rewards, obs=obs, logits=logits, act_key=act_key,
            env_offset=env_offset)
    else:
        action, log_prob = sample_actions_plain(logits, act_key, env_offset)
        stepped, reward, done, lines = turbo.step_plain(state, action, config, turbo.PIECES,
                                                        rewards)
        obs = turbo.observe_board_plain(stepped, config)
    info = {"lines_cleared": lines, "score": stepped.score, "steps": stepped.steps}
    return stepped, obs, reward, done, info, action, log_prob


def flagship_sample_step(state: engine.EngineState, logits: torch.Tensor, act_key,
                         config: EngineConfig, obs: str = "board",
                         rewards: RewardsMapping = engine.REWARDS, env_offset: int = 0):
    """The flagship engine's rollout step: sample each env's action from
    ``logits`` ``f32[B, 8]`` with the step's ``uint32[2]`` key ``act_key``
    (as :func:`sample_actions`, env ``b`` being global env ``env_offset +
    b``), step with it and observe (``obs`` ``"board"``, or ``"rgb84"`` for
    the 84x84 gray frame).

    Returns what :func:`turbo_sample_step` returns.  On CUDA tensors it is
    one ``flagship_step`` launch that samples and steps, then the
    observation's launch (``flagship_observe_board`` or ``render_rgb84``);
    on CPU tensors it is :func:`sample_actions_plain`, ``engine.step_plain``
    and the observation's plain version in turn.
    """
    if state.board.is_cuda:
        from tetris_gymnasium_torch import kernels

        stepped, reward, done, lines, action, log_prob = kernels.flagship_step(
            state, None, config, engine.PIECES, rewards, logits=logits, act_key=act_key,
            env_offset=env_offset)
    else:
        action, log_prob = sample_actions_plain(logits, act_key, env_offset)
        stepped, reward, done, lines = engine.step_plain(state, action, config, engine.PIECES,
                                                         rewards)
    raw = (engine.render_rgb84 if obs == "rgb84" else engine.observe_board)(stepped, config)
    info = {"lines_cleared": lines, "score": stepped.score, "steps": stepped.steps}
    return stepped, raw, reward, done, info, action, log_prob


def composed_sample_step(env_step: Callable, observe: Callable, env_offset: int = 0) -> Callable:
    """A rollout step of :func:`sample_actions`, then ``env_step`` (from
    ``rl.engines.env_fns``), then ``observe`` where the step gave no
    observation, in a launch each; it returns what
    :func:`turbo_sample_step` returns.  No route takes it: it is the
    composition that the fused routes are held to."""

    def sample_step(state, logits, act_key):
        action, log_prob = sample_actions(logits, act_key, env_offset)
        state, raw, reward, done, info = env_step(state, action)
        raw = observe(state) if raw is None else raw
        return state, raw, reward, done, info, action, log_prob

    return sample_step


def sample_step_fn(env_config: EngineConfig, impl: str = "turbo",
                   rewards: Optional[RewardsMapping] = None, obs: str = "board",
                   env_offset: int = 0) -> Callable:
    """The rollout step ``sample_step(state, logits, act_key) -> (state,
    obs, reward, done, info, action, log_prob)`` of an engine route:
    :func:`turbo_sample_step` on the turbo engine (board observations),
    :func:`flagship_sample_step` on the flagship engine (board or 84x84
    frames); on the card each samples the action in its step's launch.  It
    runs where the state lies; ``env_offset`` is the global index of the
    batch's env 0 (a rank's first env), where the sampling counters start."""
    env_fns(env_config, impl, rewards, obs=obs, device="cpu")  # refuses an unknown route
    rkw = {} if rewards is None else {"rewards": rewards}
    if impl == "turbo":
        return functools.partial(turbo_sample_step, config=env_config, env_offset=env_offset,
                                 **rkw)
    return functools.partial(flagship_sample_step, config=env_config, obs=obs,
                             env_offset=env_offset, **rkw)


# ---------------------------------------------------------------------------
# Rollout, loss and minibatches
# ---------------------------------------------------------------------------


def rollout(ts: TrainState, ppo: PPOConfig, sample_step: Callable):
    """``rollout_len`` policy steps from ``ts``, with no gradient.

    Each step samples the action from the policy's logits and steps the
    envs with ``sample_step`` (:func:`sample_step_fn`).  Returns ``(traj,
    env_states, last_obs, key)``: the :class:`Transition` over time, the env
    batch and observation (or window, pushed with each step's ``done``,
    ``ppo.py:180-190``) after the last step, and the carried key after one
    ``split`` per step.  Each step's fields are copied into ``[T, ...]``
    tensors allocated at the first step, so the rollout's windows are held
    once (T x B x K x 7056 bytes of 84x84 frames), not twice as a list and
    its stack.
    """
    key = ts.key
    act_keys = []
    for _ in range(ppo.rollout_len):
        key, act_key = threefry.split(key)
        act_keys.append(act_key)
    env_states, window = ts.env_states, ts.last_obs
    traj: Optional[Transition] = None
    with torch.no_grad():
        for t, act_key in enumerate(act_keys):
            logits, value = ts.net(window)
            env_states, raw, reward, done, _, action, log_prob = sample_step(
                env_states, logits, act_key)
            step = (window, action, log_prob, value, reward, done)
            if traj is None:
                traj = Transition(*(x.new_empty((ppo.rollout_len,) + x.shape) for x in step))
            for field, x in zip(traj, step):
                field[t] = x
            window = raw if ppo.frame_stack == 1 else framestack.push(window, raw, done)
    return traj, env_states, window, key


def loss_fn(net, ppo: PPOConfig, batch: Transition, advantages, targets, ent_coef: float,
            adv_stats=None, count: Optional[int] = None):
    """Clipped surrogate, clipped value loss and entropy bonus (``ppo.py:194-214``).

    Returns ``(total, (pg_loss, v_loss, entropy))``.  Advantages are
    normalised with the population std (``jnp.std`` is ddof=0).

    A rank of a sharded update holds part of a global minibatch: it passes
    the global minibatch's advantage ``(mean, std)`` as ``adv_stats`` and
    its sample count as ``count``, and each mean becomes this part's sum
    over ``count``, so the ranks' losses (and gradients) add up to the
    global minibatch's.
    """
    logits, value = net(batch.obs)
    log_probs = F.log_softmax(logits, dim=-1)
    log_prob = log_probs.gather(1, batch.action.long()[:, None]).squeeze(1)
    ratio = torch.exp(log_prob - batch.log_prob)

    if adv_stats is None:
        adv = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
        mean = torch.mean
    else:
        adv = (advantages - adv_stats[0]) / (adv_stats[1] + 1e-8)
        mean = lambda x: x.sum() / count  # noqa: E731
    pg1 = -adv * ratio
    pg2 = -adv * torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps)
    pg_loss = mean(torch.maximum(pg1, pg2))

    v_clipped = batch.value + torch.clamp(value - batch.value, -ppo.clip_eps, ppo.clip_eps)
    v_loss = 0.5 * mean(torch.maximum((value - targets) ** 2, (v_clipped - targets) ** 2))

    entropy = mean(-torch.sum(torch.exp(log_probs) * log_probs, dim=-1))
    total = pg_loss + ppo.vf_coef * v_loss - ent_coef * entropy
    return total, (pg_loss, v_loss, entropy)


def shuffle_block(ppo: PPOConfig, n: int) -> int:
    """Samples per shuffle block for ``n`` rollout samples (``ppo.py:242-252``)."""
    if n % ppo.n_minibatches:
        raise ValueError(
            f"rollout samples ({n}) must divide into n_minibatches ({ppo.n_minibatches})"
        )
    return math.gcd(max(1, ppo.shuffle_block), n // ppo.n_minibatches)


def epoch_keys(key, n_epochs: int):
    """The carried key after ``n_epochs`` splits, and each epoch's permutation key."""
    perm_keys = []
    for _ in range(n_epochs):
        key, perm_key = threefry.split(key)
        perm_keys.append(perm_key)
    return key, perm_keys


def shard_minibatches(n_local_envs: int, T: int, ppo: PPOConfig, perm_keys, mesh) -> list:
    """This rank's blocks of every global minibatch of the update, in order.

    The global rollout is ``T x B`` samples with ``B = world * n_local_envs``;
    a block is ``block`` adjacent global envs at one timestep, so block ``k``
    holds envs ``(k % (B // block)) * block + [0, block)`` at timestep
    ``k // (B // block)``.  Each epoch permutes the global blocks as
    :func:`minibatches` does (the permutation computed on the host, the
    same on every rank); this returns, for each minibatch, an int64 array
    of the indices into this rank's ``[T * n_local_envs // block, block]``
    blocks of those global blocks that lie in ``[lo, hi)``, in the
    minibatch's order.  A rank may hold none of a minibatch's blocks.
    Raises ``ValueError`` unless ``block`` divides ``n_local_envs``.
    """
    B = n_local_envs * mesh.world
    n = T * B
    block = shuffle_block(ppo, n)
    if n_local_envs % block:
        raise ValueError(
            f"shuffle blocks of {block} envs do not tile a rank's {n_local_envs} envs; "
            f"pick n_envs so that {block} divides n_envs / world")
    per_t, local_per_t = B // block, n_local_envs // block
    k = np.arange(T * per_t)
    owner = (k % per_t) // local_per_t
    local = (k // per_t) * local_per_t + (k % per_t) % local_per_t
    out = []
    for perm_key in perm_keys:
        perm = threefry.permutation(perm_key, T * per_t)
        for bidx in perm.reshape(ppo.n_minibatches, -1):
            out.append(local[bidx[owner[bidx] == mesh.rank]])
    return out


def minibatches(traj: Transition, advantages, targets, ppo: PPOConfig,
                perm_keys) -> Iterator[Tuple[Transition, torch.Tensor, torch.Tensor]]:
    """Every minibatch of the update, in order: ``(batch, advantages, targets)``.

    Sample ``t * B + b`` lies in block ``(t * B + b) // block``, so a block
    is ``block`` adjacent envs at one timestep.  Epoch ``e`` permutes the
    blocks with ``jax.random.permutation(perm_keys[e], n_blocks)`` (computed
    where the rollout lies) and minibatch ``j`` takes the blocks
    ``perm.reshape(n_minibatches, -1)[j]``.
    """
    n = traj.reward.numel()
    block = shuffle_block(ppo, n)
    n_blocks = n // block
    flat = Transition(*(x.reshape((n_blocks, block) + x.shape[2:]) for x in traj))
    adv_f = advantages.reshape(n_blocks, block)
    tgt_f = targets.reshape(n_blocks, block)

    def merge(x):
        return x.reshape((-1,) + x.shape[2:])

    for perm_key in perm_keys:
        perm = threefry.permutation_lanes(perm_key, n_blocks, traj.reward.device)
        for bidx in perm.reshape(ppo.n_minibatches, -1):
            yield (Transition(*(merge(x[bidx]) for x in flat)), merge(adv_f[bidx]),
                   merge(tgt_f[bidx]))


def _sharded_update(ts: TrainState, ppo: PPOConfig, traj: Transition, advantages, targets,
                    perm_keys, ent_coef: float, mesh):
    """The update on this rank's part of each global minibatch
    (:func:`shard_minibatches`); returns the last minibatch's local loss
    terms, which add up over the ranks to the global ones.

    Two ``all_reduce`` calls give every minibatch's advantage mean and
    (ddof 0) std over the whole global minibatch, sums taken in float64;
    then each minibatch's gradient, flattened, is summed over the ranks by
    one ``all_reduce`` before :class:`ClippedAdam` clips it by its global
    norm.  A rank that holds none of a minibatch's blocks adds zeros, and
    still joins its collectives.
    """
    T, b = traj.reward.shape
    dev = traj.reward.device
    count = T * b * mesh.world // ppo.n_minibatches  # samples of a global minibatch
    parts = shard_minibatches(b, T, ppo, perm_keys, mesh)
    block = shuffle_block(ppo, T * b * mesh.world)
    n_blocks = T * b // block
    flat = Transition(*(x.reshape((n_blocks, block) + x.shape[2:]) for x in traj))
    adv_f = advantages.reshape(n_blocks, block)
    tgt_f = targets.reshape(n_blocks, block)
    host = torch.from_numpy(np.concatenate(parts).astype(np.int64))
    if dev.type == "cuda":
        host = host.pin_memory()
    idx = host.to(dev, non_blocking=True).split([len(p) for p in parts])

    def merge(x):
        return x.reshape((-1,) + x.shape[2:])

    zero = torch.zeros((), dtype=torch.float64, device=dev)
    sums = mesh.all_reduce(torch.stack([adv_f[i].sum(dtype=torch.float64) if len(p) else zero
                                        for p, i in zip(parts, idx)]))
    means = sums / count
    sq = mesh.all_reduce(torch.stack([((adv_f[i].double() - m) ** 2).sum() if len(p) else zero
                                      for p, i, m in zip(parts, idx, means)]))
    stds = torch.sqrt(sq / count)
    means, stds = means.float(), stds.float()

    aux = None
    for j, (p, i) in enumerate(zip(parts, idx)):
        ts.optimizer.zero_grad()
        if len(p):
            batch = Transition(*(merge(x[i]) for x in flat))
            total, aux = loss_fn(ts.net, ppo, batch, merge(adv_f[i]), merge(tgt_f[i]), ent_coef,
                                 (means[j], stds[j]), count)
            total.backward()
        else:
            aux = tuple(torch.zeros((), dtype=torch.float32, device=dev) for _ in range(3))
        mesh.sum_gradients(ts.optimizer.params)
        ts.optimizer.step()
    return aux


def ent_coef_at(ppo: PPOConfig, update_i: int) -> float:
    """The entropy coefficient of train step ``update_i``, in float32 (``ppo.py:220-226``)."""
    if ppo.total_iterations <= 0:
        return float(np.float32(ppo.ent_coef))
    frac = np.clip(np.float32(update_i) / np.float32(ppo.total_iterations), 0.0, 1.0)
    frac = np.float32(frac)
    return float(np.float32(ppo.ent_coef) + np.float32(ppo.ent_coef_final - ppo.ent_coef) * frac)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def make_train_step(
    env_config: EngineConfig,
    ppo: PPOConfig,
    impl: str = "turbo",
    rewards=None,
    obs: str = "board",
    marks: Optional[Callable[[str], None]] = None,
    mesh=None,
):
    """The PPO iteration: rollout ``rollout_len`` steps, GAE, then the update.

    ``env_config.auto_reset`` should be True so episodes restart on the
    card.  ``rewards`` is an optional :class:`RewardsMapping` override.
    ``train_step(ts) -> (ts, metrics)``; ``metrics`` holds 0-dim tensors on
    the rollout's device with the JAX package's keys, and reading them is
    the only thing that waits for the card.  ``marks``, if given, is called
    with ``"start"``, ``"rollout"``, ``"gae"`` and ``"update"`` as each phase
    has been enqueued (a caller can record CUDA events there).

    With ``mesh`` (the state from :func:`init_train_state` with the same
    mesh) each rank rolls out its envs ``[lo, hi)``, sampling at the global
    envs' counters, computes GAE on them, and takes part in every global
    minibatch through :func:`_sharded_update`; the metrics are the global
    ones, the same on every rank.
    """
    mark = marks or (lambda _name: None)
    sample_steps: dict = {}  # env_offset -> the rollout step

    def train_step(ts: TrainState):
        mark("start")
        ent_coef = ent_coef_at(ppo, ts.update_i)
        lo = 0 if mesh is None else mesh.rank * ts.last_obs.shape[0]
        if lo not in sample_steps:
            sample_steps[lo] = sample_step_fn(env_config, impl, rewards, obs=obs, env_offset=lo)
        traj, env_states, last_obs, key = rollout(ts, ppo, sample_steps[lo])
        with torch.no_grad():
            _, last_value = ts.net(last_obs)
        mark("rollout")
        advantages, targets = gae(ppo, traj, last_value)
        mark("gae")
        key, perm_keys = epoch_keys(key, ppo.update_epochs)
        if mesh is None:
            for batch, adv, tgt in minibatches(traj, advantages, targets, ppo, perm_keys):
                total, aux = loss_fn(ts.net, ppo, batch, adv, tgt, ent_coef)
                ts.optimizer.zero_grad()
                total.backward()
                ts.optimizer.step()
        else:
            aux = _sharded_update(ts, ppo, traj, advantages, targets, perm_keys, ent_coef, mesh)
        mark("update")
        pg_loss, v_loss, entropy = (x.detach() for x in aux)  # the last minibatch's
        device = traj.reward.device
        if mesh is None:
            mean_reward, episodes_done = traj.reward.mean(), traj.done.sum()
            mean_score = ts.env_states.score.mean()
        else:  # one all_reduce for the global terms and sums
            sums = mesh.all_reduce(torch.stack([
                pg_loss.double(), v_loss.double(), entropy.double(),
                traj.reward.sum(dtype=torch.float64), traj.done.sum().double(),
                ts.env_states.score.sum(dtype=torch.float64)]))
            pg_loss, v_loss, entropy = sums[:3].float()
            n_global = traj.reward.numel() * mesh.world
            mean_reward = (sums[3] / n_global).float()
            episodes_done = sums[4].to(torch.int64)
            mean_score = (sums[5] / (ts.last_obs.shape[0] * mesh.world)).float()
        metrics = {
            "pg_loss": pg_loss,
            "v_loss": v_loss,
            "entropy": entropy,
            "ent_coef": torch.full((), ent_coef, dtype=torch.float32, device=device),
            "mean_reward": mean_reward,
            "episodes_done": episodes_done,
            "mean_score": mean_score,
        }
        new_ts = ts.replace(env_states=env_states, last_obs=last_obs, key=key,
                            update_i=ts.update_i + 1)
        return new_ts, metrics

    return train_step
