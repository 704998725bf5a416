"""Env-batch sharding over ``torch.distributed``: one rank a device.

Port of ``tetris_gymnasium_tpu/parallel/mesh.py``.  The JAX package lays a
1-D ``"env"`` mesh over its devices and lets XLA partition one program
over it; here each rank of a process group is one device and holds a
contiguous slice ``[lo, hi)`` of the global env batch (:class:`EnvMesh`),
and the few collectives the algorithms need are explicit calls of the
mesh's helpers.  Parameters, optimizer state and the DQN replay buffer are
replicated: every rank holds the whole of them.

Determinism across world sizes is the JAX package's (``mesh.py:12-14``):
env ``i`` starts from ``fold_in(base_key, i)`` by its global index, and
every random draw over the batch takes global env ``lo + b``'s counters
(``threefry.randint_lanes(start=)``, the ``env_offset`` of the sampling
kernels), so a trajectory depends only on its global env index, never on
the world size.  :func:`state_checksum` certifies it: a wraparound
``uint32`` sum of every field, keyed by JAX's ``keystr`` paths, so the
dicts compare directly with the JAX package's.

A world of one needs no process group: :func:`env_mesh` then returns a
mesh whose collectives are the identity.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tetris_gymnasium_torch.config import EngineConfig, EnvConfig
from tetris_gymnasium_torch.core import engine, fn_env, turbo
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.utils.device import resolve_device

_MASK32 = 0xFFFFFFFF
# dtypes a collective moves as another of one size (torch.distributed has no uint32 or bool)
_WIRE = {torch.uint32: torch.int32, torch.bool: torch.uint8}


@dataclasses.dataclass
class EnvMesh:
    """One rank's view of the ``"env"`` mesh (``env_mesh :29``).

    ``group`` is None for a world of one without a process group.
    ``counts`` counts each collective this rank made, and ``events``, when a
    list, collects a pair of CUDA events around each collective, for the
    time spent in them.  Every collective takes the tensors where they lie:
    NCCL and gloo both take CUDA tensors (gloo copies them through the host
    itself), gloo CPU ones.
    """

    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None
    backend: Optional[str] = None
    counts: dict = dataclasses.field(default_factory=lambda: {"all_reduce": 0, "all_gather": 0})
    events: Optional[list] = None

    def env_slice(self, n_envs: int):
        """``(lo, hi)``: the global envs of this rank, an equal contiguous share."""
        if n_envs % self.world:
            raise ValueError(f"{n_envs} envs do not split evenly over {self.world} ranks")
        share = n_envs // self.world
        return self.rank * share, (self.rank + 1) * share

    # -- collectives ----------------------------------------------------------

    def _run(self, name: str, fn, t: torch.Tensor) -> torch.Tensor:
        """Run collective ``fn(wire)`` on ``t`` and return the result in
        ``t``'s dtype and device: the one place every collective passes."""
        self.counts[name] += 1
        if self.events is not None and t.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        wire = t.view(_WIRE[t.dtype]) if t.dtype in _WIRE else t
        out = fn(wire)
        out = out.view(t.dtype) if t.dtype in _WIRE else out
        if self.events is not None and t.is_cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.append((start, end))
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``t`` over the ranks, as a new tensor or ``t``."""
        if self.group is None:
            return t

        def fn(x):
            x = x.contiguous()
            dist.all_reduce(x, group=self.group)
            return x

        return self._run("all_reduce", fn, t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated on the leading axis in rank order,
        which is global env order for a rank's env block."""
        if self.group is None:
            return t

        def fn(x):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.world)]
            dist.all_gather(parts, x, group=self.group)
            return torch.cat(parts)

        return self._run("all_gather", fn, t)

    def sum_gradients(self, params, extra: Optional[torch.Tensor] = None):
        """Sum every parameter's ``.grad`` over the ranks with one
        ``all_reduce`` of their concatenation (a missing gradient counts as
        zeros), leaving the sums in ``.grad``; ``extra``, a 1-D tensor, rides
        along, and its sum is returned."""
        params = list(params)
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in params] + ([] if extra is None else [extra]))
        flat = self.all_reduce(flat)
        offset = 0
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        return None if extra is None else flat[offset:]

    def collective_ms(self) -> float:
        """Milliseconds between the CUDA events of :attr:`events` (synchronises)."""
        if not self.events:
            return 0.0
        torch.cuda.synchronize(self.device)
        return float(sum(a.elapsed_time(b) for a, b in self.events))


def env_mesh(device="cuda", group=None) -> EnvMesh:
    """The mesh of the default process group (or ``group``), this rank on
    ``device``; a world of one when no process group is up."""
    device = resolve_device(device)
    if group is None and not dist.is_initialized():
        return EnvMesh(rank=0, world=1, device=device)
    group = group if group is not None else dist.group.WORLD
    return EnvMesh(rank=dist.get_rank(group), world=dist.get_world_size(group), device=device,
                   group=group, backend=str(dist.get_backend(group)))


def initialize_distributed(backend: str, init_method: str, world_size: int, rank: int,
                           timeout: float = 300.0) -> None:
    """Bring up the default process group (``initialize_distributed :267``).

    Idempotent: a no-op when it is already up.  Every other failure (an
    unreachable address, a bad world size, a backend missing from this
    torch) propagates, so that a misconfigured cluster fails at start-up
    instead of running as a single process.  ``timeout`` (seconds) bounds
    every collective, so a lost rank ends the run instead of hanging it.
    """
    if dist.is_initialized():
        return
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))


# ---------------------------------------------------------------------------
# Keys, reset, step and the random-policy rollout
# ---------------------------------------------------------------------------


def batch_keys(base_key, n_envs: int, device="cuda", start: int = 0) -> torch.Tensor:
    """Per-env keys ``uint32[n_envs, 2]``: env ``i`` gets ``fold_in(base, start + i)``.

    ``base_key`` is a ``uint32[2]`` key, e.g. ``threefry.prng_key(seed)``; a
    rank holding global envs ``[lo, hi)`` passes ``start=lo`` and gets rows
    ``[lo, hi)`` of JAX's ``batch_keys(base, n)`` (``mesh.py:47``).
    """
    device = resolve_device(device)
    keys = threefry.fold_in(np.asarray(base_key, dtype=np.uint32),
                            np.arange(start, start + n_envs, dtype=np.uint32))
    return torch.from_numpy(keys).to(device)


def _obs_fn(obs: str):
    return {"dict": engine.observe_dict, "board": engine.observe_board}[obs]


def sharded_reset(base_key, n_envs: int, config: EngineConfig, mesh: EnvMesh, obs: str = "board"):
    """This rank's share ``[lo, hi)`` of ``n_envs`` fresh flagship envs and
    its observation (``sharded_reset :104``): ``(states, obs)``, env ``i``
    from ``fold_in(base_key, i)`` by its global index."""
    lo, hi = mesh.env_slice(n_envs)
    keys = batch_keys(base_key, hi - lo, device=mesh.device, start=lo)
    return engine.reset(keys, config, obs_fn=_obs_fn(obs), device=mesh.device)


def sharded_step(states, actions: torch.Tensor, config: EngineConfig, mesh: EnvMesh,
                 obs: str = "board"):
    """One step of this rank's envs (``sharded_step :114``): ``(states,
    obs, reward, done, info)``; ``actions`` are the rank's ``int32[hi - lo]``."""
    return engine.step(states, actions, config, obs_fn=_obs_fn(obs))


def sharded_compat_reset(base_key, n_envs: int, config: EnvConfig, mesh: EnvMesh):
    """This rank's share of ``n_envs`` fresh compat envs (``core/fn_env.py``),
    env ``i`` from ``fold_in(base_key, i)``: ``(states, obs)``, the input of
    :func:`sharded_random_rollout` with ``engine_kind="fn_env"``."""
    lo, hi = mesh.env_slice(n_envs)
    keys = batch_keys(base_key, hi - lo, device=mesh.device, start=lo)
    _, states, obs = fn_env.reset(keys, config, device=mesh.device)
    return states, obs


def sharded_random_rollout(states, rollout_key, config, mesh: EnvMesh, horizon: int,
                           engine_kind: str = "engine"):
    """``horizon`` random-policy steps of this rank's envs
    (``sharded_random_rollout :151``): ``(states, Σreward, Σdone)``, the
    sums over every env of every rank and step (0-dim float64 and int64
    tensors on the mesh's device, the same on every rank).

    Step ``t`` splits the rollout key and draws ``randint(sub, (n,), 0, A)``
    over the global batch; this rank takes elements ``[lo, hi)`` of it.
    ``engine_kind`` is ``"engine"`` (the flagship engine, 8 actions,
    ``config`` an :class:`EngineConfig`) or ``"fn_env"`` (the compat engine,
    7 actions, an :class:`EnvConfig`).  Rewards are whole numbers, so the
    sums are exact and equal JAX's float32 ones.
    """
    if engine_kind == "engine":
        step, n_actions = engine.step, 8
        kw = {"obs_fn": engine.no_obs}
    elif engine_kind == "fn_env":
        step, n_actions, kw = fn_env.step, 7, {}
    else:
        raise ValueError(f"unknown engine_kind: {engine_kind!r}")
    n_local = states.board.shape[0]
    lo = mesh.rank * n_local
    dev = states.board.device
    key = np.asarray(rollout_key, dtype=np.uint32)
    sum_r = torch.zeros((), dtype=torch.float64, device=dev)
    sum_d = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(horizon):
        key, sub = threefry.split(key)
        acts = threefry.randint_lanes(sub, n_local, n_actions, dev, start=lo).to(torch.int32)
        states, _, reward, done, _ = step(states, acts, config, **kw)
        sum_r += reward.sum(dtype=torch.float64)
        sum_d += done.sum()
    totals = mesh.all_reduce(torch.stack([sum_r, sum_d.to(torch.float64)]))
    return states, totals[0], totals[1].to(torch.int64)


# ---------------------------------------------------------------------------
# A rank's slice of a global state, and back
# ---------------------------------------------------------------------------


def _minor_fields(tree, minor) -> tuple:
    """Fields whose env axis is the last (``batch_minor_shardings :169``)."""
    fields = tuple(f.name for f in dataclasses.fields(tree))
    if minor is not None:
        return fields if minor else ()
    if isinstance(tree, turbo.TurboState):
        return fields
    if isinstance(tree, engine.EngineState):
        return ("key",)  # uint32[2, B] in the port, [B, 2] in JAX
    return ()


def _map_env(fn, tree, minor):
    """``fn(tensor, axis)`` over the env-batched tensors of ``tree``: a
    state dataclass, a dict of them, or one tensor (leading axis, or the
    last with ``minor=True``)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, -1 if minor else 0)
    if isinstance(tree, dict):
        return {k: _map_env(fn, v, minor) for k, v in tree.items()}
    last = _minor_fields(tree, minor)
    return type(tree)(**{f.name: fn(getattr(tree, f.name), -1 if f.name in last else 0)
                         for f in dataclasses.fields(tree)})


def shard_env(tree, mesh: EnvMesh, minor: Optional[bool] = None):
    """This rank's slice ``[lo, hi)`` of a global env-batched state.

    The env axis is each field's leading axis, or its last for the turbo
    engine's batch-minor fields and the flagship engine's key; ``minor``
    True or False overrides that for every field.
    """
    def take(x, axis):
        lo, hi = mesh.env_slice(x.shape[axis])
        return x.narrow(axis, lo, hi - lo).contiguous()

    return _map_env(take, tree, minor)


def gather_env(tree, mesh: EnvMesh, minor: Optional[bool] = None):
    """The global state from every rank's slice (the inverse of :func:`shard_env`)."""
    def gather(x, axis):
        moved = x.movedim(axis, 0)
        return mesh.all_gather(moved).movedim(0, axis).contiguous()

    return _map_env(gather, tree, minor)


# ---------------------------------------------------------------------------
# Checksums
# ---------------------------------------------------------------------------


def _leaves(tree, path=""):
    """``(keystr path, leaf)`` in JAX's ``tree_flatten_with_path`` order:
    dataclass fields as ``.name`` in declaration order, dict entries as
    ``['key']`` in sorted key order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _sum32(x) -> torch.Tensor:
    """Wraparound ``uint32`` sum of a leaf as an int64 in ``[0, 2**32)``:
    float32 by its bits, every other dtype cast to ``uint32`` (``:235-249``)."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor(int(x) & _MASK32, dtype=torch.int64)
    x = x.detach().reshape(-1)
    if x.dtype.is_floating_point:
        bits = {4: torch.int32, 2: torch.int16, 8: torch.int64}[x.element_size()]
        x = x.view(bits)
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for chunk in x.split(1 << 30):  # 2**30 values below 2**32 fit an int64 sum
        total = (total + (chunk.to(torch.int64) & _MASK32).sum()) & _MASK32
    return total


def state_checksum(tree, mesh: EnvMesh, sharded: bool = True) -> dict:
    """Placement-invariant ``uint32`` checksum of every field of a state
    (``state_checksum :251``): ``{keystr path: int}``, e.g. ``{".board": ...}``.

    Each leaf is bit-viewed as ``uint32`` and summed with wraparound; with
    ``sharded`` (an env-batched state) the rank sums are added over the
    mesh in one ``all_reduce``, so every rank returns the global checksum,
    equal on any world size and equal to the JAX package's on the same
    global state.  A replicated tree (parameters, the DQN replay buffer)
    passes ``sharded=False``: each rank checksums its own copy, which lets
    a caller check that the copies agree.
    """
    paths, sums = [], []
    for path, leaf in _leaves(tree):
        paths.append(path)
        sums.append(_sum32(leaf).to(mesh.device))
    totals = torch.stack(sums)
    if sharded:
        totals = mesh.all_reduce(totals)
    return {p: int(v) & _MASK32 for p, v in zip(paths, totals.tolist())}

