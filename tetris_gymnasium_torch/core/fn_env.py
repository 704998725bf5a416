"""Compat functional engine: the reference ``tetris_fn`` API, batched.

PyTorch port of ``tetris_gymnasium_tpu/core/fn_env.py``, bit-equal to it:
the same keys and actions give the same boards, queues, keys, scores,
observations and termination flags, quirks included (7 actions with no
swap, reward = score delta, the queue's key threading, a spawn column that
does not depend on the piece, line clears whose new top rows copy row 0).

The JAX engine is written for one env and lifted with ``vmap``; here every
function takes a batch, leading in every field (``rng_key uint32[B, 2]``,
``board int8[B, H + pad, W + 2 * pad]``, ``queue int32[B, queue_size]``,
the rest ``[B]``).  Each entry point dispatches on the device of its
tensors: on CUDA tensors :func:`reset`, :func:`step` and :func:`observe`
launch the ``fn_reset``, ``fn_step`` and ``fn_observe`` kernels of
:mod:`tetris_gymnasium_torch.kernels` (``csrc/fn_env.cu``, built for each
geometry) or raise; on CPU tensors they run the plain versions here
(``*_plain``), which mirror the JAX functions line for line and also run on
CUDA tensors when called by name.  The plain versions keep keys on int64
lanes of 32-bit words (:mod:`tetris_gymnasium_torch.ops.threefry`).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tetris_gymnasium_torch.config import EnvConfig
from tetris_gymnasium_torch.core.turbo import lanes_to_u32, u32_to_lanes
from tetris_gymnasium_torch.ops import board as ob
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.ops.queue import BAG_QUEUE, UNIFORM_QUEUE, QueueFns
from tetris_gymnasium_torch.pieces import PIECES, PieceSet, piece_matrix
from tetris_gymnasium_torch.utils.device import constant, resolve_device
from tetris_gymnasium_torch.utils.tree import select_tree

# Compat action ids.
LEFT, RIGHT, DOWN, CCW, CW, NOOP, HARD_DROP = range(7)


@dataclasses.dataclass
class FnState:
    """Batched compat state, field for field the JAX ``FnState``."""

    rng_key: torch.Tensor  # uint32[B, 2]
    board: torch.Tensor  # int8[B, H + pad, W + 2 * pad]
    piece: torch.Tensor  # int32[B]
    rotation: torch.Tensor  # int32[B]
    x: torch.Tensor  # int32[B]
    y: torch.Tensor  # int32[B]
    queue: torch.Tensor  # int32[B, queue_size]
    queue_index: torch.Tensor  # int32[B]
    game_over: torch.Tensor  # bool[B]
    score: torch.Tensor  # float32[B]

    def replace(self, **kw) -> "FnState":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(FnState))
_NUMPY_DTYPES = {"rng_key": np.uint32, "board": np.int8, "game_over": np.bool_, "score": np.float32}


def state_from_numpy(arrays: dict, device="cuda") -> FnState:
    """A state from a dict of numpy arrays, one per field (a JAX ``FnState``
    as numpy), single-env or batched; a single env becomes a batch of one."""
    device = resolve_device(device)
    single = np.ndim(arrays["board"]) == 2
    out = {}
    for k in FIELDS:
        a = np.array(arrays[k], dtype=_NUMPY_DTYPES.get(k, np.int32))  # a writable copy
        out[k] = torch.from_numpy(a[None] if single else a).to(device)
    return FnState(**out)


def state_to_numpy(state: FnState) -> dict:
    """The state's fields as numpy arrays, batched."""
    return {k: getattr(state, k).cpu().numpy() for k in FIELDS}


def _lookup_ids(pieces: PieceSet, piece: torch.Tensor) -> torch.Tensor:
    """``ids[piece]`` as JAX indexes: a negative index wraps, then it is clamped."""
    ids = constant(np.asarray(pieces.ids, dtype=np.int32), piece.device)
    n = ids.shape[0]
    return ids[torch.where(piece < 0, piece + n, piece).clamp(0, n - 1).long()]


def observe_plain(state: FnState, config: EnvConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """Plain version of :func:`observe` (``:64``), on any device."""
    binary = (state.board > 0).to(torch.int8)
    mat = piece_matrix(pieces, state.piece, state.rotation)
    projected = ob.project(binary, mat, state.x, state.y, -1)
    out = torch.where(state.game_over[:, None, None], binary, projected)
    pad = config.padding
    return out[:, :-pad, pad:-pad].contiguous()


def observe(state: FnState, config: EnvConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """Cropped board ``int8[B, height, width]``: occupancy 0/1 with the active
    piece added as -1 unless the game is over.  On CUDA tensors the
    ``fn_observe`` kernel computes it."""
    if state.board.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.fn_observe(state, config, pieces)
    return observe_plain(state, config, pieces)


def _lock_piece(state: FnState, y_final, x, rotation, config: EnvConfig, pieces: PieceSet,
                queue_fns: QueueFns, key):
    """Lock the active piece, clear lines, spawn the next (``:80``).  The queue
    draws from ``state.rng_key`` and its returned key is thrown away; the
    next key is ``split(rng_key)[0]``.  ``key`` is ``state.rng_key`` in lanes."""
    mat = piece_matrix(pieces, state.piece, rotation)
    stamped = ob.project(state.board, mat, x, y_final, _lookup_ids(pieces, state.piece))
    new_board, lines = ob.clear_lines_compat(stamped, config.height, config.width, config.padding)
    lock_reward = ob.score_fn(lines)

    new_piece, new_queue, new_qi, _ = queue_fns.next_piece(config, state.queue, state.queue_index, key)
    sx, sy = ob.spawn_xy_fn(config)
    sx = torch.full_like(state.x, sx)
    sy = torch.full_like(state.y, sy)
    spawn_mat = piece_matrix(pieces, new_piece, torch.zeros_like(new_piece))
    game_over = ob.collision(new_board, spawn_mat, sx, sy)
    new_rng = threefry.split_keyed(key)[:, 0]

    new_state = state.replace(
        rng_key=new_rng, board=new_board, piece=new_piece.to(torch.int32),
        rotation=torch.zeros_like(state.rotation), x=sx, y=sy, queue=new_queue,
        queue_index=new_qi, game_over=game_over,
    )
    return new_state, lock_reward, lines


def _update(state: FnState, action, config: EnvConfig, pieces: PieceSet, queue_fns: QueueFns):
    """One action, branch-free (``:124``): the horizontal move (old rotation),
    then down or hard drop (at the new x), then rotation (checked at the new
    x and y), then gravity (new rotation), then lock and respawn.  ``state``
    holds its key in lanes."""
    board = state.board
    x, y, rotation = state.x, state.y, state.rotation
    mat = piece_matrix(pieces, state.piece, rotation)

    dx = torch.where(action == LEFT, -1, torch.where(action == RIGHT, 1, 0))
    x_cand = x + dx
    x_ok = ~ob.collision(board, mat, x_cand, y)
    x = torch.where((dx != 0) & x_ok, x_cand, x)

    down_free = ~ob.collision(board, mat, x, y + 1)
    y_down = torch.where(down_free, y + 1, y)
    dist = ob.drop_distance(board, mat, x, y)
    y_new = torch.where(action == DOWN, y_down, torch.where(action == HARD_DROP, y + dist, y))
    move_reward = torch.where(action == DOWN, y_down - y,
                              torch.where(action == HARD_DROP, 2 * dist, 0)).to(torch.int32)

    rot_dir = torch.where(action == CCW, -1, torch.where(action == CW, 1, 0))
    rot_cand = torch.remainder(rotation + rot_dir, 4)
    mat_cand = piece_matrix(pieces, state.piece, rot_cand)
    rot_ok = ~ob.collision(board, mat_cand, x, y_new)
    rotation = torch.where((rot_dir != 0) & rot_ok, rot_cand, rotation)
    mat = piece_matrix(pieces, state.piece, rotation)

    if config.gravity_enabled:
        y_grav = ob.gravity_step(board, mat, x, y_new)
        should_lock = y_grav == y_new
    else:
        y_grav = y_new
        should_lock = torch.zeros_like(state.game_over)

    x, y_grav, rotation = x.to(torch.int32), y_grav.to(torch.int32), rotation.to(torch.int32)
    moved = state.replace(x=x, y=y_grav, rotation=rotation, game_over=torch.zeros_like(state.game_over))

    lock = should_lock | (action == HARD_DROP)
    locked_state, lock_reward, lock_lines = _lock_piece(
        state, y_grav, x, rotation, config, pieces, queue_fns, state.rng_key)
    new_state = select_tree(lock, locked_state, moved)
    lock_reward = torch.where(lock, lock_reward, 0)
    lines = torch.where(lock, lock_lines, 0)

    # float32, added left to right: (score + move_reward) + lock_reward
    score = new_state.score + move_reward.to(torch.float32) + lock_reward.to(torch.float32)
    return new_state.replace(score=score), lines


def _queue_fns_kind(queue_fns: QueueFns) -> str:
    """``"bag"`` or ``"uniform"``, the two queues the kernels draw; else raises."""
    for kind, fns in (("bag", BAG_QUEUE), ("uniform", UNIFORM_QUEUE)):
        if queue_fns == fns:
            return kind
    raise NotImplementedError("the fn_env kernels draw BAG_QUEUE and UNIFORM_QUEUE only "
                              "(pass CPU tensors for the plain versions)")


def step_plain(state: FnState, action: torch.Tensor, config: EnvConfig, pieces: PieceSet = PIECES,
               queue_fns: QueueFns = BAG_QUEUE):
    """Plain version of :func:`step` (``:189``): ``(state, obs, reward f32[B],
    terminated bool[B], lines int32[B])``, on any device."""
    s = state.replace(rng_key=u32_to_lanes(state.rng_key))
    action = action.to(torch.int32)
    updated, lines = _update(s, action, config, pieces, queue_fns)
    new_state = select_tree(s.game_over, s, updated)
    lines = torch.where(s.game_over, 0, lines).to(torch.int32)
    new_state = new_state.replace(rng_key=lanes_to_u32(new_state.rng_key))

    obs = observe_plain(new_state, config, pieces)
    reward = new_state.score - state.score
    return new_state, obs, reward, new_state.game_over, lines


def step(state: FnState, action: torch.Tensor, config: EnvConfig, pieces: PieceSet = PIECES,
         queue_fns: QueueFns = BAG_QUEUE):
    """One batched step; ``action`` is ``int32[B]`` (an id outside 0-6 is a
    no-op followed by gravity).  Returns ``(state, obs, reward, terminated,
    info)`` as the JAX ``step`` does; a finished game stays frozen.  On CUDA
    tensors the ``fn_step`` kernel computes it into new buffers."""
    if state.board.is_cuda:
        from tetris_gymnasium_torch import kernels

        new, obs, reward, term, lines = kernels.fn_step(state, action, config, pieces,
                                                        _queue_fns_kind(queue_fns))
    else:
        new, obs, reward, term, lines = step_plain(state, action, config, pieces, queue_fns)
    return new, obs, reward, term, {"lines_cleared": lines}


def reset_plain(keys: torch.Tensor, config: EnvConfig, pieces: PieceSet = PIECES,
                queue_fns: QueueFns = BAG_QUEUE):
    """Plain version of :func:`reset` (``:210``) from keys ``uint32[B, 2]``, on any device."""
    B = keys.shape[0]
    dev = keys.device
    board = ob.create_board(config.height, config.width, config.padding, B, device=dev)

    halves = threefry.split_keyed(u32_to_lanes(keys))
    key, subkey = halves[:, 0], halves[:, 1]
    queue, queue_index = queue_fns.create(config, key)
    piece, queue, queue_index, key = queue_fns.next_piece(config, queue, queue_index, key)

    sx, sy = ob.spawn_xy_fn(config)

    def full(v, dtype=torch.int32):
        return torch.full((B,), v, dtype=dtype, device=dev)

    state = FnState(
        rng_key=lanes_to_u32(subkey).contiguous(), board=board, piece=piece.to(torch.int32),
        rotation=full(0), x=full(sx), y=full(sy), queue=queue.contiguous(),
        queue_index=queue_index.to(torch.int32), game_over=full(False, torch.bool),
        score=full(0.0, torch.float32),
    )
    return lanes_to_u32(key).contiguous(), state, observe_plain(state, config, pieces)


def reset(keys, config: EnvConfig, pieces: PieceSet = PIECES, queue_fns: QueueFns = BAG_QUEUE,
          device="cuda"):
    """Fresh episodes from per-env keys ``uint32[B, 2]``: ``(keys, state, obs)``.

    The key discipline is the reference's: each key splits once, the first
    half draws the queue and comes back, the second becomes the state's
    stream.  On ``device="cuda"`` the ``fn_reset`` kernel makes the batch.
    """
    device = resolve_device(device)
    keys = torch.as_tensor(keys).to(device)
    if device.type == "cuda":
        from tetris_gymnasium_torch import kernels

        return kernels.fn_reset(keys, config, pieces, _queue_fns_kind(queue_fns))
    return reset_plain(keys, config, pieces, queue_fns)


def rollout(state: FnState, actions: torch.Tensor, config: EnvConfig, pieces: PieceSet = PIECES,
            queue_fns: QueueFns = BAG_QUEUE):
    """Step an action sequence ``[T, B]`` (``:273``): ``(state, (obs, reward,
    terminated, lines))``, each stacked over ``T``."""
    outs = []
    for a in actions:
        state, o, r, t, info = step(state, a, config, pieces, queue_fns)
        outs.append((o, r, t, info["lines_cleared"]))
    return state, tuple(torch.stack(xs) for xs in zip(*outs))


# ---------------------------------------------------------------------------
# Cached entry points (``:246-312``): plain callables, one per config
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jit_step(config: EnvConfig):
    """Cached step for the default piece set: ``(state, action int32[B]) -> (state, obs, reward, terminated, info)``."""
    return functools.partial(step, config=config)


@functools.lru_cache(maxsize=None)
def jit_reset(config: EnvConfig, device="cuda"):
    """Cached reset for the default piece set: ``keys uint32[B, 2] -> (keys, state, obs)``."""
    return functools.partial(reset, config=config, device=device)


def batched_step(states: FnState, actions: torch.Tensor, *, config: EnvConfig):
    """Step over the leading env axis (``:301``)."""
    return jit_step(config)(states, actions)


def batched_reset(keys, *, config: EnvConfig, device="cuda"):
    """Reset from per-env keys ``uint32[B, 2]`` (``:308``)."""
    return jit_reset(config, device)(keys)
