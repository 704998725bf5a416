"""Flagship engine: id boards, holder, preview queue, batched.

PyTorch port of ``tetris_gymnasium_tpu/core/engine.py``.  The JAX engine is
written for one env and lifted with ``vmap``; here every function takes a
batch, leading in every field but the counter key, which is laid out as the
turbo engine's is (``uint32[2, B]``):

* ``board int8[B, H + pad, W + 2 * pad]`` holds cell ids (0 empty, 1
  bedrock, 2.. the pieces), ``bag int32[B, 7]``, ``queue int32[B,
  queue_size]``, ``holder_piece`` and ``holder_rotation int32[B,
  holder_size]``, the other fields ``[B]``.

Each entry point dispatches on the device of the tensors it is given: on
CUDA tensors :func:`init`, :func:`step`, :func:`observe_board`,
:func:`observe_dict`, :func:`render_rgb` and :func:`render_rgb84` launch the
hand-written kernels of :mod:`tetris_gymnasium_torch.kernels`
(``flagship_init``, ``flagship_step``, ``flagship_observe_board``,
``observe_dict``, ``observe_dict`` then ``compose_rgb``, ``render_rgb84``)
or raise; on CPU tensors they run the plain versions in this module
(``*_plain``), which mirror the JAX functions line for line and also run on
CUDA tensors when called by name.  The JAX module's cached ``jit_*`` and
``batched_*`` entry points are plain cached callables here (PyTorch runs
eagerly).  The RNG and the piece draws are the turbo engine's
(:mod:`tetris_gymnasium_torch.ops.rng`,
:mod:`tetris_gymnasium_torch.components.tetromino_randomizer`), which work
batch-minor: the plain versions transpose the bag into them and out again.

Any geometry plays: :func:`_kb` picks the bit operations of
:mod:`~tetris_gymnasium_torch.ops.bitboard` for padded rows that fit one
32-bit word and those of :mod:`~tetris_gymnasium_torch.ops.bitboard_wide`
for wider ones, as the JAX engine does.  The step, init, board
observation, Dict observation and render kernels are built for each
geometry at first use.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tetris_gymnasium_torch.components.tetromino_randomizer import get_draw_fn
from tetris_gymnasium_torch.config import ActionsMapping, EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core.turbo import lanes_to_u32, u32_to_lanes
from tetris_gymnasium_torch.ops import bitboard_wide as bbw
from tetris_gymnasium_torch.ops import board as ob
from tetris_gymnasium_torch.ops import rng as orng
from tetris_gymnasium_torch.ops.image import preprocess_rgb84
from tetris_gymnasium_torch.ops.observations import compose_rgb, compose_rgb_plain
from tetris_gymnasium_torch.pieces import PIECES, PieceSet, piece_matrix
from tetris_gymnasium_torch.utils.device import constant, resolve_device
from tetris_gymnasium_torch.utils.tree import select_tree

ACTIONS = ActionsMapping()
REWARDS = RewardsMapping()


@dataclasses.dataclass
class EngineState:
    """Batched flagship state; the batch leads in every field but ``key``."""

    key: torch.Tensor  # uint32[2, B] counter-RNG state per env
    board: torch.Tensor  # int8[B, H + pad, W + 2 * pad] cell ids
    piece: torch.Tensor  # int32[B]
    rotation: torch.Tensor  # int32[B]
    x: torch.Tensor  # int32[B]
    y: torch.Tensor  # int32[B]
    bag: torch.Tensor  # int32[B, n_pieces]
    bag_index: torch.Tensor  # int32[B]
    queue: torch.Tensor  # int32[B, queue_size]
    holder_piece: torch.Tensor  # int32[B, holder_size]
    holder_rotation: torch.Tensor  # int32[B, holder_size]
    holder_count: torch.Tensor  # int32[B]
    has_swapped: torch.Tensor  # bool[B]
    game_over: torch.Tensor  # bool[B]
    score: torch.Tensor  # float32[B]
    lines: torch.Tensor  # int32[B]
    steps: torch.Tensor  # int32[B]

    def replace(self, **kw) -> "EngineState":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(EngineState))


def _kb(config: EngineConfig):
    """The bit-operation module of this geometry (``:46``): single-word rows
    ``[B, H]`` up to a padded width of 32, else multi-word rows ``[B, H, NW]``
    with the same API."""
    return bbw.row_ops(config.padded_width)


def _lookup(table, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (int32), 0 where ``idx`` is out of range (the one-hot's)."""
    t = constant(np.asarray(table, dtype=np.int32), idx.device)
    n = t.shape[0]
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, t[idx.clamp(0, n - 1).long()], 0)


def piece_box(pieces: PieceSet, piece: torch.Tensor) -> torch.Tensor:
    """Bounding-box side ``int32[B]`` of ``piece``."""
    return _lookup(pieces.box, piece)


def piece_id(pieces: PieceSet, piece: torch.Tensor) -> torch.Tensor:
    """Cell id ``int8[B]`` of ``piece``."""
    return _lookup(pieces.ids, piece).to(torch.int8)


def _spawn_x(config: EngineConfig, pieces: PieceSet, piece: torch.Tensor) -> torch.Tensor:
    return ob.spawn_x_classic(config.padded_width, piece_box(pieces, piece))


# ---------------------------------------------------------------------------
# Bag / preview queue / reset
# ---------------------------------------------------------------------------


def _queue_draw(queue, bag, bag_index, key, config: EngineConfig):
    """Pop the queue head and backfill from the randomizer (``:113``); the
    draw runs batch-minor on the transposed bag, ``key`` is int64 lanes."""
    piece = queue[:, 0]
    refill, bag_t, bag_index, key = get_draw_fn(config.queue_kind)(bag.T, bag_index, key)
    queue = torch.cat([queue[:, 1:], refill[:, None].to(queue.dtype)], dim=1)
    return piece, queue, bag_t.T.contiguous(), bag_index, key


def _init_from_lanes(key: torch.Tensor, config: EngineConfig, pieces: PieceSet) -> EngineState:
    """Fresh episodes (``init_state :131``) from keys ``[2, B]`` in int64 lanes."""
    n = int(pieces.ids.shape[0])
    B = key.shape[1]
    dev = key.device
    key, bag = orng.shuffle(key, n)  # bag [n, B]
    if config.queue_kind == "bag" and config.queue_size + 1 <= n:
        active = bag[0]
        queue = bag[1 : 1 + config.queue_size].T
        bag_index = torch.full((B,), config.queue_size + 1, dtype=torch.int32, device=dev)
    else:
        draw = get_draw_fn(config.queue_kind)
        bag_index = torch.zeros((B,), dtype=torch.int32, device=dev)
        active, bag, bag_index, key = draw(bag, bag_index, key)
        qs = []
        for _ in range(config.queue_size):
            p, bag, bag_index, key = draw(bag, bag_index, key)
            qs.append(p)
        queue = torch.stack(qs, dim=1) if qs else torch.zeros((B, 0), dtype=torch.int32, device=dev)
    hs = config.holder_size

    def zeros(shape=(B,), dtype=torch.int32):  # a buffer of its own for every field
        return torch.zeros(shape, dtype=dtype, device=dev)

    return EngineState(
        key=key,
        board=ob.create_board(config.height, config.width, config.padding, B, device=dev),
        piece=active.to(torch.int32).clone(),
        rotation=zeros(),
        x=_spawn_x(config, pieces, active),
        y=zeros(),
        bag=bag.T.to(torch.int32).contiguous(),
        bag_index=bag_index.to(torch.int32),
        queue=queue.to(torch.int32).contiguous(),
        holder_piece=zeros((B, hs)),
        holder_rotation=zeros((B, hs)),
        holder_count=zeros(),
        has_swapped=zeros(dtype=torch.bool),
        game_over=zeros(dtype=torch.bool),
        score=zeros(dtype=torch.float32),
        lines=zeros(),
        steps=zeros(),
    )


def init_plain(keys: torch.Tensor, config: EngineConfig, pieces: PieceSet = PIECES) -> EngineState:
    """Plain version of :func:`init`: fresh episodes from keys ``uint32[B, 2]`` on any device."""
    s = _init_from_lanes(u32_to_lanes(keys).T.contiguous(), config, pieces)
    return s.replace(key=lanes_to_u32(s.key))


def init(keys, config: EngineConfig, pieces: PieceSet = PIECES, device="cuda") -> EngineState:
    """Fresh batch from per-env keys ``uint32[B, 2]`` (``jax.vmap(init_state)``).

    On ``device="cuda"`` the batch is made by the ``flagship_init`` kernel.
    """
    device = resolve_device(device)
    keys = torch.as_tensor(keys).to(device)
    if device.type == "cuda":
        from tetris_gymnasium_torch import kernels

        return kernels.flagship_init(keys, config, pieces)
    return init_plain(keys, config, pieces)


def init_state(key, config: EngineConfig, pieces: PieceSet = PIECES, device="cuda") -> EngineState:
    """A fresh episode from one env's key ``uint32[2]`` (``init_state :131``),
    as a batch of one (the port's states are batched)."""
    if isinstance(key, torch.Tensor):
        return init(key.reshape(1, 2), config, pieces, device=device)
    return init(np.asarray(key, dtype=np.uint32).reshape(1, 2), config, pieces, device=device)


def reset(keys, config: EngineConfig, pieces: PieceSet = PIECES,
          obs_fn: Optional[Callable] = None, device="cuda"):
    """Fresh batch and its observation (``:512``): ``(state, obs)``, by default the Dict obs."""
    state = init(keys, config, pieces, device=device)
    return state, (obs_fn or observe_dict)(state, config, pieces)


# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------


def active_mask(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """``uint8[B, H_pad, W_pad]``: the active piece's bounding box (``:188``)."""
    box = piece_box(pieces, state.piece)[:, None]
    rows = torch.arange(config.padded_height, device=box.device)[None, :]
    cols = torch.arange(config.padded_width, device=box.device)[None, :]
    y, x = state.y[:, None], state.x[:, None]
    rmask = (rows >= y) & (rows < y + box)
    cmask = (cols >= x) & (cols < x + box)
    return (rmask[:, :, None] & cmask[:, None, :]).to(torch.uint8)


def _strip(piece_ids, rotations, valid, pieces: PieceSet) -> torch.Tensor:
    """Thumbnails of ``n`` slots side by side, ``uint8[B, S, S * n]``;
    invalid slots are bedrock (``:202``)."""
    B, n = piece_ids.shape
    size = pieces.matrices.shape[-1]
    mats = piece_matrix(pieces, piece_ids.reshape(-1), rotations.reshape(-1)).reshape(B, n, size, size)
    ids = _lookup(pieces.ids, piece_ids)[:, :, None, None]
    tiles = (mats.to(torch.int32) * ids).to(torch.uint8)
    tiles = torch.where(valid[:, :, None, None], tiles, torch.ones_like(tiles))
    return tiles.permute(0, 2, 1, 3).reshape(B, size, n * size)


def project_active(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """The board with the active piece added in, unless it collides (``:227``)."""
    mat = piece_matrix(pieces, state.piece, state.rotation)
    hit = ob.collision(state.board, mat, state.x, state.y)
    stamped = ob.project(state.board, mat, state.x, state.y, piece_id(pieces, state.piece))
    return torch.where(hit[:, None, None], state.board, stamped)


def queue_holder_strips(state: EngineState, pieces: PieceSet = PIECES):
    """``(queue_strip, holder_strip)`` id images (``:239``); the queue at
    rotation 0, empty holder slots as bedrock."""
    queue_strip = _strip(state.queue, torch.zeros_like(state.queue),
                         torch.ones_like(state.queue, dtype=torch.bool), pieces)
    hslot = torch.arange(state.holder_piece.shape[1], device=state.holder_piece.device)[None, :]
    holder_strip = _strip(state.holder_piece, state.holder_rotation,
                          hslot < state.holder_count[:, None], pieces)
    return queue_strip, holder_strip


def observe_dict_plain(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES) -> dict:
    """Plain version of :func:`observe_dict`, on any device."""
    queue_strip, holder_strip = queue_holder_strips(state, pieces)
    return {
        "board": project_active(state, config, pieces).to(torch.uint8),
        "active_tetromino_mask": active_mask(state, config, pieces),
        "holder": holder_strip,
        "queue": queue_strip,
    }


def observe_dict(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES) -> dict:
    """The Dict observation (``:257``): ``board``, ``active_tetromino_mask``,
    ``holder``, ``queue``, each ``uint8`` with the batch leading.  On CUDA
    tensors the ``observe_dict`` kernel computes all four."""
    if state.board.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.observe_dict(state, config, pieces)
    return observe_dict_plain(state, config, pieces)


def observe_board_plain(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """Plain version of :func:`observe_board`, on any device."""
    binary = (state.board > 0).to(torch.int8)
    mat = piece_matrix(pieces, state.piece, state.rotation)
    stamped = ob.project(binary, mat, state.x, state.y, -1)
    out = torch.where(state.game_over[:, None, None], binary, stamped)
    pad = config.padding
    return out[:, :-pad, pad:-pad].contiguous()


def observe_board(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """Cropped occupancy ``int8[B, height, width]`` with the active piece
    ADDED as -1 unless the game is over (``:274``); a piece cell over an
    occupied cell reads 0.  On CUDA tensors the ``flagship_observe_board``
    kernel computes it."""
    if state.board.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.flagship_observe_board(state, config, pieces)
    return observe_board_plain(state, config, pieces)


def render_rgb_plain(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """Plain version of :func:`render_rgb`, on any device."""
    obs = observe_dict_plain(state, config, pieces)
    return compose_rgb_plain(obs["board"], obs["queue"], obs["holder"], pieces)


def render_rgb(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """RGB composite ``uint8[B, H_pad, W_pad + sidebar, 3]`` (``:529``).  On
    CUDA tensors it is the ``observe_dict`` kernel, then ``compose_rgb``."""
    obs = observe_dict(state, config, pieces)
    return compose_rgb(obs["board"], obs["queue"], obs["holder"], pieces)


def render_rgb84_plain(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """Plain version of :func:`render_rgb84`, on any device."""
    return preprocess_rgb84(render_rgb_plain(state, config, pieces))


def render_rgb84(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """The reference CNN workload's frame ``uint8[B, 84, 84]``:
    ``preprocess_rgb84(render_rgb(state))``.  On CUDA tensors the whole
    chain is the ``render_rgb84`` kernel."""
    if state.board.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.render_rgb84(state, config, pieces)
    return render_rgb84_plain(state, config, pieces)


# ---------------------------------------------------------------------------
# Step (plain version; int64 key lanes inside)
# ---------------------------------------------------------------------------


def _commit(s: EngineState, rows, hm, config: EngineConfig, pieces: PieceSet, rtab,
            rewards: RewardsMapping):
    """Drop, lock, clear and respawn (``:289``); ``hm`` is the piece's hit
    map at its column over the pre-step rows.  A piece that already overlaps
    (``pre_over``) changes nothing but ``game_over``."""
    kb = _kb(config)
    pw, size, pad = config.padded_width, rtab.shape[-1], config.padding
    mat = piece_matrix(pieces, s.piece, s.rotation)
    rb = kb.piece_row_bits(rtab, s.piece, s.rotation)
    pre_over = kb.collision_at(hm, s.y, size)

    y_f = s.y + kb.drop_from_map(hm, s.y, size)
    stamped = ob.project(s.board, mat, s.x, y_f, piece_id(pieces, s.piece))
    stamped_rows = kb.project(rows, rb, s.x, y_f, pw)
    cleared_rows, lines, filled = kb.clear_lines(stamped_rows, config.height, config.width, pad)
    # the clear rewrites the pad columns and bottom rows as fresh bedrock
    inner = kb.compact_ids(stamped[:, : config.height, pad:-pad], filled)
    cleared = F.pad(inner, (pad, pad, 0, pad), value=1)

    new_piece, queue, bag, bag_index, key = _queue_draw(s.queue, s.bag, s.bag_index, s.key, config)
    sx = _spawn_x(config, pieces, new_piece)
    rb_new = kb.piece_row_bits(rtab, new_piece, torch.zeros_like(new_piece))
    spawn_over = kb.collision(cleared_rows, rb_new, sx, torch.zeros_like(sx), pw)

    line_reward = (lines * lines * config.width).to(torch.float32)
    reward = torch.where(pre_over | spawn_over, float(np.float32(rewards.game_over)),
                         line_reward + float(np.float32(rewards.alife)))
    placed = s.replace(
        key=key, board=cleared, piece=new_piece.to(torch.int32),
        rotation=torch.zeros_like(s.rotation), x=sx, y=torch.zeros_like(sx), bag=bag,
        bag_index=bag_index.to(torch.int32), queue=queue,
        has_swapped=torch.zeros_like(s.has_swapped), game_over=spawn_over, lines=s.lines + lines,
    )
    new_state = select_tree(pre_over, s.replace(game_over=torch.ones_like(pre_over)), placed)
    return new_state, reward, torch.where(pre_over, 0, lines)


def _swap(s: EngineState, config: EngineConfig, pieces: PieceSet) -> EngineState:
    """Holder swap (``:365``): store and draw from the queue while the holder
    has room, else trade with the oldest slot, which keeps its rotation."""
    hs = config.holder_size
    full = s.holder_count >= hs
    idx = s.holder_count.clamp(0, hs - 1)
    at_idx = torch.arange(hs, device=idx.device)[None, :] == idx[:, None]
    hp_store = torch.where(at_idx, s.piece[:, None], s.holder_piece)
    hr_store = torch.where(at_idx, s.rotation[:, None], s.holder_rotation)
    q_piece, queue2, bag2, bidx2, key2 = _queue_draw(s.queue, s.bag, s.bag_index, s.key, config)

    hp_swap = torch.cat([s.holder_piece[:, 1:], s.piece[:, None]], dim=1)
    hr_swap = torch.cat([s.holder_rotation[:, 1:], s.rotation[:, None]], dim=1)
    new_piece = torch.where(full, s.holder_piece[:, 0], q_piece)
    new_rot = torch.where(full, s.holder_rotation[:, 0], 0)
    sx = _spawn_x(config, pieces, new_piece)
    f1 = full[:, None]
    return s.replace(
        key=torch.where(full, s.key, key2),
        piece=new_piece.to(torch.int32),
        rotation=new_rot.to(torch.int32),
        x=sx,
        y=torch.zeros_like(sx),
        bag=torch.where(f1, s.bag, bag2),
        bag_index=torch.where(full, s.bag_index, bidx2).to(torch.int32),
        queue=torch.where(f1, s.queue, queue2),
        holder_piece=torch.where(f1, hp_swap, hp_store),
        holder_rotation=torch.where(f1, hr_swap, hr_store),
        holder_count=(s.holder_count + 1).clamp(max=hs).to(torch.int32),
        has_swapped=torch.ones_like(s.has_swapped),
    )


def _apply_action(s: EngineState, rows, action, config: EngineConfig, pieces: PieceSet, rtab):
    """Phase 1 of a step (``:412``): the action's effect, probed on the pre-step rows."""
    kb = _kb(config)
    pw, size = config.padded_width, rtab.shape[-1]
    rb = kb.piece_row_bits(rtab, s.piece, s.rotation)

    dx = torch.where(action == ACTIONS.move_left, -1, torch.where(action == ACTIONS.move_right, 1, 0))
    x_cand = s.x + dx
    hm_cand = kb.hit_map(rows, kb.shift_piece(rb, x_cand, pw))
    x = torch.where((dx != 0) & ~kb.collision_at(hm_cand, s.y, size), x_cand, s.x)
    hm_x = kb.hit_map(rows, kb.shift_piece(rb, x, pw))
    down = (action == ACTIONS.move_down) & ~kb.collision_at(hm_x, s.y + 1, size)
    y = s.y + down.to(torch.int32)

    rot_dir = torch.where(action == ACTIONS.rotate_clockwise, 1,
                          torch.where(action == ACTIONS.rotate_counterclockwise, -1, 0))
    rot_cand = torch.remainder(s.rotation + rot_dir, 4)
    rot_ok = ~kb.collision(rows, kb.piece_row_bits(rtab, s.piece, rot_cand), x, y, pw)
    rotation = torch.where((rot_dir != 0) & rot_ok, rot_cand, s.rotation)

    moved = s.replace(x=x.to(torch.int32), y=y.to(torch.int32), rotation=rotation.to(torch.int32))
    do_swap = (action == ACTIONS.swap) & ~s.has_swapped
    return select_tree(do_swap, _swap(s, config, pieces), moved)


def step_plain(state: EngineState, action: torch.Tensor, config: EngineConfig,
               pieces: PieceSet = PIECES, rewards: RewardsMapping = REWARDS):
    """Plain version of one step (``:451``): ``(state, reward f32[B], done
    bool[B], lines int32[B])``, on any device."""
    kb = _kb(config)
    rtab = kb.row_bits_table(pieces)
    size = rtab.shape[-1]
    s = state.replace(key=u32_to_lanes(state.key))
    action = action.to(torch.int32)
    rows = kb.pack_board(s.board)
    s1 = _apply_action(s, rows, action, config, pieces, rtab)

    is_drop = action == ACTIONS.hard_drop
    rb1 = kb.piece_row_bits(rtab, s1.piece, s1.rotation)
    hm1 = kb.hit_map(rows, kb.shift_piece(rb1, s1.x, config.padded_width))
    grav_free = ~kb.collision_at(hm1, s1.y + 1, size)
    if config.gravity_enabled:
        fall = ~is_drop & grav_free
        commit_now = is_drop | ~grav_free
    else:
        fall = torch.zeros_like(is_drop)
        commit_now = is_drop

    s1 = s1.replace(y=s1.y + fall.to(torch.int32))
    committed, commit_reward, lines = _commit(s1, rows, hm1, config, pieces, rtab, rewards)

    stepped = select_tree(commit_now, committed, s1)
    reward = torch.where(commit_now, commit_reward, 0.0)
    lines = torch.where(commit_now, lines, 0)
    stepped = stepped.replace(score=stepped.score + reward, steps=stepped.steps + 1)

    # finished games freeze (no auto-reset): the input state, reward 0
    stepped = select_tree(s.game_over, s, stepped)
    reward = torch.where(s.game_over, 0.0, reward)
    lines = torch.where(s.game_over, 0, lines).to(torch.int32)

    done = stepped.game_over
    if config.auto_reset:
        # the counter RNG keeps streaming: the fresh episode's draws advance it
        stepped = select_tree(done, _init_from_lanes(stepped.key, config, pieces), stepped)
    return stepped.replace(key=lanes_to_u32(stepped.key)), reward, done, lines


def step(state: EngineState, action: torch.Tensor, config: EngineConfig, pieces: PieceSet = PIECES,
         rewards: RewardsMapping = REWARDS, obs_fn: Optional[Callable] = None):
    """One batched step; ``action`` is ``int32[B]``.

    Returns ``(state, obs, reward, done, info)`` like the JAX ``step``, with
    ``obs = obs_fn(state, config, pieces)``, by default the Dict obs
    (:func:`observe_dict`); pass ``obs_fn=no_obs`` to build none.  On CUDA
    tensors the ``flagship_step`` kernel computes it into new buffers, in
    the build that ``kernels.flagship_step_lanes`` picks for the batch and
    the board.
    """
    if state.board.is_cuda:
        from tetris_gymnasium_torch import kernels

        stepped, reward, done, lines = kernels.flagship_step(state, action, config, pieces, rewards)
    else:
        stepped, reward, done, lines = step_plain(state, action, config, pieces, rewards)
    obs = (obs_fn or observe_dict)(stepped, config, pieces)
    info = {"lines_cleared": lines, "score": stepped.score, "steps": stepped.steps}
    return stepped, obs, reward, done, info


def no_obs(state, config, pieces):
    """An ``obs_fn`` that builds no observation (the RL loops' and the grouped engine's)."""
    return None


def rollout(state: EngineState, actions: torch.Tensor, config: EngineConfig,
            pieces: PieceSet = PIECES, obs_fn: Optional[Callable] = None):
    """Step an action sequence ``[T, B]`` (``:587``): ``(state, (obs, reward,
    done, lines))``, each stacked over ``T``; ``obs_fn`` defaults to
    :func:`observe_board`."""
    obs_fn = obs_fn or observe_board
    outs = []
    for a in actions:
        state, o, r, d, info = step(state, a, config, pieces, obs_fn=obs_fn)
        outs.append((o, r, d, info["lines_cleared"]))
    return state, tuple(torch.stack(xs) for xs in zip(*outs))


# ---------------------------------------------------------------------------
# Cached entry points (``:539-584``): plain callables, one per config
# ---------------------------------------------------------------------------

_OBS_FNS = {"dict": observe_dict, "board": observe_board}


@functools.lru_cache(maxsize=None)
def jit_render_rgb(config: EngineConfig):
    """Cached RGB renderer for the default piece set."""
    return functools.partial(render_rgb, config=config)


@functools.lru_cache(maxsize=None)
def jit_observe(config: EngineConfig, obs: str = "dict"):
    """Cached observation function for the default piece set."""
    return functools.partial(_OBS_FNS[obs], config=config)


@functools.lru_cache(maxsize=None)
def jit_step(config: EngineConfig, obs: str = "dict", rewards: RewardsMapping = REWARDS):
    """Cached step for the default piece set: ``(state, action int32[B]) -> (state, obs, reward, done, info)``."""
    return functools.partial(step, config=config, obs_fn=_OBS_FNS[obs], rewards=rewards)


@functools.lru_cache(maxsize=None)
def jit_reset(config: EngineConfig, obs: str = "dict", device="cuda"):
    """Cached reset for the default piece set: ``keys uint32[B, 2] -> (state, obs)``."""
    return functools.partial(reset, config=config, obs_fn=_OBS_FNS[obs], device=device)


def batched_step(states, actions, *, config: EngineConfig, obs: str = "dict"):
    """Step over the leading env axis (``:577``)."""
    return jit_step(config, obs)(states, actions)


def batched_reset(keys, *, config: EngineConfig, obs: str = "dict", device="cuda"):
    """Reset from per-env keys ``uint32[B, 2]`` (``:582``)."""
    return jit_reset(config, obs, device)(keys)
