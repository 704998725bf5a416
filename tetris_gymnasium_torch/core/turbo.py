"""Turbo engine: batch-minor, bit-packed Tetris for training-scale batches.

PyTorch port of ``tetris_gymnasium_tpu/core/turbo.py``.  Every state field
keeps the JAX layout, with the env batch as the MINOR axis: rows
``uint32[H, B]`` (one 32-bit occupancy mask per padded row), bag
``int32[n, B]``, queue ``int32[queue_size, B]``, key ``uint32[2, B]``.
Boards wider than one word (``padded_width > 32``) keep a word axis, rows
``uint32[H, NW, B]`` with ``NW = ceil(padded_width / 32)``, and take the
multi-word paths below (:mod:`tetris_gymnasium_torch.ops.bitboard_wide`
semantics), chosen from the static geometry as the JAX module chooses them.

Each entry point dispatches on the device of the tensors it is given:

* on a CUDA tensor, :func:`init`, :func:`step`, :func:`observe_board` and
  :func:`heights` launch the hand-written kernels of
  :mod:`tetris_gymnasium_torch.kernels` (``csrc/turbo_step.cu``, built for
  the config's geometry, ``csrc/observe_board.cu``, ``csrc/heights.cu``),
  or raise;
* on a CPU tensor they run the plain PyTorch versions in this module
  (:func:`init_plain`, :func:`step_plain`, :func:`observe_board_plain`,
  :func:`heights_plain`).

The plain versions mirror the JAX functions line for line and are the
kernels' oracle; they also run on CUDA tensors when called by name, which is
how ``chip_smoke.py`` holds the kernels against them.  PyTorch lacks
``uint32`` arithmetic on the CPU, so they compute on int64 lanes holding
32-bit values (see :mod:`tetris_gymnasium_torch.ops.rng`), masking every
left shift back to 32 bits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tetris_gymnasium_torch.components.tetromino_randomizer import get_draw_fn
from tetris_gymnasium_torch.config import ActionsMapping, EngineConfig, RewardsMapping
from tetris_gymnasium_torch.ops import bitboard as bb
from tetris_gymnasium_torch.ops import bitboard_wide as bw
from tetris_gymnasium_torch.ops import rng as orng
from tetris_gymnasium_torch.ops.board import clamp_start as _clamp_start
from tetris_gymnasium_torch.pieces import PIECES, PieceSet
from tetris_gymnasium_torch.utils import tree
from tetris_gymnasium_torch.utils.device import constant, resolve_device

ACTIONS = ActionsMapping()
REWARDS = RewardsMapping()
MASK32 = orng.MASK32


@dataclasses.dataclass
class TurboState:
    """Batched engine state; every field has the env batch as its minor axis."""

    key: torch.Tensor  # uint32[2, B] counter-RNG state per env
    rows: torch.Tensor  # uint32[H, B] packed occupancy (bit w = column w);
    #   boards wider than one word carry a word axis: uint32[H, NW, B]
    piece: torch.Tensor  # int32[B]
    rotation: torch.Tensor  # int32[B]
    x: torch.Tensor  # int32[B]
    y: torch.Tensor  # int32[B]
    bag: torch.Tensor  # int32[n_pieces, B]
    bag_index: torch.Tensor  # int32[B]
    queue: torch.Tensor  # int32[queue_size, B]
    holder_piece: torch.Tensor  # int32[holder_size, B]
    holder_rotation: torch.Tensor  # int32[holder_size, B]
    holder_count: torch.Tensor  # int32[B]
    has_swapped: torch.Tensor  # bool[B]
    game_over: torch.Tensor  # bool[B]
    score: torch.Tensor  # float32[B]
    lines: torch.Tensor  # int32[B]
    steps: torch.Tensor  # int32[B]

    def replace(self, **kw) -> "TurboState":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(TurboState))


def select_tree(cond: torch.Tensor, a: TurboState, b: TurboState) -> TurboState:
    """Per-env select of every field; ``cond [B]`` broadcasts on the minor axis."""
    return tree.select_tree(cond, a, b, minor=FIELDS)


def n_words(config: EngineConfig) -> int:
    """Words of a packed row: 1 up to a padded width of 32."""
    return bw.n_words(config.padded_width)


_TABLES: dict = {}


def tables_for(pieces: PieceSet, device) -> Tuple[bb.Tables, torch.Tensor, torch.Tensor]:
    """The packed piece table ``[n*4, NW]`` and box sizes, in numpy and as
    int32 tensors on ``device`` (cached; the kernels read the packed table
    as uint32, same bits)."""
    ck = (pieces.matrices.tobytes(), pieces.box.tobytes(), str(device))
    hit = _TABLES.get(ck)
    if hit is None:
        t = bb.turbo_tables(pieces)
        hit = (
            t,
            torch.as_tensor(t.packed.astype(np.int32), device=device),
            torch.as_tensor(t.box.astype(np.int32), device=device),
        )
        _TABLES[ck] = hit
    return hit


def _empty_rows(config: EngineConfig, device) -> torch.Tensor:
    """Packed rows ``[H]`` (``[H, NW]`` when wide) of an empty board as int64
    lanes on ``device`` (cached, so that a step makes no host-to-device copy
    once warm)."""
    kb = bw.row_ops(config.padded_width)
    rows = kb.empty_rows(config.height, config.width, config.padding).astype(np.int64)
    return constant(rows, device)


# ---------------------------------------------------------------------------
# int64-lane conversions at the plain versions' boundary
# ---------------------------------------------------------------------------


def u32_to_lanes(t: torch.Tensor) -> torch.Tensor:
    """``uint32`` tensor -> int64 lanes holding the same 32-bit values."""
    return t.view(torch.int32).to(torch.int64) & MASK32


def lanes_to_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 lanes of 32-bit values -> ``uint32`` (same bits)."""
    return t.to(torch.int32).view(torch.uint32)


def _to_lanes(s: TurboState) -> TurboState:
    return s.replace(key=u32_to_lanes(s.key), rows=u32_to_lanes(s.rows))


def _from_lanes(s: TurboState) -> TurboState:
    return s.replace(key=lanes_to_u32(s.key), rows=lanes_to_u32(s.rows))


# ---------------------------------------------------------------------------
# Bit helpers in [H, B] layout (int64 lanes)
# ---------------------------------------------------------------------------


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` as int64 lanes, 0 where ``idx`` is out of range (the JAX select chain)."""
    n = table.shape[0]
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, table[idx.clamp(0, n - 1).long()].to(torch.int64), 0)


def _unpack_rows(words, size: int) -> torch.Tensor:
    """Packed words -> piece row masks ``[S, B]``: row ``s`` is bits ``[s*S,
    (s+1)*S)`` of the words laid end to end; a row that straddles two words
    joins them with split shifts."""
    mask = (1 << size) - 1
    rows = []
    for s in range(size):
        w0, r = divmod(s * size, 32)
        v = words[w0] >> r
        if r and r + size > 32:
            v = v | (words[w0 + 1] << (32 - r))
        rows.append(v & mask)
    return torch.stack(rows)


def _row_bits(t, packed, piece, rotation) -> torch.Tensor:
    idx = piece * 4 + rotation
    return _unpack_rows([_lookup(packed[:, w], idx) for w in range(t.n_words)], t.size)


def _row_bits_spawn(t, packed, piece) -> torch.Tensor:
    """Row masks at rotation 0 (spawn collision check)."""
    return _row_bits(t, packed, piece, torch.zeros_like(piece))


def _shift(rb: torch.Tensor, x: torch.Tensor, width: int) -> torch.Tensor:
    """x-shifted piece rows: ``[S, *batch]`` single words up to ``width`` 32,
    else ``[S, NW, *batch]``, each row's low word ``rb << (x % 32)`` at word
    ``x // 32`` and its guarded carry ``rb >> (32 - x % 32)`` at the next."""
    xc = _clamp_start(x, width - rb.shape[0], width)
    if not bw.wide(width):
        return rb << xc
    nw = bw.n_words(width)
    word, off = xc // 32, xc % 32
    lo = (rb << off) & MASK32
    hi = torch.where(off == 0, 0, rb >> (32 - off))
    j = torch.arange(nw, device=rb.device).reshape((1, nw) + (1,) * xc.ndim)
    return torch.where(j == word, lo[:, None], 0) | torch.where(j == word + 1, hi[:, None], 0)


def _h_iota(H: int, ndim: int, device) -> torch.Tensor:
    """``arange(H)`` shaped to broadcast over ``ndim - 1`` trailing axes."""
    return torch.arange(H, dtype=torch.int32, device=device).reshape((H,) + (1,) * (ndim - 1))


def _hit_map(rows: torch.Tensor, sp: torch.Tensor) -> torch.Tensor:
    """``bool[H, B]``: ``hm[y] = any_s rows[y+s] & sp[s]`` (rows past H are empty)."""
    acc = rows & sp[0]
    for s in range(1, sp.shape[0]):
        shifted = torch.cat([rows[s:], torch.zeros_like(rows[:s])], dim=0)
        acc = acc | (shifted & sp[s])
    return acc != 0


def _hit_map_r(rows: torch.Tensor, sp: torch.Tensor, width: int) -> torch.Tensor:
    """The hit map with the word axis of multi-word rows OR-reduced away."""
    hm = _hit_map(rows, sp)
    return hm.any(dim=1) if bw.wide(width) else hm


def _spawn_overlap(rows: torch.Tensor, sp: torch.Tensor, width: int) -> torch.Tensor:
    """``bool[B]`` overlap of the spawn-shifted piece rows with rows ``0..S-1``."""
    over = None
    for s in range(sp.shape[0]):
        hit = (rows[s] & sp[s]) != 0
        hit = hit.any(dim=0) if bw.wide(width) else hit
        over = hit if over is None else over | hit
    return over


def _collision_at(hm: torch.Tensor, y: torch.Tensor, size: int) -> torch.Tensor:
    H = hm.shape[0]
    yc = _clamp_start(y, H - size, H)
    return hm.gather(0, yc.long()[None])[0]


def _drop_from_map(hm: torch.Tensor, y: torch.Tensor, size: int) -> torch.Tensor:
    """Hard-drop distance: first hit at or below ``y + 1``; ``first_hit == 0`` gives 0."""
    H = hm.shape[0]
    h = torch.arange(H, dtype=torch.int32, device=hm.device)[:, None]
    z = (y + 1).clamp(0, H - size)
    eligible = hm & (h >= z) & (h <= H - size)
    first_hit = torch.where(eligible, h, 2 * H).amin(dim=0)
    dist = (first_hit - (y + 1)).clamp(0, H)
    return torch.where(first_hit == 0, 0, dist).to(torch.int32)


def _project(rows: torch.Tensor, sp: torch.Tensor, y: torch.Tensor, size: int) -> torch.Tensor:
    """OR the x-shifted piece rows into the board at (clamped) row ``y``."""
    H = rows.shape[0]
    yc = _clamp_start(y, H - size, H)
    h = _h_iota(H, rows.ndim, rows.device)
    out = rows
    for s in range(sp.shape[0]):
        out = out | torch.where(h == yc + s, sp[s], 0)
    return out


def _clear_lines(rows: torch.Tensor, config: EngineConfig, max_clear: int):
    """Clear full playfield rows and compact down; returns ``(rows', n)``.

    A kept row at ``h`` moves down by ``sh[h]``, the number of full rows
    strictly below it.  As in the JAX version, only shifts up to
    ``max_clear`` are applied: a row that would move further is dropped, and
    the caller ends the game when ``n > max_clear``.
    """
    if bw.wide(config.padded_width):
        return _clear_lines_wide(rows, config, max_clear)
    height = config.height
    pm = bb.play_mask(config.width, config.padding)
    side = bb.side_mask(config.width, config.padding)

    inner = rows[:height]
    filled = (inner & pm) == pm  # [height, B]
    n = filled.sum(dim=0, dtype=torch.int32)
    below_incl = filled.flip(0).to(torch.int32).cumsum(0).flip(0)
    sh = below_incl - filled.to(torch.int32)
    keep = ~filled

    acc = torch.full_like(inner, side)
    for k in range(min(max_clear, height) + 1):
        move_k = keep & (sh == k)
        if k:
            move_k = torch.cat([torch.zeros_like(move_k[:k]), move_k[: height - k]], dim=0)
            src = torch.cat([torch.full_like(inner[:k], side), inner[: height - k]], dim=0)
        else:
            src = inner
        acc = torch.where(move_k, src, acc)
    return torch.cat([acc, rows[height:]], dim=0), n


def _clear_lines_wide(rows: torch.Tensor, config: EngineConfig, max_clear: int):
    """:func:`_clear_lines` on multi-word rows ``[H, NW, B]`` (``:326``): the
    masks are per-word constants, a row is full when every word is, and the
    compaction moves whole rows of words."""
    height, nw = config.height, n_words(config)
    B = rows.shape[2]
    pm = constant(bw.play_mask_words(config.width, config.padding).astype(np.int64),
                  rows.device)[None, :, None]
    side = constant(bw.side_mask_words(config.width, config.padding).astype(np.int64),
                    rows.device)[None, :, None]

    inner = rows[:height]
    filled = ((inner & pm) == pm).all(dim=1)  # [height, B]
    n = filled.sum(dim=0, dtype=torch.int32)
    below_incl = filled.flip(0).to(torch.int32).cumsum(0).flip(0)
    sh = below_incl - filled.to(torch.int32)
    keep = ~filled

    acc = side.expand(height, nw, B)
    for k in range(min(max_clear, height) + 1):
        move_k = keep & (sh == k)
        if k:
            move_k = torch.cat([torch.zeros_like(move_k[:k]), move_k[: height - k]], dim=0)
            src = torch.cat([side.expand(k, nw, B), inner[: height - k]], dim=0)
        else:
            src = inner
        acc = torch.where(move_k[:, None], src, acc)
    return torch.cat([acc, rows[height:]], dim=0), n


# ---------------------------------------------------------------------------
# Queue / reset
# ---------------------------------------------------------------------------


def _queue_draw(queue, bag, bag_index, key, config: EngineConfig):
    """FIFO pop plus randomizer backfill."""
    piece = queue[0]
    refill, bag, bag_index, key = get_draw_fn(config.queue_kind)(bag, bag_index, key)
    queue = torch.cat([queue[1:], refill[None]], dim=0)
    return piece, queue, bag, bag_index, key


def _spawn_x(box, config: EngineConfig, piece) -> torch.Tensor:
    return (config.padded_width // 2 - _lookup(box, piece) // 2).to(torch.int32)


def _init_from_lanes(key: torch.Tensor, config: EngineConfig, pieces: PieceSet) -> TurboState:
    """Fresh episodes from per-env keys ``[2, B]`` in int64 lanes."""
    t, _, box = tables_for(pieces, key.device)
    n = t.n_pieces
    B = key.shape[1]
    dev = key.device
    key, bag = orng.shuffle(key, n)
    bag_index = torch.zeros((B,), dtype=torch.int32, device=dev)
    if config.queue_kind == "bag" and config.queue_size + 1 <= n:
        active = bag[0]
        queue = bag[1 : 1 + config.queue_size]
        bag_index = torch.full((B,), config.queue_size + 1, dtype=torch.int32, device=dev)
    else:
        draw = get_draw_fn(config.queue_kind)
        active, bag, bag_index, key = draw(bag, bag_index, key)
        qs = []
        for _ in range(config.queue_size):
            p, bag, bag_index, key = draw(bag, bag_index, key)
            qs.append(p)
        queue = torch.stack(qs)
    empty = _empty_rows(config, dev)
    hs = config.holder_size

    def zeros(shape=(B,), dtype=torch.int32):  # a buffer of its own for every field
        return torch.zeros(shape, dtype=dtype, device=dev)

    return TurboState(
        key=key,
        rows=empty[..., None].expand(empty.shape + (B,)).clone(),
        piece=active.to(torch.int32).clone(),
        rotation=zeros(),
        x=_spawn_x(box, config, active),
        y=zeros(),
        bag=bag.to(torch.int32).clone(),
        bag_index=bag_index,
        queue=queue.to(torch.int32).clone(),
        holder_piece=zeros((hs, B)),
        holder_rotation=zeros((hs, B)),
        holder_count=zeros(),
        has_swapped=zeros(dtype=torch.bool),
        game_over=zeros(dtype=torch.bool),
        score=zeros(dtype=torch.float32),
        lines=zeros(),
        steps=zeros(),
    )


def init_plain(keys: torch.Tensor, config: EngineConfig, pieces: PieceSet = PIECES) -> TurboState:
    """Plain version of :func:`init`: keys ``uint32[B, 2]`` on any device."""
    return _from_lanes(_init_from_lanes(u32_to_lanes(keys).T.contiguous(), config, pieces))


def init_from_key(key2b: torch.Tensor, config: EngineConfig, pieces: PieceSet = PIECES) -> TurboState:
    """Fresh episodes from per-env RNG states ``uint32[2, B]`` (``_init_from_key :440``).

    On a CUDA tensor the ``turbo_init`` kernel makes them, reading the keys
    where they lie; on a CPU tensor the plain version does.
    """
    if key2b.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.turbo_init(key2b, config, pieces, key_rows=True)
    return init_plain(key2b.T, config, pieces)


def init(keys, config: EngineConfig, pieces: PieceSet = PIECES, device="cuda") -> TurboState:
    """Fresh batch from per-env keys ``uint32[B, 2]`` (e.g. ``mesh.batch_keys``).

    On ``device="cuda"`` the batch is made by the ``turbo_init`` kernel.
    """
    device = resolve_device(device)
    keys = torch.as_tensor(keys).to(device)
    if device.type == "cuda":
        from tetris_gymnasium_torch import kernels

        return kernels.turbo_init(keys, config, pieces)
    return init_plain(keys, config, pieces)


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------


def _swap(s: TurboState, box, config: EngineConfig) -> TurboState:
    """Holder swap: with the holder full, key, bag and queue do not change."""
    full = s.holder_count >= config.holder_size
    idx = s.holder_count.clamp(0, config.holder_size - 1)
    slot = torch.arange(config.holder_size, dtype=torch.int32, device=idx.device)[:, None]
    at_idx = slot == idx
    hp_store = torch.where(at_idx, s.piece, s.holder_piece)
    hr_store = torch.where(at_idx, s.rotation, s.holder_rotation)
    q_piece, queue2, bag2, bidx2, key2 = _queue_draw(s.queue, s.bag, s.bag_index, s.key, config)

    hp_swap = torch.cat([s.holder_piece[1:], s.piece[None]], dim=0)
    hr_swap = torch.cat([s.holder_rotation[1:], s.rotation[None]], dim=0)
    new_piece = torch.where(full, s.holder_piece[0], q_piece)
    new_rot = torch.where(full, s.holder_rotation[0], 0)
    sx = _spawn_x(box, config, new_piece)
    return s.replace(
        key=torch.where(full, s.key, key2),
        piece=new_piece,
        rotation=new_rot,
        x=sx,
        y=torch.zeros_like(sx),
        bag=torch.where(full, s.bag, bag2),
        bag_index=torch.where(full, s.bag_index, bidx2),
        queue=torch.where(full, s.queue, queue2),
        holder_piece=torch.where(full, hp_swap, hp_store),
        holder_rotation=torch.where(full, hr_swap, hr_store),
        holder_count=(s.holder_count + 1).clamp(max=config.holder_size),
        has_swapped=torch.ones_like(s.has_swapped),
    )


def _apply_action(s: TurboState, action, t, packed, box, config: EngineConfig) -> TurboState:
    """Phase 1: the action's direct effect (move, down, rotate, swap)."""
    pw = config.padded_width
    S = t.size
    rows = s.rows
    rb = _row_bits(t, packed, s.piece, s.rotation)

    dx = torch.where(action == ACTIONS.move_left, -1, torch.where(action == ACTIONS.move_right, 1, 0))
    x_cand = s.x + dx
    hm_cand = _hit_map_r(rows, _shift(rb, x_cand, pw), pw)
    x = torch.where((dx != 0) & ~_collision_at(hm_cand, s.y, S), x_cand, s.x)
    hm_x = _hit_map_r(rows, _shift(rb, x, pw), pw)
    down = (action == ACTIONS.move_down) & ~_collision_at(hm_x, s.y + 1, S)
    y = s.y + down.to(torch.int32)

    rot_dir = torch.where(
        action == ACTIONS.rotate_clockwise,
        1,
        torch.where(action == ACTIONS.rotate_counterclockwise, -1, 0),
    )
    rot_cand = torch.remainder(s.rotation + rot_dir, 4)
    rb_cand = _row_bits(t, packed, s.piece, rot_cand)
    hm_rot = _hit_map_r(rows, _shift(rb_cand, x, pw), pw)
    rot_ok = ~_collision_at(hm_rot, y, S)
    rotation = torch.where((rot_dir != 0) & rot_ok, rot_cand, s.rotation)

    moved = s.replace(x=x.to(torch.int32), y=y.to(torch.int32), rotation=rotation.to(torch.int32))
    do_swap = (action == ACTIONS.swap) & ~s.has_swapped
    return select_tree(do_swap, _swap(s, box, config), moved)


def _commit(s, rows, hm, t, packed, box, config, rewards, max_clear):
    """Drop, lock, clear and respawn; the pre-step ``hm`` decides ``pre_over``."""
    pw = config.padded_width
    S = t.size
    rb = _row_bits(t, packed, s.piece, s.rotation)
    pre_over = _collision_at(hm, s.y, S)

    y_f = s.y + _drop_from_map(hm, s.y, S)
    stamped = _project(rows, _shift(rb, s.x, pw), y_f, S)
    cleared_rows, lines = _clear_lines(stamped, config, max_clear)

    new_piece, queue, bag, bag_index, key = _queue_draw(s.queue, s.bag, s.bag_index, s.key, config)
    sx = _spawn_x(box, config, new_piece)
    sp_new = _shift(_row_bits_spawn(t, packed, new_piece), sx, pw)
    # more than max_clear full rows only come from a hand-built board: the
    # compaction above dropped rows, so the game ends instead of playing on
    spawn_over = _spawn_overlap(cleared_rows, sp_new, pw) | (lines > max_clear)

    line_reward = (lines * lines * config.width).to(torch.float32)
    reward = torch.where(
        pre_over | spawn_over,
        float(np.float32(rewards.game_over)),
        line_reward + float(np.float32(rewards.alife)),
    )
    placed = s.replace(
        key=key,
        rows=cleared_rows,
        piece=new_piece.to(torch.int32),
        rotation=torch.zeros_like(s.rotation),
        x=sx,
        y=torch.zeros_like(sx),
        bag=bag,
        bag_index=bag_index,
        queue=queue,
        has_swapped=torch.zeros_like(s.has_swapped),
        game_over=spawn_over,
        lines=s.lines + lines,
    )
    new_state = select_tree(pre_over, s.replace(game_over=torch.ones_like(pre_over)), placed)
    out_lines = torch.where(pre_over, 0, lines)
    return new_state, reward, out_lines


def step_plain(
    state: TurboState,
    action: torch.Tensor,
    config: EngineConfig,
    pieces: PieceSet = PIECES,
    rewards: RewardsMapping = REWARDS,
    max_clear: int = 4,
):
    """Plain version of one step: returns ``(state, reward f32[B], done bool[B], lines int32[B])``.

    Works on any device; on the CPU it is what :func:`step` runs.
    """
    t, packed, box = tables_for(pieces, state.rows.device)
    state = _to_lanes(state)
    action = action.to(torch.int32)
    rows = state.rows
    s1 = _apply_action(state, action, t, packed, box, config)

    is_drop = action == ACTIONS.hard_drop
    rb1 = _row_bits(t, packed, s1.piece, s1.rotation)
    hm1 = _hit_map_r(rows, _shift(rb1, s1.x, config.padded_width), config.padded_width)
    grav_free = ~_collision_at(hm1, s1.y + 1, t.size)
    if config.gravity_enabled:
        fall = ~is_drop & grav_free
        commit_now = is_drop | ~grav_free
    else:
        fall = torch.zeros_like(is_drop)
        commit_now = is_drop

    s1 = s1.replace(y=s1.y + fall.to(torch.int32))
    committed, commit_reward, lines = _commit(s1, rows, hm1, t, packed, box, config, rewards, max_clear)

    stepped = select_tree(commit_now, committed, s1)
    reward = torch.where(commit_now, commit_reward, 0.0)
    lines = torch.where(commit_now, lines, 0)
    stepped = stepped.replace(score=stepped.score + reward, steps=stepped.steps + 1)

    stepped = select_tree(state.game_over, state, stepped)
    reward = torch.where(state.game_over, 0.0, reward)
    lines = torch.where(state.game_over, 0, lines).to(torch.int32)

    done = stepped.game_over
    if config.auto_reset:
        fresh = _init_from_lanes(stepped.key, config, pieces)
        stepped = select_tree(done, fresh, stepped)
    return _from_lanes(stepped), reward, done, lines


def step(
    state: TurboState,
    action: torch.Tensor,
    config: EngineConfig,
    pieces: PieceSet = PIECES,
    rewards: RewardsMapping = REWARDS,
    obs_fn: Optional[Callable] = None,
    max_clear: int = 4,
):
    """One batched step; ``action`` is ``int32[B]``.

    Returns ``(state, obs, reward, done, info)`` like the JAX ``turbo.step``,
    with ``obs = obs_fn(state, config, pieces)`` or None.  On CUDA tensors
    the ``turbo_step`` kernel computes it; the input state is left as it was
    and the new state is in new buffers.  With ``obs_fn=observe_board`` the
    same launch writes the board observation (one kernel for both); any
    other ``obs_fn`` is called on the new state.
    """
    if state.rows.is_cuda:
        from tetris_gymnasium_torch import kernels

        obs = None
        if obs_fn is observe_board:
            B = state.piece.shape[0]
            obs = torch.empty((B, config.height, config.width), dtype=torch.int8,
                              device=state.rows.device)
        stepped, reward, done, lines = kernels.turbo_step(
            state, action, config, pieces, rewards, max_clear, obs=obs
        )
        if obs is None and obs_fn is not None:
            obs = obs_fn(stepped, config, pieces)
    else:
        stepped, reward, done, lines = step_plain(state, action, config, pieces, rewards, max_clear)
        obs = obs_fn(stepped, config, pieces) if obs_fn is not None else None
    info = {"lines_cleared": lines, "score": stepped.score, "steps": stepped.steps}
    return stepped, obs, reward, done, info


# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------


def unpack_playfield(rows: torch.Tensor, config: EngineConfig, dtype=torch.int8) -> torch.Tensor:
    """Packed rows ``[H, *batch]`` or ``[H, NW, *batch]`` (``uint32``, or
    int64 lanes) -> playfield bits ``dtype[*reversed(batch), height, W]``
    (``unpack_playfield :702``): the packed words move batch-first, then
    each word's bits unpack along a new axis."""
    H, pad, W = config.height, config.padding, config.width
    if rows.dtype == torch.uint32:
        rows = u32_to_lanes(rows)
    if not bw.wide(config.padded_width):
        words = rows[:H].permute(*range(rows.ndim - 1, 0, -1), 0)  # [*rev(batch), height]
        shifts = torch.arange(pad, pad + W, device=rows.device)
        return ((words[..., None] >> shifts) & 1).to(dtype)
    words = rows[:H].permute(*range(rows.ndim - 1, 1, -1), 0, 1)  # [*rev(batch), height, NW]
    bits = (words[..., None] >> torch.arange(32, device=rows.device)) & 1
    return bits.flatten(-2)[..., pad : pad + W].to(dtype)


def observe_board_plain(state: TurboState, config: EngineConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """Plain version of :func:`observe_board`, on any device."""
    t, packed, _ = tables_for(pieces, state.rows.device)
    rows = u32_to_lanes(state.rows)
    sp = _shift(_row_bits(t, packed, state.piece, state.rotation), state.x, config.padded_width)
    ap = _project(torch.zeros_like(rows), sp, state.y, t.size)
    ap = torch.where(state.game_over, 0, ap)
    # the active piece is stamped by addition: overlap gives 0, not -1
    return unpack_playfield(rows, config) - unpack_playfield(ap, config)


def observe_board(state: TurboState, config: EngineConfig, pieces: PieceSet = PIECES) -> torch.Tensor:
    """Cropped binary board with the active piece as -1, ``int8[B, height, width]``.

    On CUDA tensors the ``observe_board`` kernel computes it.
    """
    if state.rows.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.observe_board(state, config, pieces)
    return observe_board_plain(state, config, pieces)


def col_bits(rows: torch.Tensor, col: int, config: EngineConfig) -> torch.Tensor:
    """``bool[H, *batch]`` occupancy of padded column ``col`` from rows in
    int64 lanes (``_col_bits :730``); multi-word rows index word ``col // 32``."""
    if not bw.wide(config.padded_width):
        return ((rows >> col) & 1) != 0
    return ((rows[:, col // 32] >> (col % 32)) & 1) != 0


def heights_plain(state: TurboState, config: EngineConfig) -> torch.Tensor:
    """Plain version of :func:`heights`, on any device."""
    H = config.height
    rows = u32_to_lanes(state.rows[:H])
    h = torch.arange(H, dtype=torch.int32, device=rows.device)[:, None]
    out = []
    for w in range(config.padding, config.padding + config.width):
        top = torch.where(col_bits(rows, w, config), h, H).amin(dim=0)
        out.append(H - top)
    return torch.stack(out).to(torch.int32)


def heights(state: TurboState, config: EngineConfig) -> torch.Tensor:
    """Per-column stack heights ``int32[W, B]`` straight from the bit rows
    (``:760``): ``height - `` the row of a column's topmost occupied cell, 0
    for an empty column.  On CUDA tensors the ``heights`` kernel computes it."""
    if state.rows.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.heights(state, config)
    return heights_plain(state, config)


# ---------------------------------------------------------------------------
# Flagship interop and rollouts
# ---------------------------------------------------------------------------


def from_flagship(es, config: EngineConfig) -> TurboState:
    """The turbo state of a batched flagship ``EngineState`` (``:783``): the
    id board reduced to occupancy rows, every field batch-minor.  New
    buffers, contiguous, on the flagship state's device."""
    minor = ("bag", "queue", "holder_piece", "holder_rotation")
    fields = {k: getattr(es, k) for k in FIELDS if k != "rows"}
    fields.update({k: fields[k].T for k in minor})
    if not bw.wide(config.padded_width):
        fields["rows"] = lanes_to_u32(bb.pack_board(es.board).T)  # [H, B]
    else:
        fields["rows"] = lanes_to_u32(bw.pack_board(es.board).permute(1, 2, 0))  # [H, NW, B]
    return TurboState(**{k: v.contiguous().clone() for k, v in fields.items()})


def rollout(state: TurboState, actions: torch.Tensor, config: EngineConfig,
            pieces: PieceSet = PIECES, obs_fn: Optional[Callable] = None):
    """Step an action sequence ``[T, B]`` (``:830``): ``(state, (obs, reward,
    done, lines))``, each stacked over ``T`` (``obs`` None without ``obs_fn``)."""
    outs = []
    for a in actions:
        state, o, r, d, info = step(state, a, config, pieces, obs_fn=obs_fn)
        outs.append((o, r, d, info["lines_cleared"]))
    obs = None if obs_fn is None else torch.stack([o[0] for o in outs])
    return state, (obs,) + tuple(torch.stack(xs) for xs in list(zip(*outs))[1:])


# ---------------------------------------------------------------------------
# Cached entry points (``:819-829``): plain callables, one per config
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jit_step(config: EngineConfig, rewards: RewardsMapping = REWARDS):
    """Cached batched step (no obs) for the default piece set:
    ``(state, action int32[B]) -> (state, obs, reward, done, info)``."""
    return functools.partial(step, config=config, rewards=rewards)


@functools.lru_cache(maxsize=None)
def jit_init(config: EngineConfig, device="cuda"):
    """Cached batched init for the default piece set: ``keys uint32[B, 2] -> state``."""
    return functools.partial(init, config=config, device=device)
