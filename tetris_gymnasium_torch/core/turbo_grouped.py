"""Turbo grouped engine: the placement MDP over the turbo engine's bit-packed boards.

PyTorch port of ``tetris_gymnasium_tpu/core/turbo_grouped.py``.  An action
is one of the active piece's ``A = width * 4`` placements (column, rotation);
each step evaluates every candidate of every env: drop from the top,
legality (no bedrock overlap at rest), game-over (stack overlap at rest),
lock and line clear, then the candidate's observation:

* ``mode="features"``: ``float32[B, A, F]`` with ``F = width + 3``
  (column heights, max height, holes, bumpiness); illegal candidates get
  the all-ones board's features, game-over candidates zeros;
* ``mode="boards"``: ``float32[B, A, height, width]`` binary boards, all
  ones for an illegal candidate and all zeros for a game-over one.

The legality mask stays batch-minor, ``float32[A, B]``, as the engine keeps
it.  The feature observation is returned batch-leading, ``[B, A, F]``, the
layout the network reads: where the JAX ``placements`` returns
``[F, A, B]`` and ``observation`` transposes it, the port's
:func:`placements` returns ``[B, A, F]`` directly.

:func:`placements` and :func:`placement_boards` dispatch on the state's
device: on CUDA tensors the ``grouped_placements`` kernel of
:mod:`tetris_gymnasium_torch.kernels` computes them, on CPU tensors the plain
versions below (:func:`placements_plain`, :func:`placement_boards_plain`),
which fold the candidate axis into the batch (``[H, A*B]``, or ``[H, NW,
A*B]`` for rows of several words) so that the turbo engine's bit helpers
apply unchanged.  :func:`step` teleports and hard-drops through
:func:`turbo.step` (the ``turbo_step`` kernel on the card) and restarts
illegal-terminated games through :func:`turbo.init_from_key`
(``turbo_init``).  Every geometry the turbo engine takes plays here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from tetris_gymnasium_torch.config import ActionsMapping, EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.pieces import PIECES, PieceSet

ACTIONS = ActionsMapping()
REWARDS = RewardsMapping()
MODES = ("features", "boards")


@dataclasses.dataclass
class TurboGroupedState:
    """Turbo engine state and the current piece's legality mask ``float32[A, B]``."""

    env: turbo.TurboState
    mask: torch.Tensor  # float32 [A, B], 1 = legal

    def replace(self, **kw) -> "TurboGroupedState":
        return dataclasses.replace(self, **kw)


def n_actions(config: EngineConfig) -> int:
    return config.width * 4


def n_features(config: EngineConfig) -> int:
    return config.width + 3


# ---------------------------------------------------------------------------
# Candidate evaluation (plain versions)
# ---------------------------------------------------------------------------


def _features_from_rows(rows: torch.Tensor, config: EngineConfig) -> torch.Tensor:
    """Features ``float32[F, N]`` from packed rows ``[H, N]`` (``[H, NW, N]``
    when wide) in int64 lanes (``_features_from_rows :65``)."""
    H, pad, W = config.height, config.padding, config.width
    inner = rows[:H]
    h = torch.arange(H, dtype=torch.int32, device=rows.device)[:, None]
    heights, hole_counts = [], []
    for w in range(pad, pad + W):
        col = turbo.col_bits(inner, w, config)
        height_w = H - torch.where(col, h, H).amin(dim=0)
        heights.append(height_w)
        hole_counts.append(height_w - col.sum(dim=0, dtype=torch.int32))  # empty cells under the top
    hs = torch.stack(heights)
    max_h = hs.amax(dim=0)
    holes = torch.stack(hole_counts).sum(dim=0)
    bump = (hs[1:] - hs[:-1]).abs().sum(dim=0)
    return torch.cat([hs, max_h[None], holes[None], bump[None]]).to(torch.float32)


def _candidate_geometry(box: torch.Tensor, config: EngineConfig, piece, rotation):
    """Per-candidate rotation and x, ``[A, B]`` (``_candidate_geometry :93``)."""
    cand = torch.arange(n_actions(config), dtype=torch.int32, device=piece.device)[:, None]
    rot = torch.remainder(rotation[None, :] + cand % 4, 4)
    x = cand // 4 + config.padding - turbo._lookup(box, piece)[None, :] // 2
    return rot, x


def _candidate_rows(state: turbo.TurboState, config: EngineConfig, pieces: PieceSet, max_clear: int):
    """Drop, lock and clear every candidate (``_candidate_rows :103``).

    Returns cleared rows ``[H, A, B]`` (``[H, NW, A, B]`` when wide,
    ``:126-133``) in int64 lanes, ``frame_hit``, ``stack_hit`` (bool) and
    ``lines`` (int32), each ``[A, B]``.
    """
    dev = state.rows.device
    t, packed, box = turbo.tables_for(pieces, dev)
    S, H, pw = t.size, config.padded_height, config.padded_width
    B = state.rows.shape[-1]
    A = n_actions(config)
    rot, x = _candidate_geometry(box, config, state.piece, state.rotation)
    piece_ab = state.piece[None, :].expand(A, B)
    # the candidate axis folds into the batch: [H, A*B], index a * B + b
    rb = turbo._row_bits(t, packed, piece_ab.reshape(-1), rot.reshape(-1))
    sp = turbo._shift(rb, x.reshape(-1), pw)  # [S, A*B], or [S, NW, A*B] when wide
    rows = turbo.u32_to_lanes(state.rows)  # [H, B] or [H, NW, B]
    word_axes = rows.shape[1:-1]
    rows_ab = rows[..., None, :].expand(rows.shape[:-1] + (A, B)).reshape(rows.shape[:-1] + (A * B,))
    empty = turbo._empty_rows(config, dev)  # [H] or [H, NW]
    bed = empty[..., None].expand(empty.shape + (A * B,))

    hm = turbo._hit_map_r(rows_ab, sp, pw)  # stack and frame
    y = turbo._drop_from_map(hm, torch.zeros(A * B, dtype=torch.int32, device=dev), S)
    frame_hit = turbo._collision_at(turbo._hit_map_r(bed, sp, pw), y, S)
    stack_hit = turbo._collision_at(hm, y, S) & ~frame_hit

    stamped = turbo._project(rows_ab, sp, y, S)
    cleared, lines = turbo._clear_lines(stamped, config, max_clear)
    # more than max_clear full rows only come from a hand-built board: the
    # compaction dropped rows, so the placement counts as a game over
    stack_hit = stack_hit | (lines > max_clear)
    lines = torch.where(frame_hit | stack_hit, 0, lines)
    return (cleared.reshape((H,) + word_axes + (A, B)), frame_hit.reshape(A, B),
            stack_hit.reshape(A, B), lines.reshape(A, B).to(torch.int32))


def placements_plain(state: turbo.TurboState, config: EngineConfig, pieces: PieceSet = PIECES,
                     max_clear: int = 4):
    """Plain version of :func:`placements`, on any device."""
    cleared, frame_hit, stack_hit, lines = _candidate_rows(state, config, pieces, max_clear)
    A, B = cleared.shape[-2:]
    feats = _features_from_rows(cleared.flatten(-2), config).reshape(-1, A, B)
    # the all-ones board's features: every height and the max at full height, no holes, flat
    ones_feats = torch.full((feats.shape[0], 1, 1), float(config.height), device=feats.device)
    ones_feats[config.width + 1 :] = 0.0
    feats = torch.where(frame_hit[None], ones_feats, feats)
    feats = torch.where(stack_hit[None], 0.0, feats)
    mask = (~frame_hit).to(torch.float32)
    return feats.permute(2, 1, 0).contiguous(), mask, stack_hit, lines


def placement_boards_plain(state: turbo.TurboState, config: EngineConfig, pieces: PieceSet = PIECES,
                           max_clear: int = 4):
    """Plain version of :func:`placement_boards`, on any device."""
    cleared, frame_hit, stack_hit, lines = _candidate_rows(state, config, pieces, max_clear)
    A, B = cleared.shape[-2:]
    bits = turbo.unpack_playfield(cleared.flatten(-2), config)  # [A*B, height, W]
    boards = bits.reshape((A, B) + bits.shape[1:]).transpose(0, 1).to(torch.float32)
    boards = torch.where(frame_hit.T[:, :, None, None], 1.0, boards)
    boards = torch.where(stack_hit.T[:, :, None, None], 0.0, boards)
    mask = (~frame_hit).to(torch.float32)
    return boards, mask, stack_hit, lines


def _evaluate(state, config, pieces, max_clear, mode):
    if mode not in MODES:
        raise ValueError(f"unknown turbo grouped observation mode: {mode}")
    if state.rows.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.grouped_placements(state, config, pieces, max_clear, mode)
    plain = placements_plain if mode == "features" else placement_boards_plain
    return plain(state, config, pieces, max_clear)


def placements(state: turbo.TurboState, config: EngineConfig, pieces: PieceSet = PIECES,
               max_clear: int = 4):
    """Evaluate every candidate: ``(features f32[B, A, F], mask f32[A, B],
    game_over bool[A, B], lines int32[A, B])``.

    On CUDA tensors the ``grouped_placements`` kernel computes them.
    """
    return _evaluate(state, config, pieces, max_clear, "features")


def placement_boards(state: turbo.TurboState, config: EngineConfig, pieces: PieceSet = PIECES,
                     max_clear: int = 4):
    """Evaluate every candidate as a binary board: ``(boards f32[B, A, height,
    width], mask f32[A, B], game_over bool[A, B], lines int32[A, B])``."""
    return _evaluate(state, config, pieces, max_clear, "boards")


def observation(state: turbo.TurboState, config: EngineConfig, pieces: PieceSet = PIECES,
                mode: str = "features", max_clear: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(observation, mask f32[A, B])``: features ``[B, A, F]`` or boards ``[B, A, H, W]``."""
    obs, mask, _, _ = _evaluate(state, config, pieces, max_clear, mode)
    return obs, mask


# ---------------------------------------------------------------------------
# Reset and step
# ---------------------------------------------------------------------------


def reset(keys, config: EngineConfig, pieces: PieceSet = PIECES, mode: str = "features",
          max_clear: int = 4, device="cuda") -> Tuple[TurboGroupedState, torch.Tensor]:
    """Fresh grouped batch from per-env keys ``uint32[B, 2]``: ``(state, obs)``."""
    env = turbo.init(keys, config, pieces, device=device)
    obs, mask = observation(env, config, pieces, mode, max_clear)
    return TurboGroupedState(env=env, mask=mask), obs


def step(
    gstate: TurboGroupedState,
    action: torch.Tensor,
    config: EngineConfig,
    pieces: PieceSet = PIECES,
    rewards: RewardsMapping = REWARDS,
    mode: str = "features",
    terminate_on_illegal: bool = True,
    max_clear: int = 4,
):
    """One placement per env, ``action`` ``int32[B]`` (``step :246``).

    The piece teleports to the candidate's column and rotation (no
    collision check) and hard-drops through the engine.  An illegal action
    (mask 0, or outside ``[0, A)``) either ends the episode with the
    ``invalid_action`` reward and an all-``height * width`` observation,
    restarting it on the same step under ``auto_reset``, or is a no-op step
    with that reward (``terminate_on_illegal=False``).  Returns
    ``(state, obs, reward, done, info)``.
    """
    env = gstate.env
    dev = env.rows.device
    A = n_actions(config)
    _, _, box = turbo.tables_for(pieces, dev)
    action = action.to(torch.int32)

    in_range = (action >= 0) & (action < A)
    picked = gstate.mask.gather(0, action.clamp(0, A - 1).long()[None])[0]
    illegal = ~in_range | (picked == 0)

    # teleport, then hard drop through the engine
    rot = torch.remainder(env.rotation + action % 4, 4).to(torch.int32)
    x = (action // 4 + config.padding - turbo._lookup(box, env.piece) // 2).to(torch.int32)
    teleported = env.replace(x=x, rotation=rot)
    drop_a = torch.full_like(action, ACTIONS.hard_drop)
    dropped, _, drop_reward, drop_done, drop_info = turbo.step(
        teleported, drop_a, config, pieces, rewards, max_clear=max_clear
    )

    if terminate_on_illegal:
        ill_env, ill_done = env, torch.ones_like(illegal)
        ill_lines = torch.zeros_like(env.lines)
        if config.auto_reset:
            # computed for every env, as JAX does: testing illegal.any() on
            # the host would wait for the card
            ill_env = turbo.select_tree(illegal, turbo.init_from_key(env.key, config, pieces), env)
    else:
        noop_a = torch.full_like(action, ACTIONS.no_op)
        ill_env, _, _, ill_done, ill_info = turbo.step(env, noop_a, config, pieces, rewards,
                                                       max_clear=max_clear)
        ill_lines = ill_info["lines_cleared"]

    new_env = turbo.select_tree(illegal, ill_env, dropped)
    done = torch.where(illegal, ill_done, drop_done)
    reward = torch.where(illegal, float(np.float32(rewards.invalid_action)), drop_reward)
    lines = torch.where(illegal, ill_lines, drop_info["lines_cleared"])

    obs, mask = observation(new_env, config, pieces, mode, max_clear)
    if terminate_on_illegal:
        high = float(config.height * config.width)
        obs = torch.where(illegal.reshape((-1,) + (1,) * (obs.ndim - 1)), high, obs)

    new_gstate = TurboGroupedState(env=new_env, mask=mask)
    info = {"lines_cleared": lines, "action_mask": mask, "score": new_env.score}
    return new_gstate, obs, reward, done, info


# ---------------------------------------------------------------------------
# Cached entry points (``:315-340``): plain callables, one per config
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jit_step(config: EngineConfig, terminate_on_illegal: bool = True, mode: str = "features",
             max_clear: int = 4):
    """Cached batched grouped step for the default piece set:
    ``(state, action int32[B]) -> (state, obs, reward, done, info)``."""
    return functools.partial(step, config=config, mode=mode,
                             terminate_on_illegal=terminate_on_illegal, max_clear=max_clear)


@functools.lru_cache(maxsize=None)
def jit_reset(config: EngineConfig, mode: str = "features", max_clear: int = 4, device="cuda"):
    """Cached batched grouped reset for the default piece set: ``keys uint32[B, 2] -> (state, obs)``."""
    return functools.partial(reset, config=config, mode=mode, max_clear=max_clear, device=device)
