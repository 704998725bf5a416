"""Grouped placement engine on the flagship engine: the (column, rotation) MDP.

PyTorch port of ``tetris_gymnasium_tpu/core/grouped.py``.  The JAX engine
is written for one env and lifted with ``vmap``; here every function takes
a batch, leading in every field: the legality mask is ``float32[B, A]``
with ``A = width * 4`` candidates, action ``a`` meaning column ``a // 4``
and rotation ``a % 4`` (relative to the piece's current rotation).

On CUDA tensors :func:`placements` and :func:`grouped_observation` are the
``grouped_flagship`` kernel of :mod:`tetris_gymnasium_torch.kernels` (mode
``ids``, ``boards`` or ``features``; ``rgb`` is ``ids`` followed by the
``compose_rgb`` kernel over the ``B * A`` boards with each env's strips,
which the ``observe_dict`` kernel writes alone), and
the step goes through the ``flagship_step`` kernel.  On CPU tensors they run
the plain versions (``*_plain``), which mirror the JAX functions and also
run on CUDA tensors when called by name.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from tetris_gymnasium_torch.config import ActionsMapping, EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import engine
from tetris_gymnasium_torch.core.engine import EngineState
from tetris_gymnasium_torch.ops import board as ob
from tetris_gymnasium_torch.ops.observations import FeatureFlags, compose_rgb_plain, feature_vector_plain
from tetris_gymnasium_torch.pieces import PIECES, PieceSet, piece_matrix
from tetris_gymnasium_torch.utils.device import constant
from tetris_gymnasium_torch.utils.tree import select_tree

ACTIONS = ActionsMapping()
REWARDS = RewardsMapping()
MODES = ("boards", "features", "rgb")


@dataclasses.dataclass
class GroupedState:
    """Engine state and the legality mask of the current piece's placements."""

    env: EngineState
    mask: torch.Tensor  # float32[B, A], 1 = legal


def n_actions(config: EngineConfig) -> int:
    return config.width * 4


def encode_action(x: int, r: int) -> int:
    """(column, rotation) -> action id."""
    return x * 4 + r


def decode_action(action):
    """action id -> (column, rotation), floor division as JAX's."""
    return action // 4, action % 4


def _frame_overlap(board, piece, x, y) -> torch.Tensor:
    """``bool[B]``: a filled piece cell lies on bedrock (id 1) in the
    clamped window at (x, y) (``:57``).  Only the frame makes a placement
    illegal; a stack hit is a legal game-over placement."""
    return ((ob.window(board, piece.shape[-1], x, y) == 1) & (piece > 0)).flatten(1).any(dim=1)


def placements_plain(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES):
    """Plain version of :func:`placements`, on any device."""
    B, A = state.board.shape[0], n_actions(config)
    Hp, Wp = state.board.shape[1:]
    dev = state.board.device
    board = state.board[:, None].expand(B, A, Hp, Wp).reshape(B * A, Hp, Wp)
    piece = state.piece.repeat_interleave(A)
    cand = torch.arange(A, dtype=torch.int32, device=dev).repeat(B)
    x_base, r = decode_action(cand)
    rot = torch.remainder(state.rotation.repeat_interleave(A) + r, 4)
    mat = piece_matrix(pieces, piece, rot)
    x = (x_base + config.padding - engine.piece_box(pieces, piece) // 2).to(torch.int32)
    y = ob.drop_distance(board, mat, x, torch.zeros_like(x))  # dropped from the top

    frame_hit = _frame_overlap(board, mat, x, y)
    stack_hit = ob.collision(board, mat, x, y)
    placed = ob.project(board, mat, x, y, engine.piece_id(pieces, piece))
    cleared, lines = ob.clear_lines(placed, config.height, config.width, config.padding)
    boards = torch.where(frame_hit[:, None, None], torch.ones_like(board),
                         torch.where(stack_hit[:, None, None], torch.zeros_like(board), cleared))
    over = stack_hit & ~frame_hit
    lines = torch.where(frame_hit | stack_hit, 0, lines).to(torch.int32)
    return (boards.reshape(B, A, Hp, Wp), (~frame_hit).to(torch.float32).reshape(B, A),
            over.reshape(B, A), lines.reshape(B, A))


def placements(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES):
    """Every placement of the active piece (``:98``): ``(boards int8[B, A,
    H_pad, W_pad], mask f32[B, A], game_over bool[B, A], lines int32[B, A])``.

    A candidate drops from the top of its column, locks with the piece's id
    and clears its full rows.  Sentinel boards: all ones (the padding too)
    for an illegal placement (the piece on the bedrock frame), all zeros and
    0 lines for a game-over one (the piece on the stack).  On CUDA tensors
    the ``grouped_flagship`` kernel computes them.
    """
    if state.board.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.grouped_flagship(state, config, pieces, "ids")
    return placements_plain(state, config, pieces)


def grouped_observation_plain(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES,
                              mode: str = "boards", feature_flags: FeatureFlags = FeatureFlags()):
    """Plain version of :func:`grouped_observation`, on any device."""
    if mode not in MODES:
        raise ValueError(f"unknown grouped observation mode: {mode}")
    boards, mask, _, _ = placements_plain(state, config, pieces)
    B, A = mask.shape
    if mode == "boards":
        return boards.to(torch.float32), mask
    if mode == "features":
        pad = config.padding
        crop = boards[:, :, :-pad, pad:-pad].reshape(B * A, config.height, config.width)
        return feature_vector_plain(crop, feature_flags).reshape(B, A, -1).to(torch.float32), mask
    queue_strip, holder_strip = engine.queue_holder_strips(state, pieces)
    rgb = compose_rgb_plain(boards.view(torch.uint8).reshape((B * A,) + boards.shape[2:]), queue_strip,
                            holder_strip, pieces, group=A)
    return rgb.reshape((B, A) + rgb.shape[1:]), mask


def grouped_observation(state: EngineState, config: EngineConfig, pieces: PieceSet = PIECES,
                        mode: str = "boards", feature_flags: FeatureFlags = FeatureFlags()):
    """``(observation, mask f32[B, A])`` for the current state (``:113``).

    ``boards``: the candidates' padded id boards as ``float32[B, A, H_pad,
    W_pad]``.  ``features``: the feature vector of each candidate's cropped
    playfield, sentinels included, ``float32[B, A, n]``.  ``rgb``: each
    candidate's composite with the env's live queue and holder strips,
    ``uint8[B, A, H_pad, W_pad + sidebar, 3]``.
    """
    if mode not in MODES:
        raise ValueError(f"unknown grouped observation mode: {mode}")
    if not state.board.is_cuda:
        return grouped_observation_plain(state, config, pieces, mode, feature_flags)
    from tetris_gymnasium_torch import kernels

    if mode != "rgb":
        obs, mask, _, _ = kernels.grouped_flagship(state, config, pieces, mode, feature_flags)
        return obs, mask
    boards, mask, _, _ = kernels.grouped_flagship(state, config, pieces, "ids")
    strips = kernels.observe_dict(state, config, pieces, strips_only=True)
    B, A = mask.shape
    rgb = kernels.compose_rgb(boards.view(torch.uint8).reshape((B * A,) + boards.shape[2:]),
                              strips["queue"], strips["holder"], pieces, group=A)
    return rgb.reshape((B, A) + rgb.shape[1:]), mask


def reset(keys, config: EngineConfig, pieces: PieceSet = PIECES, mode: str = "boards",
          device="cuda") -> Tuple[GroupedState, torch.Tensor]:
    """Fresh grouped batch from per-env keys ``uint32[B, 2]``: ``(state, obs)``."""
    env_state = engine.init(keys, config, pieces, device=device)
    obs, mask = grouped_observation(env_state, config, pieces, mode)
    return GroupedState(env=env_state, mask=mask), obs


def step(gstate: GroupedState, action: torch.Tensor, config: EngineConfig,
         pieces: PieceSet = PIECES, rewards: RewardsMapping = REWARDS, mode: str = "boards",
         terminate_on_illegal: bool = True):
    """One placement per env, ``action`` ``int32[B]`` (``:165``): teleport,
    hard drop, re-derive the mask.  Returns ``(state, obs, reward, done, info)``.

    The piece teleports to the candidate's column and rotation (no
    collision check) and hard-drops through the engine.  An illegal action
    (its mask entry 0; an id outside ``[0, A)`` reads the mask as JAX's
    gather does, wrapped once and clamped) either ends the episode with the
    ``invalid_action`` reward and an observation of ``space.high``
    (``height * width``, 255 in ``rgb`` mode), restarting it on the same
    step under ``auto_reset``, or is a no-op step with that reward
    (``terminate_on_illegal=False``).
    """
    env = gstate.env
    dev = env.board.device
    A = n_actions(config)
    action = torch.as_tensor(action, device=dev).to(torch.int32).reshape(-1)
    idx = torch.where(action < 0, action + A, action).clamp(0, A - 1).long()
    illegal = gstate.mask.gather(1, idx[:, None])[:, 0] == 0

    x_base, r = decode_action(action)
    rot = torch.remainder(env.rotation + r, 4).to(torch.int32)
    box = constant(np.asarray(pieces.box, dtype=np.int32), dev)
    x = (x_base + config.padding - box[env.piece.clamp(0, box.shape[0] - 1).long()] // 2)
    teleported = env.replace(x=x.to(torch.int32), rotation=rot)
    dropped, _, drop_reward, drop_done, drop_info = engine.step(
        teleported, torch.full_like(action, ACTIONS.hard_drop), config, pieces, rewards,
        obs_fn=engine.no_obs)

    if terminate_on_illegal:
        ill_state, ill_done = env, torch.ones_like(illegal)
        ill_lines = torch.zeros_like(env.lines)
    else:
        ill_state, _, _, ill_done, ill_info = engine.step(
            env, torch.full_like(action, ACTIONS.no_op), config, pieces, rewards,
            obs_fn=engine.no_obs)
        ill_lines = ill_info["lines_cleared"]

    new_env = select_tree(illegal, ill_state, dropped)
    done = torch.where(illegal, ill_done, drop_done)
    reward = torch.where(illegal, float(np.float32(rewards.invalid_action)), drop_reward)
    lines = torch.where(illegal, ill_lines, drop_info["lines_cleared"])

    if config.auto_reset and terminate_on_illegal:
        # the counter RNG keeps streaming, as the engine's own auto-reset;
        # computed for every env, as JAX does
        fresh = engine.init(new_env.key.T.contiguous(), config, pieces, device=dev)
        new_env = select_tree(illegal, fresh, new_env)

    obs, mask = grouped_observation(new_env, config, pieces, mode)
    if terminate_on_illegal:
        high = 255 if mode == "rgb" else config.height * config.width
        obs = torch.where(illegal.reshape((-1,) + (1,) * (obs.ndim - 1)),
                          torch.full_like(obs, high), obs)

    info = {"lines_cleared": lines, "action_mask": mask, "score": new_env.score}
    return GroupedState(env=new_env, mask=mask), obs, reward, done, info


# ---------------------------------------------------------------------------
# Cached entry points (``:232-268``): plain callables over a batch-leading state
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jit_step(config: EngineConfig, mode: str = "boards", terminate_on_illegal: bool = True):
    """Cached grouped step for the default piece set."""
    return functools.partial(step, config=config, mode=mode,
                             terminate_on_illegal=terminate_on_illegal)


@functools.lru_cache(maxsize=None)
def jit_observation(config: EngineConfig, mode: str = "boards"):
    """Cached grouped observation for the default piece set."""
    return functools.partial(grouped_observation, config=config, mode=mode)


def batched_step(gstates, actions, *, config, mode="boards", terminate_on_illegal=True):
    """Grouped step over the leading env axis."""
    return jit_step(config, mode, terminate_on_illegal)(gstates, actions)


def batched_reset(keys, *, config, mode="boards", terminate_on_illegal=True, device="cuda"):
    """Grouped reset from per-env keys ``uint32[B, 2]``."""
    return reset(keys, config, mode=mode, device=device)
