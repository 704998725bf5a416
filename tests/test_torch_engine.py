"""The flagship engine of the PyTorch port against the JAX package's, on the CPU.

The plain PyTorch versions (what the port runs on CPU tensors) must play the
identical game as ``jax.vmap`` of ``tetris_gymnasium_tpu.core.engine`` from
the same per-env keys: every state field, reward, done flag and line count,
and every observation (board, Dict, RGB), is bit-equal at every step.  The
behavioural checks of ``tests/test_engine.py:23-194`` (spawn, 7-bag, moves,
rotation, gravity commit, swap and its orientation, the line-clear reward,
auto-reset, freeze) run on the port beside the comparison.  The bit
operations of ``ops/bitboard.py`` and the id-board helpers of
``ops/board.py`` are held against JAX's on random inputs.  The JAX package
is imported only as the oracle; its jitted functions are shared within the
module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.core import engine as jengine
from tetris_gymnasium_tpu.ops import bitboard as jbb
from tetris_gymnasium_tpu.ops import board as jboard
from tetris_gymnasium_tpu.parallel.mesh import batch_keys as jbatch_keys
from tetris_gymnasium_tpu.pieces import PIECES as JPIECES
from tetris_gymnasium_tpu.pieces import piece_matrix as jpiece_matrix

from tetris_gymnasium_torch.config import ActionsMapping, EngineConfig
from tetris_gymnasium_torch.core import engine
from tetris_gymnasium_torch.ops import bitboard as bb
from tetris_gymnasium_torch.ops import board as ob
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES, piece_matrix

CPU = "cpu"
A = ActionsMapping()
# actions biased towards hard drops and swaps (left, right, down, cw, ccw, drop, swap, no-op)
ACTION_P = (0.1, 0.1, 0.08, 0.1, 0.07, 0.3, 0.15, 0.1)


@functools.lru_cache(maxsize=None)
def _jax(**kw):
    """JAX config and the jitted vmapped init, step and observations of one config."""
    jc = JEngineConfig(**kw)
    init = jax.jit(jax.vmap(functools.partial(jengine.init_state, config=jc)))
    step = jax.jit(jax.vmap(functools.partial(jengine.step, config=jc, obs_fn=lambda s, c, p: ())))
    obs = jax.jit(lambda s: (jax.vmap(functools.partial(jengine.observe_board, config=jc))(s),
                             jax.vmap(functools.partial(jengine.observe_dict, config=jc))(s),
                             jax.vmap(functools.partial(jengine.render_rgb, config=jc))(s)))
    return jc, init, step, obs


def _to_jax(ts: engine.EngineState):
    fields = {k: np.array(getattr(ts, k)) for k in engine.FIELDS}
    fields["key"] = fields["key"].T  # the port keeps the key as [2, B]
    return jengine.EngineState(**{k: jnp.asarray(v) for k, v in fields.items()})


def _assert_states_equal(ts: engine.EngineState, js, where):
    for k in engine.FIELDS:
        got, want = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        if k == "key":
            got = got.T
        assert got.dtype == want.dtype, f"{k} dtype @ {where}"
        np.testing.assert_array_equal(got, want, err_msg=f"{k} @ {where}")


def _pair(seed, B, **kw):
    """The same fresh batch on both sides, checked equal."""
    jc, init, *_ = _jax(**kw)
    js = init(jbatch_keys(jax.random.PRNGKey(seed), B))
    ts = engine.init(batch_keys(threefry.prng_key(seed), B, device=CPU), EngineConfig(**kw),
                     device=CPU)
    _assert_states_equal(ts, js, "init")
    return ts, js


def _step_both(ts, js, actions, **kw):
    """One step on both sides; asserts every output equal and returns the port's."""
    _, _, jstep, _ = _jax(**kw)
    a = np.asarray(actions, dtype=np.int32)
    js, _, jr, jd, jinfo = jstep(js, jnp.asarray(a))
    ts, obs, tr, td, tinfo = engine.step(ts, torch.from_numpy(a), EngineConfig(**kw),
                                         obs_fn=engine.no_obs)
    assert obs is None
    _assert_states_equal(ts, js, "step")
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tinfo["lines_cleared"].numpy(), np.asarray(jinfo["lines_cleared"]))
    return ts, js, tr, td, tinfo


def _run(seed, actions, B=1, surgery=None, **kw):
    """Steps a batch through ``actions`` (one per step, all envs alike) on
    both sides; returns the port's ``(state, reward, done, info)`` per step."""
    ts, js = _pair(seed, B, **kw)
    if surgery is not None:
        ts = surgery(ts)
        js = _to_jax(ts)
    out = [(ts, None, None, None)]
    for a in actions:
        ts, js, r, d, info = _step_both(ts, js, np.full((B,), a), **kw)
        out.append((ts, r, d, info))
    return out


# ---------------------------------------------------------------------------
# Helpers and bit operations
# ---------------------------------------------------------------------------


def test_board_helpers_match_jax():
    rng = np.random.default_rng(0)
    for h, w, p in ((20, 10, 4), (8, 6, 4), (15, 9, 2)):
        np.testing.assert_array_equal(ob.create_board(h, w, p, 3, "cpu")[1].numpy(),
                                      np.asarray(jboard.create_board(h, w, p)))
    B = 64
    boards = rng.integers(-1, 9, size=(B, 24, 18)).astype(np.int8)
    boards[rng.random((B, 24, 18)) < 0.6] = 0
    piece = rng.integers(-1, 8, size=B).astype(np.int32)
    rot = rng.integers(-1, 5, size=B).astype(np.int32)
    x = rng.integers(-6, 20, size=B).astype(np.int32)
    y = rng.integers(-6, 26, size=B).astype(np.int32)
    mats = piece_matrix(PIECES, torch.from_numpy(piece), torch.from_numpy(rot))
    jmats = jax.vmap(lambda p, r: jpiece_matrix(JPIECES, p, r))(jnp.asarray(piece), jnp.asarray(rot))
    np.testing.assert_array_equal(mats.numpy(), np.asarray(jmats))
    tb, tx, ty = torch.from_numpy(boards), torch.from_numpy(x), torch.from_numpy(y)
    jcoll = jax.vmap(jboard.collision)(jnp.asarray(boards), jmats, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(ob.collision(tb, mats, tx, ty).numpy(), np.asarray(jcoll))
    ids = rng.integers(-3, 9, size=B).astype(np.int8)
    jproj = jax.vmap(jboard.project)(jnp.asarray(boards), jmats, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(ids))
    np.testing.assert_array_equal(ob.project(tb, mats, tx, ty, torch.from_numpy(ids)).numpy(),
                                  np.asarray(jproj))
    box = torch.from_numpy(PIECES.box)
    np.testing.assert_array_equal(ob.spawn_x_classic(18, box).numpy(),
                                  np.asarray(jboard.spawn_x_classic(18, jnp.asarray(PIECES.box))))


@pytest.mark.parametrize("seed", [0, 1])
def test_bit_operations_match_jax(seed):
    """pack_board .. compact_ids over random boards, pieces, clamped windows
    and stacks with up to 8 full rows."""
    rng = np.random.default_rng(seed)
    B, height, width, pad = 64, 20, 10, 4
    boards = np.asarray(jboard.create_board(height, width, pad))[None].repeat(B, 0).copy()
    inner = rng.integers(2, 9, size=(B, height, width)).astype(np.int8)
    inner[rng.random((B, height, width)) < 0.5] = 0
    n_full = rng.integers(0, 9, size=B)
    for b in range(B):
        inner[b, height - n_full[b]:] = rng.integers(2, 9, size=(n_full[b], width))
    boards[:, :height, pad:-pad] = inner
    piece = rng.integers(0, 7, size=B).astype(np.int32)
    rot = rng.integers(0, 4, size=B).astype(np.int32)
    x = rng.integers(-6, 20, size=B).astype(np.int32)
    y = rng.integers(-6, 26, size=B).astype(np.int32)
    tb, tp, tr = torch.from_numpy(boards), torch.from_numpy(piece), torch.from_numpy(rot)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    rows = bb.pack_board(tb)
    jrows = jax.vmap(jbb.pack_board)(jnp.asarray(boards))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows).astype(np.int64))
    rtab = bb.row_bits_table(PIECES)
    rb = bb.piece_row_bits(rtab, tp, tr)
    jrb = jax.vmap(lambda p, r: jbb.piece_row_bits(jbb.ROW_BITS, p, r))(jnp.asarray(piece),
                                                                         jnp.asarray(rot))
    np.testing.assert_array_equal(rb.numpy(), np.asarray(jrb))
    hm = bb.hit_map(rows, bb.shift_piece(rb, tx, 18))
    jhm = jax.vmap(lambda r, p, x: jbb.hit_map(r, jbb.shift_piece(p, x, 18)))(jrows, jrb,
                                                                             jnp.asarray(x))
    np.testing.assert_array_equal(hm.numpy(), np.asarray(jhm))
    for fn, jfn in ((bb.collision_at, jbb.collision_at), (bb.drop_from_map, jbb.drop_from_map)):
        np.testing.assert_array_equal(fn(hm, ty).numpy(),
                                      np.asarray(jax.vmap(jfn)(jhm, jnp.asarray(y))))
    np.testing.assert_array_equal(
        bb.collision(rows, rb, tx, ty, 18).numpy(),
        np.asarray(jax.vmap(lambda r, p, x, y: jbb.collision(r, p, x, y, 18))(
            jrows, jrb, jnp.asarray(x), jnp.asarray(y))))
    proj = bb.project(rows, rb, tx, ty, 18)
    jproj = jax.vmap(lambda r, p, x, y: jbb.project(r, p, x, y, 18))(jrows, jrb, jnp.asarray(x),
                                                                     jnp.asarray(y))
    np.testing.assert_array_equal(proj.numpy(), np.asarray(jproj).astype(np.int64))
    cleared, n, filled = bb.clear_lines(rows, height, width, pad)
    jc, jn, jf = jax.vmap(lambda r: jbb.clear_lines(r, height, width, pad))(jrows)
    np.testing.assert_array_equal(cleared.numpy(), np.asarray(jc).astype(np.int64))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(filled.numpy(), np.asarray(jf))
    assert int(n.max()) >= 5
    ids = bb.compact_ids(tb[:, :height, pad:-pad], filled)
    jids = jax.vmap(jbb.compact_ids)(jnp.asarray(boards[:, :height, pad:-pad]), jf)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


# ---------------------------------------------------------------------------
# Init and trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("queue_kind", ["bag", "uniform"])
def test_init_matches_jax(queue_kind):
    ts, _ = _pair(7, 16, queue_kind=queue_kind)
    bag = ts.bag.numpy()
    assert all(sorted(row) == list(range(7)) for row in bag.tolist())
    if queue_kind == "bag":  # the active piece and the queue are the bag's first five
        np.testing.assert_array_equal(ts.piece.numpy(), bag[:, 0])
        np.testing.assert_array_equal(ts.queue.numpy(), bag[:, 1:5])
    box = PIECES.box[ts.piece.numpy()]
    np.testing.assert_array_equal(ts.x.numpy(), 18 // 2 - box // 2)
    assert not ts.y.any() and not ts.game_over.any()


TRAJ_CONFIGS = {
    "default": {},
    "autoreset": {"auto_reset": True},
    "nograv-uniform-autoreset": {"gravity_enabled": False, "queue_kind": "uniform",
                                 "auto_reset": True},
}


@pytest.mark.parametrize("kw", list(TRAJ_CONFIGS.values()), ids=list(TRAJ_CONFIGS))
def test_trajectory_matches_jax(kw):
    """150 random steps, 32 envs, biased towards hard drops and swaps."""
    ts, js = _pair(3, 32, **kw)
    rng = np.random.default_rng(0)
    n_done = n_full_holder = 0
    for _ in range(150):
        a = rng.choice(8, size=32, p=ACTION_P)
        ts, js, _, d, _ = _step_both(ts, js, a, **kw)
        n_done += int(d.sum())
        n_full_holder += int((ts.holder_count == 1).sum())
    assert n_done > 0 and n_full_holder > 0


def _surgery(seed, B):
    """Hand-built boards: garbage and 0..6 full bottom rows, random pieces."""

    def apply(ts):
        rng = np.random.default_rng(seed)
        board = ts.board.numpy().copy()
        inner = rng.integers(2, 9, size=(B, 12, 10)).astype(np.int8)
        inner[rng.random((B, 12, 10)) < 0.4] = 0
        n_full = rng.integers(0, 7, size=B)
        for b in range(B):
            inner[b, 12 - n_full[b]:] = rng.integers(2, 9, size=(n_full[b], 10))
        board[:, 8:20, 4:14] = inner
        ints = lambda lo, hi: torch.from_numpy(rng.integers(lo, hi, size=B).astype(np.int32))  # noqa: E731
        return ts.replace(board=torch.from_numpy(board), piece=ints(0, 7), rotation=ints(0, 4),
                          x=ints(-3, 18), y=ints(0, 5))

    return apply


def test_multi_line_clears_match_jax():
    """Drops onto hand-built stacks clear up to ten rows at once; the id
    board compacts as JAX's does."""
    kw = {"auto_reset": True}
    ts, js = _pair(9, 64, **kw)
    ts = _surgery(9, 64)(ts)
    js = _to_jax(ts)
    rng = np.random.default_rng(9)
    lines = []
    for i in range(40):
        a = np.full(64, A.hard_drop) if i == 0 else rng.choice(8, size=64, p=ACTION_P)
        ts, js, _, _, info = _step_both(ts, js, a, **kw)
        lines.append(info["lines_cleared"].numpy())
    assert np.concatenate(lines).max() >= 5


def test_rollout_matches_jax():
    jc, *_ = _jax(auto_reset=True)
    ts, js = _pair(4, 8, auto_reset=True)
    acts = np.random.default_rng(4).choice(8, size=(20, 8), p=ACTION_P).astype(np.int32)
    ts, (obs, r, d, lines) = engine.rollout(ts, torch.from_numpy(acts), EngineConfig(auto_reset=True))
    js, (jobs, jr, jd, jl) = jax.jit(lambda s, a: jengine.rollout(s, a, jc))(js, jnp.asarray(acts))
    _assert_states_equal(ts, js, "rollout")
    for got, want in ((obs, jobs), (r, jr), (d, jd), (lines, jl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The behaviour of tests/test_engine.py, on both sides
# ---------------------------------------------------------------------------


def test_bag_sequence_is_7_bag():
    out = _run(3, [A.hard_drop] * 6, gravity_enabled=False)
    assert sorted(int(s.piece[0]) for s, *_ in out) == list(range(7))


def test_moves_and_rotation():
    acts = [A.move_left, A.move_right, A.move_down, A.rotate_clockwise, A.rotate_counterclockwise]
    out = _run(1, acts, gravity_enabled=False)
    x0, r0 = int(out[0][0].x[0]), int(out[3][0].rotation[0])
    assert [int(s.x[0]) for s, *_ in out[1:3]] == [x0 - 1, x0]
    assert int(out[3][0].y[0]) == 1
    assert int(out[4][0].rotation[0]) == (r0 + 1) % 4 and int(out[5][0].rotation[0]) == r0


def test_gravity_pulls_and_commits():
    out = _run(2, [A.no_op] * 30)
    assert [int(s.y[0]) for s, *_ in out[1:4]] == [1, 2, 3]
    assert all(float(r[0]) == 0.0 for _, r, _, _ in out[1:4])
    # the piece locks once: alife reward, a new piece at the top
    rewards = [float(r[0]) for _, r, _, _ in out[1:]]
    lock = rewards.index(1.0)
    assert int(out[lock + 1][0].y[0]) == 0
    assert int(out[lock + 1][0].board.sum()) > int(out[0][0].board.sum())


def test_swap_semantics():
    out = _run(5, [A.swap, A.swap, A.hard_drop, A.swap], gravity_enabled=False)
    s0, s1, s2, s3, s4 = (o[0] for o in out)
    p0, q0 = int(s0.piece[0]), int(s0.queue[0, 0])
    assert int(s1.holder_count[0]) == 1 and int(s1.holder_piece[0, 0]) == p0
    assert int(s1.piece[0]) == q0 and bool(s1.has_swapped[0])
    assert int(s2.piece[0]) == int(s1.piece[0]) and int(s2.holder_piece[0, 0]) == p0
    assert not bool(s3.has_swapped[0])
    assert int(s4.piece[0]) == p0  # the full holder trades with the stored piece


def test_swap_preserves_orientation():
    out = _run(8, [A.rotate_clockwise, A.swap, A.hard_drop, A.swap], gravity_enabled=False)
    rot, p0 = int(out[1][0].rotation[0]), int(out[1][0].piece[0])
    assert int(out[4][0].piece[0]) == p0 and int(out[4][0].rotation[0]) == rot


def test_line_clear_reward_classic():
    """A horizontal I dropped into a prepared gap clears one row: width + alife."""
    H, W, P = 20, 10, 4

    def gap(ts):
        board = ts.board.clone()
        board[:, H - 1, P : P + W] = 2
        board[:, H - 1, P + 3 : P + 7] = 0
        one = torch.zeros_like(ts.piece)
        return ts.replace(board=board, piece=one, rotation=one, x=one + P + 3)

    out = _run(0, [A.hard_drop], surgery=gap, gravity_enabled=False)
    s, r, _, info = out[1]
    assert int(info["lines_cleared"][0]) == 1 and float(r[0]) == 1 * 1 * W + 1
    assert int(s.board[0, H - 1, P:-P].sum()) == 0


def test_auto_reset():
    out = _run(4, [A.hard_drop] * 30, gravity_enabled=False, auto_reset=True)
    done_at = next(i for i, (_, _, d, _) in enumerate(out[1:], 1) if bool(d[0]))
    s = out[done_at][0]
    assert not bool(s.game_over[0]) and int(s.steps[0]) == 0 and float(s.score[0]) == 0.0
    assert int(s.board[0, :20, 4:-4].sum()) == 0


def test_freeze_without_auto_reset():
    out = _run(4, [A.hard_drop] * 30, gravity_enabled=False)
    done_at = next(i for i, (_, _, d, _) in enumerate(out[1:], 1) if bool(d[0]))
    s, s2 = out[done_at][0], out[done_at + 1][0]
    _, r2, d2, _ = out[done_at + 1]
    assert bool(d2[0]) and float(r2[0]) == 0.0
    assert torch.equal(s2.board, s.board) and int(s2.steps[0]) == int(s.steps[0])


# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------


def test_observations_match_jax():
    """``observe_board``, ``observe_dict`` and ``render_rgb`` at every state
    of a trajectory that holds pieces, ends games and meets hand-built stacks."""
    kw = {"auto_reset": True}
    _, _, _, jobs = _jax(**kw)
    cfg = EngineConfig(**kw)
    ts, js = _pair(6, 16, **kw)
    ts = _surgery(6, 16)(ts)
    js = _to_jax(ts)
    rng = np.random.default_rng(6)
    for i in range(30):
        board, obs, rgb = jobs(js)
        np.testing.assert_array_equal(engine.observe_board(ts, cfg).numpy(), np.asarray(board))
        d = engine.observe_dict(ts, cfg)
        assert set(d) == set(obs)
        for k in obs:
            np.testing.assert_array_equal(d[k].numpy(), np.asarray(obs[k]), err_msg=f"{k} @ {i}")
        np.testing.assert_array_equal(engine.render_rgb(ts, cfg).numpy(), np.asarray(rgb))
        ts, js, *_ = _step_both(ts, js, rng.choice(8, size=16, p=ACTION_P), **kw)
    # the Dict observation's content, as tests/test_engine.py checks it
    s = engine.init(batch_keys(threefry.prng_key(6), 1, device=CPU), EngineConfig(), device=CPU)
    d = engine.observe_dict(s, EngineConfig())
    assert d["holder"].shape == (1, 4, 4) and bool((d["holder"] == 1).all())
    assert d["queue"].shape == (1, 4, 16)
    pid = int(PIECES.ids[int(s.piece[0])])
    assert int((d["board"] == pid).sum()) == 4
    box = int(PIECES.box[int(s.piece[0])])
    assert int(d["active_tetromino_mask"].sum()) == box * box


def test_reset_returns_the_dict_observation():
    keys = batch_keys(threefry.prng_key(2), 4, device=CPU)
    s, obs = engine.reset(keys, EngineConfig(), device=CPU)
    assert set(obs) == {"board", "active_tetromino_mask", "holder", "queue"}
    assert obs["board"].shape == (4, 24, 18) and s.board.shape == (4, 24, 18)


def test_wide_geometry_is_not_ported():
    """A wide board plays on the flagship engine, equal to JAX's, and so do
    its Dict observation and renders (the kernels, built for each geometry,
    refuse only CPU tensors here)."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_tpu.ops.image import preprocess_rgb84 as jpreprocess

    ts, js = _pair(0, 2, width=30)
    assert ts.board.shape == (2, 24, 38)
    _, _, step, obs = _jax(width=30)
    a = np.full(2, A.hard_drop, np.int32)
    cfg = EngineConfig(width=30)
    ts2, _, r, d, _ = engine.step(ts, torch.from_numpy(a), cfg, obs_fn=engine.no_obs)
    js2, _, jr, jd, _ = step(js, jnp.asarray(a))
    _assert_states_equal(ts2, js2, "drop")
    _, jdict, jrgb = obs(js2)
    tdict = engine.observe_dict(ts2, cfg)
    for k in jdict:
        np.testing.assert_array_equal(tdict[k].numpy(), np.asarray(jdict[k]), err_msg=k)
    np.testing.assert_array_equal(engine.render_rgb(ts2, cfg).numpy(), np.asarray(jrgb))
    np.testing.assert_array_equal(engine.render_rgb84(ts2, cfg).numpy(),
                                  np.asarray(jpreprocess(jrgb)))
    for call in (kernels.observe_dict, kernels.render_rgb84):
        with pytest.raises(ValueError, match="CUDA"):
            call(ts2, cfg, PIECES)


# ---------------------------------------------------------------------------
# PPO on the flagship engine (tests/test_rl.py:98-133)
# ---------------------------------------------------------------------------


def test_ppo_flagship_rollout_equals_turbo():
    """The same per-env keys give the same initial observations, and the
    same small PPO rollout, on the flagship and the turbo engine."""
    from tetris_gymnasium_torch.models.networks import ActorCriticCNN
    from tetris_gymnasium_torch.rl import ppo

    config = EngineConfig(auto_reset=True)
    cfg = ppo.PPOConfig(rollout_len=6, update_epochs=1, n_minibatches=2)
    out = {}
    for impl in ("turbo", "flagship"):
        ts = ppo.init_train_state(threefry.prng_key(0), 8, config, cfg,
                                  net=ActorCriticCNN(dtype=torch.float32), impl=impl, device=CPU)
        # the turbo engine samples in its step's call, the flagship engine apart
        out[impl] = (ts.last_obs, ppo.rollout(ts, cfg, ppo.sample_step_fn(config, impl)))
    (obs_t, (traj_t, _, last_t, key_t)), (obs_f, (traj_f, _, last_f, key_f)) = out["turbo"], out["flagship"]
    assert torch.equal(obs_t, obs_f) and torch.equal(last_t, last_f)
    np.testing.assert_array_equal(key_t, key_f)
    for name in traj_t._fields:
        assert torch.equal(getattr(traj_t, name), getattr(traj_f, name)), name
