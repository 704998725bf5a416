"""The port's compat functional engine against the JAX one, on the CPU.

The plain PyTorch versions (what the port runs on CPU tensors) must play the
identical game as ``tetris_gymnasium_tpu.core.fn_env`` from the same keys
and actions: every state field, observation, reward, termination flag and
line count bit-equal, at five configurations (the default board, no
gravity, a uniform queue of 5, width 30, and 8x12 with padding 2, where the
window clamps bind).  Beside them: ``EnvConfig``, the queues across
refills, the compat board functions at clamping starts, hand-built stacks
whose line clears copy row 0, frozen games, the numpy round trip of a
state, the ported ``play_random_functional`` game, and the behavioural
tests of ``tests/test_fn_env.py``.  The JAX package is imported only as the
oracle.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu import config as jconfig
from tetris_gymnasium_tpu.core import fn_env as jfn
from tetris_gymnasium_tpu.ops import board as jboard
from tetris_gymnasium_tpu.ops import queue as jqueue
from tetris_gymnasium_tpu.pieces import PIECES as JPIECES
from tetris_gymnasium_tpu.pieces import piece_matrix as jpiece_matrix

from tetris_gymnasium_torch import config as tconfig
from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.core import fn_env
from tetris_gymnasium_torch.core.turbo import lanes_to_u32, u32_to_lanes
from tetris_gymnasium_torch.examples import play_random_functional as prf
from tetris_gymnasium_torch.ops import board as ob
from tetris_gymnasium_torch.ops import queue as tqueue
from tetris_gymnasium_torch.pieces import PIECES, piece_matrix

CPU = "cpu"
CONFIGS = {
    "default": (dict(), "bag"),
    "nograv": (dict(gravity_enabled=False), "bag"),
    "uniform5": (dict(queue_size=5), "uniform"),
    "30x20": (dict(width=30), "bag"),
    "8x12-pad2": (dict(width=8, height=12, padding=2), "bag"),
}
NO_LAUNCHES = {name: 0 for name in kernels.LAUNCHES}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _engines(name):
    """``(jax config, port config, jax queue, port queue, jitted JAX batched
    reset, step and rollout)`` of a configuration of ``CONFIGS``."""
    kw, kind = CONFIGS[name]
    jc, tc = jconfig.EnvConfig(**kw), tconfig.EnvConfig(**kw)
    jq = jqueue.BAG_QUEUE if kind == "bag" else jqueue.UNIFORM_QUEUE
    tq = tqueue.BAG_QUEUE if kind == "bag" else tqueue.UNIFORM_QUEUE
    reset = jax.jit(jax.vmap(lambda k: jfn.reset(k, jc, queue_fns=jq)))
    step = jax.jit(jax.vmap(lambda s, a: jfn.step(s, a, jc, queue_fns=jq)))
    rollout = jax.jit(lambda s, a: jfn.rollout(s, a, jc, queue_fns=jq))
    return jc, tc, jq, tq, reset, step, rollout


def _numpy(js):
    """A JAX ``FnState``'s fields as a dict of numpy arrays."""
    return {k: np.asarray(getattr(js, k)) for k in fn_env.FIELDS}


def _keys(seed, n):
    return np.array(jax.random.split(jax.random.PRNGKey(seed), n))


def _assert_state(ts, js, where):
    for k in fn_env.FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), err_msg=f"{k} @ {where}")


def _assert_step(t_out, j_out, where):
    ts, tobs, trew, tterm, tinfo = t_out
    js, jobs, jrew, jterm, jinfo = j_out
    _assert_state(ts, js, where)
    for got, want, what in ((tobs, jobs, "obs"), (trew, jrew, "reward"), (tterm, jterm, "terminated"),
                            (tinfo["lines_cleared"], jinfo["lines_cleared"], "lines")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{what} @ {where}")


# ---------------------------------------------------------------------------
# Config, queues, board functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(width=8, height=12, padding=2), dict(width=30, queue_size=5,
                                                                                  gravity_enabled=False)])
def test_env_config_matches_jax(kw):
    jc, tc = jconfig.EnvConfig(**kw), tconfig.EnvConfig(**kw)
    assert tconfig.EnvConfig._fields == jconfig.EnvConfig._fields
    assert tc._asdict() == jc._asdict()
    assert (tc.padded_width, tc.padded_height) == (jc.padded_width, jc.padded_height)
    assert tconfig.FN_ACTION_ID_TO_NAME == jconfig.FN_ACTION_ID_TO_NAME


@pytest.mark.parametrize("kind,qs", [("bag", 7), ("bag", 1), ("uniform", 5), ("uniform", 2)])
def test_queues_match_jax_across_refills(kind, qs):
    """Create, then draw ``3 * qs + 2`` pieces, refilling three times: piece,
    queue, index and key bit-equal at every draw."""
    jc, tc = jconfig.EnvConfig(queue_size=qs), tconfig.EnvConfig(queue_size=qs)
    jfns = jqueue.BAG_QUEUE if kind == "bag" else jqueue.UNIFORM_QUEUE
    tfns = tqueue.BAG_QUEUE if kind == "bag" else tqueue.UNIFORM_QUEUE
    keys = _keys(11, 32)
    jq, ji = jax.vmap(lambda k: jfns.create(jc, k))(keys)
    tkey = u32_to_lanes(torch.from_numpy(keys))
    tq, ti = tfns.create(tc, tkey)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jnext = jax.jit(jax.vmap(lambda q, i, k: jfns.next_piece(jc, q, i, k)))
    jkey = keys
    for draw in range(3 * qs + 2):
        jp, jq, ji, jkey = jnext(jq, ji, jkey)
        tp, tq, ti, tkey = tfns.next_piece(tc, tq, ti, tkey)
        for got, want, what in ((tp, jp, "piece"), (tq, jq, "queue"), (ti, ji, "index"),
                                (lanes_to_u32(tkey), jkey, "key")):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{what} @ draw {draw}")
    if kind == "uniform":  # the reference's off-by-one: the last piece never comes
        assert int(tq.max()) <= max(qs - 2, 0)


def _random_boards(rng, n, cfg, fill=0.35):
    H, W, pad = cfg.height, cfg.width, cfg.padding
    boards = np.asarray(jboard.create_board(H, W, pad))[None].repeat(n, 0).copy()
    inner = np.where(rng.random((n, H, W)) < fill, rng.integers(2, 9, (n, H, W)), 0).astype(np.int8)
    inner[:, : H // 3] = 0
    boards[:, :H, pad : pad + W] = inner
    return boards


def test_board_functions_match_jax_at_clamping_starts():
    """``collision``, ``project``, ``drop_distance``, ``hard_drop`` and
    ``gravity_step`` at starts that clamp (negative x, ``y + 1 > H + pad - 4``,
    negative y) on the 8x12 board with padding 2; ``score_fn``,
    ``score_classic`` and ``spawn_xy_fn``."""
    cfg = tconfig.EnvConfig(width=8, height=12, padding=2)
    rng = np.random.default_rng(5)
    n = 256
    boards = _random_boards(rng, n, cfg)
    piece = rng.integers(0, 7, n).astype(np.int32)
    rot = rng.integers(0, 4, n).astype(np.int32)
    x = rng.choice([-4, -3, -1, 0, 3, cfg.padded_width - 4, cfg.padded_width - 2, cfg.padded_width + 1], n)
    y = rng.choice([-3, -1, 0, 5, cfg.padded_height - 5, cfg.padded_height - 3, cfg.padded_height - 1,
                    cfg.padded_height + 2], n)
    x, y = x.astype(np.int32), y.astype(np.int32)
    jm = jax.vmap(lambda p, r: jpiece_matrix(JPIECES, p, r))(piece, rot)
    tb, tp, tx, ty = (torch.from_numpy(a) for a in (boards, piece, x, y))
    tm = piece_matrix(PIECES, tp, torch.from_numpy(rot))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    cases = {
        "collision": (ob.collision(tb, tm, tx, ty), jax.vmap(jboard.collision)(boards, jm, x, y)),
        "project": (ob.project(tb, tm, tx, ty, torch.from_numpy(PIECES.ids[piece])),
                    jax.vmap(jboard.project)(boards, jm, x, y, JPIECES.ids[piece])),
        "drop_distance": (ob.drop_distance(tb, tm, tx, ty), jax.vmap(jboard.drop_distance)(boards, jm, x, y)),
        "gravity_step": (ob.gravity_step(tb, tm, tx, ty), jax.vmap(jboard.gravity_step)(boards, jm, x, y)),
    }
    t_hd, j_hd = ob.hard_drop(tb, tm, tx, ty), jax.vmap(jboard.hard_drop)(boards, jm, x, y)
    cases.update(hard_drop_y=(t_hd[0], j_hd[0]), hard_drop_reward=(t_hd[1], j_hd[1]))
    for name, (got, want) in cases.items():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    # the clamps bind: a start past the board's end, or a wrapped negative one
    assert ((y + 1 > cfg.padded_height - 4) & ~np.asarray(cases["collision"][1])).any()
    rows = np.arange(-2, 9, dtype=np.int32)
    for got, want in ((ob.score_fn(torch.from_numpy(rows)), jboard.score_fn(rows)),
                      (ob.score_classic(torch.from_numpy(rows), 10), jboard.score_classic(rows, 10))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for kw in (dict(), dict(width=8, height=12, padding=2), dict(width=30)):
        assert ob.spawn_xy_fn(tconfig.EnvConfig(**kw)) == jboard.spawn_xy_fn(jconfig.EnvConfig(**kw))


@pytest.mark.parametrize("name", ["default", "8x12-pad2"])
def test_clear_lines_compat_matches_jax(name):
    """1-4 full rows and a non-empty row 0: the new top rows are copies of the
    pre-clear row 0, not zeros."""
    jc, tc = _engines(name)[:2]
    rng = np.random.default_rng(7)
    n = 64
    boards = _random_boards(rng, n, tc, fill=0.5)
    H, W, pad = tc.height, tc.width, tc.padding
    n_full = rng.integers(1, 5, n)
    for b in range(n):
        boards[b, H - n_full[b] : H, pad : pad + W] = 4
        boards[b, 0, pad : pad + W] = np.where(np.arange(W) % 3 == 0, 0, 5)
    got, lines = ob.clear_lines_compat(torch.from_numpy(boards), H, W, pad)
    want, jlines = jax.vmap(lambda bd: jboard.clear_lines_compat(bd, H, W, pad))(boards)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lines.numpy(), np.asarray(jlines))
    assert (lines.numpy() >= n_full).all()
    # the quirk: every one of the n top rows copies row 0
    assert all((got[b, : lines[b], pad : pad + W] == torch.from_numpy(boards[b, 0, pad : pad + W])).all()
               for b in range(n))


# ---------------------------------------------------------------------------
# The engine: reset, trajectories, hand-built stacks, frozen games
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reset_matches_jax(name):
    jc, tc, jq, tq, reset, _, _ = _engines(name)
    keys = _keys(3, 64)
    jk, js, jo = reset(keys)
    tk, ts, to = fn_env.reset(keys, tc, queue_fns=tq, device=CPU)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    _assert_state(ts, js, "reset")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rollout_matches_jax(name):
    """200 random steps (actions 0-7; 7 is a no-op then gravity) at B = 64."""
    jc, tc, jq, tq, reset, _, rollout = _engines(name)
    keys = _keys(17, 64)
    _, js, _ = reset(keys)
    _, ts, _ = fn_env.reset(keys, tc, queue_fns=tq, device=CPU)
    actions = np.random.default_rng(1).integers(0, 8, (200, 64)).astype(np.int32)
    jfinal, jout = rollout(js, jnp.asarray(actions))
    tfinal, tout = fn_env.rollout(ts, torch.from_numpy(actions), tc, queue_fns=tq)
    _assert_state(tfinal, jfinal, "final")
    for got, want, what in zip(tout, jout, ("obs", "reward", "terminated", "lines")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)
    assert np.asarray(jout[2]).any(), "some game should end"


def _stacks(name, n, seed):
    """Numpy states on hand-built stacks, each repeated for the actions 0-7:
    1-4 full rows, a non-empty row 0 that is not full, a random piece at a
    random position (clamps included), half the queues at their refill
    boundary, a fifth of the games over."""
    jc, tc, jq, tq, reset, _, _ = _engines(name)
    rng = np.random.default_rng(seed)
    _, js, _ = reset(_keys(seed, n))
    st = {k: v.copy() for k, v in _numpy(js).items()}
    H, W, pad, qs = tc.height, tc.width, tc.padding, tc.queue_size
    inner = np.where(rng.random((n, H, W)) < 0.5, 5, 0).astype(np.int8)
    inner[:, 1 : H // 2] = 0
    inner[:, 0, 0], inner[:, 0, 1] = 6, 0
    n_full = rng.integers(1, 5, n)
    inner[np.arange(H)[None, :] >= H - n_full[:, None]] = 3
    st["board"][:, :H, pad : pad + W] = inner
    st["piece"] = rng.integers(0, qs, n).astype(np.int32)
    st["rotation"] = rng.integers(0, 4, n).astype(np.int32)
    st["x"] = rng.integers(-3, tc.padded_width, n).astype(np.int32)
    st["y"] = rng.integers(0, tc.padded_height, n).astype(np.int32)
    st["queue_index"] = np.where(rng.random(n) < 0.5, qs, rng.integers(0, qs, n)).astype(np.int32)
    st["game_over"] = rng.random(n) < 0.2
    st = {k: np.repeat(v, 8, axis=0) for k, v in st.items()}
    return st, (np.arange(8 * n) % 8).astype(np.int32)


@pytest.mark.parametrize("name", ["default", "uniform5", "8x12-pad2"])
def test_hand_built_stacks_match_jax(name):
    """Every action 0-7 on stacks with full rows: hard drops clear 1-4 rows and
    copy row 0, refills draw from the key's second half, frozen games stay."""
    jc, tc, jq, tq, _, jstep, _ = _engines(name)
    st, actions = _stacks(name, 24, 9)
    js = jfn.FnState(**{k: jnp.asarray(v) for k, v in st.items()})
    ts = fn_env.state_from_numpy(st, device=CPU)
    t_out = fn_env.step(ts, torch.from_numpy(actions), tc, queue_fns=tq)
    _assert_step(t_out, jstep(js, jnp.asarray(actions)), name)
    new, lines = t_out[0], t_out[4]["lines_cleared"]
    pad, W = tc.padding, tc.width
    row0 = (new.board[:, 0, pad : pad + W] > 0).any(dim=1)
    over = ts.game_over
    assert ((lines > 0) & row0 & ~over).any(), "no line clear copied row 0"
    assert ((ts.queue_index == tc.queue_size) & (new.queue_index == 1) & ~over).any(), "no refill"
    assert torch.equal(new.board[over], ts.board[over]) and bool((t_out[2][over] == 0).all())


def test_frozen_states_match_jax():
    """A finished game passes its state through, key and score included:
    reward 0, lines 0, terminated."""
    jc, tc, jq, tq, reset, jstep, _ = _engines("default")
    keys = _keys(23, 16)
    _, js, _ = reset(keys)
    js = js.replace(game_over=jnp.ones(16, bool), score=jnp.arange(16, dtype=jnp.float32))
    ts = fn_env.state_from_numpy(_numpy(js), device=CPU)
    for a in range(8):
        actions = np.full(16, a, np.int32)
        t_out = fn_env.step(ts, torch.from_numpy(actions), tc, queue_fns=tq)
        _assert_step(t_out, jstep(js, jnp.asarray(actions)), f"action {a}")
        _assert_state(t_out[0], js, f"frozen, action {a}")
        assert t_out[3].all() and (t_out[2] == 0).all() and (t_out[4]["lines_cleared"] == 0).all()


def test_state_numpy_round_trip():
    jc, tc, _, tq, reset, _, _ = _engines("default")
    _, js, _ = reset(_keys(4, 5))
    ts = fn_env.state_from_numpy(_numpy(js), device=CPU)
    _assert_state(ts, js, "from numpy")
    back = fn_env.state_to_numpy(ts)
    for k in fn_env.FIELDS:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(js, k)))
        assert back[k].dtype == np.asarray(getattr(js, k)).dtype
    # a single env becomes a batch of one
    _, single, _ = jfn.jit_reset(jc)(jax.random.PRNGKey(8))
    one = fn_env.state_from_numpy(_numpy(single), device=CPU)
    assert one.board.shape == (1, tc.padded_height, tc.padded_width) and one.rng_key.shape == (1, 2)
    _assert_state(one, jax.tree.map(lambda v: v[None], single), "single")


def test_play_random_functional_matches_jax_example():
    """The ported example's game against the JAX example's loop (its first
    200 steps at most): steps, score and the last observation."""
    config = jconfig.EnvConfig(width=10, height=20, padding=4, queue_size=7)
    step, reset = jfn.jit_step(config), jfn.jit_reset(config)
    key, state, obs = reset(jax.random.PRNGKey(42))
    steps = 0
    while not bool(state.game_over) and steps < 200:
        key, sub = jax.random.split(key)
        state, obs, reward, terminated, info = step(state, jax.random.randint(sub, (), 0, 7))
        steps += 1
    game = prf.play(CPU, max_steps=200)
    assert (game["steps"], game["score"]) == (steps, float(state.score))
    np.testing.assert_array_equal(game["obs"], np.asarray(obs))


# ---------------------------------------------------------------------------
# Behavioural tests, as tests/test_fn_env.py runs them on the JAX engine
# ---------------------------------------------------------------------------

CFG = tconfig.EnvConfig()


def _traj(key_seed, action_seed, n, B=1):
    keys = _keys(key_seed, B)
    _, state, _ = fn_env.batched_reset(keys, config=CFG, device=CPU)
    actions = torch.from_numpy(np.random.default_rng(action_seed).integers(0, 7, (n, B)).astype(np.int32))
    return fn_env.rollout(state, actions, CFG)


def test_same_seed_same_trajectory():
    a, b = _traj(123, 9, 150), _traj(123, 9, 150)
    assert torch.equal(a[1][0], b[1][0]) and torch.equal(a[0].board, b[0].board)


def test_game_over_freezes_state():
    _, state, _ = fn_env.jit_reset(CFG, CPU)(_keys(0, 1))
    state = state.replace(game_over=torch.ones(1, dtype=torch.bool))
    new_state, obs, reward, term, info = fn_env.jit_step(CFG)(state, torch.full((1,), 6, dtype=torch.int32))
    assert bool(term[0]) and float(reward[0]) == 0.0 and int(info["lines_cleared"][0]) == 0
    assert torch.equal(new_state.board, state.board) and torch.equal(new_state.rng_key, state.rng_key)


def test_score_is_the_sum_of_rewards_and_games_end():
    """Random play: rewards never negative, every game of 8 ends within 400
    steps, and the score is the running sum of the rewards."""
    final, (obs, rew, term, lines) = _traj(3, 3, 400, B=8)
    assert (rew >= 0).all() and term[-1].all()
    np.testing.assert_array_equal(final.score.numpy(), rew.sum(dim=0).numpy())


def test_batched_step_equals_one_env_at_a_time():
    B, T = 8, 20
    keys = _keys(17, B)
    _, states, _ = fn_env.batched_reset(keys, config=CFG, device=CPU)
    acts = torch.from_numpy(np.random.default_rng(17).integers(0, 7, (T, B)).astype(np.int32))
    vfinal, (vobs, vrew, vterm, _) = fn_env.rollout(states, acts, CFG)
    for b in range(B):
        one = fn_env.FnState(**{k: getattr(states, k)[b : b + 1] for k in fn_env.FIELDS})
        sfinal, (sobs, srew, sterm, _) = fn_env.rollout(one, acts[:, b : b + 1], CFG)
        assert torch.equal(sobs[:, 0], vobs[:, b]) and torch.equal(srew[:, 0], vrew[:, b])
        assert torch.equal(sfinal.board[0], vfinal.board[b])


def test_batched_reset_shapes_and_key_identity():
    B = 16
    keys = _keys(2, B)
    _, states, obs = fn_env.batched_reset(keys, config=CFG, device=CPU)
    assert states.board.shape == (B, CFG.padded_height, CFG.padded_width)
    assert obs.shape == (B, CFG.height, CFG.width)
    _, s2, o2 = fn_env.batched_reset(np.stack([keys[0], keys[0]]), config=CFG, device=CPU)
    assert torch.equal(o2[0], o2[1]) and torch.equal(s2.queue[0], s2.queue[1])


def test_observation_active_piece_is_minus_one():
    _, state, obs = fn_env.jit_reset(CFG, CPU)(_keys(21, 1))
    obs = obs[0]
    assert obs.shape == (CFG.height, CFG.width)
    assert int(obs.min()) == -1 and int((obs == -1).sum()) == 4 and int(obs.max()) <= 1
    assert torch.equal(fn_env.observe(state, CFG)[0], obs)


def test_cpu_runs_the_plain_versions_and_cuda_needs_a_card():
    kernels.reset_launches()
    keys, state, obs = fn_env.reset(_keys(1, 3), CFG, device=CPU)
    fn_env.step(state, torch.zeros(3, dtype=torch.int32), CFG)
    fn_env.observe(state, CFG)
    assert kernels.LAUNCHES == NO_LAUNCHES
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            fn_env.reset(_keys(1, 3), CFG)
        with pytest.raises(RuntimeError, match="cuda"):
            prf.play()
