"""The port's Gymnasium shell against the JAX package's, on the CPU.

``tetris_gymnasium_torch.envs.Tetris(device="cpu")`` must pass Gymnasium's
env checker, keep the spaces and API of ``tests/test_gym_env.py``, and play
the JAX shell's episodes step for step: the Dict observation, reward,
termination, ``lines_cleared`` and both renderings, from the same seeds and
actions (out-of-range ids included).  The per-concern action semantics of
``tests/test_base_env_actions.py`` are held on the port's shell.  Without
Gymnasium the shell runs on the stand-ins of ``utils/gym_lite.py``: with
Gymnasium hidden, the shell, the wrappers and the vector adapter must play
as they do on Gymnasium.
"""
import importlib
import sys
import types

import gymnasium as gym
import numpy as np
import pytest
import torch

import tetris_gymnasium_tpu.envs  # noqa: F401 (registers the JAX env)
import tetris_gymnasium_torch.envs  # noqa: F401 (registers the port's env)
from tetris_gymnasium_torch.config import ActionsMapping, EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import engine
from tetris_gymnasium_torch.envs import Tetris, TetrisVectorEnv
from tetris_gymnasium_torch.ops.board import create_board
from tetris_gymnasium_torch.pieces import PIECES
from tetris_gymnasium_torch.wrappers import (
    FeatureVectorObservation,
    GroupedActionsObservations,
    RgbObservation,
)

A = ActionsMapping()
R = RewardsMapping()
H, W, P = 20, 10, 4
PW = W + 2 * P

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture()
def env():
    e = gym.make("tetris_gymnasium_torch/Tetris", render_mode="rgb_array", device="cpu")
    yield e
    e.close()


@pytest.fixture(scope="module")
def jax_env():
    return gym.make("tetris_gymnasium_tpu/Tetris", render_mode="rgb_array")


def test_env_checker_compliance(env):
    from gymnasium.utils.env_checker import check_env

    check_env(env.unwrapped, skip_render_check=True)


def test_registration_and_spaces(env, jax_env):
    assert env.action_space.n == 8
    obs, info = env.reset(seed=0)
    assert set(obs) == {"board", "active_tetromino_mask", "holder", "queue"}
    for k, space in env.observation_space.items():
        assert obs[k].shape == space.shape, k
        assert obs[k].dtype == space.dtype, k
        assert space == jax_env.observation_space[k], k


@pytest.mark.parametrize("seed", [0, 17])
def test_episodes_equal_jax_shell(env, jax_env, seed):
    """200 steps of random actions (ids -2..9: out of range ones are no-ops
    with gravity), restarting on game over: every output equal."""
    rng = np.random.default_rng(seed)
    env.unwrapped.render_mode = jax_env.unwrapped.render_mode = "rgb_array"
    obs_t, _ = env.reset(seed=seed)
    obs_j, _ = jax_env.reset(seed=seed)
    ends = 0
    for i in range(200):
        for k in obs_j:
            np.testing.assert_array_equal(obs_t[k], obs_j[k], err_msg=f"{k} @ {i}")
        if i % 25 == 0:
            np.testing.assert_array_equal(env.render(), jax_env.render(), err_msg=f"rgb @ {i}")
            assert env.unwrapped._render_ansi() == jax_env.unwrapped._render_ansi(), i
        a = int(rng.choice([-2, 8, 9, *range(8)], p=[.02, .02, .02] + [.94 / 8] * 8))
        obs_t, r_t, term_t, trunc_t, info_t = env.step(a)
        obs_j, r_j, term_j, trunc_j, info_j = jax_env.step(a)
        assert (r_t, term_t, trunc_t, info_t) == (r_j, term_j, trunc_j, info_j), i
        if term_t:
            ends += 1
            obs_t, _ = env.reset(seed=seed + i)
            obs_j, _ = jax_env.reset(seed=seed + i)
    assert ends > 0


def test_same_seed_same_episode(env):
    def play(seed):
        obs, _ = env.reset(seed=seed)
        frames = [obs["board"]]
        rng = np.random.default_rng(7)
        for _ in range(50):
            obs, r, term, trunc, _ = env.step(int(rng.integers(0, 8)))
            frames.append(obs["board"])
            if term:
                break
        return frames

    a, b = play(11), play(11)
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("trial", range(3))
def test_clone_restore_determinism(env, trial):
    env.reset(seed=trial)
    rng = np.random.default_rng(trial)
    for _ in range(int(rng.integers(1, 20))):
        env.step(int(rng.integers(0, 8)))
    snap = env.unwrapped.get_state()
    actions = rng.integers(0, 8, 15)
    first = [env.step(int(a))[0]["board"] for a in actions]
    env.unwrapped.set_state(snap)
    second = [env.step(int(a))[0]["board"] for a in actions]
    assert all(np.array_equal(x, y) for x, y in zip(first, second))


def test_render_rgb_array_and_ansi(env):
    env.reset(seed=1)
    frame = env.render()
    assert frame.shape == (24, 34, 3) and frame.dtype == np.uint8
    ansi = Tetris(render_mode="ansi", device="cpu")
    ansi.reset(seed=1)
    text = ansi.render()
    assert len(text.splitlines()) == H and all(len(row) == W for row in text.splitlines())


def test_random_play_reaches_game_over():
    env = Tetris(device="cpu")
    env.reset(seed=5)
    rng = np.random.default_rng(5)
    for _ in range(3000):
        _, _, term, _, _ = env.step(int(rng.integers(0, 8)))
        if term:
            break
    assert term


def test_custom_action_mapping_must_be_bijective():
    with pytest.raises(ValueError, match="distinct"):
        Tetris(actions_mapping=ActionsMapping(move_left=1, move_right=1), device="cpu")
    with pytest.raises(ValueError, match="0..7"):
        Tetris(actions_mapping=ActionsMapping(hard_drop=11), device="cpu")
    amap = ActionsMapping(move_left=7, move_right=6, move_down=5, rotate_clockwise=4,
                          rotate_counterclockwise=3, hard_drop=2, swap=1, no_op=0)
    env = Tetris(actions_mapping=amap, device="cpu")
    env.reset(seed=0)
    x0 = int(env.state.x[0])
    env.step(7)  # user id 7 = move_left
    assert int(env.state.x[0]) == x0 - 1


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        Tetris()


_SHELL_MODULES = ("tetris_gymnasium_torch.envs", "tetris_gymnasium_torch.envs.api",
                  "tetris_gymnasium_torch.envs.gym_env", "tetris_gymnasium_torch.envs.vector_env",
                  "tetris_gymnasium_torch.wrappers", "tetris_gymnasium_torch.wrappers.observation",
                  "tetris_gymnasium_torch.wrappers.grouped")


@pytest.fixture()
def lite(monkeypatch):
    """The shell's modules imported anew with Gymnasium hidden, so that they
    build on ``utils/gym_lite.py`` as on a machine without Gymnasium; the
    modules imported before are put back afterwards."""
    import tetris_gymnasium_torch as pkg
    from tetris_gymnasium_torch.utils import gym_lite

    monkeypatch.setitem(sys.modules, "gymnasium", None)  # `import gymnasium` raises
    for name in _SHELL_MODULES:
        monkeypatch.delitem(sys.modules, name, raising=False)
    for sub in ("envs", "wrappers"):
        monkeypatch.setattr(pkg, sub, getattr(pkg, sub))  # restored afterwards
    mods = types.SimpleNamespace(
        api=importlib.import_module("tetris_gymnasium_torch.envs.api"),
        envs=importlib.import_module("tetris_gymnasium_torch.envs"),
        wrappers=importlib.import_module("tetris_gymnasium_torch.wrappers"))
    assert not mods.api.HAVE_GYMNASIUM and mods.api.gym is gym_lite
    yield mods


def _space_equal(a, b, what):
    assert type(a).__name__ == type(b).__name__, what
    if hasattr(b, "spaces"):
        assert a.spaces.keys() == b.spaces.keys(), what
        for k in b.spaces:
            _space_equal(a.spaces[k], b.spaces[k], f"{what}[{k}]")
        return
    assert a.shape == b.shape and a.dtype == b.dtype, what
    for attr in ("low", "high", "n", "start", "nvec"):
        if hasattr(b, attr):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr), err_msg=f"{what}.{attr}")


def _assert_same(a, b, what):
    """Two outputs of the shell (arrays, dicts, tuples, scalars) are equal."""
    if isinstance(b, dict):
        assert a.keys() == b.keys(), what
        for k in b:
            _assert_same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(b, tuple):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(b, np.ndarray) and b.dtype == object:
        for i, (x, y) in enumerate(zip(a, b)):
            assert (x is None) == (y is None), f"{what}[{i}]"
            if y is not None:
                _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, what


def test_shell_runs_without_gymnasium(lite):
    """On the stand-ins the shell and the observation wrappers play the
    Gymnasium-backed shell's episodes: spaces, observations, rewards,
    infos, both renderings, and the seeds ``reset()`` draws from
    ``np_random`` after an episode ends."""
    lite_env, gym_env = (T(render_mode="rgb_array", device="cpu") for T in (lite.envs.Tetris, Tetris))
    assert isinstance(gym_env, gym.Env) and not isinstance(lite_env, gym.Env)
    stacks = [(lite_env, gym_env)]
    for lite_wrap, wrap in ((lite.wrappers.RgbObservation, RgbObservation),
                            (lite.wrappers.FeatureVectorObservation, FeatureVectorObservation)):
        stacks.append((lite_wrap(lite.envs.Tetris(render_mode="rgb_array", device="cpu")),
                       wrap(Tetris(render_mode="rgb_array", device="cpu"))))
    rng = np.random.default_rng(3)
    for n, (a, b) in enumerate(stacks):
        _space_equal(a.observation_space, b.observation_space, f"stack {n} observation")
        _space_equal(a.action_space, b.action_space, f"stack {n} action")
        _assert_same(a.reset(seed=3 + n), b.reset(seed=3 + n), f"stack {n} reset")
        ends = 0
        for i in range(60 if n == 0 else 20):
            act = int(rng.choice([-1, 8, 5, *range(8)], p=[.02, .02, .46] + [.0625] * 8))
            out = a.step(act)
            _assert_same(out, b.step(act), f"stack {n} step {i}")
            if i % 10 == 0:
                _assert_same(a.render(), b.render(), f"stack {n} render {i}")
                assert a.unwrapped._render_ansi() == b.unwrapped._render_ansi()
            if n == 0:
                assert a.observation_space.contains(out[0]) == b.observation_space.contains(out[0])
            if out[2]:
                ends += 1
                _assert_same(a.reset(), b.reset(), f"stack {n} reset after {i}")  # np_random's seed
        assert ends > 0 or n > 0
        a.close()
        b.close()


@pytest.mark.parametrize("mode,terminate", [("features", True), ("boards", True), ("rgb", True),
                                            ("host", True), ("features", False)])
def test_gym_lite_grouped_wrapper_equals_gymnasium(lite, mode, terminate):
    """The grouped wrapper on the stand-ins equals it on Gymnasium, step for
    step, legal and illegal actions, in every mode."""
    def build(envs, wrappers):
        env = envs.Tetris(gravity=False, device="cpu")
        inner = {"features": [wrappers.FeatureVectorObservation(env)], "boards": None,
                 "rgb": [wrappers.RgbObservation(env)],
                 "host": [wrappers.FeatureVectorObservation(env, report_bumpiness=False)]}[mode]
        return wrappers.GroupedActionsObservations(env, inner, terminate, "host" if mode == "host" else None)

    a = build(lite.envs, lite.wrappers)
    b = build(types.SimpleNamespace(Tetris=Tetris), types.SimpleNamespace(
        FeatureVectorObservation=FeatureVectorObservation, RgbObservation=RgbObservation,
        GroupedActionsObservations=GroupedActionsObservations))
    assert a.mode == b.mode
    _space_equal(a.observation_space, b.observation_space, "observation")
    _space_equal(a.action_space, b.action_space, "action")
    rng = np.random.default_rng(len(mode) + terminate)
    out_a, out_b = a.reset(seed=8), b.reset(seed=8)
    _assert_same(out_a, out_b, "reset")
    n_illegal = 0
    for i in range(10):
        legal, illegal = (np.nonzero(out_b[-1]["action_mask"] == v)[0] for v in (1, 0))
        act = int(rng.choice(illegal if (i % 4 == 3 and len(illegal)) or not len(legal) else legal))
        n_illegal += int(not out_b[-1]["action_mask"][act])
        out_a, out_b = a.step(act), b.step(act)
        _assert_same(out_a, out_b, f"step {i}")
        if out_b[2]:
            out_a, out_b = a.reset(seed=9 + i), b.reset(seed=9 + i)
            _assert_same(out_a, out_b, f"reset after {i}")
    assert n_illegal > 0


@pytest.mark.parametrize("impl", ["turbo", "flagship"])
def test_gym_lite_vector_env_equals_gymnasium(lite, impl):
    """TetrisVectorEnv on the stand-ins equals it on Gymnasium: spaces,
    metadata, observations, rewards, terminations and ``final_obs``."""
    n = 4
    a = lite.envs.TetrisVectorEnv(n, impl=impl, seed=5, device="cpu")
    b = TetrisVectorEnv(n, impl=impl, seed=5, device="cpu")
    assert a.metadata["autoreset_mode"].value == b.metadata["autoreset_mode"].value == "SameStep"
    for k in ("single_observation_space", "single_action_space", "observation_space", "action_space"):
        _space_equal(getattr(a, k), getattr(b, k), k)
    _assert_same(a.reset(seed=5), b.reset(seed=5), "reset")
    rng = np.random.default_rng(5)
    ends = 0
    for i in range(14):
        acts = rng.choice(8, n, p=[.02] * 5 + [.86, .02, .02])
        out = a.step(acts)
        _assert_same(out, b.step(acts), f"step {i}")
        ends += int(out[2].sum())
    assert ends > 0
    a.close()
    b.close()
    assert a.closed and b.closed


# -- action semantics through the shell (tests/test_base_env_actions.py) -------


def _shell(gravity=True, piece=0, rotation=0, x=None, y=0, board=None):
    """A port shell forced into a chosen pose on a chosen (default empty) board."""
    env = Tetris(gravity=gravity, device="cpu")
    env.reset(seed=0)
    x = PW // 2 - int(PIECES.box[piece]) // 2 if x is None else x
    repl = dict(piece=torch.tensor([piece], dtype=torch.int32),
                rotation=torch.tensor([rotation], dtype=torch.int32),
                x=torch.tensor([x], dtype=torch.int32), y=torch.tensor([y], dtype=torch.int32))
    if board is not None:
        repl["board"] = torch.from_numpy(np.asarray(board, dtype=np.int8))[None].contiguous()
    env.set_state(env.state.replace(**repl))
    return env


def _board(fill=None):
    board = create_board(H, W, P, 1, "cpu")[0].numpy().copy()
    if fill is not None:
        fill(board)
    return board


def _wall_right(b):
    b[:H, 11:15] = 2


def _wall_left(b):
    b[:H, 3:7] = 2


def _stack8(b):
    b[8:H, P : P + W] = 2


MOVES = {
    "move_right_free": (dict(x=7, y=2), ["move_right"], lambda s: int(s.x[0]) == 8),
    "move_left_free": (dict(x=7, y=2), ["move_left"], lambda s: int(s.x[0]) == 6),
    "move_down_adds_gravity": (dict(y=5), ["move_down"], lambda s: int(s.y[0]) == 7),
    "move_down_no_gravity": (dict(gravity=False, y=5), ["move_down"], lambda s: int(s.y[0]) == 6),
    "left_wall_blocks": (dict(gravity=False, x=P, y=2), ["move_left"], lambda s: int(s.x[0]) == P),
    "right_wall_blocks": (dict(gravity=False, x=P + W - 4, y=2), ["move_right"],
                          lambda s: int(s.x[0]) == P + W - 4),
    "stack_blocks_right": (dict(gravity=False, x=7, y=2, board=_board(_wall_right)), ["move_right"],
                           lambda s: int(s.x[0]) == 7),
    "stack_blocks_left": (dict(gravity=False, x=7, y=2, board=_board(_wall_left)), ["move_left"],
                          lambda s: int(s.x[0]) == 7),
    "stack_blocks_down": (dict(gravity=False, x=P, y=5, board=_board(_stack8)), ["move_down"],
                          lambda s: int(s.y[0]) == 6),
    "three_moves_left": (dict(gravity=False, x=9, y=2), ["move_left"] * 3, lambda s: int(s.x[0]) == 6),
    "gravity_one_cell": (dict(y=3), ["no_op"], lambda s: int(s.y[0]) == 4),
    "rotate_cw_free": (dict(gravity=False, y=5), ["rotate_clockwise"], lambda s: int(s.rotation[0]) == 1),
    "rotate_ccw_free": (dict(gravity=False, y=5), ["rotate_counterclockwise"],
                        lambda s: int(s.rotation[0]) == 3),
    "full_360": (dict(gravity=False, y=5), ["rotate_clockwise"] * 4, lambda s: int(s.rotation[0]) == 0),
    "rotate_blocked_by_wall": (dict(gravity=False, rotation=1, x=P - 1, y=2), ["rotate_clockwise"],
                               lambda s: int(s.rotation[0]) == 1),
    "first_swap": (dict(gravity=False, y=3), ["swap"],
                   lambda s: int(s.holder_count[0]) == 1 and int(s.holder_piece[0, 0]) == 0
                   and bool(s.has_swapped[0]) and int(s.y[0]) == 0),
    "double_swap_blocked": (dict(gravity=False, y=3), ["swap", "swap"],
                            lambda s: int(s.holder_count[0]) == 1 and bool(s.has_swapped[0])),
    "swap_keeps_orientation": (dict(gravity=False, rotation=1, y=2), ["swap", "hard_drop", "swap"],
                               lambda s: int(s.piece[0]) == 0 and int(s.rotation[0]) == 1),
}


@pytest.mark.parametrize("name", sorted(MOVES))
def test_action_semantics(name):
    setup, actions, check = MOVES[name]
    env = _shell(**setup)
    for a in actions:
        env.step(getattr(A, a))
    assert check(env.state), name


@pytest.mark.parametrize("lines", [0, 1, 2, 3, 4])
def test_score_matrix(lines):
    def fill(b):
        if lines:
            b[H - lines : H, P : P + W] = 2
            b[H - lines : H, P] = 0

    env = _shell(gravity=False, rotation=1, x=P - 1, board=_board(fill))
    _, reward, term, _, info = env.step(A.hard_drop)
    assert not term and info["lines_cleared"] == lines
    assert reward == pytest.approx(R.alife + lines * lines * W)


def test_game_over_reward():
    def fill(b):
        b[:H, P : P + W] = 2

    env = _shell(gravity=False, board=_board(fill))
    _, reward, term, _, _ = env.step(A.hard_drop)
    assert term and reward == R.game_over


@pytest.mark.parametrize("piece", range(7))
def test_every_piece_spawn_drop_is_sound(piece):
    env = _shell(gravity=False, piece=piece)
    _, reward, term, _, _ = env.step(A.hard_drop)
    assert not term and reward == R.alife
    assert int((env.state.board > 1).sum()) == 4


def test_step_without_obs_fn_returns_the_dict_obs():
    """The engine's step builds the Dict observation by default, as JAX's does."""
    cfg = EngineConfig()
    s = engine.init(np.array([[0, 3]], dtype=np.uint32), cfg, device="cpu")
    _, obs, *_ = engine.step(s, torch.tensor([5], dtype=torch.int32), cfg)
    assert set(obs) == {"board", "active_tetromino_mask", "holder", "queue"}
