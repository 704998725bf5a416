"""The port's wrappers against the JAX package's, on the CPU.

``RgbObservation``, ``FeatureVectorObservation`` and
``GroupedActionsObservations`` over ``Tetris(device="cpu")`` must give the
JAX wrappers' outputs over 30-step episodes in every mode (boards,
features, rgb, host), with legal and illegal actions, and keep the
behaviour of ``tests/test_wrappers.py`` and ``tests/test_grouped.py:197-420``:
feature values on the reference fixture, the composite's layout, the
per-candidate inner wrappers, ``info["board"]`` only after a legal action,
the illegal sentinel at ``space.high``.
"""
import gymnasium as gym
import numpy as np
import pytest
import torch
from gymnasium import spaces

import tetris_gymnasium_tpu.envs  # noqa: F401
from tetris_gymnasium_tpu import wrappers as jwrappers

import tetris_gymnasium_torch.envs  # noqa: F401
from tetris_gymnasium_torch.core import grouped
from tetris_gymnasium_torch.ops.board import create_board
from tetris_gymnasium_torch.ops.observations import feature_vector
from tetris_gymnasium_torch.wrappers import (
    FeatureVectorObservation,
    GroupedActionsObservations,
    RgbObservation,
)

H, W, P = 20, 10, 4
EXPECTED_HEIGHTS = [10, 11, 10, 10, 11, 11, 10, 10, 10, 0]

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _example_board():
    board = create_board(H, W, P, 1, "cpu")[0].numpy().copy()
    top = H // 2
    board[top:H, P : -(P + 1)] = 2
    board[top - 1, P + 1] = 2
    board[top - 1, P + 4] = 2
    board[top - 1, P + 5] = 2
    board[top + 2, P + 2] = 0
    board[top + 4, P + 3] = 0
    board[top + 6, P + 6] = 0
    return board


def _make(which, **kw):
    if which == "jax":
        return gym.make("tetris_gymnasium_tpu/Tetris", **kw)
    return gym.make("tetris_gymnasium_torch/Tetris", device="cpu", **kw)


def _stack(which, mode, terminate=True):
    env = _make(which, gravity=False)
    w = jwrappers if which == "jax" else __import__("tetris_gymnasium_torch.wrappers",
                                                   fromlist=["x"])
    inner = {"boards": None, "features": [w.FeatureVectorObservation(env)],
             "rgb": [w.RgbObservation(env)],
             "host": [w.FeatureVectorObservation(env, report_bumpiness=False)]}[mode]
    return w.GroupedActionsObservations(env, observation_wrappers=inner,
                                        terminate_on_illegal_action=terminate,
                                        mode="host" if mode == "host" else None)


@pytest.mark.parametrize("mode,terminate", [("boards", True), ("features", True), ("rgb", True),
                                            ("host", True), ("features", False)])
def test_grouped_wrapper_equals_jax(mode, terminate):
    """30-step episodes of legal actions, with one in seven illegal and one
    in seven uniform: observation, reward, done and info equal every step."""
    mine, theirs = _stack("torch", mode, terminate), _stack("jax", mode, terminate)
    assert mine.mode == theirs.mode and mine.observation_space == theirs.observation_space
    rng = np.random.default_rng(3)
    o, i = mine.reset(seed=8)
    jo, ji = theirs.reset(seed=8)
    n_illegal = 0
    for step in range(30):
        np.testing.assert_array_equal(o, jo, err_msg=f"obs @ {step}")
        assert o.dtype == jo.dtype
        assert i.keys() == ji.keys()
        for k in ji:
            got, want = (i[k], ji[k]) if isinstance(ji[k], dict) else ({0: i[k]}, {0: ji[k]})
            assert got.keys() == want.keys()
            for kk in want:
                np.testing.assert_array_equal(got[kk], want[kk], err_msg=f"{k} {kk} @ {step}")
        legal, illegal = (np.nonzero(i["action_mask"] == v)[0] for v in (1, 0))
        u = rng.random()
        pick = illegal if (u < 0.15 and len(illegal)) or not len(legal) else legal
        a = int(rng.integers(0, 40)) if u > 0.85 else int(rng.choice(pick))
        n_illegal += int(i["action_mask"][a] == 0)
        o, r, d, t, i = mine.step(a)
        jo, jr, jd, jt, ji = theirs.step(a)
        assert (r, d, t) == (jr, jd, jt), step
        if d:
            o, i = mine.reset(seed=step)
            jo, ji = theirs.reset(seed=step)
    assert n_illegal > 0


def test_observation_wrappers_equal_jax():
    """RgbObservation and FeatureVectorObservation (every flag set) along a
    played episode; render() of the upscaled composite too."""
    env, jenv = _make("torch", render_mode="rgb_array"), _make("jax", render_mode="rgb_array")
    rgb, jrgb = RgbObservation(env), jwrappers.RgbObservation(jenv)
    feats = [FeatureVectorObservation(env, *f) for f in ((1, 1, 1, 1), (0, 1, 1, 0), (1, 0, 0, 1))]
    jfeats = [jwrappers.FeatureVectorObservation(jenv, *f) for f in ((1, 1, 1, 1), (0, 1, 1, 0),
                                                                     (1, 0, 0, 1))]
    o, _ = rgb.reset(seed=4)
    jo, _ = jrgb.reset(seed=4)
    rng = np.random.default_rng(4)
    for step in range(30):
        np.testing.assert_array_equal(o, jo, err_msg=f"rgb @ {step}")
        for f, jf in zip(feats, jfeats):
            assert f.observation_space == jf.observation_space
            np.testing.assert_array_equal(f.observation(None), jf.observation(None))
        a = int(rng.integers(0, 8))
        o, r, d, *_ = rgb.step(a)
        jo, jr, jd, *_ = jrgb.step(a)
        assert (r, d) == (jr, jd)
        if d:
            break
    np.testing.assert_array_equal(rgb.render(), jrgb.render())


def test_feature_values_match_reference_fixture():
    pf = torch.from_numpy(_example_board()[None, :-P, P:-P].copy())
    assert feature_vector(pf)[0].tolist() == EXPECTED_HEIGHTS + [11, 3, 14]


def test_feature_wrapper_shapes_flags_and_checker():
    from gymnasium.utils.env_checker import check_env

    env = _make("torch")
    w = FeatureVectorObservation(env)
    obs, _ = w.reset(seed=0)
    assert obs.tolist() == [0] * (W + 3)  # the piece in flight is not counted
    assert FeatureVectorObservation(env, report_height=False).reset(seed=0)[0].shape == (3,)
    assert w.observation_space.high[0] >= H * W and w.observation_space.contains(obs)
    check_env(w, skip_render_check=True)


def test_rgb_wrapper_layout_and_palette():
    env = _make("torch")
    w = RgbObservation(env)
    w.reset(seed=0)
    obs, *_ = w.step(5)
    assert obs.shape == (24, 18 + 16, 3) and obs.dtype == np.uint8
    assert obs[-1, 0].tolist() == [128, 128, 128]
    assert (obs[:P, 18:] != 128).any()
    board = env.unwrapped.state.board[0].numpy()
    palette = env.unwrapped.pieces.palette
    for y, x in list(zip(*np.nonzero(board)))[:20]:
        assert obs[y, x].tolist() == palette[board[y, x]].tolist()


def _fixture_wrapper(inner=()):
    env = _make("torch", gravity=False)
    w = GroupedActionsObservations(env, observation_wrappers=[t(env) for t in inner] or None)
    w.reset(seed=0)
    forced = env.unwrapped.state.replace(board=torch.from_numpy(_example_board()[None]).contiguous(),
                                         piece=torch.tensor([0], dtype=torch.int32),
                                         rotation=torch.tensor([1], dtype=torch.int32))
    env.unwrapped.state = forced
    _, mask = w._observe(forced)
    w._gstate = grouped.GroupedState(env=forced, mask=mask)
    w.legal_actions_mask = mask[0].numpy()
    return w


def test_wrapper_info_board_only_after_a_legal_action():
    w = _fixture_wrapper([FeatureVectorObservation])
    legal = int(np.nonzero(w.legal_actions_mask == 1)[0][0])
    _, _, _, _, info = w.step(legal)
    assert info["board"].shape == (W + 3,) and info["board"].sum() > 0
    w = _fixture_wrapper()
    illegal = int(np.nonzero(w.legal_actions_mask == 0)[0][0])
    _, _, done, _, info = w.step(illegal)
    assert done and "board" not in info


def test_wrapper_rgb_mode_matches_host_recipe():
    w = _fixture_wrapper([RgbObservation])
    assert w.mode == "rgb"
    dev_obs, _ = w._observe(w._gstate.env)
    boards, _ = grouped.jit_observation(w.config, "boards")(w._gstate.env)
    host = w._apply_candidates(boards[0].numpy(), w._base_obs(w._gstate.env))
    np.testing.assert_array_equal(dev_obs[0].numpy(), host)


def test_wrapper_host_chain_arbitrary_wrapper():
    class BoardSum(gym.ObservationWrapper):
        def __init__(self, env):
            super().__init__(env)
            self.observation_space = spaces.Box(0, 1e9, (1,), dtype=np.float32)

        def observation(self, observation):
            return np.asarray([observation["board"].sum()], dtype=np.float32)

    class Passthrough(BoardSum):
        def observation(self, observation):
            return observation

    env = _make("torch", gravity=False)
    w = GroupedActionsObservations(env, observation_wrappers=[BoardSum(env), Passthrough(env)])
    assert w.mode == "host"
    obs, _ = w.reset(seed=0)
    boards, _ = grouped.jit_observation(w.config, "boards")(w._gstate.env)
    np.testing.assert_allclose(obs, boards[0].numpy().sum(axis=(1, 2))[:, None])


def test_wrapper_host_features_equal_features_mode():
    env = _make("torch", gravity=False)
    fv = FeatureVectorObservation(env)
    fast = GroupedActionsObservations(env, observation_wrappers=[fv])
    slow = GroupedActionsObservations(env, observation_wrappers=[fv], mode="host")
    assert fast.mode == "features" and slow.mode == "host"
    np.testing.assert_allclose(fast.reset(seed=5)[0], slow.reset(seed=5)[0].astype(np.float32))


def test_features_of_board_takes_a_stack():
    """The host chain's one call over all candidates equals a call a board."""
    env = _make("torch", gravity=False)
    fv = FeatureVectorObservation(env, report_holes=False)
    w = GroupedActionsObservations(env, observation_wrappers=[fv], mode="host")
    w.reset(seed=3)
    boards = grouped.jit_observation(w.config, "boards")(w._gstate.env)[0][0].numpy()
    stacked = fv.features_of_board(boards)
    assert stacked.shape == (40, 12) and stacked.dtype == fv.observation_space.dtype
    for a in range(40):
        np.testing.assert_array_equal(stacked[a], fv.features_of_board(boards[a]), err_msg=str(a))


def test_wrapper_unknown_inner_wrapper_raises():
    with pytest.raises(TypeError, match="observation"):
        GroupedActionsObservations(_make("torch"), observation_wrappers=[object(), object()])


def test_wrapper_host_illegal_sentinel_is_space_high():
    w = _fixture_wrapper([RgbObservation])
    w.mode = "host"
    illegal = int(np.nonzero(w.legal_actions_mask == 0)[0][0])
    obs, _, done, _, _ = w.step(illegal)
    assert done and np.all(obs == w.observation_space.high.flat[0])
