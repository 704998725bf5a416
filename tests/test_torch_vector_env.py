"""The port's vector adapter against the JAX package's, on the CPU.

Mirrors ``tests/test_vector_env.py`` (the Gymnasium vector contract,
seeding, SAME_STEP autoreset with ``final_obs``, a third-party loop) on
``TetrisVectorEnv(device="cpu")``, and holds its trajectories equal to the
JAX adapter's for both engines: observations, rewards, terminations, lines
and the terminal observations, from the same seed and actions.
"""
import gymnasium as gym
import numpy as np
import pytest
import torch
from gymnasium.vector import AutoresetMode

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.envs.vector_env import TetrisVectorEnv as JTetrisVectorEnv

from tetris_gymnasium_torch.components import Tetromino
from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.envs import TetrisVectorEnv

B = 16

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(params=["turbo", "flagship"])
def venv(request):
    return TetrisVectorEnv(B, EngineConfig(), impl=request.param, seed=7, device="cpu")


def test_vector_api_contract(venv):
    assert isinstance(venv, gym.vector.VectorEnv)
    assert venv.num_envs == B and venv.metadata["autoreset_mode"] == AutoresetMode.SAME_STEP
    obs, infos = venv.reset(seed=3)
    assert obs.shape == (B, 20, 10) and obs.dtype == np.int8
    assert venv.observation_space.contains(obs) and isinstance(infos, dict)
    obs, rew, term, trunc, infos = venv.step(np.full(B, 7))
    assert venv.observation_space.contains(obs)
    assert rew.shape == (B,) and rew.dtype == np.float32
    assert term.dtype == bool and trunc.dtype == bool and not trunc.any()
    assert infos["lines_cleared"].shape == (B,)


def test_reset_seed_determinism(venv):
    def run():
        out = [venv.reset(seed=11)[0]]
        rng = np.random.default_rng(0)
        for _ in range(10):
            out += list(venv.step(rng.integers(0, 8, B))[:3])
        return out

    for a, b in zip(run(), run()):
        np.testing.assert_array_equal(a, b)


def test_same_step_autoreset_delivers_final_obs(venv):
    venv.reset(seed=5)
    for _ in range(60):
        obs, rew, term, trunc, infos = venv.step(np.full(B, 5))
        if term.any():
            np.testing.assert_array_equal(infos["_final_obs"], term)
            assert infos["final_obs"].dtype == object
            assert all(infos["final_obs"][b] is None for b in np.nonzero(~term)[0])
            for b in np.nonzero(term)[0]:
                assert (infos["final_obs"][b] != 0).sum() > (obs[b] != 0).sum()
            return
    pytest.fail("hard-drop spam never terminated an episode")


@pytest.mark.parametrize("impl", ["turbo", "flagship"])
def test_trajectories_equal_jax_adapter(impl):
    """60 steps biased to hard drops: every output equal to the JAX
    adapter's, restarts and terminal observations included."""
    mine = TetrisVectorEnv(B, EngineConfig(), impl=impl, seed=9, device="cpu")
    theirs = JTetrisVectorEnv(B, JEngineConfig(), impl=impl, seed=9)
    np.testing.assert_array_equal(mine.reset()[0], theirs.reset()[0])
    rng = np.random.default_rng(1)
    ends = 0
    for i in range(60):
        acts = rng.choice(8, B, p=[.1, .1, .05, .1, .05, .5, .05, .05])
        got, want = mine.step(acts), theirs.step(acts)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w, err_msg=f"step {i}")
        assert got[4].keys() == want[4].keys()
        np.testing.assert_array_equal(got[4]["lines_cleared"], want[4]["lines_cleared"])
        if "final_obs" in want[4]:
            ends += int(want[4]["_final_obs"].sum())
            for g, w in zip(got[4]["final_obs"], want[4]["final_obs"]):
                assert (g is None and w is None) or np.array_equal(g, w)
    assert ends > 0


def test_third_party_style_loop_runs():
    venv = TetrisVectorEnv(B, EngineConfig(), impl="turbo", seed=1, device="cpu")
    wrapped = gym.wrappers.vector.RecordEpisodeStatistics(venv)
    wrapped.reset(seed=1)
    episodes = 0
    rng = np.random.default_rng(2)
    for _ in range(150):
        *_, infos = wrapped.step(rng.choice(8, B, p=[.1, .1, .05, .1, .05, .5, .05, .05]))
        if "episode" in infos:
            episodes += int(np.sum(infos["_episode"]))
    assert episodes > 0


def test_oversize_pieces_raise_on_turbo_and_play_on_flagship():
    """A 6x6-box set plays on both engines, the same game (the turbo
    engine's two-word piece table); the kernels take it, and raise only for
    a box past their static limit."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.components.tetromino import pieces_from_tetrominoes
    from tetris_gymnasium_torch.ops import bitboard as bb

    tets = [Tetromino(2, (255, 0, 0), np.ones((2, 2), np.uint8)),
            Tetromino(3, (0, 255, 0), np.ones((1, 6), np.uint8))]
    cfg = EngineConfig(width=8, height=12, queue_size=2, queue_kind="uniform")
    envs = [TetrisVectorEnv(4, cfg, impl=impl, tetrominoes=tets, device="cpu")
            for impl in ("turbo", "flagship")]
    obs = [env.reset(seed=0)[0] for env in envs]
    assert obs[0].shape == (4, 12, 8)
    np.testing.assert_array_equal(obs[0], obs[1])
    deaths = 0
    for _ in range(40):
        got = [env.step(np.full(4, 5)) for env in envs]
        for x, y in zip(got[0][:4], got[1][:4]):
            np.testing.assert_array_equal(x, y)
        deaths += int(got[0][2].sum())
    assert deaths > 0
    pieces, pad = pieces_from_tetrominoes(tets)
    assert dict(kernels.engine_defines(cfg._replace(padding=pad), bb.turbo_tables(pieces)))["TETRIS_S"] == 6
    big, pad = pieces_from_tetrominoes(tets + [Tetromino(4, (0, 0, 255), np.ones((1, 9), np.uint8))])
    with pytest.raises(NotImplementedError, match="piece box side 9"):
        kernels.engine_defines(cfg._replace(padding=pad), bb.turbo_tables(big))
