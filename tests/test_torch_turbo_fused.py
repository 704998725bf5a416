"""The turbo step with its board observation in the same call, on the CPU.

``turbo.step(..., obs_fn=turbo.observe_board)`` is one ``turbo_step``
launch on the card; on CPU tensors it runs ``step_plain`` and then
``observe_board_plain``.  Held here, integers bit-equal:

* against JAX's ``turbo.step`` with the same ``obs_fn`` (state, obs,
  reward, done, lines), from numpy-seeded keys and actions at 10x20, 30x20,
  61x12 and the 6x6 pieces at widths 10 and 30, with and without
  auto-reset and gravity;
* the PPO rollout, which samples, steps and observes in one call
  (``ppo.turbo_sample_step``), the greedy evaluation and the DQN step,
  which take the observation from the step (``env_fns(..., step_obs=True)``),
  against the same code taking them from separate calls, and their env part
  against JAX, whose rollout steps and then observes (``rl/ppo.py:188-189``);
* the wrapper's choice of lanes an env and its checks of the ``obs``
  tensor.

The ``cuda``-marked test holds the kernel, every lanes count with and
without the observation, to the plain versions; it skips without a card.
The JAX package is imported inside the tests that compare with it, so that
on a machine with a card and no JAX ``python -m pytest --noconftest
tests/test_torch_turbo_fused.py -m cuda`` collects this file.
"""
import functools
import types

import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.components.tetromino import Tetromino, pieces_from_tetrominoes
from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.models.networks import ActorCriticCNN
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES
from tetris_gymnasium_torch.rl import dqn, engines, evaluate, ppo

CPU = "cpu"
# hard drops and swaps weigh more, so that games end and restart in the run
ACTION_P = (0.1, 0.1, 0.08, 0.1, 0.07, 0.3, 0.15, 0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    """The JAX modules the comparisons need, imported on first use."""
    import jax
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.components import tetromino
    from tetris_gymnasium_tpu.config import EngineConfig
    from tetris_gymnasium_tpu.core import turbo as jturbo
    from tetris_gymnasium_tpu.parallel.mesh import batch_keys
    from tetris_gymnasium_tpu.rl import evaluate as jevaluate

    return types.SimpleNamespace(jax=jax, jnp=jnp, tetromino=tetromino, EngineConfig=EngineConfig,
                                 turbo=jturbo, batch_keys=batch_keys, evaluate=jevaluate)


def _oversize_sets():
    """The 6x6-box set of ``tests/test_components.py:221``, in both packages."""
    J = _jax()
    shapes = [((255, 0, 0), np.array([[1, 1], [1, 1]], np.uint8)),
              ((0, 255, 0), np.ones((1, 6), np.uint8)),
              ((0, 0, 255), np.array([[0, 1, 0], [1, 1, 1], [0, 0, 0]], np.uint8))]
    mine, pad = pieces_from_tetrominoes([Tetromino(2 + i, c, m) for i, (c, m) in enumerate(shapes)])
    theirs, _ = J.tetromino.pieces_from_tetrominoes(
        [J.tetromino.Tetromino(2 + i, c, m) for i, (c, m) in enumerate(shapes)])
    return mine, theirs, pad


GEOMETRIES = {
    "10x20-autoreset": dict(auto_reset=True),
    "10x20-nograv": dict(gravity_enabled=False),
    "30x20-autoreset": dict(width=30, height=20, auto_reset=True),
    "30x20-nograv": dict(width=30, height=20, gravity_enabled=False, auto_reset=True),
    "61x12-queue3": dict(width=61, height=12, queue_size=3, auto_reset=True),
    "6x6-w10": dict(width=10, height=16, queue_size=2, queue_kind="uniform", auto_reset=True),
    "6x6-w30": dict(width=30, height=16, queue_size=2, queue_kind="uniform", auto_reset=True),
}


def _assert_state_equal(ts, js, where):
    for k in turbo.FIELDS:
        got, want = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        assert got.dtype == want.dtype and got.shape == want.shape, f"{k} @ {where}"
        if k == "score":
            got, want = got.view(np.int32), want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=f"{k} @ {where}")


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_fused_step_matches_jax(name):
    """60 steps x 8 envs: ``step(..., obs_fn=observe_board)`` against JAX's,
    every output bit-equal (the score by its bits)."""
    J = _jax()
    jax, jnp, jturbo = J.jax, J.jnp, J.turbo
    kw = dict(GEOMETRIES[name])
    pieces, jpieces = PIECES, None
    if name.startswith("6x6"):
        pieces, jpieces, kw["padding"] = _oversize_sets()
    jc, tc = J.EngineConfig(**kw), EngineConfig(**kw)
    pkw = {} if jpieces is None else {"pieces": jpieces}
    B, T = 8, 60
    j_init = jax.jit(functools.partial(jturbo.init, config=jc, **pkw))
    j_step = jax.jit(functools.partial(jturbo.step, config=jc, obs_fn=jturbo.observe_board, **pkw))
    js = j_init(J.batch_keys(jax.random.PRNGKey(5), B))
    ts = turbo.init(batch_keys(threefry.prng_key(5), B, device=CPU), tc, pieces=pieces, device=CPU)
    _assert_state_equal(ts, js, "init")
    rng = np.random.default_rng(10)
    ends = 0
    for i in range(T):
        acts = rng.choice(8, size=B, p=ACTION_P).astype(np.int32)
        js, jobs, jr, jd, jinfo = j_step(js, jnp.asarray(acts))
        ts, obs, r, d, info = turbo.step(ts, torch.from_numpy(acts), tc, pieces=pieces,
                                         obs_fn=turbo.observe_board)
        _assert_state_equal(ts, js, i)
        assert obs.dtype == torch.int8 and obs.shape == (B, tc.height, tc.width)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs), err_msg=f"obs @ {i}")
        np.testing.assert_array_equal(r.numpy().view(np.int32), np.asarray(jr).view(np.int32))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd), err_msg=f"done @ {i}")
        np.testing.assert_array_equal(info["lines_cleared"].numpy(), np.asarray(jinfo["lines_cleared"]))
        ends += int(d.sum())
    assert ends > 0, "no game ended, so no reset (or frozen game) was observed"


@pytest.mark.parametrize("impl, obs, step_obs, fused", [
    ("turbo", "board", True, True), ("turbo", "board", False, False),
    ("flagship", "board", True, False), ("flagship", "rgb84", True, False),
])
def test_env_fns_step_obs(impl, obs, step_obs, fused):
    """Only the turbo engine's board observation comes from the step, and
    there it equals ``observe`` of the step's state."""
    config = EngineConfig(auto_reset=True)
    init, step, observe = engines.env_fns(config, impl, obs=obs, device=CPU, step_obs=step_obs)
    s = init(batch_keys(threefry.prng_key(2), 4, device=CPU))
    s, o, *_ = step(s, torch.full((4,), 5, dtype=torch.int32))
    if fused:
        assert torch.equal(o, observe(s))
    else:
        assert o is None


def _two_call(monkeypatch, module):
    """``module``'s ``env_fns`` with the observation taken by a second call."""
    monkeypatch.setattr(module, "env_fns",
                        lambda *a, **kw: engines.env_fns(*a, **{**kw, "step_obs": False}))


def _three_calls(config):
    """PPO's rollout step that samples, steps and observes in three calls."""
    _, env_step, observe = engines.env_fns(config, device=CPU, step_obs=False)
    return ppo.composed_sample_step(env_step, observe)


def _small_ppo_state(K):
    cfg = ppo.PPOConfig(rollout_len=6, update_epochs=1, n_minibatches=1, frame_stack=K)
    net = ActorCriticCNN(in_channels=K, dtype=torch.float32)
    return cfg, ppo.init_train_state(threefry.prng_key(8), 8, EngineConfig(auto_reset=True), cfg,
                                     net=net, device=CPU)


@pytest.mark.parametrize("K", [1, 4])
def test_ppo_rollout_fused_equals_two_call_and_jax(K, monkeypatch):
    """The rollout that samples, steps and observes in one call (the
    sampling step) equals the rollout that samples, steps and observes in
    three, field for field, and its observations, rewards and dones equal
    JAX's ``env_step`` then ``observe`` on its actions."""
    config = EngineConfig(auto_reset=True)
    cfg, ts = _small_ppo_state(K)
    start = ts.env_states
    runs = {"fused": ppo.rollout(ts, cfg, ppo.sample_step_fn(config)),
            "two_call": ppo.rollout(ts, cfg, _three_calls(config))}
    (traj, states, last, key), (traj2, states2, last2, key2) = runs["fused"], runs["two_call"]
    for k in ppo.Transition._fields:
        assert torch.equal(getattr(traj, k), getattr(traj2, k)), k
    for k in turbo.FIELDS:
        assert torch.equal(getattr(states, k), getattr(states2, k)), k
    assert torch.equal(last, last2) and np.array_equal(key, key2)

    J = _jax()
    jax, jnp, jturbo = J.jax, J.jnp, J.turbo
    jc = J.EngineConfig(auto_reset=True)
    j_step = jax.jit(functools.partial(jturbo.step, config=jc))
    j_obs = jax.jit(functools.partial(jturbo.observe_board, config=jc))
    js = jturbo.TurboState(**{k: jnp.asarray(getattr(start, k).numpy()) for k in turbo.FIELDS})
    for t in range(cfg.rollout_len):
        js, _, jr, jd, _ = j_step(js, jnp.asarray(traj.action[t].numpy()))
        jraw = np.asarray(j_obs(js))
        seen = traj.obs[t + 1] if t + 1 < cfg.rollout_len else last
        np.testing.assert_array_equal(seen.numpy() if K == 1 else seen[:, -1].numpy(), jraw)
        np.testing.assert_array_equal(traj.reward[t].numpy(), np.asarray(jr))
        np.testing.assert_array_equal(traj.done[t].numpy(), np.asarray(jd))

    monkeypatch.setattr(ppo, "sample_step_fn", lambda env_config, *a, **kw: _three_calls(env_config))
    ts_a, m_a = ppo.make_train_step(config, cfg)(_small_ppo_state(K)[1])
    monkeypatch.undo()
    ts_b, m_b = ppo.make_train_step(config, cfg)(_small_ppo_state(K)[1])
    assert torch.equal(ts_a.last_obs, ts_b.last_obs)
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k


_W = np.random.default_rng(3).integers(-3, 4, size=(20 * 10, 8)).astype(np.float32)


def _torch_act(obs):
    """A deterministic policy of integer weights: exact float32 sums, so
    both frameworks take the same argmax."""
    flat = obs.reshape(obs.shape[0], -1)[:, -200:].to(torch.float32)
    return (flat @ torch.from_numpy(_W)).argmax(-1).to(torch.int32)


def _jax_act(obs):
    jnp = _jax().jnp
    flat = obs.reshape(obs.shape[0], -1)[:, -200:].astype(jnp.float32)
    return jnp.argmax(flat @ jnp.asarray(_W), -1).astype(jnp.int32)


@pytest.mark.parametrize("K", [1, 4])
def test_evaluate_fused_equals_two_call_and_jax(K, monkeypatch):
    """16 games of at most 300 steps: the same statistics and the same
    observations seen by the policy, whichever call made them, and JAX's
    statistics."""
    def run():
        seen = []

        def act(obs):
            seen.append(obs.clone())
            return _torch_act(obs)

        out = evaluate.evaluate_policy(act, 16, EngineConfig(), threefry.prng_key(4), max_steps=300,
                                       frame_stack=K, device=CPU)
        return out, seen

    fused, seen = run()
    _two_call(monkeypatch, evaluate)
    two_call, seen2 = run()
    assert fused == two_call
    assert len(seen) == len(seen2) and all(torch.equal(a, b) for a, b in zip(seen, seen2))
    J = _jax()
    want = J.jax.jit(lambda key: J.evaluate.evaluate_policy(
        _jax_act, 16, J.EngineConfig(), key, max_steps=300, frame_stack=K))(J.jax.random.PRNGKey(4))
    for k in ("episodes_completed", "lines_mean", "length_mean", "return_mean", "truncated"):
        np.testing.assert_allclose(fused[k], np.asarray(want[k]), rtol=1e-6, err_msg=k)
    assert fused["episodes_completed"] > 0


@pytest.mark.parametrize("K", [1, 4])
def test_dqn_step_fused_equals_two_call(K, monkeypatch):
    """Twelve DQN steps (learning from step 8): env states, windows, replay
    and metrics equal, whichever call made the observation."""
    cfg = dqn.DQNConfig(buffer_size=8 * 8, batch_size=8, learning_starts=8, target_update_every=4,
                        exploration_steps=20, frame_stack=K)
    config = EngineConfig(auto_reset=True)

    def run():
        ts = dqn.init_dqn_state(threefry.prng_key(6), 8, config, cfg, device=CPU)
        step = dqn.make_train_step(config, cfg)
        metrics = []
        for _ in range(12):
            ts, m = step(ts)
            metrics.append(m)
        return ts, metrics

    ts, metrics = run()
    _two_call(monkeypatch, dqn)
    ts2, metrics2 = run()
    assert torch.equal(ts.obs, ts2.obs)
    for k in turbo.FIELDS:
        assert torch.equal(getattr(ts.env_states, k), getattr(ts2.env_states, k)), k
    for k in ts.buffer.data:
        assert torch.equal(ts.buffer.data[k], ts2.buffer.data[k]), k
    for m, m2 in zip(metrics, metrics2):
        for k in m:
            assert torch.equal(m[k], m2[k]), k


@pytest.mark.parametrize("B, frame, lanes", [
    (1, 0, 8), (512, 0, 8), (kernels.ONE_LANE_FROM_B - 1, 0, 8), (kernels.ONE_LANE_FROM_B, 0, 1),
    (65536, 0, 1), (1, 200, 8), (512, 200, 8), (8192, 200, 8),
    (kernels.ONE_LANE_FROM_B_OBS - 1, 200, 8), (kernels.ONE_LANE_FROM_B_OBS, 200, 1),
    (65536, 732, 1), (65536, 3000, 8),
])
def test_step_lanes(B, frame, lanes):
    """One lane an env where the batch fills the card, a group below it, and
    a group where one lane's block could not stage its observations."""
    assert kernels.step_lanes(B, frame) == lanes
    assert lanes in kernels.STEP_LANES


def test_turbo_step_checks_obs():
    config = EngineConfig()
    s = turbo.init(batch_keys(threefry.prng_key(0), 4, device=CPU), config, device=CPU)
    a = torch.zeros(4, dtype=torch.int32)
    for bad in (torch.empty((4, 20, 10), dtype=torch.uint8), torch.empty((4, 10, 20), dtype=torch.int8),
                torch.empty((3, 20, 10), dtype=torch.int8),
                torch.empty((4, 10, 20), dtype=torch.int8).transpose(1, 2),
                torch.empty((4, 20, 10), dtype=torch.int8)):  # right, but on the CPU
        with pytest.raises(ValueError, match="obs"):
            kernels.turbo_step(s, a, config, PIECES, RewardsMapping(), obs=bad)
    with pytest.raises(ValueError, match="lanes"):
        kernels.turbo_step(s, a, config, PIECES, RewardsMapping(), lanes=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(auto_reset=True), dict(width=30, height=20, auto_reset=True),
                                dict(width=61, height=12, queue_size=3, gravity_enabled=False)],
                         ids=["10x20", "30x20", "61x12-nograv"])
def test_fused_kernel_matches_plain(cuda, kw):
    """Every lanes count, with and without the observation, at B = 1, 1001
    and 4096: the state and outputs equal ``step_plain``'s, the observation
    ``observe_board_plain`` of the returned state."""
    config = EngineConfig(**kw)
    for B in (1, 1001, 4096):
        g = torch.Generator(device=cuda)
        g.manual_seed(B)
        s = turbo.init(batch_keys(threefry.prng_key(B), B, device=cuda), config, device=cuda)
        for i in range(60):
            a = torch.multinomial(torch.tensor(ACTION_P, device=cuda), B, replacement=True,
                                  generator=g).to(torch.int32)
            want = turbo.step_plain(s, a, config)
            want_obs = turbo.observe_board_plain(want[0], config)
            for lanes in kernels.STEP_LANES:
                for with_obs in (False, True):
                    obs = torch.empty((B, config.height, config.width), dtype=torch.int8,
                                      device=cuda) if with_obs else None
                    got = kernels.turbo_step(s, a, config, PIECES, RewardsMapping(), obs=obs,
                                             lanes=lanes)
                    for k in turbo.FIELDS:
                        x, y = getattr(got[0], k), getattr(want[0], k)
                        if x.dtype in (torch.uint32, torch.float32):
                            x, y = x.view(torch.int32), y.view(torch.int32)
                        assert torch.equal(x, y), f"{k} B={B} L={lanes} obs={with_obs} @ {i}"
                    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
                    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
                    if with_obs:
                        assert torch.equal(obs, want_obs), f"obs B={B} L={lanes} @ {i}"
            s = want[0]
