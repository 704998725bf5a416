"""PPO's rollout step with the action sampled in the step's call, and GAE at
ragged shapes, on the CPU.

``ppo.turbo_sample_step`` (``ppo.sample_step_fn``'s step on the turbo
engine with board observations) is one ``turbo_step`` launch on the card
that samples the action from the policy's logits, steps and writes the
board observation; on CPU tensors it runs ``ppo.sample_actions_plain``,
``turbo.step_plain`` and ``turbo.observe_board_plain`` in turn.  Held here:

* against ``sample_actions_plain`` followed by ``turbo.step(...,
  obs_fn=observe_board)``, every output bit-equal, and its action and state
  against JAX's ``jax.random.categorical`` and ``turbo.step`` from
  numpy-seeded logits and keys, at 10x20, 30x20 and 61x12;
* the PPO rollout through it against the rollout that samples and steps in
  two calls, and against JAX's env step on its actions, at K = 1 and 4;
* ``sample_step_fn``'s step on every engine route (each sampling in its
  step's call) against ``sample_actions_plain``, the route's step and its
  observation;
* ``gae_plain`` against JAX's ``_gae`` at the ragged shapes the ``gae``
  kernel's builds must take (T in {1, 7, 33}, B in {1, 17, 1001});
* the wrappers' argument checks and ``gae``'s choice of build.

The ``cuda``-marked tests hold the sampling builds of ``turbo_step`` (1 and
8 lanes) and both builds of ``gae`` to their plain versions; they skip
without a card.  JAX is imported inside the tests that compare with it, so
that ``python -m pytest --noconftest tests/test_torch_ppo_fused.py -m cuda``
collects this file on a machine with a card and no JAX.
"""
import functools
import types

import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.models.networks import ActorCriticCNN
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES
from tetris_gymnasium_torch.rl import engines, ppo

CPU = "cpu"
GEOMETRIES = {
    "10x20": dict(auto_reset=True),
    "30x20": dict(width=30, height=20, auto_reset=True),
    "61x12": dict(width=61, height=12, queue_size=3, auto_reset=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
    from tetris_gymnasium_tpu.core import turbo as jturbo
    from tetris_gymnasium_tpu.parallel.mesh import batch_keys as jbatch_keys
    from tetris_gymnasium_tpu.rl import ppo as jppo

    return types.SimpleNamespace(jax=jax, jnp=jnp, EngineConfig=JEngineConfig, turbo=jturbo,
                                 batch_keys=jbatch_keys, ppo=jppo)


def _assert_state_equal(ts, js, where):
    for k in turbo.FIELDS:
        got, want = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        assert got.dtype == want.dtype and got.shape == want.shape, f"{k} @ {where}"
        if k == "score":
            got, want = got.view(np.int32), want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=f"{k} @ {where}")


def _logits(rng, B, scale):
    """``f32[B, 8]``: normal logits times ``scale``, or small integers
    (exact ties) for ``scale`` None."""
    if scale is None:
        return rng.integers(0, 3, size=(B, 8)).astype(np.float32)
    return (rng.standard_normal((B, 8)) * scale).astype(np.float32)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_sample_step_plain_equals_two_calls_and_jax(name):
    """40 steps x 8 envs under logits of four kinds: ``turbo_sample_step`` equals
    ``sample_actions_plain`` then ``step(..., obs_fn=observe_board)`` bit
    for bit (log-prob too), and its action and state equal JAX's
    ``categorical`` then ``turbo.step`` on the same key and logits."""
    J = _jax()
    jax, jnp, jturbo = J.jax, J.jnp, J.turbo
    config, jc = EngineConfig(**GEOMETRIES[name]), J.EngineConfig(**GEOMETRIES[name])
    B, T = 8, 40
    j_step = jax.jit(functools.partial(jturbo.step, config=jc))
    j_sample = jax.jit(lambda key, x: jax.random.categorical(key, x).astype(jnp.int32))
    js = jturbo.init(J.batch_keys(jax.random.PRNGKey(3), B), jc)
    ts = turbo.init(batch_keys(threefry.prng_key(3), B, device=CPU), config, device=CPU)
    _assert_state_equal(ts, js, "init")
    rng = np.random.default_rng(4)
    ends = 0
    for i in range(T):
        x = torch.from_numpy(_logits(rng, B, (0.1, 3.0, 30.0, None)[i % 4]))
        key = rng.integers(0, 2**32, size=2, dtype=np.uint32)
        s1, obs, r, d, info, a, lp = ppo.turbo_sample_step(ts, x, key, config)
        a2, lp2 = ppo.sample_actions_plain(x, key)
        s2, obs2, r2, d2, info2 = turbo.step(ts, a2, config, obs_fn=turbo.observe_board)
        assert a.dtype == torch.int32 and lp.dtype == torch.float32
        assert torch.equal(a, a2) and torch.equal(lp.view(torch.int32), lp2.view(torch.int32))
        for k in turbo.FIELDS:
            assert torch.equal(getattr(s1, k), getattr(s2, k)), f"{k} @ {i}"
        assert torch.equal(obs, obs2) and torch.equal(r, r2) and torch.equal(d, d2)
        assert torch.equal(info["lines_cleared"], info2["lines_cleared"])

        ja = j_sample(jnp.asarray(key), jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja), err_msg=f"action @ {i}")
        js, _, jr, jd, _ = j_step(js, ja)
        _assert_state_equal(s1, js, i)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jturbo.observe_board(js, jc)))
        np.testing.assert_array_equal(r.numpy().view(np.int32), np.asarray(jr).view(np.int32))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        ends += int(d.sum())
        ts = s1
    assert ends > 0, "no game ended, so no reset was sampled into"


def _small_ppo_state(K):
    cfg = ppo.PPOConfig(rollout_len=6, update_epochs=1, n_minibatches=1, frame_stack=K)
    net = ActorCriticCNN(in_channels=K, dtype=torch.float32)
    return cfg, ppo.init_train_state(threefry.prng_key(9), 8, EngineConfig(auto_reset=True), cfg,
                                     net=net, device=CPU)


@pytest.mark.parametrize("K", [1, 4])
def test_rollout_sampling_step_equals_two_calls_and_jax(K):
    """The rollout through the sampling step equals the rollout that calls
    ``sample_actions`` and then the step, field for field (the window and
    the key chain too), and its actions equal JAX's ``categorical`` on its
    logits, its rewards, dones and observations JAX's step and observation."""
    config = EngineConfig(auto_reset=True)
    cfg, ts = _small_ppo_state(K)
    _, env_step, observe = engines.env_fns(config, device=CPU, step_obs=True)
    one = ppo.rollout(ts, cfg, ppo.sample_step_fn(config))
    two = ppo.rollout(ts, cfg, ppo.composed_sample_step(env_step, observe))
    (traj, states, last, key), (traj2, states2, last2, key2) = one, two
    for k in ppo.Transition._fields:
        assert torch.equal(getattr(traj, k), getattr(traj2, k)), k
    for k in turbo.FIELDS:
        assert torch.equal(getattr(states, k), getattr(states2, k)), k
    assert torch.equal(last, last2) and np.array_equal(key, key2)

    J = _jax()
    jax, jnp, jturbo = J.jax, J.jnp, J.turbo
    jc = J.EngineConfig(auto_reset=True)
    j_step = jax.jit(functools.partial(jturbo.step, config=jc))
    js = jturbo.TurboState(**{k: jnp.asarray(getattr(ts.env_states, k).numpy())
                              for k in turbo.FIELDS})
    carried = ts.key
    for t in range(cfg.rollout_len):
        carried, act_key = threefry.split(carried)
        with torch.no_grad():
            logits, _ = ts.net(traj.obs[t])
        ja = jax.random.categorical(jnp.asarray(act_key), jnp.asarray(logits.numpy()))
        np.testing.assert_array_equal(traj.action[t].numpy(), np.asarray(ja).astype(np.int32))
        js, _, jr, jd, _ = j_step(js, ja.astype(jnp.int32))
        seen = traj.obs[t + 1] if t + 1 < cfg.rollout_len else last
        jraw = np.asarray(jturbo.observe_board(js, jc))
        np.testing.assert_array_equal(seen.numpy() if K == 1 else seen[:, -1].numpy(), jraw)
        np.testing.assert_array_equal(traj.reward[t].numpy(), np.asarray(jr))
        np.testing.assert_array_equal(traj.done[t].numpy(), np.asarray(jd))


@pytest.mark.parametrize("rewards", [None, RewardsMapping(alife=0.5, clear_line=3, game_over=-2)],
                         ids=["default", "override"])
@pytest.mark.parametrize("impl, obs, fused", [
    ("turbo", "board", True), ("flagship", "board", True), ("flagship", "rgb84", True),
])
def test_sample_step_fn_routes(impl, obs, fused, rewards):
    """Every route samples in its step's call (``turbo_sample_step`` on the
    turbo engine, ``flagship_sample_step`` on the flagship engine's board
    and 84x84 routes); on every route 12 steps of ``sample_step_fn``'s step
    equal ``sample_actions_plain``, the route's step with the same rewards
    and its observation, bit for bit."""
    config = EngineConfig(auto_reset=True)
    sample_step = ppo.sample_step_fn(config, impl, rewards, obs=obs)
    fused_step = ppo.turbo_sample_step if impl == "turbo" else ppo.flagship_sample_step
    assert (getattr(sample_step, "func", None) is fused_step) == fused
    init, env_step, observe = engines.env_fns(config, impl, rewards, obs=obs, device=CPU)
    s = s2 = init(batch_keys(threefry.prng_key(5), 6, device=CPU))
    rng = np.random.default_rng(6)
    for i in range(12):
        x = torch.from_numpy(_logits(rng, 6, 3.0))
        key = rng.integers(0, 2**32, size=2, dtype=np.uint32)
        s, o, r, d, _, a, lp = sample_step(s, x, key)
        a2, lp2 = ppo.sample_actions_plain(x, key)
        s2, _, r2, d2, _ = env_step(s2, a2)
        assert torch.equal(a, a2) and torch.equal(lp, lp2), i
        assert torch.equal(o, observe(s2)) and torch.equal(r, r2) and torch.equal(d, d2), i


@pytest.mark.parametrize("T, B", [(1, 1), (1, 17), (7, 1001), (33, 1), (33, 17), (33, 1001)])
def test_gae_plain_matches_jax_at_ragged_shapes(T, B):
    """``gae_plain`` against JAX's ``_gae`` (``ppo.py:147``) within 1e-6
    relative and 1e-5 absolute: XLA on the CPU may contract a multiply and
    an add into one rounding where the port rounds each (the card's kernel
    is held to ``gae_plain`` bit for bit), and over 33 steps with gamma *
    lambda ~ 0.95 the sums reach ~10, whose ulp is ~1e-6."""
    J = _jax()
    rng = np.random.default_rng(T * 1000 + B)
    reward = rng.standard_normal((T, B)).astype(np.float32)
    value = (rng.standard_normal((T, B)) * 3).astype(np.float32)
    done = rng.random((T, B)) < 0.1
    last_value = (rng.standard_normal(B) * 3).astype(np.float32)
    jtraj = J.ppo.Transition(None, None, None, J.jnp.asarray(value), J.jnp.asarray(reward),
                             J.jnp.asarray(done))
    want_adv, want_tgt = J.ppo._gae(J.ppo.PPOConfig(), jtraj, J.jnp.asarray(last_value))
    adv, tgt = ppo.gae_plain(torch.from_numpy(reward), torch.from_numpy(value),
                             torch.from_numpy(done), torch.from_numpy(last_value), 0.999, 0.95)
    assert adv.shape == (T, B) and adv.dtype == torch.float32
    np.testing.assert_allclose(adv.numpy(), np.asarray(want_adv), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(want_tgt), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# The wrappers' checks
# ---------------------------------------------------------------------------


def _cpu_state(B=4):
    config = EngineConfig()
    return config, turbo.init(batch_keys(threefry.prng_key(0), B, device=CPU), config, device=CPU)


def test_turbo_step_sample_needs_obs():
    config, s = _cpu_state()
    with pytest.raises(ValueError, match="only together with obs"):
        kernels.turbo_step(s, None, config, PIECES, RewardsMapping(), logits=torch.zeros((4, 8)),
                           act_key=threefry.prng_key(0))


@pytest.mark.parametrize("bad", [
    torch.zeros((4, 8), dtype=torch.float64), torch.zeros((4, 7)), torch.zeros((3, 8)),
    torch.zeros((8, 4)).T, torch.zeros((4, 8)),  # right, but on the CPU
], ids=["float64", "width7", "batch3", "strided", "cpu"])
def test_turbo_step_checks_logits(bad):
    config, s = _cpu_state()
    obs = torch.empty((4, 20, 10), dtype=torch.int8)
    with pytest.raises(ValueError, match="logits"):
        kernels.turbo_step(s, None, config, PIECES, RewardsMapping(), obs=obs, logits=bad,
                           act_key=threefry.prng_key(0))


def test_turbo_step_checks_key():
    config, s = _cpu_state()
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="act_key without logits"):
        kernels.turbo_step(s, a, config, PIECES, RewardsMapping(), act_key=threefry.prng_key(0))
    with pytest.raises(ValueError, match="logits need act_key"):
        kernels.turbo_step(s, None, config, PIECES, RewardsMapping(),
                           obs=torch.empty((4, 20, 10), dtype=torch.int8),
                           logits=torch.zeros((4, 8)))


def test_gae_checks():
    T, B = 4, 16
    args = (torch.zeros((T, B)), torch.zeros((T, B)), torch.zeros((T, B), dtype=torch.bool),
            torch.zeros(B), 0.99, 0.95)
    with pytest.raises(ValueError, match="build"):
        kernels.gae(*args, build="scan")
    with pytest.raises(ValueError, match="CUDA"):  # CPU tensors are the plain version's
        kernels.gae(*args)


def test_gae_build_from_shape_and_alignment():
    """TMA tensor copies where every row lies on 16 bytes, cp.async elsewhere."""
    def arrays(T, B, offset=0):
        f = torch.zeros(T * B + 8)[offset:offset + T * B].view(T, B)
        d = torch.zeros(T * B + 32, dtype=torch.bool)[offset:offset + T * B].view(T, B)
        return f, d

    for B, want in ((16, "tma"), (8192, "tma"), (65536, "tma"), (1, "cp_async"),
                    (1001, "cp_async"), (8, "cp_async"), (24, "cp_async")):
        f, d = arrays(3, B)
        assert kernels.gae_build(B, f, f, d, f, f) == want, B
    f, d = arrays(3, 16, offset=1)  # a view 4 bytes into its storage
    assert kernels.gae_build(16, f, f, d, f, f) == "cp_async"
    assert set(kernels.GAE_BUILDS) == {"tma", "cp_async"}


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_sample_kernel_matches_plain(cuda, name):
    """Each sampling build (1 and 8 lanes) at B = 1, 1001 and 4096, 20 steps
    under four kinds of logits: action, state, observation, reward, done
    and lines bit-equal to ``sample_actions_plain`` + ``step_plain`` +
    ``observe_board_plain``, the log-prob within 2 ulps and 2**-22 of the
    plain one (``logf``/``expf`` bounds) and bit-equal to ``ppo_sample``."""
    from tetris_gymnasium_torch.rl.ppo import sample_actions_plain

    config = EngineConfig(**GEOMETRIES[name])
    rng = np.random.default_rng(7)
    for B in (1, 1001, 4096):
        s = kernels.turbo_init(batch_keys(threefry.prng_key(B), B, device=cuda), config, PIECES)
        for i in range(20):
            x = torch.from_numpy(_logits(rng, B, (0.1, 3.0, 30.0, None)[i % 4])).to(cuda)
            key = rng.integers(0, 2**32, size=2, dtype=np.uint32)
            pa, plp = sample_actions_plain(x, key)
            ps, pr, pd, pl = turbo.step_plain(s, pa, config)
            pobs = turbo.observe_board_plain(ps, config)
            ka, klp = kernels.sample_actions(x, key)
            for lanes in kernels.STEP_LANES:
                obs = torch.empty((B, config.height, config.width), dtype=torch.int8, device=cuda)
                ks, kr, kd, kl, a, lp = kernels.turbo_step(
                    s, None, config, PIECES, RewardsMapping(), obs=obs, lanes=lanes, logits=x,
                    act_key=key)
                assert torch.equal(a, pa) and torch.equal(a, ka), (B, i, lanes)
                assert torch.equal(lp.view(torch.int32), klp.view(torch.int32)), (B, i, lanes)
                ulp = torch.from_numpy(np.spacing(plp.abs().cpu().numpy())).to(cuda).double()
                assert ((lp.double() - plp.double()).abs() <= 2.0**-22 + 2 * ulp).all()
                for k in turbo.FIELDS:
                    assert torch.equal(getattr(ks, k), getattr(ps, k)), (k, B, i, lanes)
                assert torch.equal(obs, pobs) and torch.equal(kr, pr) and torch.equal(kd, pd)
                assert torch.equal(kl, pl)
            s = ps


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 7, 128, 129])
def test_gae_kernel_matches_plain(cuda, T):
    """Both builds (the tma one where B % 16 == 0) bit-equal to ``gae_plain``."""
    g = torch.Generator(device=cuda)
    g.manual_seed(T)
    for B in (1, 16, 1001, 8192):
        for p_done in (0.0, 1 / 200, 1.0):
            reward = torch.randn((T, B), generator=g, device=cuda)
            value = torch.randn((T, B), generator=g, device=cuda) * 10
            done = torch.rand((T, B), generator=g, device=cuda) < p_done
            last = torch.randn((B,), generator=g, device=cuda) * 10
            want = ppo.gae_plain(reward, value, done, last, 0.999, 0.95)
            builds = kernels.GAE_BUILDS if B % 16 == 0 else ("cp_async",)
            for build in builds:
                got = kernels.gae(reward, value, done, last, 0.999, 0.95, build=build)
                for a, b in zip(got, want):
                    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (T, B, build)
