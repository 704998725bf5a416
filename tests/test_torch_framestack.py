"""Frame stacking of the PyTorch port against the JAX package's, on the CPU.

Covers ``ops/framestack.py`` (``init``, ``push``), the stacked replay sample
``rl/buffers.py:sample_with_next_stacked`` and one PPO train step with a
frame stack.  Tolerances, each with its reason:

* integer results (windows, stores, sampled transitions, env states,
  actions, rewards, dones, keys): equal;
* PPO values and log-probs of the rollout: 1e-5 (float32 sums in another
  order, as ``tests/test_torch_ppo.py``);
* the PPO step's parameter changes: 1e-3 of each leaf's largest change
  (Adam divides by sqrt(v) + 1e-5, as ``tests/test_torch_ppo.py``).

The stacked sample's invariant is also held on the port alone: every sampled
window equals the window the online actor saw at that step
(``tests/test_framestack.py``).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.models.networks import ActorCriticCNN as FlaxActorCritic
from tetris_gymnasium_tpu.ops import framestack as jframestack
from tetris_gymnasium_tpu.rl import buffers as jbuffers
from tetris_gymnasium_tpu.rl import ppo as jppo

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.examples import train_ppo
from tetris_gymnasium_torch.models.convert import to_flax_params
from tetris_gymnasium_torch.models.networks import ActorCriticCNN
from tetris_gymnasium_torch.ops import framestack
from tetris_gymnasium_torch.rl import buffers, ppo


def _flat(params):
    return {
        "/".join(str(p.key) for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _close(got, want, rel, what=""):
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0, atol=rel * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# init and push
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 2, 4])
def test_init_and_push_match_jax(K):
    rng = np.random.default_rng(K)
    B = 33
    obs0 = rng.integers(-1, 2, (B, 8, 6)).astype(np.int8)
    want = jframestack.init(jnp.asarray(obs0), K)
    got = framestack.init(torch.from_numpy(obs0), K)
    assert got.shape == (B, K, 8, 6) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for t in range(6):
        obs = rng.integers(-1, 2, (B, 8, 6)).astype(np.int8)
        done = rng.random(B) < 0.15
        want = jframestack.push(want, jnp.asarray(obs), jnp.asarray(done))
        got = framestack.push(got, torch.from_numpy(obs), torch.from_numpy(done))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"push {t}")
        assert (got[torch.from_numpy(done)] == torch.from_numpy(obs)[done][:, None]).all()


def test_push_rolls_oldest_first_and_resets():
    """``tests/test_framestack.py:32-46`` on the port."""
    st = framestack.init(torch.zeros((3, 2, 2), dtype=torch.int8), 4)
    done = torch.zeros(3, dtype=torch.bool)
    for i in range(1, 4):
        st = framestack.push(st, torch.full((3, 2, 2), i, dtype=torch.int8), done)
    assert (st[:, 0] == 0).all() and (st[:, -1] == 3).all()
    st = framestack.push(st, torch.full((3, 2, 2), 9, dtype=torch.int8),
                         torch.tensor([False, True, False]))
    assert (st[1] == 9).all() and (st[0, 0] == 1).all() and (st[0, -1] == 9).all()


# ---------------------------------------------------------------------------
# The stacked replay sample
# ---------------------------------------------------------------------------


def _trajectory(T, B, seed):
    """Frames encoding ``(t, env)`` and irregular episode ends."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((T, B, 2, 3), np.int32)
    for t in range(T):
        frames[t] = (t * 100 + np.arange(B))[:, None, None]
    return frames, rng.random((T, B)) < 0.15


def _fill(T, B, capacity_blocks, K, seed):
    """The JAX and the port's buffers after the same adds, and the port's online windows."""
    frames, dones = _trajectory(T, B, seed)
    jbuf = jbuffers.create({"obs": jnp.asarray(frames[0]), "done": jnp.asarray(dones[0])},
                           capacity_blocks * B, B)
    buf = buffers.create({"obs": torch.from_numpy(frames[0]), "done": torch.from_numpy(dones[0])},
                         capacity_blocks * B, B)
    online = framestack.init(torch.from_numpy(frames[0]), K)
    windows = [online]
    for t in range(T - 1):
        jbuf = jbuffers.add(jbuf, {"obs": jnp.asarray(frames[t]), "done": jnp.asarray(dones[t])})
        buf = buffers.add(buf, {"obs": torch.from_numpy(frames[t]), "done": torch.from_numpy(dones[t])})
        online = framestack.push(online, torch.from_numpy(frames[t + 1]), torch.from_numpy(dones[t]))
        windows.append(online)
    return jbuf, buf, windows


@pytest.mark.parametrize("T, blocks, K", [(40, 40, 4), (60, 12, 4), (60, 12, 2), (30, 7, 3)],
                         ids=["no-wrap-k4", "wrap-k4", "wrap-k2", "wrap-k3"])
def test_stacked_sample_matches_jax(T, blocks, K):
    """The same stores and key give JAX's windows, successors and fields, and
    every sampled window is the one the online actor saw (with and without
    the buffer's wrap-around, ``tests/test_framestack.py:50-111``)."""
    B = 4
    jbuf, buf, windows = _fill(T, B, blocks, K, seed=T + blocks)
    assert (buf.pos, buf.size) == (int(jbuf.pos), int(jbuf.size))
    seen = set()
    for seed in (7, 8):
        key = jax.random.PRNGKey(seed)
        jcur, jnxt = jbuffers.sample_with_next_stacked(jbuf, key, 256, B, K)
        cur, nxt = buffers.sample_with_next_stacked(buf, np.asarray(key), 256, B, K)
        for k in ("obs", "done"):
            np.testing.assert_array_equal(cur[k].numpy(), np.asarray(jcur[k]), err_msg=k)
            np.testing.assert_array_equal(nxt[k].numpy(), np.asarray(jnxt[k]), err_msg=k)
        assert cur["obs"].shape == (256, K, 2, 3)
        for s in range(256):
            newest = int(cur["obs"][s, -1, 0, 0])
            t, b = newest // 100, newest % 100
            seen.add(t)
            assert torch.equal(cur["obs"][s], windows[t][b]), (s, t, b)
            assert torch.equal(nxt["obs"][s], windows[t + 1][b]), (s, t, b)
    if blocks >= T:
        assert min(seen) <= K and max(seen) >= T - 4
    else:
        assert min(seen) >= T - blocks - 1 + K - 1 and max(seen) <= T - 2


def test_stacked_sample_needs_k_plus_one_blocks():
    buf = buffers.create({"obs": torch.zeros((4, 2)), "done": torch.zeros(4, dtype=torch.bool)}, 16, 4)
    with pytest.raises(ValueError, match=r"\(k\+1\)\*batch"):
        buffers.sample_with_next_stacked(buf, np.zeros(2, np.uint32), 8, 4, 4)


# ---------------------------------------------------------------------------
# PPO with a frame stack
# ---------------------------------------------------------------------------

SMALL = dict(rollout_len=12, update_epochs=2, n_minibatches=2, frame_stack=2)
SMALL_ENV = dict(width=6, height=8, auto_reset=True)  # episodes end inside the rollout
N_ENVS = 8


@pytest.fixture(scope="module")
def jax_ppo():
    net = FlaxActorCritic(dtype=jnp.float32)
    cfg = jppo.PPOConfig(**SMALL)
    env_config = JEngineConfig(**SMALL_ENV)
    ts = jppo.init_train_state(jax.random.PRNGKey(0), N_ENVS, env_config, cfg, net, impl="turbo")
    step = jppo.make_train_step(env_config, cfg, net, impl="turbo")
    policy_step = inspect.getclosurevars(step).nonlocals["policy_step"]
    _, traj = jax.jit(
        lambda s: jax.lax.scan(policy_step, (s.env_states, s.last_obs, s.params, s.key), None,
                               length=cfg.rollout_len)
    )(ts)
    ts2, _ = jax.jit(step)(ts)
    return {"ts": ts, "ts2": ts2, "traj": {k: np.asarray(v) for k, v in traj._asdict().items()}}


def test_ppo_frame_stack_step_matches_jax(jax_ppo):
    """One PPO train step with K = 2 from the same key and weights: the
    windows, actions, rewards and dones of the rollout bit-equal to JAX's,
    and the parameter changes within 1e-3 of JAX's largest."""
    p0 = _flat(jax_ppo["ts"].params)
    cfg = ppo.PPOConfig(**SMALL)
    config = EngineConfig(**SMALL_ENV)
    net = ActorCriticCNN(in_channels=2, board_shape=(8, 6), dtype=torch.float32)
    ts = ppo.init_train_state(np.asarray(jax.random.PRNGKey(0)), N_ENVS, config, cfg, net=net,
                              device="cpu", params=p0)
    assert ts.last_obs.shape == (N_ENVS, 2, 8, 6)
    np.testing.assert_array_equal(ts.last_obs.numpy(), np.asarray(jax_ppo["ts"].last_obs))
    traj = ppo.rollout(ts, cfg, ppo.sample_step_fn(config))[0]
    want = jax_ppo["traj"]
    assert want["done"].any()  # a window restarts inside the rollout
    for k in ("obs", "action", "reward", "done"):
        np.testing.assert_array_equal(getattr(traj, k).numpy(), want[k], err_msg=k)
    for k in ("value", "log_prob"):
        np.testing.assert_allclose(getattr(traj, k).numpy(), want[k], rtol=0, atol=1e-5, err_msg=k)
    ts2, _ = ppo.make_train_step(config, cfg)(ts)
    np.testing.assert_array_equal(ts2.last_obs.numpy(), np.asarray(jax_ppo["ts2"].last_obs))
    got, p1 = to_flax_params(ts2.net.state_dict()), _flat(jax_ppo["ts2"].params)
    for k in p0:
        assert np.abs(p1[k] - p0[k]).max() > 0, k
        _close(got[k] - p0[k], p1[k] - p0[k], 1e-3, k)


def test_ppo_cli_trains_with_frame_stack():
    ts, records = train_ppo.main(["--device", "cpu", "--n-envs", "8", "--rollout-len", "4",
                                  "--iterations", "1", "--update-epochs", "1", "--n-minibatches", "2",
                                  "--frame-stack", "2"])
    assert ts.last_obs.shape == (8, 2, 20, 10) and ts.net.encoder.convs[0].weight.shape[1] == 2
    assert records[0]["env_steps"] == 32
    with pytest.raises(SystemExit):
        train_ppo.parse_args(["--frame-stack", "0"])
