"""Grouped placement DQN of the PyTorch port against the JAX package's, on the CPU.

Tolerances, each with its reason:

* integer results and random draws (randint offsets, replay contents, env
  states, observations, masks, actions, rewards, dones, the evaluation's
  episode counts): equal;
* Q values and the TD loss: 1e-5 relative (float32 sums of up to 64 terms
  taken in another order);
* parameters after several Adam updates: each leaf's change within 1e-3 of
  its largest change; Adam divides by sqrt(v) + 1e-8, so a float32
  difference of a gradient near zero is magnified up to lr / 1e-8 (the
  same reason as ``tests/test_torch_ppo.py``);
* the evaluation's means: 1e-6 relative (float32 means of the same values
  summed in another order).

The rest mirrors the JAX grouped DQN gates of ``tests/test_rl.py:188-266``
and ``tests/test_learning.py:110-141`` on the port alone, and covers the
converters, the checkpoint files and the command line.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.models.networks import QGroupedBoardsCNN as FlaxQGroupedBoardsCNN
from tetris_gymnasium_tpu.models.networks import QMLP as FlaxQMLP
from tetris_gymnasium_tpu.rl import buffers as jbuffers
from tetris_gymnasium_tpu.rl import evaluate as jevaluate
from tetris_gymnasium_tpu.rl import grouped_dqn as jgd

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.examples import train_lin_grouped
from tetris_gymnasium_torch.models.convert import from_flax_params, to_flax_params
from tetris_gymnasium_torch.models.init import init_lecun_
from tetris_gymnasium_torch.models.networks import QGroupedBoardsCNN, QMLP
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.rl import buffers, evaluate, grouped_dqn
from tetris_gymnasium_torch.utils.checkpoint import load_flat, load_q_net, save_q_net

CPU = "cpu"
SMALL_ENV = dict(width=6, height=8, gravity_enabled=False, auto_reset=True)


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


def _assert_env_equal(ts, js, where):
    for k in turbo.FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                      err_msg=f"{k} @ {where}")


# ---------------------------------------------------------------------------
# randint and the replay buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("maxval", [1, 7, 1000, 65536, 65537, 130_048, 2**31 - 1, 0, -5])
def test_randint_matches_jax(maxval):
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(key, (512,), 0, maxval))
        np.testing.assert_array_equal(threefry.randint(np.asarray(key), 512, maxval), want)
        got = threefry.randint_lanes(np.asarray(key), 512, maxval, CPU)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def _blocks(t, batch):
    return {"obs": np.stack([np.full((3,), 100 * t + e, np.int32) for e in range(batch)]),
            "t": np.full((batch,), t, np.int32),
            "r": (np.arange(batch) * 0.5 + t).astype(np.float32)}


def test_buffers_match_jax_across_wraparound():
    """Seven blocks into a four-block buffer: stores, write position and size
    after every add, and both samples, equal to JAX's; the successor of a
    sampled entry is the same env one step later (``tests/test_rl.py:206``)."""
    batch, capacity = 4, 16
    example = {k: jnp.asarray(v) for k, v in _blocks(0, batch).items()}
    jbuf = jbuffers.create(example, capacity, batch)
    buf = buffers.create({k: torch.from_numpy(v) for k, v in _blocks(0, batch).items()}, capacity,
                         batch)
    for t in range(7):
        block = _blocks(t, batch)
        jbuf = jbuffers.add(jbuf, {k: jnp.asarray(v) for k, v in block.items()})
        buf = buffers.add(buf, {k: torch.from_numpy(v) for k, v in block.items()})
        assert (buf.pos, buf.size) == (int(jbuf.pos), int(jbuf.size))
        for k in block:
            np.testing.assert_array_equal(buf.data[k].numpy(), np.asarray(jbuf.data[k]))
    key = jax.random.PRNGKey(0)
    jcur, jnxt = jbuffers.sample_with_next(jbuf, key, 64, batch)
    cur, nxt = buffers.sample_with_next(buf, np.asarray(key), 64, batch)
    for k in cur:
        np.testing.assert_array_equal(cur[k].numpy(), np.asarray(jcur[k]))
        np.testing.assert_array_equal(nxt[k].numpy(), np.asarray(jnxt[k]))
    ts = cur["t"].numpy()
    assert set(ts) <= {3, 4, 5}  # resident blocks are t = 3..6; the newest is never drawn
    np.testing.assert_array_equal(nxt["t"].numpy(), ts + 1)
    np.testing.assert_array_equal(nxt["obs"][:, 0].numpy(), cur["obs"][:, 0].numpy() + 100)
    jplain = jbuffers.sample(jbuf, key, 40)
    plain = buffers.sample(buf, np.asarray(key), 40)
    for k in plain:
        np.testing.assert_array_equal(plain[k].numpy(), np.asarray(jplain[k]))


def test_buffer_capacity_must_divide_and_hold_two_blocks():
    with pytest.raises(ValueError, match="multiple"):
        buffers.create({"x": torch.zeros(3)}, 10, 3)
    one_block = buffers.create({"x": torch.zeros(4)}, 4, 4)
    with pytest.raises(ValueError, match="capacity >= 2"):
        buffers.sample_with_next(one_block, threefry.prng_key(0), 8, 4)


# ---------------------------------------------------------------------------
# Masked epsilon-greedy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exploration_steps", [10, 333, 1500])
def test_epsilon_matches_jitted_jax(exploration_steps):
    """Bit for bit the schedule of the jitted JAX train step (reciprocal
    multiply and fused multiply-add, as XLA compiles ``_epsilon``)."""
    cfg = grouped_dqn.GroupedDQNConfig(exploration_steps=exploration_steps)
    jeps = jax.jit(functools.partial(jgd._epsilon, jgd.GroupedDQNConfig(exploration_steps=exploration_steps)))
    steps = np.arange(exploration_steps + 3, dtype=np.int32)
    want = np.asarray(jax.vmap(jeps)(jnp.asarray(steps)))
    got = np.array([grouped_dqn.epsilon_at(cfg, int(s)) for s in steps])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B, A", [(64, 40), (33, 24)])
def test_act_plain_matches_jax(B, A):
    """Greedy, Gumbel-max exploration and the uniform draw of ``train_step
    :165-174`` on the same keys, with rows whose every candidate is illegal."""
    rng = np.random.default_rng(B)
    q = rng.standard_normal((B, A)).astype(np.float32)
    mask = (rng.random((B, A)) < 0.6).astype(np.float32)
    mask[:3] = 0.0  # all illegal: every argmax falls to candidate 0
    q[5, :] = 1.5  # ties: the lowest legal index wins
    key = jax.random.PRNGKey(B)
    _, eps_key, act_key, _ = jax.random.split(key, 4)
    for eps in (0.0, 0.37, 1.0):
        jq = jnp.where(jnp.asarray(mask) > 0, jnp.asarray(q), jgd.NEG_INF)
        greedy = jnp.argmax(jq, axis=-1)
        random_a = jgd._masked_random(act_key, jnp.asarray(mask))
        explore = jax.random.uniform(eps_key, (B,)) < jnp.float32(eps)
        want = np.asarray(jnp.where(explore, random_a, greedy))
        got = grouped_dqn.act(torch.from_numpy(q), torch.from_numpy(mask), np.asarray(act_key),
                              np.asarray(eps_key), np.float32(eps))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:3] == 0).all()
    greedy_only = grouped_dqn.act_plain(torch.from_numpy(q), torch.from_numpy(mask).T.contiguous().T,
                                        fill=float("-inf"))
    np.testing.assert_array_equal(
        greedy_only.numpy(), np.argmax(np.where(mask > 0, q, -np.inf), axis=-1))


# ---------------------------------------------------------------------------
# Init, train steps and evaluation against JAX
# ---------------------------------------------------------------------------

TRAIN_CFG = dict(buffer_size=64, batch_size=16, learning_starts=3, target_update_every=4,
                 exploration_steps=10)
N_ENVS = 8
N_STEPS = 9


@pytest.fixture(scope="module")
def jax_run():
    """The JAX grouped DQN at 6x8 for ``N_STEPS`` steps, its state after each."""
    env_config = JEngineConfig(**SMALL_ENV)
    cfg = jgd.GroupedDQNConfig(**TRAIN_CFG)
    ts = jgd.init_grouped_dqn_state(jax.random.PRNGKey(0), N_ENVS, env_config, cfg, FlaxQMLP())
    step = jax.jit(jgd.make_train_step(env_config, cfg, FlaxQMLP()))
    states, metrics = [ts], []
    for _ in range(N_STEPS):
        ts, m = step(ts)
        states.append(ts)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"states": states, "metrics": metrics}


def _port_state(jax_run, **kw):
    return grouped_dqn.init_grouped_dqn_state(
        np.asarray(jax.random.PRNGKey(0)), N_ENVS, EngineConfig(**SMALL_ENV),
        grouped_dqn.GroupedDQNConfig(**TRAIN_CFG), device=CPU,
        params=_flat(jax_run["states"][0].params), **kw)


def test_init_state_matches_jax(jax_run):
    js = jax_run["states"][0]
    ts = _port_state(jax_run)
    np.testing.assert_array_equal(ts.key, np.asarray(js.key))
    _assert_env_equal(ts.env_states.env, js.env_states.env, "init")
    np.testing.assert_array_equal(ts.env_states.mask.numpy(), np.asarray(js.env_states.mask))
    np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(js.obs))
    for k, v in ts.buffer.data.items():
        assert v.dtype == {"obs": torch.float32, "mask": torch.float32, "action": torch.int32,
                           "reward": torch.float32, "done": torch.bool}[k]
        assert tuple(v.shape) == np.asarray(js.buffer.data[k]).shape
    q = ts.net(ts.obs)
    want = FlaxQMLP().apply(js.params, js.obs)
    _close(q.detach().numpy(), want, 1e-5, "Q of the first observation")


def test_train_steps_match_jax(jax_run):
    """Nine steps: learning from step 3, target syncs at steps 4 and 8.  The
    replay contents (actions, rewards, dones, observations and masks) and the
    env states equal JAX's after every step."""
    ts = _port_state(jax_run)
    train_step = grouped_dqn.make_train_step(EngineConfig(**SMALL_ENV),
                                             grouped_dqn.GroupedDQNConfig(**TRAIN_CFG))
    for i in range(N_STEPS):
        ts, m = train_step(ts)
        js, jm = jax_run["states"][i + 1], jax_run["metrics"][i]
        where = f"step {i}"
        for k, v in ts.buffer.data.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(js.buffer.data[k]), err_msg=f"{k} {where}")
        assert (ts.buffer.pos, ts.buffer.size) == (int(js.buffer.pos), int(js.buffer.size))
        _assert_env_equal(ts.env_states.env, js.env_states.env, where)
        np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(js.obs), err_msg=where)
        np.testing.assert_array_equal(ts.key, np.asarray(js.key))
        for k in ("mean_reward", "episodes_done", "lines_cleared", "epsilon"):
            assert float(m[k]) == jm[k], (k, where)
        _close(float(m["loss"]), jm["loss"], 1e-5, f"loss {where}")
        assert (jm["loss"] > 0) == (i >= 3)
    assert ts.step == N_STEPS
    start = _flat(jax_run["states"][0].params)
    want, want_target = _flat(jax_run["states"][-1].params), _flat(jax_run["states"][-1].target_params)
    got, got_target = to_flax_params(ts.net.state_dict(), "qmlp"), \
        to_flax_params(ts.target_net.state_dict(), "qmlp")
    for k, p0 in start.items():
        _close(got[k] - p0, want[k] - p0, 1e-3, k)
        _close(got_target[k] - p0, want_target[k] - p0, 1e-3, f"target {k}")
        assert np.abs(want[k] - p0).max() > 0


def test_boards_mode_step_runs():
    """Boards mode with :class:`QGroupedBoardsCNN` (``tests/test_rl.py:243``):
    two steps run, the loss is finite and the shapes hold; the port's fp32 Q
    equals Flax's on the first observation."""
    env_config = EngineConfig(**SMALL_ENV)
    cfg = grouped_dqn.GroupedDQNConfig(buffer_size=64, batch_size=8, learning_starts=0,
                                       exploration_steps=10)
    net = QGroupedBoardsCNN(board_shape=(8, 6), dtype=torch.float32)
    ts = grouped_dqn.init_grouped_dqn_state(np.asarray(jax.random.PRNGKey(0)), 8, env_config, cfg,
                                            net, mode="boards", device=CPU)
    assert ts.obs.shape == (8, 24, 8, 6)
    step = grouped_dqn.make_train_step(env_config, cfg, mode="boards")
    ts, m = step(ts)
    ts, m = step(ts)
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
    assert ts.obs.shape == (8, 24, 8, 6)
    flax = FlaxQGroupedBoardsCNN(dtype=jnp.float32)
    params = flax.init(jax.random.PRNGKey(1), jnp.zeros((1, 24, 8, 6)))
    net.load_state_dict(from_flax_params(_flat(params), "grouped_cnn"))
    want = flax.apply(params, jnp.asarray(ts.obs.numpy()))
    _close(net(ts.obs).detach().numpy(), want, 1e-5, "boards Q")


@pytest.fixture(scope="module")
def eval_pair(jax_run):
    params = jax_run["states"][-1].params
    jc = JEngineConfig(**SMALL_ENV)
    want = jax.jit(lambda p, k: jevaluate.evaluate_grouped(
        jevaluate.greedy_masked_q(FlaxQMLP(), p), 32, jc, k, max_steps=64))(
        params, jax.random.PRNGKey(4))
    net = QMLP(n_features=9)
    net.load_state_dict(from_flax_params(_flat(params), "qmlp"))
    got = evaluate.evaluate_grouped(evaluate.greedy_masked_q(net), 32, EngineConfig(**SMALL_ENV),
                                    threefry.prng_key(4), max_steps=64, device=CPU)
    return {k: float(v) for k, v in want.items()}, got


def test_evaluate_grouped_matches_jax(eval_pair):
    want, got = eval_pair
    for k in ("episodes_completed", "truncated", "max_steps"):
        assert got[k] == want[k], k
    assert got["episodes_completed"] > 0
    for k in ("return_mean", "return_min", "return_max", "length_mean", "lines_mean"):
        _close(got[k], want[k], 1e-6, k)


# ---------------------------------------------------------------------------
# Networks, initialisers, converters, checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["qmlp", "grouped_cnn"])
def test_flax_round_trip_and_forward(kind, tmp_path):
    if kind == "qmlp":
        flax, x = FlaxQMLP(), jnp.asarray(np.random.default_rng(0).integers(0, 9, (2, 40, 13)),
                                          jnp.float32)
        net = QMLP()
    else:
        flax = FlaxQGroupedBoardsCNN(dtype=jnp.float32)
        x = jnp.asarray(np.random.default_rng(0).integers(0, 2, (2, 3, 20, 10)), jnp.float32)
        net = QGroupedBoardsCNN(dtype=torch.float32)
    params = flax.init(jax.random.PRNGKey(2), x)
    flat = _flat(params)
    net.load_state_dict(from_flax_params(flat, kind))
    back = to_flax_params(net.state_dict(), kind)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    _close(net(torch.from_numpy(np.array(x))).detach().numpy(), flax.apply(params, x), 1e-5, kind)
    path = str(tmp_path / "q.npz")
    save_q_net(path, net, kind)
    loaded = load_q_net(path, kind, device=CPU, dtype=torch.float32)
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    with pytest.raises(KeyError, match="missing"):
        from_flax_params({k: v for k, v in flat.items() if "bias" not in k}, kind)


def test_exported_init_equals_fresh_export(tmp_path):
    """``results/grouped_qmlp_init_seed1.npz`` holds the JAX run's initial
    weights (``examples/train_lin_grouped.py --seed 1``), which the card's
    full-width run starts from."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "export_grouped_init_params", os.path.join(repo, "tools", "export_grouped_init_params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.export(1, str(tmp_path / "init.npz"))
    committed = load_flat(os.path.join(repo, "results", "grouped_qmlp_init_seed1.npz"))
    assert sorted(fresh) == sorted(committed) and len(fresh) == 6
    for k in fresh:
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
    net = load_q_net(os.path.join(repo, "results", "grouped_qmlp_init_seed1.npz"), "qmlp", device=CPU)
    assert net.hidden[0].weight.shape == (64, 13)


def test_init_statistics_match_flax():
    """lecun_normal weights (std 1/sqrt(fan_in), truncated at 2 std) and zero biases."""
    flax = _flat(FlaxQMLP().init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 13))))
    net = init_lecun_(QMLP(), torch.Generator().manual_seed(0))
    port = to_flax_params(net.state_dict(), "qmlp")
    assert sorted(port) == sorted(flax)
    for k, want in flax.items():
        if k.endswith("/bias"):
            assert not port[k].any() and not want.any(), k
            continue
        fan_in = want.shape[0]
        assert abs(port[k].std() * np.sqrt(fan_in) - 1) < 0.25, k
        assert np.abs(port[k]).max() <= 2 * np.sqrt(1 / fan_in) / 0.87962566103423978 + 1e-6


def test_init_state_is_seeded():
    cfg = grouped_dqn.GroupedDQNConfig(buffer_size=16)
    a, b, c = (grouped_dqn.init_grouped_dqn_state(threefry.prng_key(s), 4, EngineConfig(**SMALL_ENV),
                                                  cfg, device=CPU) for s in (0, 0, 1))
    for k, v in a.net.state_dict().items():
        assert torch.equal(v, b.net.state_dict()[k]) and torch.equal(v, a.target_net.state_dict()[k])
    assert any(not torch.equal(v, c.net.state_dict()[k]) for k, v in a.net.state_dict().items())


# ---------------------------------------------------------------------------
# Command line and the learning gate
# ---------------------------------------------------------------------------


def test_cli_trains_on_cpu_and_saves(tmp_path, capsys):
    params, log = str(tmp_path / "q.npz"), str(tmp_path / "log.jsonl")
    ts, records = train_lin_grouped.main([
        "--device", "cpu", "--n-envs", "8", "--steps", "6", "--chunk", "3",
        "--learning-starts", "2", "--eval-every", "6", "--eval-episodes", "4",
        "--save-params", params, "--log-json", log,
    ])
    assert ts.step == 6 and [r["step"] for r in records] == [3, 6]
    assert {"step", "env_steps", "sps", "lines_per_step", "mean_reward", "loss", "epsilon",
            "eval_return", "eval_length", "eval_lines", "eval_episodes"} <= set(records[-1])
    assert records[-1]["env_steps"] == 48 and records[-1]["loss"] > 0
    _, again = train_lin_grouped.main(["--device", "cpu", "--n-envs", "8", "--steps", "3",
                                       "--chunk", "3", "--init-params", params])
    assert "warm-started params" in capsys.readouterr().out and len(again) == 1
    assert sorted(load_flat(params)) == sorted(to_flax_params(ts.net.state_dict(), "qmlp"))
    with pytest.raises(NotImplementedError, match="item 12"):
        train_lin_grouped.parse_args(["--wandb"])
    assert train_lin_grouped.parse_args([]).device == "cuda"


def test_grouped_dqn_learns_micro():
    """The port's own learning gate at the 6x8 configuration and thresholds of
    ``tests/test_learning.py:110-141``: lines per 50-step chunk over the last 3
    chunks above 3x the first 3 (epsilon falling from 1), from the key and
    the initial weights of the JAX gate (``PRNGKey(0)``)."""
    env_config = EngineConfig(**SMALL_ENV)
    cfg = grouped_dqn.GroupedDQNConfig(buffer_size=4096, batch_size=128, exploration_steps=250,
                                       learning_starts=64, target_update_every=64)
    jax_params = jgd.init_grouped_dqn_state(jax.random.PRNGKey(0), 64, JEngineConfig(**SMALL_ENV),
                                            jgd.GroupedDQNConfig(**cfg._asdict()), FlaxQMLP()).params
    ts = grouped_dqn.init_grouped_dqn_state(threefry.prng_key(0), 64, env_config, cfg, device=CPU,
                                            params=_flat(jax_params))
    train_step = grouped_dqn.make_train_step(env_config, cfg)
    totals = []
    for _ in range(10):
        lines = 0
        for _ in range(50):
            ts, m = train_step(ts)
            lines += int(m["lines_cleared"])
        totals.append(lines)
    random_rate, learned_rate = sum(totals[:3]) / 3, sum(totals[-3:]) / 3
    assert learned_rate > 3 * max(random_rate, 1.0), (random_rate, learned_rate, totals)
