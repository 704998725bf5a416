"""The CNN DQN of the PyTorch port against the JAX package's, on the CPU.

Tolerances, each with its reason:

* integer results and random draws (randint and uniform draws, actions,
  replay contents, env states, windows, rewards, dones, keys, the
  evaluation's episode counts): equal;
* Q values and the TD loss: 1e-5 relative (float32 sums of up to 1152
  terms taken in another order);
* ``mean_q``: 1e-6 absolute (a mean of values of magnitude ~0.1 that
  nearly cancel, so its relative error is not bounded);
* parameters after six or seven Adam updates: each leaf's change within
  1e-3 of JAX's largest change of that leaf, as ``tests/test_torch_ppo.py``
  holds a whole train step (the worst seen is 2.9e-4 of it, on 17 of
  131,072 weights); Adam divides by sqrt(v) + 1e-8, so a float32 difference
  of a gradient near zero is magnified up to lr / 1e-8;
* the evaluation's means: 1e-6 relative (float32 means of the same values
  summed in another order).

The rest mirrors the JAX DQN gates of ``tests/test_rl.py:135-160`` on the
port alone, and covers the converter, the checkpoint files, the exported
initial weights and the command line.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.models.networks import QNetworkCNN as FlaxQNetworkCNN
from tetris_gymnasium_tpu.rl import dqn as jdqn
from tetris_gymnasium_tpu.rl import evaluate as jevaluate

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.examples import train_cnn
from tetris_gymnasium_torch.models.convert import from_flax_params, to_flax_params
from tetris_gymnasium_torch.models.networks import QNetworkCNN
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.rl import dqn, evaluate
from tetris_gymnasium_torch.utils.checkpoint import load_flat, load_q_net, save_q_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SMALL_ENV = dict(width=6, height=8, auto_reset=True)
TRAIN_CFG = dict(buffer_size=64, batch_size=16, learning_starts=3, target_update_every=4,
                 exploration_steps=10)
N_ENVS = 8
N_STEPS = 10


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
# Configuration, schedule, epsilon-greedy
# ---------------------------------------------------------------------------


def test_config_defaults_equal_jax():
    assert dqn.DQNConfig()._asdict() == jdqn.DQNConfig()._asdict()


@pytest.mark.parametrize("exploration_steps", [10, 6000, 100_000])
def test_epsilon_matches_jitted_jax(exploration_steps):
    """Bit for bit the schedule of the jitted JAX step (``_epsilon :59-62``,
    compiled as a reciprocal multiply and a fused multiply-add), end 0.01."""
    cfg = dqn.DQNConfig(exploration_steps=exploration_steps)
    jeps = jax.jit(functools.partial(jdqn._epsilon, jdqn.DQNConfig(exploration_steps=exploration_steps)))
    steps = np.unique(np.linspace(0, exploration_steps + 3, 4000).astype(np.int32))
    want = np.asarray(jax.vmap(jeps)(jnp.asarray(steps)))
    got = np.array([dqn.epsilon_at(cfg, int(s)) for s in steps])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", [64, 33])
def test_act_plain_matches_jax(B):
    """Greedy argmax (ties to the lowest index), ``randint(act_key, (B,), 0,
    8)`` and the uniform draw of ``train_step :143-147`` on the same keys."""
    rng = np.random.default_rng(B)
    q = rng.standard_normal((B, 8)).astype(np.float32)
    q[:4, 2:6] = 3.0
    _, eps_key, act_key, _ = jax.random.split(jax.random.PRNGKey(B), 4)
    for eps in (0.0, 0.37, 1.0):
        greedy = jnp.argmax(jnp.asarray(q), axis=-1)
        random_a = jax.random.randint(act_key, (B,), 0, 8)
        explore = jax.random.uniform(eps_key, (B,)) < jnp.float32(eps)
        want = np.asarray(jnp.where(explore, random_a, greedy))
        got = dqn.act(torch.from_numpy(q), np.asarray(act_key), np.asarray(eps_key), np.float32(eps))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dqn.act_plain(torch.from_numpy(q)).numpy(), np.argmax(q, axis=-1))
    assert (dqn.act_plain(torch.from_numpy(q))[:4] == 2).all()


# ---------------------------------------------------------------------------
# QNetworkCNN, the converter, checkpoints, exported initial weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 4])
def test_qnetwork_cnn_matches_flax(K, tmp_path):
    flax = FlaxQNetworkCNN(dtype=jnp.float32)
    shape = (5, 20, 10) if K == 1 else (5, K, 20, 10)
    x = np.random.default_rng(K).integers(-1, 2, shape).astype(np.int8)
    params = flax.init(jax.random.PRNGKey(K), jnp.asarray(x[:1]))
    flat = _flat(params)
    net = QNetworkCNN(in_channels=K, dtype=torch.float32)
    net.load_state_dict(from_flax_params(flat, "q_cnn"))
    back = to_flax_params(net.state_dict(), "q_cnn")
    assert sorted(back) == sorted(flat) and len(flat) == 10
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    q = net(torch.from_numpy(x))
    assert q.shape == (5, 8) and q.dtype == torch.float32
    _close(q.detach().numpy(), flax.apply(params, jnp.asarray(x)), 1e-5, f"K={K}")
    path = str(tmp_path / "q.npz")
    save_q_net(path, net, "q_cnn")
    loaded = load_q_net(path, "q_cnn", device=CPU, dtype=torch.float32)
    assert loaded.encoder.convs[0].weight.shape[1] == K
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    bf16 = QNetworkCNN(in_channels=K)  # the default bf16 trunk with a float32 head
    bf16.load_state_dict(net.state_dict())
    assert bf16(torch.from_numpy(x)).dtype == torch.float32


@pytest.mark.parametrize("K, name", [(1, "qcnn_init_seed1.npz"), (4, "qcnn_k4_init_seed1.npz")])
def test_exported_init_equals_fresh_export(K, name, tmp_path):
    """``results/qcnn*_init_seed1.npz`` hold the JAX runs' initial weights
    (``examples/train_cnn.py --seed 1 [--frame-stack 4]``), which the card's
    full-width runs start from."""
    spec = importlib.util.spec_from_file_location(
        "export_grouped_init_params", os.path.join(REPO, "tools", "export_grouped_init_params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    committed_path = os.path.join(REPO, "results", name)
    assert mod.default_out("q_cnn", 1, K) == committed_path
    fresh = mod.export(1, str(tmp_path / "init.npz"), "q_cnn", K)
    committed = load_flat(committed_path)
    assert sorted(fresh) == sorted(committed) and len(fresh) == 10
    for k in fresh:
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
    net = load_q_net(committed_path, "q_cnn", device=CPU)
    assert net.encoder.convs[0].weight.shape == (32, K, 3, 3) and net.head.weight.shape == (8, 512)


# ---------------------------------------------------------------------------
# Train steps and evaluation against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[1, 4], ids=["k1", "k4"])
def jax_run(request):
    """The JAX DQN (turbo engine, 6x8, fp32 net) for ``N_STEPS`` steps, its
    state after each and its metrics."""
    K = request.param
    env_config = JEngineConfig(**SMALL_ENV)
    cfg = jdqn.DQNConfig(frame_stack=K, **TRAIN_CFG)
    net = FlaxQNetworkCNN(dtype=jnp.float32)
    ts = jdqn.init_dqn_state(jax.random.PRNGKey(0), N_ENVS, env_config, cfg, net, impl="turbo")
    step = jax.jit(jdqn.make_train_step(env_config, cfg, net, impl="turbo"))
    states, metrics = [ts], []
    for _ in range(N_STEPS):
        ts, m = step(ts)
        states.append(ts)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"K": K, "states": states, "metrics": metrics}


def _port_state(jax_run):
    K = jax_run["K"]
    return dqn.init_dqn_state(
        np.asarray(jax.random.PRNGKey(0)), N_ENVS, EngineConfig(**SMALL_ENV),
        dqn.DQNConfig(frame_stack=K, **TRAIN_CFG),
        net=QNetworkCNN(in_channels=K, board_shape=(8, 6), dtype=torch.float32), device=CPU,
        params=_flat(jax_run["states"][0].params))


def test_init_state_matches_jax(jax_run):
    js, ts = jax_run["states"][0], _port_state(jax_run)
    np.testing.assert_array_equal(ts.key, np.asarray(js.key))
    for k in turbo.FIELDS:
        np.testing.assert_array_equal(getattr(ts.env_states, k).numpy(),
                                      np.asarray(getattr(js.env_states, k)), err_msg=k)
    np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(js.obs))
    for k, v in ts.buffer.data.items():
        assert v.dtype == {"obs": torch.int8, "action": torch.int32, "reward": torch.float32,
                           "done": torch.bool}[k]
        assert tuple(v.shape) == np.asarray(js.buffer.data[k]).shape, k


def test_train_steps_match_jax(jax_run):
    """Ten steps: learning from step max(3, K), target syncs at steps 4 and 8,
    the buffer wrapping at step 8.  The replay contents (stored frames,
    actions, rewards, dones), the env states, the window and the key equal
    JAX's after every step; the losses and the parameter changes agree."""
    K = jax_run["K"]
    ts = _port_state(jax_run)
    train_step = dqn.make_train_step(EngineConfig(**SMALL_ENV), dqn.DQNConfig(frame_stack=K, **TRAIN_CFG))
    for i in range(N_STEPS):
        ts, m = train_step(ts)
        js, jm = jax_run["states"][i + 1], jax_run["metrics"][i]
        where = f"step {i}"
        for k, v in ts.buffer.data.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(js.buffer.data[k]), err_msg=f"{k} {where}")
        assert (ts.buffer.pos, ts.buffer.size) == (int(js.buffer.pos), int(js.buffer.size))
        for k in turbo.FIELDS:
            np.testing.assert_array_equal(getattr(ts.env_states, k).numpy(),
                                          np.asarray(getattr(js.env_states, k)), err_msg=f"{k} {where}")
        np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(js.obs), err_msg=where)
        np.testing.assert_array_equal(ts.key, np.asarray(js.key))
        assert sorted(m) == sorted(jm)
        for k in ("mean_reward", "episodes_done", "epsilon"):
            assert float(m[k]) == jm[k], (k, where)
        _close(float(m["loss"]), jm["loss"], 1e-5, f"loss {where}")
        assert abs(float(m["mean_q"]) - jm["mean_q"]) <= 1e-6, where
        assert (jm["loss"] > 0) == (i >= max(3, K))
    assert ts.step == N_STEPS and ts.buffer.pos == 16 and ts.buffer.size == 64
    assert any(jm["episodes_done"] > 0 for jm in jax_run["metrics"])
    start = _flat(jax_run["states"][0].params)
    want, want_target = _flat(jax_run["states"][-1].params), _flat(jax_run["states"][-1].target_params)
    got, got_target = (to_flax_params(n.state_dict(), "q_cnn") for n in (ts.net, ts.target_net))
    for k, p0 in start.items():
        assert np.abs(want[k] - p0).max() > 0, k
        _close(got[k] - p0, want[k] - p0, 1e-3, k)
        _close(got_target[k] - p0, want_target[k] - p0, 1e-3, f"target {k}")


def test_evaluate_q_checkpoint_matches_jax(jax_run):
    """16 greedy episodes of the trained net, frame-stacked for K = 4, give
    JAX's statistics."""
    K = jax_run["K"]
    params = jax_run["states"][-1].params
    want = jevaluate.evaluate_q_checkpoint(FlaxQNetworkCNN(dtype=jnp.float32), params, 16,
                                           JEngineConfig(**SMALL_ENV), seed=3, max_steps=96,
                                           frame_stack=K)
    net = QNetworkCNN(in_channels=K, board_shape=(8, 6), dtype=torch.float32)
    net.load_state_dict(from_flax_params(_flat(params), "q_cnn"))
    got = evaluate.evaluate_q_checkpoint(net, 16, EngineConfig(**SMALL_ENV), seed=3, max_steps=96,
                                         frame_stack=K, device=CPU)
    for k in ("episodes_completed", "truncated", "max_steps"):
        assert got[k] == want[k], k
    assert got["episodes_completed"] > 0
    for k in ("return_mean", "return_min", "return_max", "length_mean", "lines_mean"):
        _close(got[k], want[k], 1e-6, k)


@pytest.mark.parametrize("K", [1, 4])
def test_learn_flag(K):
    """``tests/test_rl.py:135-160`` on the port: parameters stay put before
    the learn gate (``step >= learning_starts and step >= frame_stack``) and
    move at it, with a finite loss."""
    env_config = EngineConfig(**SMALL_ENV)
    cfg = dqn.DQNConfig(buffer_size=8 * (K + 2), batch_size=8, learning_starts=1,
                        target_update_every=2, frame_stack=K)
    ts = dqn.init_dqn_state(prng_key(0), 8, env_config, cfg, device=CPU)
    step = dqn.make_train_step(env_config, cfg)
    first = max(1, K)
    for i in range(first + 1):
        before = {k: v.clone() for k, v in ts.net.state_dict().items()}
        ts, m = step(ts)
        moved = any(not torch.equal(before[k], v) for k, v in ts.net.state_dict().items())
        assert moved == (i == first), i
        assert (float(m["loss"]) > 0) == (i == first) and np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# Command lines
# ---------------------------------------------------------------------------


def test_cli_trains_on_cpu_and_saves(tmp_path, capsys):
    params, log = str(tmp_path / "q.npz"), str(tmp_path / "log.jsonl")
    ts, records = train_cnn.main([
        "--device", "cpu", "--n-envs", "8", "--steps", "20", "--chunk", "10",
        "--learning-starts", "4", "--frame-stack", "4", "--eval-every", "20",
        "--eval-episodes", "4", "--save-params", params, "--log-json", log,
    ])
    assert ts.step == 20 and ts.obs.shape == (8, 4, 20, 10) and [r["step"] for r in records] == [10, 20]
    keys = {"step", "env_steps", "sps", "reward_per_step", "steps_per_episode", "loss", "epsilon"}
    assert set(records[0]) == keys
    assert set(records[-1]) == keys | {"eval_return", "eval_length", "eval_lines", "eval_episodes"}
    with open(log) as f:
        assert [eval(line)["env_steps"] for line in f] == [80, 160]
    assert records[-1]["loss"] > 0 and ts.net.encoder.dtype == torch.bfloat16
    _, again = train_cnn.main(["--device", "cpu", "--n-envs", "8", "--steps", "2", "--chunk", "2",
                               "--frame-stack", "4", "--init-params", params])
    out = capsys.readouterr().out
    assert "warm-started params" in out and "saved params" in out and len(again) == 1
    stats = evaluate.main(["--net", "q", "--frame-stack", "4", "--checkpoint", params, "--device",
                           "cpu", "--episodes", "4", "--max-steps", "40", "--dtype", "float32"])
    assert stats["max_steps"] == 40 and stats["episodes_completed"] + stats["truncated"] == 4


@pytest.mark.parametrize("argv, item", [
    (["--obs", "rgb84"], "item 10"),
    (["--impl", "flagship"], "item 9"),
    (["--wandb"], "item 12"),
    (["--video-every", "5"], "item 12"),
])
def test_cli_unported_options_raise(argv, item):
    """``--wandb`` and ``--video-every`` raise, naming their ROADMAP.md item;
    ``--obs rgb84`` (item 10) and ``--impl flagship`` (item 9) are ported
    and parse, the pixel frames selecting the flagship engine as in JAX."""
    if item in ("item 9", "item 10"):
        assert train_cnn.parse_args(argv).impl == "flagship"
        return
    with pytest.raises(NotImplementedError, match=item):
        train_cnn.parse_args(argv)


def test_cli_defaults_match_jax_and_the_card():
    args = train_cnn.parse_args([])
    assert (args.n_envs, args.steps, args.chunk, args.seed, args.exploration_steps,
            args.learning_starts, args.frame_stack, args.eval_episodes) == \
        (1024, 20_000, 100, 1, 6_000, 500, 1, 256)
    assert args.device == "cuda" and args.impl == "turbo" and args.obs == "board"
    with pytest.raises(SystemExit):
        train_cnn.parse_args(["--frame-stack", "0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cnn.setup(args)
