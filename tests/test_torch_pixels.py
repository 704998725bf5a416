"""The pixel chain and the pixel CNN DQN of the PyTorch port against the JAX package's, on the CPU.

Tolerances, each with its reason:

* every integer and uint8 result (coefficient tables, the RGB composite,
  the resize, the gray frames, replay contents, env states, windows,
  rewards, dones, keys, actions, the evaluation's episode counts): equal;
* ``AtariQNetwork``'s Q values in float32: 1e-5 of the output's scale
  (float32 sums of up to 3136 terms taken in another order);
* parameters after five Adam updates: each leaf's change within 1e-4 of
  JAX's change of that leaf in the L2 norm, ``|d_port - d_jax| <= 1e-4 *
  |d_jax|``.  Float32 gradients are summed in another order, and Adam's
  division by sqrt(v) + 1e-8 magnifies that where a gradient is near zero:
  a few dozen of the dense layer's 1.6M weights then differ by up to a
  learning rate, so no bound on the largest single difference would be
  tight;
* the TD loss: 1e-4 relative (the networks differ as above once they have
  learned); ``mean_q``: 1e-6 absolute (a mean of small values that nearly
  cancel);
* the evaluation's means: 1e-6 relative (float32 means of the same values
  summed in another order).
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
from tetris_gymnasium_tpu.core import engine as jengine
from tetris_gymnasium_tpu.models.networks import AtariQNetwork as FlaxAtariQNetwork
from tetris_gymnasium_tpu.ops import image as jimage
from tetris_gymnasium_tpu.ops import observations as jobs
from tetris_gymnasium_tpu.parallel.mesh import batch_keys as jbatch_keys
from tetris_gymnasium_tpu.pieces import PIECES as JPIECES
from tetris_gymnasium_tpu.rl import dqn as jdqn
from tetris_gymnasium_tpu.rl import evaluate as jevaluate

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import engine
from tetris_gymnasium_torch.examples import train_cnn
from tetris_gymnasium_torch.models.convert import from_flax_params, to_flax_params
from tetris_gymnasium_torch.models.networks import AtariQNetwork
from tetris_gymnasium_torch.ops import image, observations, threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES
from tetris_gymnasium_torch.rl import dqn, evaluate
from tetris_gymnasium_torch.utils.checkpoint import load_flat, load_q_net, save_q_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
EXPORTED = os.path.join(REPO, "results", "atari_q_k4_init_seed1.npz")
N_ENVS, N_STEPS, K = 4, 10, 4
TRAIN_CFG = dict(buffer_size=64, batch_size=8, learning_starts=5, target_update_every=4,
                 exploration_steps=10, frame_stack=K)


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
# Resize, grayscale, composite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_src, n_dst", [(24, 84), (34, 84), (20, 84), (7, 13), (84, 84), (10, 90)])
def test_zoom_coefficients_match_jax(n_src, n_dst):
    R = image._area_zoom_matrix(n_src, n_dst)
    np.testing.assert_array_equal(R, jimage._area_zoom_matrix(n_src, n_dst))
    src, coef = image.area_zoom_taps(n_src, n_dst)
    back = np.zeros_like(R)
    for d in range(n_dst):
        for t in range(2):
            back[d, src[d, t]] += coef[d, t]
    np.testing.assert_array_equal(back, R)


@pytest.mark.parametrize("shape, out", [
    ((3, 24, 34, 3), (84, 84)),
    ((2, 20, 10), (84, 84)),
    ((2, 7, 13, 4), (30, 20)),
    ((1, 84, 84, 1), (84, 84)),
    ((2, 30, 50), (84, 90)),
])
def test_resize_area_zoom_matches_jax(shape, out):
    img = np.random.default_rng(len(shape) + shape[1]).integers(0, 256, shape, dtype=np.uint8)
    got = image.resize_area_zoom(torch.from_numpy(img), *out)
    want = jimage.resize_area_zoom(jnp.asarray(img), *out)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("channel", [0, 1, 2])
def test_grayscale_matches_jax_on_a_full_channel(channel):
    """Each of the 256 values of one channel, beside random values of the other two."""
    rng = np.random.default_rng(channel)
    rgb = rng.integers(0, 256, (4, 256, 3), dtype=np.uint8)
    rgb[..., channel] = np.arange(256, dtype=np.uint8)
    assert image._W22 == jimage._W22
    np.testing.assert_array_equal(image.grayscale_u8(torch.from_numpy(rgb)).numpy(),
                                  np.asarray(jimage.grayscale_u8(jnp.asarray(rgb))))


def test_preprocess_rgb84_matches_jax():
    rgb = np.random.default_rng(84).integers(0, 256, (4, 24, 34, 3), dtype=np.uint8)
    got = image.preprocess_rgb84(torch.from_numpy(rgb))
    assert got.shape == (4, 84, 84) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jimage.preprocess_rgb84(jnp.asarray(rgb))))


@pytest.mark.parametrize("holder_size", [1, 2])
def test_compose_rgb_matches_jax(holder_size):
    """Random id images, ids past the palette (black) included."""
    rng = np.random.default_rng(holder_size)
    B = 6
    board = rng.integers(0, 12, (B, 24, 18), dtype=np.uint8)
    queue = rng.integers(0, 10, (B, 4, 16), dtype=np.uint8)
    holder = rng.integers(0, 10, (B, 4, 4 * holder_size), dtype=np.uint8)
    got = observations.compose_rgb(torch.from_numpy(board), torch.from_numpy(queue),
                                   torch.from_numpy(holder), PIECES)
    want = jax.vmap(lambda b, q, h: jobs.compose_rgb(b, q, h, JPIECES))(
        jnp.asarray(board), jnp.asarray(queue), jnp.asarray(holder))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert observations.sidebar_width(4, 4, holder_size) == jobs.sidebar_width(4, 4, holder_size)


def test_render_rgb84_matches_jax():
    """The whole chain from the engine state, along a short trajectory."""
    jc, cfg = JEngineConfig(auto_reset=True), EngineConfig(auto_reset=True)
    js = jax.jit(jax.vmap(functools.partial(jengine.init_state, config=jc)))(
        jbatch_keys(jax.random.PRNGKey(12), 8))
    chain = jax.jit(lambda s: jimage.preprocess_rgb84(
        jax.vmap(functools.partial(jengine.render_rgb, config=jc))(s)))
    step = jax.jit(jax.vmap(functools.partial(jengine.step, config=jc, obs_fn=lambda s, c, p: ())))
    ts = engine.init(batch_keys(threefry.prng_key(12), 8, device=CPU), cfg, device=CPU)
    rng = np.random.default_rng(12)
    for i in range(12):
        frame = engine.render_rgb84(ts, cfg)
        assert frame.shape == (8, 84, 84) and frame.dtype == torch.uint8
        np.testing.assert_array_equal(frame.numpy(), np.asarray(chain(js)), err_msg=f"@ {i}")
        a = rng.integers(0, 8, 8).astype(np.int32)
        js = step(js, jnp.asarray(a))[0]
        ts = engine.step(ts, torch.from_numpy(a), cfg)[0]


# ---------------------------------------------------------------------------
# AtariQNetwork, the converter, the exported initial weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_atari_q_network_matches_flax(k, tmp_path):
    flax = FlaxAtariQNetwork(dtype=jnp.float32)
    shape = (5, 84, 84) if k == 1 else (5, k, 84, 84)
    x = np.random.default_rng(k).integers(0, 256, shape, dtype=np.uint8)
    params = flax.init(jax.random.PRNGKey(k), jnp.asarray(x[:1]))
    flat = _flat(params)
    net = AtariQNetwork(in_channels=k, dtype=torch.float32)
    net.load_state_dict(from_flax_params(flat, "atari_q"))
    back = to_flax_params(net.state_dict(), "atari_q")
    assert sorted(back) == sorted(flat) and len(flat) == 10
    for key, v in flat.items():
        np.testing.assert_array_equal(back[key], v, err_msg=key)
    with torch.no_grad():
        q = net(torch.from_numpy(x))
    assert q.shape == (5, 8) and q.dtype == torch.float32
    _close(q.numpy(), flax.apply(params, jnp.asarray(x)), 1e-5, f"K={k}")
    path = str(tmp_path / "q.npz")
    save_q_net(path, net, "atari_q")
    loaded = load_q_net(path, "atari_q", device=CPU, dtype=torch.float32)
    assert loaded.convs[0].weight.shape == (32, k, 8, 8)
    for key, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], v), key
    bf16 = AtariQNetwork(in_channels=k)  # the default bf16 trunk with a float32 head
    bf16.load_state_dict(net.state_dict())
    with torch.no_grad():
        assert bf16(torch.from_numpy(x)).dtype == torch.float32


def test_exported_init_equals_flax_init():
    """``results/atari_q_k4_init_seed1.npz`` holds the initial weights of
    ``examples/train_cnn.py --obs rgb84 --frame-stack 4 --seed 1``: Flax's
    draw from the network key of ``PRNGKey(1)`` for a ``[1, 4, 84, 84]``
    input (the exporter's ``init_dqn_state`` depends on nothing else)."""
    spec = importlib.util.spec_from_file_location(
        "export_grouped_init_params", os.path.join(REPO, "tools", "export_grouped_init_params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.default_out("atari_q", 1, 4) == EXPORTED
    _, net_key, _ = jax.random.split(jax.random.PRNGKey(1), 3)
    fresh = _flat(FlaxAtariQNetwork().init(net_key, jnp.zeros((1, 4, 84, 84), jnp.uint8)))
    committed = load_flat(EXPORTED)
    assert sorted(fresh) == sorted(committed) and len(fresh) == 10
    for key in fresh:
        np.testing.assert_array_equal(fresh[key], committed[key], err_msg=key)
    assert load_q_net(EXPORTED, "atari_q", device=CPU).head.weight.shape == (8, 512)


# ---------------------------------------------------------------------------
# The pixel DQN against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run():
    """The JAX pixel DQN (flagship engine, rgb84, K = 4, fp32 Atari net) for
    ``N_STEPS`` steps: its state after each and its metrics."""
    env_config = JEngineConfig(auto_reset=True)
    cfg = jdqn.DQNConfig(**TRAIN_CFG)
    net = FlaxAtariQNetwork(dtype=jnp.float32)
    ts = jax.jit(functools.partial(jdqn.init_dqn_state, n_envs=N_ENVS, env_config=env_config,
                                   cfg=cfg, net=net, impl="flagship", obs="rgb84"))(
        jax.random.PRNGKey(0))
    step = jax.jit(jdqn.make_train_step(env_config, cfg, net, impl="flagship", obs="rgb84"))
    states, metrics = [ts], []
    for _ in range(N_STEPS):
        ts, m = step(ts)
        states.append(ts)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"states": states, "metrics": metrics}


def _port_state(jax_run):
    return dqn.init_dqn_state(
        np.asarray(jax.random.PRNGKey(0)), N_ENVS, EngineConfig(auto_reset=True),
        dqn.DQNConfig(**TRAIN_CFG), net=AtariQNetwork(in_channels=K, dtype=torch.float32),
        impl="flagship", obs="rgb84", device=CPU, params=_flat(jax_run["states"][0].params))


def _assert_env_equal(ts, js, where):
    for k in engine.FIELDS:
        got = getattr(ts.env_states, k).numpy()
        np.testing.assert_array_equal(got.T if k == "key" else got,
                                      np.asarray(getattr(js.env_states, k)), err_msg=f"{k} {where}")


def test_pixel_init_state_matches_jax(jax_run):
    js, ts = jax_run["states"][0], _port_state(jax_run)
    np.testing.assert_array_equal(ts.key, np.asarray(js.key))
    _assert_env_equal(ts, js, "init")
    assert ts.obs.shape == (N_ENVS, K, 84, 84) and ts.obs.dtype == torch.uint8
    np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(js.obs))
    assert ts.buffer.data["obs"].shape == (64, 84, 84)
    assert ts.buffer.data["obs"].dtype == torch.uint8


def test_pixel_train_steps_match_jax(jax_run):
    """Ten steps: learning from step 5, a target sync at step 8.  The replay
    contents, the env states, the window and the key equal JAX's after every
    step; the losses and the parameter changes agree."""
    ts = _port_state(jax_run)
    step = dqn.make_train_step(EngineConfig(auto_reset=True), dqn.DQNConfig(**TRAIN_CFG),
                               impl="flagship", obs="rgb84")
    for i in range(N_STEPS):
        ts, m = step(ts)
        js, jm = jax_run["states"][i + 1], jax_run["metrics"][i]
        where = f"step {i}"
        for k, v in ts.buffer.data.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(js.buffer.data[k]),
                                          err_msg=f"{k} {where}")
        _assert_env_equal(ts, js, where)
        np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(js.obs), err_msg=where)
        np.testing.assert_array_equal(ts.key, np.asarray(js.key))
        for k in ("mean_reward", "episodes_done", "epsilon"):
            assert float(m[k]) == jm[k], (k, where)
        _close(float(m["loss"]), jm["loss"], 1e-4, f"loss {where}")
        assert abs(float(m["mean_q"]) - jm["mean_q"]) <= 1e-6, where
        assert (jm["loss"] > 0) == (i >= 5)
    start = _flat(jax_run["states"][0].params)
    want = _flat(jax_run["states"][-1].params)
    want_target = _flat(jax_run["states"][-1].target_params)
    got, got_target = (to_flax_params(n.state_dict(), "atari_q") for n in (ts.net, ts.target_net))
    for k, p0 in start.items():
        for mine, theirs, what in ((got, want, k), (got_target, want_target, f"target {k}")):
            d_jax = theirs[k] - p0
            assert np.abs(d_jax).max() > 0, what
            assert np.linalg.norm(mine[k] - p0 - d_jax) <= 1e-4 * np.linalg.norm(d_jax), what


def test_pixel_evaluate_q_checkpoint_matches_jax(jax_run):
    """16 greedy episodes of the trained net on the 84x84 frames, 4-frame
    windows, give JAX's statistics."""
    params = jax_run["states"][-1].params
    want = jevaluate.evaluate_q_checkpoint(FlaxAtariQNetwork(dtype=jnp.float32), params, 16,
                                           JEngineConfig(), seed=3, max_steps=48,
                                           impl="flagship", frame_stack=K, obs="rgb84")
    net = AtariQNetwork(in_channels=K, dtype=torch.float32)
    net.load_state_dict(from_flax_params(_flat(params), "atari_q"))
    got = evaluate.evaluate_q_checkpoint(net, 16, EngineConfig(), seed=3, max_steps=48,
                                         impl="flagship", frame_stack=K, obs="rgb84", device=CPU)
    for k in ("episodes_completed", "truncated", "max_steps"):
        assert got[k] == want[k], k
    for k in ("return_mean", "return_min", "return_max", "length_mean", "lines_mean"):
        _close(got[k], want[k], 1e-6, k)


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def test_cli_rgb84_trains_on_cpu(tmp_path, capsys):
    """``train_cnn --obs rgb84 --frame-stack 4`` switches to the flagship
    engine, trains the Atari net and writes the JAX script's records; the
    evaluation command line reads what it saved."""
    params, log = str(tmp_path / "q.npz"), str(tmp_path / "log.jsonl")
    ts, records = train_cnn.main([
        "--device", "cpu", "--obs", "rgb84", "--frame-stack", "4", "--n-envs", "4",
        "--steps", "20", "--chunk", "10", "--learning-starts", "4", "--save-params", params,
        "--log-json", log,
    ])
    assert "switching --impl to flagship" in capsys.readouterr().out
    assert isinstance(ts.net, AtariQNetwork) and ts.obs.shape == (4, 4, 84, 84)
    assert isinstance(ts.env_states, engine.EngineState)
    keys = {"step", "env_steps", "sps", "reward_per_step", "steps_per_episode", "loss", "epsilon"}
    assert [r["step"] for r in records] == [10, 20] and set(records[0]) == keys
    assert records[-1]["loss"] > 0
    with open(log) as f:
        assert [eval(line)["env_steps"] for line in f] == [40, 80]
    stats = evaluate.main(["--net", "q", "--obs", "rgb84", "--frame-stack", "4", "--checkpoint",
                           params, "--device", "cpu", "--episodes", "4", "--max-steps", "24",
                           "--dtype", "float32"])
    assert stats["max_steps"] == 24 and stats["episodes_completed"] + stats["truncated"] == 4
