"""PPO on the reference's pixel chain in the PyTorch port against the JAX package's, on the CPU.

The chain is the flagship engine's RGB frame -> 84x84 INTER_AREA -> gray
-> FrameStack(4), read by ``AtariActorCritic``.  One module-scoped JAX run
(8 envs, ``PPOConfig(rollout_len=4, update_epochs=1, n_minibatches=2,
frame_stack=4)``, fp32 network) is the oracle for the whole train step.
Tolerances, each with its reason:

* integer and uint8 results (windows, actions, rewards, dones, keys, env
  states, the evaluation's statistics): equal;
* ``AtariActorCritic``'s logits and value in float32: 1e-5 of the output's
  scale (float32 sums of up to 3136 terms taken in another order); with a
  bf16 trunk on both sides: 2**-8 of the output's scale, one bf16 step:
  both round every layer's output to bf16 and differ only where float32
  sums in another order round to neighbouring bf16 values (9.7e-4 of the
  scale on these inputs, each side 0.6-1.1% from a float64 evaluation);
* the rollout's values and log-probs: 1e-5 of their scale, as the network;
* parameters after a train step (two Adam updates): each leaf's change
  within 1e-4 of JAX's change of that leaf in the L2 norm, ``|d_port -
  d_jax| <= 1e-4 * |d_jax|``, the bound ``tests/test_torch_pixels.py`` holds
  the pixel DQN to: Adam's division by sqrt(v) + 1e-5 magnifies float32
  differences of a gradient near zero, so no bound on the largest single
  difference would be tight;
* the loss terms: 1e-4 of their magnitude (the networks differ as above
  after the first update).
"""
import functools
import importlib.util
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.models.networks import ActorCriticCNN as FlaxActorCritic
from tetris_gymnasium_tpu.models.networks import AtariActorCritic as FlaxAtariActorCritic
from tetris_gymnasium_tpu.rl import evaluate as jevaluate
from tetris_gymnasium_tpu.rl import ppo as jppo

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import engine
from tetris_gymnasium_torch.examples import train_ppo
from tetris_gymnasium_torch.models.convert import from_flax_params, to_flax_params
from tetris_gymnasium_torch.models.init import init_actor_critic_
from tetris_gymnasium_torch.models.networks import ActorCriticCNN, AtariActorCritic
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.rl import evaluate, ppo
from tetris_gymnasium_torch.utils.checkpoint import (
    flat_actor_critic_kind, load_actor_critic, load_flat, save_actor_critic,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
ATARI_INIT = os.path.join(REPO, "results", "atari_actor_critic_k4_init_seed1.npz")
BOARD_INIT = os.path.join(REPO, "results", "ppo_init_seed1.npz")
N_ENVS, K = 8, 4
SMALL = dict(rollout_len=4, update_epochs=1, n_minibatches=2, frame_stack=K)
KIND = "atari_actor_critic"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(params):
    return {
        "/".join(str(p.key) for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _tree(flat):
    """Flat ``{a/b/c: array}`` -> the nested dict Flax applies."""
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def _close(got, want, rel, what=""):
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# AtariActorCritic, its initialiser, the converter and the checkpoint files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, K])
def test_atari_actor_critic_matches_flax(k, dtype):
    """Logits and value from the same converted weights: the committed JAX
    initial weights (for K = 1 the first frame's slice of ``Conv_0``)."""
    flat = load_flat(ATARI_INIT)
    flat["params/Conv_0/kernel"] = np.ascontiguousarray(flat["params/Conv_0/kernel"][:, :, :k])
    x = _frames(k, (6, 84, 84) if k == 1 else (6, k, 84, 84))
    want_logits, want_value = jax.jit(FlaxAtariActorCritic(dtype=getattr(jnp, dtype)).apply)(
        _tree(flat), jnp.asarray(x))
    net = AtariActorCritic(in_channels=k, dtype=getattr(torch, dtype))
    net.load_state_dict(from_flax_params(flat, KIND))
    with torch.no_grad():
        logits, value = net(torch.from_numpy(x))
    assert logits.shape == (6, 8) and value.shape == (6,)
    assert logits.dtype == value.dtype == torch.float32
    rel = 1e-5 if dtype == "float32" else 2.0**-8
    _close(logits.numpy(), want_logits, rel, "logits")
    _close(value.numpy(), want_value, rel, "value")


def test_init_statistics_match_flax():
    """Per-layer std within 10% of Flax's init, zero biases, orthogonal heads,
    JAX's parameter count."""
    flax = _flat(jax.jit(FlaxAtariActorCritic().init)(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, K, 84, 84), jnp.uint8)))
    net = init_actor_critic_(AtariActorCritic(in_channels=K), torch.Generator().manual_seed(0))
    port = to_flax_params(net.state_dict(), KIND)
    assert sorted(port) == sorted(flax)
    assert sum(v.size for v in port.values()) == sum(v.size for v in flax.values()) == 1_688_745
    for k, want in flax.items():
        assert port[k].shape == want.shape, k
        if k.endswith("/bias"):
            assert not port[k].any() and not want.any(), k
            continue
        assert abs(port[k].std() / want.std() - 1) < 0.1, k
        if k.startswith(("params/Conv_", "params/Dense_0")):  # lecun_normal, truncated at 2 std
            fan_in = int(np.prod(want.shape[:-1]))
            assert abs(port[k].std() * np.sqrt(fan_in) - 1) < 0.1, k
            assert np.abs(port[k]).max() <= 2 * np.sqrt(1 / fan_in) / 0.87962566103423978 + 1e-6
    for k, gain in (("params/Dense_1/kernel", 0.01), ("params/Dense_2/kernel", 1.0)):
        w = port[k]  # [in, out], orthonormal columns times gain
        np.testing.assert_allclose(w.T @ w, gain**2 * np.eye(w.shape[1]), atol=1e-5 * gain**2)


def test_flax_round_trip_and_checkpoints(tmp_path):
    """``Dense_0`` is the trunk's dense layer here (the policy head in the
    board actor-critic); the checkpoint reader tells the kinds apart."""
    flat = load_flat(ATARI_INIT)
    sd = from_flax_params(flat, KIND)
    assert sd["dense.weight"].shape == (512, 3136) and sd["policy.weight"].shape == (8, 512)
    assert sd["value.weight"].shape == (1, 512) and sd["convs.0.weight"].shape == (32, K, 8, 8)
    back = to_flax_params(sd, KIND)
    assert sorted(back) == sorted(flat) and len(flat) == 12
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError):
        from_flax_params(flat)  # the board actor-critic's kind
    assert flat_actor_critic_kind(flat) == KIND
    assert flat_actor_critic_kind(load_flat(BOARD_INIT)) == "actor_critic"

    net = load_actor_critic(ATARI_INIT, device=CPU)
    assert isinstance(net, AtariActorCritic) and net.convs[0].in_channels == K
    path = str(tmp_path / "p.npz")
    save_actor_critic(path, net)
    for k, v in load_flat(path).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    assert isinstance(load_actor_critic(BOARD_INIT, device=CPU), ActorCriticCNN)


@pytest.mark.parametrize("net, path", [("actor_critic", BOARD_INIT), (KIND, ATARI_INIT)])
def test_exported_init_equals_flax_init(net, path):
    """``results/ppo_init_seed1.npz`` and
    ``results/atari_actor_critic_k4_init_seed1.npz`` hold the initial weights
    of ``examples/train_ppo.py --seed 1`` and of ``--obs rgb84 --frame-stack
    4 --seed 1``: Flax's draw from the network key of ``PRNGKey(1)``."""
    spec = importlib.util.spec_from_file_location(
        "export_grouped_init_params", os.path.join(REPO, "tools", "export_grouped_init_params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pixels = net == KIND
    assert mod.default_out(net, 1, K if pixels else 1) == path
    _, net_key, _ = jax.random.split(jax.random.PRNGKey(1), 3)
    flax, example = ((FlaxAtariActorCritic(), jnp.zeros((1, K, 84, 84), jnp.uint8)) if pixels
                     else (FlaxActorCritic(), jnp.zeros((1, 20, 10), jnp.int8)))
    fresh = _flat(jax.jit(flax.init)(net_key, example))
    committed = load_flat(path)
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)


# ---------------------------------------------------------------------------
# A whole train step against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run():
    net = FlaxAtariActorCritic(dtype=jnp.float32)
    cfg = jppo.PPOConfig(**SMALL)
    env_config = JEngineConfig(auto_reset=True)
    ts = jax.jit(functools.partial(jppo.init_train_state, n_envs=N_ENVS, env_config=env_config,
                                   ppo=cfg, net=net, impl="flagship", obs="rgb84"))(
        jax.random.PRNGKey(0))
    step = jppo.make_train_step(env_config, cfg, net, impl="flagship", obs="rgb84")
    policy_step = inspect.getclosurevars(step).nonlocals["policy_step"]
    _, traj = jax.jit(
        lambda s: jax.lax.scan(policy_step, (s.env_states, s.last_obs, s.params, s.key), None,
                               length=cfg.rollout_len)
    )(ts)
    ts2, metrics = jax.jit(step)(ts)
    return {
        "ts": ts, "ts2": ts2,
        "traj": {k: np.asarray(v) for k, v in traj._asdict().items()},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "params0": _flat(ts.params), "params1": _flat(ts2.params),
    }


def _port_state(jax_run):
    return ppo.init_train_state(
        np.asarray(jax.random.PRNGKey(0)), N_ENVS, EngineConfig(auto_reset=True),
        ppo.PPOConfig(**SMALL), net=AtariActorCritic(in_channels=K, dtype=torch.float32),
        impl="flagship", obs="rgb84", device=CPU, params=jax_run["params0"],
    )


def _assert_env_equal(states, jstates, where):
    for k in engine.FIELDS:
        got = getattr(states, k).numpy()
        np.testing.assert_array_equal(got.T if k == "key" else got,
                                      np.asarray(getattr(jstates, k)), err_msg=f"{k} {where}")


def test_train_step_matches_jax(jax_run):
    ts = _port_state(jax_run)
    jts = jax_run["ts"]
    np.testing.assert_array_equal(ts.key, np.asarray(jts.key))
    assert ts.last_obs.shape == (N_ENVS, K, 84, 84) and ts.last_obs.dtype == torch.uint8
    np.testing.assert_array_equal(ts.last_obs.numpy(), np.asarray(jts.last_obs))
    _assert_env_equal(ts.env_states, jts.env_states, "init")

    cfg = ppo.PPOConfig(**SMALL)
    env_config = EngineConfig(auto_reset=True)
    traj, _, _, _ = ppo.rollout(ts, cfg, ppo.sample_step_fn(env_config, "flagship", obs="rgb84"))
    want = jax_run["traj"]
    assert traj.obs.shape == (4, N_ENVS, K, 84, 84)
    for k in ("obs", "action", "reward", "done"):
        got = getattr(traj, k).numpy()
        assert got.dtype == want[k].dtype, k
        np.testing.assert_array_equal(got, want[k], err_msg=k)
    for k in ("value", "log_prob"):
        _close(getattr(traj, k).numpy(), want[k], 1e-5, k)

    ts2, metrics = ppo.make_train_step(env_config, cfg, impl="flagship", obs="rgb84")(ts)
    jm = jax_run["metrics"]
    assert sorted(metrics) == sorted(jm)
    for k in ("ent_coef", "mean_reward", "episodes_done", "mean_score"):
        assert float(metrics[k]) == jm[k], k
    for k in ("pg_loss", "v_loss", "entropy"):
        _close(float(metrics[k]), jm[k], 1e-4, k)
    jts2 = jax_run["ts2"]
    np.testing.assert_array_equal(ts2.key, np.asarray(jts2.key))
    np.testing.assert_array_equal(ts2.last_obs.numpy(), np.asarray(jts2.last_obs))
    _assert_env_equal(ts2.env_states, jts2.env_states, "after the step")
    assert ts2.update_i == 1 and ts2.optimizer.count == 2
    p0, p1 = jax_run["params0"], jax_run["params1"]
    got = to_flax_params(ts2.net.state_dict(), KIND)
    for k in p0:
        d_jax = p1[k] - p0[k]
        assert np.abs(d_jax).max() > 0, k
        assert np.linalg.norm(got[k] - p0[k] - d_jax) <= 1e-4 * np.linalg.norm(d_jax), k


def test_ppo_rgb84_frame_stack_train_step():
    """``tests/test_rl.py:307-329`` on the port: the default bf16
    ``AtariActorCritic`` over 4-frame windows runs a train step, the
    windows flow through the rollout and the parameters move."""
    env_config = EngineConfig(auto_reset=True)
    cfg = ppo.PPOConfig(rollout_len=4, update_epochs=1, n_minibatches=2, frame_stack=4)
    ts = ppo.init_train_state(prng_key(0), 4, env_config, cfg, impl="flagship", obs="rgb84",
                              device=CPU)
    assert isinstance(ts.net, AtariActorCritic) and ts.net.dtype == torch.bfloat16
    assert ts.last_obs.shape == (4, 4, 84, 84) and ts.last_obs.dtype == torch.uint8
    before = {k: v.clone() for k, v in ts.net.state_dict().items()}
    ts2, metrics = ppo.make_train_step(env_config, cfg, impl="flagship", obs="rgb84")(ts)
    assert np.isfinite(float(metrics["pg_loss"]))
    assert any(not torch.equal(before[k], v) for k, v in ts2.net.state_dict().items())
    assert ts2.last_obs.shape == (4, 4, 84, 84)


# ---------------------------------------------------------------------------
# Greedy evaluation and the command lines
# ---------------------------------------------------------------------------


def test_greedy_evaluation_matches_jax():
    """The JAX-initialised agent (fp32 trunks) plays 4 greedy games of at
    most 192 steps on 4-frame windows in both packages: the same statistics.
    (Its games last about 150 steps: none ends within 50.)"""
    flat = load_flat(ATARI_INIT)
    flax = FlaxAtariActorCritic(dtype=jnp.float32)
    want = jax.jit(lambda p, key: jevaluate.evaluate_policy(
        jevaluate.greedy_logits(flax, p), 4, JEngineConfig(), key, impl="flagship",
        max_steps=192, frame_stack=K, obs="rgb84"))(_tree(flat), jax.random.PRNGKey(5))
    want = {k: float(v) for k, v in jax.device_get(want).items()}
    net = load_actor_critic(ATARI_INIT, device=CPU, dtype=torch.float32)
    got = evaluate.evaluate_policy(evaluate.greedy_logits(net), 4, EngineConfig(), prng_key(5),
                                   impl="flagship", max_steps=192, frame_stack=K, obs="rgb84",
                                   device=CPU)
    assert got["episodes_completed"] > 0
    for k in ("episodes_completed", "truncated", "return_mean", "return_min", "return_max",
              "length_mean", "lines_mean"):
        assert got[k] == want[k], k


def test_cli_rgb84_trains_on_cpu_and_evaluates(tmp_path, capsys):
    """``train_ppo --obs rgb84 --frame-stack 4`` switches to the flagship
    engine, trains the Atari agent one iteration and saves it; the
    evaluation command line loads that file."""
    params, log = str(tmp_path / "p.npz"), str(tmp_path / "log.jsonl")
    ts, records = train_ppo.main([
        "--device", CPU, "--obs", "rgb84", "--frame-stack", "4", "--n-envs", "4",
        "--rollout-len", "4", "--iterations", "1", "--update-epochs", "1", "--n-minibatches", "2",
        "--save-params", params, "--log-json", log,
    ])
    out = capsys.readouterr().out
    assert "switching --impl to flagship" in out and "saved params" in out
    assert isinstance(ts.net, AtariActorCritic) and ts.net.dtype == torch.bfloat16
    assert isinstance(ts.env_states, engine.EngineState) and ts.last_obs.shape == (4, 4, 84, 84)
    assert [r["iteration"] for r in records] == [1]
    with open(log) as f:
        assert json.loads(f.readline())["env_steps"] == 16
    assert flat_actor_critic_kind(load_flat(params)) == KIND
    stats = evaluate.main(["--obs", "rgb84", "--frame-stack", "4", "--checkpoint", params,
                           "--device", CPU, "--episodes", "4", "--max-steps", "24",
                           "--dtype", "float32"])
    assert stats["max_steps"] == 24 and stats["episodes_completed"] + stats["truncated"] == 4


def test_cli_rgb84_defaults_to_the_card():
    args = train_ppo.parse_args(["--obs", "rgb84", "--frame-stack", "4"])
    assert args.device == "cuda" and args.impl == "flagship" and args.frame_stack == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_ppo.setup(args)
        with pytest.raises(RuntimeError, match="cuda"):
            evaluate.main(["--obs", "rgb84", "--frame-stack", "4", "--checkpoint", ATARI_INIT])
