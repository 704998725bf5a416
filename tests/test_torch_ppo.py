"""PPO of the PyTorch port against the JAX package's, on the CPU.

One module-scoped JAX run (8 envs, ``PPOConfig(rollout_len=4,
update_epochs=2, n_minibatches=2)``, fp32 network, turbo engine) is the
oracle for the whole train step; the JAX ``policy_step`` and ``loss_fn`` are
taken from the closure of its ``make_train_step``.  Tolerances, each with its
reason:

* integer results (observations, actions, rewards, dones, keys): equal;
* GAE: 1e-6 relative (float32 rounding, XLA may contract into FMAs);
* values and log-probs of the rollout: 1e-5 (float32 sums of up to 1152
  terms in another order);
* loss terms 1e-5 and gradients 1e-4 of each leaf's largest magnitude;
* Adam steps: 1e-5 of the largest change plus an ulp of the parameters
  per step (optax and PyTorch round the bias corrections in another order);
* a whole train step (4 Adam updates): each parameter leaf's change within
  1e-3 of its largest change; Adam divides by sqrt(v) + 1e-5, so a float32
  difference of the gradient near zero is magnified up to lr / 1e-5.

The rest mirrors the JAX PPO gates of ``tests/test_rl.py:41-123`` on the
port alone, and covers the initialisers, the converters, the checkpoint
files and the command line.
"""
import ast
import copy
import inspect
import json
import os
import sys

import imageio
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.models.networks import ActorCriticCNN as FlaxActorCritic
from tetris_gymnasium_tpu.rl import ppo as jppo

from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.examples import train_ppo
from tetris_gymnasium_torch.models.convert import from_flax_params, to_flax_params
from tetris_gymnasium_torch.models.init import init_actor_critic_
from tetris_gymnasium_torch.models.networks import ActorCriticCNN
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.rl import ppo
from tetris_gymnasium_torch.utils.checkpoint import load_actor_critic, load_flat, save_actor_critic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORTED = os.path.join(REPO, "results", "ppo_lines_params.npz")
SMALL = dict(rollout_len=4, update_epochs=2, n_minibatches=2)
N_ENVS = 8


def _flat(params):
    return {
        "/".join(str(p.key) for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _close(got, want, rel, what=""):
    """``|got - want| <= rel * max(|want|, tiny)`` elementwise."""
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0, atol=rel * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def jax_run():
    net = FlaxActorCritic(dtype=jnp.float32)
    cfg = jppo.PPOConfig(**SMALL)
    env_config = JEngineConfig(auto_reset=True)
    ts = jppo.init_train_state(jax.random.PRNGKey(0), N_ENVS, env_config, cfg, net, impl="turbo")
    step = jppo.make_train_step(env_config, cfg, net, impl="turbo")
    closure = inspect.getclosurevars(step).nonlocals
    policy_step = closure["policy_step"]
    _, traj = jax.jit(
        lambda s: jax.lax.scan(policy_step, (s.env_states, s.last_obs, s.params, s.key), None,
                               length=cfg.rollout_len)
    )(ts)
    ts2, metrics = jax.jit(step)(ts)
    return {
        "ts": ts, "ts2": ts2, "loss_fn": closure["loss_fn"],
        "traj": {k: np.asarray(v) for k, v in traj._asdict().items()},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "params0": _flat(ts.params), "params1": _flat(ts2.params),
    }


def _port_state(jax_run):
    return ppo.init_train_state(
        np.asarray(jax.random.PRNGKey(0)), N_ENVS, EngineConfig(auto_reset=True),
        ppo.PPOConfig(**SMALL), net=ActorCriticCNN(dtype=torch.float32), device="cpu",
        params=jax_run["params0"],
    )


# ---------------------------------------------------------------------------
# Parity with JAX
# ---------------------------------------------------------------------------


def test_gae_plain_matches_jax():
    T, B = 16, 32
    rng = np.random.default_rng(0)
    reward = rng.standard_normal((T, B)).astype(np.float32)
    value = rng.standard_normal((T, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.15
    last_value = rng.standard_normal(B).astype(np.float32)
    cfg = jppo.PPOConfig()
    jtraj = jppo.Transition(None, None, None, jnp.asarray(value), jnp.asarray(reward),
                            jnp.asarray(done))
    want_adv, want_tgt = jppo._gae(cfg, jtraj, jnp.asarray(last_value))
    traj = ppo.Transition(None, None, None, torch.from_numpy(value), torch.from_numpy(reward),
                          torch.from_numpy(done))
    adv, tgt = ppo.gae(ppo.PPOConfig(), traj, torch.from_numpy(last_value))
    assert done.any() and adv.dtype == torch.float32 and adv.shape == (T, B)
    np.testing.assert_allclose(adv.numpy(), np.asarray(want_adv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(want_tgt), rtol=1e-6, atol=1e-6)


def test_loss_and_gradients_match_jax(jax_run):
    rng = np.random.default_rng(1)
    n = 64
    obs = rng.integers(-1, 2, size=(n, 20, 10)).astype(np.int8)
    action = rng.integers(0, 8, size=n).astype(np.int32)
    log_prob = rng.uniform(-2.5, -1.6, size=n).astype(np.float32)
    value = rng.standard_normal(n).astype(np.float32) * 0.1
    adv = rng.standard_normal(n).astype(np.float32) * 2
    tgt = rng.standard_normal(n).astype(np.float32)
    zeros = np.zeros(n, np.float32)
    ent_coef = 0.05

    jbatch = jppo.Transition(*(jnp.asarray(x) for x in (obs, action, log_prob, value, zeros, zeros)))
    (jtotal, jaux), jgrads = jax.value_and_grad(jax_run["loss_fn"], has_aux=True)(
        jax_run["ts"].params, jbatch, jnp.asarray(adv), jnp.asarray(tgt), ent_coef
    )
    net = ActorCriticCNN(dtype=torch.float32)
    net.load_state_dict(from_flax_params(jax_run["params0"]))
    batch = ppo.Transition(*(torch.from_numpy(x) for x in (obs, action, log_prob, value, zeros, zeros)))
    total, aux = ppo.loss_fn(net, ppo.PPOConfig(**SMALL), batch, torch.from_numpy(adv),
                             torch.from_numpy(tgt), ent_coef)
    total.backward()
    for got, want, name in zip((total, *aux), (jtotal, *jaux), ("total", "pg", "v", "entropy")):
        _close(got.item(), float(want), 1e-5, name)
    grads = to_flax_params({k: p.grad for k, p in net.named_parameters()})
    for k, want in _flat(jgrads).items():
        assert np.abs(want).max() > 0, k
        _close(grads[k], want, 1e-4, k)


@pytest.mark.parametrize("scales", [
    (10.0, 0.03, 40.0, 0.2, 3.0, 0.05),
    (0.01, 0.03, 0.002, 0.04, 0.01, 0.02),
], ids=["clip-fires", "no-clip"])
def test_optimizer_steps_match_optax(scales):
    """Global-norm clip + Adam(eps=1e-5) + the linear lr decay over six counts.

    The gradients' norms vary from count to count, so the clip changes Adam's
    moments and with them the steps.  Tolerance: 1e-5 of the largest change
    plus ``count + 2`` float32 ulps of the parameters (magnitude ~1): each
    side rounds ``p + update`` on its own at every step.
    """
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * sc).astype(np.float32) for k, s in shapes.items()}
             for sc in scales]
    norms = [np.sqrt(sum(float((g ** 2).sum()) for g in gs.values())) for gs in grads]
    fires = [n >= 0.5 for n in norms]
    assert any(fires) == (scales[0] > 1) and not all(fires)

    kw = dict(learning_rate=1e-2, total_iterations=2, update_epochs=2, n_minibatches=1)
    jopt = jppo.make_optimizer(jppo.PPOConfig(**kw))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    runs = {}
    for max_norm in (0.5, 1e9):  # the port as configured, and without the clip
        tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
        runs[max_norm] = (tparams, ppo.make_optimizer(
            ppo.PPOConfig(max_grad_norm=max_norm, **kw), tparams.values()))
    schedule = optax.linear_schedule(1e-2, 0.0, 4)
    unclipped_off = 0.0
    for count, g in enumerate(grads):
        before = {k: np.asarray(v) for k, v in jparams.items()}
        t_before = {k: p.detach().numpy().copy() for k, p in runs[0.5][0].items()}
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for tparams, topt in runs.values():
            assert topt.lr(count) == float(np.float32(schedule(count)))
            for k, p in tparams.items():
                p.grad = torch.from_numpy(g[k].copy())
            topt.step()
        for k in shapes:
            want = np.asarray(jparams[k]) - before[k]
            got = runs[0.5][0][k].detach().numpy() - before[k]
            if count >= 4:  # the schedule has reached 0: nothing moves
                assert not want.any()
                np.testing.assert_array_equal(runs[0.5][0][k].detach().numpy(), t_before[k])
                continue
            tol = 1e-5 * np.abs(want).max() + (count + 2) * np.spacing(np.abs(before[k]).max())
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{k} @ {count}")
            other = runs[1e9][0][k].detach().numpy() - before[k]
            unclipped_off = max(unclipped_off, float(np.abs(other - want).max() / tol))
    # the clip is what makes the port agree: without it the steps differ (when it fires)
    assert (unclipped_off > 10) == (scales[0] > 1)
    assert runs[0.5][1].count == 6


def test_optimizer_treats_missing_gradients_as_zero():
    """JAX's gradient of a loss that does not reach a parameter is zeros, and
    Adam's moments still decay; a missing ``.grad`` must do the same."""
    cfg = ppo.PPOConfig(learning_rate=1e-2)
    runs = []
    for explicit in (True, False):
        ps = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))]
        opt = ppo.make_optimizer(cfg, ps)
        for count in range(3):
            ps[0].grad = torch.full((3,), 0.1)
            ps[1].grad = torch.full((2,), 0.1) if count == 0 else (
                torch.zeros(2) if explicit else None)
            opt.step()
        runs.append([p.detach().clone() for p in ps])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert (runs[1][1] < 1 - 2e-2).all()  # kept moving on its first gradient's momentum


def test_train_step_matches_jax(jax_run):
    ts = _port_state(jax_run)
    jts = jax_run["ts"]
    np.testing.assert_array_equal(ts.key, np.asarray(jts.key))
    np.testing.assert_array_equal(ts.last_obs.numpy(), np.asarray(jts.last_obs))
    cfg = ppo.PPOConfig(**SMALL)
    sample_step = ppo.sample_step_fn(EngineConfig(auto_reset=True))
    assert sample_step.func is ppo.turbo_sample_step  # the turbo engine's one-call route
    traj, _, _, _ = ppo.rollout(ts, cfg, sample_step)
    want = jax_run["traj"]
    for k in ("obs", "action", "reward", "done"):
        got = getattr(traj, k).numpy()
        assert got.dtype == want[k].dtype, k
        np.testing.assert_array_equal(got, want[k], err_msg=k)
    for k in ("value", "log_prob"):
        np.testing.assert_allclose(getattr(traj, k).numpy(), want[k], rtol=0, atol=1e-5, err_msg=k)

    ts2, metrics = ppo.make_train_step(EngineConfig(auto_reset=True), cfg)(ts)
    jm = jax_run["metrics"]
    assert sorted(metrics) == sorted(jm)
    for k in ("ent_coef", "mean_reward", "episodes_done", "mean_score"):
        assert float(metrics[k]) == jm[k], k
    for k in ("pg_loss", "v_loss", "entropy"):
        _close(float(metrics[k]), jm[k], 1e-4, k)
    np.testing.assert_array_equal(ts2.key, np.asarray(jax_run["ts2"].key))
    np.testing.assert_array_equal(ts2.last_obs.numpy(), np.asarray(jax_run["ts2"].last_obs))
    assert ts2.update_i == 1 and ts2.optimizer.count == 4
    p0, p1 = jax_run["params0"], jax_run["params1"]
    got = to_flax_params(ts2.net.state_dict())
    for k in p0:
        assert np.abs(p1[k] - p0[k]).max() > 0, k
        _close(got[k] - p0[k], p1[k] - p0[k], 1e-3, k)


# ---------------------------------------------------------------------------
# The JAX PPO gates (tests/test_rl.py:41-123), on the port
# ---------------------------------------------------------------------------


def _init(cfg, seed=0):
    return ppo.init_train_state(prng_key(seed), N_ENVS, EngineConfig(auto_reset=True), cfg,
                                device="cpu")


def test_ppo_train_step_runs_and_updates():
    cfg = ppo.PPOConfig(rollout_len=4, update_epochs=1, n_minibatches=2)
    ts = _init(cfg)
    before = {k: v.clone() for k, v in ts.net.state_dict().items()}
    ts2, metrics = ppo.make_train_step(EngineConfig(auto_reset=True), cfg)(ts)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(before[k], v) for k, v in ts2.net.state_dict().items())
    # every env advanced rollout_len steps (batch-minor turbo state)
    assert ts2.env_states.steps.shape == (N_ENVS,)
    assert int(ts2.env_states.steps.min()) == 4


def test_ppo_annealing_schedules():
    cfg = ppo.PPOConfig(rollout_len=4, update_epochs=1, n_minibatches=2, total_iterations=4,
                        ent_coef=0.1, ent_coef_final=0.02)
    ts = _init(cfg)
    step = ppo.make_train_step(EngineConfig(auto_reset=True), cfg)
    coefs = []
    for _ in range(5):
        ts, metrics = step(ts)
        coefs.append(float(metrics["ent_coef"]))
    np.testing.assert_allclose(coefs, [0.1, 0.08, 0.06, 0.04, 0.02], atol=1e-6)
    assert ts.update_i == 5
    # the learning rate decays over the 4 * 1 * 2 minibatch updates, then stays 0
    assert ts.optimizer.count == 10 and ts.optimizer.lr(8) == 0.0
    assert ts.optimizer.lr(0) == pytest.approx(cfg.learning_rate)


def test_ppo_custom_rewards_mapping():
    """alife=0 reaches the rollout engine: smaller per-commit rewards than alife=1."""
    cfg = ppo.PPOConfig(rollout_len=16, update_epochs=1, n_minibatches=2)
    ts = _init(cfg)
    _, m0 = ppo.make_train_step(EngineConfig(auto_reset=True), cfg)(copy.deepcopy(ts))
    _, mz = ppo.make_train_step(EngineConfig(auto_reset=True), cfg,
                                rewards=RewardsMapping(alife=0.0))(copy.deepcopy(ts))
    assert float(mz["mean_reward"]) < float(m0["mean_reward"])


def test_minibatches_cover_every_sample_once_per_epoch():
    cfg = ppo.PPOConfig(rollout_len=4, update_epochs=2, n_minibatches=2, shuffle_block=64)
    T, B = 4, 8
    ids = torch.arange(T * B).reshape(T, B)
    traj = ppo.Transition(ids, ids, ids, ids, ids.float(), ids.bool())
    assert ppo.shuffle_block(cfg, T * B) == 16  # gcd(64, 32 // 2)
    _, keys = ppo.epoch_keys(prng_key(0), 2)
    seen = [b.obs for b, _, _ in ppo.minibatches(traj, ids.float(), ids.float(), cfg, keys)]
    assert len(seen) == 4 and all(s.shape == (16,) for s in seen)
    for e in range(2):
        assert sorted(torch.cat(seen[2 * e:2 * e + 2]).tolist()) == list(range(T * B))
    with pytest.raises(ValueError, match="n_minibatches"):
        ppo.shuffle_block(ppo.PPOConfig(n_minibatches=3), 32)


def test_frame_stack_is_not_ported():
    """Frame stacking itself is ported now (``tests/test_torch_framestack.py``
    holds it against JAX): a K = 4 state carries ``[B, 4, H, W]`` windows
    into a four-channel trunk, on the turbo and the flagship engine alike."""
    cfg = ppo.PPOConfig(frame_stack=4, rollout_len=2, update_epochs=1, n_minibatches=2)
    ts = _init(cfg)
    assert ts.last_obs.shape == (N_ENVS, 4, 20, 10)
    assert ts.net.encoder.convs[0].weight.shape[1] == 4
    flag = ppo.init_train_state(prng_key(0), N_ENVS, EngineConfig(auto_reset=True), cfg,
                                impl="flagship", device="cpu")
    assert torch.equal(flag.last_obs, ts.last_obs)


# ---------------------------------------------------------------------------
# Initialisers, converters, checkpoints
# ---------------------------------------------------------------------------


def test_init_statistics_match_flax():
    """Per-layer std within 10% of Flax's init, zero biases, orthogonal heads."""
    flax = _flat(FlaxActorCritic().init(jax.random.PRNGKey(0), jnp.zeros((1, 20, 10), jnp.int8)))
    net = init_actor_critic_(ActorCriticCNN(), torch.Generator().manual_seed(0))
    port = to_flax_params(net.state_dict())
    assert sorted(port) == sorted(flax)
    for k, want in flax.items():
        if k.endswith("/bias"):
            assert not port[k].any() and not want.any(), k
            continue
        fan_in = int(np.prod(want.shape[:-1]))
        assert abs(port[k].std() / want.std() - 1) < 0.1, k
        if "BoardEncoder" in k:  # lecun_normal: variance 1 / fan_in, truncated at 2 std
            assert abs(port[k].std() * np.sqrt(fan_in) - 1) < 0.1, k
            assert np.abs(port[k]).max() <= 2 * np.sqrt(1 / fan_in) / 0.87962566103423978 + 1e-6
    for k, gain in (("params/Dense_0/kernel", 0.01), ("params/Dense_1/kernel", 1.0)):
        w = port[k]  # [in, out], orthonormal columns times gain
        np.testing.assert_allclose(w.T @ w, gain**2 * np.eye(w.shape[1]), atol=1e-5 * gain**2)


def test_init_train_state_is_seeded():
    cfg = ppo.PPOConfig(rollout_len=4)
    a, b, c = _init(cfg, 0), _init(cfg, 0), _init(cfg, 1)
    for k, v in a.net.state_dict().items():
        assert torch.equal(v, b.net.state_dict()[k])
    assert any(not torch.equal(v, c.net.state_dict()[k]) for k, v in a.net.state_dict().items())
    assert a.net.encoder.dtype == torch.bfloat16 and a.update_i == 0
    assert a.key.dtype == np.uint32 and a.key.shape == (2,)


def test_flax_round_trip():
    flat = load_flat(EXPORTED)
    back = to_flax_params(from_flax_params(flat))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError, match="missing"):
        to_flax_params({"policy.weight": torch.zeros(8, 512)})


def test_save_load_round_trip(tmp_path):
    net = init_actor_critic_(ActorCriticCNN(), torch.Generator().manual_seed(3))
    path = str(tmp_path / "params.npz")
    save_actor_critic(path, net)
    flat = load_flat(path)
    assert len(flat) == 12
    loaded = load_actor_critic(path, device="cpu")
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def test_cli_trains_on_cpu_and_saves(tmp_path, capsys):
    params, log = str(tmp_path / "p.npz"), str(tmp_path / "log.jsonl")
    ts, records = train_ppo.main([
        "--device", "cpu", "--n-envs", "8", "--rollout-len", "4", "--iterations", "2",
        "--update-epochs", "1", "--n-minibatches", "2", "--save-params", params,
        "--log-json", log, "--init-params", EXPORTED,
    ])
    assert ts.update_i == 2 and ts.net.encoder.dtype == torch.bfloat16
    assert [r["iteration"] for r in records] == [1]  # logs at 1 and every 5th, as the JAX script
    with open(log) as f:
        assert json.loads(f.readline())["env_steps"] == 32
    out = capsys.readouterr().out
    assert "warm-started params" in out and "saved params" in out
    saved = load_flat(params)
    start = load_flat(EXPORTED)
    assert sorted(saved) == sorted(start)
    assert any(not np.array_equal(saved[k], start[k]) for k in saved)


def test_cli_chunk_reads_metrics_once_per_chunk(capsys):
    _, records = train_ppo.main([
        "--device", "cpu", "--n-envs", "8", "--rollout-len", "4", "--iterations", "4",
        "--chunk", "2", "--update-epochs", "1", "--n-minibatches", "2",
    ])
    assert [r["iteration"] for r in records] == [2, 4]


@pytest.mark.parametrize("argv", [
    ["--iterations", "5", "--chunk", "2"],
    ["--iterations", "4", "--chunk", "2", "--eval-every", "3"],
])
def test_cli_chunk_divisibility_errors(argv):
    with pytest.raises(SystemExit):
        train_ppo.parse_args(argv)


@pytest.mark.parametrize("argv, item", [
    (["--obs", "rgb84"], "item 10"),
    (["--impl", "flagship"], "item 9"),
    (["--wandb"], "item 12"),
    (["--video-every", "5"], "item 12"),
])
def test_cli_unported_options_raise(argv, item, tmp_path, monkeypatch, capsys):
    """Every option of the JAX script is ported and parses: ``--impl
    flagship`` (item 9); ``--obs rgb84`` (item 10), which selects the
    flagship engine; ``--wandb`` (item 12), which without wandb warns once
    and leaves the records as they are; ``--video-every`` (item 12), which
    writes a greedy GIF beside the log and leaves the records as they are."""
    args = train_ppo.parse_args(argv)
    if item in ("item 9", "item 10"):
        assert args.impl == "flagship" and args.obs == ("rgb84" if item == "item 10" else "board")
        return
    tiny = ["--device", "cpu", "--n-envs", "8", "--rollout-len", "4", "--iterations", "5",
            "--update-epochs", "1", "--n-minibatches", "2"]

    def no_sps(records):
        return [{k: v for k, v in r.items() if k != "sps"} for r in records]

    if argv == ["--wandb"]:
        assert args.wandb
        monkeypatch.setitem(sys.modules, "wandb", None)  # forces ImportError
        _, flagged = train_ppo.main(tiny + argv)
        assert capsys.readouterr().err.count("wandb requested") == 1
    else:
        assert args.video_every == 5
        _, flagged = train_ppo.main(tiny + argv + ["--log-json", str(tmp_path / "ppo.jsonl")])
        assert "recorded greedy episode" in capsys.readouterr().out
        assert len(imageio.mimread(str(tmp_path / "ppo_it5.gif"))) > 1
    _, plain = train_ppo.main(tiny)
    assert no_sps(flagged) == no_sps(plain)


def test_cli_defaults_to_the_card():
    args = train_ppo.parse_args([])
    assert args.device == "cuda" and args.impl == "turbo" and args.obs == "board"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_ppo.setup(args)


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tetris_gymnasium_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "tetris_gymnasium_tpu")
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in banned, f"{path} imports {name}"
