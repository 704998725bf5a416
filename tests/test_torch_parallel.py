"""The port's env-batch sharding against the JAX package's, in one process.

Mirrors ``tests/test_parallel.py``.  The JAX functions run on the suite's
8-device virtual CPU mesh as the oracle; the port's run on CPU tensors.  A
rank of a larger world is an :class:`EnvMesh` with that rank and world and
no process group: it computes its share ``[lo, hi)`` exactly as a rank of a
real group does, only its collectives are the identity, so its sums here
are its own share (``tests/test_torch_multihost.py`` runs real groups).
Integer state, keys, draws and checksums must be bit-equal.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.config import EnvConfig as JEnvConfig
from tetris_gymnasium_tpu.core import fn_env as jfn
from tetris_gymnasium_tpu.core import turbo as jturbo
from tetris_gymnasium_tpu.parallel import mesh as jmesh
from tetris_gymnasium_tpu.rl import buffers as jbuffers

from tetris_gymnasium_torch import parallel
from tetris_gymnasium_torch.config import EngineConfig, EnvConfig
from tetris_gymnasium_torch.core import engine, fn_env, turbo
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel import mesh as pmesh
from tetris_gymnasium_torch.rl import buffers, dqn, ppo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CFG, JCFG = EngineConfig(auto_reset=True), JEngineConfig(auto_reset=True)
N = 16
RANKS = [(1, 0), (2, 0), (2, 1), (4, 3), (8, 5)]  # (world, rank)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank(world, rank):
    return pmesh.EnvMesh(rank=rank, world=world, device=CPU)


def _flagship_from_jax(js) -> engine.EngineState:
    fields = {k: torch.from_numpy(np.array(getattr(js, k))) for k in engine.FIELDS}
    fields["key"] = fields["key"].T.contiguous()  # the port keeps the key as [2, B]
    return engine.EngineState(**fields)


def _assert_flagship_equal(ts, js, lo, hi, where):
    for k in engine.FIELDS:
        got, want = getattr(ts, k).numpy(), np.asarray(getattr(js, k))[lo:hi]
        if k == "key":
            got = got.T
        np.testing.assert_array_equal(got, want, err_msg=f"{k} @ {where}")


@functools.lru_cache(maxsize=None)
def _jax_reset(seed, n, obs="board"):
    return jmesh.sharded_reset(jax.random.PRNGKey(seed), n, JCFG, jmesh.env_mesh(), obs=obs)


# ---------------------------------------------------------------------------
# Keys, reset, step
# ---------------------------------------------------------------------------


def test_port_exports_the_parallel_names():
    for name in ("batch_keys", "env_mesh", "initialize_distributed", "sharded_random_rollout",
                 "sharded_reset", "sharded_step", "state_checksum", "shard_env", "gather_env"):
        assert callable(getattr(parallel, name)), name


@pytest.mark.parametrize("lo,n", [(0, 16), (5, 7), (48, 16)])
def test_batch_keys_start_is_a_slice_of_jax(lo, n):
    want = np.asarray(jmesh.batch_keys(jax.random.PRNGKey(3), lo + n))[lo:]
    got = pmesh.batch_keys(threefry.prng_key(3), n, device=CPU, start=lo)
    np.testing.assert_array_equal(got.numpy(), want)


def test_env_mesh_without_a_group_is_one_rank():
    m = pmesh.env_mesh("cpu")
    assert (m.rank, m.world, m.group, m.device) == (0, 1, None, CPU)
    assert m.env_slice(12) == (0, 12)
    t = torch.arange(4)
    assert m.all_reduce(t) is t and m.all_gather(t) is t
    assert sum(m.counts.values()) == 0


def test_env_slice_is_even_and_contiguous():
    assert [_rank(4, r).env_slice(64) for r in range(4)] == [(0, 16), (16, 32), (32, 48), (48, 64)]
    with pytest.raises(ValueError, match="do not split evenly"):
        _rank(3, 0).env_slice(64)


@pytest.mark.parametrize("world,rank", RANKS)
@pytest.mark.parametrize("obs", ["board", "dict"])
def test_sharded_reset_matches_jax(world, rank, obs):
    m = _rank(world, rank)
    lo, hi = m.env_slice(N)
    jstates, jobs = _jax_reset(0, N, obs)
    ts, tobs = pmesh.sharded_reset(threefry.prng_key(0), N, CFG, m, obs=obs)
    _assert_flagship_equal(ts, jstates, lo, hi, "reset")
    if obs == "board":
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs)[lo:hi])
    else:
        assert sorted(tobs) == sorted(jobs)
        for k in jobs:
            np.testing.assert_array_equal(tobs[k].numpy(), np.asarray(jobs[k])[lo:hi], err_msg=k)


@pytest.mark.parametrize("world,rank", RANKS)
def test_sharded_step_matches_jax(world, rank):
    m = _rank(world, rank)
    lo, hi = m.env_slice(N)
    jstates, _ = jmesh.sharded_reset(jax.random.PRNGKey(1), N, JCFG, jmesh.env_mesh(), obs="board")
    ts, _ = pmesh.sharded_reset(threefry.prng_key(1), N, CFG, m, obs="board")
    actions = np.tile(np.arange(8, dtype=np.int32), N // 8)
    jout = jmesh.sharded_step(jstates, jnp.asarray(actions), JCFG, jmesh.env_mesh(), obs="board")
    tout = pmesh.sharded_step(ts, torch.from_numpy(actions[lo:hi]), CFG, m, obs="board")
    _assert_flagship_equal(tout[0], jout[0], lo, hi, "step")
    for got, want, what in zip(tout[1:4], jout[1:4], ("obs", "reward", "done")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[lo:hi], err_msg=what)


@functools.lru_cache(maxsize=None)
def _jax_rollout(engine_kind):
    m = jmesh.env_mesh()
    if engine_kind == "engine":
        states, _ = jmesh.sharded_reset(jax.random.PRNGKey(2), N, JCFG, m, obs="board")
        cfg = JCFG
    else:
        cfg = JEnvConfig()
        keys = jmesh.batch_keys(jax.random.PRNGKey(2), N)
        _, states, _ = jax.jit(jax.vmap(lambda k: jfn.reset(k, cfg)))(keys)
    final, tot_r, tot_d = jmesh.sharded_random_rollout(states, jax.random.PRNGKey(3), cfg, m,
                                                       horizon=64, engine_kind=engine_kind)
    return final, float(tot_r), int(tot_d)


@pytest.mark.parametrize("engine_kind", ["engine", "fn_env"])
def test_sharded_random_rollout_ranks_add_up_to_jax(engine_kind):
    """Each rank of W = 1, 2 and 4 plays its envs of JAX's rollout on the
    8-device mesh bit for bit, and the ranks' sums add up to JAX's."""
    jfinal, jr, jd = _jax_rollout(engine_kind)
    assert jd > 0
    for world in (1, 2, 4):
        sum_r, sum_d = 0.0, 0
        for rank in range(world):
            m = _rank(world, rank)
            lo, hi = m.env_slice(N)
            if engine_kind == "engine":
                states, _ = pmesh.sharded_reset(threefry.prng_key(2), N, CFG, m)
                cfg = CFG
            else:
                cfg = EnvConfig()
                states, _ = pmesh.sharded_compat_reset(threefry.prng_key(2), N, cfg, m)
            final, r, d = pmesh.sharded_random_rollout(states, threefry.prng_key(3), cfg, m,
                                                       horizon=64, engine_kind=engine_kind)
            assert r.dtype == torch.float64 and d.dtype == torch.int64
            sum_r, sum_d = sum_r + float(r), sum_d + int(d)
            if engine_kind == "engine":
                _assert_flagship_equal(final, jfinal, lo, hi, f"W={world} rank {rank}")
            else:
                for k in fn_env.FIELDS:
                    np.testing.assert_array_equal(getattr(final, k).numpy(),
                                                  np.asarray(getattr(jfinal, k))[lo:hi], err_msg=k)
        assert (sum_r, sum_d) == (jr, jd), world


def test_unknown_engine_kind_raises():
    states, _ = pmesh.sharded_reset(threefry.prng_key(0), 4, CFG, _rank(1, 0))
    with pytest.raises(ValueError, match="engine_kind"):
        pmesh.sharded_random_rollout(states, threefry.prng_key(1), CFG, _rank(1, 0), 1, "turbo")


# ---------------------------------------------------------------------------
# The draws at a global counter offset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,n", [(0, 32), (32, 32), (96, 32), (7, 9)])
def test_sample_actions_plain_at_an_offset_is_the_slice_of_jax(lo, n):
    rng = np.random.default_rng(lo)
    logits = (rng.standard_normal((128, 8)) * 3).astype(np.float32)
    key = threefry.prng_key(21)
    want = np.asarray(jax.random.categorical(jnp.asarray(key), jnp.asarray(logits)))
    got_a, got_lp = ppo.sample_actions_plain(torch.from_numpy(logits[lo:lo + n]), key, lo)
    np.testing.assert_array_equal(got_a.numpy(), want[lo:lo + n])
    full_a, full_lp = ppo.sample_actions_plain(torch.from_numpy(logits), key)
    np.testing.assert_array_equal(full_a.numpy()[lo:lo + n], got_a.numpy())
    np.testing.assert_array_equal(full_lp.numpy()[lo:lo + n], got_lp.numpy())


@pytest.mark.parametrize("lo,n", [(0, 16), (16, 16), (48, 16)])
def test_turbo_sample_step_at_an_offset_is_the_slice_of_the_full_batch(lo, n):
    B = 64
    state = turbo.init(pmesh.batch_keys(threefry.prng_key(4), B, device=CPU), CFG, device=CPU)
    logits = torch.from_numpy(
        (np.random.default_rng(1).standard_normal((B, 8)) * 3).astype(np.float32))
    key = threefry.prng_key(22)
    full = ppo.turbo_sample_step(state, logits, key, CFG)
    part_state = pmesh.shard_env(state, _rank(B // n, lo // n))
    part = ppo.turbo_sample_step(part_state, logits[lo:lo + n], key, CFG, env_offset=lo)
    for k in turbo.FIELDS:
        np.testing.assert_array_equal(getattr(part[0], k).numpy(),
                                      getattr(full[0], k).numpy()[..., lo:lo + n], err_msg=k)
    for i in (1, 2, 3, 5, 6):  # obs, reward, done, action, log_prob
        np.testing.assert_array_equal(part[i].numpy(), full[i].numpy()[lo:lo + n])


@pytest.mark.parametrize("lo,n", [(0, 24), (24, 24), (40, 24)])
def test_act_plain_at_an_offset_is_the_slice_of_jax(lo, n):
    B, A = 64, 8
    q = np.random.default_rng(lo).standard_normal((B, A)).astype(np.float32)
    act_key, eps_key = threefry.prng_key(31), threefry.prng_key(32)
    random_a = np.asarray(jax.random.randint(jnp.asarray(act_key), (B,), 0, A))
    explore = np.asarray(jax.random.uniform(jnp.asarray(eps_key), (B,))) < 0.5
    want = np.where(explore, random_a, q.argmax(-1))
    got = dqn.act_plain(torch.from_numpy(q[lo:lo + n]), act_key, eps_key, 0.5, env_offset=lo)
    np.testing.assert_array_equal(got.numpy(), want[lo:lo + n])
    np.testing.assert_array_equal(
        threefry.randint_lanes(act_key, n, A, CPU, start=lo).numpy(), random_a[lo:lo + n])


# ---------------------------------------------------------------------------
# Checksums
# ---------------------------------------------------------------------------


def _jax_checksum(tree):
    return jmesh.state_checksum(tree, jmesh.env_mesh())


def test_state_checksum_of_the_flagship_state_matches_jax():
    js = _jax_rollout("engine")[0]
    assert pmesh.state_checksum(_flagship_from_jax(js), _rank(1, 0)) == _jax_checksum(js)


def test_state_checksum_of_the_compat_state_matches_jax():
    js = _jax_rollout("fn_env")[0]
    ts = fn_env.state_from_numpy({k: np.asarray(getattr(js, k)) for k in fn_env.FIELDS},
                                 device=CPU)
    assert pmesh.state_checksum(ts, _rank(1, 0)) == _jax_checksum(js)


def test_state_checksum_of_the_turbo_state_matches_jax():
    jc = JCFG
    js = jturbo.init(jmesh.batch_keys(jax.random.PRNGKey(5), N), jc)
    step = jax.jit(functools.partial(jturbo.step, config=jc))
    for i in range(20):
        js = step(js, jnp.full((N,), i % 8, dtype=jnp.int32))[0]
    ts = turbo.TurboState(**{k: torch.from_numpy(np.array(getattr(js, k))) for k in turbo.FIELDS})
    got = pmesh.state_checksum(ts, _rank(1, 0))
    assert got == _jax_checksum(js)
    assert got[".rows"] != 0 and got[".key"] != 0


def test_state_checksum_of_the_replay_buffer_matches_jax():
    rng = np.random.default_rng(7)
    block = {"obs": rng.integers(-1, 2, (8, 20, 10)).astype(np.int8),
             "action": rng.integers(0, 8, 8).astype(np.int32),
             "reward": rng.standard_normal(8).astype(np.float32),
             "done": rng.random(8) < 0.5}
    jb = jbuffers.create({k: jnp.asarray(v) for k, v in block.items()}, 32, 8)
    tb = buffers.create({k: torch.from_numpy(v) for k, v in block.items()}, 32, 8)
    for i in range(3):
        step = {k: (v * (i + 1) if v.dtype != bool else ~v) for k, v in block.items()}
        jb = jbuffers.add(jb, {k: jnp.asarray(v) for k, v in step.items()})
        tb = buffers.add(tb, {k: torch.from_numpy(v) for k, v in step.items()})
    got = pmesh.state_checksum(tb, _rank(1, 0), sharded=False)
    assert got == _jax_checksum(jb)
    assert set(got) == {".data['action']", ".data['done']", ".data['obs']", ".data['reward']",
                        ".pos", ".size"}


def test_state_checksum_of_shards_adds_up_to_the_whole():
    """The rank sums wrap the same as the whole: each rank's local sums (a
    world-size-1 reduction here) add up mod 2**32 to the global checksum."""
    js = _jax_rollout("engine")[0]
    whole = pmesh.state_checksum(_flagship_from_jax(js), _rank(1, 0))
    parts = [pmesh.state_checksum(pmesh.shard_env(_flagship_from_jax(js), _rank(4, r)),
                                  _rank(4, r)) for r in range(4)]
    assert {k: sum(p[k] for p in parts) % 2**32 for k in whole} == whole


# ---------------------------------------------------------------------------
# shard_env / gather_env, and the minibatch blocks of a sharded update
# ---------------------------------------------------------------------------


def _flagship_and_turbo(B):
    keys = pmesh.batch_keys(threefry.prng_key(6), B, device=CPU)
    return engine.init(keys, CFG, device=CPU), turbo.init(keys, CFG, device=CPU)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_env_slices_each_layout(world):
    fs, ts = _flagship_and_turbo(16)
    for r in range(world):
        m = _rank(world, r)
        lo, hi = m.env_slice(16)
        f_part, t_part = pmesh.shard_env(fs, m), pmesh.shard_env(ts, m)
        for k in engine.FIELDS:  # the batch leads, but the key is [2, B]
            axis = -1 if k == "key" else 0
            assert torch.equal(getattr(f_part, k), getattr(fs, k).narrow(axis, lo, hi - lo)), k
        for k in turbo.FIELDS:  # batch-minor
            assert torch.equal(getattr(t_part, k), getattr(ts, k)[..., lo:hi]), k
        obs = torch.arange(16 * 3).reshape(16, 3)
        assert torch.equal(pmesh.shard_env(obs, m), obs[lo:hi])
        assert torch.equal(pmesh.shard_env(obs.T, m, minor=True), obs.T[:, lo:hi])


_GATHER_SCRIPT = r"""
import datetime, sys, torch, torch.distributed as dist
from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import engine, turbo
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel import mesh as pmesh
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
pmesh.initialize_distributed("gloo", f"tcp://localhost:{port}", world, rank, timeout=60)
pmesh.initialize_distributed("gloo", "tcp://localhost:1", world, rank)  # a no-op once up
m = pmesh.env_mesh("cpu")
cfg = EngineConfig(auto_reset=True)
keys = pmesh.batch_keys(threefry.prng_key(6), 16, device="cpu")
for state in (engine.init(keys, cfg, device="cpu"), turbo.init(keys, cfg, device="cpu")):
    back = pmesh.gather_env(pmesh.shard_env(state, m), m)
    for k in type(state).__dataclass_fields__:
        assert torch.equal(getattr(back, k), getattr(state, k)), k
    assert pmesh.state_checksum(pmesh.shard_env(state, m), m) == pmesh.state_checksum(
        state, pmesh.EnvMesh(0, 1, torch.device("cpu")))
obs = torch.arange(64).reshape(16, 4) - 7
assert torch.equal(pmesh.gather_env(pmesh.shard_env(obs, m), m), obs)
assert torch.equal(pmesh.gather_env(pmesh.shard_env(obs.T.contiguous(), m, minor=True), m,
                                    minor=True), obs.T)
done = torch.arange(16) % 3 == 0
assert torch.equal(m.all_gather(pmesh.shard_env(done, m)), done)
lin = torch.nn.Linear(3, 2)
lin.weight.grad = torch.full_like(lin.weight, rank + 1.0)  # lin.bias has no gradient
total = m.sum_gradients(lin.parameters(), torch.tensor([10.0 * rank]))
assert torch.equal(lin.weight.grad, torch.full_like(lin.weight, 3.0))
assert torch.equal(lin.bias.grad, torch.zeros_like(lin.bias)) and total.tolist() == [10.0]
assert m.counts["all_gather"] > 0
dist.destroy_process_group()
print("ok", rank)
"""


def test_shard_then_gather_gives_back_the_state(tmp_path):
    """Two gloo ranks: :func:`gather_env` of :func:`shard_env` is the state
    again on both layouts, and the ranks' checksum is the whole state's."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _GATHER_SCRIPT, str(r), "2", str(port)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


@pytest.mark.parametrize("world", [2, 4])
def test_shard_minibatches_partition_the_global_minibatches(world):
    """Over the ranks, each global minibatch's blocks are split exactly once,
    and each rank's local block holds the global block's samples."""
    cfg = ppo.PPOConfig(rollout_len=4, update_epochs=2, n_minibatches=4, shuffle_block=8)
    T, B = 4, 64
    b = B // world
    perm_keys = ppo.epoch_keys(threefry.prng_key(9), cfg.update_epochs)[1]
    sample = torch.arange(T * B).reshape(T, B)  # the global sample index t * B + b
    block = ppo.shuffle_block(cfg, T * B)
    # the unsharded minibatches, as sample indices
    traj = ppo.Transition(*(sample,) * 6)
    want = [mb[0].obs for mb in ppo.minibatches(traj, sample.float(), sample.float(), cfg,
                                                perm_keys)]
    got = [[] for _ in want]
    for r in range(world):
        m = _rank(world, r)
        lo, hi = m.env_slice(B)
        local = sample[:, lo:hi].reshape(-1, block)
        for j, idx in enumerate(ppo.shard_minibatches(b, T, cfg, perm_keys, m)):
            got[j].append(local[torch.from_numpy(idx)].reshape(-1))
    for j, w in enumerate(want):
        assert torch.equal(torch.sort(torch.cat(got[j])).values, torch.sort(w).values), j


def test_uneven_block_split_raises():
    cfg = ppo.PPOConfig(rollout_len=4, update_epochs=1, n_minibatches=2, shuffle_block=8)
    with pytest.raises(ValueError, match="do not tile"):
        ppo.shard_minibatches(12, 4, cfg, [threefry.prng_key(0)], _rank(2, 0))
