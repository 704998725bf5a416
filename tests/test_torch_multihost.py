"""Real multi-process runs of the port's launcher, held to the JAX package's.

Mirrors ``tests/test_multihost.py``.  Each cluster is W processes of
``python -m tetris_gymnasium_torch.parallel.launch --backend cpu`` (gloo on
CPU tensors, one torch thread each) joined through a ``tcp://localhost``
rendezvous; JAX's ``launch.run``, ``run_ppo`` and ``run_dqn`` on the
suite's 8-device virtual mesh are the oracle, run once for the module while
the clusters run.  The PPO and DQN oracles run JAX's own functions with
their networks in float32 (the parity rule of ``ROADMAP.md``; bf16 trunks
round differently in XLA and PyTorch), and the port's clusters start from
the JAX oracle's initial weights, written to an ``.npz``:

* the rollout at W = 1, 2 and 4: checksums, Σreward and Σdone equal JAX's
  on every rank;
* PPO (3 iterations) and DQN (4 iterations) at W = 2: env-state and
  replay-buffer checksums equal JAX's on both ranks, the losses within
  JAX's own bound (``rtol=1e-4, atol=1e-6``), both ranks' parameter
  checksums equal;
* PPO on the turbo engine: the same env checksum at W = 1 and W = 2;
* the entry point without a coordinator, the default backend without a
  card, and a group that cannot form.
"""
import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.models import networks as jnetworks
from tetris_gymnasium_tpu.parallel import launch as jlaunch
from tetris_gymnasium_tpu.parallel import mesh as jmesh
from tetris_gymnasium_tpu.rl import dqn as jdqn
from tetris_gymnasium_tpu.rl import ppo as jppo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ENVS = 64
HORIZON = 16
REPEATS = 2
PPO_ITERS, DQN_ITERS = 3, 4
TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


class Cluster:
    """W launcher processes started together; :meth:`results` waits for
    them (killing every one on a failure or timeout) and returns each
    rank's metrics JSON."""

    def __init__(self, world, out_dir, tag, *args):
        port = _free_port()
        self.outs = [out_dir / f"{tag}_rank{r}.json" for r in range(world)]
        self.procs = [
            subprocess.Popen(
                [sys.executable, "-m", "tetris_gymnasium_torch.parallel.launch",
                 "--backend", "cpu", "--coordinator", f"localhost:{port}",
                 "--num-processes", str(world), "--process-id", str(r), "--timeout", "120",
                 "--n-envs", str(N_ENVS), "--out", str(out), *args],
                cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            for r, out in enumerate(self.outs)]
        self._results = None

    def results(self):
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=TIMEOUT_S)[0])
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()  # the processes this test started
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, f"rank exited {p.returncode}:\n{log[-4000:]}"
            self._results = [json.loads(o.read_text()) for o in self.outs]
        return self._results


def _flat(params):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every cluster of the module, started at once; then the JAX oracles
    computed while they run."""
    tmp = tmp_path_factory.mktemp("clusters")
    ac = functools.partial(jppo.ActorCriticCNN, dtype=jnp.float32)
    qn = functools.partial(jnetworks.QNetworkCNN, dtype=jnp.float32)
    cfg = JEngineConfig(auto_reset=True)
    # the JAX oracle's initial weights, as launch.run_ppo and run_dqn draw them
    pcfg = jppo.PPOConfig(rollout_len=8, update_epochs=1, n_minibatches=2, shuffle_block=8)
    ts = jppo.init_train_state(jax.random.PRNGKey(0), N_ENVS, cfg, pcfg, ac(), impl="flagship")
    np.savez(tmp / "ppo_init.npz", **_flat(ts.params))
    dcfg = jdqn.DQNConfig(buffer_size=N_ENVS * 8, batch_size=32, learning_starts=2,
                          target_update_every=4, exploration_steps=DQN_ITERS)
    ds = jdqn.init_dqn_state(jax.random.PRNGKey(0), N_ENVS, cfg, dcfg, qn(), impl="flagship")
    np.savez(tmp / "dqn_init.npz", **_flat(ds.params))

    rollout = ("--horizon", str(HORIZON), "--repeats", str(REPEATS))
    f32_args = ("--dtype", "float32")
    clusters = {
        **{f"rollout{w}": Cluster(w, tmp, f"rollout{w}", *rollout) for w in (1, 2, 4)},
        "ppo2": Cluster(2, tmp, "ppo2", "--train", "ppo", "--train-iters", str(PPO_ITERS),
                        *f32_args, "--init-params", str(tmp / "ppo_init.npz")),
        "dqn2": Cluster(2, tmp, "dqn2", "--train", "dqn", "--train-iters", str(DQN_ITERS),
                        *f32_args, "--init-params", str(tmp / "dqn_init.npz")),
        **{f"turbo{w}": Cluster(w, tmp, f"turbo{w}", "--train", "ppo", "--impl", "turbo",
                                "--train-iters", str(PPO_ITERS), *f32_args) for w in (1, 2)},
    }
    try:
        mesh = jmesh.env_mesh()
        oracle = {"rollout": jlaunch.run(mesh, cfg, N_ENVS, HORIZON, REPEATS)}
        mp = pytest.MonkeyPatch()
        with mp.context() as m:  # JAX's run_ppo and run_dqn with float32 networks
            m.setattr(jppo, "ActorCriticCNN", ac)
            m.setattr(jnetworks, "QNetworkCNN", qn)
            oracle["ppo"] = jlaunch.run_ppo(mesh, cfg, N_ENVS, PPO_ITERS)
            oracle["dqn"] = jlaunch.run_dqn(mesh, cfg, N_ENVS, DQN_ITERS)
        yield {"oracle": oracle, "clusters": clusters}
    finally:
        for c in clusters.values():
            for p in c.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.mark.parametrize("world", [1, 2, 4])
def test_rollout_cluster_matches_jax(world, runs):
    results = runs["clusters"][f"rollout{world}"].results()
    ref = runs["oracle"]["rollout"]
    assert ref["sum_done"] > 0
    for rank, r in enumerate(results):
        assert (r["process_index"], r["process_count"], r["n_devices"]) == (rank, world, world)
        assert r["backend"] == "gloo"
        assert r["checksum"] == ref["checksum"], f"W={world} rank {rank}"
        assert (r["sum_reward"], r["sum_done"]) == (ref["sum_reward"], ref["sum_done"])
        # one all_reduce of the sums a rollout (warm-up + repeats), one for the checksum
        assert r["collectives"] == {"all_reduce": REPEATS + 2, "all_gather": 0}


def test_ppo_cluster_matches_jax(runs):
    results = runs["clusters"]["ppo2"].results()
    ref = runs["oracle"]["ppo"]
    for r in results:
        assert r["process_count"] == 2
        assert r["env_checksum"] == ref["env_checksum"], "2-rank PPO played other trajectories"
        np.testing.assert_allclose(r["pg_losses"], ref["pg_losses"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r["final_entropy"], ref["final_entropy"], rtol=1e-4, atol=1e-6)
    assert results[0]["param_checksum"] == results[1]["param_checksum"], "the replicas drifted"
    assert results[0]["pg_losses"] == results[1]["pg_losses"]


def test_dqn_cluster_matches_jax(runs):
    results = runs["clusters"]["dqn2"].results()
    ref = runs["oracle"]["dqn"]
    for r in results:
        assert r["env_checksum"] == ref["env_checksum"], "2-rank DQN played other trajectories"
        assert r["buffer_checksum"] == ref["buffer_checksum"], "the replicated replay diverged"
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r["mean_q"], ref["mean_q"], rtol=1e-4, atol=1e-6)
        # each step gathers its 4 transition fields; learning steps reduce the gradient
        assert r["collectives"]["all_gather"] == 4 * DQN_ITERS
    assert results[0]["param_checksum"] == results[1]["param_checksum"], "the replicas drifted"
    assert results[0]["losses"][-1] > 0


def test_turbo_ppo_is_the_same_at_one_and_two_ranks(runs):
    one = runs["clusters"]["turbo1"].results()
    two = runs["clusters"]["turbo2"].results()
    assert one[0]["env_checksum"] == two[0]["env_checksum"] == two[1]["env_checksum"]
    np.testing.assert_allclose(two[0]["pg_losses"], one[0]["pg_losses"], rtol=1e-4, atol=1e-6)
    assert two[0]["param_checksum"] == two[1]["param_checksum"]


def _launch(*args, timeout=TIMEOUT_S):
    return subprocess.run(
        [sys.executable, "-m", "tetris_gymnasium_torch.parallel.launch", *args], cwd=REPO,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=timeout)


def test_launch_single_process_entrypoint(tmp_path, runs):
    out = tmp_path / "single.json"
    res = _launch("--backend", "cpu", "--n-envs", str(N_ENVS), "--horizon", str(HORIZON),
                  "--repeats", str(REPEATS), "--out", str(out))
    assert res.returncode == 0, res.stdout[-4000:]
    assert "single-process run" in res.stdout and "env-steps/s" in res.stdout
    metrics = json.loads(out.read_text())
    assert (metrics["n_devices"], metrics["process_count"], metrics["backend"]) == (1, 1, None)
    assert metrics["checksum"] == runs["oracle"]["rollout"]["checksum"]


def test_launcher_defaults_to_the_card():
    """``--backend auto`` (the default) is NCCL on a card a rank: without a
    card it raises instead of running on the CPU."""
    res = _launch("--n-envs", "8", "--horizon", "1", "--repeats", "1", timeout=120)
    assert res.returncode != 0
    assert "has none of 0" in res.stdout


def test_a_group_that_cannot_form_fails():
    """A rank whose peer never comes fails at start-up; it does not run alone."""
    res = _launch("--backend", "cpu", "--coordinator", f"localhost:{_free_port()}",
                  "--num-processes", "2", "--process-id", "0", "--timeout", "3",
                  "--n-envs", "8", "--horizon", "1", "--repeats", "1", timeout=120)
    assert res.returncode != 0
    assert "env-steps/s" not in res.stdout and "single-process" not in res.stdout
