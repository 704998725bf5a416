"""The port's utilities against the JAX package's, on the CPU.

* ``utils/checkpoint.py:save``/``restore``: mirrors of ``tests/test_utils.py
  :12-33`` (the flagship env state round-trips; a resumed episode continues
  as it would have, and as JAX's does after the same actions and key), and
  whole training states: PPO's and the DQN's (networks, optimizers, the
  replay buffer, ``uint32`` keys, bf16 weights) round-trip exactly, and a
  resumed PPO step equals one taken without stopping;
* the public names the port lacked (``rng.seed_key``/``uniform``,
  ``bitboard.drop_distance``/``ROW_BITS``, ``turbo.unpack_playfield``/
  ``jit_step``/``jit_init``, ``turbo_grouped.jit_step``/``jit_reset``,
  ``engine.init_state``, the queue aliases), each held to JAX's function on
  seeded inputs: integer results and draws equal, bit for bit;
* ``utils/metrics.py``, ``utils/profiling.py``, and that the new modules
  import nothing of JAX.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import typing
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.core import engine as jengine
from tetris_gymnasium_tpu.core import turbo as jturbo
from tetris_gymnasium_tpu.core import turbo_grouped as jturbo_grouped
from tetris_gymnasium_tpu.ops import bitboard as jbb
from tetris_gymnasium_tpu.ops import queue as jqueue
from tetris_gymnasium_tpu.ops import rng as jrng

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import engine, turbo, turbo_grouped
from tetris_gymnasium_torch.models.networks import ActorCriticCNN, QNetworkCNN
from tetris_gymnasium_torch.ops import bitboard as bb
from tetris_gymnasium_torch.ops import queue as oqueue
from tetris_gymnasium_torch.ops import rng
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.rl import dqn, ppo
from tetris_gymnasium_torch.utils import checkpoint, metrics, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields_equal(a, b, what=""):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f.name)
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.uint32 else x,
                           y.view(torch.int32) if y.dtype == torch.uint32 else y), (what, f.name)


def _engine_equals_jax(state, jstate, what=""):
    """A port flagship state (a batch of one) equals a JAX per-env state."""
    for f in dataclasses.fields(state):
        got = getattr(state, f.name)
        got = got[:, 0] if f.name == "key" else got[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jstate, f.name)),
                                      err_msg=f"{what} {f.name}")


# ---------------------------------------------------------------------------
# Whole-state checkpoints: mirrors of tests/test_utils.py:12-33
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_env_state(tmp_path):
    """The flagship env state round-trips exactly, and is JAX's ``init_state``."""
    cfg = EngineConfig()
    state = engine.init_state(prng_key(0), cfg, device=CPU)
    _engine_equals_jax(state, jengine.init_state(jax.random.PRNGKey(0), JEngineConfig()))
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, state)
    template = engine.init_state(prng_key(9), cfg, device=CPU)
    restored = checkpoint.restore(path, template)
    assert restored.key.dtype == torch.uint32 and restored.key.shape == (2, 1)
    _fields_equal(restored, state)


def test_checkpoint_resume_continues_identically(tmp_path):
    """Restore-and-replay gives the same trajectory as never stopping, and
    JAX's after the same actions from the same key."""
    cfg = EngineConfig(gravity_enabled=False)
    step = engine.jit_step(cfg, obs="board")
    jcfg = JEngineConfig(gravity_enabled=False)
    jstep = jengine.jit_step(jcfg, obs="board")
    s = engine.init_state(prng_key(1), cfg, device=CPU)
    js = jengine.init_state(jax.random.PRNGKey(1), jcfg)
    for a in (0, 1, 5, 3):
        s, *_ = step(s, torch.tensor([a], dtype=torch.int32))
        js, *_ = jstep(js, jnp.int32(a))

    path = str(tmp_path / "ckpt")
    checkpoint.save(path, s)
    s2 = checkpoint.restore(path, engine.init_state(prng_key(2), cfg, device=CPU))

    for a in (5, 5, 2, 4):
        s, *_ = step(s, torch.tensor([a], dtype=torch.int32))
        s2, *_ = step(s2, torch.tensor([a], dtype=torch.int32))
        js, *_ = jstep(js, jnp.int32(a))
    assert torch.equal(s.board, s2.board)
    assert float(s.score[0]) == float(s2.score[0])
    _engine_equals_jax(s2, js, "resumed")


@pytest.fixture(scope="module")
def ppo_run():
    """A small PPO on the turbo engine: the state after one train step, and the step."""
    ec = EngineConfig(width=6, height=8, auto_reset=True)
    cfg = ppo.PPOConfig(rollout_len=4, update_epochs=1, n_minibatches=2)
    net = ActorCriticCNN(board_shape=(8, 6), dtype=torch.float32)
    ts = ppo.init_train_state(prng_key(1), 8, ec, cfg, net=net, device=CPU)
    step = ppo.make_train_step(ec, cfg)
    ts, _ = step(ts)
    return ec, cfg, ts, step


def _fresh_ppo(ec, cfg, seed):
    net = ActorCriticCNN(board_shape=(8, 6), dtype=torch.float32)
    return ppo.init_train_state(prng_key(seed), 8, ec, cfg, net=net, device=CPU)


def test_ppo_state_roundtrips_exactly(ppo_run, tmp_path):
    ec, cfg, ts, _ = ppo_run
    checkpoint.save(str(tmp_path / "ts"), ts)
    back = checkpoint.restore(str(tmp_path / "ts"), _fresh_ppo(ec, cfg, 5))
    np.testing.assert_array_equal(back.key, ts.key)
    assert back.key.dtype == np.uint32 and back.update_i == ts.update_i == 1
    _fields_equal(back.env_states, ts.env_states)
    assert torch.equal(back.last_obs, ts.last_obs)
    for a, b in zip(back.net.state_dict().values(), ts.net.state_dict().values()):
        assert torch.equal(a, b)
    assert back.optimizer.count == ts.optimizer.count == cfg.update_epochs * cfg.n_minibatches
    sa, sb = back.optimizer.adam.state_dict(), ts.optimizer.adam.state_dict()
    assert sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
    for i, st in sb["state"].items():
        for k, v in st.items():
            assert torch.equal(sa["state"][i][k], v), (i, k)


def test_resumed_ppo_step_equals_unbroken(ppo_run, tmp_path):
    """A PPO train step from a restored state is bit-equal to the same step
    taken without stopping: env batch, parameters, Adam moments, metrics."""
    ec, cfg, ts, step = ppo_run
    checkpoint.save(str(tmp_path / "ts"), ts)
    resumed = checkpoint.restore(str(tmp_path / "ts"), _fresh_ppo(ec, cfg, 7))
    a, ma = step(ts)
    b, mb = step(resumed)
    _fields_equal(a.env_states, b.env_states)
    np.testing.assert_array_equal(a.key, b.key)
    for x, y in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(x, y)
    for st_a, st_b in zip(a.optimizer.adam.state.values(), b.optimizer.adam.state.values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(st_a[k], st_b[k]), k
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}


@pytest.mark.parametrize("K", [1, 4])
def test_dqn_state_roundtrips_exactly(K, tmp_path):
    """A DQN state after a few steps: both networks, ``torch.optim.Adam``,
    the replay buffer (positions and stores) and the env batch."""
    ec = EngineConfig(width=6, height=8, auto_reset=True)
    cfg = dqn.DQNConfig(frame_stack=K, buffer_size=64, batch_size=16, learning_starts=3,
                        target_update_every=4, exploration_steps=10)

    def fresh(seed):
        net = QNetworkCNN(in_channels=K, board_shape=(8, 6), dtype=torch.float32)
        return dqn.init_dqn_state(prng_key(seed), 8, ec, cfg, net=net, device=CPU)

    step = dqn.make_train_step(ec, cfg)
    ts = fresh(0)
    for _ in range(5):
        ts, _ = step(ts)
    checkpoint.save(str(tmp_path / "dqn"), ts)
    back = checkpoint.restore(str(tmp_path / "dqn"), fresh(3))
    assert (back.step, back.buffer.pos, back.buffer.size) == (ts.step, ts.buffer.pos, ts.buffer.size)
    np.testing.assert_array_equal(back.key, ts.key)
    for k, v in ts.buffer.data.items():
        assert torch.equal(back.buffer.data[k], v), k
    _fields_equal(back.env_states, ts.env_states)
    for net in ("net", "target_net"):
        for a, b in zip(getattr(back, net).parameters(), getattr(ts, net).parameters()):
            assert torch.equal(a, b), net
    for a, b in zip(back.optimizer.state.values(), ts.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in b)
    a, ma = step(ts)
    b, mb = step(back)
    assert float(ma["loss"]) == float(mb["loss"])
    _fields_equal(a.env_states, b.env_states)


class _Pair(NamedTuple):
    left: object
    right: object


def test_tree_leaves_and_containers_roundtrip(tmp_path):
    """bf16 weights, ``uint32``/``uint16`` tensors, numpy scalars, int dict
    keys, tuples, named tuples, None, strings and a generator's state."""
    torch.manual_seed(0)
    net = torch.nn.Linear(3, 2).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    tree = {
        "net": net,
        "u32": torch.tensor([0, 1, 2**31, 2**32 - 1], dtype=torch.int64).to(torch.uint32),
        "u16": torch.tensor([0, 65535], dtype=torch.int32).to(torch.uint16),
        "bf16": torch.randn(5).to(torch.bfloat16),
        "np": (np.uint32(7), np.arange(4, dtype=np.int8), np.float32(0.1)),
        3: [None, "s", 1.5, True, 2],
        "pair": _Pair(torch.zeros(2, 3), {7: "x"}),
        "gen": gen,
    }
    torch.rand(3, generator=gen)
    want = torch.randint(0, 1000, (4,), generator=torch.Generator().set_state(gen.get_state()))
    checkpoint.save(str(tmp_path / "t"), tree)
    spec = json.load(open(tmp_path / "t" / checkpoint.TREE_FILE))
    assert spec["dict"][1][2]["tensor"] == "uint32"
    template = {
        "net": torch.nn.Linear(3, 2).to(torch.bfloat16),
        "u32": torch.zeros(4, dtype=torch.uint32),
        "u16": torch.zeros(2, dtype=torch.uint16),
        "bf16": torch.zeros(5, dtype=torch.bfloat16),
        "np": (np.uint32(0), np.zeros(4, np.int8), np.float32(0)),
        3: [None, "", 0.0, False, 0],
        "pair": _Pair(torch.ones(2, 3), {7: ""}),
        "gen": torch.Generator(),
    }
    out = checkpoint.restore(str(tmp_path / "t"), template)
    assert out["net"] is template["net"] and out["net"].weight.dtype == torch.bfloat16
    assert torch.equal(out["net"].weight, net.weight) and torch.equal(out["net"].bias, net.bias)
    assert out["u32"].dtype == torch.uint32
    assert out["u32"].to(torch.int64).tolist() == [0, 1, 2**31, 2**32 - 1]
    assert out["u16"].to(torch.int32).tolist() == [0, 65535]
    assert torch.equal(out["bf16"], tree["bf16"])
    assert type(out["np"][0]) is np.uint32 and out["np"][0] == 7 and type(out["np"]) is tuple
    np.testing.assert_array_equal(out["np"][1], np.arange(4))
    assert out["np"][2] == np.float32(0.1)
    assert out[3] == [None, "s", 1.5, True, 2]
    assert isinstance(out["pair"], _Pair) and out["pair"].right == {7: "x"}
    assert torch.equal(out["pair"].left, torch.zeros(2, 3))
    assert torch.equal(torch.randint(0, 1000, (4,), generator=out["gen"]), want)


@pytest.mark.parametrize("change, where", [
    (lambda t: t.update({"a": torch.zeros(3)}), r"tree\['a'\]: saved shape \[2\]"),
    (lambda t: t.update({"b": [1, 2, 3]}), r"tree\['b'\]: saved length 2"),
    (lambda t: t.pop("c"), "saved keys"),
    (lambda t: t.update({"c": {"d": np.zeros(2)}}), r"tree\['c'\]\['d'\]: the template holds a numpy"),
    (lambda t: t.update({"n": torch.nn.Linear(2, 3)}), r"tree\['n'\]"),
])
def test_restore_raises_naming_the_path(change, where, tmp_path):
    tree = {"a": torch.zeros(2), "b": [1, 2], "c": {"d": torch.zeros(2)}, "n": torch.nn.Linear(3, 2)}
    checkpoint.save(str(tmp_path / "t"), tree)
    template = {"a": torch.zeros(2), "b": [1, 2], "c": {"d": torch.zeros(2)}, "n": torch.nn.Linear(3, 2)}
    change(template)
    with pytest.raises(ValueError, match=where):
        checkpoint.restore(str(tmp_path / "t"), template)


def test_save_writes_no_pickle(tmp_path):
    checkpoint.save(str(tmp_path / "t"), {"x": torch.arange(3), "opt": torch.optim.Adam(
        [torch.nn.Parameter(torch.ones(2))])})
    assert sorted(os.listdir(tmp_path / "t")) == [checkpoint.LEAVES_FILE, checkpoint.TREE_FILE]
    with np.load(tmp_path / "t" / checkpoint.LEAVES_FILE, allow_pickle=False) as data:
        assert all(data[k].dtype != object for k in data.files)


# ---------------------------------------------------------------------------
# The public names, each against JAX's function
# ---------------------------------------------------------------------------


def test_seed_key_and_uniform_match_jax():
    for w0, w1 in ((0, 0), (5, 9), (2**32 - 1, 123456789)):
        key = rng.seed_key(w0, w1)
        np.testing.assert_array_equal(key.numpy(), np.asarray(jrng.seed_key(w0, w1)))
        for shape in ((), (3,), (2, 5)):
            k2, u = rng.uniform(key, shape)
            jk, ju = jrng.uniform(jrng.seed_key(w0, w1), shape)
            assert u.dtype == torch.float32 and tuple(u.shape) == shape
            np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
            np.testing.assert_array_equal(k2.numpy(), np.asarray(jk))


def _random_board(seed, fill, H, W):
    r = np.random.default_rng(seed)
    board = np.zeros((H, W), dtype=np.int8)
    board[:, :4] = 1
    board[:, -4:] = 1
    board[-4:, :] = 1
    inner = r.random((H - 4, W - 8)) < fill
    inner[: (H - 4) // 2] = False  # a clear top half so pieces fall
    board[: H - 4, 4 : W - 4] = np.where(inner, 2, 0)
    return board


@pytest.mark.parametrize("seed, fill", [(3, 0.3), (4, 0.6)])
def test_drop_distance_matches_jax(seed, fill):
    """``drop_distance`` on random boards (as ``tests/test_bitboard.py:86``),
    every piece and rotation, batched against JAX's per-env call."""
    HP, WP = 24, 18
    board = _random_board(seed, fill, HP, WP)
    jrows = jbb.pack_board(jnp.asarray(board))
    r = np.random.default_rng(seed + 100)
    cases = [(p, rot, int(r.integers(0, WP - 3)), int(r.integers(0, HP)))
             for p in range(7) for rot in range(4) for _ in range(6)]
    p, rot, x, y = (torch.tensor(c, dtype=torch.int32) for c in zip(*cases))
    rows = bb.pack_board(torch.from_numpy(board)[None].expand(len(cases), -1, -1))
    got = bb.drop_distance(rows, bb.piece_row_bits(bb.ROW_BITS, p, rot), x, y, WP)
    want = [int(jbb.drop_distance(jrows, jbb.piece_row_bits(jbb.ROW_BITS, jnp.int32(c[0]),
                                                             jnp.int32(c[1])),
                                  jnp.int32(c[2]), jnp.int32(c[3]), WP)) for c in cases]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(bb.ROW_BITS, np.asarray(jbb.ROW_BITS))


@pytest.mark.parametrize("geo", [dict(), dict(width=30, height=12)], ids=["10x20", "30x12"])
def test_unpack_playfield_matches_jax(geo):
    """Single- and multi-word rows, one and two batch axes (reversed to the front)."""
    cfg, jcfg = EngineConfig(**geo), JEngineConfig(**geo)
    B = 5
    s = turbo.init(batch_keys(prng_key(3), B, device=CPU), cfg, device=CPU)
    step = turbo.jit_step(cfg)
    g = np.random.default_rng(0)
    for _ in range(30):
        s, *_ = step(s, torch.from_numpy(g.integers(0, 8, B).astype(np.int32)))
    for rows in (s.rows, s.rows.reshape(s.rows.shape[:-1] + (1, B))):
        got = turbo.unpack_playfield(rows, cfg, torch.int8)
        want = np.asarray(jturbo.unpack_playfield(jnp.asarray(rows.numpy()), jcfg, jnp.int8))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_turbo_entry_points_match_jax():
    """``turbo.jit_init``/``jit_step`` and ``turbo_grouped.jit_reset``/
    ``jit_step`` against JAX's, 12 steps of 6 envs from the same keys."""
    cfg = EngineConfig(width=6, height=8, auto_reset=True)
    jcfg = JEngineConfig(width=6, height=8, auto_reset=True)
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(2), i)) for i in range(6)])
    s = turbo.jit_init(cfg, CPU)(keys)
    js = jturbo.jit_init(jcfg)(jnp.asarray(keys))
    gs, gobs = turbo_grouped.jit_reset(cfg, device=CPU)(keys)
    jgs, jgobs = jturbo_grouped.jit_reset(jcfg)(jnp.asarray(keys))
    np.testing.assert_array_equal(gobs.numpy(), np.asarray(jgobs))
    g = np.random.default_rng(1)
    for i in range(12):
        a = g.integers(0, 8, 6).astype(np.int32)
        s, _, r, d, _ = turbo.jit_step(cfg)(s, torch.from_numpy(a))
        js, _, jr, jd, _ = jturbo.jit_step(jcfg)(js, jnp.asarray(a))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        for f in turbo.FIELDS:
            np.testing.assert_array_equal(getattr(s, f).numpy(), np.asarray(getattr(js, f)),
                                          err_msg=f"step {i} {f}")
        ga = g.integers(0, turbo_grouped.n_actions(cfg), 6).astype(np.int32)
        gs, gobs, gr, _, _ = turbo_grouped.jit_step(cfg)(gs, torch.from_numpy(ga))
        jgs, jgobs, jgr, _, _ = jturbo_grouped.jit_step(jcfg)(jgs, jnp.asarray(ga))
        np.testing.assert_array_equal(gobs.numpy(), np.asarray(jgobs), err_msg=f"grouped {i}")
        np.testing.assert_array_equal(gr.numpy(), np.asarray(jgr))
    assert turbo.jit_step(cfg) is turbo.jit_step(cfg)


def test_queue_aliases_match_jax():
    """``CreateQueueFn`` and ``NextPieceFn`` type ``QueueFns`` with JAX's arities."""
    assert typing.get_type_hints(oqueue.QueueFns) == {"create": oqueue.CreateQueueFn,
                                                      "next_piece": oqueue.NextPieceFn}
    for name in ("CreateQueueFn", "NextPieceFn"):
        port, ref = getattr(oqueue, name), getattr(jqueue, name)
        assert len(typing.get_args(port)[0]) == len(typing.get_args(ref)[0])
        assert len(typing.get_args(typing.get_args(port)[1])) == \
            len(typing.get_args(typing.get_args(ref)[1]))


# ---------------------------------------------------------------------------
# Metrics, profiling, and no JAX in the new modules
# ---------------------------------------------------------------------------


def test_sps_meter_windows():
    m = metrics.SpsMeter(steps_per_call=8, report_every=3)
    assert m.tick() is None and m.tick() is None
    sps = m.tick()
    assert sps is not None and sps > 0 and m.tick() is None and m.lifetime_sps > 0


def test_scalar_logger_falls_back_to_stdout(monkeypatch, capsys, tmp_path):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # forces ImportError
    log = metrics.ScalarLogger(str(tmp_path))
    log.log("loss", 0.25, 3)
    log.close()
    assert "[3] loss=0.25" in capsys.readouterr().out
    metrics.ScalarLogger(None).log("x", 1.0, 0)
    assert "[0] x=1" in capsys.readouterr().out


def test_profiling_on_the_cpu(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("tetris_region"):
            torch.ones(64).sum()
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "tetris_region" for e in events)
    stats = profiling.time_fn(lambda: torch.ones(8) * 2, repeats=3, warmup=1)
    assert set(stats) == {"mean_s", "best_s", "calls_per_s"} and stats["best_s"] <= stats["mean_s"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.save_device_memory_profile(str(tmp_path / "mem.pickle"))


NEW_MODULES = ("utils/checkpoint.py", "utils/video.py", "utils/tracking.py", "utils/metrics.py",
               "utils/profiling.py", "utils/__init__.py", "examples/evaluate_checkpoint.py",
               "examples/record_video.py", "examples/play_random.py",
               "examples/play_interactive.py")


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_new_modules_import_no_jax(rel):
    """No import of JAX, its libraries or the JAX package in the source."""
    path = os.path.join(REPO, "tetris_gymnasium_torch", rel)
    for node in ast.walk(ast.parse(open(path).read())):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
            [node.module or ""] if isinstance(node, ast.ImportFrom) else []
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "optax", "tetris_gymnasium_tpu"), n


def test_new_modules_load_no_jax_at_run_time():
    """A fresh interpreter that imports every new module has loaded no JAX."""
    mods = ", ".join("tetris_gymnasium_torch." + rel[:-3].replace("/", ".").removesuffix(".__init__")
                     for rel in NEW_MODULES)
    code = (f"import sys, {mods}; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'tetris_gymnasium_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# the JAX package's public names with no counterpart in the port: XLA's compile
# cache and the jax.sharding builders (ROADMAP.md queue 1 gives the reasons)
NO_COUNTERPART = {
    "utils/compilation.py": {"enable_persistent_cache"},
    "parallel/mesh.py": {"env_sharding", "replicated", "batch_minor_shardings",
                         "train_state_shardings", "dqn_state_shardings"},
}


def _top_level_names(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            found = set()
            for node in ast.parse(open(path).read()).body:
                if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                    found.add(node.name)
                elif isinstance(node, ast.Assign):
                    found.update(t.id for t in node.targets if isinstance(t, ast.Name))
            out[os.path.relpath(path, root)] = {n for n in found if not n.startswith("_")}
    return out


def test_every_public_jax_name_has_a_counterpart():
    """A diff of the top-level public names of every module of the two
    packages finds only the names known to have no counterpart."""
    jax_names = _top_level_names(os.path.join(REPO, "tetris_gymnasium_tpu"))
    port_names = _top_level_names(os.path.join(REPO, "tetris_gymnasium_torch"))
    missing = {rel: names - port_names.get(rel, set()) for rel, names in jax_names.items()}
    assert {rel: m for rel, m in missing.items() if m} == NO_COUNTERPART
