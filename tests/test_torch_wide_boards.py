"""Wide boards and other geometries on the port's engines, against JAX, on the CPU.

Mirrors the engine cases of ``tests/test_wide_boards.py``: the four
``WIDE_CONFIGS`` (padded widths 38, 38, 69 and 36, the last with bit 31 of
word 0 in the playfield) play 120 random steps on 8 envs in the port's
turbo engine (rows ``uint32[H, NW, B]``) and its flagship engine, each
field for field against the JAX engine of the same kind; the turbo board
observation at 30x20; the eight engineered line clears whose gaps straddle
the word boundary; ``TetrisVectorEnv`` at width 30 on both engines against
the JAX adapter.  Beside them: the 6x6 oversize piece set on both engines
at widths 10 and 30 (``tests/test_components.py:221-330``), whose packed
piece table takes two words, and the Gymnasium shell playing a scripted
game at width 30.  Integers are bit-equal, scores ``assert_allclose`` at
JAX's own tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.components.tetromino import Tetromino as JTetromino
from tetris_gymnasium_tpu.components.tetromino import pieces_from_tetrominoes as jpieces_from
from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.core import engine as jengine
from tetris_gymnasium_tpu.core import turbo as jturbo
from tetris_gymnasium_tpu.envs.vector_env import TetrisVectorEnv as JTetrisVectorEnv
from tetris_gymnasium_tpu.parallel.mesh import batch_keys as jbatch_keys

from tetris_gymnasium_torch.components.tetromino import Tetromino, pieces_from_tetrominoes
from tetris_gymnasium_torch.config import ActionsMapping, EngineConfig
from tetris_gymnasium_torch.core import engine, turbo
from tetris_gymnasium_torch.envs import TetrisVectorEnv
from tetris_gymnasium_torch.ops import bitboard as bb
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys

CPU = "cpu"
A = ActionsMapping()

WIDE_CONFIGS = [
    dict(width=30, height=20, auto_reset=True),
    dict(width=30, height=20, gravity_enabled=False),
    dict(width=61, height=12, queue_size=3, auto_reset=True),
    dict(width=28, height=14, auto_reset=True),  # word-0 bit 31 in play
]
WIDE_IDS = ["wide-30x20", "wide-30x20-nograv", "wide-61x12", "wide-28x14"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oversize_sets():
    """The 6x6-box set of ``tests/test_components.py:221``, in both packages."""
    shapes = [((255, 0, 0), np.array([[1, 1], [1, 1]], np.uint8)),
              ((0, 255, 0), np.ones((1, 6), np.uint8)),  # 6-wide I
              ((0, 0, 255), np.array([[0, 1, 0], [1, 1, 1], [0, 0, 0]], np.uint8))]
    mine, pad = pieces_from_tetrominoes([Tetromino(2 + i, c, m) for i, (c, m) in enumerate(shapes)])
    theirs, jpad = jpieces_from([JTetromino(2 + i, c, m) for i, (c, m) in enumerate(shapes)])
    assert pad == jpad == 6 and int(mine.box.max()) == 6
    return mine, theirs, pad


def _jax_flagship_for(jc, pieces):
    kw = {} if pieces is None else {"pieces": pieces}
    init = jax.jit(jax.vmap(functools.partial(jengine.init_state, config=jc, **kw)))
    step = jax.jit(jax.vmap(functools.partial(jengine.step, config=jc, obs_fn=lambda s, c, p: (),
                                              **kw)))
    return init, step


_jax_flagship = functools.lru_cache(maxsize=None)(lambda jc: _jax_flagship_for(jc, None))


def _assert_turbo_equal(ts, js, where):
    for k in turbo.FIELDS:
        got, want = getattr(ts, k), np.asarray(getattr(js, k))
        if k == "score":
            np.testing.assert_allclose(got.numpy(), want, err_msg=f"score @ {where}")
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{k} @ {where}")
        assert got.shape == want.shape, f"{k} shape @ {where}"


def _assert_flagship_equal(es, js, where):
    for k in engine.FIELDS:
        got, want = getattr(es, k).numpy(), np.asarray(getattr(js, k))
        if k == "key":
            got = got.T
        if k == "score":
            np.testing.assert_allclose(got, want, err_msg=f"score @ {where}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{k} @ {where}")


def _assert_outputs_equal(got, want, where):
    (r, d, lines), (jr, jd, jlines) = got, want
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), err_msg=f"reward @ {where}")
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd), err_msg=f"done @ {where}")
    np.testing.assert_array_equal(lines.numpy(), np.asarray(jlines), err_msg=f"lines @ {where}")


def _turbo_from_jax(js) -> turbo.TurboState:
    return turbo.TurboState(**{k: torch.from_numpy(np.array(getattr(js, k))) for k in turbo.FIELDS})


def _flagship_from_jax(js) -> engine.EngineState:
    fields = {k: torch.from_numpy(np.array(getattr(js, k))) for k in engine.FIELDS}
    fields["key"] = fields["key"].T.contiguous()
    return engine.EngineState(**fields)


@pytest.mark.parametrize("kw", WIDE_CONFIGS, ids=WIDE_IDS)
def test_turbo_trajectory_matches_jax_wide(kw):
    """120 random steps, 8 envs: every field of the port's turbo engine equal
    to the JAX turbo engine's, and its rows to the JAX flagship's board."""
    B, T = 8, 120
    jc, tc = JEngineConfig(**kw), EngineConfig(**kw)
    keys = jbatch_keys(jax.random.PRNGKey(3), B)
    js = jturbo.init(keys, jc)
    jes = _jax_flagship(jc)[0](keys)
    ts = turbo.init(batch_keys(threefry.prng_key(3), B, device=CPU), tc, device=CPU)
    assert ts.rows.shape == (tc.padded_height, turbo.n_words(tc), B)
    _assert_turbo_equal(ts, js, "init")
    j_step, f_step = jturbo.jit_step(jc), _jax_flagship(jc)[1]
    rng = np.random.default_rng(0)
    n_done = 0
    for i in range(T):
        acts = rng.integers(0, 8, size=B).astype(np.int32)
        js, _, jr, jd, jinfo = j_step(js, jnp.asarray(acts))
        jes, *_ = f_step(jes, jnp.asarray(acts))
        ts, _, r, d, info = turbo.step(ts, torch.from_numpy(acts), tc)
        _assert_turbo_equal(ts, js, i)
        _assert_outputs_equal((r, d, info["lines_cleared"]), (jr, jd, jinfo["lines_cleared"]), i)
        np.testing.assert_array_equal(
            turbo.u32_to_lanes(ts.rows).numpy(),
            turbo.u32_to_lanes(turbo.from_flagship(_flagship_from_jax(jes), tc).rows).numpy(),
            err_msg=f"rows vs the flagship board @ {i}")
        n_done += int(d.sum())
    if kw.get("gravity_enabled", True):
        assert n_done > 0  # the game-over path ran


@pytest.mark.parametrize("kw", WIDE_CONFIGS, ids=WIDE_IDS)
def test_flagship_trajectory_matches_jax_wide(kw):
    """120 random steps, 8 envs: every field of the port's flagship engine
    (multi-word bit operations under the id board) equal to JAX's."""
    B, T = 8, 120
    jc, tc = JEngineConfig(**kw), EngineConfig(**kw)
    init, f_step = _jax_flagship(jc)
    jes = init(jbatch_keys(jax.random.PRNGKey(3), B))
    es = engine.init(batch_keys(threefry.prng_key(3), B, device=CPU), tc, device=CPU)
    _assert_flagship_equal(es, jes, "init")
    rng = np.random.default_rng(0)
    for i in range(T):
        acts = rng.integers(0, 8, size=B).astype(np.int32)
        jes, _, jr, jd, jinfo = f_step(jes, jnp.asarray(acts))
        es, _, r, d, info = engine.step(es, torch.from_numpy(acts), tc, obs_fn=engine.no_obs)
        _assert_flagship_equal(es, jes, i)
        _assert_outputs_equal((r, d, info["lines_cleared"]), (jr, jd, jinfo["lines_cleared"]), i)


def test_observe_board_matches_jax_wide():
    """The turbo and the flagship board observation at 30x20, 60 steps."""
    B, T = 8, 60
    kw = dict(width=30, height=20, auto_reset=True)
    jc, tc = JEngineConfig(**kw), EngineConfig(**kw)
    keys = jbatch_keys(jax.random.PRNGKey(11), B)
    js, jes = jturbo.init(keys, jc), _jax_flagship(jc)[0](keys)
    j_step, f_step = jturbo.jit_step(jc), _jax_flagship(jc)[1]
    j_obs = jax.jit(functools.partial(jturbo.observe_board, config=jc))
    f_obs = jax.jit(jax.vmap(functools.partial(jengine.observe_board, config=jc)))
    j_heights = jax.jit(functools.partial(jturbo.heights, config=jc))
    rng = np.random.default_rng(2)
    for i in range(T):
        acts = jnp.asarray(rng.integers(0, 8, size=B), dtype=jnp.int32)
        js, *_ = j_step(js, acts)
        jes, *_ = f_step(jes, acts)
        want = np.asarray(j_obs(js))
        np.testing.assert_array_equal(want, np.asarray(f_obs(jes)))
        ts = _turbo_from_jax(js)
        got = turbo.observe_board(ts, tc)
        assert got.dtype == torch.int8 and got.shape == (B, 20, 30)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"turbo @ {i}")
        np.testing.assert_array_equal(engine.observe_board(_flagship_from_jax(jes), tc).numpy(),
                                      want, err_msg=f"flagship @ {i}")
        np.testing.assert_array_equal(turbo.heights(ts, tc).numpy(), np.asarray(j_heights(js)),
                                      err_msg=f"heights @ {i}")


def _surgery_states(jc, gap_col, n_rows):
    """The JAX test's B = 2 batch: the bottom ``n_rows`` playfield rows full
    but for a 4-wide gap at ``gap_col``, a flat I parked over it."""
    es = _jax_flagship(jc)[0](jbatch_keys(jax.random.PRNGKey(7), 2))
    board = np.array(es.board)
    pad, H, W = jc.padding, jc.height, jc.width
    board[:, H - n_rows : H, pad : pad + W] = 2
    board[:, H - n_rows : H, pad + gap_col : pad + gap_col + 4] = 0
    return es.replace(board=jnp.asarray(board), piece=jnp.zeros(2, jnp.int32),
                      rotation=jnp.zeros(2, jnp.int32), x=jnp.full((2,), gap_col + pad, jnp.int32),
                      y=jnp.zeros(2, jnp.int32))


@pytest.mark.parametrize("gap_col", [0, 26, 12, 14])  # 12..15, 14..17 straddle words
@pytest.mark.parametrize("n_rows", [1, 2])
def test_wide_line_clear_cross_engine(gap_col, n_rows):
    """A hard drop into the gap clears the engineered row on both port
    engines exactly as on both JAX engines, across the word boundary."""
    kw = dict(width=30, height=20, auto_reset=False)
    jc, tc = JEngineConfig(**kw), EngineConfig(**kw)
    jes = _surgery_states(jc, gap_col, n_rows)
    js = jturbo.from_flagship(jes, jc)
    drop = np.full((2,), A.hard_drop, np.int32)
    jes2, _, er, ed, einfo = jengine.batched_step(jes, jnp.asarray(drop), config=jc, obs="board")
    js2, _, jr, jd, jinfo = jturbo.jit_step(jc)(js, jnp.asarray(drop))
    assert (np.asarray(einfo["lines_cleared"]) == 1).all()

    ts = turbo.from_flagship(_flagship_from_jax(jes), tc)
    _assert_turbo_equal(ts, js, "surgery")
    ts2, _, r, d, info = turbo.step(ts, torch.from_numpy(drop), tc)
    _assert_turbo_equal(ts2, js2, "turbo clear")
    _assert_outputs_equal((r, d, info["lines_cleared"]), (jr, jd, jinfo["lines_cleared"]), "turbo")

    es2, _, r, d, info = engine.step(_flagship_from_jax(jes), torch.from_numpy(drop), tc,
                                     obs_fn=engine.no_obs)
    _assert_flagship_equal(es2, jes2, "flagship clear")
    _assert_outputs_equal((r, d, info["lines_cleared"]), (er, ed, einfo["lines_cleared"]), "flagship")


@pytest.mark.parametrize("impl", ["turbo", "flagship"])
def test_vector_env_wide_board(impl):
    """``TetrisVectorEnv`` at width 30: 80 steps of drop spam equal to the
    JAX adapter's, terminal observations included."""
    B = 16
    mine = TetrisVectorEnv(B, EngineConfig(width=30, height=20), impl=impl, seed=2, device=CPU)
    theirs = JTetrisVectorEnv(B, JEngineConfig(width=30, height=20), impl=impl, seed=2)
    obs = mine.reset(seed=2)[0]
    assert obs.shape == (B, 20, 30)
    np.testing.assert_array_equal(obs, theirs.reset(seed=2)[0])
    ends = 0
    for i in range(80):
        acts = np.full(B, A.hard_drop)
        got, want = mine.step(acts), theirs.step(acts)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w, err_msg=f"step {i}")
        assert got[4].keys() == want[4].keys()
        if "final_obs" in want[4]:
            ends += int(want[4]["_final_obs"].sum())
            assert got[4]["final_obs"].dtype == object
            for g, w in zip(got[4]["final_obs"], want[4]["final_obs"]):
                assert (g is None and w is None) or (g.shape == (20, 30) and np.array_equal(g, w))
    assert ends > 0, "drop spam never terminated an episode"


@pytest.mark.parametrize("width", [10, 30])  # padded 22 (one word), 42 (two words)
def test_oversize_pieces_match_jax(width):
    """The 6x6-box set on both engines, 150 steps x 8 envs with auto-reset:
    the turbo engine's two-word piece table against JAX's turbo engine,
    field for field, and the flagship engine against JAX's flagship."""
    mine, theirs, pad = _oversize_sets()
    assert turbo.tables_for(mine, CPU)[0].n_words == jturbo._tables_for(theirs).n_words == 2
    np.testing.assert_array_equal(bb.turbo_tables(mine).packed, jturbo._tables_for(theirs).packed)
    kw = dict(width=width, height=14, padding=pad, queue_size=2, auto_reset=True,
              queue_kind="uniform")
    jc, tc = JEngineConfig(**kw), EngineConfig(**kw)
    B, T = 8, 150
    keys = jbatch_keys(jax.random.PRNGKey(4), B)
    tkeys = batch_keys(threefry.prng_key(4), B, device=CPU)
    js = jturbo.init(keys, jc, pieces=theirs)
    init, f_step = _jax_flagship_for(jc, theirs)
    jes = init(keys)
    ts = turbo.init(tkeys, tc, pieces=mine, device=CPU)
    es = engine.init(tkeys, tc, pieces=mine, device=CPU)
    j_step = jax.jit(functools.partial(jturbo.step, config=jc, pieces=theirs))
    rng = np.random.default_rng(1)
    deaths = 0
    for i in range(T):
        acts = rng.integers(0, 8, size=B).astype(np.int32)
        js, _, jr, jd, jinfo = j_step(js, jnp.asarray(acts))
        jes, *_ = f_step(jes, jnp.asarray(acts))
        ts, _, r, d, info = turbo.step(ts, torch.from_numpy(acts), tc, pieces=mine)
        es, *_ = engine.step(es, torch.from_numpy(acts), tc, pieces=mine, obs_fn=engine.no_obs)
        _assert_turbo_equal(ts, js, f"w={width} step {i}")
        _assert_flagship_equal(es, jes, f"w={width} step {i}")
        _assert_outputs_equal((r, d, info["lines_cleared"]), (jr, jd, jinfo["lines_cleared"]), i)
        np.testing.assert_array_equal(turbo.observe_board(ts, tc, mine).numpy(),
                                      engine.observe_board(es, tc, mine).numpy())
        deaths += int(d.sum())
    assert deaths > 0, "the oversize run must cross auto-reset boundaries"


def test_gym_shell_plays_wide_board():
    """``Tetris(width=30, device="cpu")`` plays a scripted game to termination."""
    from tetris_gymnasium_torch.envs import Tetris

    env = Tetris(width=30, height=20, device=CPU)
    obs, info = env.reset(seed=0)
    assert obs["board"].shape == (20 + 4, 30 + 8)
    script = [A.move_left, A.rotate_clockwise, A.move_right, A.swap, A.hard_drop]
    terminated, steps, total_r = False, 0, 0.0
    while not terminated and steps < 3000:
        obs, r, terminated, _, info = env.step(script[steps % len(script)])
        total_r += float(r)
        steps += 1
    assert terminated, "scripted wide-board game never terminated"
    assert steps > 10 and total_r > 0
