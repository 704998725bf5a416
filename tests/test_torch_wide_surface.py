"""The Gymnasium surface and both grouped engines at other geometries, against JAX, on the CPU.

Mirrors ``tests/test_wide_boards.py:165-210`` and ``:301-328`` with the JAX
package as the oracle, values and not only shapes: the turbo grouped
engine's multi-word candidates (``core/turbo_grouped.py:126-133``) over 12
masked-random steps at 30x14 and in boards mode at 30x10; the flagship
grouped engine's placements and grouped observation in all four modes at
30x14 and with the 6x6 pieces; the Dict observation and the renders at
30x20 and 61x12, and JAX's own refusal of a composite wider than 84; the
feature vector at width 61 and at 40 rows; a holder longer than the queue
(the sidebar is ``S * max(queue, holder)`` wide); the shell playing a
scripted game at width 30; and the observation wrappers and the grouped
wrapper at width 30.  Integers and images are bit-equal, float features
equal.
"""
import functools

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tetris_gymnasium_tpu.envs  # noqa: F401  (registers the JAX env)
from tetris_gymnasium_tpu import wrappers as jwrappers
from tetris_gymnasium_tpu.components.tetromino import Tetromino as JTetromino
from tetris_gymnasium_tpu.components.tetromino import pieces_from_tetrominoes as jpieces_from
from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.core import engine as jengine
from tetris_gymnasium_tpu.core import grouped as jgrouped
from tetris_gymnasium_tpu.core import turbo_grouped as jturbo_grouped
from tetris_gymnasium_tpu.ops import observations as jobs
from tetris_gymnasium_tpu.ops.image import preprocess_rgb84 as jpreprocess
from tetris_gymnasium_tpu.parallel.mesh import batch_keys as jbatch_keys
from tetris_gymnasium_tpu.pieces import PIECES as JPIECES

import tetris_gymnasium_torch.envs  # noqa: F401  (registers the port's env)
from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch import wrappers
from tetris_gymnasium_torch.components.tetromino import Tetromino, pieces_from_tetrominoes
from tetris_gymnasium_torch.config import ActionsMapping, EngineConfig
from tetris_gymnasium_torch.core import engine, grouped
from tetris_gymnasium_torch.core import turbo_grouped as tg
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.ops.observations import FeatureFlags, compose_rgb, feature_vector
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES

CPU = "cpu"
A = ActionsMapping()
FLAG_SETS = [(1, 1, 1, 1), (0, 1, 1, 0), (1, 0, 0, 1)]


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
    theirs, _ = jpieces_from([JTetromino(2 + i, c, m) for i, (c, m) in enumerate(shapes)])
    return mine, theirs, pad


def _keys(seed, B):
    jk = jbatch_keys(jax.random.PRNGKey(seed), B)
    return jk, torch.from_numpy(np.array(jk))


def _to_jax(ts):
    fields = {k: np.array(getattr(ts, k)) for k in engine.FIELDS}
    fields["key"] = fields["key"].T  # the port keeps the key as [2, B]
    return jengine.EngineState(**{k: jnp.asarray(v) for k, v in fields.items()})


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} vs {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=what)


def _played(cfg, pieces, B, steps, seed):
    """A flagship batch after ``steps`` random actions, biased to hard drops
    and swaps so that stacks and holders fill."""
    rng = np.random.default_rng(seed)
    s = engine.init(batch_keys(threefry.prng_key(seed), B, device=CPU), cfg, pieces, device=CPU)
    for _ in range(steps):
        a = rng.choice(8, B, p=[.1, .1, .05, .1, .05, .35, .15, .1]).astype(np.int32)
        s = engine.step(s, torch.from_numpy(a), cfg, pieces, obs_fn=engine.no_obs)[0]
    return s


# ---------------------------------------------------------------------------
# The turbo grouped engine's multi-word candidates
# ---------------------------------------------------------------------------


def test_turbo_grouped_matches_jax_wide():
    """Masked-random placements at width 30 (rows of two words): features,
    mask, reward, done and lines equal to JAX's at every step."""
    kw = dict(width=30, height=14, gravity_enabled=False, auto_reset=True)
    jc, tc = JEngineConfig(**kw), EngineConfig(**kw)
    B = 4
    jk, tk = _keys(5, B)
    jgs, jo = jturbo_grouped.reset(jk, jc)
    gs, o = tg.reset(tk, tc, device=CPU)
    assert gs.env.rows.shape == (18, 2, B)
    _eq(o, jo, "reset obs")
    _eq(gs.mask, jgs.mask, "reset mask")
    rng = np.random.default_rng(4)
    jstep = jturbo_grouped.jit_step(jc)
    for i in range(12):
        legal = gs.mask.T.numpy()
        acts = np.array([rng.choice(np.nonzero(legal[b])[0]) for b in range(B)], np.int32)
        jgs, jo, jr, jd, ji = jstep(jgs, jnp.asarray(acts))
        gs, o, r, d, info = tg.step(gs, torch.from_numpy(acts), tc)
        for got, want, what in ((o, jo, "obs"), (gs.mask, jgs.mask, "mask"), (r, jr, "reward"),
                                (d, jd, "done"), (info["lines_cleared"], ji["lines_cleared"], "lines")):
            _eq(got, want, f"{what} @ {i}")


def test_turbo_grouped_boards_mode_matches_jax_wide():
    """Boards mode at width 30: the candidates' binary boards, mask, game
    over and lines equal to JAX's at reset and after three placements."""
    kw = dict(width=30, height=10, gravity_enabled=False, auto_reset=True)
    jc, tc = JEngineConfig(**kw), EngineConfig(**kw)
    jk, tk = _keys(9, 2)
    jgs, jo = jturbo_grouped.reset(jk, jc, mode="boards")
    gs, o = tg.reset(tk, tc, mode="boards", device=CPU)
    assert o.shape == (2, 120, 10, 30)
    _eq(o, jo, "reset boards")
    jstep = jax.jit(functools.partial(jturbo_grouped.step, config=jc, mode="boards"))
    for i, a in enumerate(([0, 57], [118, 3], [60, 61])):
        jgs, jo, jr, jd, ji = jstep(jgs, jnp.asarray(a, jnp.int32))
        gs, o, r, d, info = tg.step(gs, torch.tensor(a, dtype=torch.int32), tc, mode="boards")
        _eq(o, jo, f"boards @ {i}")
        _eq(r, jr, f"reward @ {i}")
    _, jmask, jover, jlines = jturbo_grouped.placement_boards(jgs.env, jc)
    _, mask, over, lines = tg.placement_boards_plain(gs.env, tc)
    for got, want, what in ((mask, jmask, "mask"), (over, jover, "over"), (lines, jlines, "lines")):
        _eq(got, want, what)


# ---------------------------------------------------------------------------
# The flagship grouped engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_grouped(kw, oversize):
    jc = JEngineConfig(**dict(kw))
    extra = {"pieces": _oversize_sets()[1]} if oversize else {}

    def one(s):
        out = jgrouped.placements(s, jc, **extra)
        return out + tuple(jgrouped.grouped_observation(s, jc, mode=m, **extra)[0]
                           for m in ("boards", "features", "rgb"))

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("oversize", [False, True], ids=["30x14", "6x6-pieces"])
def test_flagship_grouped_matches_jax(oversize):
    """``placements`` (id boards, mask, game over, lines) and
    ``grouped_observation`` in its boards, features and rgb modes equal to
    JAX's, at 30x14 and for the 6x6 pieces at width 10."""
    if oversize:
        pieces, _, pad = _oversize_sets()
        kw = dict(width=10, height=16, padding=pad, queue_size=2, queue_kind="uniform")
    else:
        pieces, kw = PIECES, dict(width=30, height=14, gravity_enabled=False)
    cfg = EngineConfig(**kw)
    s = _played(cfg, pieces, 3, 25, 21)
    want = _jax_grouped(tuple(kw.items()), oversize)(_to_jax(s))
    got = grouped.placements(s, cfg, pieces)
    for k, what in enumerate(("boards", "mask", "over", "lines")):
        _eq(got[k], want[k], what)
    assert (got[1] == 0).any() and (got[1] == 1).any()
    for k, mode in zip((4, 5, 6), ("boards", "features", "rgb")):
        obs, mask = grouped.grouped_observation(s, cfg, pieces, mode)
        _eq(obs, want[k], mode)
        _eq(mask, want[1], f"{mode} mask")


# ---------------------------------------------------------------------------
# The Dict observation, the renders and the feature vector
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_observe(kw):
    jc = JEngineConfig(**dict(kw))
    dict_of = jax.vmap(functools.partial(jengine.observe_dict, config=jc))
    rgb_of = jax.vmap(functools.partial(jengine.render_rgb, config=jc))
    return jax.jit(lambda s: (dict_of(s), rgb_of(s), jpreprocess(rgb_of(s))))


@pytest.mark.parametrize("kw", [dict(width=30, height=20), dict(width=61, height=12, queue_size=3),
                                dict(width=10, height=20, queue_size=1, holder_size=2)],
                         ids=["30x20", "61x12", "queue1-holder2"])
def test_observations_match_jax(kw):
    """``observe_dict``, ``render_rgb`` and ``render_rgb84`` after random
    play (holders filled by swaps) equal to JAX's; with a holder longer
    than the queue the sidebar is ``S * max(queue, holder)`` wide and the
    queue strip is widened with bedrock."""
    cfg = EngineConfig(**kw)
    s = _played(cfg, PIECES, 3, 30, 13)
    assert int(s.holder_count.max()) == cfg.holder_size
    jdict, jrgb, j84 = _jax_observe(tuple(kw.items()))(_to_jax(s))
    d = engine.observe_dict(s, cfg)
    for k in jdict:
        _eq(d[k], jdict[k], k)
    rgb = engine.render_rgb(s, cfg)
    side = 4 * max(cfg.queue_size, cfg.holder_size)
    assert rgb.shape == (3, cfg.padded_height, cfg.padded_width + side, 3)
    _eq(rgb, jrgb, "render_rgb")
    _eq(engine.render_rgb84(s, cfg), j84, "render_rgb84")


def test_render_rgb84_refuses_as_jax():
    """A composite wider than 84 (width 80: 88 + 16 columns) is refused by
    JAX's resize with ``ValueError``, and a board lower than the sidebar's
    two strips by JAX's composite with ``TypeError``; the port's plain
    versions and kernel wrappers raise the same."""
    cfg = EngineConfig(width=80, height=12)
    s = _played(cfg, PIECES, 1, 0, 3)
    with pytest.raises(ValueError, match="only enlarges"):
        jpreprocess(jnp.zeros((1, cfg.padded_height, cfg.padded_width + 16, 3), jnp.uint8))
    with pytest.raises(ValueError, match="only enlarges"):
        engine.render_rgb84(s, cfg)
    with pytest.raises(ValueError, match="only enlarges"):
        kernels.render_rgb84(s, cfg, PIECES)
    low, q, h = np.zeros((7, 18), np.uint8), np.zeros((4, 16), np.uint8), np.zeros((4, 4), np.uint8)
    with pytest.raises(TypeError):
        jobs.compose_rgb(jnp.asarray(low), jnp.asarray(q), jnp.asarray(h), JPIECES)
    for compose in (compose_rgb, kernels.compose_rgb):
        with pytest.raises(TypeError, match="lower than"):
            compose(*(torch.from_numpy(x)[None] for x in (low, q, h)), PIECES)


@pytest.mark.parametrize("shape", [(20, 61), (40, 10)], ids=["width61", "height40"])
def test_feature_vector_matches_jax(shape):
    """Random stacks (columns empty, full and ragged) at width 61 and at 40
    rows, every flag set of ``FLAG_SETS``."""
    rng = np.random.default_rng(shape[1])
    boards = rng.integers(-3, 9, (16,) + shape).astype(np.int8) * (rng.random((16,) + shape) < 0.4)
    boards[0] = 0
    boards[1, :, 3] = 5
    for flags in FLAG_SETS:
        want = jax.vmap(functools.partial(jobs.feature_vector, flags=jobs.FeatureFlags(*map(bool, flags))))(
            jnp.asarray(boards))
        _eq(feature_vector(torch.from_numpy(boards), FeatureFlags(*map(bool, flags))), want, str(flags))


# ---------------------------------------------------------------------------
# The shell and the wrappers at width 30
# ---------------------------------------------------------------------------


def _make(which, **kw):
    if which == "jax":
        return gym.make("tetris_gymnasium_tpu/Tetris", **kw)
    return gym.make("tetris_gymnasium_torch/Tetris", device=CPU, **kw)


def test_shell_matches_jax_wide():
    """``Tetris(width=30)`` plays the scripted game of
    ``tests/test_wide_boards.py:test_gym_shell_plays_wide_board`` to its
    end, every observation, reward, termination, info and rgb frame equal
    to JAX's shell."""
    env, jenv = (_make(w, width=30, height=20, render_mode="rgb_array") for w in ("torch", "jax"))
    o, _ = env.reset(seed=0)
    jo, _ = jenv.reset(seed=0)
    assert o["board"].shape == (24, 38)
    script = [A.move_left, A.rotate_clockwise, A.move_right, A.swap, A.hard_drop]
    done, steps, total = False, 0, 0.0
    while not done and steps < 3000:
        for k in jo:
            _eq(o[k], jo[k], f"{k} @ {steps}")
        if steps % 50 == 0:
            _eq(env.render(), jenv.render(), f"rgb @ {steps}")
        o, r, done, trunc, info = env.step(script[steps % len(script)])
        jo, jr, jdone, jtrunc, jinfo = jenv.step(script[steps % len(script)])
        assert (r, done, trunc, info) == (jr, jdone, jtrunc, jinfo), steps
        total += r
        steps += 1
    assert done and steps > 10 and total > 0


def test_observation_wrappers_match_jax_wide():
    """RgbObservation and FeatureVectorObservation (three flag sets) at
    width 30 along a played episode, values equal to JAX's."""
    env, jenv = (_make(w, width=30, height=20) for w in ("torch", "jax"))
    rgb, jrgb = wrappers.RgbObservation(env), jwrappers.RgbObservation(jenv)
    assert rgb.observation_space == jrgb.observation_space
    feats = [wrappers.FeatureVectorObservation(env, *f) for f in FLAG_SETS]
    jfeats = [jwrappers.FeatureVectorObservation(jenv, *f) for f in FLAG_SETS]
    o, _ = rgb.reset(seed=1)
    jo, _ = jrgb.reset(seed=1)
    rng = np.random.default_rng(1)
    for step in range(40):
        _eq(o, jo, f"rgb @ {step}")
        for f, jf in zip(feats, jfeats):
            assert f.observation_space == jf.observation_space
            _eq(f.observation(None), jf.observation(None), f"features @ {step}")
        a = int(rng.choice(8, p=[.1, .1, .05, .1, .05, .4, .1, .1]))
        o, r, d, *_ = rgb.step(a)
        jo, jr, jd, *_ = jrgb.step(a)
        assert (r, d) == (jr, jd)
        if d:
            break
    assert feats[0].observation(None).max() > 0


@pytest.mark.parametrize("mode", ["features", "boards", "rgb"])
def test_grouped_wrapper_matches_jax_wide(mode):
    """GroupedActionsObservations at width 30 (120 candidates): 12 steps of
    legal and illegal placements, observation, reward, done and info equal
    to JAX's."""
    def stack(which):
        env = _make(which, width=30, height=20, gravity=False)
        w = jwrappers if which == "jax" else wrappers
        inner = {"boards": None, "features": [w.FeatureVectorObservation(env)],
                 "rgb": [w.RgbObservation(env)]}[mode]
        return w.GroupedActionsObservations(env, observation_wrappers=inner)

    mine, theirs = stack("torch"), stack("jax")
    assert mine.observation_space == theirs.observation_space
    rng = np.random.default_rng(6)
    o, i = mine.reset(seed=2)
    jo, ji = theirs.reset(seed=2)
    for step in range(12):
        _eq(o, jo, f"obs @ {step}")
        assert i.keys() == ji.keys()
        for k in ji:
            got, want = (i[k], ji[k]) if isinstance(ji[k], dict) else ({0: i[k]}, {0: ji[k]})
            for kk in want:
                _eq(got[kk], want[kk], f"{k} {kk} @ {step}")
        legal, illegal = (np.nonzero(i["action_mask"] == v)[0] for v in (1, 0))
        a = int(rng.choice(illegal if step == 5 and len(illegal) else legal))
        o, r, d, t, i = mine.step(a)
        jo, jr, jd, jt, ji = theirs.step(a)
        assert (r, d, t) == (jr, jd, jt), step
        if d:
            o, i = mine.reset(seed=step)
            jo, ji = theirs.reset(seed=step)
