"""The PyTorch turbo grouped engine against the JAX one, field for field.

The plain PyTorch versions (what the port runs on CPU tensors) must give
the identical placement MDP as ``tetris_gymnasium_tpu.core.turbo_grouped``
from the same per-env keys and actions: masks, observations (features or
binary boards), rewards, dones, lines and every engine state field are
equal at every step.  The port returns features batch-leading
(``[B, A, F]``), the layout of JAX's ``observation``; JAX's ``placements``
returns ``[F, A, B]``, so the tests transpose it.  Integer and float
results alike are compared for equality: the features are small integers
held in float32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.core import turbo as jturbo
from tetris_gymnasium_tpu.core import turbo_grouped as jtg
from tetris_gymnasium_tpu.parallel.mesh import batch_keys as jbatch_keys

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.core import turbo_grouped as tg
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys

CPU = "cpu"
B = 8


def _pair(**kw):
    return JEngineConfig(**kw), EngineConfig(**kw)


def _to_torch(js) -> turbo.TurboState:
    return turbo.TurboState(**{k: torch.from_numpy(np.array(getattr(js, k))) for k in turbo.FIELDS})


def _assert_env_equal(ts, js, where):
    for k in turbo.FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                      err_msg=f"{k} @ {where}")


def _keys(seed, n=B):
    return jbatch_keys(jax.random.PRNGKey(seed), n), batch_keys(threefry.prng_key(seed), n, device=CPU)


@pytest.mark.parametrize("mode", ["features", "boards"])
@pytest.mark.parametrize(
    "kw",
    [dict(gravity_enabled=False, auto_reset=True), dict(width=6, height=8, gravity_enabled=False)],
    ids=["10x20", "6x8"],
)
def test_reset_matches_jax(kw, mode):
    jc, tc = _pair(**kw)
    jkeys, tkeys = _keys(3)
    jgs, jobs = jtg.reset(jkeys, jc, mode=mode)
    tgs, tobs = tg.reset(tkeys, tc, mode=mode, device=CPU)
    _assert_env_equal(tgs.env, jgs.env, "reset")
    np.testing.assert_array_equal(tgs.mask.numpy(), np.asarray(jgs.mask))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    A = tc.width * 4
    assert tobs.shape == ((B, A, tc.width + 3) if mode == "features" else (B, A, tc.height, tc.width))


def _played_state(jc, seed, steps):
    """A JAX grouped batch after ``steps`` random legal placements."""
    jkeys, _ = _keys(seed)
    jgs, _ = jtg.reset(jkeys, jc)
    rng = np.random.default_rng(seed)
    jstep = jax.jit(functools.partial(jtg.step, config=jc))
    for _ in range(steps):
        legal = np.asarray(jgs.mask).T
        acts = [rng.choice(np.nonzero(legal[b])[0]) if legal[b].any() else 0 for b in range(B)]
        jgs, *_ = jstep(jgs, jnp.asarray(acts, dtype=jnp.int32))
    return jgs


@pytest.mark.parametrize("kw", [dict(gravity_enabled=False, auto_reset=True),
                                dict(width=6, height=8, gravity_enabled=False, auto_reset=True)],
                         ids=["10x20", "6x8"])
def test_placements_match_jax_on_played_boards(kw):
    jc, tc = _pair(**kw)
    jgs = _played_state(jc, 5, 12)
    ts = _to_torch(jgs.env)
    jf, jm, jg, jl = jtg.placements(jgs.env, jc)
    tf, tm, tgo, tl = tg.placements(ts, tc)
    np.testing.assert_array_equal(tf.numpy(), np.transpose(np.asarray(jf), (2, 1, 0)))
    for got, want in ((tm, jm), (tgo, jg), (tl, jl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jb, *_ = jtg.placement_boards(jgs.env, jc)
    tb, *_ = tg.placement_boards(ts, tc)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize(
    "kw,terminate,mode",
    [
        (dict(gravity_enabled=False, auto_reset=True), True, "features"),
        (dict(gravity_enabled=False, auto_reset=False), True, "features"),
        (dict(gravity_enabled=False, auto_reset=True), False, "features"),
        (dict(width=6, height=8, gravity_enabled=False, auto_reset=True), True, "boards"),
    ],
    ids=["autoreset-term", "noreset-term", "autoreset-noop", "6x8-boards"],
)
def test_random_trajectories_match_jax(kw, terminate, mode):
    """60 random placement steps, about a sixth of them illegal: every output
    equal at every step, the ``high`` sentinel observation included."""
    jc, tc = _pair(**kw)
    jkeys, tkeys = _keys(11)
    jgs, _ = jtg.reset(jkeys, jc, mode=mode)
    tgs, _ = tg.reset(tkeys, tc, mode=mode, device=CPU)
    jstep = jax.jit(functools.partial(jtg.step, config=jc, mode=mode, terminate_on_illegal=terminate))
    rng = np.random.default_rng(7)
    A = tc.width * 4
    n_illegal = n_done = n_lines = 0
    for i in range(60):
        legal = np.asarray(jgs.mask).T
        acts = []
        for b in range(B):
            options = np.nonzero(legal[b])[0]
            if rng.random() < 0.15 or not len(options):
                acts.append(int(rng.integers(0, A)))
            else:
                acts.append(int(rng.choice(options)))
        n_illegal += sum(legal[b, a] == 0 for b, a in enumerate(acts))
        jgs, jobs, jrew, jdone, jinfo = jstep(jgs, jnp.asarray(acts, dtype=jnp.int32))
        tgs, tobs, trew, tdone, tinfo = tg.step(tgs, torch.tensor(acts, dtype=torch.int32), tc,
                                                mode=mode, terminate_on_illegal=terminate)
        where = f"step {i}"
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew), err_msg=where)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), err_msg=where)
        np.testing.assert_array_equal(tinfo["lines_cleared"].numpy(),
                                      np.asarray(jinfo["lines_cleared"]), err_msg=where)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs), err_msg=where)
        np.testing.assert_array_equal(tgs.mask.numpy(), np.asarray(jgs.mask), err_msg=where)
        _assert_env_equal(tgs.env, jgs.env, where)
        n_done += int(tdone.sum())
        n_lines += int(tinfo["lines_cleared"].sum())
    assert n_illegal > 0 and n_done > 0


def test_boards_sentinels_present_and_match():
    """A played board has illegal (all-ones) and game-over (all-zeros) candidates."""
    jc, tc = _pair(width=6, height=8, gravity_enabled=False, auto_reset=False)
    jgs = _played_state(jc, 23, 10)
    tb, tm, tgo, _ = tg.placement_boards(_to_torch(jgs.env), tc)
    jb, jm, jg, _ = jtg.placement_boards(jgs.env, jc)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    illegal, over = (tm == 0).T, tgo.T & (tm > 0).T
    assert illegal.any() and over.any()
    assert bool((tb[illegal] == 1).all()) and bool((tb[over] == 0).all())


@pytest.mark.parametrize("max_clear", [4, 20])
def test_max_clear_envelope_on_a_hand_built_board(max_clear):
    """Six full rows under an I piece: with max_clear = 4 every placement that
    completes a row is a game over; with max_clear = 20 it clears them."""
    jc, tc = _pair(gravity_enabled=False, auto_reset=False)
    jkeys, tkeys = _keys(2, 2)
    jenv = jturbo.init(jkeys, jc)
    play = ((1 << jc.width) - 1) << jc.padding
    side = (1 << jc.padding) - 1 | ((1 << jc.padding) - 1) << (jc.padding + jc.width)
    rows = np.array(jenv.rows)
    rows[14:20] |= play  # six full rows
    rows[13] = side | (play & ~(1 << jc.padding))  # one hole at the left wall
    jenv = jenv.replace(rows=jnp.asarray(rows), piece=jnp.zeros((2,), jnp.int32))
    tenv = _to_torch(jenv)
    jf, jm, jg, jl = jtg.placements(jenv, jc, max_clear=max_clear)
    tf, tm, tgo, tl = tg.placements(tenv, tc, max_clear=max_clear)
    np.testing.assert_array_equal(tf.numpy(), np.transpose(np.asarray(jf), (2, 1, 0)))
    for got, want in ((tm, jm), (tgo, jg), (tl, jl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if max_clear == 4:
        assert bool(tgo.all()) and int(tl.max()) == 0
    else:
        assert int(tl.max()) >= 6
