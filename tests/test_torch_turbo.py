"""The PyTorch turbo engine against the JAX turbo engine, field for field.

The plain PyTorch versions (what the port runs on CPU tensors) must play
the identical game as ``tetris_gymnasium_tpu.core.turbo`` from the same
per-env keys: every state field, reward, done flag and line count is
bit-equal at every step.  The JAX package is imported only as the oracle.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.core import engine as jengine
from tetris_gymnasium_tpu.core import turbo as jturbo
from tetris_gymnasium_tpu.ops import bitboard as jbb
from tetris_gymnasium_tpu.parallel.mesh import batch_keys as jbatch_keys

from tetris_gymnasium_torch import config as tconfig
from tetris_gymnasium_torch import pieces as tpieces
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.ops import bitboard as bb
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys

CPU = "cpu"


def _pair(**kw):
    return JEngineConfig(**kw), tconfig.EngineConfig(**kw)


def _to_torch(js) -> turbo.TurboState:
    return turbo.TurboState(**{k: torch.from_numpy(np.array(getattr(js, k))) for k in turbo.FIELDS})


def _assert_states_equal(ts: turbo.TurboState, js, where):
    for k in turbo.FIELDS:
        got, want = getattr(ts, k), np.asarray(getattr(js, k))
        assert got.dtype == {
            np.uint32: torch.uint32, np.int32: torch.int32, np.bool_: torch.bool,
            np.float32: torch.float32,
        }[want.dtype.type], f"{k} dtype @ {where}"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{k} @ {where}")


def test_constants_match_jax():
    from tetris_gymnasium_tpu import config as jconfig
    from tetris_gymnasium_tpu import pieces as jpieces

    assert tconfig.EngineConfig()._asdict() == jconfig.EngineConfig()._asdict()
    assert tconfig.ActionsMapping().__dict__ == jconfig.ActionsMapping().__dict__
    assert tconfig.RewardsMapping().__dict__ == jconfig.RewardsMapping().__dict__
    assert tconfig.EnvConfig()._asdict() == jconfig.EnvConfig()._asdict()
    assert tconfig.FN_ACTION_ID_TO_NAME == jconfig.FN_ACTION_ID_TO_NAME
    for name in jpieces.PieceSet._fields:
        np.testing.assert_array_equal(getattr(tpieces.PIECES, name), getattr(jpieces.PIECES, name))
    np.testing.assert_array_equal(bb.row_bits_table(), jbb.ROW_BITS)
    for w, h, p in ((10, 20, 4), (6, 8, 4), (9, 15, 2)):
        assert bb.side_mask(w, p) == jbb.side_mask(w, p)
        assert bb.play_mask(w, p) == jbb.play_mask(w, p)
        np.testing.assert_array_equal(bb.empty_rows(h, w, p), jbb.empty_rows(h, w, p))
    jt = jturbo._tables_for(jpieces.PIECES)
    tt = bb.turbo_tables(tpieces.PIECES)
    np.testing.assert_array_equal(tt.packed, jt.packed)
    np.testing.assert_array_equal(tt.box, jt.box)
    assert (tt.size, tt.n_pieces, tt.n_words) == (jt.size, jt.n_pieces, jt.n_words)


@pytest.mark.parametrize("queue_kind", ["bag", "uniform"])
def test_init_matches_jax(queue_kind):
    jc, tc = _pair(queue_kind=queue_kind)
    keys = jbatch_keys(jax.random.PRNGKey(7), 16)
    tkeys = batch_keys(threefry.prng_key(7), 16, device=CPU)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(keys))
    _assert_states_equal(turbo.init(tkeys, tc, device=CPU), jturbo.init(keys, jc), "init")


TRAJ_CONFIGS = {
    "default": {},
    "autoreset": {"auto_reset": True},
    "nograv-uniform": {"gravity_enabled": False, "queue_kind": "uniform"},
}


@pytest.mark.parametrize("kw", list(TRAJ_CONFIGS.values()), ids=list(TRAJ_CONFIGS))
def test_trajectory_matches_jax(kw):
    """300 random steps, 64 envs: every field and output equal at every step."""
    B, T = 64, 300
    jc, tc = _pair(**kw)
    keys = jbatch_keys(jax.random.PRNGKey(3), B)
    js = jturbo.init(keys, jc)
    ts = turbo.init(batch_keys(threefry.prng_key(3), B, device=CPU), tc, device=CPU)
    j_step = jturbo.jit_step(jc)
    rng = np.random.default_rng(0)
    n_done = 0
    for i in range(T):
        acts = rng.integers(0, 8, size=B).astype(np.int32)
        js, _, jr, jd, jinfo = j_step(js, jnp.asarray(acts))
        ts, _, tr, td, tinfo = turbo.step(ts, torch.from_numpy(acts), tc)
        _assert_states_equal(ts, js, i)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=f"reward @ {i}")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"done @ {i}")
        np.testing.assert_array_equal(
            tinfo["lines_cleared"].numpy(), np.asarray(jinfo["lines_cleared"]), err_msg=f"lines @ {i}"
        )
        n_done += int(td.sum())
    assert n_done > 0  # the game-over path ran


def test_observe_board_and_heights_match_jax():
    B, T = 16, 120
    jc, tc = _pair(auto_reset=True)
    keys = jbatch_keys(jax.random.PRNGKey(11), B)
    js = jturbo.init(keys, jc)
    j_step = jturbo.jit_step(jc)
    j_obs = jax.jit(functools.partial(jturbo.observe_board, config=jc))
    j_heights = jax.jit(functools.partial(jturbo.heights, config=jc))
    rng = np.random.default_rng(5)
    for i in range(T):
        acts = rng.integers(0, 8, size=B).astype(np.int32)
        js, *_ = j_step(js, jnp.asarray(acts))
        ts = _to_torch(js)
        obs = turbo.observe_board(ts, tc)
        assert obs.dtype == torch.int8 and obs.shape == (B, 20, 10)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(j_obs(js)), err_msg=f"obs @ {i}")
        np.testing.assert_array_equal(
            turbo.heights(ts, tc).numpy(), np.asarray(j_heights(js)), err_msg=f"heights @ {i}"
        )


def test_observe_board_game_over_hides_piece():
    jc, tc = _pair()
    js = jturbo.init(jbatch_keys(jax.random.PRNGKey(4), 4), jc)
    js = js.replace(game_over=jnp.asarray([True, False, True, False]))
    obs = turbo.observe_board(_to_torch(js), tc).numpy()
    np.testing.assert_array_equal(obs, np.asarray(jturbo.observe_board(js, jc)))
    assert (obs[[0, 2]] >= 0).all() and (obs[[1, 3]] < 0).any()


def test_clear_lines_matches_jax():
    """_clear_lines on random stacks with up to 6 full rows, both envelopes."""
    jc, tc = _pair()
    rng = np.random.default_rng(4)
    B = 48
    rows = np.tile(bb.empty_rows(20, 10, 4)[:, None], (1, B))
    pm = bb.play_mask(10, 4)
    for b in range(B):
        for r in range(8, 20):
            if rng.random() < 0.6:
                rows[r, b] |= np.uint32(rng.integers(0, 1 << 10) << 4)
        for r in rng.choice(np.arange(20), size=rng.integers(0, 7), replace=False):
            rows[r, b] |= np.uint32(pm)
    for max_clear in (4, 20):
        want_rows, want_n = jax.jit(
            functools.partial(jturbo._clear_lines, config=jc, max_clear=max_clear)
        )(jnp.asarray(rows))
        got_rows, got_n = turbo._clear_lines(turbo.u32_to_lanes(torch.from_numpy(rows)), tc, max_clear)
        np.testing.assert_array_equal(turbo.lanes_to_u32(got_rows).numpy(), np.asarray(want_rows))
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def _surgery(n_full_rows, auto_reset=False):
    """A B=2 batch with ``n_full_rows`` pre-filled rows (board surgery)."""
    jc, tc = _pair(auto_reset=auto_reset)
    keys = jbatch_keys(jax.random.PRNGKey(77), 2)
    es = jax.jit(jax.vmap(functools.partial(jengine.init_state, config=jc)))(keys)
    board = np.array(es.board)
    board[:, 20 - n_full_rows : 20, 4:14] = 2
    js = jturbo.from_flagship(es.replace(board=jnp.asarray(board)), jc)
    return jc, tc, js


@pytest.mark.parametrize("max_clear", [4, 20], ids=["envelope", "widened"])
def test_surgery_five_rows_matches_jax(max_clear):
    """Hard drop onto 5 full rows: with max_clear=4 the env terminates with
    the game-over reward (as ``test_surgery_overflow_terminates_always_on``);
    with max_clear=20 all five rows clear.  Both equal JAX field for field."""
    jc, tc, js = _surgery(5)
    drop = np.full((2,), 5, np.int32)
    js2, _, jr, jd, jinfo = jax.jit(
        functools.partial(jturbo.step, config=jc, max_clear=max_clear)
    )(js, jnp.asarray(drop))
    ts2, _, tr, td, tinfo = turbo.step(_to_torch(js), torch.from_numpy(drop), tc, max_clear=max_clear)
    _assert_states_equal(ts2, js2, "surgery")
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tinfo["lines_cleared"].numpy(), np.asarray(jinfo["lines_cleared"]))
    if max_clear == 4:
        assert td.all() and ts2.game_over.all()
        np.testing.assert_array_equal(tr.numpy(), 0.0)
    else:
        assert (tinfo["lines_cleared"] >= 5).all() and not td.any()


def test_surgery_overflow_autoreset_restarts_cleanly():
    jc, tc, js = _surgery(5, auto_reset=True)
    drop = torch.full((2,), 5, dtype=torch.int32)
    ts2, _, _, td, _ = turbo.step(_to_torch(js), drop, tc)
    assert td.all() and not ts2.game_over.any()
    np.testing.assert_array_equal(ts2.rows.numpy(), np.tile(bb.empty_rows(20, 10, 4)[:, None], (1, 2)))


def test_frozen_state_does_not_change():
    """A finished game freezes every field, key and step count included."""
    _, tc = _pair()
    ts = turbo.init(batch_keys(threefry.prng_key(2), 4, device=CPU), tc, device=CPU)
    ts = ts.replace(game_over=torch.tensor([True, False, True, False]))
    ts2, _, r, d, info = turbo.step(ts, torch.full((4,), 5, dtype=torch.int32), tc)
    for k in turbo.FIELDS:
        np.testing.assert_array_equal(getattr(ts2, k)[..., [0, 2]].numpy(), getattr(ts, k)[..., [0, 2]].numpy())
    assert (r[[0, 2]] == 0).all() and d[[0, 2]].all()


def test_wide_board_raises():
    """A wide board plays on the turbo engine, rows ``[H, NW, B]`` equal to
    JAX's, and so do the grouped engine's multi-word candidates
    (``turbo_grouped.py:126-133``): features, mask, game over and lines."""
    from tetris_gymnasium_torch.core import turbo_grouped
    from tetris_gymnasium_tpu.core import turbo_grouped as jturbo_grouped

    jc, tc = _pair(width=30)
    ts = turbo.init(batch_keys(threefry.prng_key(0), 2, device=CPU), tc, device=CPU)
    assert ts.rows.shape == (24, 2, 2)
    js = jturbo.init(jbatch_keys(jax.random.PRNGKey(0), 2), jc)
    _assert_states_equal(ts, js, "init")
    feats, mask, over, lines = turbo_grouped.placements(ts, tc)
    jfeats, jmask, jover, jlines = jturbo_grouped.placements(js, jc)
    np.testing.assert_array_equal(feats.numpy(), np.transpose(np.asarray(jfeats), (2, 1, 0)))
    for got, want in ((mask, jmask), (over, jover), (lines, jlines)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        turbo.init(np.zeros((2, 2), np.uint32), tconfig.EngineConfig())
