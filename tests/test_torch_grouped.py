"""The port's flagship grouped engine against the JAX package's, on the CPU.

``core/grouped.py`` of the port (placements, the grouped observation in
its boards, features and rgb modes, the step under both illegal-action
policies, with and without auto-reset) must equal
``tetris_gymnasium_tpu.core.grouped`` bit for bit from the same keys and
actions; the port's flagship grouped engine must equal its turbo grouped
engine through ``turbo.from_flagship`` (as ``tests/test_turbo_grouped.py``
holds JAX's two); and the golden cases of ``tests/test_grouped.py`` hold on
the port.  The JAX programs are jitted once per module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.core import engine as jengine
from tetris_gymnasium_tpu.core import grouped as jgrouped
from tetris_gymnasium_tpu.parallel.mesh import batch_keys as jbatch_keys

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import engine, grouped, turbo
from tetris_gymnasium_torch.core import turbo_grouped as tg
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.ops.board import create_board
from tetris_gymnasium_torch.parallel.mesh import batch_keys

CPU = "cpu"
B = 8
CFG = EngineConfig(gravity_enabled=False)
H, W, P = CFG.height, CFG.width, CFG.padding

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _to_jax(ts):
    fields = {k: np.array(getattr(ts, k)) for k in engine.FIELDS}
    fields["key"] = fields["key"].T  # the port keeps the key as [2, B]
    return jengine.EngineState(**{k: jnp.asarray(v) for k, v in fields.items()})


def _assert_env_equal(ts, js, where):
    for k in engine.FIELDS:
        got, want = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        if k == "key":
            got = got.T
        np.testing.assert_array_equal(got, want, err_msg=f"{k} @ {where}")


@functools.lru_cache(maxsize=None)
def _jax_observe(cfg):
    jc = JEngineConfig(**cfg._asdict())

    def one(s):
        out = jgrouped.placements(s, jc)
        return out + tuple(jgrouped.grouped_observation(s, jc, mode=m)[0]
                           for m in ("boards", "features", "rgb"))

    return jax.jit(jax.vmap(one))


def _example_board():
    """The reference's half-filled fixture board (``tests/test_grouped.py:29``)."""
    board = create_board(H, W, P, 1, "cpu")[0].numpy().copy()
    top = H // 2
    board[top:H, P : -(P + 1)] = 2
    board[top - 1, P + 1] = 2
    board[top - 1, P + 4] = 2
    board[top - 1, P + 5] = 2
    board[top + 2, P + 2] = 0
    board[top + 4, P + 3] = 0
    board[top + 6, P + 6] = 0
    return board


def _fixture_state(board=None, piece=0, rotation=1, n=1):
    s = engine.init(batch_keys(threefry.prng_key(0), n, device=CPU), CFG, device=CPU)
    board = _example_board() if board is None else board
    return s.replace(board=torch.from_numpy(np.repeat(board[None], n, 0)).contiguous(),
                     piece=torch.full((n,), piece, dtype=torch.int32),
                     rotation=torch.full((n,), rotation, dtype=torch.int32))


def _played_states(seed):
    """Fresh states, the same after random play, and hand-built stacks."""
    ts = engine.init(batch_keys(threefry.prng_key(seed), B, device=CPU), CFG, device=CPU)
    rng = np.random.default_rng(seed)
    out = [ts]
    for _ in range(30):
        a = torch.from_numpy(rng.choice(8, B, p=(.15, .15, .1, .15, .1, .2, .05, .1)).astype(np.int32))
        ts = engine.step(ts, a, CFG, obs_fn=engine.no_obs)[0]
    out.append(ts)
    board = ts.board.clone()
    inner = board[:, 4:20, 4:14]
    full = torch.from_numpy(rng.random((B, 16, 1)) < 0.3)
    ids = torch.from_numpy(rng.integers(2, 9, inner.shape).astype(np.int8))
    inner[:] = torch.where(full | torch.from_numpy(rng.random(inner.shape) < 0.5), ids, 0)
    board[0, :20, 4:14] = 2  # stacked to the ceiling: game-over placements
    out.append(ts.replace(board=board, piece=torch.from_numpy(rng.integers(0, 7, B).astype(np.int32)),
                          rotation=torch.from_numpy(rng.integers(-2, 6, B).astype(np.int32))))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_placements_and_observations_match_jax(seed):
    for i, ts in enumerate(_played_states(seed)):
        want = _jax_observe(CFG)(_to_jax(ts))
        got = grouped.placements(ts, CFG) + tuple(
            grouped.grouped_observation(ts, CFG, mode=m)[0] for m in ("boards", "features", "rgb"))
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.numpy().dtype == np.asarray(w).dtype, f"output {k} @ {i}"
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"output {k} @ {i}")


@pytest.mark.parametrize("cfg,terminate", [
    (EngineConfig(gravity_enabled=False, auto_reset=True), True),
    (EngineConfig(gravity_enabled=False), True),
    (EngineConfig(gravity_enabled=False, auto_reset=True), False),
    (EngineConfig(auto_reset=False), False),
], ids=["autoreset-term", "noreset-term", "autoreset-noop", "gravity-noop"])
def test_step_matches_jax(cfg, terminate):
    """50 steps of random legal and illegal placements: state, observation,
    reward, done, lines and mask equal every step."""
    jc = JEngineConfig(**cfg._asdict())
    jstep = jax.jit(jax.vmap(functools.partial(jgrouped.step, config=jc, mode="features",
                                               terminate_on_illegal=terminate)))
    js = jax.jit(jax.vmap(functools.partial(jgrouped.reset, config=jc, mode="features")))
    jgs, jobs = js(jbatch_keys(jax.random.PRNGKey(3), B))
    tgs, tobs = grouped.reset(batch_keys(threefry.prng_key(3), B, device=CPU), cfg, mode="features",
                              device=CPU)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    rng = np.random.default_rng(4)
    n_illegal = n_done = 0
    for i in range(50):
        legal = tgs.mask.numpy()
        acts = np.array([rng.integers(0, 40) if rng.random() < 0.2 or not legal[b].any()
                         else rng.choice(np.nonzero(legal[b])[0]) for b in range(B)], dtype=np.int32)
        n_illegal += int((legal[np.arange(B), acts] == 0).sum())
        jgs, jo, jr, jd, ji = jstep(jgs, jnp.asarray(acts))
        tgs, to, tr, td, ti = grouped.step(tgs, torch.from_numpy(acts), cfg, mode="features",
                                           terminate_on_illegal=terminate)
        _assert_env_equal(tgs.env, jgs.env, i)
        for got, want, what in ((to, jo, "obs"), (tr, jr, "reward"), (td, jd, "done"),
                                (ti["lines_cleared"], ji["lines_cleared"], "lines"),
                                (tgs.mask, jgs.mask, "mask")):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{what} @ {i}")
        n_done += int(td.sum())
    assert n_illegal > 5 and n_done > 0


def _to_turbo(gs, cfg):
    return tg.TurboGroupedState(env=turbo.from_flagship(gs.env, cfg), mask=gs.mask.T.contiguous())


@pytest.mark.parametrize("terminate", [True, False])
def test_flagship_grouped_equals_turbo_grouped(terminate):
    """The flagship grouped engine plays the turbo grouped engine's game:
    masks, features, rewards, done, lines and env fields equal every step
    (``tests/test_turbo_grouped.py:34-80`` on the port)."""
    cfg = EngineConfig(gravity_enabled=False, auto_reset=True)
    keys = batch_keys(threefry.prng_key(11), B, device=CPU)
    fgs, fobs = grouped.reset(keys, cfg, mode="features", device=CPU)
    tgs, tobs = tg.reset(keys, cfg, device=CPU)
    np.testing.assert_array_equal(tobs.numpy(), fobs.numpy())
    rng = np.random.default_rng(7)
    for i in range(40):
        legal = fgs.mask.numpy()
        acts = torch.from_numpy(np.array(
            [rng.integers(0, 40) if rng.random() < 0.15 or not legal[b].any()
             else rng.choice(np.nonzero(legal[b])[0]) for b in range(B)], dtype=np.int32))
        fgs, fobs, fr, fd, fi = grouped.step(fgs, acts, cfg, mode="features",
                                             terminate_on_illegal=terminate)
        tgs, tobs, tr, td, ti = tg.step(tgs, acts, cfg, terminate_on_illegal=terminate)
        for got, want in ((tobs, fobs), (tr, fr), (td, fd), (ti["lines_cleared"], fi["lines_cleared"]),
                          (tgs.mask.T, fgs.mask)):
            np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=f"step {i}")
        ft = turbo.from_flagship(fgs.env, cfg)
        for k in turbo.FIELDS:
            np.testing.assert_array_equal(getattr(tgs.env, k).numpy(), getattr(ft, k).numpy(),
                                          err_msg=f"{k} @ {i}")
    assert _to_turbo(fgs, cfg).mask.shape == (40, B)


def test_encode_decode_roundtrip():
    for a in range(40):
        x, r = grouped.decode_action(a)
        assert grouped.encode_action(x, r) == a


def test_golden_action_mask():
    """The literal legality mask of the vertical I on the fixture board."""
    _, mask, _, _ = grouped.placements(_fixture_state(), CFG)
    expected = np.array([
        [0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
        [0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0],
        [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
        [0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0],
    ]).reshape(40, order="F")
    np.testing.assert_array_equal(mask[0].numpy(), expected)


def test_golden_i_placement_lands_the_piece():
    """(column 5, rotation 1) from the I at rotation 1: rotation 2, a flat I
    at x = 5 + padding - 2, on the stack, the golden placement's cells."""
    boards, _, over, lines = grouped.placements(_fixture_state(), CFG)
    got = boards[0, grouped.encode_action(5, 1)].numpy()
    rows, cols = np.nonzero(got != _example_board())
    assert cols.tolist() == [7, 8, 9, 10] and len(set(rows.tolist())) == 1
    assert np.all(got[rows, cols] == 2) and not bool(over[0, 21]) and int(lines[0, 21]) == 0


def test_illegal_placements_are_all_ones():
    boards, mask, _, _ = grouped.placements(_fixture_state(), CFG)
    illegal = np.nonzero(mask[0].numpy() == 0)[0]
    assert len(illegal) > 0
    assert all(np.all(boards[0, a].numpy() == 1) for a in illegal)


def test_game_over_placements_are_all_zeros():
    board = create_board(H, W, P, 1, "cpu")[0].numpy().copy()
    board[0:H, P:-P] = 2
    boards, mask, over, _ = grouped.placements(_fixture_state(board), CFG)
    hit = [(mask[0, a] == 1) and np.all(boards[0, a].numpy() == 0) for a in range(40)]
    assert any(hit) and bool(over[0].any())


def test_step_places_and_rederives_mask():
    state = _fixture_state()
    _, mask0 = grouped.jit_observation(CFG)(state)
    gs2, obs, reward, done, info = grouped.jit_step(CFG)(
        grouped.GroupedState(env=state, mask=mask0), torch.tensor([grouped.encode_action(5, 1)]))
    assert not bool(done[0]) and float(reward[0]) == 1.0
    assert info["action_mask"].shape == (1, 40)
    assert int(gs2.env.board.sum()) > int(state.board.sum())
    assert obs.shape == (1, 40, H + P, W + 2 * P)


@pytest.mark.parametrize("terminate", [True, False])
def test_illegal_action(terminate):
    state = _fixture_state()
    _, mask0 = grouped.jit_observation(CFG)(state)
    illegal = int(np.nonzero(mask0[0].numpy() == 0)[0][0])
    gs2, obs, reward, done, _ = grouped.jit_step(CFG, terminate_on_illegal=terminate)(
        grouped.GroupedState(env=state, mask=mask0), torch.tensor([illegal]))
    assert bool(done[0]) == terminate
    assert float(reward[0]) == pytest.approx(-0.1)
    if terminate:  # the high-valued sentinel; the env untouched
        assert np.all(obs.numpy() == H * W)
        assert torch.equal(gs2.env.board, state.board)


def test_rgb_sentinel_is_255_and_features_shape():
    state = _fixture_state()
    obs, mask = grouped.jit_observation(CFG, mode="features")(state)
    assert obs.shape == (1, 40, W + 3)
    assert np.all(obs[0].numpy()[mask[0].numpy() == 1, :W] <= H)
    illegal = int(np.nonzero(mask[0].numpy() == 0)[0][0])
    _, rgb, _, _, _ = grouped.step(grouped.GroupedState(env=state, mask=mask), torch.tensor([illegal]),
                                   CFG, mode="rgb")
    assert rgb.dtype == torch.uint8 and bool((rgb == 255).all())


def test_batched_grouped():
    gs, obs = grouped.batched_reset(batch_keys(threefry.prng_key(1), 4, device=CPU), config=CFG,
                                    device=CPU)
    assert obs.shape == (4, 40, H + P, W + 2 * P)
    gs2, obs2, rew, done, info = grouped.batched_step(gs, gs.mask.argmax(dim=1).to(torch.int32),
                                                      config=CFG)
    assert rew.shape == (4,) and info["action_mask"].shape == (4, 40)


def test_turbo_from_flagship_matches_jax():
    """``turbo.from_flagship`` of a played flagship batch equals JAX's, field for field."""
    from tetris_gymnasium_tpu.core import turbo as jturbo

    ts = _played_states(2)[1]
    want = jturbo.from_flagship(_to_jax(ts), JEngineConfig())
    got = turbo.from_flagship(ts, CFG)
    for k in turbo.FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)


def test_turbo_rollout_equals_stepping():
    cfg = EngineConfig(auto_reset=True)
    s0 = turbo.init(batch_keys(threefry.prng_key(2), B, device=CPU), cfg, device=CPU)
    acts = torch.from_numpy(np.random.default_rng(9).integers(0, 8, (24, B)).astype(np.int32))
    final, (obs, rewards, dones, lines) = turbo.rollout(s0, acts, cfg, obs_fn=turbo.observe_board)
    s = s0
    for i in range(24):
        s, o, r, d, info = turbo.step(s, acts[i], cfg, obs_fn=turbo.observe_board)
        for got, want in ((obs[i], o), (rewards[i], r), (dones[i], d), (lines[i], info["lines_cleared"])):
            assert torch.equal(got, want), i
    for k in turbo.FIELDS:
        assert torch.equal(getattr(final, k), getattr(s, k)), k
