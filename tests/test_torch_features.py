"""The port's feature vector and id-board line clear against the JAX package's, on the CPU.

``ops/observations.py`` (column heights, max height, holes, bumpiness and
the feature vector under every set of flags) and ``ops/board.py``
(``drop_distance``, ``clear_lines``) of the port must equal
``tetris_gymnasium_tpu``'s bit for bit on random and hand-built playfields:
empty, a full column, overhangs, pieces at the clamped edges of the board.
The JAX functions are jitted once per module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.ops import board as jboard
from tetris_gymnasium_tpu.ops import observations as jobs
from tetris_gymnasium_tpu.pieces import PIECES as JPIECES
from tetris_gymnasium_tpu.pieces import piece_matrix as jpiece_matrix

from tetris_gymnasium_torch.ops import board as ob
from tetris_gymnasium_torch.ops import observations as obs
from tetris_gymnasium_torch.pieces import PIECES, piece_matrix

FLAG_SETS = [tuple(bool(m >> k & 1) for k in range(4)) for m in range(1, 16)]

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _playfields(seed, B=24, H=20, W=10):
    """Random playfields of ids, and hand-built ones: empty, full, a full
    column, overhangs (a filled row over empty cells), negative ids."""
    rng = np.random.default_rng(seed)
    pf = rng.integers(-3, 9, size=(B, H, W)).astype(np.int8)
    pf *= (rng.random((B, H, W)) < rng.random((B, 1, 1))).astype(np.int8)
    pf[0] = 0
    pf[1] = 2
    pf[2] = 0
    pf[2, :, 4] = 5
    pf[3] = 0
    pf[3, 6, :] = 3  # an overhang over an empty stack
    pf[3, 15:, 1:3] = 1
    return pf


@functools.lru_cache(maxsize=None)
def _jax_features(flags):
    return jax.jit(jax.vmap(lambda p: jobs.feature_vector(p, jobs.FeatureFlags(*flags))))


@pytest.mark.parametrize("seed", [0, 1])
def test_feature_parts_match_jax(seed):
    pf = _playfields(seed)
    t = torch.from_numpy(pf)
    for name in ("column_heights", "max_height", "holes", "bumpiness"):
        want = np.asarray(jax.vmap(getattr(jobs, name))(jnp.asarray(pf)))
        got = getattr(obs, name)(t).numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)


@pytest.mark.parametrize("flags", FLAG_SETS, ids=[str(f) for f in FLAG_SETS])
def test_feature_vector_matches_jax_under_every_flag_set(flags):
    pf = _playfields(7)
    want = np.asarray(_jax_features(flags)(jnp.asarray(pf)))
    got = obs.feature_vector(torch.from_numpy(pf), obs.FeatureFlags(*flags))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[1] == obs.n_features(10, obs.FeatureFlags(*flags))


def test_feature_vector_without_flags_is_empty():
    got = obs.feature_vector(torch.zeros((3, 20, 10), dtype=torch.int8), obs.FeatureFlags(*(False,) * 4))
    assert got.shape == (3, 0)


def test_feature_vector_reads_a_padded_boards_crop():
    """The crop view of padded boards gives the features of the copied crop."""
    rng = np.random.default_rng(3)
    boards = rng.integers(0, 9, size=(5, 24, 18)).astype(np.int8)
    view = torch.from_numpy(boards)[:, :20, 4:14]
    assert not view.is_contiguous()
    np.testing.assert_array_equal(obs.feature_vector(view).numpy(),
                                  obs.feature_vector(view.contiguous()).numpy())


def _boards(seed, B):
    """Padded boards with a random stack under a random height, full rows
    and holes, on the bedrock frame."""
    rng = np.random.default_rng(seed)
    board = np.ones((B, 24, 18), dtype=np.int8)
    stack = rng.integers(2, 9, size=(B, 20, 10)).astype(np.int8)
    top = rng.integers(0, 21, size=(B, 1, 1))
    keep = (np.arange(20)[None, :, None] >= top) & (rng.random((B, 20, 10)) < 0.8)
    full = rng.random((B, 20, 1)) < 0.2
    board[:, :20, 4:14] = np.where(keep | (full & (np.arange(20)[None, :, None] >= top)), stack, 0)
    board[:3, :20, 4:14] = 0
    return board


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drop_distance_matches_jax(seed):
    """Every piece and rotation from every column and start row, the clamped
    edges included (x from -3 to 17, y from -2 to 23)."""
    B = 512
    rng = np.random.default_rng(seed)
    board = _boards(seed, B)
    piece = rng.integers(0, 7, B).astype(np.int32)
    rot = rng.integers(0, 4, B).astype(np.int32)
    x = rng.integers(-3, 18, B).astype(np.int32)
    y = rng.integers(-2, 24, B).astype(np.int32)
    jmat = jax.vmap(lambda p, r: jpiece_matrix(JPIECES.jx(), p, r))(jnp.asarray(piece), jnp.asarray(rot))
    want = np.asarray(jax.jit(jax.vmap(jboard.drop_distance))(jnp.asarray(board), jmat,
                                                              jnp.asarray(x), jnp.asarray(y)))
    mat = piece_matrix(PIECES, torch.from_numpy(piece), torch.from_numpy(rot))
    got = ob.drop_distance(torch.from_numpy(board), mat, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), want)
    # a board without a floor: the drop is capped at the board's height
    open_board = np.zeros((1, 24, 18), dtype=np.int8)
    got = ob.drop_distance(torch.from_numpy(open_board), mat[:1], torch.tensor([7]), torch.tensor([0]))
    assert int(got[0]) == 24


@pytest.mark.parametrize("seed", [0, 1])
def test_clear_lines_matches_jax(seed):
    """Full rows anywhere (up to 20 at once), a garbage frame that the clear
    rebuilds as bedrock, negative ids that do not count as filled."""
    rng = np.random.default_rng(seed)
    board = _boards(seed, 64)
    board[:, :, :4] = rng.integers(-2, 3, size=(64, 24, 4))
    board[:, 20:, :] = rng.integers(0, 9, size=(64, 4, 18))
    board[5, :20, 4:14] = 2  # every row full
    board[6, 10, 4:14] = 3
    board[6, 10, 8] = -1  # not > 0: not full
    want_b, want_n = jax.jit(jax.vmap(lambda b: jboard.clear_lines(b, 20, 10, 4)))(jnp.asarray(board))
    got_b, got_n = ob.clear_lines(torch.from_numpy(board), 20, 10, 4)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert int(got_n[5]) == 20


def test_upscale_rgb_matches_jax():
    rgb = np.random.default_rng(0).integers(0, 256, size=(24, 34, 3)).astype(np.uint8)
    np.testing.assert_array_equal(obs.upscale_rgb(torch.from_numpy(rgb), 3).numpy(),
                                  np.asarray(jobs.upscale_rgb(jnp.asarray(rgb), 3)))


def test_compose_rgb_matches_jax_with_ids_outside_the_palette():
    rng = np.random.default_rng(5)
    board = rng.integers(0, 256, size=(4, 24, 18)).astype(np.uint8)
    q = rng.integers(0, 12, size=(4, 4, 16)).astype(np.uint8)
    h = rng.integers(0, 12, size=(4, 4, 4)).astype(np.uint8)
    want = jax.vmap(lambda b, qq, hh: jobs.compose_rgb(b, qq, hh, JPIECES))(
        jnp.asarray(board), jnp.asarray(q), jnp.asarray(h))
    got = obs.compose_rgb(torch.from_numpy(board), torch.from_numpy(q), torch.from_numpy(h), PIECES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # grouped: boards 0-1 take env 0's strips, 2-3 env 1's
    got = obs.compose_rgb(torch.from_numpy(board), torch.from_numpy(q[:2]), torch.from_numpy(h[:2]),
                          PIECES, group=2)
    want = jax.vmap(lambda b, qq, hh: jobs.compose_rgb(b, qq, hh, JPIECES))(
        jnp.asarray(board), jnp.asarray(np.repeat(q[:2], 2, 0)), jnp.asarray(np.repeat(h[:2], 2, 0)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
