"""The port's multi-word bit operations against the JAX package's, on the CPU.

Mirrors ``tests/test_bitboard_wide.py`` on ``tetris_gymnasium_torch.ops.
bitboard_wide``: packing, collision at every x of the padded range (so the
low/carry word split sees every offset), drop distance, projection, line
clears with filled-row sets up to four and bit 31 of word 0 in the
playfield, on the same three geometries (padded widths 38, 36 and 69).  The
port batches what the JAX test loops over: every (piece, rotation, x, y)
probe of a case is one batched call, held against ``jax.vmap`` of the JAX
function on the same inputs, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.ops import bitboard_wide as jbw
from tetris_gymnasium_tpu.ops import board as jboard
from tetris_gymnasium_tpu.pieces import PIECES as JPIECES

from tetris_gymnasium_torch.core.turbo import u32_to_lanes
from tetris_gymnasium_torch.ops import bitboard_wide as bw
from tetris_gymnasium_torch.ops import board as ob
from tetris_gymnasium_torch.pieces import PIECES

GEOMETRIES = [(20, 30, 4), (14, 28, 4), (12, 61, 4)]
RTAB = bw.row_bits_table(PIECES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dims(geom):
    H, W, PAD = geom
    return H, W, PAD, H + PAD, W + 2 * PAD


def random_board(geom, seed: int, fill: float) -> np.ndarray:
    H, W, PAD, HP, WP = dims(geom)
    r = np.random.default_rng(seed)
    inner = np.where(r.random((H, W)) < fill, r.integers(2, 9, (H, W)), 0)
    return np.pad(inner, ((0, PAD), (PAD, PAD)), constant_values=1).astype(np.int8)


def _lanes(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _probes(geom, xs, seed, y_range):
    """Every (piece, rotation) at every x of ``xs``, a random y each: int32 arrays."""
    r = np.random.default_rng(seed)
    p, rot, x = (a.ravel().astype(np.int32) for a in np.meshgrid(
        np.arange(7), np.arange(4), np.asarray(xs), indexing="ij"))
    y = r.integers(*y_range, size=p.shape).astype(np.int32)
    return p, rot, x, y


def _port_inputs(board, p, rot):
    n = p.shape[0]
    rows = bw.pack_board(torch.from_numpy(board)[None]).expand(n, -1, -1)
    rb = bw.piece_row_bits(RTAB, torch.from_numpy(p), torch.from_numpy(rot))
    return rows, rb


def _jax_vmapped(fn, board, WP):
    rows = jbw.pack_board(jnp.asarray(board))
    jtab = jbw.row_bits_table(JPIECES)
    return jax.jit(jax.vmap(lambda p, r, x, y: fn(rows, jbw.piece_row_bits(jtab, p, r), x, y, WP)))


def test_mask_words_and_empty_rows_match_jax():
    for H, W, PAD in GEOMETRIES + [(8, 28, 4), (16, 30, 6)]:
        WP = W + 2 * PAD
        assert bw.n_words(WP) == jbw.n_words(WP)
        np.testing.assert_array_equal(bw.side_mask_words(W, PAD), jbw.side_mask_words(W, PAD))
        np.testing.assert_array_equal(bw.play_mask_words(W, PAD), jbw.play_mask_words(W, PAD))
        np.testing.assert_array_equal(bw.empty_rows(H, W, PAD), jbw.empty_rows(H, W, PAD))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_pack_board_roundtrip(geom):
    H, W, PAD, HP, WP = dims(geom)
    boards = np.stack([random_board(geom, s, 0.4) for s in range(3)])
    rows = bw.pack_board(torch.from_numpy(boards))
    assert rows.shape == (3, HP, bw.n_words(WP))
    np.testing.assert_array_equal(rows.numpy(), _lanes(jax.vmap(jbw.pack_board)(jnp.asarray(boards))))
    bits = (rows[..., None] >> torch.arange(32)) & 1
    np.testing.assert_array_equal(bits.flatten(-2)[..., :WP].numpy(), boards > 0)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("fill", [0.0, 0.35, 0.9])
def test_collision_equivalence_every_x(geom, fill):
    """Every x in the padded range: the carry split sees all 32 offsets."""
    H, W, PAD, HP, WP = dims(geom)
    board = random_board(geom, int(fill * 10) + 1, fill)
    p, rot, x, y = _probes(geom, range(-2, WP + 2), 7, (-2, HP + 2))
    rows, rb = _port_inputs(board, p, rot)
    got = bw.collision(rows, rb, torch.from_numpy(x), torch.from_numpy(y), WP)
    want = _jax_vmapped(jbw.collision, board, WP)(p, rot, x, y)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the einsum kernels' answer, which the JAX test holds the wide ones to
    mats = jnp.asarray(JPIECES.matrices)[p, rot]
    spec = jax.vmap(lambda m, xx, yy: jboard.collision(jnp.asarray(board), m, xx, yy))(mats, x, y)
    np.testing.assert_array_equal(got.numpy(), np.asarray(spec))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_drop_distance_equivalence(geom):
    H, W, PAD, HP, WP = dims(geom)
    board = random_board(geom, 5, 0.35)
    p, rot, x, y = _probes(geom, range(0, WP - 3, 3), 11, (0, HP))
    rows, rb = _port_inputs(board, p, rot)
    got = bw.drop_distance(rows, rb, torch.from_numpy(x), torch.from_numpy(y), WP)
    assert got.dtype == torch.int32
    want = _jax_vmapped(jbw.drop_distance, board, WP)(p, rot, x, y)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_project_equivalence(geom):
    H, W, PAD, HP, WP = dims(geom)
    board = random_board(geom, 8, 0.3)
    p, rot, x, y = _probes(geom, range(0, WP - 3, 2), 13, (0, HP - 3))
    rows, rb = _port_inputs(board, p, rot)
    got = bw.project(rows, rb, torch.from_numpy(x), torch.from_numpy(y), WP)
    want = _jax_vmapped(jbw.project, board, WP)(p, rot, x, y)
    np.testing.assert_array_equal(got.numpy(), _lanes(want))
    stamped = ob.project(torch.from_numpy(board)[None].expand(p.shape[0], -1, -1),
                         torch.from_numpy(PIECES.matrices[p, rot]), torch.from_numpy(x),
                         torch.from_numpy(y), 2)
    np.testing.assert_array_equal(got.numpy(), bw.pack_board(stamped).numpy())


def make_filled_board(geom, filled_rows_idx):
    H, W, PAD, HP, WP = dims(geom)
    inner = np.zeros((H, W), dtype=np.int8)
    r = np.random.default_rng(42)
    inner[r.random((H, W)) < 0.3] = 3
    for i in filled_rows_idx:
        inner[i] = 2
    for i in range(H):
        if i not in filled_rows_idx:
            inner[i, r.integers(0, W)] = 0
    return np.pad(inner, ((0, PAD), (PAD, PAD)), constant_values=1)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("filled", [[], [0], [5, 6, 7, 8], [0, 3, 11]])
def test_clear_lines_equivalence(geom, filled):
    H, W, PAD, HP, WP = dims(geom)
    board = make_filled_board(geom, filled)
    rows = bw.pack_board(torch.from_numpy(board)[None])
    got_rows, got_n, got_filled = bw.clear_lines(rows, H, W, PAD)
    want_rows, want_n, want_filled = jbw.clear_lines(jbw.pack_board(jnp.asarray(board)), H, W, PAD)
    assert got_n.tolist() == [int(want_n)] == [len(filled)]
    np.testing.assert_array_equal(got_rows[0].numpy(), _lanes(want_rows))
    np.testing.assert_array_equal(got_filled[0].numpy(), np.asarray(want_filled))
    got_ids = bw.compact_ids(torch.from_numpy(board)[None, :H, PAD:-PAD], got_filled)
    want_board, _ = jboard.clear_lines(jnp.asarray(board), H, W, PAD)
    np.testing.assert_array_equal(got_ids[0].numpy(), np.asarray(want_board)[:H, PAD:-PAD])


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_empty_rows_matches_create_board(geom):
    H, W, PAD, HP, WP = dims(geom)
    board = ob.create_board(H, W, PAD, 1, "cpu")
    np.testing.assert_array_equal(bw.pack_board(board)[0].numpy(),
                                  bw.empty_rows(H, W, PAD).astype(np.int64))


def test_word0_bit31_in_playfield():
    """padded_width 36 puts playfield column 27 at word-0 bit 31: the
    compaction carries it, in the lanes and through a uint32 round trip."""
    H, W, PAD = 8, 28, 4
    inner = np.zeros((H, W), dtype=np.int8)
    inner[H - 1] = 2
    inner[H - 2, 27] = 3
    board = np.pad(inner, ((0, PAD), (PAD, PAD)), constant_values=1)
    rows = bw.pack_board(torch.from_numpy(board)[None])
    got_rows, got_n, _ = bw.clear_lines(rows, H, W, PAD)
    want_rows, want_n, _ = jbw.clear_lines(jbw.pack_board(jnp.asarray(board)), H, W, PAD)
    assert got_n.tolist() == [int(want_n)] == [1]
    assert int(got_rows[0, H - 1, 0]) >> 31 == 1
    np.testing.assert_array_equal(got_rows[0].numpy(), _lanes(want_rows))
    u32 = got_rows.to(torch.int32).view(torch.uint32)
    np.testing.assert_array_equal(u32_to_lanes(u32)[0].numpy(), _lanes(want_rows))


@pytest.mark.parametrize("width", [6, 10, 24, 25, 28, 30, 61])
def test_row_ops_picks_the_jax_module(width):
    """``row_ops`` picks the single-word or the multi-word module where JAX's
    ``core/engine.py:_kb`` does, by padded width, and ``wide`` agrees."""
    from tetris_gymnasium_tpu.config import EngineConfig as JConfig
    from tetris_gymnasium_tpu.core import engine as jengine

    config = JConfig(width=width)
    module = bw.row_ops(config.padded_width)
    assert module.__name__.rsplit(".", 1)[1] == jengine._kb(config).__name__.rsplit(".", 1)[1]
    assert bw.wide(config.padded_width) == (module is bw)
