"""The redesigned kernels of the Gymnasium observation wrappers:
``feature_vector`` (a warp an env, a crop row a lane with every load in
flight, the row masks turned into column masks by a bit transpose across
the warp, warp reductions) and ``compose_rgb`` (a lane a run of 16 pixels,
or of one for a batch too small to fill the card, the palette a launch
parameter copied on chip while the ids are in flight, a run's 48 bytes as
whole-word stores).

On the CPU:

* numpy models of both launch maps (``csrc/features.cu``,
  ``csrc/observe_dict.cu:compose_rgb_kernel``): for ``feature_vector`` the
  lanes to rows (two row blocks where a crop has more than 32 rows), the
  aligned 16-byte words a lane loads and crops in registers (the words
  build) or its row's bytes (the bytes build), the four-byte nonzero test,
  the funnel shift, the transpose's five shuffle stages, the heights from
  each column's lowest set bit, the holes, the bumpiness's neighbour
  shuffles and the stores a column a lane; for ``compose_rgb`` (both run
  lengths) the runs to images and envs (``n // group`` by the launcher's
  multiplier), the pixels' coordinates, the ids read
  from the board, the strips or the bedrock, the warp's palette table
  (the colours, then black for every id past them), the ``__byte_perm`` packing and the stores in the
  image's widest words with the last run's tail.  Each model must equal
  ``feature_vector_plain`` / ``compose_rgb_plain`` and JAX's
  ``feature_vector`` / ``compose_rgb`` bit for bit on seeded boards (empty,
  full, single cells, towers, holes under overhangs, negative ids, ids past
  the palette) at 10x20, 30x20, 61x12 and 28x14, crops of more than 32
  rows and of 33-128 columns, under all 16 flag sets (JAX refuses the empty
  set; the port returns the empty vector), with ``group`` > 1;
* the wrapper's choice between the two ``feature_vector`` builds (the
  words must lie inside the tensor's storage) and both launchers'
  blocks-a-batch rules.

On a card (marked ``cuda``; they skip without one, decided inside the
test): both kernels against their plain twins at every crop and geometry
above, both ``feature_vector`` builds, the paths' batches (1, 40, 120) and
batches that give every warps-a-block choice.  The file imports JAX only
inside its CPU tests, so ``python -m pytest --noconftest
tests/test_torch_wrapper_obs_redesign.py -m cuda`` runs on the card's
machine.
"""
import functools

import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.components.tetromino import Tetromino, pieces_from_tetrominoes
from tetris_gymnasium_torch.ops.observations import (FeatureFlags, compose_rgb_plain, feature_vector_plain,
                                                      n_features)
from tetris_gymnasium_torch.pieces import PIECES

WARPS = 8  # csrc/features.cu:kWarps and csrc/observe_dict.cu:kComposeWarps
SMALL_RUNS_PER_SM = 256  # csrc/observe_dict.cu:kSmallRunsPerSM
BLOCKS_PER_SM = 8  # csrc/features.cu:kBlocksPerSM: past it feature_vector's warps stride over the batch
H100_SMS = 132
M32 = 0xFFFFFFFF
FLAG_SETS = tuple(FeatureFlags(*(bool(m >> k & 1) for k in range(4))) for m in range(16))
# (rows, columns, padding) of the crops: the four geometries of the surface
# phases, more than 32 rows, 33-128 columns, one cell, an odd small board
CROPS = ((20, 10, 4), (20, 30, 4), (12, 61, 4), (14, 28, 4), (40, 33, 2), (33, 64, 3), (64, 128, 1),
         (20, 96, 4), (1, 1, 1), (13, 9, 4))
OVERSIZE_SHAPES = (((255, 0, 0), ((1, 1), (1, 1))), ((0, 255, 0), ((1, 1, 1, 1, 1, 1),)),
                   ((0, 0, 255), ((0, 1, 0), (1, 1, 1), (0, 0, 0))))
# (name, padded height, padded width, piece side, queue, holder) of the composites
COMPOSITES = (("10x20", 24, 18, 4, 4, 1), ("30x20", 24, 38, 4, 4, 1), ("61x12", 16, 69, 4, 3, 1),
              ("28x14", 18, 36, 4, 4, 1), ("queue1-holder2", 24, 18, 4, 1, 2), ("6x6-w30", 22, 42, 6, 2, 1),
              ("9x13", 17, 17, 4, 4, 1))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Boards
# ---------------------------------------------------------------------------


def _padded(seed, B, FH, FW, pad):
    """``int8[B, FH + pad, FW + 2 pad]`` boards with bedrock (1) around the
    playfield: empty, full, single cells, a tower, holes under an
    overhang, a column with every other cell, then random stacks of ids
    (negative ones among them)."""
    rng = np.random.default_rng(seed)
    full = np.ones((B, FH + pad, FW + 2 * pad), np.int8)
    pf = rng.integers(-3, 12, (B, FH, FW)).astype(np.int8)
    pf *= (rng.random((B, FH, FW)) < rng.random((B, 1, 1))).astype(np.int8)
    hand = [np.zeros((FH, FW), np.int8) for _ in range(6)]
    hand[1][:] = 2
    hand[2][FH - 1, 0] = 7
    hand[2][0, FW - 1] = -5
    hand[3][FH // 2:, FW // 2] = 4
    hand[4][FH // 3, :] = 5
    hand[4][FH - 1, ::2] = 3
    hand[5][::2, FW - 1] = 6
    for i in range(min(B, 6)):
        pf[i] = hand[i]
    full[:, :FH, pad:pad + FW] = pf
    return full


def _ids(seed, shape, hi=14):
    """Ids up to ``hi`` (past the palette), with 255 in the first image."""
    a = np.random.default_rng(seed).integers(0, hi, shape).astype(np.uint8)
    a.reshape(-1)[:3] = (255, 200, 0)
    return a


def _oversize_pieces():
    return pieces_from_tetrominoes([Tetromino(2 + i, c, np.array(m, np.uint8))
                                    for i, (c, m) in enumerate(OVERSIZE_SHAPES)])[0]


def _pieces(name):
    return _oversize_pieces() if name.startswith("6x6") else PIECES


# ---------------------------------------------------------------------------
# The feature_vector model
# ---------------------------------------------------------------------------


def full_row_word(FW, k):
    """``features.cuh:full_row_word``."""
    return M32 if 32 * k + 32 <= FW else (1 << (FW - 32 * k)) - 1


def nonzero_bytes(x):
    """``features.cu:nonzero_bytes``: bit i is byte i of x not 0."""
    t = ((((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) >> 7) & 0x01010101
    return ((t * 0x01020408) & M32) >> 24


def nonzero_bytes16(word):
    """``features.cu:nonzero_bytes16`` of 16 bytes ``uint8[..., 16]``."""
    u = word.astype(np.int64)
    lanes = [u[..., 4 * i] | u[..., 4 * i + 1] << 8 | u[..., 4 * i + 2] << 16 | u[..., 4 * i + 3] << 24
             for i in range(4)]
    return sum(nonzero_bytes(v) << (4 * i) for i, v in enumerate(lanes))


def transpose32(x):
    """``features.cu:transpose32`` on ``[E, 32]`` lanes: each stage a
    ``__shfl_xor_sync`` and the off-diagonal blocks swapped."""
    lane = np.arange(32)
    for s, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        y = x[:, lane ^ s]
        nm = ~m & M32
        x = np.where((lane & s) != 0, (x & nm) | ((y & nm) >> s), (x & m) | (((y & m) << s) & M32))
    return x


def feature_words(addr, B, FH, FW, bs, rs, lo, hi):
    """``kernels._feature_words``: every 16-byte word that holds a byte of a
    crop row lies inside the storage ``[lo, hi)``."""
    last = addr + (B - 1) * bs + (FH - 1) * rs + FW
    return addr // 16 * 16 >= lo and -(-last // 16) * 16 <= hi


def model_feature_vector(buf, base, bs, rs, B, FH, FW, flags, words, addr0=0):
    """The kernel's program on the storage's bytes ``buf`` (element (b, r,
    c) of the crop at ``base + b * bs + r * rs + c``, ``buf[0]`` at address
    ``addr0``): a warp an env, lane r rows r and r + 32.  Returns ``int32[B,
    n]``; every element written once."""
    NWF, NRB = -(-FW // 32), -(-FH // 32)
    NWW = (15 + FW + 15) // 16
    NW32 = max(-(-NWW // 2), NWF + 1)
    lane = np.arange(32)
    env = base + np.arange(B)[:, None] * bs  # [B, 1]
    m = np.zeros((NRB, NWF, B, 32), np.int64)
    for j in range(NRB):
        r = lane + 32 * j
        live = np.broadcast_to(r < FH, (B, 32))
        p = env + r * rs  # [B, 32] offsets into buf
        if words:
            off = (addr0 + p) % 16
            aligned = p - off
            bits = np.zeros((NW32, B, 32), np.int64)
            for q in range(NWW):
                need = live & (16 * q < off + FW)
                at = aligned + 16 * q
                assert (at[need] >= 0).all() and (at[need] + 16 <= len(buf)).all(), "a word past the storage"
                w = np.where(need[..., None], buf[np.where(need, at, 0)[..., None] + np.arange(16)], 0)
                bits[q // 2] |= nonzero_bytes16(w) << (16 * (q % 2))
            for k in range(NWF):
                fun = ((bits[k + 1] << 32 | bits[k]) >> off) & M32  # __funnelshift_r
                m[j, k] = fun & full_row_word(FW, k)
        else:
            for c in range(FW):
                v = np.where(live, buf[np.where(live, p + c, 0)].view(np.int8), 0)
                m[j, c // 32] |= (v != 0).astype(np.int64) << (c % 32)
    col = np.stack([[transpose32(m[j, k]) for k in range(NWF)] for j in range(NRB)])
    h = np.zeros((NWF, B, 32), np.int64)
    holes = np.zeros((B, 32), np.int64)
    for k in range(NWF):
        v = col[0, k].astype(np.uint64) | (col[NRB - 1, k].astype(np.uint64) << np.uint64(32) if NRB == 2
                                           else np.uint64(0))
        low = v & (~v + np.uint64(1))
        ffs = np.where(v != 0, np.log2(np.maximum(low, 1).astype(np.float64)).astype(np.int64) + 1, 0)
        h[k] = np.where(v != 0, FH + 1 - ffs, 0)
        holes += h[k] - np.bitwise_count(v).astype(np.int64)
    bump = np.zeros((B, 32), np.int64)
    for k in range(NWF):
        nxt = np.concatenate([h[k][:, 1:], h[k][:, 31:]], axis=1)  # __shfl_down_sync(h, 1)
        if NWF > 1:
            wrap = (h[k + 1] if k + 1 < NWF else np.zeros_like(h[k]))[:, :1]  # lane 0's next word
            nxt[:, 31:] = wrap
        bump += np.where(lane + 32 * k + 1 < FW, np.abs(h[k] - nxt), 0)
    max_h, holes, bump = h.max(axis=(0, 2)), holes.sum(axis=1), bump.sum(axis=1)
    n = n_features(FW, flags)
    out = np.zeros((B, n), np.int64)
    written = np.zeros((B, n), np.int64)

    def store(i, v, lanes):
        out[:, i] = v
        written[:, i] += lanes

    if flags.height:
        for k in range(NWF):
            for c in range(32):
                if c + 32 * k < FW:
                    store(c + 32 * k, h[k][:, c], 1)
    i_max = FW if flags.height else 0
    i_holes = i_max + int(flags.max_height)
    i_bump = i_holes + int(flags.holes)
    if flags.max_height:
        store(i_max, max_h, 1)
    if flags.holes:
        store(i_holes, holes, 1)
    if flags.bumpiness:
        store(i_bump, bump, 1)
    assert (written == 1).all()
    return out.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_features(flags):
    import jax

    from tetris_gymnasium_tpu.ops import observations as jobs

    return jax.vmap(lambda p: jobs.feature_vector(p, jobs.FeatureFlags(*flags)))


def _jax_feature_vector(crop, flags):
    """JAX's vector, or the port's empty one where JAX refuses the empty set."""
    import jax.numpy as jnp

    if not any(flags):
        with pytest.raises(ValueError):
            _jax_features(tuple(flags))(jnp.asarray(crop))
        return np.zeros((crop.shape[0], 0), np.int32)
    return np.asarray(_jax_features(tuple(flags))(jnp.asarray(crop)))


def _crop_view(full, pad, FH):
    """The wrapper's view ``board[:, :-pad, pad:-pad]``: storage, byte offset, strides."""
    B, Hp, PW = full.shape
    return full.reshape(-1).view(np.uint8), pad, Hp * PW, PW


# ---------------------------------------------------------------------------
# The compose_rgb model
# ---------------------------------------------------------------------------


def word_bytes(n):
    """``board_words.cuh:word_bytes``."""
    return next(w for w in (16, 8, 4, 2, 1) if n % w == 0)


def byte_perm(x, y, s):
    """``__byte_perm(x, y, s)``: byte i of the result is byte ``s >> 4 i & 7`` of y:x."""
    v = (y << 32) | x
    return sum(((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def compose_shape(H, PW, S, QS, HS, R=16):
    """``observe_dict.cu:Run<R>``: the image's width, its runs, the last
    run's pixels and the store word."""
    IW = PW + S * max(QS, HS)
    img = H * IW
    runs = -(-img // R)
    return IW, runs, img - R * (runs - 1), min(word_bytes(3 * img), word_bytes(3 * R))


def compose_run(N, runs16, sms):
    """``observe_dict.cu:compose_run``: 1-pixel runs while 16-pixel ones
    would give the SMs fewer than 256 lanes each."""
    return 1 if N * runs16 < SMALL_RUNS_PER_SM * sms else 16


def compose_warps(runs):
    """``observe_dict.cu:compose_warps`` for a launch of ``runs`` runs."""
    return min(WARPS, -(-runs // 32))


def model_compose_rgb(board, queue, holder, palette, group, S, R=16):
    """The kernel's program: lane g takes run g % RUNS (R pixels) of image
    g // RUNS, its env ``n // group``; returns ``uint8[N, H, IW, 3]``, every
    byte written once, every store aligned to its word."""
    N, H, PW = board.shape
    QS, HS = queue.shape[2] // S, holder.shape[2] // S
    IW, RUNS, TAIL, SW = compose_shape(H, PW, S, QS, HS, R)
    npal = palette.shape[0]
    table = np.zeros(npal + 1, np.int64)  # the colours, then black
    p = palette.astype(np.int64)
    table[:npal] = p[:, 0] | p[:, 1] << 8 | p[:, 2] << 16
    g = np.arange(N * RUNS)
    n, k = g // RUNS, g % RUNS
    magic, shift = kernels.group_divider(group)  # the kernel's n // group
    m = n if shift < 0 else ((n * magic) >> 32) >> shift
    assert (m == n // group).all()
    last = k + 1 == RUNS
    r0, c0 = (R * k) // IW, (R * k) % IW
    ids = np.zeros((R, g.size), np.int64)
    for i in range(R):
        live = ~last | (i < TAIL)
        t = c0 + i
        j = t // IW  # the row of the run's span (selects over its rows in the kernel)
        r, c = r0 + j, t - j * IW
        sc = c - PW
        width = np.where(r < S, S * QS, np.where(r >= H - S, S * HS, 0))
        on_board = live & (c < PW)
        in_side = live & ~on_board & (sc < width)
        rr, cc = np.clip(r, 0, H - 1), np.clip(c, 0, PW - 1)
        v = np.ones(g.size, np.int64)  # kBedrock
        v = np.where(on_board, board[n, rr, cc], v)
        side = np.where(r < S, queue[m, np.clip(r, 0, S - 1), np.clip(sc, 0, S * QS - 1)],
                        holder[m, np.clip(r - (H - S), 0, S - 1), np.clip(sc, 0, S * HS - 1)])
        ids[i] = np.where(in_side, side, v)
    col = table[np.minimum(ids, npal)]
    w = np.zeros(((3 * R + 3) // 4, g.size), np.int64)
    if R == 1:
        w[0] = col[0]
    for q in range(R // 4):
        a, b, c2, d = col[4 * q], col[4 * q + 1], col[4 * q + 2], col[4 * q + 3]
        w[3 * q] = byte_perm(a, b, 0x4210)
        w[3 * q + 1] = byte_perm(b, c2, 0x5421)
        w[3 * q + 2] = byte_perm(c2, d, 0x6542)
    run_bytes = np.ascontiguousarray(w.T.astype("<u4")).view(np.uint8)  # [lanes, 3 R] and a pad
    out = np.zeros(N * H * IW * 3, np.uint8)
    written = np.zeros(out.size, np.int64)
    dst = n * 3 * H * IW + 3 * R * k
    nwords = np.where(last, 3 * TAIL // SW, 3 * R // SW)
    for q in range(3 * R // SW):
        sel = q < nwords
        at = dst[sel] + q * SW
        assert (at % SW == 0).all()
        idx = at[:, None] + np.arange(SW)
        out[idx] = run_bytes[sel][:, q * SW:(q + 1) * SW]
        np.add.at(written, idx.reshape(-1), 1)
    assert (written == 1).all()
    return out.reshape(N, H, IW, 3)


@functools.lru_cache(maxsize=None)
def _jax_compose(name):
    import jax

    from tetris_gymnasium_tpu.components.tetromino import Tetromino as JTetromino
    from tetris_gymnasium_tpu.components.tetromino import pieces_from_tetrominoes as jpieces_from
    from tetris_gymnasium_tpu.ops import observations as jobs
    from tetris_gymnasium_tpu.pieces import PIECES as JPIECES

    jp = JPIECES
    if name.startswith("6x6"):
        jp = jpieces_from([JTetromino(2 + i, c, np.array(mat, np.uint8))
                           for i, (c, mat) in enumerate(OVERSIZE_SHAPES)])[0]
    return jax.vmap(lambda b, q, h: jobs.compose_rgb(b, q, h, jp))


def _strips(name, S, QS, HS, M, seed):
    return _ids(seed + 1, (M, S, S * QS), 12), _ids(seed + 2, (M, S, S * HS), 12)


# ---------------------------------------------------------------------------
# CPU: the models against the plain twins and JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("crop", CROPS, ids=[f"{h}x{w}" for h, w, _ in CROPS])
def test_feature_model_matches_plain_and_jax(crop):
    """Both builds' programs on the wrapper's crop view of padded boards,
    under all 16 flag sets, against the plain twin and JAX."""
    FH, FW, pad = crop
    B = 7
    full = _padded(FH * 131 + FW, B, FH, FW, pad)
    buf, base, bs, rs = _crop_view(full, pad, FH)
    crop_np = full[:, :FH, pad:pad + FW]
    t = torch.from_numpy(full)[:, :FH, pad:pad + FW]
    lo = t.untyped_storage().data_ptr()
    inside = kernels._feature_words(t)
    assert inside == feature_words(t.data_ptr(), B, FH, FW, bs, rs, lo, lo + buf.size)
    assert inside or crop == (1, 1, 1)  # 42 bytes end inside a word
    for flags in FLAG_SETS:
        want = feature_vector_plain(t, flags).numpy()
        for words in (True, False) if inside else (False,):
            np.testing.assert_array_equal(
                model_feature_vector(buf, base, bs, rs, B, FH, FW, flags, words, addr0=lo), want,
                err_msg=f"{crop} {flags} words={words}")
        np.testing.assert_array_equal(_jax_feature_vector(crop_np, flags), want, err_msg=f"JAX {crop} {flags}")


def test_feature_model_on_unpadded_and_misaligned_storage():
    """A contiguous unpadded crop whose storage ends inside a 16-byte word
    (B odd at 10 x 20: 200 bytes an env) and a storage that starts 8 bytes
    past a 16-byte boundary: the wrapper's rule refuses the words build
    there, the bytes build equals the plain twin, and the rule on real
    tensors agrees with the model's."""
    FH, FW = 20, 10
    full = _padded(5, 5, FH, FW, 0)
    play = np.ascontiguousarray(full[:, :FH])
    buf = play.reshape(-1).view(np.uint8)
    want = feature_vector_plain(torch.from_numpy(play)).numpy()
    assert not feature_words(0, 5, FH, FW, FH * FW, FW, 0, buf.size)
    np.testing.assert_array_equal(model_feature_vector(buf, 0, FH * FW, FW, 5, FH, FW, FeatureFlags(), False), want)
    for B in (4, 5):  # 800 bytes end on a word, 1000 do not
        t = torch.from_numpy(np.ascontiguousarray(full[:B, :FH]))
        assert kernels._feature_words(t) == feature_words(t.data_ptr(), B, FH, FW, FH * FW, FW,
                                                          t.untyped_storage().data_ptr(),
                                                          t.untyped_storage().data_ptr() + B * FH * FW)
        assert kernels._feature_words(t) == (B % 4 == 0 or t.data_ptr() % 16 == 0 and B * 200 % 16 == 0)
    # a storage 8 bytes past a boundary: the first row's word would start before it
    assert not feature_words(8, 5, FH, FW, FH * FW, FW, 8, 8 + buf.size)
    full = _padded(6, 3, FH, FW, 4)
    buf, base, bs, rs = _crop_view(full, 4, FH)
    want = feature_vector_plain(torch.from_numpy(full)[:, :FH, 4:14]).numpy()
    for addr0 in (0, 4, 8, 12):  # the words' offsets differ, the vector does not
        np.testing.assert_array_equal(
            model_feature_vector(buf, base, bs, rs, 3, FH, FW, FeatureFlags(), True, addr0=addr0 - addr0 % 16),
            want)
        np.testing.assert_array_equal(
            model_feature_vector(buf, base, bs, rs, 3, FH, FW, FeatureFlags(), False, addr0=addr0), want)


def test_transpose32_model_is_the_bit_transpose():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 32, (4, 32), dtype=np.int64)
    bits = (x[:, :, None] >> np.arange(32)) & 1  # [E, row, col]
    want = (bits.transpose(0, 2, 1) << np.arange(32)).sum(axis=2)
    np.testing.assert_array_equal(transpose32(x), want)


def test_nonzero_bytes_of_every_byte():
    """The four-byte test on each byte value in each position, and on
    words mixing them."""
    v = np.arange(256, dtype=np.int64)
    for i in range(4):
        np.testing.assert_array_equal(nonzero_bytes(v << (8 * i)), (v != 0).astype(np.int64) << i)
    rng = np.random.default_rng(4)
    b = rng.integers(0, 256, (500, 16)) * (rng.random((500, 16)) < 0.5)
    want = ((b != 0) << np.arange(16)).sum(axis=1)
    np.testing.assert_array_equal(nonzero_bytes16(b.astype(np.uint8)), want)


@pytest.mark.parametrize("B", [1, 40, 120, 133, 265, 1057, 4096, 65536])
def test_feature_envs_a_block_rule(B):
    """``min(8, ceil(B / SMs))`` warps a block, at most 8 blocks an SM, the
    warps striding over the rest: every env taken by one warp once, no
    block empty, B = 1 and 40 one env a block on the H100."""
    for sms in (H100_SMS, 7, 1):
        envs = min(WARPS, max(1, -(-B // sms)))
        blocks = min(-(-B // envs), BLOCKS_PER_SM * sms)
        warps = blocks * envs
        taken = np.concatenate([np.arange(w, B, warps) for w in range(warps)])
        assert np.array_equal(np.sort(taken), np.arange(B))
        assert (blocks - 1) * envs < B  # no block without an env
        if sms == H100_SMS and B <= H100_SMS:
            assert envs == 1


@pytest.mark.parametrize("geo", COMPOSITES, ids=[g[0] for g in COMPOSITES])
def test_compose_model_matches_plain_and_jax(geo):
    """Ids past the palette, every strip cell, group 1 and > 1."""
    name, H, PW, S, QS, HS = geo
    pieces = _pieces(name)
    for N, group in ((3, 1), (6, 3), (5, 5)):
        board = _ids(N * 7 + H, (N, H, PW))
        queue, holder = _strips(name, S, QS, HS, N // group, N)
        tb, tq, th = (torch.from_numpy(a) for a in (board, queue, holder))
        want = compose_rgb_plain(tb, tq, th, pieces, group).numpy()
        for R in (16, 1):
            np.testing.assert_array_equal(model_compose_rgb(board, queue, holder, pieces.palette, group, S, R),
                                          want, err_msg=f"{name} N={N} group={group} run={R}")
        jq, jh = np.repeat(queue, group, axis=0), np.repeat(holder, group, axis=0)
        np.testing.assert_array_equal(np.asarray(_jax_compose(name)(board, jq, jh)), want,
                                      err_msg=f"JAX {name} N={N} group={group}")


def test_compose_runs_and_store_words_of_the_geometries():
    """Runs an image, the last run's pixels and the store word: for 16-pixel
    runs whole 16-byte words at 10x20, 30x20 and 61x12, 8-byte words and
    an 8-pixel tail at 28x14, byte stores at an odd board; for 1-pixel runs
    bytes.  The paths' batches (1, the 40 and 120 candidates) take 1-pixel
    runs on the H100, 4096 and more 16-pixel ones."""
    want = {"10x20": (34, 51, 16, 16), "30x20": (54, 81, 16, 16), "61x12": (81, 81, 16, 16),
            "28x14": (52, 59, 8, 8), "queue1-holder2": (26, 39, 16, 16), "9x13": (33, 36, 1, 1)}
    shapes = {g[0]: compose_shape(*g[1:]) for g in COMPOSITES}
    for name, (iw, runs, tail, sw) in want.items():
        assert shapes[name] == (iw, runs, tail, sw), name
    assert compose_shape(24, 18, 4, 4, 1, 1) == (34, 816, 1, 1)
    assert compose_shape(18, 36, 4, 4, 1, 1) == (52, 936, 1, 1)
    for N, runs16 in ((1, 51), (40, 51), (1, 81), (120, 81)):
        assert compose_run(N, runs16, H100_SMS) == 1
    assert compose_warps(816) == 8 and compose_warps(13) == 1
    for N in (4096, 65536):
        assert compose_run(N, 51, H100_SMS) == 16 and compose_warps(N * 51) == 8


def test_wrappers_refuse_cpu_tensors():
    """No fallback inside the wrappers: the CPU's plain twins are reached
    only by dispatch on the tensor's device (``ops/observations.py``)."""
    crop = torch.zeros((2, 20, 10), dtype=torch.int8)
    with pytest.raises(ValueError):
        kernels.feature_vector(crop, FeatureFlags())
    b = torch.zeros((2, 24, 18), dtype=torch.uint8)
    q, h = torch.zeros((2, 4, 16), dtype=torch.uint8), torch.zeros((2, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        kernels.compose_rgb(b, q, h, PIECES)


def test_forced_builds_are_restored_and_batch_counts_reset():
    """``kernels._forced`` holds a build only inside its block, also when
    the block raises; ``reset_launches`` clears the counts by batch."""
    with kernels._forced("feature_vector", False), kernels._forced("compose_rgb", 16):
        assert kernels._FORCE == {"feature_vector": False, "compose_rgb": 16}
    with pytest.raises(RuntimeError), kernels._forced("compose_rgb", 1):
        raise RuntimeError
    assert kernels._FORCE == {}
    kernels.LAUNCHES_BY_BATCH["feature_vector@1"] = 3
    kernels.reset_launches()
    assert kernels.LAUNCHES_BY_BATCH == {} and not any(kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The card: the kernels against their plain twins
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_batches(sms):
    """The paths' batches (1, 40, 120), batches that give every
    warps-a-block choice with a ragged last block, and one whose warps
    stride over it (``feature_vector``'s blocks capped)."""
    return sorted({1, 40, 120} | {sms * (k - 1) + 1 for k in range(1, WARPS + 1)} | {sms * WARPS + 5}
                  | {sms * WARPS * BLOCKS_PER_SM * 2 + 3})


@pytest.mark.cuda
@pytest.mark.parametrize("crop", CROPS, ids=[f"{h}x{w}" for h, w, _ in CROPS])
def test_feature_vector_matches_plain_on_the_card(cuda, crop):
    FH, FW, pad = crop
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B in _card_batches(sms):
        full = torch.from_numpy(_padded(B + FW, B, FH, FW, pad)).to(cuda)
        view = full[:, :FH, pad:pad + FW]
        shape = kernels.feature_vector_shape(FH, FW, B)
        envs = min(WARPS, max(1, -(-B // sms)))
        assert (shape["envs_per_block"], shape["blocks"]) == (envs, min(-(-B // envs), BLOCKS_PER_SM * sms))
        inside = kernels._feature_words(view)
        assert inside or crop == (1, 1, 1)  # 42 bytes an env: the last row's word ends past the storage
        for flags in (FLAG_SETS if B in (1, 40) else (FeatureFlags(), FLAG_SETS[5])):
            want = feature_vector_plain(view.cpu(), flags)
            for words in (None, True, False) if inside else (None, False):
                with kernels._forced("feature_vector", words):
                    got = kernels.feature_vector(view, flags)
                assert torch.equal(got.cpu(), want), (crop, B, tuple(flags), words)
    # an unpadded contiguous crop of odd B ends inside a word: the bytes build
    play = torch.from_numpy(np.ascontiguousarray(_padded(9, 5, FH, FW, pad)[:, :FH, pad:pad + FW])).to(cuda)
    if FH * FW % 16:
        assert not kernels._feature_words(play)
    got = kernels.feature_vector(play, FeatureFlags())
    assert torch.equal(got.cpu(), feature_vector_plain(play.cpu())), crop


@pytest.mark.cuda
@pytest.mark.parametrize("geo", COMPOSITES, ids=[g[0] for g in COMPOSITES])
def test_compose_rgb_matches_plain_on_the_card(cuda, geo):
    name, H, PW, S, QS, HS = geo
    pieces = _pieces(name)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    IW, runs, _, _ = compose_shape(H, PW, S, QS, HS)
    for N in _card_batches(sms):
        for group in sorted({1, N} | ({40} if N % 40 == 0 else set())):
            board = _ids(N + H, (N, H, PW))
            queue, holder = _strips(name, S, QS, HS, N // group, N + group)
            args = [torch.from_numpy(a) for a in (board, queue, holder)]
            want = compose_rgb_plain(*args, pieces, group)
            for run in (None, 16, 1):
                with kernels._forced("compose_rgb", run):
                    got = kernels.compose_rgb(*(a.to(cuda) for a in args), pieces, group)
                assert torch.equal(got.cpu(), want), (name, N, group, run)
        if name in ("10x20", "30x20"):
            from tetris_gymnasium_torch.config import EngineConfig

            shape = kernels.compose_rgb_shape(EngineConfig(width=PW - 8, height=H - 4), pieces, N)
            R = compose_run(N, runs, sms)
            assert (shape["run_pixels"], shape["warps_per_block"]) == \
                (R, compose_warps(N * compose_shape(H, PW, S, QS, HS, R)[1]))
