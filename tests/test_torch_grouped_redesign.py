"""The redesigned ``grouped_act`` (a group of lanes an env) and
``grouped_flagship`` (an env's shared work once, boards built a row at a
time).

On the CPU:

* ``grouped_act``'s lane program (``csrc/grouped_act.cu``): a numpy model
  in which the group's L lanes are a loop, each keeping a running best
  (value, index) over candidates l, l + L, ... in order, and the shuffle
  butterfly is the same pairwise combine in the same order (lane l takes
  lane l ^ off's pair where it wins, off = L / 2 ... 1; lane L - 1 reads
  the result).  For every lane width the wrapper may pick it must equal
  ``act_plain`` and JAX's selection (``_masked_random``, ``train_step``'s
  ``where``, ``greedy_masked_q``) on ties inside a lane and across lanes,
  NaNs in one lane and in several, +-0.0, rows with every candidate
  illegal, fills -1e9 and -inf, epsilon 0, 1 and float32(0.3), A = 4 x the
  widths of the JAX tests (not all multiples of L) and the mask as the
  engine's ``[A, B]`` transposed;
* ``grouped_flagship``'s structure (``csrc/grouped_flagship.cu``): a numpy
  model of the env's shared tables (occupancy tops of the first S + 1 rows,
  the playfield's filled tops at every row, the heights' sum and
  bumpiness, the rows' counts, the full rows), the drop from the column
  tops, the window rows after the lock as the staged row words ORed with
  the piece rows (cell by cell where a piece cell lies on a negative id),
  the features of a candidate that clears nothing patched from the
  env's, the fold of a candidate that clears rows, and the boards built a
  row at a time from the row-source map (the kept row of rank r - n as a
  fixed point).  In all three modes it must equal
  ``grouped_observation_plain`` / ``placements_plain`` and JAX's
  ``placements`` and ``grouped_observation`` at the geometries of
  ``chip_smoke.py``'s phases 26, 35 and 39, under all 16 feature-flag sets,
  on seeded trajectories and on hand-built stacks with clears of several
  rows, illegal and game-over candidates and cells that the lock's add
  wraps;
* the wrappers' lane choices and the limits they name.

On a card (marked ``cuda``; they skip without one, decided inside the
test): every lane width of ``grouped_act`` on both mask layouts, and
``grouped_flagship`` in its three modes at every geometry, against the
plain twins.  This file imports JAX only inside its CPU tests, so ``python
-m pytest --noconftest tests/test_torch_grouped_redesign.py -m cuda`` runs
on the card's machine.
"""
import functools

import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.components.tetromino import Tetromino, pieces_from_tetrominoes
from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import engine, grouped, turbo
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.ops.observations import FeatureFlags, feature_vector_plain
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES
from tetris_gymnasium_torch.rl.grouped_dqn import NEG_INF, act_plain

CPU = "cpu"
FLAG_SETS = tuple(FeatureFlags(*(bool(m >> k & 1) for k in range(4))) for m in range(16))
ACT_WIDTHS = (8, 10, 28, 30, 61)  # A = 32, 40, 112, 120, 244


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# grouped_act's lane program, in numpy
# ---------------------------------------------------------------------------


def _wins(v, i, w, j):
    """csrc/grouped_act.cu:wins over arrays: (v, i) beats (w, j) in
    jnp.argmax's order."""
    with np.errstate(invalid="ignore"):
        nv, nw = np.isnan(v), np.isnan(w)
        return np.where(nv, ~nw | (i < j), np.where(nw, False, (v > w) | ((v == w) & (i < j))))


def _lane_argmax(vals, lanes):
    """The kernel's argmax of ``vals`` float32[B, A] over a group of
    ``lanes`` lanes: int32[B]."""
    B, A = vals.shape
    bv = np.full((B, lanes), -np.inf, np.float32)
    bi = np.full((B, lanes), A, np.int64)
    for lane in range(lanes):
        for a in range(lane, A, lanes):
            v = vals[:, a]
            take = np.ones(B, bool) if a == lane else _wins(v, a, bv[:, lane], bi[:, lane])
            bv[:, lane] = np.where(take, v, bv[:, lane])
            bi[:, lane] = np.where(take, a, bi[:, lane])
    off = lanes // 2
    while off >= 1:
        partner = np.arange(lanes) ^ off
        w, j = bv[:, partner], bi[:, partner]
        take = _wins(w, j, bv, bi)
        bv, bi = np.where(take, w, bv), np.where(take, j, bi)
        off //= 2
    out = bi[:, lanes - 1]
    return np.where(out == A, 0, out).astype(np.int32)


def _act_model(q, mask, act_key, eps_key, epsilon, fill, lanes):
    """The kernel's actions: the greedy argmax, and with the keys the
    Gumbel argmax where the env's uniform is below epsilon."""
    B, A = q.shape
    legal = mask > 0
    greedy = _lane_argmax(np.where(legal, q, np.float32(fill)), lanes)
    if act_key is None:
        return greedy
    counters = torch.arange(B * A, dtype=torch.int64).reshape(B, A)
    noise = threefry.gumbel_lanes(act_key, counters).numpy()
    random_a = _lane_argmax(np.where(legal, noise, np.float32(fill)), lanes)
    u = threefry.bits_to_uniform_lanes(
        threefry.random_bits32_lanes(eps_key, torch.arange(B, dtype=torch.int64))).numpy()
    return np.where(u < np.float32(epsilon), random_a, greedy).astype(np.int32)


def _act_case(kind, B, A, rng, lanes_hint=16):
    """q float32[B, A] and the mask as float32[A, B] (the engine's layout)."""
    if kind == "ties":  # few distinct values: ties inside a lane and across lanes
        q = rng.integers(0, 3, (B, A)).astype(np.float32) * np.float32(2**-20)
    elif kind == "signed_zeros":
        q = np.where(rng.random((B, A)) < 0.5, np.float32(0.0), np.float32(-0.0)).astype(np.float32)
    else:
        q = rng.standard_normal((B, A)).astype(np.float32)
    if kind == "nan_one_lane":  # NaNs only at candidates of lane 3 (of a 16-lane group)
        cols = np.arange(A) % lanes_hint == 3
        q[:, cols] = np.where(rng.random((B, cols.sum())) < 0.5, np.nan, q[:, cols])
    elif kind == "nan_lanes":
        q = np.where(rng.random((B, A)) < 0.08, np.float32(np.nan), q).astype(np.float32)
    mask_ab = (rng.random((A, B)) < 0.5).astype(np.float32)
    mask_ab[:, ::4] = 0.0  # every fourth env has no legal candidate
    if kind == "ties":
        mask_ab[:, 1] = 1.0
        q[1] = np.float32(0.5)  # every legal candidate tied
    return q, mask_ab


@functools.lru_cache(maxsize=None)
def _jax_select():
    import jax
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.rl import grouped_dqn as jgd

    def train_select(q, mask, act_key, eps_key, eps):
        greedy = jnp.argmax(jnp.where(mask > 0, q, jgd.NEG_INF), axis=-1)
        random_a = jgd._masked_random(act_key, mask)
        explore = jax.random.uniform(eps_key, (q.shape[0],)) < eps
        return jnp.where(explore, random_a, greedy).astype(jnp.int32)

    def greedy_masked(q, mask):  # rl/evaluate.py:greedy_masked_q's selection
        return jnp.argmax(jnp.where(mask > 0, q, -jnp.inf), axis=-1).astype(jnp.int32)

    return jax.jit(train_select), jax.jit(greedy_masked)


@pytest.mark.parametrize("kind", ["randn", "ties", "nan_one_lane", "nan_lanes", "signed_zeros"])
@pytest.mark.parametrize("width", ACT_WIDTHS)
def test_act_lane_model_matches_plain_and_jax(kind, width):
    import jax.numpy as jnp

    B, A = 9, 4 * width
    rng = np.random.default_rng(width * 7 + len(kind))
    q, mask_ab = _act_case(kind, B, A, rng)
    mask = mask_ab.T  # the engine's [A, B] mask, transposed: a strided view
    assert not mask.flags.c_contiguous
    qt, mt = torch.from_numpy(q), torch.from_numpy(mask_ab).T
    train_select, greedy_masked = _jax_select()
    act_key, eps_key = threefry.split(threefry.prng_key(width + len(kind)))
    for fill in (NEG_INF, float("-inf")):
        greedy_want = act_plain(qt, mt, fill=fill).numpy()
        if fill == float("-inf"):
            np.testing.assert_array_equal(greedy_want, np.asarray(greedy_masked(jnp.asarray(q), jnp.asarray(mask))))
        for lanes in kernels.GROUPED_ACT_LANES:
            np.testing.assert_array_equal(_act_model(q, mask, None, None, 0.0, fill, lanes), greedy_want,
                                          err_msg=f"greedy, fill {fill}, {lanes} lanes")
        for eps in (0.0, 1.0, np.float32(0.3)):
            want = act_plain(qt, mt, act_key, eps_key, eps, fill).numpy()
            if fill == NEG_INF:
                np.testing.assert_array_equal(want, np.asarray(train_select(
                    jnp.asarray(q), jnp.asarray(mask), jnp.asarray(act_key), jnp.asarray(eps_key),
                    jnp.float32(eps))))
            for lanes in kernels.GROUPED_ACT_LANES:
                np.testing.assert_array_equal(_act_model(q, mask, act_key, eps_key, eps, fill, lanes), want,
                                              err_msg=f"eps {eps}, fill {fill}, {lanes} lanes")
    assert (greedy_want[::4] == 0).all()  # no legal candidate: index 0


def test_act_combine_keeps_the_lowest_index_across_lanes():
    """Equal maxima on several lanes, +0.0 after -0.0, and a NaN after an
    earlier NaN: the lowest index wins, whichever lane holds it."""
    A = 40
    vals = np.full((4, A), -1.0, np.float32)
    vals[0, [5, 21, 37]] = 2.0  # lanes 5, 5 and 5 of 16; 5, 21, 5 of 32; 5, 5, 5 of 8
    vals[1, 9], vals[1, 2] = 0.0, -0.0  # equal: index 2
    vals[2, [30, 7, 12]] = np.nan  # the first NaN: 7
    vals[3, 39] = np.inf
    want = np.argmax(np.where(np.isnan(vals), np.inf, vals), axis=-1)
    want[2] = 7
    for lanes in kernels.GROUPED_ACT_LANES:
        got = _lane_argmax(vals, lanes)
        np.testing.assert_array_equal(got, [5, 2, 7, 39])
        np.testing.assert_array_equal(got, torch.argmax(torch.from_numpy(vals), dim=-1).numpy())


def test_act_lane_choice_and_limits():
    """The widest group whose lanes stay within the budget: 32 at the
    grouped DQN's 1024 envs, 16 at 4096, 8 from 8192 on."""
    picks = {B: kernels.grouped_act_lanes(B) for B in (1, 512, 1024, 2048, 2049, 4096, 8192, 65536)}
    assert picks == {1: 32, 512: 32, 1024: 32, 2048: 32, 2049: 16, 4096: 16, 8192: 8, 65536: 8}
    q = torch.zeros((4, 40))
    with pytest.raises(ValueError, match="lanes must be one of"):
        kernels.grouped_act(q, q, lanes=12)


# ---------------------------------------------------------------------------
# grouped_flagship's structure, in numpy
# ---------------------------------------------------------------------------


def _oversize_pieces():
    """The 6x6-box set of chip_smoke.py:wide_geometries, in both packages."""
    from tetris_gymnasium_tpu.components.tetromino import Tetromino as JTetromino
    from tetris_gymnasium_tpu.components.tetromino import pieces_from_tetrominoes as jpieces_from

    shapes = [((255, 0, 0), np.array([[1, 1], [1, 1]], np.uint8)),
              ((0, 255, 0), np.ones((1, 6), np.uint8)),
              ((0, 0, 255), np.array([[0, 1, 0], [1, 1, 1], [0, 0, 0]], np.uint8))]
    mine, pad = pieces_from_tetrominoes([Tetromino(2 + i, c, m) for i, (c, m) in enumerate(shapes)])
    theirs, _ = jpieces_from([JTetromino(2 + i, c, m) for i, (c, m) in enumerate(shapes)])
    return mine, theirs, pad


def _geometry(name):
    """``(config kwargs, oversize)`` of chip_smoke.py's phases 26 (10x20),
    35 (surface_geometries) and 39 (30x20, 61x12)."""
    oversize = dict(height=16, queue_size=2, queue_kind="uniform", auto_reset=True)
    return {
        "10x20": (dict(auto_reset=True), False),
        "30x20": (dict(width=30, height=20, auto_reset=True), False),
        "30x20-nograv": (dict(width=30, height=20, gravity_enabled=False), False),
        "61x12": (dict(width=61, height=12, queue_size=3, auto_reset=True), False),
        "28x14": (dict(width=28, height=14, auto_reset=True), False),
        "8x12-uniform": (dict(width=8, height=12, queue_size=2, queue_kind="uniform", auto_reset=True), False),
        "6x6-w10": (dict(width=10, **oversize), True),
        "6x6-w30": (dict(width=30, **oversize), True),
        "queue1-holder2": (dict(queue_size=1, holder_size=2, auto_reset=True), False),
    }[name]


GEOMETRIES = ("10x20", "30x20", "30x20-nograv", "61x12", "28x14", "8x12-uniform", "6x6-w10", "6x6-w30",
              "queue1-holder2")


def _config(name):
    kw, oversize = _geometry(name)
    if oversize:
        pieces, _, pad = _oversize_pieces()
        return EngineConfig(padding=pad, **kw), pieces
    return EngineConfig(**kw), PIECES


def _clamp(v, limit, dim):
    if v < 0:
        v += dim
    return min(max(v, 0), limit)


class _Tables:
    """What the kernel reads of a piece set: the packed rows, boxes and ids."""

    def __init__(self, cfg, pieces):
        t = turbo.tables_for(pieces, CPU)[0]
        self.S, self.box = t.size, [int(b) for b in t.box]
        self.packed = np.asarray(t.packed).astype(np.uint64)
        self.ids = [int(i) for i in kernels._ids_for(pieces, CPU).numpy()]
        self.NP = len(self.box)

    def piece_rows(self, piece, rot):
        """engine_common.cuh:piece_word_2d then piece_row: S row masks."""
        if not (0 <= piece < self.NP and 0 <= rot < 4):
            return [0] * self.S
        words = self.packed[piece * 4 + rot]
        bits = sum(int(w) << (32 * k) for k, w in enumerate(np.atleast_1d(words)))
        return [(bits >> (s * self.S)) & ((1 << self.S) - 1) for s in range(self.S)]


def _env_shared(bd, cfg, S):
    """EnvShared of one board (int8[H, PW])."""
    H, PW, h, W, pad = cfg.padded_height, cfg.padded_width, cfg.height, cfg.width, cfg.padding
    occ, nz = bd > 0, bd != 0
    occ_top = np.full((S + 1, PW), H, np.int64)
    for col in range(PW):
        first = H
        for r in range(H - 1, -1, -1):
            if occ[r, col]:
                first = r
            if r <= S:
                occ_top[r, col] = first
    top = np.full((h + 1, W), h, np.int64)
    for c in range(W):
        first = h
        for y in range(h - 1, -1, -1):
            if nz[y, pad + c]:
                first = y
            top[y, c] = first
    heights = h - top[0]
    play_nz = nz[:h, pad:pad + W]
    weights = 1 << np.arange(PW, dtype=object)
    bits = lambda m: [int((m[r] * weights).sum()) for r in range(H)]  # noqa: E731
    return dict(
        occ_bits=bits(occ), nz_bits=bits(nz), one_bits=bits(bd == 1), neg_bits=bits(bd < 0),
        occ=occ, nz=nz, occ_top=occ_top, top=top, heights=heights,
        full=occ[:h, pad:pad + W].all(axis=1), sum=int(heights.sum()),
        bump=int(np.abs(np.diff(heights)).sum()), occ_cnt=int(play_nz.sum()),
        row_cnt=play_nz.sum(axis=1),
    )


def _kept_row(filled, k):
    """The kept row of rank k: the least fixed point of s = k + full_upto(s)."""
    s = k
    while True:
        t = k + int(filled[:s + 1].sum())
        if t == s:
            return s
        s = t


def _candidate(es, bd, piece, rotation, a, cfg, tb):
    """One thread's candidate: status, lines, full rows, window and the
    full feature vector (heights, max, holes, bumpiness)."""
    H, PW, h, W, pad, S = cfg.padded_height, cfg.padded_width, cfg.height, cfg.width, cfg.padding, tb.S
    rot = (rotation + (a & 3)) % 4
    prows = tb.piece_rows(piece, rot)
    x = a // 4 + pad - (tb.box[piece] if 0 <= piece < tb.NP else 0) // 2
    xc = _clamp(x, PW - S, PW)
    z = min(1, H - S)
    first_hit = 2 * H
    for s in range(S):
        for j in range(S):
            r = es["occ_top"][z + s, xc + j]
            if (prows[s] >> j) & 1 and r - s <= H - S:
                first_hit = min(first_hit, r - s)
    y = 0 if first_hit == 0 else min(max(first_hit - 1, 0), H)
    yc = _clamp(y, H - S, H)
    pid = tb.ids[piece] if 0 <= piece < tb.NP else 0
    # the cells under the piece as row words: frame, stack, and the lock as an OR
    sp = [prows[i] << xc for i in range(S)]
    hs = [yc + i for i in range(S)]
    frame = any(es["one_bits"][r] & m for r, m in zip(hs, sp))
    stack = any(es["occ_bits"][r] & m for r, m in zip(hs, sp))
    odd = np.int64(pid).astype(np.int8) <= 0 or any(es["neg_bits"][r] & m for r, m in zip(hs, sp))
    play = (1 << W) - 1
    pos = [((es["occ_bits"][r] | m) >> pad) & play for r, m in zip(hs, sp)]
    win = [((es["nz_bits"][r] | m) >> pad) & play for r, m in zip(hs, sp)]
    if odd:  # a piece cell on a negative id: cell by cell, the sum wraps as int8
        pos = [(es["occ_bits"][r] >> pad) & play for r in hs]
        win = [(es["nz_bits"][r] >> pad) & play for r in hs]
        for i, m in enumerate(sp):
            for c in range(W):
                if (m >> (pad + c)) & 1:
                    v = np.int64(int(bd[hs[i], pad + c]) + pid).astype(np.int8)
                    pos[i] = pos[i] & ~(1 << c) | (int(v > 0) << c)
                    win[i] = win[i] & ~(1 << c) | (int(v != 0) << c)
    filled = es["full"].copy()
    for i in range(S):
        if hs[i] < h:
            filled[hs[i]] = pos[i] == play
    n = int(filled.sum())
    status = "illegal" if frame else ("over" if stack else "placed")
    if status == "illegal":
        vec = [h] * W + [h, 0, 0]
    elif status == "over":
        vec = [0] * (W + 3)
    elif n == 0:  # only the window's columns change
        c0, yb = xc - pad, min(yc + S, h)
        heights = es["heights"].copy()
        for j in range(S):
            cc = c0 + j
            if 0 <= cc < W:
                tp = es["top"][0, cc]
                if tp >= yc:
                    tp = es["top"][yb, cc]
                    for i in range(S - 1, -1, -1):
                        if yc + i < h and (win[i] >> cc) & 1:
                            tp = yc + i
                heights[cc] = h - tp
        old = es["heights"]
        total = es["sum"] + int((heights - old).sum())
        bump = es["bump"]
        for j in range(S + 1):
            cc = c0 + j
            if 1 <= cc < W:
                bump += abs(int(heights[cc]) - int(heights[cc - 1])) - abs(int(old[cc]) - int(old[cc - 1]))
        # the maximum: the window's new heights, then the other columns' as the env has them
        mx = max([0] + [int(heights[c0 + j]) for j in range(S) if 0 <= c0 + j < W] +
                 [int(old[c]) for c in range(W) if not 0 <= c - c0 < S])
        occ = es["occ_cnt"] + sum(bin(win[i]).count("1") - int(es["row_cnt"][yc + i])
                                  for i in range(S) if yc + i < h)
        vec = list(heights) + [mx, total - occ, bump]
    else:  # rows clear: the kept rows folded top-down
        as_row = lambda m: np.array([(m >> c) & 1 for c in range(W)], bool)  # noqa: E731
        kept = [as_row(win[r - yc]) if 0 <= r - yc < S else es["nz"][r, pad:pad + W]
                for r in range(h) if not filled[r]]
        seen = np.zeros(W, bool)
        count = np.zeros(W, np.int64)
        occ = 0
        for m in kept:
            seen |= m
            count += seen
            occ += int(m.sum())
        vec = list(count) + [int(count.max()), int(count.sum()) - occ, int(np.abs(np.diff(count)).sum())]
    return dict(status=status, n=n, filled=filled, xc=xc, yc=yc, prows=prows, pid=pid,
                vec=np.asarray(vec, np.float32))


def _build_row(c, bd, r, cfg, S):
    """csrc/grouped_flagship.cu:build_row: row r of a candidate's board."""
    PW, h, W, pad = cfg.padded_width, cfg.height, cfg.width, cfg.padding
    if c["status"] == "over":
        return np.zeros(PW, np.int8)
    if c["status"] == "illegal" or r >= h:
        return np.ones(PW, np.int8)
    row = np.ones(PW, np.int8)
    n = c["n"]
    if r < n:
        row[pad:pad + W] = 0
        return row
    s = r if n == 0 else _kept_row(c["filled"], r - n)
    i = s - c["yc"]
    prow = c["prows"][i] if 0 <= i < S else 0
    cols = np.arange(pad, pad + W)
    j = cols - c["xc"]
    hit = (j >= 0) & (j < S) & ((prow >> np.clip(j, 0, S - 1)) & 1).astype(bool)
    row[pad:pad + W] = (bd[s, pad:pad + W].astype(np.int64) + np.where(hit, c["pid"], 0)).astype(np.int8)
    return row


def _model(state, cfg, pieces):
    """The kernel's outputs: (boards int8[B, A, H, PW], mask, game_over,
    lines, features float32[B, A, W + 3] under all flags)."""
    tb = _Tables(cfg, pieces)
    B, A = state.board.shape[0], cfg.width * 4
    boards = np.zeros((B, A, cfg.padded_height, cfg.padded_width), np.int8)
    mask, over = np.zeros((B, A), np.float32), np.zeros((B, A), bool)
    lines, feats = np.zeros((B, A), np.int32), np.zeros((B, A, cfg.width + 3), np.float32)
    board = state.board.numpy()
    for b in range(B):
        es = _env_shared(board[b], cfg, tb.S)
        for a in range(A):
            c = _candidate(es, board[b], int(state.piece[b]), int(state.rotation[b]), a, cfg, tb)
            mask[b, a] = 0.0 if c["status"] == "illegal" else 1.0
            over[b, a] = c["status"] == "over"
            lines[b, a] = c["n"] if c["status"] == "placed" else 0
            feats[b, a] = c["vec"]
            for r in range(cfg.padded_height):
                boards[b, a, r] = _build_row(c, board[b], r, cfg, tb.S)
    return boards, mask, over, lines, feats


def _select(feats, width, flags):
    """The vector under ``flags`` from the full one (features.cuh's order)."""
    parts = [feats[..., :width]] if flags.height else []
    parts += [feats[..., width + k:width + k + 1] for k, on in
              enumerate((flags.max_height, flags.holes, flags.bumpiness)) if on]
    return np.concatenate(parts, axis=-1) if parts else feats[..., :0]


def _played(cfg, pieces, B, steps, seed):
    rng = np.random.default_rng(seed)
    s = engine.init(batch_keys(threefry.prng_key(seed), B, device=CPU), cfg, pieces, device=CPU)
    for _ in range(steps):
        a = rng.choice(8, B, p=[.1, .1, .05, .1, .05, .35, .15, .1]).astype(np.int32)
        s = engine.step(s, torch.from_numpy(a), cfg, pieces, obs_fn=engine.no_obs)[0]
    return s


def _stacks(s, cfg, seed):
    """Hand-built stacks: garbage in the lower two thirds with 0-6 full
    bottom rows, ids that the lock's add wraps (126, negative ones, -id),
    a column stacked to the ceiling, and random pieces and rotations."""
    rng = np.random.default_rng(seed)
    B = s.board.shape[0]
    board = s.board.clone().numpy()
    pad, h, w = cfg.padding, cfg.height, cfg.width
    top = h // 3
    inner = board[:, top:h, pad:pad + w]
    ids = rng.integers(2, 9, inner.shape)
    ids = np.where(rng.random(inner.shape) < 0.15, rng.choice([126, 127, -3, -8, -100], inner.shape), ids)
    n_full = rng.integers(0, 7, B)
    n_full[0] = max(n_full[0], 2)  # clears of several rows
    full = np.arange(h - top)[None, :] >= (h - top) - n_full[:, None]
    ids = np.where(full[:, :, None], np.abs(ids), ids)  # a full row's cells all > 0
    inner[:] = np.where((rng.random(inner.shape) < 0.6) | full[:, :, None], ids, 0).astype(np.int8)
    board[0, :h, pad + w // 2] = 3  # a column to the ceiling: game-over placements
    n_pieces = int(s.bag.shape[1])
    return s.replace(board=torch.from_numpy(board).contiguous(),
                     piece=torch.from_numpy(rng.integers(0, n_pieces, B).astype(np.int32)),
                     rotation=torch.from_numpy(rng.integers(-5, 9, B).astype(np.int32)))


@functools.lru_cache(maxsize=None)
def _jax_grouped(name):
    import jax

    from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
    from tetris_gymnasium_tpu.core import grouped as jgrouped

    kw, oversize = _geometry(name)
    extra = {"pieces": _oversize_pieces()[1]} if oversize else {}
    jc = JEngineConfig(padding=_oversize_pieces()[2], **kw) if oversize else JEngineConfig(**kw)

    def one(s):
        out = jgrouped.placements(s, jc, **extra)
        return out + tuple(jgrouped.grouped_observation(s, jc, mode=m, **extra)[0]
                           for m in ("boards", "features"))

    return jax.jit(jax.vmap(one))


def _to_jax(ts):
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.core import engine as jengine

    fields = {k: np.array(getattr(ts, k)) for k in engine.FIELDS}
    fields["key"] = fields["key"].T  # the port keeps the key as [2, B]
    return jengine.EngineState(**{k: jnp.asarray(v) for k, v in fields.items()})


def _check_model(s, cfg, pieces, name, what, with_jax):
    boards, mask, over, lines, feats = _model(s, cfg, pieces)
    want = grouped.placements_plain(s, cfg, pieces)
    for got, w, k in zip((boards, mask, over, lines), want, ("boards", "mask", "game_over", "lines")):
        np.testing.assert_array_equal(got, w.numpy(), err_msg=f"{name} {what} {k}")
    np.testing.assert_array_equal(boards.astype(np.float32),
                                  grouped.grouped_observation_plain(s, cfg, pieces, "boards")[0].numpy())
    for flags in FLAG_SETS:
        plain = grouped.grouped_observation_plain(s, cfg, pieces, "features", flags)[0].numpy()
        np.testing.assert_array_equal(_select(feats, cfg.width, flags), plain,
                                      err_msg=f"{name} {what} features {tuple(flags)}")
    if with_jax:
        jw = _jax_grouped(name)(_to_jax(s))
        for got, w, k in zip((boards, mask, over, lines, boards.astype(np.float32), feats), jw,
                             ("boards", "mask", "game_over", "lines", "boards mode", "features")):
            np.testing.assert_array_equal(got, np.asarray(w), err_msg=f"{name} {what} JAX {k}")
    return dict(clearing=int((lines > 0).sum()), illegal=int((mask == 0).sum()), over=int(over.sum()))


@pytest.mark.parametrize("name", GEOMETRIES)
def test_flagship_model_matches_plain_and_jax(name):
    """The model on a seeded trajectory (two states) and two hand-built
    stacks, in all three modes and under all 16 flag sets."""
    cfg, pieces = _config(name)
    B = 2 if cfg.width > 40 else 3
    s = _played(cfg, pieces, B, 12, seed=len(name))
    seen = dict(clearing=0, illegal=0, over=0)
    for what, st in (("fresh", engine.init(batch_keys(threefry.prng_key(3), B, device=CPU), cfg, pieces,
                                           device=CPU)),
                     ("played", s), ("stack 0", _stacks(s, cfg, 0)), ("stack 1", _stacks(s, cfg, 1))):
        got = _check_model(st, cfg, pieces, name, what, with_jax=what in ("played", "stack 0"))
        for k in seen:
            seen[k] += got[k]
    assert seen["clearing"] > 0 and seen["illegal"] > 0 and seen["over"] > 0, seen


def test_flagship_model_flag_sets_match_jax():
    """The model's vector under each flag set equal to JAX's
    ``grouped_observation(..., feature_flags=flags)`` on a played 10x20
    state; JAX's feature_vector refuses the empty set (nothing to
    concatenate), which the plain version answers with an empty vector."""
    import jax

    from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
    from tetris_gymnasium_tpu.core import grouped as jgrouped
    from tetris_gymnasium_tpu.ops.observations import FeatureFlags as JFeatureFlags

    cfg, pieces = _config("10x20")
    s = _stacks(_played(cfg, pieces, 2, 12, seed=9), cfg, 3)
    feats = _model(s, cfg, pieces)[4]
    jc = JEngineConfig(**_geometry("10x20")[0])
    every = jax.jit(jax.vmap(lambda st: tuple(
        jgrouped.grouped_observation(st, jc, mode="features", feature_flags=JFeatureFlags(*f))[0]
        for f in FLAG_SETS[1:])))
    for flags, want in zip(FLAG_SETS[1:], every(_to_jax(s))):
        np.testing.assert_array_equal(_select(feats, cfg.width, flags), np.asarray(want),
                                      err_msg=str(tuple(flags)))


def test_kept_row_fixed_point():
    """The row-source map: the kept row of rank k is the least fixed point
    of s = k + (full rows at or above s), for every mask of 12 rows."""
    for m in range(1 << 12):
        filled = np.array([(m >> h) & 1 for h in range(12)], bool)
        kept = np.flatnonzero(~filled)
        for k, s in enumerate(kept):
            assert _kept_row(filled, k) == s


def test_flagship_features_of_wrapped_cells():
    """A window cell that the lock's add wraps to 0 (id -pid) or past 127
    empties or keeps its column; the model and the plain version agree."""
    cfg, pieces = _config("10x20")
    s = _played(cfg, pieces, 2, 0, seed=5)
    board = s.board.clone().numpy()
    pid = int(kernels._ids_for(pieces, CPU)[int(s.piece[0])])
    board[:, 12:20, 4:14] = np.int8(-pid)
    board[:, 19, 4] = 0
    board[:, 15, 4:14] = 126
    s = s.replace(board=torch.from_numpy(board).contiguous())
    _check_model(s, cfg, pieces, "10x20", "wrapped", with_jax=False)


def test_flagship_occupancy_limits_are_named():
    """The wrapper's geometry limits: the flagship board cap names itself."""
    cfg = EngineConfig(width=120, height=40)
    with pytest.raises(NotImplementedError, match="padded board"):
        kernels.engine_defines(cfg, turbo.tables_for(PIECES, CPU)[0], flagship=True)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 1024, 4100])
def test_grouped_act_builds_match_plain_on_the_card(cuda, B):
    g = torch.Generator(device=cuda)
    g.manual_seed(B)
    A = 40
    q = torch.randn((B, A), generator=g, device=cuda)
    q[::5] = torch.randint(0, 2, (len(q[::5]), A), generator=g, device=cuda).float()
    q[::7, ::9] = float("nan")
    mask_ab = (torch.rand((A, B), generator=g, device=cuda) < 0.5).float()
    mask_ab[:, ::4] = 0.0
    act_key, eps_key = threefry.split(threefry.prng_key(B))
    for mask in (mask_ab.T, mask_ab.T.contiguous()):
        for fill in (NEG_INF, float("-inf")):
            greedy = act_plain(q, mask, fill=fill)
            for eps in (0.0, 0.3, 1.0):
                want = act_plain(q, mask, act_key, eps_key, eps, fill)
                for lanes in (None,) + kernels.GROUPED_ACT_LANES:
                    got = kernels.grouped_act(q, mask, act_key, eps_key, eps, fill, lanes=lanes)
                    assert torch.equal(got, want), (lanes, eps, fill)
                    assert torch.equal(kernels.grouped_act(q, mask, fill=fill, lanes=lanes), greedy)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GEOMETRIES)
def test_grouped_flagship_matches_plain_on_the_card(cuda, name):
    kw, oversize = _geometry(name)
    if oversize:
        pieces, pad = pieces_from_tetrominoes([
            Tetromino(2, (255, 0, 0), np.array([[1, 1], [1, 1]], np.uint8)),
            Tetromino(3, (0, 255, 0), np.ones((1, 6), np.uint8)),
            Tetromino(4, (0, 0, 255), np.array([[0, 1, 0], [1, 1, 1], [0, 0, 0]], np.uint8))])
        cfg = EngineConfig(padding=pad, **kw)
    else:
        cfg, pieces = EngineConfig(**kw), PIECES
    s = _played(cfg, pieces, 37, 30, seed=7)
    for what, st in (("played", s), ("stack", _stacks(s, cfg, 2))):
        on = engine.EngineState(**{k: getattr(st, k).to(cuda) for k in engine.FIELDS})
        want = grouped.placements_plain(st, cfg, pieces)
        for k, (a, b) in enumerate(zip(kernels.grouped_flagship(on, cfg, pieces, "ids"), want)):
            assert torch.equal(a.cpu(), b), (name, what, k)
        assert torch.equal(kernels.grouped_flagship(on, cfg, pieces, "boards")[0].cpu(), want[0].float())
        for flags in FLAG_SETS:
            got = kernels.grouped_flagship(on, cfg, pieces, "features", flags)[0].cpu()
            pad = cfg.padding
            crop = want[0][:, :, :-pad, pad:-pad].reshape(-1, cfg.height, cfg.width)
            plain = feature_vector_plain(crop, flags).reshape(got.shape).float()
            assert torch.equal(got, plain), (name, what, tuple(flags))
