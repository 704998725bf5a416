"""The redesigned ``grouped_placements`` (an env's shared work once, boards
built a row at a time) and ``replay_add`` (one flat grid of row copies).

On the CPU:

* ``grouped_placements``' structure (``csrc/grouped_placements.cu``): a
  numpy model of the env's shared pass (each padded column's first
  occupied row at or below each of the first S + 1 rows, each playfield
  column's filled rows as a mask, the column tops with the heights' sum,
  maximum and bumpiness, the filled cells, the full rows), the drop from
  those column tops, the S rows under the piece as words (frame, stack,
  lock, full rows), the max_clear envelope, the features of a candidate
  that clears nothing patched from the env's, those of a candidate that
  clears rows from the column masks (a column's top kept cell falls by the
  full rows below it), and the boards built a row at a time from the
  row-source map (the kept row of rank r - n).  In both modes it must
  equal ``placements_plain`` / ``placement_boards_plain`` and JAX's
  ``placements`` and
  ``placement_boards`` at the geometries of ``chip_smoke.py``'s phases 11,
  35 and 39 and a board of more than 32 playfield rows, on seeded
  trajectories and on hand-built stacks with clears of 1-6 rows at
  max_clear 4 and 20, pieces against the walls, collisions at the spawn
  row, unknown pieces and both sentinels;
* ``replay_add``'s grid (``csrc/replay.cu``): a numpy model of the
  launcher's plan (each field's first block) and of every block's copy
  (its runs of words, or a 32 x 32 tile of the transposed field) must
  write every entry once, leave no block without work, and equal
  ``add_plain`` and JAX's ``buffers.add`` across the wrap-around, for
  strided ``window[:, -1]`` sources, the transposed mask and B = 1, 512,
  1001 and 1024;
* the limits as the wrapper names them: each field's copy granule (row
  size, source stride and alignment).

On a card (marked ``cuda``; they skip without one, decided inside the
test): ``grouped_placements`` in both modes at every geometry (and at
120x60, whose features vectors are too large to stage), at batches that
give its blocks the build's envs, fewer, and a last block part full, and
``replay_add`` at every DQN shape, against the plain twins; the boards
chunk's limits (shared memory, buffers) at every geometry; and
``replay_add``'s refusal of a field past its 32-bit word index.
This file imports JAX only inside its CPU tests, so ``python -m pytest
--noconftest tests/test_torch_placements_replay_redesign.py -m cuda`` runs
on the card's machine.
"""
import functools

import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.components.tetromino import Tetromino, pieces_from_tetrominoes
from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.core import turbo_grouped as tg
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES
from tetris_gymnasium_torch.rl import buffers

CPU = "cpu"
OVERSIZE_SHAPES = (((255, 0, 0), ((1, 1), (1, 1))), ((0, 255, 0), ((1, 1, 1, 1, 1, 1),)),
                   ((0, 0, 255), ((0, 1, 0), (1, 1, 1), (0, 0, 0))))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Geometries and states
# ---------------------------------------------------------------------------


def _geometry(name):
    """``(config kwargs, oversize)`` of chip_smoke.py's phases 11 (10x20),
    35 (surface_geometries) and 39 (30x20, 61x12), and a board of 40
    playfield rows (a 64-bit mask of full rows)."""
    oversize = dict(height=16, queue_size=2, queue_kind="uniform", auto_reset=True)
    return {
        "10x20": (dict(gravity_enabled=False, auto_reset=True), False),
        "30x20": (dict(width=30, height=20, auto_reset=True), False),
        "30x20-nograv": (dict(width=30, height=20, gravity_enabled=False), False),
        "61x12": (dict(width=61, height=12, queue_size=3, auto_reset=True), False),
        "28x14": (dict(width=28, height=14, auto_reset=True), False),
        "8x12-uniform": (dict(width=8, height=12, queue_size=2, queue_kind="uniform", auto_reset=True), False),
        "6x6-w10": (dict(width=10, **oversize), True),
        "6x6-w30": (dict(width=30, **oversize), True),
        "queue1-holder2": (dict(queue_size=1, holder_size=2, auto_reset=True), False),
        "10x40": (dict(width=10, height=40, auto_reset=True), False),
    }[name]


GEOMETRIES = ("10x20", "30x20", "30x20-nograv", "61x12", "28x14", "8x12-uniform", "6x6-w10", "6x6-w30",
              "queue1-holder2", "10x40")


def _config(name):
    kw, oversize = _geometry(name)
    if oversize:
        pieces, pad = pieces_from_tetrominoes([Tetromino(2 + i, c, np.array(m, np.uint8))
                                               for i, (c, m) in enumerate(OVERSIZE_SHAPES)])
        return EngineConfig(padding=pad, **kw), pieces
    return EngineConfig(**kw), PIECES


def _played(cfg, pieces, B, steps, seed):
    """A grouped batch after ``steps`` placements: a random legal candidate,
    or one time in ten any candidate (illegal ones end or restart games)."""
    rng = np.random.default_rng(seed)
    gs, _ = tg.reset(batch_keys(threefry.prng_key(seed), B, device=CPU), cfg, pieces, device=CPU)
    for _ in range(steps):
        m = gs.mask.numpy()
        acts = [rng.choice(np.flatnonzero(m[:, b])) if m[:, b].any() and rng.random() > 0.1
                else rng.integers(0, m.shape[0]) for b in range(B)]
        gs = tg.step(gs, torch.tensor(acts, dtype=torch.int32), cfg, pieces)[0]
    return gs.env


def _rows_np(s, cfg):
    """Packed rows as Python ints over the padded width, ``[B][H]``."""
    r = turbo.u32_to_lanes(s.rows).numpy().astype(np.uint64)
    if r.ndim == 2:
        r = r[:, None, :]
    B = r.shape[-1]
    return [[sum(int(r[h, j, b]) << (32 * j) for j in range(r.shape[1])) for h in range(r.shape[0])]
            for b in range(B)]


def _with_rows(s, rows, cfg):
    """``s`` with the packed rows ``[B][H]`` (Python ints)."""
    nw = (cfg.padded_width + 31) // 32
    B, H = len(rows), cfg.padded_height
    lanes = np.zeros((H, nw, B), np.int64)
    for b in range(B):
        for h in range(H):
            for j in range(nw):
                lanes[h, j, b] = (rows[b][h] >> (32 * j)) & 0xFFFFFFFF
    lanes = torch.from_numpy(lanes if nw > 1 else lanes[:, 0])
    return s.replace(rows=turbo.lanes_to_u32(lanes).contiguous())


def _stacks(s, cfg, seed):
    """Hand-built stacks: garbage in the lower two thirds with 0-6 full
    bottom rows (5, 6, 1, 2, 3, 4 for the first envs), a column stacked to the ceiling
    (a collision at the spawn row), and random pieces (an unknown one
    among them) and rotations (negative and past 3)."""
    rng = np.random.default_rng(seed)
    rows = _rows_np(s, cfg)
    B = len(rows)
    pad, h, w = cfg.padding, cfg.height, cfg.width
    play = ((1 << w) - 1) << pad
    n_full = rng.integers(0, 7, B)
    n_full[: min(B, 6)] = (5, 6, 1, 2, 3, 4)[: min(B, 6)]
    for b in range(B):
        for r in range(h // 3, h):
            garbage = (int(rng.integers(0, 1 << w)) if w < 63 else  # numpy draws below 2**63
                       sum(int(rng.integers(0, 1 << 32)) << (32 * k) for k in range(-(-w // 32)))) << pad
            rows[b][r] |= garbage & play if rng.random() < 0.8 else 0
            if r >= h - n_full[b]:
                rows[b][r] |= play
    rows[B - 1] = [r | (1 << (pad + w // 2)) if i < h else r for i, r in enumerate(rows[B - 1])]
    n_pieces = int(s.bag.shape[0])
    piece = rng.integers(0, n_pieces, B).astype(np.int32)
    piece[0] = n_pieces  # an unknown piece: no cells
    return _with_rows(s, rows, cfg).replace(
        piece=torch.from_numpy(piece), rotation=torch.from_numpy(rng.integers(-5, 9, B).astype(np.int32)))


# ---------------------------------------------------------------------------
# grouped_placements' structure, in numpy
# ---------------------------------------------------------------------------


def _clamp(v, limit, dim):
    if v < 0:
        v += dim
    return min(max(v, 0), limit)


class _Tables:
    """What the kernel reads of a piece set: the packed rows and boxes."""

    def __init__(self, pieces):
        t = turbo.tables_for(pieces, CPU)[0]
        self.S, self.box = t.size, [int(b) for b in t.box]
        self.packed = np.asarray(t.packed).astype(np.uint64)
        self.NP = len(self.box)

    def piece_rows(self, piece, rot):
        """engine_common.cuh:piece_word then piece_row: S row masks (0
        outside the table)."""
        idx = piece * 4 + rot
        if not 0 <= idx < self.NP * 4:
            return [0] * self.S
        bits = sum(int(w) << (32 * k) for k, w in enumerate(np.atleast_1d(self.packed[idx])))
        return [(bits >> (s * self.S)) & ((1 << self.S) - 1) for s in range(self.S)]


def _env_shared(rows, cfg, S):
    """EnvShared of one env's packed rows."""
    H, PW, h, W, pad = cfg.padded_height, cfg.padded_width, cfg.height, cfg.width, cfg.padding
    occ_top = np.full((S + 1, PW), H, np.int64)
    for col in range(PW):
        first = H
        for r in range(H - 1, -1, -1):
            if rows[r] >> col & 1:
                first = r
            if r <= S:
                occ_top[r, col] = first
    col_masks = [sum(1 << r for r in range(h) if rows[r] >> (pad + c) & 1) for c in range(W)]
    top = [next((r for r in range(h) if rows[r] >> (pad + c) & 1), h) for c in range(W)]
    heights = [h - t for t in top]
    play = ((1 << W) - 1) << pad
    return dict(occ_top=occ_top, col=col_masks, top=top, sum=sum(heights), maxh=max(heights),
                bump=sum(abs(heights[c] - heights[c - 1]) for c in range(1, W)),
                occ=sum(bin(rows[r] & play).count("1") for r in range(h)),
                full=sum(1 << r for r in range(h) if rows[r] & play == play))


def _kept_row(filled, k):
    """The kept row of rank k: the least fixed point of s = k + (full rows at or above s)."""
    s = k
    while True:
        t = k + bin(filled & ((2 << s) - 1)).count("1")
        if t == s:
            return s
        s = t


def _crop(row, cfg):
    return (row >> cfg.padding) & ((1 << cfg.width) - 1)


def _columns(es, filled, prows, xc, yc, cfg):
    """The features of a candidate that clears rows, from the column masks:
    a column's top kept cell r (its cells and the piece's, less the full
    rows) falls by the full rows below it; its holes are its height less its
    kept cells."""
    W, h, c0, n = cfg.width, cfg.height, xc - cfg.padding, bin(filled).count("1")
    heights, holes = [], 0
    for c in range(W):
        j = c - c0
        cells = sum((prows[i] >> j & 1) << (yc + i) for i in range(len(prows))) if 0 <= j < len(prows) else 0
        kept = (es["col"][c] | cells) & ~filled
        hgt = 0
        if kept:
            r = (kept & -kept).bit_length() - 1
            hgt = h - r - (n - bin(filled & ((2 << r) - 1)).count("1"))
        heights.append(hgt)
        holes += hgt - bin(kept).count("1")
    bump = sum(abs(heights[c] - heights[c - 1]) for c in range(1, W))
    return heights + [max(heights), holes, bump]


def _candidate(es, rows, piece, rotation, a, cfg, tb, max_clear):
    """One thread's candidate: (status, n, lines, frame_hit, stack_hit,
    filled, window rows, yc, features)."""
    H, PW, h, W, pad, S = cfg.padded_height, cfg.padded_width, cfg.height, cfg.width, cfg.padding, tb.S
    rot = (rotation + (a & 3)) % 4
    prows = tb.piece_rows(piece, rot)
    box = tb.box[piece] if 0 <= piece < tb.NP else 0
    xc = _clamp(a // 4 + pad - box // 2, PW - S, PW)
    z = min(1, H - S)
    first_hit = 2 * H
    for s in range(S):
        for j in range(S):
            if prows[s] >> j & 1:
                r = int(es["occ_top"][z + s, xc + j])
                if r - s <= H - S:
                    first_hit = min(first_hit, r - s)
    y = 0 if first_hit == 0 else min(max(first_hit - 1, 0), H)
    yc = _clamp(y, H - S, H)
    side = ((1 << pad) - 1) | (((1 << pad) - 1) << (pad + W))
    full_row, play = (1 << PW) - 1, ((1 << W) - 1) << pad
    window = [p << xc for p in prows]
    frame_hit = any(((side if yc + i < h else full_row) & window[i]) for i in range(S))
    stack_hit = any(rows[yc + i] & window[i] for i in range(S)) and not frame_hit
    filled = es["full"]
    for i in range(S):
        if yc + i < h:
            bit = 1 << (yc + i)
            filled = (filled | bit) if (rows[yc + i] | window[i]) & play == play else (filled & ~bit)
    n = bin(filled).count("1")
    stack_hit = stack_hit or n > max_clear
    status = "over" if stack_hit else ("illegal" if frame_hit else "placed")
    if status == "over":
        feats = [0] * (W + 3)
    elif status == "illegal":
        feats = [h] * (W + 1) + [0, 0]
    elif n == 0:
        # patched from the env's: the window's columns rise to the piece's top cells
        c0 = xc - pad
        heights = [h - t for t in es["top"]]
        new = list(heights)
        for j in range(S):
            if 0 <= c0 + j < W:
                ptop = next((yc + i for i in range(S) if prows[i] >> j & 1), h)
                new[c0 + j] = max(heights[c0 + j], h - ptop)
        bump = es["bump"]
        for j in range(S + 1):
            cc = c0 + j
            if 1 <= cc < W:
                bump += abs(new[cc] - new[cc - 1]) - abs(heights[cc] - heights[cc - 1])
        cells = sum(bin(p).count("1") for p in prows)
        feats = new + [max(max(new[max(c0, 0):c0 + S], default=0), es["maxh"]),
                       sum(new) - es["occ"] - cells, bump]
    else:
        feats = _columns(es, filled, prows, xc, yc, cfg)
    return status, n, (n if status == "placed" else 0), frame_hit, stack_hit, filled, window, yc, feats


def _board(status, n, filled, window, yc, rows, cfg):
    """The candidate's board, a row at a time (build_row)."""
    h, W = cfg.height, cfg.width
    out = np.zeros((h, W), np.float32)
    if status == "illegal":
        out[:] = 1.0
    elif status == "placed":
        for r in range(n, h):
            s = r if n == 0 else _kept_row(filled, r - n)
            m = _crop(rows[s] | (window[s - yc] if 0 <= s - yc < len(window) else 0), cfg)
            out[r] = [(m >> c) & 1 for c in range(W)]
    return out


def _model(s, cfg, pieces, max_clear):
    """(features [B, A, W + 3], boards [B, A, H, W], mask, game_over, lines [A, B])."""
    tb = _Tables(pieces)
    rows_all = _rows_np(s, cfg)
    B, A, W, h = len(rows_all), 4 * cfg.width, cfg.width, cfg.height
    feats = np.zeros((B, A, W + 3), np.float32)
    boards = np.zeros((B, A, h, W), np.float32)
    mask = np.zeros((A, B), np.float32)
    over = np.zeros((A, B), bool)
    lines = np.zeros((A, B), np.int32)
    for b, rows in enumerate(rows_all):
        es = _env_shared(rows, cfg, tb.S)
        piece, rotation = int(s.piece[b]), int(s.rotation[b])
        for a in range(A):
            status, n, ln, frame_hit, stack_hit, filled, window, yc, f = _candidate(
                es, rows, piece, rotation, a, cfg, tb, max_clear)
            feats[b, a] = f
            boards[b, a] = _board(status, n, filled, window, yc, rows, cfg)
            mask[a, b], over[a, b], lines[a, b] = (0.0 if frame_hit else 1.0), stack_hit, ln
    return feats, boards, mask, over, lines


@functools.lru_cache(maxsize=None)
def _jax_placements(name, max_clear):
    import jax

    from tetris_gymnasium_tpu.components.tetromino import Tetromino as JTetromino
    from tetris_gymnasium_tpu.components.tetromino import pieces_from_tetrominoes as jpieces_from
    from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
    from tetris_gymnasium_tpu.core import turbo_grouped as jtg
    from tetris_gymnasium_tpu.pieces import PIECES as JPIECES

    kw, oversize = _geometry(name)
    if oversize:
        jpieces, pad = jpieces_from([JTetromino(2 + i, c, np.array(m, np.uint8))
                                     for i, (c, m) in enumerate(OVERSIZE_SHAPES)])
        jc = JEngineConfig(padding=pad, **kw)
    else:
        jpieces, jc = JPIECES, JEngineConfig(**kw)
    return jax.jit(lambda st: (jtg.placements(st, jc, jpieces, max_clear),
                               jtg.placement_boards(st, jc, jpieces, max_clear)[0]))


def _to_jax(s):
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.core import turbo as jturbo

    return jturbo.TurboState(**{k: jnp.asarray(np.array(getattr(s, k))) for k in turbo.FIELDS})


def _check_model(s, cfg, pieces, name, what, max_clear, with_jax):
    feats, boards, mask, over, lines = _model(s, cfg, pieces, max_clear)
    pf = tg.placements_plain(s, cfg, pieces, max_clear)
    pb = tg.placement_boards_plain(s, cfg, pieces, max_clear)
    for got, want, k in ((feats, pf[0], "features"), (boards, pb[0], "boards"), (mask, pf[1], "mask"),
                         (over, pf[2], "game_over"), (lines, pf[3], "lines"), (mask, pb[1], "boards mask"),
                         (over, pb[2], "boards game_over"), (lines, pb[3], "boards lines")):
        np.testing.assert_array_equal(got, want.numpy(), err_msg=f"{name} {what} max_clear={max_clear} {k}")
    if with_jax:
        (jf, jm, jo, jl), jb = _jax_placements(name, max_clear)(_to_jax(s))
        for got, want, k in ((feats, np.transpose(np.asarray(jf), (2, 1, 0)), "features"),
                             (boards, np.asarray(jb), "boards"), (mask, np.asarray(jm), "mask"),
                             (over, np.asarray(jo), "game_over"), (lines, np.asarray(jl), "lines")):
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {what} max_clear={max_clear} JAX {k}")
    return dict(clearing=int((lines > 0).sum()), illegal=int((mask == 0).sum()), over=int(over.sum()),
                max_lines=int(lines.max()))


@pytest.mark.parametrize("name", GEOMETRIES)
def test_placements_model_matches_plain_and_jax(name):
    """The model on a seeded trajectory (fresh and played states) and two
    hand-built stacks, both modes, at max_clear 4 and 20."""
    cfg, pieces = _config(name)
    B = 2 if cfg.width > 40 else 4
    played = _played(cfg, pieces, B, 10, seed=len(name))
    fresh = tg.reset(batch_keys(threefry.prng_key(3), B, device=CPU), cfg, pieces, device=CPU)[0].env
    seen = dict(clearing=0, illegal=0, over=0, max_lines=0)
    for what, st in (("fresh", fresh), ("played", played), ("stack 0", _stacks(played, cfg, 0)),
                     ("stack 1", _stacks(played, cfg, 1))):
        for max_clear in ((4, 20) if what.startswith("stack") else (4,)):
            got = _check_model(st, cfg, pieces, name, what, max_clear,
                               with_jax=what in ("played", "stack 0"))
            for k in seen:
                seen[k] = max(seen[k], got[k]) if k == "max_lines" else seen[k] + got[k]
    assert seen["clearing"] > 0 and seen["illegal"] > 0 and seen["over"] > 0, seen
    assert seen["max_lines"] >= (5 if cfg.height >= 12 else 4), seen


def test_placements_model_envelope_and_spawn_collisions():
    """Clears of 1-6 rows at max_clear 4 (5 and 6 are game over) and 20 (all
    clear), pieces against both walls, and a stack at the spawn row, each
    held to the plain versions through the model."""
    cfg, pieces = _config("10x20")
    s = tg.reset(batch_keys(threefry.prng_key(8), 7, device=CPU), cfg, pieces, device=CPU)[0].env
    rows = _rows_np(s, cfg)
    pad, h, w = cfg.padding, cfg.height, cfg.width
    play = ((1 << w) - 1) << pad
    for b in range(6):  # b + 1 full rows with a hole in the row above them
        for r in range(h - b - 1, h):
            rows[b][r] |= play
        rows[b][h - b - 2] |= play & ~(1 << (pad + 3))
    for r in range(3):  # the spawn rows filled but one cell: pieces come to rest on them
        rows[6][r] |= play & ~(1 << (pad + 4))
    s = _with_rows(s, rows, cfg).replace(piece=torch.arange(7, dtype=torch.int32),
                                         rotation=torch.tensor([0, 1, 2, 3, -1, 5, 0], dtype=torch.int32))
    for max_clear in (4, 20):
        _, _, mask, over, lines = _model(s, cfg, pieces, max_clear)
        _check_model(s, cfg, pieces, "10x20", "envelope", max_clear, with_jax=False)
        assert (lines[:, 0] > 0).any()
        if max_clear == 4:
            assert over[:, 4].all() and over[:, 5].all()  # five and six full rows
        else:
            assert lines.max() >= 6
    assert (over[:, 6]).any() and (mask[:, 6] == 1).any()
    assert (mask[:4, :] == 0).any() and (mask[-4:, :] == 0).any()  # against the walls


def test_kept_row_fixed_point():
    """The row-source map: the kept row of rank k is the least fixed point
    of s = k + (full rows at or above s), for every mask of 12 rows."""
    for m in range(1 << 12):
        kept = [r for r in range(12) if not m >> r & 1]
        for k, s in enumerate(kept):
            assert _kept_row(m, k) == s


# ---------------------------------------------------------------------------
# replay_add's grid, in numpy
# ---------------------------------------------------------------------------

THREADS, MAX_RUNS, TILE = 256, 32768, 32  # csrc/replay.cu


def _fields(data, transitions):
    """``(row_bytes, src_stride, word, transposed)`` of each field, as
    ``kernels.replay_add`` sets them up."""
    B = next(iter(transitions.values())).shape[0]
    out = []
    for name, store in data.items():
        x = transitions[name]
        row_bytes = store[0].numel() * store.element_size()
        transposed = not kernels._rows_contiguous(x)
        stride = row_bytes if transposed or B <= 1 else x.stride(0) * x.element_size()
        word = 4 if transposed else kernels._copy_word(row_bytes, store, x, stride=stride)
        out.append((row_bytes, stride, word, transposed))
    return out


def _plan(fields, B):
    """replay_add_launch's AddPlan: the first block of each field, and the grid."""
    first, blocks = [], 0
    for row_bytes, _, word, transposed in fields:
        first.append(blocks)
        if transposed:
            blocks += -(-B // TILE) * -(-(row_bytes // 4) // TILE)
        else:
            blocks += min(-(-(B * row_bytes // word) // THREADS), MAX_RUNS)
    return first + [blocks]


def _model_add(data, transitions, pos):
    """Every block of the flat grid copies its share into numpy copies of
    the stores; returns them, with a count of writes a byte."""
    B = next(iter(transitions.values())).shape[0]
    fields = _fields(data, transitions)
    first = _plan(fields, B)
    stores = {k: v.numpy().copy() for k, v in data.items()}
    writes = {k: np.zeros(v.view(torch.uint8).shape if v.dtype != torch.bool else v.shape, np.int64)
              for k, v in data.items()}
    names = list(data)
    for blk in range(first[-1]):
        k = max(i for i in range(len(fields)) if first[i] <= blk)
        local, name = blk - first[k], names[k]
        row_bytes, stride, word, transposed = fields[k]
        src = transitions[name]
        dst = stores[name].reshape(stores[name].shape[0], -1).view(np.uint8)[pos:pos + B]
        seen = writes[name].reshape(writes[name].shape[0], -1)[pos:pos + B]
        raw = src.contiguous().numpy().reshape(B, -1).view(np.uint8)  # row b of the source, its bytes
        did = 0
        if transposed:
            m, tiles_b = row_bytes // 4, -(-B // TILE)
            b0, j0 = (local % tiles_b) * TILE, (local // tiles_b) * TILE
            col = np.asarray(src.T.contiguous().numpy()).view(np.uint32)  # [m, B] as the kernel reads it
            tile = np.zeros((TILE, TILE + 1), np.uint32)
            for kk in range(TILE):
                for tx in range(TILE):
                    if j0 + kk < m and b0 + tx < B:
                        tile[kk, tx] = col[j0 + kk, b0 + tx]
            for kk in range(TILE):
                for tx in range(TILE):
                    b, j = b0 + kk, j0 + tx
                    if b < B and j < m:
                        dst[b].view(np.uint32)[j] = tile[tx, kk]
                        seen[b, 4 * j:4 * j + 4] += 1
                        did += 1
        else:  # runs local, local + blocks, ... of THREADS words
            wpr, n = row_bytes // word, B * (row_bytes // word)
            run, blocks = THREADS, first[k + 1] - first[k]
            for start in range(local * run, n, blocks * run):
                for i in range(start, min(start + run, n)):
                    r, c = divmod(i, wpr)
                    dst[r, c * word:(c + 1) * word] = raw[r, c * word:(c + 1) * word]
                    seen[r, c * word:(c + 1) * word] += 1
                    did += 1
        assert did > 0, f"block {blk} of field {name} has no work"
    return stores, writes


def _add_block(kind, B, g):
    common = {"action": torch.randint(0, 8, (B,), generator=g, dtype=torch.int32),
              "reward": torch.randn((B,), generator=g),
              "done": torch.rand((B,), generator=g) < 0.2}
    if kind == "grouped":
        A = 40
        return {"obs": torch.randn((B, A, 13), generator=g),
                "mask": (torch.rand((A, B), generator=g) < 0.5).float().T, **common}
    frame, dtype, lo, hi = ((84, 84), torch.uint8, 0, 256) if kind == "pixel" else ((20, 10), torch.int8, -1, 2)
    window = torch.randint(lo, hi, (B, 4, *frame), generator=g, dtype=dtype)
    return {"obs": window[:, -1], **common}


@pytest.mark.parametrize("kind,B", [("grouped", 1), ("grouped", 1001), ("grouped", 1024),
                                    ("pixel", 1), ("pixel", 512), ("board", 1001), ("board", 1024)])
def test_replay_add_grid_model_matches_plain_and_jax(kind, B):
    """The grid across the wrap-around (capacity 3B, four adds) against
    ``add_plain`` and JAX's ``buffers.add``: every byte of the block
    written once, no block without work, the mask transposed where its
    rows are strided."""
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.rl import buffers as jbuffers

    g = torch.Generator()
    g.manual_seed(B + len(kind))
    example = _add_block(kind, B, g)
    pbuf = buffers.create(example, 3 * B, B)
    jbuf = jbuffers.create({k: jnp.asarray(v.contiguous().numpy()) for k, v in example.items()}, 3 * B, B)
    model = {k: v.clone() for k, v in pbuf.data.items()}
    pos = 0
    for _ in range(4):
        blk = _add_block(kind, B, g)
        stores, writes = _model_add(model, blk, pos)
        for k, w in writes.items():
            assert (w[pos:pos + B] == 1).all() and w[:pos].sum() + w[pos + B:].sum() == 0, k
        model = {k: torch.from_numpy(v) for k, v in stores.items()}
        pbuf = buffers.add_plain(pbuf, blk)
        jbuf = jbuffers.add(jbuf, {k: jnp.asarray(v.contiguous().numpy()) for k, v in blk.items()})
        pos = (pos + B) % (3 * B)
        for k in example:
            np.testing.assert_array_equal(model[k].numpy(), pbuf.data[k].numpy(), err_msg=k)
            np.testing.assert_array_equal(model[k].numpy(), np.asarray(jbuf.data[k]), err_msg=f"JAX {k}")
    # a [1, n] view of an [n, 1] mask has contiguous rows: no transpose
    transposed = [name for name, f in zip(example, _fields(pbuf.data, blk)) if f[3]]
    assert transposed == (["mask"] if kind == "grouped" and B > 1 else [])


def test_replay_add_block_map_leaves_no_block_idle():
    """At the pixel DQN's shape the first design's (blocks, fields) grid
    launched 3,528 blocks, 882 of them with work; the flat grid launches
    one block for each share of work, and at most 32768 a field of words."""
    g = torch.Generator()
    g.manual_seed(0)
    blk = _add_block("pixel", 512, g)
    fields = _fields({k: torch.zeros((1024, *v.shape[1:]), dtype=v.dtype) for k, v in blk.items()}, blk)
    assert [f[2] for f in fields] == [16, 4, 4, 1]  # obs in 16-byte words, done in bytes
    assert _plan(fields, 512)[-1] == -(-512 * 441 // 256) + 2 + 2 + 2
    big = _plan(fields, 65536)
    assert big[1] == 32768 and big[-1] == 32768 + 3 * 256


def test_replay_add_word_limits():
    """Each field's copy granule as ``kernels._copy_word`` picks it: 16-byte
    words where the row, the source stride and every pointer allow (the
    pixel frames, the grouped features), else 4-byte (the board DQN's
    200-byte frames at a stride of 800) or single bytes."""
    t = torch.zeros(64, dtype=torch.uint8)
    assert kernels._copy_word(7056, t, stride=4 * 7056) == 16
    assert kernels._copy_word(2080, t, stride=2080) == 16
    assert kernels._copy_word(200, t, stride=800) == 4  # 200 = 12 x 16 + 8
    assert kernels._copy_word(160, t, stride=168) == 4  # the stride
    assert kernels._copy_word(160, t[4:], stride=160) == 4  # the alignment
    assert kernels._copy_word(1, t, stride=1) == 1


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_config(name):
    return (EngineConfig(width=120, height=60), PIECES) if name == "120x60" else _config(name)


def _placement_batches(width, sms):
    """Batches that give ``grouped_placements``' blocks (csrc/
    grouped_placements.cu:envs_per_block) the build's envs with a last block
    part full, fewer envs, and one env, on a card of ``sms`` SMs."""
    k = max(256 // (4 * width), 1)  # kEnvs
    if k == 1:
        return (9,)
    return (9, sms * (k // 2) - 1, sms * k + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GEOMETRIES + ("120x60",))
def test_grouped_placements_matches_plain_on_the_card(cuda, name):
    cfg, pieces = _card_config(name)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B in _placement_batches(cfg.width, sms):
        s = _played(cfg, pieces, B, 12, seed=7)
        for what, st in (("played", s), ("stack", _stacks(s, cfg, 2))):
            on = turbo.TurboState(**{k: getattr(st, k).to(cuda) for k in turbo.FIELDS})
            for max_clear in (0, 4, 20):
                for mode, plain in (("features", tg.placements_plain), ("boards", tg.placement_boards_plain)):
                    want = plain(st, cfg, pieces, max_clear)
                    got = kernels.grouped_placements(on, cfg, pieces, max_clear, mode)
                    for k, (a, b) in enumerate(zip(got, want)):
                        assert torch.equal(a.cpu(), b), (name, B, what, max_clear, mode, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GEOMETRIES + ("120x60",))
def test_grouped_placements_chunk_limits_on_the_card(cuda, name):
    """A boards chunk as the build sizes it: a multiple of 4 candidates (a
    run of boards starts on 16 bytes and streams as 16-byte stores at every
    geometry), within 227 KB of shared memory with the rest of the block,
    on two buffers where they fit, and at least a block an SM."""
    cfg, pieces = _card_config(name)
    occ = kernels.grouped_placements_occupancy(cfg, pieces)
    chunk = occ["chunk_candidates"] * cfg.height * cfg.width
    assert occ["chunk_candidates"] % 4 == 0 and occ["boards_dynamic_smem_bytes"] == occ["chunk_buffers"] * chunk
    assert occ["static_smem_bytes"] + occ["boards_dynamic_smem_bytes"] <= 227 * 1024
    assert occ["chunk_buffers"] == (2 if occ["static_smem_bytes"] + 2 * chunk <= 227 * 1024 else 1)
    assert occ["features_blocks_per_sm"] >= 1 and occ["boards_blocks_per_sm"] >= 1, occ


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B", [("grouped", 1), ("grouped", 1001), ("grouped", 1024), ("pixel", 1),
                                    ("pixel", 512), ("pixel", 4100), ("board", 1001), ("board", 1024)])
def test_replay_add_matches_plain_on_the_card(cuda, kind, B):
    g = torch.Generator()
    g.manual_seed(B)
    example = {k: v.to(cuda) for k, v in _add_block(kind, B, g).items()}
    kbuf = buffers.create(example, 3 * B, B)
    pbuf = buffers.create(example, 3 * B, B)
    for _ in range(4):  # wraps after three adds
        blk = {k: v.to(cuda) for k, v in _add_block(kind, B, g).items()}
        if kind == "grouped":
            blk["mask"] = blk["mask"].T.contiguous().T  # the engine's [A, B], transposed
        kernels.replay_add(kbuf.data, blk, kbuf.pos)
        kbuf = buffers._advance(kbuf, B)
        pbuf = buffers.add_plain(pbuf, blk)
        for k in example:
            assert torch.equal(kbuf.data[k], pbuf.data[k]), (kind, B, k)


@pytest.mark.cuda
def test_replay_add_refuses_a_field_past_32_bit_words(cuda):
    """A field of single-byte words whose count, with the grid's last step
    (32768 runs of 256 words), reaches 2**32 is refused before a launch."""
    n = 2**32 - kernels._ADD_MAX_RUNS * kernels._ADD_THREADS
    store = torch.empty((n, 1), dtype=torch.uint8, device=cuda)
    with pytest.raises(NotImplementedError, match="32-bit word index"):
        kernels.replay_add({"x": store}, {"x": store}, 0)
    launches = kernels.LAUNCHES["replay_add"]
    small = store[: 2 ** 20]
    kernels.replay_add({"x": store[: 2 ** 21]}, {"x": small}, 2 ** 20)  # within the limit: launches
    assert kernels.LAUNCHES["replay_add"] == launches + 1
