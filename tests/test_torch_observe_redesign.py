"""The redesigned observation kernels: ``observe_dict`` (a warp an env, the
env's piece work once, one vote on the collision, whole-word loads and
stores) and ``flagship_observe_board`` (one env a warp for a small batch,
1-4 for a large one, the playfield rows in whole words, the frames staged
in the warp's own shared memory).

On the CPU:

* numpy models of both programs (``csrc/observe_dict.cu``,
  ``csrc/flagship_step.cu:flagship_observe_board_kernel`` over
  ``csrc/board_words.cuh``): the lane map (which lane loads which field and
  which board word), the per-env scalars handed round from the lanes that
  computed them, the piece's and the box's cells as bits of each word, the
  four-byte tests and sums (``__vcmpgts4``, ``__vadd4``, ``__vsub4``), the
  vote, the strips built a row a lane and cut into words with their tails,
  the rows' staging, the crop a frame row a lane in aligned granules, the
  frames' store (the bytes before the first 16-byte boundary, the 16-byte
  words, the tail), both builds of the observation (one env a warp and the
  geometry's envs a warp), and the launchers' envs-a-block rules.  Each
  model must equal ``observe_dict_plain`` / ``observe_board_plain`` and
  JAX's ``observe_dict`` / ``observe_board`` bit for bit, at the default
  board, every geometry of ``chip_smoke.py:surface_geometries()`` and a
  board of an odd number of cells (1-byte words, read again after the
  vote), on seeded trajectories and on hand-built states (a piece that
  collides in its window, pieces against both walls and the floor, empty
  and part-full holders, ``game_over``, piece ids and rotations outside the
  table), in the strips-only mode, at B = 1 and with a ragged last block,
  on cards of several SM counts;
* the word sizes, the crop's granules and the envs a warp that the
  sources fix for each geometry.

On a card (marked ``cuda``; they skip without one, decided inside the
test): both kernels against their plain twins at every geometry, at batches
that give every envs-a-block choice, B = 1, a ragged last block and the
strips-only mode, and the launch shapes against the models' rules.  This
file imports JAX only inside its CPU tests, so ``python -m pytest
--noconftest tests/test_torch_observe_redesign.py -m cuda`` runs on the
card's machine.
"""
import functools

import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.components.tetromino import Tetromino, pieces_from_tetrominoes
from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import engine, turbo
from tetris_gymnasium_torch.ops import board as ob
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES, piece_matrix

CPU = "cpu"
OVERSIZE_SHAPES = (((255, 0, 0), ((1, 1), (1, 1))), ((0, 255, 0), ((1, 1, 1, 1, 1, 1),)),
                   ((0, 0, 255), ((0, 1, 0), (1, 1, 1), (0, 0, 0))))
ACTION_P = (0.1, 0.1, 0.08, 0.1, 0.07, 0.3, 0.15, 0.1)  # chip_smoke.py:FLAGSHIP_ACTION_P
WARPS = 8  # csrc/observe_dict.cu:kWarps and csrc/flagship_step.cu:kObsWarps
H100_SMS = 132


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

GEOMETRIES = ("10x20", "30x20", "30x20-nograv", "61x12", "28x14", "8x12-uniform", "6x6-w10", "6x6-w30",
              "queue1-holder2", "9x13")


def _geometry(name):
    """``(config kwargs, oversize)``: the default board,
    ``chip_smoke.py:surface_geometries()`` and a board of an odd number of
    cells (17 x 17: 1-byte words)."""
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
        "9x13": (dict(width=9, height=13, auto_reset=True), False),
    }[name]


def _oversize_tetrominoes(cls):
    return [cls(2 + i, c, np.array(m, np.uint8)) for i, (c, m) in enumerate(OVERSIZE_SHAPES)]


def _config(name):
    kw, oversize = _geometry(name)
    if oversize:
        pieces, pad = pieces_from_tetrominoes(_oversize_tetrominoes(Tetromino))
        return EngineConfig(padding=pad, **kw), pieces
    return EngineConfig(**kw), PIECES


def _trajectory(cfg, pieces, B, steps, seed, every=4):
    """Every ``every``-th state of a seeded game of random actions (mostly
    hard drops and swaps, so that holders fill and games end)."""
    rng = np.random.default_rng(seed)
    s = engine.init(batch_keys(threefry.prng_key(seed), B, device=CPU), cfg, pieces, device=CPU)
    out = [s]
    for t in range(1, steps + 1):
        a = torch.from_numpy(rng.choice(8, B, p=np.asarray(ACTION_P)).astype(np.int32))
        s = engine.step(s, a, cfg, pieces, obs_fn=engine.no_obs)[0]
        if t % every == 0:
            out.append(s)
    return out


def _hand_built(s, cfg, pieces, seed):
    """``s`` with random stacks of ids (negative ones, bedrock and ids past
    the palette among them) and the piece anywhere: against both walls and
    the floor and past them (the clamped window against the unclamped box),
    piece ids and rotations outside the table, empty, part-full and
    over-full holders, ``game_over`` set on some envs."""
    rng = np.random.default_rng(seed)
    B = s.piece.shape[0]
    H, PW, S = cfg.padded_height, cfg.padded_width, pieces.matrices.shape[-1]
    n = pieces.matrices.shape[0]
    fill = rng.random((B, H, PW)) < 0.35
    board = np.where(fill, rng.integers(-3, 12, (B, H, PW)), s.board.numpy()).astype(np.int8)

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))

    return s.replace(
        board=torch.from_numpy(board), piece=ints(-1, n + 2, B), rotation=ints(-1, 5, B),
        x=ints(-S - 2, PW + 2, B), y=ints(-S - 2, H + 2, B), queue=ints(-1, n + 1, tuple(s.queue.shape)),
        holder_piece=ints(-1, n + 1, tuple(s.holder_piece.shape)),
        holder_rotation=ints(0, 4, tuple(s.holder_rotation.shape)),
        holder_count=ints(-1, cfg.holder_size + 2, B),
        game_over=torch.from_numpy(rng.random(B) < 0.3))


def _cases(cfg, pieces, s):
    """Hand-built single situations, one env each, from the first env of
    ``s``: the piece colliding in its window (the frame a game ends on),
    the piece against the left and right walls and the floor with x and y
    past the clamp, the holder empty and part full, ``game_over``, a piece
    id and a rotation outside the table."""
    H, PW, S = cfg.padded_height, cfg.padded_width, pieces.matrices.shape[-1]
    one = s.replace(**{k: (getattr(s, k)[:, :1] if k == "key" else getattr(s, k)[:1]).clone()
                       for k in engine.FIELDS})
    out = []
    full = one.board.clone()
    full[0, :H - cfg.padding] = 5  # every playfield cell under any window is taken
    out.append(("collides", one.replace(board=full)))
    for what, x, y in (("left wall", -2, 3), ("right wall", PW - 1, 3), ("floor", 3, H - 1),
                       ("past the floor", PW - S + 1, H + 1), ("top left", -S - 1, -S - 1)):
        out.append((what, one.replace(x=torch.tensor([x], dtype=torch.int32),
                                      y=torch.tensor([y], dtype=torch.int32))))
    hs = cfg.holder_size
    for count in (0, max(hs - 1, 0), hs):
        out.append((f"holder {count}", one.replace(holder_count=torch.tensor([count], dtype=torch.int32),
                                                   holder_piece=torch.zeros((1, hs), dtype=torch.int32))))
    out.append(("game over", one.replace(game_over=torch.tensor([True]))))
    n = pieces.matrices.shape[0]
    out.append(("piece outside the table", one.replace(piece=torch.tensor([n], dtype=torch.int32))))
    out.append(("rotation outside the table", one.replace(rotation=torch.tensor([4], dtype=torch.int32))))
    return out


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


def word_bytes(n):
    """``csrc/board_words.cuh:word_bytes``: the widest word of at most 16
    bytes that ``n`` bytes are a whole number of."""
    return next(w for w in (16, 8, 4, 2, 1) if n % w == 0)


def _u32(b):
    """Bytes (``uint8[4k]``) as little-endian 32-bit lanes."""
    return np.frombuffer(np.ascontiguousarray(b, np.uint8).tobytes(), "<u4").astype(np.int64)


def _bytes(lanes, n):
    return np.frombuffer(np.asarray(lanes, "<u4").tobytes(), np.uint8)[:n]


def vcmpgts4_pos(v):
    """``__vcmpgts4(v, 0) & 0x01010101``: 1 in each byte of v that is > 0 as int8."""
    out = 0
    for i in range(4):
        b = (v >> (8 * i)) & 0xFF
        out |= (1 if 0 < b < 128 else 0) << (8 * i)
    return out


def vadd4(a, b):
    return sum((((a >> 8 * i) + (b >> 8 * i)) & 0xFF) << 8 * i for i in range(4))


def vsub4(a, b):
    return sum((((a >> 8 * i) - (b >> 8 * i)) & 0xFF) << 8 * i for i in range(4))


def expand4(nibble):
    """``board_words.cuh:expand4``: four bits as the low bits of four bytes."""
    return (nibble * 0x00204081) & 0x01010101


def _bit_bytes(bits, g):
    return expand4((bits >> (4 * g)) & 15)


class Geo:
    """A geometry's compile-time constants (``engine_common.cuh``) and the
    tables a launch is handed (``turbo.tables_for``, ``kernels._ids_for``)."""

    def __init__(self, cfg, pieces):
        t, packed, box = turbo.tables_for(pieces, CPU)
        self.H, self.PW, self.S = cfg.padded_height, cfg.padded_width, t.size
        self.HEIGHT, self.WIDTH, self.PAD = cfg.height, cfg.width, cfg.padding
        self.QS, self.HS, self.NP = cfg.queue_size, cfg.holder_size, t.n_pieces
        self.TW = (self.S * self.S + 31) // 32
        self.packed = packed.numpy().astype(np.int64) & 0xFFFFFFFF
        self.box = box.numpy()
        self.ids = pieces.ids.astype(np.int64)
        self.BOARD = self.H * self.PW

    def piece_word(self, piece, rot):
        """``piece_word_2d``: the table entry as one integer, 0 outside the table."""
        if not (0 <= piece < self.NP and 0 <= rot < 4):
            return 0
        idx = piece * 4 + rot
        return sum(int(self.packed.reshape(-1)[idx * self.TW + t]) << (32 * t) for t in range(self.TW))

    def piece_row(self, word, i):
        return (word >> (i * self.S)) & ((1 << self.S) - 1)

    def entry(self, table, piece):
        """``piece_entry``: 0 outside the table."""
        return int(table[piece]) if 0 <= piece < self.NP else 0

    def clamp(self, v, limit, dim):
        """``clamp_start``."""
        if v < 0:
            v += dim
        return min(max(v, 0), limit)

    def place(self, bits, r, c0, i0):
        """``board_words.cuh:place``."""
        sh = r * self.PW + c0 - i0
        if sh >= 0:
            return (bits << sh) & 0xFFFFFFFF if sh < 32 else 0
        return bits >> -sh if sh > -32 else 0

    def rows_of(self, W):
        return (W - 1) // self.PW + 2

    def piece_bits(self, W, word, xc, yc, i0):
        r0, bits = i0 // self.PW, 0
        for k in range(self.rows_of(W)):
            r = r0 + k
            if 0 <= r - yc < self.S:
                bits |= self.place(self.piece_row(word, r - yc), r, xc, i0)
        return bits & ((1 << W) - 1)

    def rows_bits(self, W, cols, c0, y, n, i0):
        r0, bits = i0 // self.PW, 0
        for k in range(self.rows_of(W)):
            r = r0 + k
            if 0 <= r - y < n:
                bits |= self.place(cols, r, c0, i0)
        return bits & ((1 << W) - 1)


def _lanes_of_word(word_bytes_, raw):
    """A word's bytes as its 32-bit lanes (one lane holding W < 4 bytes)."""
    pad = (-len(raw)) % 4
    return list(_u32(np.concatenate([raw, np.zeros(pad, np.uint8)])))


def envs_per_block(B, sms):
    """``observe_dict.cu:envs_per_block``: min(8, ceil(B / SMs))."""
    return min(WARPS, max(1, -(-B // sms)))


def obs_warp_envs(niw):
    """``flagship_step.cu:obs_warp_envs``: of 1-4 envs a warp, the count
    whose words fill the warp's rounds of 32 lanes best within six rounds,
    the fewer on a tie (1 where even one env takes more)."""
    best, best_words, best_lanes = 1, 0, 1
    for e in range(1, 5):
        words, lanes = e * niw, 32 * (-(-e * niw // 32))
        if lanes <= 6 * 32 and words * best_lanes > best_words * lanes:
            best, best_words, best_lanes = e, words, lanes
    return best


ONE_ENV_WARPS_PER_SM = 16  # csrc/flagship_step.cu:kObsOneEnvWarpsPerSM


def obs_envs_per_warp(B, niw, sms):
    """``flagship_step.cu:obs_envs_per_warp``: one env a warp while B gives
    the SMs at most 16 warps each, else :func:`obs_warp_envs`."""
    return 1 if B <= ONE_ENV_WARPS_PER_SM * sms else obs_warp_envs(niw)


def obs_warps_per_block(B, E, sms):
    """``flagship_step.cu:obs_warps_per_block`` for the batch's E."""
    warps = -(-B // E)
    return min(WARPS, max(1, -(-warps // sms)))


def _state_np(s):
    return {k: getattr(s, k).numpy() for k in engine.FIELDS}


def model_observe_dict(s, cfg, pieces, strips_only=False, sms=H100_SMS):
    """The program of ``observe_dict_kernel``: blocks of ``envs_per_block``
    warps, a warp an env, as the lanes compute it."""
    g = Geo(cfg, pieces)
    st = _state_np(s)
    B = st["piece"].shape[0]
    S, QS, HS, PW, H = g.S, g.QS, g.HS, g.PW, g.H
    WB = word_bytes(g.BOARD)
    NBW = g.BOARD // WB
    rounds = -(-NBW // 32)
    L_HOLD, L_ACTIVE = QS, QS + HS
    L_X, L_Y, L_COUNT = L_ACTIVE + 1, L_ACTIVE + 2, L_ACTIVE + 3
    assert L_COUNT < 32 and 2 * S <= 32
    board_in = st["board"].view(np.uint8).reshape(B, -1)
    out = {"holder": np.full((B, S, S * HS), 0xEE, np.uint8), "queue": np.full((B, S, S * QS), 0xEE, np.uint8)}
    if not strips_only:
        out["board"] = np.full((B, g.BOARD), 0xEE, np.uint8)
        out["active_tetromino_mask"] = np.full((B, g.BOARD), 0xEE, np.uint8)
    envs = envs_per_block(B, sms)
    blocks = -(-B // envs)
    seen = np.zeros(B, np.int64)
    for blk in range(blocks):
        for warp in range(envs):
            b = blk * envs + warp
            if b >= B:
                continue  # the whole warp returns
            seen[b] += 1
            # one field a lane, then each subject lane's table entries
            f, rot = [0] * 32, [0] * 32
            for lane in range(L_COUNT + 1):
                if lane < L_HOLD:
                    f[lane] = int(st["queue"][b, lane])
                elif lane < L_ACTIVE:
                    f[lane] = int(st["holder_piece"][b, lane - L_HOLD])
                    rot[lane] = int(st["holder_rotation"][b, lane - L_HOLD])
                elif lane == L_ACTIVE:
                    f[lane], rot[lane] = int(st["piece"][b]), int(st["rotation"][b])
                else:
                    f[lane] = int(st[{L_X: "x", L_Y: "y", L_COUNT: "holder_count"}[lane]][b])
            word = [g.piece_word(f[l], rot[l]) if l <= L_ACTIVE else 0 for l in range(32)]
            idn = [g.entry(g.ids, f[l]) if l <= L_ACTIVE else 0 for l in range(32)]
            side = g.entry(g.box, f[L_ACTIVE])
            # handed round by shuffles
            aw, pid, bx = word[L_ACTIVE], idn[L_ACTIVE], side
            x, y, count = f[L_X], f[L_Y], f[L_COUNT]
            qw, qid = word[:QS], [v & 0xFF for v in idn[:QS]]
            hw, hid = word[L_HOLD:L_ACTIVE], [v & 0xFF for v in idn[L_HOLD:L_ACTIVE]]
            if not strips_only:
                xc, yc = g.clamp(x, PW - S, PW), g.clamp(y, H - S, H)
                mlo, mhi = max(x, 0), min(x + bx, PW)
                mcols = (1 << (mhi - mlo)) - 1 if mhi > mlo else 0
                hit, words = False, []
                for k in range(rounds):
                    for lane in range(32):
                        w = lane + 32 * k
                        if w >= NBW:
                            continue
                        i0 = w * WB
                        lanes = _lanes_of_word(WB, board_in[b, i0:i0 + WB])
                        pb = g.piece_bits(WB, aw, xc, yc, i0)
                        mb = g.rows_bits(WB, mcols, mlo, y, bx, i0)
                        hit |= any(vcmpgts4_pos(v) & _bit_bytes(pb, gi) for gi, v in enumerate(lanes))
                        words.append((i0, lanes, pb, mb))
                add = 0 if hit else pid & 0xFF  # __any_sync over the warp
                for i0, lanes, pb, mb in words:
                    o = [vadd4(v, _bit_bytes(pb, gi) * add) for gi, v in enumerate(lanes)]
                    m = [_bit_bytes(mb, gi) for gi in range(len(lanes))]
                    out["board"][b, i0:i0 + WB] = _bytes(o, WB)
                    out["active_tetromino_mask"][b, i0:i0 + WB] = _bytes(m, WB)
            for lane in range(2 * S):  # the strips, a row a lane
                if lane < S:
                    rows = [g.piece_row(w_, lane) for w_ in qw]
                    out["queue"][b, lane] = _strip_row(S, rows, qid)
                else:
                    i = lane - S
                    rows = [g.piece_row(hw[k], i) if k < count else (1 << S) - 1 for k in range(HS)]
                    idb = [hid[k] if k < count else 1 for k in range(HS)]
                    out["holder"][b, i] = _strip_row(S, rows, idb)
    assert (seen == 1).all()
    if not strips_only:
        for k in ("board", "active_tetromino_mask"):
            out[k] = out[k].reshape(B, H, PW)
    return out


def _strip_row(S, rows, idb):
    """``observe_dict.cu:strip_row``: the row's bytes as 32-bit lanes, then
    cut into words of the widest size the row is a whole number of (one
    lane's low bytes where that is under 4), then laid out again."""
    n = len(rows) * S
    lanes = [0] * (-(-n // 4))
    for j in range(n):
        lanes[j // 4] |= (((rows[j // S] >> (j % S)) & 1) * idb[j // S]) << (8 * (j % 4))
    W = word_bytes(n)
    out = []
    for q in range(n // W):
        if W >= 4:
            out += list(_bytes(lanes[q * W // 4:(q + 1) * W // 4], W))
        else:
            v = (lanes[q * W // 4] >> (8 * (q * W % 4))) & ((1 << (8 * W)) - 1)
            out += [(v >> (8 * t)) & 0xFF for t in range(W)]
    return np.array(out, np.uint8)


def granule(cfg):
    """``flagship_step.cu:G``: a frame row's bytes move in words of the
    widest of 4, 2 and 1 that PW, PAD and WIDTH are multiples of."""
    return next(g for g in (4, 2, 1) if cfg.padded_width % g == 0 and cfg.padding % g == 0 and cfg.width % g == 0)


def model_observe_board(s, cfg, pieces, sms=H100_SMS, out_offset=0, envs=None):
    """The program of ``flagship_observe_board_kernel<E>``: warps of E envs
    (``envs``, by default the launcher's choice for B), blocks of
    ``obs_warps_per_block`` warps; each word of the envs' playfield rows
    made four bytes at a time and staged in the warp's rows, a frame row a
    lane cropped from them in granules, the frames stored from the first
    16-byte boundary of the output (which starts ``out_offset`` bytes past
    one)."""
    g = Geo(cfg, pieces)
    st = _state_np(s)
    B = st["piece"].shape[0]
    S, PW, H = g.S, g.PW, g.H
    OBS, PLAY = g.HEIGHT * g.WIDTH, g.HEIGHT * PW
    WI = word_bytes(g.BOARD)
    NIW = -(-PLAY // WI)
    assert NIW * WI <= g.BOARD  # never past the board's end
    SPLAY, G = NIW * WI, granule(cfg)
    E = obs_envs_per_warp(B, NIW, sms) if envs is None else envs
    rounds = -(-E * NIW // 32)
    board_in = st["board"].view(np.uint8).reshape(B, -1)
    out = np.full(B * OBS, 0xEE, np.uint8)
    written = np.zeros(B * OBS, np.int64)
    warps = obs_warps_per_block(B, E, sms)
    blocks = -(-(-(-B // E)) // warps)
    for blk in range(blocks):
        for warp in range(warps):
            e0 = (blk * warps + warp) * E
            if e0 >= B:
                continue
            n = min(E, B - e0)
            word, win = [0] * 32, [0] * 32  # env lanes: the piece word, the window x | y << 8
            for lane in range(n):
                b = e0 + lane
                if not st["game_over"][b]:
                    word[lane] = g.piece_word(int(st["piece"][b]), int(st["rotation"][b]))
                win[lane] = g.clamp(int(st["x"][b]), PW - S, PW) | g.clamp(int(st["y"][b]), H - S, H) << 8
            o0 = e0 * OBS
            off = (out_offset + o0) & 15
            rows = np.full(E * SPLAY, 0xCD, np.uint8)
            frames = np.full(off + E * OBS + 16, 0xCD, np.uint8)
            for k in range(rounds):
                for lane in range(32):
                    e, w = divmod(lane + 32 * k, NIW)
                    src = min(e, E - 1)  # the shuffle's source lane
                    if e >= n:
                        continue
                    i0 = w * WI
                    lanes = _lanes_of_word(WI, board_in[e0 + e, i0:i0 + WI])
                    pb = g.piece_bits(WI, word[src], win[src] & 0xFF, win[src] >> 8, i0)
                    rows[e * SPLAY + i0:e * SPLAY + i0 + WI] = _bytes(
                        [vsub4(vcmpgts4_pos(v), _bit_bytes(pb, gi)) for gi, v in enumerate(lanes)], WI)
            for item in range(n * g.HEIGHT):  # the crop, a frame row a lane
                e, r = divmod(item, g.HEIGHT)
                a, z = e * SPLAY + r * PW + g.PAD, off + e * OBS + r * g.WIDTH
                assert a % G == 0 and z % G == 0  # granule-aligned in the warp's shared memory
                frames[z:z + g.WIDTH] = rows[a:a + g.WIDTH]
            # the store: bytes to the first 16-byte boundary, words, the tail
            nbytes = n * OBS
            lead = min((16 - off) & 15, nbytes)
            nwords = (nbytes - lead) // 16
            assert (off + lead) % 16 == 0 and (out_offset + o0 + lead) % 16 == 0 or nwords == 0
            spans = [(0, lead)] + [(lead + 16 * q, lead + 16 * q + 16) for q in range(nwords)] + \
                [(lead + 16 * nwords, nbytes)]
            for a, z in spans:
                out[o0 + a:o0 + z] = frames[off + a:off + z]
                written[o0 + a:o0 + z] += 1
    assert (written == 1).all()
    return out.view(np.int8).reshape(B, g.HEIGHT, g.WIDTH)


# ---------------------------------------------------------------------------
# JAX, the oracle (imported inside the CPU tests)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_obs(name):
    import jax

    from tetris_gymnasium_tpu.components.tetromino import Tetromino as JTetromino
    from tetris_gymnasium_tpu.components.tetromino import pieces_from_tetrominoes as jpieces_from
    from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
    from tetris_gymnasium_tpu.core import engine as jengine
    from tetris_gymnasium_tpu.pieces import PIECES as JPIECES

    kw, oversize = _geometry(name)
    if oversize:
        jp, pad = jpieces_from(_oversize_tetrominoes(JTetromino))
        jc = JEngineConfig(padding=pad, **kw)
    else:
        jp, jc = JPIECES, JEngineConfig(**kw)
    return jax.jit(lambda s: (jax.vmap(functools.partial(jengine.observe_dict, config=jc, pieces=jp))(s),
                              jax.vmap(functools.partial(jengine.observe_board, config=jc, pieces=jp))(s)))


def _jax(name, s):
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.core import engine as jengine

    fields = {k: np.array(getattr(s, k)) for k in engine.FIELDS}
    fields["key"] = fields["key"].T  # the port keeps the key as [2, B]
    d, ob = _jax_obs(name)(jengine.EngineState(**{k: jnp.asarray(v) for k, v in fields.items()}))
    return {k: np.asarray(v) for k, v in d.items()}, np.asarray(ob)


def _check(name, cfg, pieces, s, what, with_jax, sms=H100_SMS):
    plain = engine.observe_dict_plain(s, cfg, pieces)
    plain_ob = engine.observe_board_plain(s, cfg, pieces)
    got = model_observe_dict(s, cfg, pieces, sms=sms)
    strips = model_observe_dict(s, cfg, pieces, strips_only=True, sms=sms)
    assert sorted(strips) == ["holder", "queue"]
    ob = model_observe_board(s, cfg, pieces, sms=sms)
    g = Geo(cfg, pieces)
    big = obs_warp_envs(-(-cfg.height * g.PW // word_bytes(g.BOARD)))
    for E in {1, big}:  # both builds, whichever B picks
        np.testing.assert_array_equal(model_observe_board(s, cfg, pieces, sms=sms, envs=E), plain_ob.numpy(),
                                      err_msg=f"{name} {what} observe_board, {E} envs a warp")
    for k, v in plain.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=f"{name} {what} observe_dict {k}")
        if k in strips:
            np.testing.assert_array_equal(strips[k], v.numpy(), err_msg=f"{name} {what} strips {k}")
    np.testing.assert_array_equal(ob, plain_ob.numpy(), err_msg=f"{name} {what} observe_board")
    if with_jax:
        jd, job = _jax(name, s)
        for k, v in jd.items():
            assert got[k].dtype == v.dtype, (name, what, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{name} {what} JAX observe_dict {k}")
        assert ob.dtype == job.dtype
        np.testing.assert_array_equal(ob, job, err_msg=f"{name} {what} JAX observe_board")


def _project_hits(s, cfg, pieces):
    """Envs whose piece collides in its window (``project_active``'s test)."""
    mat = piece_matrix(pieces, s.piece, s.rotation)
    return int(ob.collision(s.board, mat, s.x, s.y).sum())


# ---------------------------------------------------------------------------
# CPU: the models against the plain twins and JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", GEOMETRIES)
def test_models_match_plain_and_jax_on_trajectories(name):
    """Seeded games (B = 5) at every fourth step, the last block ragged on a
    card of 2 SMs (envs a block 3: blocks of 3 and 2)."""
    cfg, pieces = _config(name)
    B = 3 if cfg.width > 40 else 5
    states = _trajectory(cfg, pieces, B, 24, seed=len(name))
    for t, s in enumerate(states):
        _check(name, cfg, pieces, s, f"step {4 * t}", with_jax=t % 3 == 0, sms=2)
    held = sum(int((s.holder_count > 0).sum()) for s in states)
    assert held > 0, "no holder filled: the strips' pieces went untested"


@pytest.mark.parametrize("name", GEOMETRIES)
def test_models_match_plain_and_jax_on_hand_built_states(name):
    """Random stacks of ids and the piece anywhere (walls, floor, past
    them, outside the table), odd holders and ``game_over``: each model
    against the plain twins and JAX, with collisions among the envs."""
    cfg, pieces = _config(name)
    B = 4 if cfg.width > 40 else 7
    base = _trajectory(cfg, pieces, B, 8, seed=3, every=8)[-1]
    hits = 0
    for seed in range(2):
        s = _hand_built(base, cfg, pieces, seed)
        hits += _project_hits(s, cfg, pieces)
        _check(name, cfg, pieces, s, f"hand-built {seed}", with_jax=True, sms=3)
    assert hits > 0, "no collision among the hand-built envs"


@pytest.mark.parametrize("name", GEOMETRIES)
def test_models_on_single_situations(name):
    """A colliding piece, the walls and the floor, holders empty and part
    full, game over, a piece and a rotation outside the table; B = 1."""
    cfg, pieces = _config(name)
    s = _trajectory(cfg, pieces, 2, 6, seed=5, every=6)[-1]
    for what, one in _cases(cfg, pieces, s):
        _check(name, cfg, pieces, one, what, with_jax=True, sms=H100_SMS)
        if what == "collides":
            assert _project_hits(one, cfg, pieces) == 1
            got = model_observe_dict(one, cfg, pieces)
            np.testing.assert_array_equal(got["board"], one.board.numpy().view(np.uint8))


@pytest.mark.parametrize("B", [1, 2, 9, 131, 133, 263, 1057, 1061])
def test_envs_a_block_rules_cover_every_env_once(B):
    """Both launchers' grids on the H100's 132 SMs and on small cards:
    every env in one warp's work, no block empty, and the envs-a-block
    choice taking each of 1..8 across these batches."""
    for sms in (H100_SMS, 7, 1):
        envs = envs_per_block(B, sms)
        blocks = -(-B // envs)
        assert 1 <= envs <= WARPS and (blocks - 1) * envs < B <= blocks * envs
        for niw in (23, 48, 52, 63):
            E = obs_envs_per_warp(B, niw, sms)
            assert E == (1 if B <= 16 * sms else obs_warp_envs(niw))
            warps = obs_warps_per_block(B, E, sms)
            nwarps = -(-B // E)
            blocks = -(-nwarps // warps)
            assert 1 <= warps <= WARPS and (blocks - 1) * warps < nwarps <= blocks * warps
    chosen = {envs_per_block(b, H100_SMS) for b in (1, 133, 265, 397, 529, 661, 793, 925)}
    assert chosen == set(range(1, WARPS + 1))


def test_word_sizes_and_envs_a_warp_of_the_geometries():
    """The words each geometry's board takes (16 bytes at 10x20, 30x20 and
    61x12, 8 at 28x14, 4 for the 6x6 pieces at 30x16), whether a lane holds
    its board words in registers (six rounds at most), its playfield words,
    its envs a warp, and the strip rows' word sizes with their tails (a
    6-byte holder row in 2-byte words, a 12-byte queue row in 4-byte words)."""
    want = {"10x20": (16, True, 23, 4), "30x20": (16, True, 48, 2), "61x12": (16, True, 52, 3),
            "28x14": (8, True, 63, 1), "6x6-w30": (4, False, 168, 1)}
    for name, (wb, held, niw, e) in want.items():
        cfg, pieces = _config(name)
        board = cfg.padded_height * cfg.padded_width
        assert word_bytes(board) == wb
        assert (-(-board // wb // 32) <= 6) == held
        assert -(-cfg.height * cfg.padded_width // wb) == niw
        assert obs_warp_envs(niw) == e and -(-e * niw // 32) <= 6
    assert obs_warp_envs(289) == 1  # an odd board: 1-byte words, no env fits six rounds
    assert [granule(_config(n)[0]) for n in ("10x20", "30x20", "61x12", "28x14")] == [2, 2, 1, 4]
    S = 6
    row = _strip_row(S, [0b101101], [7])
    assert word_bytes(S) == 2 and list(row) == [7, 0, 7, 7, 0, 7]
    row = _strip_row(4, [0b1111, 0, 0b0001], [2, 3, 4])
    assert word_bytes(12) == 4 and list(row) == [2, 2, 2, 2, 0, 0, 0, 0, 4, 0, 0, 0]


def test_frame_store_from_any_offset():
    """The frames' store from an output that starts 0-14 bytes past a
    16-byte boundary (any multiple of the crop's granule: the wrapper's
    ``torch.empty`` output is 16-byte aligned, and the kernel works the
    offset out from the address): the bytes before the first boundary, the
    words and the tail write every byte once, equal to the plain twin."""
    cfg, pieces = _config("10x20")
    s = _hand_built(_trajectory(cfg, pieces, 6, 4, seed=9, every=4)[-1], cfg, pieces, 4)
    want = engine.observe_board_plain(s, cfg, pieces).numpy()
    for offset in range(0, 16, granule(cfg)):
        np.testing.assert_array_equal(model_observe_board(s, cfg, pieces, out_offset=offset), want)


# ---------------------------------------------------------------------------
# The card: the kernels against their plain twins
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(s, dev):
    return s.replace(**{k: getattr(s, k).to(dev) for k in engine.FIELDS})


def _card_batches(cfg, pieces, sms):
    """B = 1, and batches that give ``observe_dict`` every envs-a-block
    choice (1..8) with a ragged last block."""
    return sorted({1} | {sms * (k - 1) + 1 for k in range(1, WARPS + 1)} | {sms * WARPS + 5})


@pytest.mark.cuda
@pytest.mark.parametrize("name", GEOMETRIES)
def test_observe_dict_matches_plain_on_the_card(cuda, name):
    cfg, pieces = _config(name)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B in _card_batches(cfg, pieces, sms):
        assert kernels.observe_dict_shape(cfg, pieces, B)["envs_per_block"] == envs_per_block(B, sms)
        base = _trajectory(cfg, pieces, B, 8, seed=B, every=4)
        for what, s in (("played", base[-1]), ("hand-built", _hand_built(base[-1], cfg, pieces, B))):
            want = engine.observe_dict_plain(s, cfg, pieces)
            got = kernels.observe_dict(_on(s, cuda), cfg, pieces)
            strips = kernels.observe_dict(_on(s, cuda), cfg, pieces, strips_only=True)
            assert sorted(strips) == ["holder", "queue"]
            for k, v in want.items():
                assert torch.equal(got[k].cpu(), v), (name, B, what, k)
                if k in strips:
                    assert torch.equal(strips[k].cpu(), v), (name, B, what, "strips", k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GEOMETRIES)
def test_flagship_observe_board_matches_plain_on_the_card(cuda, name):
    cfg, pieces = _config(name)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = Geo(cfg, pieces)
    niw = -(-cfg.height * g.PW // word_bytes(g.BOARD))
    big = obs_warp_envs(niw)
    # one env a warp at 1..8 warps a block, then the large build's blocks
    batches = sorted({1} | {sms * (k - 1) + 1 for k in range(1, WARPS + 1)} | {16 * sms + 1}
                     | {big * sms * (k - 1) + 1 for k in range(1, WARPS + 1) if big * sms * (k - 1) + 1 > 16 * sms}
                     | {big * sms * WARPS + 3})
    for B in batches:
        shape = kernels.flagship_observe_board_shape(cfg, pieces, B)
        E = obs_envs_per_warp(B, niw, sms)
        assert (shape["envs_per_warp"], shape["warps_per_block"]) == (E, obs_warps_per_block(B, E, sms))
        base = _trajectory(cfg, pieces, B, 8, seed=B, every=4)
        for what, s in (("played", base[-1]), ("hand-built", _hand_built(base[-1], cfg, pieces, B))):
            want = engine.observe_board_plain(s, cfg, pieces)
            assert torch.equal(kernels.flagship_observe_board(_on(s, cuda), cfg, pieces).cpu(), want), \
                (name, B, what)
