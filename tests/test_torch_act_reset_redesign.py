"""The redesigned ``dqn_act`` (one thread an env, the row's loads in flight
before the draws, randint's split of the action key made on the card) and
``fn_reset`` (the board and the observation as streams of 16-byte words
beside one short RNG chain an env).

On the CPU:

* numpy models of both launch maps.  For ``dqn_act`` (``csrc/dqn_act.cu``):
  threads a block and the lanes to envs, the argmax in ``jnp.argmax``'s
  order (the A = 8 build's tree, the generic build's loop), randint's split
  made from the action key by an independent numpy threefry block, the
  draws at counter ``env_offset + b`` and the select.
  For ``fn_reset`` (``csrc/fn_env.cu``): envs a block, the streaming and
  env threads, the board words computed from their byte offsets (one word
  throughout a thread's stream where its stride is a multiple of the
  period), the observation's zero words and the words the spawned pieces
  touch, the tensors' ragged ends, the key's split, the bag's sort by
  ranks and the queue tile.  Each model
  must equal the plain twin (``rl/dqn.py:act_plain``,
  ``core/fn_env.py:reset_plain``) and JAX (``jax.random.randint`` /
  ``uniform`` / ``jnp.argmax``; ``jax.vmap(core.fn_env.reset)``) bit for
  bit on seeded inputs: rows with NaNs, ties, +-inf and all-equal values at
  A = 1, 5, 8 and 40; the five compat configurations of ``chip_smoke.py``'s
  ``fn_geometries`` and two odd boards (an observation shorter than a
  16-byte word) at B = 1, 2, 3, 17 and 1001; every byte of both tensors
  written exactly once.  The ranks hold ties in the
  stable order of JAX's ``sort_key_val``.
* the split model against ``ops/threefry.py:split`` for many keys.

On a card (marked ``cuda``; they skip without one, decided inside the
test): every ``dqn_act`` build against ``act_plain`` (keys and greedy, at
offsets 0, B and 3B, with the draws, a misaligned ``q``), that
``kernels.dqn_act`` makes no call into the host threefry module,
``fn_reset`` against ``reset_plain`` at every configuration and the
batches above, and both launchers' shapes against the models.  The file
imports JAX only inside its CPU tests, so ``python -m pytest --noconftest
tests/test_torch_act_reset_redesign.py -m cuda`` runs on the card's
machine.
"""
import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.config import EnvConfig
from tetris_gymnasium_torch.core import fn_env
from tetris_gymnasium_torch.ops import board as ob
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.ops.queue import BAG_QUEUE, UNIFORM_QUEUE
from tetris_gymnasium_torch.pieces import PIECES
from tetris_gymnasium_torch.rl import dqn

H100_SMS = 132
M32 = 0xFFFFFFFF
# chip_smoke.py:fn_geometries: (name, EnvConfig keywords, queue kind)
FN_GEOMETRIES = (("10x20", dict(), "bag"), ("10x20-nograv", dict(gravity_enabled=False), "bag"),
                 ("uniform5", dict(queue_size=5), "uniform"), ("30x20", dict(width=30), "bag"),
                 ("8x12-pad2", dict(width=8, height=12, padding=2), "bag"))
RESET_B = (1, 2, 3, 17, 1001)
# boards past chip_smoke's: observations shorter than a 16-byte word (3x4
# with padding 1) and envs a block a multiple of 16 (5x9 with padding 3)
ODD_GEOMETRIES = (("3x4-pad1", dict(width=3, height=4, padding=1), "bag"),
                  ("5x9-pad3", dict(width=5, height=9, padding=3), "bag"))
ACTIONS = (1, 5, 8, 40)
RESET_THREADS = 256  # csrc/fn_env.cu:kResetThreads
RESET_WARPS = RESET_THREADS // 32
RESET_MAX_ENVS = 128  # csrc/fn_env.cu:kResetMaxEnvs, or less where 128 envs' boards and observations pass 128 KB


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Threefry as csrc/threefry.cuh computes it, in numpy
# ---------------------------------------------------------------------------


def _block(k0, k1, c0, c1):
    """Both words of one 20-round threefry-2x32 block of key (k0, k1) at
    counter (c0, c1), lane-wise over numpy uint32 arrays."""
    k0, k1, c0, c1 = (np.asarray(v, dtype=np.uint32) for v in (k0, k1, c0, c1))
    k2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
    inject = ((k1, k2, 1), (k2, k0, 2), (k0, k1, 3), (k1, k2, 4), (k2, k0, 5))
    with np.errstate(over="ignore"):
        x0, x1 = c0 + k0, c1 + k1
        for g in range(5):
            for r in ((13, 15, 26, 6), (17, 29, 16, 24))[g % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x1 ^ x0
            a, b, c = inject[g]
            x0 = x0 + a
            x1 = x1 + b + np.uint32(c)
    return x0, x1


def _bits(k, c):
    y0, y1 = _block(k[0], k[1], 0, c)
    return y0 ^ y1


def _uniform(bits):
    """tf::uniform(bits, 0, 1): the top 23 bits as a float in [1, 2), less 1."""
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)


def test_split_model_is_threefry_split():
    """The split the kernels make on the card (the key's blocks at counters
    (0, 0) and (0, 1)) is ``threefry.split`` for many keys."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, (4000, 2), dtype=np.uint64).astype(np.uint32)
    keys[:3] = ((0, 0), (M32, M32), (0, 1))
    want = np.stack([threefry.split(k) for k in keys])
    for i in range(2):
        y0, y1 = _block(keys[:, 0], keys[:, 1], 0, i)
        np.testing.assert_array_equal(np.stack([y0, y1], -1), want[:, i])


# ---------------------------------------------------------------------------
# dqn_act's launch map
# ---------------------------------------------------------------------------


def _beats(v, best):
    return np.where(np.isnan(v), ~np.isnan(best), v > best)


def _argmax_tree(v):
    """dqn_act.cu:argmax_tree over the last axis: pairs at distance 1, 2,
    4, ..., the right member taken where it beats the left one."""
    n = v.shape[-1]
    bv, bi = v.copy(), np.broadcast_to(np.arange(n), v.shape).copy()
    w = 1
    while w < n:
        for i in range(0, n - w, 2 * w):
            take = _beats(bv[:, i + w], bv[:, i])
            bv[:, i] = np.where(take, bv[:, i + w], bv[:, i])
            bi[:, i] = np.where(take, bi[:, i + w], bi[:, i])
        w *= 2
    return bv[:, 0], bi[:, 0]


def _scan(rows):
    """The generic build's loop: value a taken where it beats the best so far."""
    best, arg = rows[:, 0].copy(), np.zeros(len(rows), np.int64)
    for a in range(1, rows.shape[1]):
        take = _beats(rows[:, a], best)
        best, arg = np.where(take, rows[:, a], best), np.where(take, a, arg)
    return arg


def _argmax_model(rows):
    """The A = 8 build's tree, or the generic build's loop."""
    return _argmax_tree(rows)[1] if rows.shape[1] == 8 else _scan(rows)


def _threads_for(B, sms=H100_SMS):
    """dqn_act.cu:threads_for: 128, or the whole warps that give every SM a block, at least 32."""
    warps = -(-(-(-B // sms)) // 32)
    return min(128, max(32, 32 * warps))


def _act_model(q, act_key=None, eps_key=None, epsilon=0.0, env_offset=0, sms=H100_SMS):
    """(action, randint draws, uniforms) of dqn_act's launch: thread t of
    block k takes env k * T + t; the key's split, both draws and the
    uniform at counter env_offset + b; the select."""
    B, A = q.shape
    T = _threads_for(B, sms)
    envs = (np.arange(-(-B // T))[:, None] * T + np.arange(T)).ravel()
    envs = envs[envs < B]
    assert np.array_equal(np.sort(envs), np.arange(B))
    arg = np.empty(B, np.int32)
    arg[envs] = _argmax_model(q[envs])
    if act_key is None:
        return arg, None, None
    c = (env_offset + np.arange(B)).astype(np.uint32)
    span = np.uint32(A)
    m = np.uint32(((65536 % A) * (65536 % A)) % 2**32 % A)
    lo_key = _block(act_key[0], act_key[1], 0, 1)
    with np.errstate(over="ignore"):
        if A == 8:
            random_a = (_bits(lo_key, c) & np.uint32(7)).astype(np.int32)
        else:
            hi_key = _block(act_key[0], act_key[1], 0, 0)
            high = (_bits(hi_key, c) % span) * m
            random_a = ((high + _bits(lo_key, c) % span) % span).astype(np.int32)
    u = _uniform(_bits(eps_key, c))
    return np.where(u < np.float32(epsilon), random_a, arg).astype(np.int32), random_a, u


def _q_rows(B, A, seed):
    """Seeded Q rows with the argmax's edge cases: NaNs (first, later,
    several), ties, +-inf, all-equal rows, -0.0 beside 0.0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, A)).astype(np.float32)
    q[::7] = np.round(q[::7])  # ties
    if A > 1:
        q[1::11, 0] = np.nan
        q[2::11, A - 1] = np.nan
        q[3::11, ::2] = np.nan
        q[4::11, A // 2] = np.inf
        q[5::11, :] = -np.inf
        q[6::11, 1] = np.inf
        q[6::11, A - 1] = np.inf
        q[7::11] = 0.25
        q[8::11, 0], q[8::11, A - 1] = -0.0, 0.0
        q[9::11] = np.nan
    return q


def _jax_act(q, act_key, eps_key, epsilon, env_offset):
    import jax
    import jax.numpy as jnp

    B, A = q.shape
    greedy = np.asarray(jnp.argmax(jnp.asarray(q), axis=-1))
    n = env_offset + B
    random_a = np.asarray(jax.random.randint(jnp.asarray(act_key), (n,), 0, A))[env_offset:]
    u = np.asarray(jax.random.uniform(jnp.asarray(eps_key), (n,)))[env_offset:]
    return np.where(u < np.float32(epsilon), random_a, greedy).astype(np.int32), random_a, u, greedy


@pytest.mark.parametrize("A", ACTIONS)
def test_act_model_matches_plain_and_jax(A):
    """The launch map of each build at A = 1, 5, 8 and 40, epsilon 0, 0.4
    and 1, env offsets 0 and 3B, against act_plain and JAX."""
    for B in (1, 45, 700):
        q = _q_rows(B, A, 7 * A + B)
        greedy, _, _ = _act_model(q)
        np.testing.assert_array_equal(greedy, dqn.act_plain(torch.from_numpy(q)).numpy())
        for trial, (epsilon, off) in enumerate(((0.0, 0), (1.0, 3 * B), (0.4, 3 * B), (0.4, 0))):
            act_key, eps_key = threefry.split(threefry.fold_in(threefry.prng_key(A), 10 * B + trial))
            got, random_a, u = _act_model(q, act_key, eps_key, epsilon, off)
            plain = dqn.act_plain(torch.from_numpy(q), act_key, eps_key, epsilon, env_offset=off).numpy()
            jact, jrand, ju, jgreedy = _jax_act(q, act_key, eps_key, epsilon, off)
            what = f"A={A} B={B} eps={epsilon} offset={off}"
            np.testing.assert_array_equal(got, plain, err_msg=what)
            np.testing.assert_array_equal(got, jact, err_msg=what)
            np.testing.assert_array_equal(random_a, jrand, err_msg=what)
            np.testing.assert_array_equal(u, ju, err_msg=what)
            np.testing.assert_array_equal(greedy, jgreedy, err_msg=what)


def test_argmax_tree_is_the_sequential_scan():
    """The tree's pairs keep jnp.argmax's answer on every row of NaN, +-inf
    and tie patterns over 8 values drawn from a few classes."""
    rng = np.random.default_rng(3)
    classes = np.array([np.nan, -np.inf, np.inf, 0.0, -0.0, 1.0, -1.0], np.float32)
    rows = classes[rng.integers(0, len(classes), (20000, 8))]
    np.testing.assert_array_equal(_argmax_tree(rows)[1], _scan(rows))
    np.testing.assert_array_equal(_argmax_model(np.repeat(rows, 5, axis=1)[:, :37]),
                                  torch.argmax(torch.from_numpy(np.repeat(rows, 5, axis=1)[:, :37]), -1).numpy())


@pytest.mark.parametrize("B", [1, 512, 1024, 4096, 32768, 65536])
def test_act_threads_a_block_rule(B):
    """Small batches spread over every SM, whole warps, 32 to 128 threads."""
    T = _threads_for(B)
    assert T % 32 == 0 and 32 <= T <= 128
    blocks = -(-B // T)
    assert blocks >= min(H100_SMS, -(-B // 32)) or T == 128
    assert {512: 32, 1024: 32, 65536: 128}.get(B, T) == T


# ---------------------------------------------------------------------------
# fn_reset's launch map
# ---------------------------------------------------------------------------


class _Geo:
    """csrc/fn_env.cu's compile-time constants for a config and piece set."""

    def __init__(self, cfg, pieces=PIECES):
        from math import gcd

        self.cfg = cfg
        self.HEIGHT, self.WIDTH, self.PAD = cfg.height, cfg.width, cfg.padding
        self.H, self.PW = cfg.padded_height, cfg.padded_width
        self.CELLS, self.OBS = self.H * self.PW, cfg.height * cfg.width
        self.QS, self.NP = cfg.queue_size, pieces.matrices.shape[0]
        self.S = pieces.matrices.shape[-1]
        self.obs_align = 16 // gcd(self.OBS, 16)
        self.board_align = 16 // gcd(self.CELLS, 16)
        self.env_align = max(self.obs_align, self.board_align)
        self.period = self.board_align * self.CELLS // 16
        self.word_rows = 15 // self.PW + 2
        self.spawn_x = self.PW // 2 - 2
        v = self.spawn_x + self.PW if self.spawn_x < 0 else self.spawn_x
        self.xc = min(max(v, 0), self.PW - self.S)
        self.win_rows = min(self.S, self.HEIGHT)
        c0, c1 = max(self.xc - self.PAD, 0), min(self.xc - self.PAD + self.S, self.WIDTH)
        self.has_win, self.win_c0 = c0 < c1, c0
        self.win_lo, self.win_hi = c0, (self.win_rows - 1) * self.WIDTH + c1
        self.win_words = (self.win_hi - self.win_lo + 14) // 16 + 1 if self.has_win else 0
        self.max_envs = min(RESET_MAX_ENVS, 1 << ((131072 // (self.CELLS + self.OBS)).bit_length() - 1))
        self.span_envs = (15 + self.OBS - 1) // self.OBS + 1
        mats = np.asarray(pieces.matrices) > 0
        self.masks = [sum(1 << (i * self.S + j) for i in range(self.S) for j in range(self.S) if mats[p, r, i, j])
                      for p in range(self.NP) for r in range(4)]

    def act_row(self, m, r):
        """fn_env.cu:act_row(m, xc, 0, r): row r of the observation's piece cells, WIDTH bits."""
        if r >= self.S:
            return 0
        row = (m >> (r * self.S)) & ((1 << self.S) - 1)
        return ((row << self.xc) >> self.PAD) & ((1 << self.WIDTH) - 1)


def _reset_envs(g, B, sms=H100_SMS):
    """fn_env.cu:reset_envs."""
    E = min(g.max_envs, -(-B // sms))
    return -(-E // g.env_align) * g.env_align


def _board_words(g, o):
    """fn_env.cu:reset_board_word at byte offsets o (an array): uint8[len(o), 16]."""
    o = np.asarray(o, np.int64)
    r0 = o // g.PW
    play = np.zeros(o.shape, np.int64)
    for k in range(g.word_rows):
        r = r0 + k
        at = r * g.PW + g.PAD - o
        lo, hi = np.maximum(at, 0), np.minimum(at + g.WIDTH, 16)
        ok = (r % g.H < g.HEIGHT) & (lo < hi)
        bits = (0xFFFF >> (16 - np.where(ok, hi, 16))) & ~((1 << np.where(ok, lo, 0)) - 1)
        play |= np.where(ok, bits, 0)
    rock = ~play & 0xFFFF
    return ((rock[:, None] >> np.arange(16)) & 1).astype(np.uint8)


def _reset_cell(g, c):
    r, w = c // g.PW, c % g.PW
    return 1 if (r >= g.HEIGHT or w < g.PAD or w >= g.PAD + g.WIDTH) else 0


def _piece_word(g, w):
    """fn_env.cu:piece_word at byte 16 w (an array of word indices from an env boundary)."""
    out = np.zeros(np.shape(w), bool)
    if not g.has_win:
        return out
    start = 16 * np.asarray(w, np.int64)
    for extra in range(16 // g.OBS + 2):
        k = start // g.OBS + extra
        inside = k * g.OBS < start + 16
        out |= inside & (k * g.OBS + g.win_hi > start) & (k * g.OBS + g.win_lo < start + 16)
    return out


def _window_rows(g, mask):
    """fn_env.cu:window_rows: byte r is the piece's row r from column kWinC0."""
    return sum(((g.act_row(mask, r) >> g.win_c0) & 0xFF) << (8 * r) for r in range(g.win_rows))


def _piece_bits(g, start, e, rows):
    """fn_env.cu:piece_bits: bit i is byte start + i a cell of its env's
    piece, from the window rows of envs e .. e + span_envs - 1."""
    bits = 0
    for k in range(e, min(e + g.span_envs, len(rows))):
        base = k * g.OBS + g.win_c0 - start
        for r in range(g.win_rows):
            at, row = base + r * g.WIDTH, (rows[k] >> (8 * r)) & 0xFF
            if -8 < at < 16:
                bits |= row << at if at >= 0 else row >> -at
    return bits & 0xFFFF


def _ranks(sk):
    """The stable ranks of sort keys ``sk[..., QS]``: the count of j with (sk[j], j) < (sk[i], i)."""
    n = sk.shape[-1]
    j_lt_i = np.arange(n)[None, :] < np.arange(n)[:, None]  # [i, j]
    a, b = sk[..., None, :], sk[..., :, None]  # sk[j], sk[i]
    return ((a < b) | ((a == b) & j_lt_i)).sum(-1)


def _chain(g, keys, uniform):
    """(keys_out, rng_key, queue) of the envs' chains: the key split once,
    the bag's sort keys placed by their ranks, or the uniform draws."""
    k0, k1 = keys[:, 0], keys[:, 1]
    first, second = _block(k0, k1, 0, 0), _block(k0, k1, 0, 1)
    B, QS = len(keys), g.QS
    i = np.arange(QS, dtype=np.uint32)[None, :]
    if uniform:
        span = np.uint32(max(QS - 1, 1))
        mult = np.uint32(((65536 % int(span)) ** 2) % int(span))
        khi, klo = _block(*first, 0, 0), _block(*first, 0, 1)
        hi = _bits((khi[0][:, None], khi[1][:, None]), i)
        lo = _bits((klo[0][:, None], klo[1][:, None]), i)
        with np.errstate(over="ignore"):
            queue = (((hi % span) * mult + lo % span) % span).astype(np.int32)
    elif QS == 1:
        queue = np.zeros((B, 1), np.int32)
    else:
        sub = _block(*first, 0, 1)
        sk = _bits((sub[0][:, None], sub[1][:, None]), i)
        rank = _ranks(sk)
        queue = np.zeros((B, QS), np.int32)
        np.put_along_axis(queue, rank, np.arange(QS, dtype=np.int32)[None, :].repeat(B, 0), axis=1)
        # the piece: the entry whose rank is 0
        assert np.array_equal(np.argmax(rank == 0, axis=1), queue[:, 0])
    return np.stack(first, -1), np.stack(second, -1), queue


def _reset_model(g, keys, uniform, sms=H100_SMS):
    """Every output of fn_reset's launch, with a count of the writes of each
    byte of the board and the observation."""
    B = len(keys)
    E, EW = _reset_envs(g, B, sms), 32
    assert E % g.env_align == 0 and E <= RESET_THREADS
    board = np.zeros(B * g.CELLS, np.int8)
    obs = np.zeros(B * g.OBS, np.int8)
    bcount, ocount = np.zeros(B * g.CELLS, np.int64), np.zeros(B * g.OBS, np.int64)
    keys_out, rng_key, queue = _chain(g, keys, uniform)
    piece = queue[:, 0]
    rows = [_window_rows(g, g.masks[p * 4]) for p in piece]
    for base in range(0, B, E):
        n = min(E, B - base)
        env_warps = -(-n // EW)
        assert env_warps <= RESET_WARPS - 4
        S = RESET_THREADS - 32 * env_warps
        # the streams: board words (thread si of the SB that take them), the
        # ragged end byte by byte, the observation's zero words
        bwords = n * g.CELLS // 16
        SB = S // g.period * g.period if S >= g.period else S
        i = np.arange(bwords)
        si = i % SB
        fixed = SB % g.period == 0
        o = (16 * (si if fixed else i)) % g.CELLS  # a fixed thread stores its first word throughout
        b0 = base * g.CELLS
        at = b0 + 16 * i[:, None] + np.arange(16)
        board[at] = _board_words(g, o)
        np.add.at(bcount, at.ravel(), 1)
        for c in range(16 * bwords, n * g.CELLS):
            board[b0 + c] = _reset_cell(g, c % g.CELLS)
            bcount[b0 + c] += 1
        owords = n * g.OBS // 16
        w = np.arange(owords)
        zero = w[~_piece_word(g, w)]
        np.add.at(ocount, (base * g.OBS + 16 * zero[:, None] + np.arange(16)).ravel(), 1)
        # the env warps: the words their pieces touch, and the ragged end
        for warp in range(env_warps):
            e0 = base + EW * warp
            m = min(EW, n - EW * warp)
            wm = rows[e0:e0 + m]
            full = m * g.OBS // 16
            for j in range(m * g.win_words):
                e = j // g.win_words
                wd = (e * g.OBS + g.win_lo) // 16 + j % g.win_words
                if wd > (e * g.OBS + g.win_hi - 1) // 16 or wd >= full:
                    continue
                if e > 0 and wd <= ((e - 1) * g.OBS + g.win_hi - 1) // 16:
                    continue
                bits = _piece_bits(g, 16 * wd, e, wm)
                at = e0 * g.OBS + 16 * wd + np.arange(16)
                obs[at] = -((bits >> np.arange(16)) & 1)
                ocount[at] += 1
            for gb in range(16 * full, m * g.OBS):
                e, c = gb // g.OBS, gb % g.OBS
                r, col = c // g.WIDTH, c % g.WIDTH - g.win_c0
                on = r < g.win_rows and 0 <= col < 8 and (wm[e] >> (8 * r + col)) & 1
                obs[e0 * g.OBS + gb] = -1 if on else 0
                ocount[e0 * g.OBS + gb] += 1
    return {"keys": keys_out, "rng_key": rng_key, "queue": queue, "piece": piece,
            "board": board.reshape(B, g.H, g.PW), "obs": obs.reshape(B, g.HEIGHT, g.WIDTH),
            "bcount": bcount, "ocount": ocount, "E": E}


def _fn_keys(seed, B):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("name,kw,kind", FN_GEOMETRIES + ODD_GEOMETRIES)
def test_reset_model_matches_plain_and_jax(name, kw, kind):
    """The launch map at B = 1, 2, 3, 17 and 1001: every byte of the board
    and the observation written once, every output equal to reset_plain's
    and JAX's."""
    import jax

    from tetris_gymnasium_tpu import config as jconfig
    from tetris_gymnasium_tpu.core import fn_env as jfn
    from tetris_gymnasium_tpu.ops import queue as jqueue

    cfg = EnvConfig(**kw)
    g = _Geo(cfg)
    jq = jqueue.BAG_QUEUE if kind == "bag" else jqueue.UNIFORM_QUEUE
    jreset = jax.jit(jax.vmap(lambda k: jfn.reset(k, jconfig.EnvConfig(**kw), queue_fns=jq)))
    for B in RESET_B:
        keys = _fn_keys(B, B)
        pk, ps, po = fn_env.reset_plain(torch.from_numpy(keys), cfg, PIECES,
                                        BAG_QUEUE if kind == "bag" else UNIFORM_QUEUE)
        jk, js, jo = jreset(keys)
        got = _reset_model(g, keys, kind == "uniform")
        what = f"{name} B={B}"
        assert (got["bcount"] == 1).all() and (got["ocount"] == 1).all(), what
        for mine, plain, jax_v, field in (
                (got["keys"], pk, jk, "keys"), (got["rng_key"], ps.rng_key, js.rng_key, "rng_key"),
                (got["board"], ps.board, js.board, "board"), (got["queue"], ps.queue, js.queue, "queue"),
                (got["piece"], ps.piece, js.piece, "piece"), (got["obs"], po, jo, "obs")):
            np.testing.assert_array_equal(mine, plain.numpy(), err_msg=f"{what} {field}")
            np.testing.assert_array_equal(mine, np.asarray(jax_v), err_msg=f"{what} {field} (JAX)")
        assert (ps.x.numpy() == g.spawn_x).all() and (ps.queue_index.numpy() == 1).all(), what
        assert not ps.game_over.numpy().any() and (ps.score.numpy() == 0).all() and (ps.y.numpy() == 0).all()


def test_ranks_keep_ties_in_the_stable_order():
    """Sort keys with equal values: the ranks place entry i where JAX's
    stable ``sort_key_val`` of iota puts it, and where a stable argsort does."""
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(5)
    for QS in (2, 5, 7, 8, 16, 32):
        sk = rng.integers(0, 3, (500, QS)).astype(np.uint32)
        sk[0] = 7
        sk[1] = np.arange(QS)[::-1]
        rank = _ranks(sk)
        queue = np.zeros_like(rank)
        np.put_along_axis(queue, rank, np.arange(QS)[None, :].repeat(len(sk), 0), axis=1)
        np.testing.assert_array_equal(queue, np.argsort(sk, axis=1, kind="stable"))
        want = np.stack([np.asarray(lax.sort_key_val(jnp.asarray(row), jnp.arange(QS))[1]) for row in sk[:60]])
        np.testing.assert_array_equal(queue[:60], want)


@pytest.mark.parametrize("name,kw,kind", FN_GEOMETRIES)
def test_reset_envs_a_block_rule(name, kw, kind):
    """Whole 16-byte words of both tensors a block, one short chain at B = 1,
    every SM a block at 8192 but four, 128 envs a block at 65536 (64 at
    30x20), at most four warps of envs a block."""
    g = _Geo(EnvConfig(**kw))
    for B in (1, 2, 17, 1001, 4096, 8192, 65536):
        E = _reset_envs(g, B)
        assert (E * g.OBS) % 16 == 0 and (E * g.CELLS) % 16 == 0
        assert -(-E // 32) <= RESET_WARPS - 4
    assert _reset_envs(g, 1) == g.env_align
    assert -(-8192 // _reset_envs(g, 8192)) >= H100_SMS - 4
    assert _reset_envs(g, 65536) == g.max_envs == (64 if name == "30x20" else 128)
    assert g.period * 16 % g.CELLS == 0 and g.spawn_x == ob.spawn_xy_fn(EnvConfig(**kw))[0]


def test_board_words_are_the_board():
    """reset_board_word at every offset of a period equals create_board's bytes, at each geometry."""
    for _, kw, _ in FN_GEOMETRIES + (("6x5-pad1", dict(width=6, height=5, padding=1), "bag"),):
        cfg = EnvConfig(**kw)
        g = _Geo(cfg)
        stream = np.tile(fn_env.reset_plain(torch.zeros((1, 2), dtype=torch.uint32), cfg)[1].board.numpy().ravel(),
                         g.board_align + 2)
        o = np.arange(g.period) * 16 % g.CELLS
        words = _board_words(g, o)
        np.testing.assert_array_equal(words, stream[(o[:, None] + np.arange(16))].astype(np.uint8))


def test_wrappers_refuse_cpu_tensors():
    """The kernels take CUDA tensors only; the plain twins take the CPU's."""
    with pytest.raises(ValueError):
        kernels.dqn_act(torch.zeros((4, 8)))
    with pytest.raises(ValueError):
        kernels.fn_reset(torch.zeros((4, 2), dtype=torch.uint32), EnvConfig(), PIECES)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("A", ACTIONS)
def test_dqn_act_matches_plain_on_the_card(cuda, A):
    """Each build (A = 8 or any A; keys or greedy) against act_plain at the
    paths' batches and small ones, offsets 0, B and 3B, with its draws; A =
    8 also from a q that does not start on 16 bytes (the 4-byte loads)."""
    for B in (1, 37, 512, 1024, 4097):
        q = torch.from_numpy(_q_rows(B, A, B + A)).to(cuda)
        np.testing.assert_array_equal(kernels.dqn_act(q).cpu().numpy(), dqn.act_plain(q.cpu()).numpy())
        for trial, (epsilon, off) in enumerate(((0.0, 0), (1.0, B), (0.4, 3 * B), (0.4, 0))):
            act_key, eps_key = threefry.split(threefry.fold_in(threefry.prng_key(A + 1), 10 * B + trial))
            a, ra, u = kernels.dqn_act(q, act_key, eps_key, epsilon, return_draws=True, env_offset=off)
            want, wr, wu = _act_model(q.cpu().numpy(), act_key, eps_key, epsilon, off, _sms(cuda))
            np.testing.assert_array_equal(
                a.cpu().numpy(), dqn.act_plain(q.cpu(), act_key, eps_key, epsilon, env_offset=off).numpy())
            np.testing.assert_array_equal(a.cpu().numpy(), want)
            np.testing.assert_array_equal(ra.cpu().numpy(), wr)
            np.testing.assert_array_equal(u.cpu().numpy(), wu)
        if A == 8:
            flat = torch.empty(B * 8 + 1, device=cuda)
            qm = flat[1:].view(B, 8)
            qm.copy_(q)
            assert qm.data_ptr() % 16
            np.testing.assert_array_equal(kernels.dqn_act(qm, act_key, eps_key, 0.4).cpu().numpy(),
                                          dqn.act_plain(q.cpu(), act_key, eps_key, 0.4).numpy())


@pytest.mark.cuda
def test_dqn_act_makes_no_host_draw(cuda, monkeypatch):
    """kernels.dqn_act calls nothing of the host threefry module: every
    function there raises while it runs."""
    q = torch.randn((1024, 8), device=cuda)
    act_key, eps_key = threefry.split(threefry.prng_key(4))
    want = dqn.act_plain(q.cpu(), act_key, eps_key, 0.5).numpy()

    def refuse(*a, **k):
        raise AssertionError("a host threefry call")

    for name in dir(threefry):
        if callable(getattr(threefry, name)) and not name.startswith("__") \
                and getattr(getattr(threefry, name), "__module__", "") == threefry.__name__:
            monkeypatch.setattr(threefry, name, refuse)
    got = kernels.dqn_act(q, act_key, eps_key, 0.5)
    got5 = kernels.dqn_act(q[:, :5].contiguous(), act_key, eps_key, 0.5)
    monkeypatch.undo()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(got5.cpu().numpy(),
                                  dqn.act_plain(q[:, :5].contiguous().cpu(), act_key, eps_key, 0.5).numpy())


@pytest.mark.cuda
def test_dqn_act_shape_matches_model(cuda):
    for B in (1, 512, 1024, 4096, 65536):
        shape = kernels.dqn_act_shape(B, 8)
        assert shape["threads_per_block"] == _threads_for(B, _sms(cuda))
        assert shape["blocks"] == -(-B // shape["threads_per_block"]) and shape["build_actions"] == 8
    assert kernels.dqn_act_shape(64, 5)["build_actions"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,kind", FN_GEOMETRIES + ODD_GEOMETRIES)
def test_fn_reset_matches_plain_on_the_card(cuda, name, kw, kind):
    """fn_reset against reset_plain in every field and the observation, at
    B = 1, 2, 3, 17, 1001 and 4096, and the launcher's shape against the
    model."""
    cfg = EnvConfig(**kw)
    g = _Geo(cfg)
    qf = BAG_QUEUE if kind == "bag" else UNIFORM_QUEUE
    for B in RESET_B + (4096,):
        keys = torch.from_numpy(_fn_keys(B + 1, B))
        pk, ps, po = fn_env.reset_plain(keys, cfg, PIECES, qf)
        kk, ks, ko = kernels.fn_reset(keys.to(cuda), cfg, PIECES, kind)
        what = f"{name} B={B}"
        np.testing.assert_array_equal(kk.cpu().numpy(), pk.numpy(), err_msg=what)
        np.testing.assert_array_equal(ko.cpu().numpy(), po.numpy(), err_msg=what)
        for k in fn_env.FIELDS:
            np.testing.assert_array_equal(getattr(ks, k).cpu().numpy(), getattr(ps, k).numpy(),
                                          err_msg=f"{what} {k}")
        shape = kernels.fn_reset_shape(cfg, PIECES, B)
        assert shape["envs_per_block"] == _reset_envs(g, B, _sms(cuda)) and shape["env_align"] == g.env_align
        assert shape["blocks"] == -(-B // shape["envs_per_block"]) and shape["threads_per_block"] == RESET_THREADS
