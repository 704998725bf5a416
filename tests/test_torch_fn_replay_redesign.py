"""The redesigned ``fn_step`` (a group of lanes an env) and
``replay_sample_stacked`` (a sample a warp, its distinct frames staged).

On the CPU:

* ``fn_step``'s lane program (``csrc/fn_env.cu``): a numpy model in which
  the group's 8 lanes are a loop, ``__any_sync``, ballots and the group's
  OR are numpy reductions over the lanes, over the 64-bit piece masks that
  ``kernels._fn_masks`` builds and the ids of ``kernels._ids_for``: the
  occupancy as one bit row a padded row, a window test as S row tests at
  the clamped start, the drop as rounds of 8 window starts with the least
  colliding start taken, the lock's stamp a lane a row, the full rows by
  an OR over the lanes, each kept row moved down by the count of full rows
  below it a lane a column, the key and queue on the first lane.  It must
  equal ``fn_env.step_plain`` and JAX's ``core/fn_env.py:step`` bit for
  bit on 40-step seeded trajectories at the five geometries of
  ``chip_smoke.py``'s phase 41, on hand-built stacks with clears of several
  rows and refills, and at 8x12 with padding 2, where the window clamps
  bind;
* ``replay_sample_stacked``'s staging map (``csrc/replay.cu``): the <= K +
  1 entries a sample stages, from the K done flags of one ballot, and each
  of the 2K output frames' slot among them, against
  ``buffers.stacked_sample_rows`` and JAX's ``rl/buffers.py:
  sample_with_next_stacked`` (the obs store holds each entry's index), at a
  ring wrap, with ``done`` at every lookback depth, at K = 1, 2 and 4 and n
  not a multiple of the words build's 4 samples a block;
* the wrappers' build choices (``fn_step_build``, ``replay_stacked_build``)
  and the limits they name.

On a card (marked ``cuda``; they skip without one, decided inside the
test): both builds of each kernel against their plain twins.  This file
imports JAX only inside its CPU tests, so ``python -m pytest --noconftest
tests/test_torch_fn_replay_redesign.py -m cuda`` runs on the card's machine.

Every result is an integer, a byte or a float32 sum formed in the same
order: equal.
"""
import functools

import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.config import EnvConfig
from tetris_gymnasium_torch.core import fn_env
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.ops.queue import BAG_QUEUE, UNIFORM_QUEUE
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES
from tetris_gymnasium_torch.rl import buffers

CPU = "cpu"
LANES = 8  # csrc/fn_env.cu:kLanes
WORDS_SAMPLES = 4  # csrc/replay.cu:kWarpsWords
GEOMETRIES = {  # chip_smoke.py:fn_geometries
    "10x20": (dict(), "bag"),
    "10x20-nograv": (dict(gravity_enabled=False), "bag"),
    "uniform5": (dict(queue_size=5), "uniform"),
    "30x20": (dict(width=30), "bag"),
    "8x12-pad2": (dict(width=8, height=12, padding=2), "bag"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# fn_step's lane program, in numpy
# ---------------------------------------------------------------------------


class _Geometry:
    def __init__(self, cfg: EnvConfig, kind: str):
        self.cfg, self.kind = cfg, kind
        self.height, self.width, self.pad = cfg.height, cfg.width, cfg.padding
        self.H, self.PW = cfg.padded_height, cfg.padded_width
        self.QS = cfg.queue_size
        masks = kernels._fn_masks(PIECES, CPU).numpy().view(np.uint64)
        self.masks = [int(m) for m in masks]
        self.NP = len(self.masks) // 4
        self.S = int(np.asarray(PIECES.matrices).shape[-1])
        self.ids = [int(i) for i in kernels._ids_for(PIECES, CPU).numpy()]
        self.spawn_x = self.PW // 2 - 2
        self.width_mask = (1 << self.width) - 1

    def piece_mask(self, p, r):
        return 0 if p < 0 or p >= self.NP or r < 0 or r > 3 else self.masks[p * 4 + r]

    def piece_row(self, m, s):
        return (m >> (s * self.S)) & ((1 << self.S) - 1)

    @staticmethod
    def clamp(v, limit, dim):
        if v < 0:
            v += dim
        return min(max(v, 0), limit)


def _row_bits(b, r, g):
    return sum(1 << c for c in range(g.PW) if b[r * g.PW + c] > 0)


M32 = 0xFFFFFFFF


def _positive_bits4(w):
    """``positive_bits4``: bit k is byte k of the 32-bit word w, an int8, > 0."""
    nonzero = ((((w & 0x7F7F7F7F) + 0x7F7F7F7F) & M32) | w) & 0x80808080
    return ((((nonzero & ~w & M32) >> 7) * 0x10204080) & M32) >> 28


def _spread4(n):
    return ((n * 0x00204081) & M32) & 0x01010101


def _build_occ(g, b):
    """``build_occ``: 4-byte words of the board packed 8 to a flat word
    (lane l: flat words l, l + 8, ..), each bit row cut from the flat words."""
    cells = g.H * g.PW
    if cells % 4:
        return [_row_bits(b, r, g) for r in range(g.H)]
    raw = np.zeros(32 * ((cells + 31) // 32) + 64, dtype=np.uint8)
    raw[:cells] = (b.astype(np.int64) % 256).astype(np.uint8)
    raw[cells:] = np.random.default_rng(cells).integers(1, 128, raw.size - cells)  # another board's bytes
    words = raw.view("<u4")
    n_flat = (cells + 31) // 32
    flat = [0] * (n_flat + 2)
    for lane in range(LANES):
        for j in range(lane, n_flat, LANES):
            v = sum(_positive_bits4(int(words[8 * j + k])) << (4 * k) for k in range(8))
            valid = cells - 32 * j
            flat[j] = v if valid >= 32 else v & ((1 << valid) - 1)
    flat[n_flat:] = [0xDEADBEEF, 0x12345678]  # read past the end and masked off
    occ = []
    for r in range(g.H):
        bit = r * g.PW
        w0, sh = bit >> 5, bit & 31
        v = ((flat[w0 + 1] << 32 | flat[w0]) >> sh) & ((1 << 64) - 1)
        if sh + g.PW > 64:
            v |= (flat[w0 + 2] << (64 - sh)) & ((1 << 64) - 1)
        occ.append(v & ((1 << g.PW) - 1))
    return occ


def _group_obs(g, occ, m, xc, yc):
    """``group_obs_maps`` then ``write_obs_maps``: the occupied and active
    bit maps of the observation's cells, a 32-cell word a lane, each from
    the rows it spans; then the bytes, occupied minus active, 4 a word from
    the maps' nibbles (a byte at a time where the observation is not whole
    words)."""
    n_obs = g.height * g.width
    n_words = (n_obs + 31) // 32

    def obs_row(r):
        return (occ[r] >> g.pad) & g.width_mask

    def act_row(r):
        ar = r - yc
        return ((g.piece_row(m, ar) << xc) >> g.pad) & g.width_mask if 0 <= ar < g.S else 0

    occupied, active = [0] * n_words, [0] * n_words
    for k in range(n_words):  # lane l: words l, l + 8, ..
        r, c = divmod(32 * k, g.width)
        got = 0
        while got < 32 and r < g.height:
            n = min(32 - got, g.width - c)
            occupied[k] |= ((obs_row(r) >> c) & ((1 << n) - 1)) << got
            active[k] |= ((act_row(r) >> c) & ((1 << n) - 1)) << got
            got, r, c = got + n, r + 1, 0
    out = np.zeros(n_obs, dtype=np.int8)
    if n_obs % 4 == 0:
        for w in range(n_obs // 4):  # the block's threads, a word each
            i = 4 * w
            o = _spread4((occupied[i >> 5] >> (i & 31)) & 0xF)
            a = _spread4((active[i >> 5] >> (i & 31)) & 0xF)
            word = (o & ~a & M32) | (((a & ~o & M32) * 0xFF) & M32)
            out[i : i + 4] = np.frombuffer(np.uint32(word).tobytes(), dtype=np.int8)
    else:
        for i in range(n_obs):
            out[i] = ((occupied[i >> 5] >> (i & 31)) & 1) - ((active[i >> 5] >> (i & 31)) & 1)
    return out.reshape(g.height, g.width)


def _group_hits(g, occ, m, xc, yc):
    votes = [lane < g.S and ((occ[yc + lane] >> xc) & g.piece_row(m, lane)) != 0 for lane in range(LANES)]
    return bool(np.any(votes))  # __any_sync


def _group_collides(g, occ, m, x, y):
    return _group_hits(g, occ, m, g.clamp(x, g.PW - g.S, g.PW), g.clamp(y, g.H - g.S, g.H))


def _group_drop(g, occ, m, x, y):
    xc = g.clamp(x, g.PW - g.S, g.PW)
    r0 = min(max(y + 1, 0), g.H - g.S)
    for first in range(r0, g.H - g.S + 1, LANES):
        ballot = np.array([first + lane <= g.H - g.S
                           and any(((occ[first + lane + s] >> xc) & g.piece_row(m, s)) != 0 for s in range(g.S))
                           for lane in range(LANES)])
        if ballot.any():
            least = first + int(np.argmax(ballot))  # __ffs of the ballot
            if least == r0:
                return 0
            d = least - (y + 1)
            return d if d < g.H else g.H
    return g.H


def _group_lock(g, b, occ, m, x, y, id_):
    xc, yc = g.clamp(x, g.PW - g.S, g.PW), g.clamp(y, g.H - g.S, g.H)
    for lane in range(min(g.S, LANES)):  # a lane a window row
        row = (yc + lane) * g.PW + xc
        for j in range(g.S):
            if (g.piece_row(m, lane) >> j) & 1:
                b[row + j] = (b[row + j] + id_ + 128) % 256 - 128  # int8 wraps
        occ[yc + lane] = _row_bits(b, yc + lane, g)
    mine = [sum(1 << r for r in range(lane, g.height, LANES)
                if ((occ[r] >> g.pad) & g.width_mask) == g.width_mask) for lane in range(LANES)]
    full = functools.reduce(lambda u, v: u | v, mine)  # the group's OR
    n = bin(full).count("1")
    if n > 0:
        for lane in range(LANES):
            for c in range(g.pad + lane, g.pad + g.width, LANES):  # a lane a column, bottom up
                top, k = b[c], 0
                for r in range(g.height - 1, -1, -1):
                    if (full >> r) & 1:
                        k += 1
                    elif k > 0:
                        b[(r + k) * g.PW + c] = b[r * g.PW + c]
                for r in range(1, n):
                    b[r * g.PW + c] = top
    for r in range(g.height):
        for c in range(g.pad):
            b[r * g.PW + c] = b[r * g.PW + g.pad + g.width + c] = 1
    b[g.height * g.PW:] = 1
    return n


def _fresh_queue(g, k0, k1):
    key = np.array([k0, k1], dtype=np.uint32)
    if g.kind == "uniform":
        return [int(v) for v in threefry.randint(key, g.QS, g.QS - 1)]
    return [int(v) for v in threefry.permutation(key, g.QS)]


def _model_env(g, st, e, a):
    """One env's step of the lane program: ``(fields, obs, reward, terminated, lines)``."""
    b = st["board"][e].reshape(-1).astype(np.int64)
    piece, rot, x, y = (int(st[k][e]) for k in ("piece", "rotation", "x", "y"))
    qi, over_in = int(st["queue_index"][e]), bool(st["game_over"][e])
    score = np.float32(st["score"][e])
    k0, k1 = (int(v) for v in st["rng_key"][e])
    queue = [int(v) for v in st["queue"][e]]
    cur, n, over, new_score = piece, 0, over_in, score
    occ = _build_occ(g, b)
    if not over_in:
        m = g.piece_mask(piece, rot)
        dx = -1 if a == 0 else 1 if a == 1 else 0
        if dx != 0 and not _group_collides(g, occ, m, x + dx, y):
            x += dx
        y_new, move = y, 0
        if a == 2:
            if not _group_collides(g, occ, m, x, y + 1):
                y_new, move = y + 1, 1
        elif a == 6:
            d = _group_drop(g, occ, m, x, y)
            y_new, move = y + d, 2 * d
        rd = -1 if a == 3 else 1 if a == 4 else 0
        if rd != 0:
            rc = ((rot + rd) % 4 + 4) % 4
            if not _group_collides(g, occ, g.piece_mask(piece, rc), x, y_new):
                rot = rc
        m = g.piece_mask(piece, rot)
        y_g, lock = y_new, a == 6
        if g.cfg.gravity_enabled:
            if _group_collides(g, occ, m, x, y_new + 1):
                lock = True
            else:
                y_g = y_new + 1
        lock_reward = 0
        if lock:
            at_id = min(max(piece + g.NP if piece < 0 else piece, 0), g.NP - 1)
            n = _group_lock(g, b, occ, m, x, y_g, g.ids[at_id])
            occ = _build_occ(g, b)
            lock_reward = {0: 0, 1: 100, 2: 300, 3: 500, 4: 800}.get(n, n * 200 - 100)
            nxt, sub = threefry.split(np.array([k0, k1], dtype=np.uint32))  # the first lane
            if qi >= g.QS:
                queue = _fresh_queue(g, *sub)
                cur, qi = queue[0], 1
            else:
                cur, qi = queue[min(max(qi + g.QS if qi < 0 else qi, 0), g.QS - 1)], qi + 1
            k0, k1 = int(nxt[0]), int(nxt[1])
            rot, x, y = 0, g.spawn_x, 0
            sm, xc = g.piece_mask(cur, 0), g.clamp(g.spawn_x, g.PW - g.S, g.PW)
            over = any(b[s * g.PW + xc + j] > 0 for s in range(min(g.S, LANES)) for j in range(g.S)
                       if (g.piece_row(sm, s) >> j) & 1)
        else:
            y, over = y_g, False
        new_score = (score + np.float32(move)) + np.float32(lock_reward)
    fields = dict(rng_key=[k0, k1], board=b.reshape(g.H, g.PW), piece=cur, rotation=rot, x=x, y=y,
                  queue=queue, queue_index=qi, game_over=over, score=new_score)
    obs = _group_obs(g, occ, 0 if over else g.piece_mask(cur, rot), g.clamp(x, g.PW - g.S, g.PW),
                     g.clamp(y, g.H - g.S, g.H))
    return fields, obs, np.float32(new_score - score), over, n


def _model_step(g, st, actions):
    """The lane program over a batch of numpy fields: numpy outputs as ``step_plain`` gives them."""
    rows = [_model_env(g, st, e, int(a)) for e, a in enumerate(actions)]
    dtypes = {"rng_key": np.uint32, "board": np.int8, "game_over": np.bool_, "score": np.float32}
    new = {k: np.array([r[0][k] for r in rows], dtype=dtypes.get(k, np.int32)) for k in fn_env.FIELDS}
    obs = np.array([r[1] for r in rows], dtype=np.int8)
    reward = np.array([r[2] for r in rows], dtype=np.float32)
    return new, obs, reward, np.array([r[3] for r in rows]), np.array([r[4] for r in rows], dtype=np.int32)


def _assert_outputs(model, got, what):
    new, obs, reward, term, lines = model
    st = fn_env.state_to_numpy(got[0]) if not isinstance(got[0], dict) else got[0]
    for k in fn_env.FIELDS:
        np.testing.assert_array_equal(new[k], np.asarray(st[k]), err_msg=f"{what} {k}")
    for m, o, name in zip((obs, reward, term, lines), got[1:], ("obs", "reward", "terminated", "lines")):
        o = o.cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
        np.testing.assert_array_equal(m, o, err_msg=f"{what} {name}")


def _queue(kind):
    return BAG_QUEUE if kind == "bag" else UNIFORM_QUEUE


def _stacks(cfg, kind, n, seed):
    """Hand-built states (``chip_smoke.py:_fn_stacks``'s recipe), each taking
    the 8 actions 0-7: 1-4 full rows at the bottom and full rows higher up
    too (a clear of several rows that are not adjacent), random cells below
    the top half, a row 0 that is not full, a random piece at a random
    position (the clamps included), half the queues at their refill, a fifth
    of the games over."""
    rng = np.random.default_rng(seed)
    _, s, _ = fn_env.reset_plain(batch_keys(prng_key(seed), n, device=CPU), cfg, queue_fns=_queue(kind))
    st = fn_env.state_to_numpy(s)
    H, W, pad, qs = cfg.height, cfg.width, cfg.padding, cfg.queue_size
    inner = np.where(rng.random((n, H, W)) < 0.5, 5, 0).astype(np.int8)
    inner[:, 1 : H // 2] = 0
    inner[:, 0, 0], inner[:, 0, 1] = 6, 0
    n_full = rng.integers(1, 5, n)
    inner[np.arange(H)[None, :] >= H - n_full[:, None]] = 3
    inner[rng.random(n) < 0.3, H // 2 + 1] = 2  # a full row above a kept one
    st["board"][:, :H, pad : pad + W] = inner
    st.update(piece=rng.integers(0, qs, n), rotation=rng.integers(0, 4, n),
              x=rng.integers(-3, cfg.padded_width, n), y=rng.integers(-2, cfg.padded_height, n),
              queue_index=np.where(rng.random(n) < 0.5, qs, rng.integers(0, qs, n)),
              game_over=rng.random(n) < 0.2)
    st = {k: np.repeat(v, 8, axis=0) for k, v in st.items()}
    return st, np.arange(8 * n, dtype=np.int32) % 8


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    import jax

    from tetris_gymnasium_tpu import config as jconfig
    from tetris_gymnasium_tpu.core import fn_env as jfn
    from tetris_gymnasium_tpu.ops import queue as jqueue

    kw, kind = GEOMETRIES[name]
    jc = jconfig.EnvConfig(**kw)
    jq = jqueue.BAG_QUEUE if kind == "bag" else jqueue.UNIFORM_QUEUE
    return jax.jit(jax.vmap(lambda s, a: jfn.step(s, a, jc, queue_fns=jq)))


def _jax_outputs(name, st, actions):
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.core import fn_env as jfn

    js = jfn.FnState(**{k: jnp.asarray(v) for k, v in st.items()})
    new, obs, reward, term, info = _jax_step(name)(js, jnp.asarray(actions))
    return ({k: np.asarray(getattr(new, k)) for k in fn_env.FIELDS}, np.asarray(obs), np.asarray(reward),
            np.asarray(term), np.asarray(info["lines_cleared"]))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_fn_step_lane_model_matches_plain_and_jax_on_trajectories(name):
    """40 steps of 24 envs from seeded keys and numpy actions 0-7."""
    kw, kind = GEOMETRIES[name]
    cfg = EnvConfig(**kw)
    g = _Geometry(cfg, kind)
    rng = np.random.default_rng(7)
    _, s, _ = fn_env.reset_plain(batch_keys(prng_key(16), 24, device=CPU), cfg, queue_fns=_queue(kind))
    locks = 0
    for t in range(40):
        st = fn_env.state_to_numpy(s)
        a = rng.integers(0, 8, 24).astype(np.int32)
        model = _model_step(g, st, a)
        plain = fn_env.step_plain(s, torch.from_numpy(a), cfg, queue_fns=_queue(kind))
        _assert_outputs(model, plain, f"{name} step {t} (plain)")
        if t % 8 == 0:
            _assert_outputs(model, _jax_outputs(name, st, a), f"{name} step {t} (JAX)")
        locks += int((model[0]["queue_index"] != st["queue_index"]).sum())
        s = plain[0]
    assert locks > 0


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_fn_step_lane_model_matches_plain_and_jax_on_stacks(name):
    """Hand-built stacks: multi-row clears, the row-0 copy, refills, frozen games, clamped windows."""
    kw, kind = GEOMETRIES[name]
    cfg = EnvConfig(**kw)
    g = _Geometry(cfg, kind)
    st, a = _stacks(cfg, kind, 40, 60)
    model = _model_step(g, st, a)
    s = fn_env.state_from_numpy(st, device=CPU)
    _assert_outputs(model, fn_env.step_plain(s, torch.from_numpy(a), cfg, queue_fns=_queue(kind)),
                    f"{name} stacks (plain)")
    _assert_outputs(model, _jax_outputs(name, st, a), f"{name} stacks (JAX)")
    live = ~st["game_over"]
    lines = model[4]
    assert (lines[live] >= 2).any() and (model[4][~live] == 0).all()
    refilled = live & (st["queue_index"] == cfg.queue_size) & (model[0]["queue_index"] == 1)
    assert refilled.any()


def test_fn_step_bit_tricks():
    """``positive_bits4`` over every byte value in every position and random
    words, ``spread4`` over every nibble, and the observation's byte rule
    (occupied minus active) over every pair of nibbles."""
    for k in range(4):
        for v in range(256):
            w = (v << (8 * k)) | (0x01 << (8 * ((k + 1) % 4)))  # a positive neighbour too
            want = (1 << k if 0 < v < 128 else 0) | (1 << ((k + 1) % 4))
            assert _positive_bits4(w) == want, (k, v)
    rng = np.random.default_rng(0)
    for w in rng.integers(0, 2**32, 2000, dtype=np.uint64):
        b = np.frombuffer(np.uint32(w).tobytes(), dtype=np.int8)
        assert _positive_bits4(int(w)) == sum(1 << k for k in range(4) if b[k] > 0)
    for n in range(16):
        assert _spread4(n) == sum(((n >> k) & 1) << (8 * k) for k in range(4))
    for o in range(16):
        for a in range(16):
            eo, ea = _spread4(o), _spread4(a)
            word = (eo & ~ea & M32) | (((ea & ~eo & M32) * 0xFF) & M32)
            got = np.frombuffer(np.uint32(word).tobytes(), dtype=np.int8)
            np.testing.assert_array_equal(got, [((o >> k) & 1) - ((a >> k) & 1) for k in range(4)])


def test_fn_step_window_clamps_bind_at_8x12_pad2():
    """At 8x12 with padding 2 a piece low enough (y + 1 > H - S) or far left
    (x < 0) is tested at a clamped start; the model's drop and window tests
    there equal the plain step's, and such states occur."""
    cfg = EnvConfig(width=8, height=12, padding=2)
    g = _Geometry(cfg, "bag")
    st, a = _stacks(cfg, "bag", 64, 61)
    clamped = (st["y"] + 1 > g.H - g.S) | (st["x"] < 0) | (st["x"] > g.PW - g.S)
    assert (clamped & ~st["game_over"]).sum() >= 20
    keep = clamped & ~st["game_over"]
    st = {k: v[keep] for k, v in st.items()}
    a = a[keep]
    model = _model_step(g, st, a)
    plain = fn_env.step_plain(fn_env.state_from_numpy(st, device=CPU), torch.from_numpy(a), cfg)
    _assert_outputs(model, plain, "8x12-pad2 clamped windows")


# ---------------------------------------------------------------------------
# replay_sample_stacked's staging map, in numpy
# ---------------------------------------------------------------------------


def _staging_map(done, a, batch, cap, k):
    """``(slots, cur, nxt)``: the entries the sample of entry ``a`` stages
    (slot 0 the successor, slot 1 + i entry a - i * batch), and each window's
    frames as slots, oldest first."""
    flags = np.array([done[(a - i * batch) % cap] for i in range(k)])  # one ballot
    cur_flags, nxt_flags = flags[1:k], flags[0 : k - 1]
    mc = int(np.argmax(cur_flags)) if cur_flags.any() else k - 1
    mn = int(np.argmax(nxt_flags)) if nxt_flags.any() else k - 1
    n_slots = 2 + max(mc, mn - 1)
    assert n_slots <= k + 1
    slots = [(a + batch) % cap] + [(a - i * batch) % cap for i in range(n_slots - 1)]
    cur = [1 + min(j, mc) for j in range(k)][::-1]
    nxt = [min(j, mn) for j in range(k)][::-1]
    return slots, cur, nxt, (mc, mn)


def _stacked_buffer(batch, blocks, k, seed, wraps=True, done_every=None):
    """A plain buffer of ``blocks * batch`` entries whose obs is each entry's
    index (so windows read as entries), its done flags seeded; filled past
    its capacity (a ring wrap) unless ``wraps`` is False."""
    cap = blocks * batch
    rng = np.random.default_rng(seed)
    buf = buffers.ReplayBuffer({"obs": torch.zeros((cap, 1), dtype=torch.int32),
                                "action": torch.zeros(cap, dtype=torch.int32),
                                "done": torch.zeros(cap, dtype=torch.bool)})
    steps = blocks + blocks // 2 if wraps else blocks - 1
    for t in range(steps):
        done = rng.random(batch) < 0.3 if done_every is None else (np.arange(batch) + t) % done_every == 0
        pos = buf.pos
        buf = buffers.add_plain(buf, {"obs": torch.arange(pos, pos + batch, dtype=torch.int32)[:, None],
                                      "action": torch.from_numpy(rng.integers(0, 7, batch).astype(np.int32)),
                                      "done": torch.from_numpy(done)})
    return buf


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("wraps", [True, False])
def test_staging_map_matches_stacked_sample_rows_and_jax(k, wraps):
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.rl import buffers as jbuffers

    batch, n = 6, 37  # n is not a multiple of the words build's 4 samples a block
    buf = _stacked_buffer(batch, 3 * k + 2, k, 100 + k, wraps)
    cap = buf.capacity
    done = buf.data["done"].numpy()
    key = prng_key(5 + k)
    anchors, windows, depth = buffers.stacked_sample_rows(buf, key, n, batch, k)
    anchors, windows, depth = anchors.numpy(), windows.numpy(), depth.numpy()
    jbuf = jbuffers.ReplayBuffer(data={name: jnp.asarray(v.numpy()) for name, v in buf.data.items()},
                                 pos=jnp.int32(buf.pos), size=jnp.int32(buf.size))
    jc, jn = jbuffers.sample_with_next_stacked(jbuf, jnp.asarray(key), n, batch, k)
    depths = set()
    for s in range(n):
        a = int(anchors[0, s])
        slots, cur, nxt, (mc, mn) = _staging_map(done, a, batch, cap, k)
        assert len(set(slots)) == len(slots) or cap <= (k + 1) * batch
        got_cur, got_nxt = [slots[i] for i in cur], [slots[i] for i in nxt]
        np.testing.assert_array_equal(got_cur, windows[0, s])
        np.testing.assert_array_equal(got_nxt, windows[1, s])
        np.testing.assert_array_equal(got_cur, np.asarray(jc["obs"])[s, :, 0])
        np.testing.assert_array_equal(got_nxt, np.asarray(jn["obs"])[s, :, 0])
        assert (mc, mn) == (depth[0, s], depth[1, s])
        assert slots[0] == anchors[1, s] and slots[1] == a
        assert np.asarray(jc["action"])[s] == buf.data["action"][a]
        assert np.asarray(jn["action"])[s] == buf.data["action"][slots[0]]
        depths.add(mc)
    if k > 1:
        assert depths == set(range(k)), f"lookback depths seen {sorted(depths)}"


@pytest.mark.parametrize("k", [1, 2, 4])
def test_staging_map_with_done_at_every_depth(k):
    """Done flags on a period of k + 1 blocks: every lookback depth 0 .. K - 1
    occurs for both windows, and the map stays within K + 1 slots."""
    batch = 4
    buf = _stacked_buffer(batch, 2 * k + 3, k, 7, done_every=k + 1)
    done = buf.data["done"].numpy()
    anchors, windows, depth = buffers.stacked_sample_rows(buf, prng_key(k), 64, batch, k)
    seen = set()
    for s in range(64):
        slots, cur, nxt, (mc, mn) = _staging_map(done, int(anchors[0, s]), batch, buf.capacity, k)
        np.testing.assert_array_equal([slots[i] for i in cur], windows[0, s].numpy())
        np.testing.assert_array_equal([slots[i] for i in nxt], windows[1, s].numpy())
        assert len(slots) <= k + 1
        seen |= {(0, mc), (1, mn)}
    assert seen == {(h, m) for h in (0, 1) for m in range(k)}


# ---------------------------------------------------------------------------
# The wrappers' build choices
# ---------------------------------------------------------------------------


def test_build_choices_follow_the_geometry():
    aligned = torch.zeros(64, dtype=torch.int8)
    odd = aligned[1:]
    assert kernels.fn_step_build(EnvConfig(), aligned, aligned) == "bulk"  # 24 x 18 = 432 bytes
    assert kernels.fn_step_build(EnvConfig(width=30), aligned, aligned) == "bulk"  # 24 x 38 = 912
    assert kernels.fn_step_build(EnvConfig(width=8, height=12, padding=2), aligned, aligned) == "words"  # 168
    assert kernels.fn_step_build(EnvConfig(), aligned, odd) == "words"
    assert kernels.replay_stacked_build(7056, 4, aligned, aligned, aligned) == "bulk"  # 84 x 84 frames
    assert kernels.replay_stacked_build(200, 4, aligned, aligned, aligned) == "words"  # the board DQN's
    assert kernels.replay_stacked_build(7056, 4, aligned, odd, aligned) == "words"
    assert kernels.replay_stacked_build(7056, 16, aligned, aligned, aligned) == "bulk"  # 17 frames, 117 KB
    assert kernels.replay_stacked_build(13056, 16, aligned, aligned, aligned) == "words"  # 17 frames > 200 KB
    assert kernels.FN_STEP_BUILDS == ("bulk", "words") == kernels.REPLAY_STACKED_BUILDS


def test_fn_defines_names_the_bit_row_limit():
    with pytest.raises(NotImplementedError, match="at most 64 rows and columns"):
        kernels.fn_defines(EnvConfig(width=60, height=10, padding=4), PIECES)  # 68 columns
    with pytest.raises(NotImplementedError, match="at most 64 rows and columns"):
        kernels.fn_defines(EnvConfig(width=4, height=70, padding=1), PIECES)  # 71 rows
    assert kernels.fn_defines(EnvConfig(width=56, height=40, padding=4), PIECES)[1] == ("TETRIS_WIDTH", 56)


def test_wrappers_refuse_unknown_builds():
    s = fn_env.reset_plain(batch_keys(prng_key(0), 2, device=CPU), EnvConfig())[1]
    with pytest.raises(ValueError, match="build must be one of"):
        kernels.fn_step(s, torch.zeros(2, dtype=torch.int32), EnvConfig(), PIECES, build="one_thread")
    data = {"obs": torch.zeros((12, 3), dtype=torch.int8), "done": torch.zeros(12, dtype=torch.bool)}
    with pytest.raises(ValueError, match="build must be one of"):
        kernels.replay_sample_stacked(data, prng_key(0), 4, 4, 0, 4, 2, build="gather")


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal_states(got, want, what):
    for k in fn_env.FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), f"{what} {k}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_fn_step_builds_match_plain_on_the_card(cuda, name):
    """Every build that fits the geometry, at B = 1, 15, 17 and 1001, along
    60 random steps and on stacks."""
    kw, kind = GEOMETRIES[name]
    cfg = EnvConfig(**kw)
    builds = kernels.FN_STEP_BUILDS if cfg.padded_height * cfg.padded_width % 16 == 0 else ("words",)
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    for B in (1, 15, 17, 1001):
        s = fn_env.reset_plain(batch_keys(prng_key(B), B, device=cuda), cfg, queue_fns=_queue(kind))[1]
        for t in range(60):
            a = torch.randint(0, 8, (B,), generator=g, device=cuda, dtype=torch.int32)
            want = fn_env.step_plain(s, a, cfg, queue_fns=_queue(kind))
            for build in builds:
                got = kernels.fn_step(s, a, cfg, PIECES, kind, build=build)
                _equal_states(got[0], want[0], f"{name} B={B} {build} step {t}")
                for x, y, field in zip(got[1:], want[1:], ("obs", "reward", "terminated", "lines")):
                    assert torch.equal(x, y), f"{name} B={B} {build} step {t} {field}"
            s = want[0]
    st, a = _stacks(cfg, kind, 128, 62)
    s, a = fn_env.state_from_numpy(st, device=cuda), torch.from_numpy(a).to(cuda)
    want = fn_env.step_plain(s, a, cfg, queue_fns=_queue(kind))
    for build in builds:
        got = kernels.fn_step(s, a, cfg, PIECES, kind, build=build)
        _equal_states(got[0], want[0], f"{name} stacks {build}")
        for x, y, field in zip(got[1:], want[1:], ("obs", "reward", "terminated", "lines")):
            assert torch.equal(x, y), f"{name} stacks {build} {field}"


@pytest.mark.cuda
@pytest.mark.parametrize("frame", [(84, 84), (20, 10)])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_replay_sample_stacked_builds_match_plain_on_the_card(cuda, frame, k):
    """Pixel (7056-byte, both builds) and board (200-byte, words) frames, a
    ring that wrapped, n = 1, 37 and 512, the offsets too."""
    batch, blocks = 32, 3 * k + 3
    cap = batch * blocks
    rng = np.random.default_rng(k)
    data = {"obs": torch.from_numpy(rng.integers(0, 255, (cap, *frame)).astype(np.uint8)).to(cuda),
            "action": torch.from_numpy(rng.integers(0, 7, cap).astype(np.int32)).to(cuda),
            "reward": torch.from_numpy(rng.random(cap).astype(np.float32)).to(cuda),
            "done": torch.from_numpy(rng.random(cap) < 0.25).to(cuda)}
    buf = buffers.ReplayBuffer(data, pos=2 * batch, size=cap)
    row = frame[0] * frame[1]
    builds = kernels.REPLAY_STACKED_BUILDS if row % 16 == 0 else ("words",)
    for n in (1, 37, 512):
        key = prng_key(n + k)
        want = buffers.sample_with_next_stacked_plain(buf, key, n, batch, k)
        start, n_valid = buffers._stacked_window(buf, batch, k)
        for build in builds:
            cur, nxt, off = kernels.replay_sample_stacked(data, key, n, n_valid, start, batch, k,
                                                          return_offsets=True, build=build)
            for name in data:
                assert torch.equal(cur[name], want[0][name]), f"{frame} k={k} n={n} {build} {name}"
                assert torch.equal(nxt[name], want[1][name]), f"{frame} k={k} n={n} {build} next {name}"
            np.testing.assert_array_equal(off.cpu().numpy(), threefry.randint(key, n, n_valid))
