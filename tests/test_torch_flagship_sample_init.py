"""PPO's action sampled inside ``flagship_step``'s launch on the flagship
routes, and the redesigned ``turbo_init`` (a short RNG chain a thread beside
warps that stream the rows tensor as 16-byte words, the state's key read
where it lies).

On the CPU:

* ``ppo.flagship_sample_step`` (``ppo.sample_step_fn``'s step for
  ``impl="flagship"``, board and 84x84 observations) against
  ``sample_actions_plain``, ``engine.step_plain`` and the route's plain
  observation, every output bit-equal, and against JAX's
  ``jax.random.categorical`` (the rows of the global batch), the vmapped
  ``core/engine.py:step`` and the route's observation, at 10x20, 30x20 and
  61x12 with ``env_offset`` 0 and B;
* a numpy model of the sampling build's lane map (``csrc/sample_group.cuh``:
  lane l of a group of 8 or 16 draws action l & 7, the argmax, max and sum
  butterflies among the 8 lanes of its eighth, lane 0's action and
  log-prob) against ``sample_actions_plain``;
* a model of the new ``turbo_init`` launch (``csrc/turbo_step.cu``: envs a
  block, the rows stream's chunks a block and a thread, the chain's draws
  mixed at once from the 64-bit counter, the bag as 4-bit entries of a word,
  both branches of ``init_pieces``, the array path past 8 pieces) against
  ``turbo.init_plain`` and JAX's ``init`` and ``_init_from_key`` in both key
  layouts, in both queue kinds, with a queue longer than a bag, at 30x20,
  61x12 and with piece sets of 3 and 9 pieces;
* the wrappers' argument checks.

On a card (marked ``cuda``; they skip without one): each lanes build of the
flagship sampling step against the plain path and ``ppo_sample`` at global
offsets 0 and 3B; ``turbo_init`` in both key layouts at every geometry
against ``init_plain``, its launch shape against the model's, and
``turbo.init_from_key`` handing the state's key to the kernel as it lies.
This file imports JAX only inside its CPU tests, so ``python -m pytest
--noconftest tests/test_torch_flagship_sample_init.py -m cuda`` runs on the
card's machine.
"""
import functools

import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.components.tetromino import Tetromino, pieces_from_tetrominoes
from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import engine, turbo
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES
from tetris_gymnasium_torch.rl import ppo

CPU = "cpu"
GEOMETRIES = {
    "10x20": dict(auto_reset=True),
    "30x20": dict(width=30, height=20, auto_reset=True),
    "61x12": dict(width=61, height=12, queue_size=3, auto_reset=True),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logits(rng, B, scale):
    """``f32[B, 8]``: normal logits times ``scale``, or small integers
    (exact ties) for ``scale`` None."""
    if scale is None:
        return rng.integers(0, 3, size=(B, 8)).astype(np.float32)
    return (rng.standard_normal((B, 8)) * scale).astype(np.float32)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# ---------------------------------------------------------------------------
# The flagship sampling route against its parts and JAX
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_route(name, obs, G):
    """JAX's init, and one jitted step of the route over a global batch of
    ``G`` envs' logits: ``categorical`` on all of them, the rows ``[off,
    off + B)`` stepping the local envs, then the observation."""
    import jax
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
    from tetris_gymnasium_tpu.core import engine as jengine
    from tetris_gymnasium_tpu.ops import image as jimage

    jc = JEngineConfig(**GEOMETRIES[name])
    init = jax.jit(jax.vmap(functools.partial(jengine.init_state, config=jc)))
    step = jax.vmap(functools.partial(jengine.step, config=jc, obs_fn=lambda s, c, p: ()))
    if obs == "rgb84":
        render = jax.vmap(functools.partial(jengine.render_rgb, config=jc))

        def observe(s):
            return jimage.preprocess_rgb84(render(s))
    else:
        observe = jax.vmap(functools.partial(jengine.observe_board, config=jc))

    @functools.partial(jax.jit, static_argnums=3)
    def sample_step(s, key, logits, off):
        a = jax.random.categorical(key, logits).astype(jnp.int32)
        a = jax.lax.dynamic_slice_in_dim(a, off, s.piece.shape[0])
        s, _, r, d, _ = step(s, a)
        return s, observe(s), r, d, a

    return init, sample_step


def _assert_flagship_equal(ts, js, where):
    for k in engine.FIELDS:
        got, want = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        if k == "key":
            got = got.T
        if k == "score":
            got, want = got.view(np.int32), want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=f"{k} @ {where}")


@pytest.mark.parametrize("obs", ["board", "rgb84"])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_flagship_sample_step_equals_its_parts_and_jax(name, obs):
    """14 steps x 6 envs under logits of four kinds that favour the hard
    drop, at env offsets 0 and B
    (the rows of a global batch of 2B): ``sample_step_fn``'s flagship step
    is ``flagship_sample_step`` and equals ``sample_actions_plain``,
    ``step_plain`` and the plain observation bit for bit (log-prob too); its
    actions, states, observations, rewards and dones equal JAX's
    ``categorical`` rows, ``engine.step`` and the route's observation."""
    import jax.numpy as jnp

    config = EngineConfig(**GEOMETRIES[name])
    B, T = 6, 14
    init, j_sample_step = _jax_route(name, obs, 2 * B)
    observe = engine.render_rgb84_plain if obs == "rgb84" else engine.observe_board_plain
    rng = np.random.default_rng(len(name) + len(obs))
    ends = 0
    for off in (0, B):
        step = ppo.sample_step_fn(config, "flagship", obs=obs, env_offset=off)
        assert step.func is ppo.flagship_sample_step
        keys = batch_keys(threefry.prng_key(3 + off), B, device=CPU)
        ts = engine.init(keys, config, device=CPU)
        js = init(jnp.asarray(keys.numpy()))
        _assert_flagship_equal(ts, js, "init")
        for i in range(T):
            xg = _logits(rng, 2 * B, (0.1, 3.0, 30.0, None)[i % 4])
            xg[:, 5] += 4.0  # mostly hard drops, so that games end and reset within the run
            x = torch.from_numpy(xg[off:off + B].copy())
            key = rng.integers(0, 2**32, size=2, dtype=np.uint32)
            s1, raw, r, d, info, a, lp = step(ts, x, key)
            a2, lp2 = ppo.sample_actions_plain(x, key, off)
            s2, r2, d2, l2 = engine.step_plain(ts, a2, config)
            assert a.dtype == torch.int32 and torch.equal(a, a2), (off, i)
            assert torch.equal(_bits(lp), _bits(lp2)), (off, i)
            for k in engine.FIELDS:
                assert torch.equal(getattr(s1, k), getattr(s2, k)), (k, off, i)
            assert torch.equal(raw, observe(s2, config)) and torch.equal(_bits(r), _bits(r2))
            assert torch.equal(d, d2) and torch.equal(info["lines_cleared"], l2)

            js, jraw, jr, jd, ja = j_sample_step(js, jnp.asarray(key), jnp.asarray(xg), off)
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja), err_msg=f"action {off} @ {i}")
            _assert_flagship_equal(s1, js, f"{off} @ {i}")
            np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw), err_msg=f"obs {off} @ {i}")
            np.testing.assert_array_equal(r.numpy().view(np.int32), np.asarray(jr).view(np.int32))
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
            ends += int(d.sum())
            ts = s1
    assert ends > 0, "no game ended, so no reset was sampled into"


# ---------------------------------------------------------------------------
# The sampling build's lane map, in numpy
# ---------------------------------------------------------------------------

ACTIONS = 8  # csrc/sample_group.cuh:kActions, the shuffles' width


def _shfl_xor(v, off):
    """``__shfl_xor_sync(mask, v, off, 8)`` over every group's lanes ``v[b, l]``."""
    lanes = np.arange(v.shape[1])
    return v[:, (lanes & ~(ACTIONS - 1)) | ((lanes & (ACTIONS - 1)) ^ off)]


def _shfl(v, src):
    """``__shfl_sync(mask, v, src[b, l], 8)``: lane src of each lane's eighth."""
    lanes = np.arange(v.shape[1])
    return np.take_along_axis(v, (lanes & ~(ACTIONS - 1)) | src, axis=1)


def model_sample(x, key, L, env_offset=0):
    """csrc/sample_group.cuh's sample_draw and sample_reduce for a group of
    L lanes an env: every lane's ``(action, log_prob)``, float32 throughout."""
    B = x.shape[0]
    lanes = np.arange(L)
    a = np.broadcast_to(lanes & (ACTIONS - 1), (B, L))
    counters = (env_offset + np.arange(B))[:, None] * ACTIONS + a
    g = threefry.gumbel_lanes(key, torch.from_numpy(counters.astype(np.int64))).numpy()
    xl = np.take_along_axis(x, a, axis=1)
    best, arg, m = (g + xl).astype(np.float32), a.copy(), xl.copy()
    for off in (1, 2, 4):
        ov, oa = _shfl_xor(best, off), _shfl_xor(arg, off)
        take = (ov > best) | ((ov == best) & (oa < arg))
        best, arg = np.where(take, ov, best), np.where(take, oa, arg)
        m = np.maximum(m, _shfl_xor(m, off))
    s = torch.exp(torch.from_numpy(xl - m)).numpy()
    for off in (4, 2, 1):
        s = (s + _shfl_xor(s, off)).astype(np.float32)
    arg = _shfl(arg, np.zeros_like(arg))  # lane 0's
    x_arg = _shfl(xl, arg)
    log_prob = (x_arg - m) - torch.log(torch.from_numpy(s)).numpy()
    return arg.astype(np.int32), log_prob.astype(np.float32)


@pytest.mark.parametrize("L", [8, 16])
def test_sample_lane_map_matches_plain(L):
    """Every lane of every group, both halves of a 16-lane group among them,
    ends with the plain version's action and log-prob bit for bit, at env
    offsets 0 and 1000, under logits of four kinds (exact ties among them)."""
    rng = np.random.default_rng(L)
    for i, scale in enumerate((0.1, 3.0, 30.0, None)):
        x = _logits(rng, 64, scale)
        key = rng.integers(0, 2**32, size=2, dtype=np.uint32)
        for off in (0, 1000):
            a, lp = model_sample(x, key, L, off)
            pa, plp = ppo.sample_actions_plain(torch.from_numpy(x), key, off)
            np.testing.assert_array_equal(a, np.repeat(pa.numpy()[:, None], L, 1), err_msg=f"{i} {off}")
            np.testing.assert_array_equal(lp.view(np.int32),
                                          np.repeat(plp.numpy()[:, None], L, 1).view(np.int32))


# ---------------------------------------------------------------------------
# turbo_init's launch, in numpy
# ---------------------------------------------------------------------------

INIT_THREADS, INIT_ENVS = 256, 128  # csrc/turbo_step.cu: kInitThreads, kInitEnvs
GOLDEN, M1, M2, M32, M64 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF, 2**64 - 1
SMS = (132, 3)


def init_envs(B, sms):
    """csrc/turbo_step.cu:init_envs: envs a block, whole warps."""
    return min(INIT_ENVS, -(-(-(-B // sms)) // 32) * 32)



def _fmix32(x):
    x ^= x >> 16
    x = (x * M1) & M32
    x ^= x >> 13
    x = (x * M2) & M32
    return x ^ (x >> 16)


def _bits_at(key, i):
    """csrc/turbo_step.cu:bits_at: next_bits as draw i of the chain sees it."""
    c = (key + (i + 1) * GOLDEN) & M64
    return _fmix32((c & M32) ^ _fmix32(c >> 32))


def _randint(bits, n):
    return ((bits >> 16) * n) >> 16


def _shuffle_array(bag, key):
    """engine_common.cuh:shuffle_bag, a fresh bag's draws one after another;
    returns the key."""
    bag[:] = range(len(bag))
    for i in range(len(bag) - 1, 0, -1):
        key = (key + GOLDEN) & M64
        j = _randint(_fmix32((key & M32) ^ _fmix32(key >> 32)), i + 1)
        bag[i], bag[j] = bag[j], bag[i]
    return key


def model_chain(k0, k1, n, qs, uniform):
    """csrc/turbo_step.cu:init_chain for one env: ``(key, piece, bag,
    bag_index, queue)``."""
    key = (k1 << 32) | k0
    if n > 8:  # the array path: init_pieces
        bag = list(range(n))
        key = _shuffle_array(bag, key)
        drawn = 0
    else:
        word = 0x76543210 & ((1 << (4 * n)) - 1)
        for i in range(n - 1, 0, -1):
            j = _randint(_bits_at(key, n - 1 - i), i + 1)
            d = ((word >> (4 * i)) ^ (word >> (4 * j))) & 15
            word ^= (d << (4 * i)) | (d << (4 * j))
        bag = [(word >> (4 * l)) & 15 for l in range(n)]
        drawn = n - 1
    if not uniform and qs + 1 <= n:
        key = (key + drawn * GOLDEN) & M64 if n <= 8 else key
        return key, bag[0], bag, qs + 1, bag[1:1 + qs]
    if uniform:
        if n <= 8:
            picks = [_randint(_bits_at(key, n - 1 + i), n) for i in range(1 + qs)]
            key = (key + (n + qs) * GOLDEN) & M64
        else:
            picks = []
            for _ in range(1 + qs):
                key = (key + GOLDEN) & M64
                picks.append(_randint(_fmix32((key & M32) ^ _fmix32(key >> 32)), n))
        return key, picks[0], bag, 0, picks[1:]
    key = (key + drawn * GOLDEN) & M64 if n <= 8 else key
    index, picks = 0, []
    for _ in range(1 + qs):  # draw(e, false): a fresh bag when this one is spent
        if index >= n:
            key = _shuffle_array(bag, key)
            index = 0
        picks.append(bag[index])
        index += 1
    return key, picks[0], bag, index, picks[1:]


def model_rows(cfg, B, sms):
    """The rows tensor as the stream warps of every block store it, checked
    to write each word once: ``uint32[H * NW * B]`` flat."""
    H, nw = cfg.padded_height, turbo.n_words(cfg)
    empty = np.asarray(turbo._empty_rows(cfg, CPU).reshape(H * nw), np.int64)  # the pattern, a word a segment
    words = H * nw * B
    out = np.zeros(words, np.int64)
    writes = np.zeros(words, np.int64)
    E, threads = init_envs(B, sms), INIT_THREADS
    grid = -(-B // E)
    chunks = -(-words // 4)
    per = -(-chunks // grid)
    for blk in range(grid):
        n = min(E, B - blk * E)
        env_warps = -(-n // 32)
        first, S = 32 * env_warps, threads - 32 * env_warps
        assert S >= threads // 2 and first + S == threads
        q0 = min(chunks, blk * per)
        q1 = min(chunks, q0 + per)
        step_seg, step_off = divmod(4 * S, B)
        for si in range(S):
            q = q0 + si
            seg, off = divmod(4 * q, B)  # carried from chunk to chunk, as the kernel does
            while q < q1:
                w = 4 * q
                assert (seg, off) == divmod(w, B)
                if off + 3 < B and w + 4 <= words:  # one 16-byte store
                    out[w:w + 4] = empty[seg]
                    writes[w:w + 4] += 1
                else:
                    for i in range(w, min(w + 4, words)):
                        out[i] = empty[i // B]
                        writes[i] += 1
                q += S
                seg, off = seg + step_seg, off + step_off
                if off >= B:
                    seg, off = seg + 1, off - B
    assert (writes == 1).all()
    return out


def model_init(keys_b2, cfg, pieces, sms):
    """The whole state of the launch, batch-minor as ``TurboState``."""
    keys = keys_b2.numpy().astype(np.int64)
    B, n = keys.shape[0], len(pieces.ids)
    qs, hs = cfg.queue_size, cfg.holder_size
    box = np.asarray(pieces.box, np.int64)
    uniform = cfg.queue_kind == "uniform"
    f = {"key": np.zeros((2, B), np.int64), "piece": np.zeros(B, np.int64), "x": np.zeros(B, np.int64),
         "bag": np.zeros((n, B), np.int64), "bag_index": np.zeros(B, np.int64),
         "queue": np.zeros((qs, B), np.int64)}
    for b in range(B):
        key, piece, bag, index, queue = model_chain(int(keys[b, 0]), int(keys[b, 1]), n, qs, uniform)
        f["key"][:, b] = (key & M32, key >> 32)
        f["piece"][b], f["bag"][:, b], f["bag_index"][b], f["queue"][:, b] = piece, bag, index, queue
        f["x"][b] = cfg.padded_width // 2 - box[piece] // 2
    rows_shape = kernels._rows_shape(cfg, B)
    f["rows"] = model_rows(cfg, B, sms).reshape(rows_shape)
    zeros = {"rotation": (B,), "y": (B,), "holder_piece": (hs, B), "holder_rotation": (hs, B),
             "holder_count": (B,), "has_swapped": (B,), "game_over": (B,), "score": (B,),
             "lines": (B,), "steps": (B,)}
    f.update({k: np.zeros(s, np.int64) for k, s in zeros.items()})
    return f


_NINE_SHAPES = [((1, 1), (1, 1)), ((1, 1, 1),), ((1, 1), (1, 0)), ((1, 1, 0), (0, 1, 1)),
                ((0, 1, 0), (1, 1, 1)), ((1, 0, 0), (1, 1, 1)), ((1,),), ((1, 1),),
                ((1, 0, 1), (1, 1, 1))]
_THREE_SHAPES = [((1, 1), (1, 1)), ((1, 1, 1, 1, 1, 1),), ((0, 1, 0), (1, 1, 1), (0, 0, 0))]
INIT_CASES = {
    "10x20-bag": ("std", dict()),
    "10x20-uniform": ("std", dict(queue_kind="uniform")),
    "10x20-queue7": ("std", dict(queue_size=7, holder_size=2)),  # QS + 1 > NP: a second bag
    "10x20-queue12-uniform": ("std", dict(queue_size=12, queue_kind="uniform")),
    "30x20": ("std", dict(width=30, height=20)),
    "61x12": ("std", dict(width=61, height=12, queue_size=3)),
    "3-pieces-w30": ("three", dict(width=30, height=16, queue_size=2)),
    "3-pieces-queue4": ("three", dict(width=10, height=16, queue_size=4)),
    "9-pieces": ("nine", dict(queue_size=5)),
    "9-pieces-uniform": ("nine", dict(queue_size=3, queue_kind="uniform")),
}


def _pieces(kind, jax=False):
    if kind == "std":
        if jax:
            from tetris_gymnasium_tpu.pieces import PIECES as JPIECES

            return JPIECES, None
        return PIECES, None
    shapes = _THREE_SHAPES if kind == "three" else _NINE_SHAPES
    colors = [(255 - 20 * i, 10 * i, 40) for i in range(len(shapes))]
    if jax:
        from tetris_gymnasium_tpu.components.tetromino import Tetromino as JTetromino
        from tetris_gymnasium_tpu.components.tetromino import pieces_from_tetrominoes as jfrom

        return jfrom([JTetromino(2 + i, c, np.array(m, np.uint8))
                      for i, (c, m) in enumerate(zip(colors, shapes))])
    return pieces_from_tetrominoes([Tetromino(2 + i, c, np.array(m, np.uint8))
                                    for i, (c, m) in enumerate(zip(colors, shapes))])


def _init_case(name):
    kind, kw = INIT_CASES[name]
    pieces, pad = _pieces(kind)
    kw = dict(kw, padding=pad) if pad is not None else dict(kw)
    return EngineConfig(**kw), pieces, kind, kw


@pytest.mark.parametrize("name", list(INIT_CASES))
def test_init_model_matches_plain_and_jax(name):
    """The launch's model (both SM counts, so that blocks take from one env
    to 128) equals ``turbo.init_plain`` on ``[B, 2]`` keys and
    ``turbo.init_from_key`` on the state's ``[2, B]`` layout, field for
    field, and JAX's ``init`` and ``_init_from_key``, at batches that leave
    part-full blocks and part-full 16-byte chunks of the rows."""
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
    from tetris_gymnasium_tpu.core import turbo as jturbo

    cfg, pieces, kind, kw = _init_case(name)
    jpieces = _pieces(kind, jax=True)[0]
    jc = JEngineConfig(**kw)
    for B in (1, 5, 33, 130, 397):
        keys = batch_keys(threefry.prng_key(B + len(name)), B, device=CPU)
        plain = turbo.init_plain(keys, cfg, pieces)
        rows_of_key = turbo.init_from_key(keys.T.contiguous(), cfg, pieces)
        j_init = jturbo.init(jnp.asarray(keys.numpy()), jc, jpieces)
        j_key = jturbo._init_from_key(jnp.asarray(keys.numpy().T), jc, jpieces)
        for sms in SMS:
            model = model_init(keys, cfg, pieces, sms)
            for k in turbo.FIELDS:
                want = getattr(plain, k)
                got = model[k].astype(np.int64)
                ref = want.view(torch.int32).numpy() if k == "score" else want.numpy()
                np.testing.assert_array_equal(got, ref.astype(np.int64), err_msg=f"{name} B={B} {k} sms={sms}")
        for k in turbo.FIELDS:
            want = getattr(plain, k).numpy()
            np.testing.assert_array_equal(getattr(rows_of_key, k).numpy(), want, err_msg=f"{name} {k} [2, B]")
            np.testing.assert_array_equal(np.asarray(getattr(j_init, k)), want, err_msg=f"JAX init {name} {k}")
            np.testing.assert_array_equal(np.asarray(getattr(j_key, k)), want, err_msg=f"JAX key {name} {k}")


def test_init_launch_shape_facts():
    """The launch at the paths' batches on 132 SMs: the vector env's 8192
    envs take 64 a block (128 blocks, two env warps beside six streaming),
    the grouped DQN's 1024 take 32 (32 blocks), 65536 take 128 (512 blocks,
    four env warps beside four streaming); a row segment of B words fills
    whole 16-byte chunks where B % 4 == 0, and else some chunks straddle two
    segments."""
    assert [init_envs(B, 132) for B in (1, 512, 1024, 8192, 65536)] == [32, 32, 32, 64, 128]
    assert [-(-B // init_envs(B, 132)) for B in (1024, 8192, 65536)] == [32, 128, 512]
    cfg = EngineConfig()
    for B, straddles in ((8192, False), (1024, False), (1001, True), (33, True)):
        words = cfg.padded_height * B
        split = sum((4 * q) // B != (4 * q + 3) // B for q in range(words // 4))
        assert (split > 0) == straddles, B


def test_turbo_init_from_key_reads_the_key_in_place(monkeypatch):
    """``turbo.init_from_key`` on a CUDA key hands the state's ``[2, B]``
    key to the kernel as it lies, with ``key_rows``, and makes no copy (a
    stand-in tensor whose ``is_cuda`` is true, and a stand-in kernel)."""
    seen = {}

    class CudaLike(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def fake_init(keys, config, pieces, key_rows=False):
        seen.update(keys=keys, key_rows=key_rows)
        return "state"

    monkeypatch.setattr(kernels, "turbo_init", fake_init)
    key2b = batch_keys(threefry.prng_key(1), 8, device=CPU).T.contiguous().as_subclass(CudaLike)
    assert turbo.init_from_key(key2b, EngineConfig()) == "state"
    assert seen["key_rows"] is True and seen["keys"] is key2b


# ---------------------------------------------------------------------------
# The wrappers' checks
# ---------------------------------------------------------------------------


def _flagship_cpu(B=4):
    config = EngineConfig()
    return config, engine.init(batch_keys(threefry.prng_key(0), B, device=CPU), config, device=CPU)


@pytest.mark.parametrize("bad", [
    torch.zeros((4, 8), dtype=torch.float64), torch.zeros((4, 7)), torch.zeros((3, 8)),
    torch.zeros((8, 4)).T, torch.zeros((4, 8)),  # right, but on the CPU
], ids=["float64", "width7", "batch3", "strided", "cpu"])
def test_flagship_step_checks_logits(bad):
    config, s = _flagship_cpu()
    with pytest.raises(ValueError, match="logits"):
        kernels.flagship_step(s, None, config, PIECES, RewardsMapping(), logits=bad,
                              act_key=threefry.prng_key(0))


def test_flagship_step_checks_key_and_offset():
    config, s = _flagship_cpu()
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="act_key without logits"):
        kernels.flagship_step(s, a, config, PIECES, RewardsMapping(), act_key=threefry.prng_key(0))
    with pytest.raises(ValueError, match="env_offset without logits"):
        kernels.flagship_step(s, a, config, PIECES, RewardsMapping(), env_offset=3)
    with pytest.raises(ValueError, match="logits need act_key"):
        kernels.flagship_step(s, None, config, PIECES, RewardsMapping(), logits=torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="act_key"):
        kernels.flagship_step(s, None, config, PIECES, RewardsMapping(), logits=torch.zeros((4, 8)),
                              act_key=np.zeros(3, np.uint32))
    for off in (-1, 2**28):
        with pytest.raises(ValueError, match="env_offset|32-bit counters"):
            kernels.flagship_step(s, None, config, PIECES, RewardsMapping(),
                                  logits=torch.zeros((4, 8)), act_key=threefry.prng_key(0),
                                  env_offset=off)


def test_turbo_init_checks_its_keys():
    config = EngineConfig()
    keys = batch_keys(threefry.prng_key(0), 4, device=CPU)
    for bad, rows in ((keys, False), (keys.T.contiguous(), True),  # right, but on the CPU
                      (keys, True), (keys.T.contiguous(), False), (keys.to(torch.int32), False),
                      (keys[:, 0], False)):
        with pytest.raises(ValueError, match="keys"):
            kernels.turbo_init(bad, config, PIECES, key_rows=rows)


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_flagship_sample_builds_match_plain(cuda, name):
    """Each lanes build of the sampling step at B = 1, 1001 and 4096 and env
    offsets 0 and 3B, 16 steps under four kinds of logits: action, state,
    reward, done and lines bit-equal to ``sample_actions_plain`` +
    ``step_plain``; the action and log-prob bit-equal to ``ppo_sample``'s;
    the log-prob within 2 ulps and 2**-22 of the plain one."""
    config = EngineConfig(**GEOMETRIES[name])
    rng = np.random.default_rng(11)
    for B in (1, 1001, 4096):
        for off in (0, 3 * B):
            s = kernels.flagship_init(batch_keys(threefry.prng_key(B), B, device=cuda), config, PIECES)
            for i in range(16):
                x = torch.from_numpy(_logits(rng, B, (0.1, 3.0, 30.0, None)[i % 4])).to(cuda)
                key = rng.integers(0, 2**32, size=2, dtype=np.uint32)
                pa, plp = ppo.sample_actions_plain(x, key, off)
                ps, pr, pd, pl = engine.step_plain(s, pa, config)
                ka, klp = kernels.sample_actions(x, key, env_offset=off)
                ulp = torch.from_numpy(np.spacing(plp.abs().cpu().numpy())).to(cuda).double()
                for lanes in kernels.FLAGSHIP_LANES:
                    ks, kr, kd, kl, a, lp = kernels.flagship_step(
                        s, None, config, PIECES, RewardsMapping(), lanes=lanes, logits=x, act_key=key,
                        env_offset=off)
                    tag = (B, off, i, lanes)
                    assert torch.equal(a, pa) and torch.equal(a, ka), tag
                    assert torch.equal(_bits(lp), _bits(klp)), tag
                    assert ((lp.double() - plp.double()).abs() <= 2.0**-22 + 2 * ulp).all(), tag
                    for k in engine.FIELDS:
                        assert torch.equal(getattr(ks, k), getattr(ps, k)), (k, *tag)
                    assert torch.equal(_bits(kr), _bits(pr)) and torch.equal(kd, pd)
                    assert torch.equal(kl, pl), tag
                s = ps


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(INIT_CASES))
def test_turbo_init_matches_plain_on_the_card(cuda, name):
    """Both key layouts at batches that leave part-full blocks, chunks that
    straddle two row segments, and 8192 and 65536 envs, against
    ``init_plain``; the launch's shape against the model's."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cfg, pieces, _, _ = _init_case(name)
    for B in (1, 33, 1001, 1024, 8192, 65536, INIT_ENVS * sms + 5):
        keys = batch_keys(threefry.prng_key(B), B, device=cuda)
        want = turbo.init_plain(keys.cpu(), cfg, pieces)
        for got in (kernels.turbo_init(keys, cfg, pieces),
                    kernels.turbo_init(keys.T.contiguous(), cfg, pieces, key_rows=True)):
            for k in turbo.FIELDS:
                assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), (name, B, k)
        assert kernels.turbo_init_shape(cfg, pieces, B) == {
            "envs_per_block": init_envs(B, sms), "threads_per_block": INIT_THREADS}, (name, B)
    # a key at an odd word: copied to an 8-byte boundary
    keys = batch_keys(threefry.prng_key(5), 65, device=cuda).reshape(-1)[1:129].reshape(64, 2)
    got = kernels.turbo_init(keys, cfg, pieces)
    want = turbo.init_plain(keys.cpu(), cfg, pieces)
    for k in turbo.FIELDS:
        assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), (name, "odd", k)
