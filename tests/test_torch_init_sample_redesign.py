"""The redesigned ``flagship_init`` (the boards as a stream of 16-byte words
of their constant pattern beside one RNG chain a thread) and
``replay_sample`` (a group of lanes a chunk of a sample's words, every load
of a lane in flight before its stores).

On the CPU:

* ``flagship_init``'s board word map (``csrc/flagship_step.cu``): a numpy
  model of the launch (envs a block from B and the SM count, each block's
  words, each thread's words at a stride of the block's threads with its
  pattern offset carried from word to word, each word's bytes from the
  playfield rows it touches, the tensor's ragged last word byte by byte)
  must write every byte of the board tensor once and equal
  ``engine.init_plain``'s boards and JAX's ``init_state``'s at the
  geometries of ``tests/test_torch_wide_boards.py`` (30x20 with and without
  gravity, 61x12, 28x14 whose 648-byte board is no multiple of 16, the 6x6
  pieces at widths 10 and 30 with 924- and 616-byte boards), the default
  board and an odd 17x17 one, in both queue kinds; the whole plain state
  equals JAX's there;
* ``replay_sample``'s lane map (``csrc/replay.cu``): a numpy model of the
  launcher's plan (the item map of every field's words, entry then
  successor, widest words first; the lanes a unit, the words a lane, the
  chunks a sample and the units a block) and of each lane's loads and
  stores must copy every byte of every field, entry and successor, exactly
  once and equal ``sample_with_next_plain``,
  ``sample_plain`` and JAX's ``sample_with_next`` and ``sample`` at the
  grouped, CNN and pixel DQNs' entries and at rows of single bytes, with a
  ragged n, on a buffer partly full, wrapped and full.

On a card (marked ``cuda``; they skip without one, decided inside the
test): ``flagship_init`` at every geometry in both queue kinds at B = 1,
31, 33, 8192, 65536 and at batches that leave a part-full last block of 256
envs and of a few, and ``replay_sample`` at n = 1, 3, 256, 512 and 65536
with and without successors, with ``return_offsets``, against the plain
twins; each launch's shape against the models'.  This file imports JAX only
inside its CPU tests, so ``python -m pytest --noconftest
tests/test_torch_init_sample_redesign.py -m cuda`` runs on the card's
machine.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.components.tetromino import Tetromino, pieces_from_tetrominoes
from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import engine
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES
from tetris_gymnasium_torch.rl import buffers

CPU = "cpu"
SMS = (132, 3)  # an H100's SMs, and few enough that blocks take their most envs
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
# flagship_init's board word map, in numpy
# ---------------------------------------------------------------------------

INIT_THREADS, WORD = 256, 16  # csrc/flagship_step.cu: kInitThreads, a board word's bytes


def stream_threads(board, n):
    """csrc/flagship_step.cu:flagship_init_kernel's stream for a block of n
    envs: ``(first, S, fixed)``: threads first .. first + S - 1 store the
    board words, the warps after the envs' where they leave two or more,
    else every thread; S a multiple of the pattern's period in words where
    it fits, so that each stores one word throughout."""
    period = board // np.gcd(board, WORD)
    env_warps = -(-n // 32)
    first = 32 * env_warps if env_warps <= INIT_THREADS // 32 - 2 else 0
    avail = INIT_THREADS - first
    S = avail // period * period if avail >= period else avail
    return first, S, S % period == 0

GEOMETRIES = {
    "10x20": dict(),
    "30x20": dict(width=30, height=20, auto_reset=True),
    "30x20-nograv": dict(width=30, height=20, gravity_enabled=False),
    "61x12": dict(width=61, height=12, queue_size=3, auto_reset=True),
    "28x14": dict(width=28, height=14, auto_reset=True),
    "17x17": dict(width=17, height=17),
    "6x6-w10": dict(width=10, height=16, queue_size=2),
    "6x6-w30": dict(width=30, height=16, queue_size=2),
}


def _config(name, kind="bag"):
    """``(torch config, torch pieces, JAX config kwargs, oversize)``."""
    kw = dict(GEOMETRIES[name], queue_kind=kind)
    if name.startswith("6x6"):
        pieces, pad = pieces_from_tetrominoes([Tetromino(2 + i, c, np.array(m, np.uint8))
                                               for i, (c, m) in enumerate(OVERSIZE_SHAPES)])
        kw["padding"] = pad
        return EngineConfig(**kw), pieces, kw, True
    return EngineConfig(**kw), PIECES, kw, False


def init_envs(B, sms):
    """csrc/flagship_step.cu:init_envs: envs a block."""
    return min(INIT_THREADS, max(1, -(-B // sms)))


@functools.lru_cache(maxsize=None)
def _board_word(o, geometry):
    """csrc/flagship_step.cu:board_word: the 16 bytes from byte ``o`` of the
    boards laid end to end, from the playfield interval of each row the word
    touches (row r of the stream is row r mod H of a board)."""
    H, PW, pad, width, height = geometry
    play = 0
    for k in range(15 // PW + 2):
        r = o // PW + k
        at = r * PW + pad - o
        lo, hi = max(at, 0), min(at + width, WORD)
        if r % H < height and lo < hi:
            play |= (0xFFFF >> (WORD - hi)) & ~((1 << lo) - 1)
    return np.array([(~play >> i) & 1 for i in range(WORD)], np.int8)


def _board_cell(c, geometry):
    H, PW, pad, width, height = geometry
    r, w = divmod(c, PW)
    return 1 if r >= height or w < pad or w >= pad + width else 0


def _model_init_boards(cfg, B, sms):
    """Every block's threads store their words of the board tensor; returns
    the boards ``int8[B, H, PW]``, having checked that each byte is written
    once and that each block holds its words."""
    geometry = (cfg.padded_height, cfg.padded_width, cfg.padding, cfg.width, cfg.height)
    board = cfg.padded_height * cfg.padded_width
    total = B * board
    out = np.full(total, 77, np.int8)
    writes = np.zeros(total, np.int64)
    E = init_envs(B, sms)
    for blk in range(-(-B // E)):
        base = blk * E
        n = min(E, B - base)
        first_thread, threads, fixed = stream_threads(board, n)
        step = (WORD * threads) % board
        assert (step == 0) == fixed and first_thread + threads <= INIT_THREADS
        w0 = -(-base * board // WORD)
        words = -(-(base + n) * board // WORD) - w0
        assert words >= 1
        for t in range(threads):
            o = (WORD * (w0 + t)) % board
            first = _board_word(o, geometry)  # the thread's one word, where fixed
            for i in range(t, words, threads):
                w = w0 + i
                if WORD * w + WORD <= total:
                    out[WORD * w:WORD * w + WORD] = first if fixed else _board_word(o, geometry)
                    writes[WORD * w:WORD * w + WORD] += 1
                else:  # the tensor's ragged last word
                    for j in range(total - WORD * w):
                        out[WORD * w + j] = _board_cell((o + j) % board, geometry)
                        writes[WORD * w + j] += 1
                o += step
                if o >= board:
                    o -= board
    assert (writes == 1).all()
    return out.reshape(B, cfg.padded_height, cfg.padded_width)


@functools.lru_cache(maxsize=None)
def _jax_init(name, kind):
    import jax

    from tetris_gymnasium_tpu.components.tetromino import Tetromino as JTetromino
    from tetris_gymnasium_tpu.components.tetromino import pieces_from_tetrominoes as jpieces_from
    from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
    from tetris_gymnasium_tpu.core import engine as jengine

    _, _, kw, oversize = _config(name, kind)
    extra = {}
    if oversize:
        extra["pieces"] = jpieces_from([JTetromino(2 + i, c, np.array(m, np.uint8))
                                        for i, (c, m) in enumerate(OVERSIZE_SHAPES)])[0]
    return jax.jit(jax.vmap(functools.partial(jengine.init_state, config=JEngineConfig(**kw), **extra)))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_init_word_map_matches_plain_and_jax(name):
    """The model's boards at batches that leave blocks of one env, of a few,
    of 181 (two streaming warps) and of 234 and 256 envs (every thread
    streaming) part full (132 SMs and 3), against the plain init and
    JAX's ``init_state`` in both queue kinds; the rest of the plain state
    against JAX's too."""
    for B in (1, 31, 33, 541, 700, 1001):
        models = [_model_init_boards(_config(name)[0], B, sms) for sms in SMS]
        keys = batch_keys(threefry.prng_key(B + 40), B, device=CPU)
        for kind in ("bag", "uniform"):
            cfg, pieces, _, _ = _config(name, kind)
            plain = engine.init_plain(keys, cfg, pieces)
            theirs = _jax_init(name, kind)(keys.numpy())
            for sms, model in zip(SMS, models):
                np.testing.assert_array_equal(model, plain.board.numpy(), err_msg=f"{name} {kind} B={B} sms={sms}")
                np.testing.assert_array_equal(model, np.asarray(theirs.board), err_msg=f"JAX {name} {kind} B={B}")
            for k in engine.FIELDS:
                want = np.asarray(getattr(theirs, k))
                got = getattr(plain, k).numpy()
                np.testing.assert_array_equal(got.T if k == "key" else got, want, err_msg=f"{name} {kind} {k}")


def test_init_word_map_boards_and_blocks():
    """The word map's facts at the paths' shapes: the vector env's 8192 envs
    take 63 a block on 132 SMs (131 blocks), its two env warps beside 189
    threads (7 periods of 27 words) streaming at 10x20, 171 at 30x20, each
    one word throughout; 65536 take 256 a block, every thread streaming
    first (243 and 228); the odd 17x17 board's period (525 words) fits no
    block; the ragged last word appears only where BOARD is no multiple of
    16."""
    assert [init_envs(B, 132) for B in (1, 512, 8192, 65536)] == [1, 4, 63, 256]
    assert -(-8192 // 63) == 131
    assert stream_threads(432, 63) == (64, 189, True) and stream_threads(912, 63) == (64, 171, True)
    assert stream_threads(432, 256) == (0, 243, True) and stream_threads(912, 256) == (0, 228, True)
    assert stream_threads(432, 1) == (32, 216, True) and stream_threads(525, 63) == (64, 192, False)
    for name, ragged in (("10x20", False), ("30x20", False), ("61x12", False), ("28x14", True),
                         ("6x6-w30", True), ("17x17", True)):
        cfg = _config(name)[0]
        board = cfg.padded_height * cfg.padded_width
        assert (board % WORD != 0) == ragged, name
    # a word straddling the end of one board and the start of the next
    cfg = _config("28x14")[0]
    geometry = (cfg.padded_height, cfg.padded_width, cfg.padding, cfg.width, cfg.height)
    board = cfg.padded_height * cfg.padded_width  # 648 = 40 * 16 + 8
    pattern = np.array([_board_cell(c, geometry) for c in range(board)], np.int8)
    np.testing.assert_array_equal(_board_word(640, geometry), np.concatenate([pattern[640:], pattern[:8]]))


# ---------------------------------------------------------------------------
# replay_sample's lane map, in numpy
# ---------------------------------------------------------------------------

SLOTS_FEW, SLOTS_MANY, MAX_GROUP_THREADS, WARPS_PER_SM = 4, 16, 256, 16  # csrc/replay.cu


def sample_plan(fields, with_next, n, sms):
    """csrc/replay.cu:sample_plan for ``fields`` ``[(row_bytes, word)]``:
    ``(entries, items, lanes, slots, chunks, units_per_block)``; the item
    map's ``entries`` are ``(field, first item, words a row)``, the fields
    by word size, widest first."""
    halves = 2 if with_next else 1
    entries, items = [], 0
    for word in (16, 4, 1):
        for j, (rb, w) in enumerate(fields):
            if w == word:
                entries.append((j, items, rb // w))
                items += halves * (rb // w)
    room = 32 * WARPS_PER_SM * sms
    lanes = 8
    while lanes < 32 and items > lanes * SLOTS_MANY:
        lanes *= 2
    while lanes < 32 and n * 2 * lanes <= room:
        lanes *= 2
    slots = SLOTS_FEW if n * -(-items // (lanes * SLOTS_FEW)) * lanes <= room else SLOTS_MANY
    chunks = max(1, -(-items // (lanes * slots)))
    warp = 32 // lanes
    want = -(-(-(-(n * chunks) // sms)) // warp) * warp
    return entries, items, lanes, slots, chunks, min(MAX_GROUP_THREADS // lanes, max(warp, want))


def _item(entries, i):
    """item_at: ``(field, successor, word)`` of item ``i``."""
    j, first, wpr = max((e for e in entries if e[1] <= i), key=lambda e: e[1])
    w = i - first
    return (j, True, w - wpr) if w >= wpr else (j, False, w)


def _fields(data, n, with_next):
    """``(row_bytes, word)`` of each store, as ``kernels._sample_setup``
    picks the word with its outputs."""
    out = []
    for store in data.values():
        row_bytes = store[0].numel() * store.element_size()
        outs = [torch.empty((n,) + tuple(store.shape[1:]), dtype=store.dtype) for _ in range(1 + with_next)]
        out.append((row_bytes, kernels._copy_word(row_bytes, store, *outs)))
    return out


def _model_sample(data, key, n, maxval, start, batch, sms):
    """The launch's blocks (a chunk of each of their samples' words), units
    and lanes: each lane loads its words of its unit (items base + lane +
    group * k)
    and stores them, into numpy outputs, returned as ``(cur, nxt)`` dicts
    (``nxt`` None without successors), having checked that every byte of
    every output is written once."""
    with_next = batch > 0
    fields = _fields(data, n, with_next)
    entries, items, lanes, slots, chunks, per_block = sample_plan(fields, with_next, n, sms)
    cap = next(iter(data.values())).shape[0]
    off = threefry.randint(key, n, maxval).astype(np.int64)
    anchor = (start + off) % cap
    successor = (anchor + batch) % cap
    stores = [v.numpy().reshape(cap, -1).view(np.uint8) for v in data.values()]
    outs = [[np.zeros((n, f[0]), np.uint8) for _ in range(1 + with_next)] for f in fields]
    writes = [[np.zeros((n, f[0]), np.int64) for _ in range(1 + with_next)] for f in fields]
    lane_items = [[(k, lane + lanes * k) for k in range(slots)] for lane in range(lanes)]
    assert sorted(i for per in lane_items for _, i in per) == list(range(lanes * slots))
    for blk, base in itertools.product(range(-(-n // per_block)), range(chunks)):  # the grid: (samples, chunk)
        for t in range(per_block * lanes):
            s = blk * per_block + t // lanes
            if s >= n:
                continue
            for _, i in lane_items[t % lanes]:
                if base * lanes * slots + i >= items:
                    continue
                j, nxt, w = _item(entries, base * lanes * slots + i)
                word, row = fields[j][1], successor[s] if nxt else anchor[s]
                outs[j][nxt][s, w * word:(w + 1) * word] = stores[j][row, w * word:(w + 1) * word]
                writes[j][nxt][s, w * word:(w + 1) * word] += 1
    for per_field in writes:
        for w in per_field:
            assert (w == 1).all()
    names = list(data)

    def as_dict(h):
        return {k: torch.from_numpy(outs[j][h].copy()).view(data[k].dtype).reshape((n,) + tuple(data[k].shape[1:]))
                for j, k in enumerate(names)}

    return as_dict(0), (as_dict(1) if with_next else None)


def _sample_data(kind, cap, g):
    """A buffer's stores: the grouped DQN's features and mask, the CNN
    DQN's 200-byte boards, the pixel DQN's 84x84 frames, or rows of 13
    single bytes; each with action, reward and done."""
    if kind == "grouped":
        data = {"obs": torch.randn((cap, 40, 13), generator=g),
                "mask": (torch.rand((cap, 40), generator=g) < 0.5).float()}
    elif kind == "board":
        data = {"obs": torch.randint(-1, 2, (cap, 20, 10), generator=g, dtype=torch.int8)}
    elif kind == "pixel":
        data = {"obs": torch.randint(0, 256, (cap, 84, 84), generator=g, dtype=torch.uint8)}
    else:
        data = {"obs": torch.randint(0, 256, (cap, 13), generator=g, dtype=torch.uint8)}
    data.update(action=torch.randint(0, 40, (cap,), generator=g, dtype=torch.int32),
                reward=torch.randn((cap,), generator=g), done=torch.rand((cap,), generator=g) < 0.1)
    return data


SAMPLE_KINDS = {"grouped": (64, 4, (37, 256)), "board": (128, 3, (37, 513)), "pixel": (16, 3, (13,)),
                "bytes": (8, 5, (29, 100))}


@pytest.mark.parametrize("kind", list(SAMPLE_KINDS))
def test_sample_lane_map_matches_plain_and_jax(kind):
    """The model on a buffer partly full, wrapped and full, with and without
    successors, against the plain twins and JAX's ``sample_with_next`` and
    ``sample``."""
    import jax.numpy as jnp

    from tetris_gymnasium_tpu.rl import buffers as jbuffers

    B, blocks, ns = SAMPLE_KINDS[kind]
    g = torch.Generator()
    g.manual_seed(len(kind))
    data = _sample_data(kind, B * blocks, g)
    cap = B * blocks
    for pos, size in ((B, 2 * B), (2 * B, cap), (0, cap)):
        buf = buffers.ReplayBuffer(data, pos=pos, size=size)
        jbuf = jbuffers.ReplayBuffer(data={k: jnp.asarray(v.numpy()) for k, v in data.items()},
                                     pos=jnp.int32(pos), size=jnp.int32(size))
        for n in ns:
            key = threefry.fold_in(threefry.prng_key(7), n + pos)
            start, n_valid = buffers._successor_window(buf, B)
            for sms in SMS:
                mc, mn = _model_sample(data, key, n, n_valid, start, B, sms)
                ms, _ = _model_sample(data, key, n, max(size, 1), 0, 0, sms)
            pc, pn = buffers.sample_with_next_plain(buf, key, n, B)
            ps = buffers.sample_plain(buf, key, n)
            jc, jn = jbuffers.sample_with_next(jbuf, jnp.asarray(key), n, B)
            js = jbuffers.sample(jbuf, jnp.asarray(key), n)
            for k in data:
                what = f"{kind} pos={pos} size={size} n={n} {k}"
                assert torch.equal(mc[k], pc[k]) and torch.equal(mn[k], pn[k]), what
                assert torch.equal(ms[k], ps[k]), f"{what} without successors"
                np.testing.assert_array_equal(mc[k].numpy(), np.asarray(jc[k]), err_msg=f"JAX {what}")
                np.testing.assert_array_equal(mn[k].numpy(), np.asarray(jn[k]), err_msg=f"JAX {what} successor")
                np.testing.assert_array_equal(ms[k].numpy(), np.asarray(js[k]), err_msg=f"JAX {what} sample")


def test_sample_plan_at_the_paths_shapes():
    """The plan at the DQN paths' shapes on 132 SMs: the grouped DQN's 256
    samples of 2249-byte entries (286 words with the successor) in 3 units
    of a warp at 4 words a lane, six units a block (128 blocks); the CNN
    DQN's 512 of 209 bytes (106 words) in one unit of a warp each (a small
    n takes a warp a unit while the warps fit 16 an SM), four a block;
    65536 samples at 16 words a lane, one unit a sample, the CNN's 8 lanes
    each, in blocks of 256 threads; every block whole warps."""
    g = torch.Generator()
    g.manual_seed(0)
    data = {kind: _sample_data(kind, 4, g) for kind in ("grouped", "board", "pixel")}
    for kind, n, with_next, want in (
            ("grouped", 256, True, (286, 32, 4, 3, 6)), ("grouped", 256, False, (143, 32, 4, 2, 4)),
            ("board", 512, True, (106, 32, 4, 1, 4)), ("grouped", 65536, True, (286, 32, 16, 1, 8)),
            ("board", 65536, True, (106, 8, 16, 1, 32)), ("pixel", 512, True, (888, 32, 16, 2, 8)),
            ("pixel", 65536, True, (888, 32, 16, 2, 8))):
        _, items, lanes, slots, chunks, per_block = sample_plan(_fields(data[kind], n, with_next), with_next, n, 132)
        assert (items, lanes, slots, chunks, per_block) == want, (kind, n, with_next)
        assert (lanes * per_block) % 32 == 0 and lanes * per_block <= MAX_GROUP_THREADS
        assert chunks * lanes * slots >= items > (chunks - 1) * lanes * slots
    for n in (1, 3, 5, 1000, 4224, 8448, 2**20):
        for words in (1, 53, 129, 286, 888):
            _, _, lanes, slots, chunks, per_block = sample_plan([(words * 16, 16)], False, n, 132)
            assert (lanes * per_block) % 32 == 0 and chunks * lanes * slots >= words, (n, words)


def test_replay_sample_refuses_offsets_past_32_bits():
    """start and batch must lie in [0, 2**31): the kernel forms the entry and
    its successor in 32 bits."""
    data = {"x": torch.zeros((8, 3))}
    for start, batch in ((-1, 0), (2**31, 0), (0, 2**31)):
        with pytest.raises(ValueError, match=r"2\*\*31"):
            kernels.replay_sample(data, threefry.prng_key(0), 4, 8, start=start, batch=batch)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_flagship_init_matches_plain_on_the_card(cuda, name):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kind in ("bag", "uniform"):
        cfg, pieces, _, _ = _config(name, kind)
        for B in (1, 31, 33, 8192, 65536, sms * INIT_THREADS + 5, 4 * sms + 3):
            keys = batch_keys(threefry.prng_key(B), B, device=cuda)
            got = kernels.flagship_init(keys, cfg, pieces)
            want = engine.init_plain(keys.cpu(), cfg, pieces)
            for k in engine.FIELDS:
                assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), (name, kind, B, k)
            shape = kernels.flagship_init_shape(cfg, pieces, B)
            assert shape == {"envs_per_block": init_envs(B, sms), "threads_per_block": INIT_THREADS,
                             "word_bytes": WORD}, (name, B, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grouped", "board", "pixel"])
def test_replay_sample_matches_plain_on_the_card(cuda, kind):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B, cap = {"grouped": (1024, 131072), "board": (1024, 262144), "pixel": (512, 8192)}[kind]
    g = torch.Generator()
    g.manual_seed(len(kind))
    cpu = _sample_data(kind, cap, g)
    data = {k: v.to(cuda) for k, v in cpu.items()}
    for pos, size in ((B, 2 * B), (cap // 2, cap)):
        buf, pbuf = buffers.ReplayBuffer(data, pos, size), buffers.ReplayBuffer(cpu, pos, size)
        for n in (1, 3, 256, 512, 65536):
            key = threefry.fold_in(threefry.prng_key(9), n + pos)
            start, n_valid = buffers._successor_window(buf, B)
            kc, kn, off = kernels.replay_sample(data, key, n, n_valid, start=start, batch=B, return_offsets=True)
            pc, pn = buffers.sample_with_next_plain(pbuf, key, n, B)
            np.testing.assert_array_equal(off.cpu().numpy(), threefry.randint(key, n, n_valid))
            ks, _, soff = kernels.replay_sample(data, key, n, size, return_offsets=True)
            ps = buffers.sample_plain(pbuf, key, n)
            np.testing.assert_array_equal(soff.cpu().numpy(), threefry.randint(key, n, size))
            for k in data:
                assert torch.equal(kc[k].cpu(), pc[k]) and torch.equal(kn[k].cpu(), pn[k]), (kind, pos, n, k)
                assert torch.equal(ks[k].cpu(), ps[k]), (kind, pos, n, k, "without successors")
            for with_next in (True, False):
                _, items, lanes, slots, chunks, per_block = sample_plan(_fields(cpu, n, with_next), with_next, n, sms)
                assert kernels.replay_sample_shape(data, n, B if with_next else 0) == {
                    "lanes": lanes, "words_per_lane": slots, "chunks": chunks, "units_per_block": per_block,
                    "words": items}
