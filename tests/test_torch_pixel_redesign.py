"""The redesigned ``render_rgb84`` and the lanes builds of ``flagship_step``.

On the CPU:

* the render kernel's arithmetic (``csrc/render_rgb84.cu``): an int32 numpy
  model of its two passes, reading the table that ``kernels._render_table``
  builds (packed row and column taps, the palette as 256-entry channel
  tables, the gray weights), on numpy-seeded mid-game states and stacks at
  10x20 and at every geometry whose composite JAX resizes: equal, bit for
  bit, to ``render_rgb84_plain`` and to JAX's ``preprocess_rgb84(
  render_rgb(state))``, with every partial sum inside int32;
* the wrappers' checks: ``_render_table``'s ``ValueError`` and
  ``TypeError`` as before, ``flagship_step_lanes(B, padded_height)`` a
  build of ``FLAGSHIP_LANES``, the ``lanes`` override refusing other
  values (1 among them), and
  CPU tensors refused.

On a card (marked ``cuda``; they skip without one, decided inside the
test): every ``flagship_step`` build and ``render_rgb84`` against their plain
versions at B = 1, 31, 33, 1001 and 2048 on trajectories and on stacks with
up to six full rows.  This file imports JAX only inside its CPU tests, so
``python -m pytest --noconftest tests/test_torch_pixel_redesign.py -m cuda``
runs on the card's machine.

Every result is an integer or a byte: equal.
"""
import functools

import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.components.tetromino import Tetromino, pieces_from_tetrominoes
from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import engine
from tetris_gymnasium_torch.ops import image, threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.pieces import PIECES

CPU = "cpu"
INT32 = 2**31
_OVERSIZE = [((255, 0, 0), np.array([[1, 1], [1, 1]], np.uint8)),
             ((0, 255, 0), np.ones((1, 6), np.uint8)),
             ((0, 0, 255), np.array([[0, 1, 0], [1, 1, 1], [0, 0, 0]], np.uint8))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oversize(jax_too=False):
    """The 6x6-box set of the JAX package's ``tests/test_components.py:221``."""
    mine, pad = pieces_from_tetrominoes([Tetromino(2 + i, c, m) for i, (c, m) in enumerate(_OVERSIZE)])
    if not jax_too:
        return mine, pad
    from tetris_gymnasium_tpu.components.tetromino import Tetromino as JTetromino
    from tetris_gymnasium_tpu.components.tetromino import pieces_from_tetrominoes as jpieces_from

    theirs, _ = jpieces_from([JTetromino(2 + i, c, m) for i, (c, m) in enumerate(_OVERSIZE)])
    return mine, theirs, pad


# Every geometry of chip_smoke.py's surface_geometries whose composite JAX
# resizes (all of them), with the default board: name -> (config kwargs, 6x6 set?)
GEOMETRIES = {
    "10x20": (dict(auto_reset=True), False),
    "30x20": (dict(width=30, height=20, auto_reset=True), False),
    "61x12": (dict(width=61, height=12, queue_size=3, auto_reset=True), False),
    "28x14": (dict(width=28, height=14, auto_reset=True), False),
    "8x12-uniform": (dict(width=8, height=12, queue_size=2, queue_kind="uniform", auto_reset=True), False),
    "6x6-w10": (dict(width=10, height=16, queue_size=2, queue_kind="uniform", auto_reset=True), True),
    "6x6-w30": (dict(width=30, height=16, queue_size=2, queue_kind="uniform", auto_reset=True), True),
    "queue1-holder2": (dict(queue_size=1, holder_size=2, auto_reset=True), False),
}


def _geometry(name):
    kw, oversize = GEOMETRIES[name]
    if oversize:
        pieces, pad = _oversize()
        return EngineConfig(padding=pad, **kw), pieces
    return EngineConfig(**kw), PIECES


def _played(cfg, pieces, B, steps, seed):
    """A flagship batch after ``steps`` numpy-seeded random actions, biased
    to hard drops and swaps so that stacks and holders fill."""
    rng = np.random.default_rng(seed)
    s = engine.init(batch_keys(threefry.prng_key(seed), B, device=CPU), cfg, pieces, device=CPU)
    for _ in range(steps):
        a = rng.choice(8, B, p=[.1, .1, .05, .1, .05, .35, .15, .1]).astype(np.int32)
        s = engine.step(s, torch.from_numpy(a), cfg, pieces, obs_fn=engine.no_obs)[0]
    return s


def _stacks(cfg, pieces, B, seed):
    """Flagship states on hand-built stacks: random cells below the top
    third, 0..6 full rows at the bottom, a random piece at a random window,
    and ids past the palette in some cells (black in the composite)."""
    rng = np.random.default_rng(seed)
    s = engine.init(batch_keys(threefry.prng_key(seed), B, device=CPU), cfg, pieces, device=CPU)
    H, W, pad = cfg.height, cfg.width, cfg.padding
    inner = np.where(rng.random((B, H, W)) < 0.6, rng.integers(2, 40, (B, H, W)), 0)
    inner[:, : H // 3] = 0
    n_full = rng.integers(0, 7, B)
    full = np.arange(H)[None, :, None] >= H - n_full[:, None, None]
    board = s.board.clone()
    board[:, :H, pad: pad + W] = torch.from_numpy(np.where(full, 2, inner).astype(np.int8))
    n = int(pieces.ids.shape[0])
    return s.replace(
        board=board,
        piece=torch.from_numpy(rng.integers(0, n, B).astype(np.int32)),
        rotation=torch.from_numpy(rng.integers(0, 4, B).astype(np.int32)),
        x=torch.from_numpy(rng.integers(-3, cfg.padded_width, B).astype(np.int32)),
        y=torch.from_numpy(rng.integers(0, 4, B).astype(np.int32)))


def _id_image(s, cfg, pieces) -> np.ndarray:
    """The composite's ids ``uint8[B, H_pad, W_pad + sidebar]`` (what the
    kernel builds in shared memory): the board with the active piece added
    unless it collides, the strips widened with bedrock, bedrock between."""
    d = engine.observe_dict_plain(s, cfg, pieces)
    q, h = d["queue"].numpy(), d["holder"].numpy()
    side = max(q.shape[2], h.shape[2])
    B, H = d["board"].shape[:2]

    def widen(x):
        return np.pad(x, ((0, 0), (0, 0), (0, side - x.shape[2])), constant_values=1)

    sep = np.ones((B, H - 2 * q.shape[1], side), np.uint8)
    return np.concatenate([d["board"].numpy(), np.concatenate([widen(q), sep, widen(h)], 1)], 2)


def _unpack_taps(words):
    w = words.view(np.uint32).astype(np.int64)
    s0, c0, c1 = w & 0xFF, (w >> 8) & 0xFFF, w >> 20
    return s0, s0 + (c1 != 0), c0, c1


def _in_int32(x, what):
    assert int(x.max()) < INT32 and int(x.min()) >= -INT32, f"{what} leaves int32"


def render_model(table, ids, n_palette):
    """``csrc/render_rgb84.cu``'s arithmetic on ``ids uint8[B, H, IW]``,
    from the kernel's table: the horizontal pass into ``h[B, H, 84, 3]``,
    the vertical pass, cv2's rounding, the clip and the gray, in int64 with
    every partial sum checked against int32."""
    t = table.numpy()
    rows, cols = t[:84], t[84:168]
    pal = np.zeros((256, 3), np.int64)  # the kernel's 256-entry channel tables
    pal[:n_palette] = t[168:168 + 3 * n_palette].reshape(n_palette, 3)
    gray = t[168 + 3 * n_palette:].astype(np.int64)
    assert gray.shape == (3,)
    sx0, sx1, cx0, cx1 = _unpack_taps(cols)
    H = ids.shape[1]
    h0 = cx0[None, None, :, None] * pal[ids[:, :, sx0]]
    h1 = cx1[None, None, :, None] * pal[ids[:, :, sx1]]
    h = h0 + h1
    for x, what in ((h0, "cx0 * pal"), (h1, "cx1 * pal"), (h, "h")):
        _in_int32(x, what)
    sy0, sy1, cy0, cy1 = _unpack_taps(rows)
    sy1 = np.minimum(sy1, H - 1)  # the kernel's next row past the last (coefficient 0)
    a0 = cy0[None, :, None, None] * h[:, sy0]
    a1 = cy1[None, :, None, None] * h[:, sy1]
    acc = a0 + a1
    for x, what in ((a0, "cy0 * h"), (a1, "cy1 * h"), (acc, "acc"), (acc + (1 << 21), "acc + 2^21")):
        _in_int32(x, what)
    assert int(acc.min()) >= 0  # so the kernel's clip to [0, 255] is its upper half
    v = np.minimum((acc + (1 << 21)) >> 22, 255)
    g = v[..., 0] * gray[0] + v[..., 1] * gray[1] + v[..., 2] * gray[2]
    _in_int32(g, "gray")
    return (g >> 22).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_render84(name):
    import jax
    from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
    from tetris_gymnasium_tpu.core import engine as jengine
    from tetris_gymnasium_tpu.ops.image import preprocess_rgb84 as jpreprocess
    from tetris_gymnasium_tpu.pieces import PIECES as JPIECES

    kw, oversize = GEOMETRIES[name]
    if oversize:
        _, jpieces, pad = _oversize(jax_too=True)
        jc = JEngineConfig(padding=pad, **kw)
    else:
        jpieces, jc = JPIECES, JEngineConfig(**kw)
    rgb = jax.vmap(functools.partial(jengine.render_rgb, config=jc, pieces=jpieces))
    return jax.jit(lambda s: jpreprocess(rgb(s)))


def _to_jax(s):
    import jax.numpy as jnp
    from tetris_gymnasium_tpu.core import engine as jengine

    fields = {k: np.array(getattr(s, k)) for k in engine.FIELDS}
    fields["key"] = fields["key"].T  # the port keeps the key as [2, B]
    return jengine.EngineState(**{k: jnp.asarray(v) for k, v in fields.items()})


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_render_two_pass_model_is_bit_equal(name):
    """The kernel's two passes, on the table it reads, equal
    ``render_rgb84_plain`` and JAX's chain on mid-game states and stacks."""
    cfg, pieces = _geometry(name)
    table = kernels._render_table(cfg, pieces, CPU)
    n_palette = int(pieces.palette.shape[0])
    for s in (_played(cfg, pieces, 5, 40, 7), _stacks(cfg, pieces, 5, 8)):
        got = render_model(table, _id_image(s, cfg, pieces), n_palette)
        np.testing.assert_array_equal(got, engine.render_rgb84_plain(s, cfg, pieces).numpy())
        np.testing.assert_array_equal(got, np.asarray(_jax_render84(name)(_to_jax(s))))


@pytest.mark.parametrize("name", ["10x20", "61x12", "6x6-w30"])
def test_render_table_holds_the_taps(name):
    """The packed taps decode to ``area_zoom_taps`` of the composite's
    height and width; palette and gray weights follow them."""
    cfg, pieces = _geometry(name)
    t = kernels._render_table(cfg, pieces, CPU).numpy()
    S = int(pieces.matrices.shape[-1])
    widths = (cfg.padded_height, cfg.padded_width + S * max(cfg.queue_size, cfg.holder_size))
    for words, n_src in zip((t[:84], t[84:168]), widths):
        src, coef = image.area_zoom_taps(n_src, 84)
        s0, s1, c0, c1 = _unpack_taps(words)
        np.testing.assert_array_equal(s0, src[:, 0])
        np.testing.assert_array_equal(c0, coef[:, 0])
        np.testing.assert_array_equal(c1, coef[:, 1])
        np.testing.assert_array_equal(np.where(c1 != 0, s1, src[:, 1]), src[:, 1])
    n = int(pieces.palette.shape[0])
    np.testing.assert_array_equal(t[168:168 + 3 * n], pieces.palette.astype(np.int32).ravel())
    np.testing.assert_array_equal(t[168 + 3 * n:], np.asarray(image._W22))


def test_render_table_refuses_as_before():
    """A composite wider than 84 raises JAX's ``ValueError``, a board lower
    than the sidebar's two strips its ``TypeError``, before any launch."""
    wide = EngineConfig(width=80, height=12)
    with pytest.raises(ValueError, match="only enlarges"):
        kernels._render_table(wide, PIECES, CPU)
    with pytest.raises(ValueError, match="only enlarges"):
        kernels.render_rgb84(_played(wide, PIECES, 1, 0, 3), wide, PIECES)
    low = EngineConfig(width=10, height=3)
    with pytest.raises(TypeError, match="lower than"):
        kernels._render_table(low, PIECES, CPU)
    with pytest.raises(TypeError, match="lower than"):
        kernels.render_rgb84(_played(low, PIECES, 1, 0, 3), low, PIECES)


@pytest.mark.parametrize("B", [1, 31, 33, 512, 2048, 65536])
def test_flagship_step_lanes_rule_gives_a_build(B):
    """16 lanes below the crossover; from there 8 where 16 lanes would hold
    more than a row each (10x20 and 30x20 pad to 24 rows), 16 where each
    holds one (61x12 and the 8x12 board pad to 16)."""
    for cfg in (EngineConfig(), EngineConfig(width=30, height=20), EngineConfig(width=61, height=12),
                EngineConfig(width=8, height=12), EngineConfig(height=40)):
        lanes = kernels.flagship_step_lanes(B, cfg.padded_height)
        assert lanes in kernels.FLAGSHIP_LANES
        big = B >= kernels.FLAGSHIP_EIGHT_LANES_FROM_B
        assert lanes == (8 if big and cfg.padded_height > 16 else 16), cfg


@pytest.mark.parametrize("lanes", [0, 1, 2, 4, 32, -8])
def test_flagship_step_refuses_other_lanes(lanes):
    cfg = EngineConfig()
    s = _played(cfg, PIECES, 2, 0, 1)
    with pytest.raises(ValueError, match="lanes must be one of"):
        kernels.flagship_step(s, torch.zeros(2, dtype=torch.int32), cfg, PIECES, RewardsMapping(),
                              lanes=lanes)


@pytest.mark.parametrize("lanes", [None, 8, 16])
def test_kernels_refuse_cpu_tensors(lanes):
    """A CPU state goes to the plain versions through ``engine.step`` and
    ``engine.render_rgb84``; the kernel wrappers refuse it."""
    cfg = EngineConfig()
    s = _played(cfg, PIECES, 2, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flagship_step(s, torch.zeros(2, dtype=torch.int32), cfg, PIECES, RewardsMapping(),
                              lanes=lanes)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.render_rgb84(s, cfg, PIECES)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), what


def _card_stacks(cfg, B, dev, seed):
    s = _stacks(cfg, PIECES, B, seed)
    return s.replace(**{k: getattr(s, k).to(dev) for k in engine.FIELDS})


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 33, 1001, 2048])
def test_flagship_step_builds_match_plain_on_card(cuda, B):
    """Every build of ``flagship_step``: 40 steps of random play (bag queue
    with auto-reset; uniform without gravity), then hand-built stacks with
    up to six full rows, hard drops on half of them."""
    rng = np.random.default_rng(B)
    for cfg in (EngineConfig(auto_reset=True),
                EngineConfig(gravity_enabled=False, queue_kind="uniform")):
        s = engine.init(batch_keys(threefry.prng_key(B), B, device=cuda), cfg, device=cuda)
        for i in range(40):
            a = torch.from_numpy(rng.choice(8, B, p=[.1, .1, .05, .1, .05, .35, .15, .1])
                                 .astype(np.int32)).to(cuda)
            want = engine.step_plain(s, a, cfg)
            for lanes in kernels.FLAGSHIP_LANES:
                got = kernels.flagship_step(s, a, cfg, PIECES, RewardsMapping(), lanes=lanes)
                for k in engine.FIELDS:
                    _equal(getattr(got[0], k), getattr(want[0], k), f"L={lanes} step {i} {k}")
                for j in (1, 2, 3):
                    _equal(got[j], want[j], f"L={lanes} step {i} output {j}")
            s = want[0]
    cfg = EngineConfig(auto_reset=True)
    s = _card_stacks(cfg, B, cuda, 9)
    a = torch.from_numpy(np.where(rng.random(B) < 0.5, 5, rng.integers(0, 8, B)).astype(np.int32)).to(cuda)
    want = engine.step_plain(s, a, cfg)
    for lanes in kernels.FLAGSHIP_LANES:
        got = kernels.flagship_step(s, a, cfg, PIECES, RewardsMapping(), lanes=lanes)
        for k in engine.FIELDS:
            _equal(getattr(got[0], k), getattr(want[0], k), f"L={lanes} stacks {k}")
        for j in (1, 2, 3):
            _equal(got[j], want[j], f"L={lanes} stacks output {j}")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 33, 1001, 2048])
def test_render_rgb84_matches_plain_on_card(cuda, B):
    cfg = EngineConfig(auto_reset=True)
    s = _card_stacks(cfg, B, cuda, 10)
    _equal(kernels.render_rgb84(s, cfg, PIECES), engine.render_rgb84_plain(s, cfg), "stacks")
    rng = np.random.default_rng(B + 1)
    for i in range(20):
        a = torch.from_numpy(rng.choice(8, B, p=[.1, .1, .05, .1, .05, .35, .15, .1])
                             .astype(np.int32)).to(cuda)
        s = kernels.flagship_step(s, a, cfg, PIECES, RewardsMapping())[0]
        _equal(kernels.render_rgb84(s, cfg, PIECES), engine.render_rgb84_plain(s, cfg), f"step {i}")
