"""The port's components against the JAX package's, on the CPU.

Mirrors ``tests/test_components.py``: the host randomizers (the same
numpy streams as JAX's from the same seeds), queue and holder, the draw
registry, custom piece sets compiled to the same tables, and the shell
configured by injected components, a custom and an oversize piece set
included (the plain versions on the CPU).
"""
import copy

import jax
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu import components as jcomp
from tetris_gymnasium_tpu.envs.gym_env import Tetris as JTetris

from tetris_gymnasium_torch.components import (
    BagRandomizer,
    Tetromino,
    TetrominoHolder,
    TetrominoQueue,
    TrueRandomizer,
    bag_draw,
    default_tetrominoes,
    get_draw_fn,
    pieces_from_tetrominoes,
    register_randomizer,
    uniform_draw,
    unregister_randomizer,
)
from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.core import engine
from tetris_gymnasium_torch.envs import Tetris
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.pieces import PIECES

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: the suite's workers
    share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("kind", ["bag", "true"])
def test_host_randomizers_equal_jax(kind):
    """Same seed, same host stream as the JAX package's classes, across a
    seeded reset, an unseeded one and a copy."""
    mine = {"bag": BagRandomizer, "true": TrueRandomizer}[kind](7)
    theirs = {"bag": jcomp.BagRandomizer, "true": jcomp.TrueRandomizer}[kind](7)
    mine.reset(seed=42)
    theirs.reset(seed=42)
    assert [mine.get_next_tetromino() for _ in range(30)] == \
        [theirs.get_next_tetromino() for _ in range(30)]
    mine.reset()
    theirs.reset()
    assert [mine.get_next_tetromino() for _ in range(20)] == \
        [theirs.get_next_tetromino() for _ in range(20)]
    a, b = copy.copy(mine), copy.copy(theirs)
    assert [a.get_next_tetromino() for _ in range(10)] == [b.get_next_tetromino() for _ in range(10)]
    assert mine.engine_kind == theirs.engine_kind


def test_bag_completeness_and_seed_determinism():
    r = BagRandomizer(7)
    r.reset(seed=42)
    for _ in range(5):
        assert sorted(r.get_next_tetromino() for _ in range(7)) == list(range(7))
    a, b = BagRandomizer(7), BagRandomizer(7)
    a.reset(seed=7)
    b.reset(seed=7)
    a.get_next_tetromino()
    a.reset()
    b.get_next_tetromino()
    b.reset()
    assert [a.get_next_tetromino() for _ in range(14)] == [b.get_next_tetromino() for _ in range(14)]


def test_true_randomizer_range():
    r = TrueRandomizer(7)
    r.reset(seed=1)
    assert {r.get_next_tetromino() for _ in range(500)} == set(range(7))


def test_queue_fifo_matches_randomizer_stream():
    q = TetrominoQueue(BagRandomizer(7), size=4)
    q.reset(seed=11)
    r2 = BagRandomizer(7)
    r2.reset(seed=11)
    stream = [r2.get_next_tetromino() for _ in range(20)]
    head = q.get_queue()[0]
    got = [q.get_next_tetromino() for _ in range(16)]
    assert got[0] == head and got == stream[:16] and len(q.get_queue()) == 4


def test_holder_swap_reset_and_copy():
    h = TetrominoHolder(size=2)
    assert h.swap("a") is None and h.swap("b") is None
    assert h.swap("c") == "a" and h.get_tetrominoes() == ["b", "c"]
    h1 = TetrominoHolder(size=1)
    h1.swap("x")
    h2 = copy.copy(h1)
    h1.reset()
    assert h1.get_tetrominoes() == [] and h2.get_tetrominoes() == ["x"]


def test_draw_registry():
    assert get_draw_fn("bag") is bag_draw and get_draw_fn("uniform") is uniform_draw
    with pytest.raises(KeyError):
        get_draw_fn("nope")

    def always_o(bag, bag_index, key):
        return torch.ones_like(bag_index), bag, bag_index, key  # piece 1 = O

    register_randomizer("always_o", always_o)
    try:
        config = EngineConfig(queue_kind="always_o", queue_size=2)
        s = engine.init(np.array([[0, 3], [0, 4]], dtype=np.uint32), config, device="cpu")
        assert s.piece.tolist() == [1, 1] and bool((s.queue == 1).all())
    finally:
        unregister_randomizer("always_o")
    with pytest.raises(KeyError):
        get_draw_fn("always_o")


def test_custom_pieces_compile_like_jax():
    pieces, padding = pieces_from_tetrominoes(default_tetrominoes())
    assert padding == 4
    for k in ("ids", "matrices", "colors", "box", "base_colors"):
        np.testing.assert_array_equal(getattr(pieces, k), getattr(PIECES, k))
    tets = [Tetromino(0, [255, 0, 0], np.array([[1]])), Tetromino(1, [0, 255, 0], np.array([[1, 1, 1]]))]
    jtets = [jcomp.Tetromino(t.id, list(t.color_rgb), t.matrix.copy()) for t in tets]
    mine, pad = pieces_from_tetrominoes(tets)
    theirs, jpad = jcomp.pieces_from_tetrominoes(jtets)
    assert pad == jpad == 3
    for k in ("ids", "matrices", "colors", "box", "base_colors"):
        np.testing.assert_array_equal(getattr(mine, k), np.asarray(getattr(theirs, k)))


def test_injected_components_configure_the_shell():
    env = Tetris(queue=TetrominoQueue(TrueRandomizer(7), size=6), holder=TetrominoHolder(size=2),
                 device="cpu")
    assert (env.config.queue_size, env.config.holder_size, env.config.queue_kind) == (6, 2, "uniform")
    obs, _ = env.reset(seed=0)
    assert obs["queue"].shape == (4, 24) and obs["holder"].shape == (4, 8)


@pytest.mark.parametrize("oversize", [False, True], ids=["custom", "oversize"])
def test_custom_piece_set_plays_like_jax_shell(oversize):
    """A custom set (and one with a 6-wide piece) in the shell on the CPU:
    the same episode as the JAX shell's."""
    mats = [np.ones((2, 2)), np.array([[0, 1, 0], [1, 1, 1], [0, 0, 0]])]
    if oversize:
        mats.append(np.ones((1, 6)))
    colors = [[255, 0, 0], [0, 255, 0], [0, 0, 255]]
    kw = dict(width=12, height=14, randomizer="uniform", gravity=False)
    env = Tetris(tetrominoes=[Tetromino(i, colors[i], m) for i, m in enumerate(mats)], device="cpu",
                 render_mode="rgb_array", **kw)
    jenv = JTetris(tetrominoes=[jcomp.Tetromino(i, colors[i], m) for i, m in enumerate(mats)],
                   render_mode="rgb_array", **kw)
    o, _ = env.reset(seed=4)
    jo, _ = jenv.reset(seed=4)
    rng = np.random.default_rng(4)
    for i in range(40):
        for k in jo:
            np.testing.assert_array_equal(o[k], jo[k], err_msg=f"{k} @ {i}")
        a = int(rng.choice(8, p=[.15, .15, .1, .1, .1, .3, .05, .05]))
        o, r, t, _, info = env.step(a)
        jo, jr, jt, _, jinfo = jenv.step(a)
        assert (r, t, info) == (jr, jt, jinfo), i
        if t:
            break
    np.testing.assert_array_equal(env.render(), jenv.render())
