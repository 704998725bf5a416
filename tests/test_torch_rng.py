"""The port's counter RNG, randomizers and per-env keys against JAX's.

The plain PyTorch versions work on int64 lanes holding 32-bit values; every
output must be bit-equal to the JAX function on the same ``[2, B]`` keys,
which are made with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.components import tetromino_randomizer as jrand
from tetris_gymnasium_tpu.ops import rng as jrng
from tetris_gymnasium_tpu.parallel.mesh import batch_keys as jbatch_keys

from tetris_gymnasium_torch.components import tetromino_randomizer as trand
from tetris_gymnasium_torch.ops import rng as trng
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.parallel.mesh import batch_keys

B = 257


def _keys(seed):
    """``uint32[2, B]`` keys covering carries: counter words near 2**32."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**32, size=(2, B), dtype=np.uint64).astype(np.uint32)
    k[0, :16] = np.uint32(0xFFFFFFFF) - np.arange(16, dtype=np.uint32)  # Weyl carry
    k[1, 16:24] = np.uint32(0xFFFFFFFF)
    return k


def _lanes(a):
    return torch.from_numpy(a.astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_fmix32_matches_jax():
    x = _keys(0).reshape(-1)
    np.testing.assert_array_equal(_u32(trng.fmix32(_lanes(x))), np.asarray(jrng.fmix32(jnp.asarray(x))))


def test_next_bits_stream_matches_jax():
    k = _keys(1)
    jk, tk = jnp.asarray(k), _lanes(k)
    for _ in range(20):
        jk, jb = jrng.next_bits(jk)
        tk, tb = trng.next_bits(tk)
        np.testing.assert_array_equal(_u32(tb), np.asarray(jb))
        np.testing.assert_array_equal(_u32(tk), np.asarray(jk))


@pytest.mark.parametrize("n", [2, 7, 13])
def test_randint_matches_jax(n):
    k = _keys(2)
    jk, tk = jnp.asarray(k), _lanes(k)
    for _ in range(10):
        jk, jv = jrng.randint(jk, n)
        tk, tv = trng.randint(tk, n)
        assert tv.dtype == torch.int32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(_u32(tk), np.asarray(jk))


@pytest.mark.parametrize("n", [4, 7])
def test_shuffle_matches_jax(n):
    k = _keys(3)
    jk, jp = jrng.shuffle(jnp.asarray(k), n)
    tk, tp = trng.shuffle(_lanes(k), n)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    assert (np.sort(tp.numpy(), axis=0) == np.arange(n)[:, None]).all()


@pytest.mark.parametrize("kind", ["bag", "uniform"])
def test_draw_stream_matches_jax(kind):
    """40 draws in a row from mixed bag positions: pieces, bags, indices, keys."""
    rng = np.random.default_rng(4)
    k = _keys(5)
    bag = np.stack([rng.permutation(7) for _ in range(B)], axis=1).astype(np.int32)
    idx = rng.integers(0, 8, size=B).astype(np.int32)
    jdraw, tdraw = jrand.get_draw_fn(kind), trand.get_draw_fn(kind)
    jstate = (jnp.asarray(bag), jnp.asarray(idx), jnp.asarray(k))
    tstate = (torch.from_numpy(bag), torch.from_numpy(idx), _lanes(k))
    for _ in range(40):
        jp, *jstate = jdraw(*jstate)
        tp, *tstate = tdraw(*tstate)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tstate[0].numpy(), np.asarray(jstate[0]))
        np.testing.assert_array_equal(tstate[1].numpy(), np.asarray(jstate[1]))
        np.testing.assert_array_equal(_u32(tstate[2]), np.asarray(jstate[2]))


def test_bag_draw_key_advances_only_on_refill():
    k = _lanes(_keys(6))
    bag = torch.arange(7, dtype=torch.int32)[:, None].expand(7, B).contiguous()
    idx = torch.where(torch.arange(B) % 2 == 0, 7, 3).to(torch.int32)
    _, _, _, k2 = trand.bag_draw(bag, idx, k)
    refill = (idx >= 7).numpy()
    assert (k2.numpy()[:, ~refill] == k.numpy()[:, ~refill]).all()
    assert (k2.numpy()[:, refill] != k.numpy()[:, refill]).any(axis=0).all()


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 7, 2**32 - 1])
def test_batch_keys_match_jax(seed):
    want = np.asarray(jbatch_keys(jax.random.PRNGKey(seed), 100))
    np.testing.assert_array_equal(threefry.prng_key(seed), np.asarray(jax.random.PRNGKey(seed)))
    got = batch_keys(threefry.prng_key(seed), 100, device="cpu")
    assert got.dtype == torch.uint32 and got.shape == (100, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prng_key_rejects_wide_seed():
    with pytest.raises(ValueError):
        threefry.prng_key(2**32)
