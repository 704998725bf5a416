"""The ``jax.random`` draws of PPO, ported to numpy and PyTorch, against JAX.

Keys, bits, uniforms and permutations must be bit-equal to JAX's; the
Gumbel noise and log-probs go through ``log`` and ``exp``, whose last bit
differs between XLA and PyTorch on the CPU, so the sampled actions must be
equal and the log-probs within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.rl.ppo import sample_actions, sample_actions_plain

SEEDS = [0, 7, 2**32 - 1]


def _u32(x):
    return np.asarray(x).view(np.uint32)


def test_jax_uses_the_partitionable_threefry():
    """The port follows JAX's draws under this flag; a change of it must fail here."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert not jax.config.jax_high_dynamic_range_gumbel  # categorical's gumbel mode "low"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [2, 3, 8])
def test_split_matches_jax(seed, n):
    key = jax.random.PRNGKey(seed)
    got = threefry.split(np.asarray(key), n)
    np.testing.assert_array_equal(got, np.asarray(jax.random.split(key, n)))
    # split's blocks are fold_in's: the same threefry block [0, i]
    folded = np.stack([np.asarray(jax.random.fold_in(key, i)) for i in range(n)])
    np.testing.assert_array_equal(got, folded)
    np.testing.assert_array_equal(threefry.fold_in(np.asarray(key), np.arange(n)), folded)


@pytest.mark.parametrize("n", [8, 100, 16384])
def test_bits_uniform_permutation_match_jax(n):
    key = jax.random.PRNGKey(11)
    k = np.asarray(key)
    bits = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
    np.testing.assert_array_equal(threefry.random_bits32(k, n), bits)
    lanes = threefry.random_bits32_lanes(k, torch.arange(n, dtype=torch.int64))
    np.testing.assert_array_equal(lanes.numpy().astype(np.uint32), bits)

    for lo, hi in ((0.0, 1.0), (threefry.TINY, 1.0), (-3.0, 5.0)):
        want = _u32(jax.random.uniform(key, (n,), minval=lo, maxval=hi))
        np.testing.assert_array_equal(_u32(threefry.uniform(k, n, lo, hi)), want)
        got = threefry.bits_to_uniform_lanes(lanes, lo, hi)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_u32(got.numpy()), want)

    perm = np.asarray(jax.random.permutation(key, n))
    np.testing.assert_array_equal(threefry.permutation(k, n), perm)
    np.testing.assert_array_equal(threefry.permutation_lanes(k, n, "cpu").numpy(), perm)


def test_shuffle_rounds_follow_jax():
    assert [threefry.shuffle_rounds(n) for n in (1, 8, 1625, 1626, 16384)] == [0, 1, 1, 2, 2]


def test_gumbel_close_to_jax():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.gumbel(key, (4096,)))
    got = threefry.gumbel_lanes(np.asarray(key), torch.arange(4096)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(threefry.gumbel(np.asarray(key), 4096), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_sample_actions_plain_matches_jax(scale):
    """``categorical`` + ``log_softmax`` of ``ppo.py:186-187`` on the same key."""
    rng = np.random.default_rng(int(scale * 100))
    logits = (rng.standard_normal((512, 8)) * scale).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want_a = np.asarray(jax.random.categorical(key, jnp.asarray(logits))).astype(np.int32)
        want_lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))[np.arange(512), want_a]
        action, log_prob = sample_actions_plain(torch.from_numpy(logits), np.asarray(key))
        assert action.dtype == torch.int32 and log_prob.dtype == torch.float32
        np.testing.assert_array_equal(action.numpy(), want_a)
        np.testing.assert_allclose(log_prob.numpy(), want_lp, rtol=1e-6, atol=1e-6)


def test_sample_actions_ties_take_the_lowest_index():
    """Equal logits and equal noise: argmax keeps the first index, as ``jnp.argmax``."""
    logits = torch.zeros((4, 8))
    action, log_prob = sample_actions(logits, threefry.prng_key(0))
    assert (action >= 0).all() and (action < 8).all()
    np.testing.assert_allclose(log_prob.numpy(), np.full(4, -np.log(8.0)), rtol=1e-6)
    big = torch.full((3, 8), -1e30)
    big[:, 5] = 0.0
    assert sample_actions(big, threefry.prng_key(1))[0].tolist() == [5, 5, 5]


def test_sample_actions_plain_any_width():
    """The plain version pads its pairwise sum with exact zeros for widths that
    are not a power of two."""
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 5)).astype(np.float32))
    _, log_prob = sample_actions_plain(logits, threefry.prng_key(2))
    assert torch.isfinite(log_prob).all() and (log_prob <= 0).all()
