"""The port's exact grayscale against the JAX one, on the CPU.

``grayscale_u8_exact`` (the plain version, what the port runs on CPU
tensors) must equal ``tetris_gymnasium_tpu.ops.image.grayscale_u8_exact``
bit for bit on the inputs of ``tests/test_image_ops.py:59-98``: the random
64x64 image with its pinned corners, and the four r-slices of all (g, b)
pairs, 262,144 triples.  Its limb tables equal JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.ops import image as jimage

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.ops import image

WEIGHTS = np.array([0.2125, 0.7154, 0.0721])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gray_tables_match_jax():
    for got, want in zip(image._gray_tables(), jimage._gray_tables()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_random_image_matches_jax():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    rgb[0, 0] = (255, 255, 255)
    rgb[0, 1] = (0, 0, 0)
    kernels.reset_launches()
    got = image.grayscale_u8_exact(torch.from_numpy(rgb))
    assert kernels.LAUNCHES["grayscale_u8_exact"] == 0  # a CPU tensor runs the plain version
    want = np.asarray(jax.jit(jimage.grayscale_u8_exact)(jnp.asarray(rgb)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.sum(np.multiply(rgb, WEIGHTS), axis=-1).astype(np.uint8))


@pytest.mark.parametrize("r", [0, 17, 128, 255])
def test_r_slice_matches_jax(r):
    """All (g, b) pairs at one r: bit-equal to JAX, and off numpy's float64
    value only where numpy's own additions round onto an integer."""
    g, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    rgb = np.stack([np.full_like(g, r), g, b], axis=-1).astype(np.uint8)
    got = image.grayscale_u8_exact(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jimage.grayscale_u8_exact(jnp.asarray(rgb))))
    want = np.sum(np.multiply(rgb, WEIGHTS), axis=-1).astype(np.uint8)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert int((got != want).sum()) <= 8


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernels.grayscale_u8_exact(torch.zeros((4, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match=r"\[\.\.\., 3\]"):
        kernels.grayscale_u8_exact(torch.zeros((4, 2), dtype=torch.uint8))
