"""The PyTorch ActorCriticCNN against the Flax one, and the exported weights.

Both sides run in float32 (``dtype=float32``) on the same random boards
with values in {-1, 0, 1}; logits and values must agree to 1e-5 of the
output's scale (its largest magnitude, at least 1).  The reason is float32
rounding in sums of up to 1152 terms, taken in another order by XLA and
PyTorch: with the committed weights (logits up to ~130) each side lies
within 4e-5 of a float64 evaluation of the same network.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.models import ActorCriticCNN as FlaxActorCritic
from tetris_gymnasium_tpu.utils import checkpoint as jckpt

from tetris_gymnasium_torch.models.convert import from_flax_params
from tetris_gymnasium_torch.models.networks import ActorCriticCNN, same_pads
from tetris_gymnasium_torch.utils.checkpoint import load_actor_critic, load_flat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "ppo_lines.npz")
EXPORTED = os.path.join(REPO, "results", "ppo_lines_params.npz")
REL = 1e-5


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale)


def _boards(seed, B=32):
    return np.random.default_rng(seed).integers(-1, 2, size=(B, 20, 10)).astype(np.int8)


def _flat(params):
    return {
        "/".join(str(p.key) for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _compare(params, boards):
    fnet = FlaxActorCritic(dtype=jnp.float32)
    want_logits, want_value = fnet.apply(params, jnp.asarray(boards))
    tnet = ActorCriticCNN(dtype=torch.float32)
    tnet.load_state_dict(from_flax_params(_flat(params)))
    with torch.no_grad():
        logits, value = tnet(torch.from_numpy(boards))
    assert logits.dtype == torch.float32 and logits.shape == (boards.shape[0], 8)
    assert value.shape == (boards.shape[0],)
    _close(logits.numpy(), np.asarray(want_logits))
    _close(value.numpy(), np.asarray(want_value))
    return logits


def test_same_pads_match_flax_plan():
    """The asymmetric SAME padding of the three stride-2 convolutions."""
    assert same_pads(20, 3, 2) == (0, 1, 10)  # Conv_0 rows
    assert same_pads(10, 3, 1) == (1, 1, 10)  # Conv_0 columns
    assert same_pads(10, 3, 2) == (0, 1, 5)  # Conv_1
    assert same_pads(5, 3, 2) == (1, 1, 3)  # Conv_2


@pytest.mark.parametrize("seed", [0, 1])
def test_random_params_match_flax(seed):
    params = FlaxActorCritic(dtype=jnp.float32).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 20, 10), jnp.int8)
    )
    # scale the small orthogonal policy head up so the comparison has teeth
    params = jax.tree_util.tree_map(lambda x: x * 3.0, params)
    _compare(params, _boards(seed))


def test_committed_checkpoint_matches_flax():
    fnet = FlaxActorCritic(dtype=jnp.float32)
    template = fnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 20, 10), jnp.int8))
    params = jckpt.restore(CKPT, template)
    logits = _compare(params, _boards(7))
    assert logits.abs().max() > 1.0  # trained weights, not a zero head
    # the exported file carries the same weights
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(load_flat(EXPORTED)[k], v)
    net = load_actor_critic(EXPORTED, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        got, _ = net(torch.from_numpy(_boards(7)))
    np.testing.assert_array_equal(got.numpy(), logits.numpy())


def test_exported_file_equals_fresh_export(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "export_torch_params", os.path.join(REPO, "tools", "export_torch_params.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "params.npz"
    mod.export(CKPT, str(out))
    fresh, committed = load_flat(str(out)), load_flat(EXPORTED)
    assert sorted(fresh) == sorted(committed) and len(fresh) == 12
    for k in fresh:
        assert fresh[k].dtype == np.float32
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)


def test_converter_rejects_wrong_keys():
    flat = load_flat(EXPORTED)
    flat.pop("params/Dense_1/bias")
    with pytest.raises(KeyError, match="missing"):
        from_flax_params(flat)


def test_bf16_trunk_is_close_to_fp32():
    """The default bf16 trunk stays near the fp32 one (about 3 significant digits)."""
    boards = torch.from_numpy(_boards(3))
    f32 = load_actor_critic(EXPORTED, device="cpu", dtype=torch.float32)
    b16 = load_actor_critic(EXPORTED, device="cpu")
    with torch.no_grad():
        a, _ = f32(boards)
        b, _ = b16(boards)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0.05, atol=0.5)
