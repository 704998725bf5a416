"""Greedy evaluation of the committed PPO policy: PyTorch port against JAX.

Both sides run the network in float32 from the same checkpoint and the
same per-env keys (seed 0), 8 episodes of at most 400 steps (the policy
lasts about 223 steps a game), and must report the same episodic
statistics.  The engine is bit-equal and the logits agree to float32
rounding, so the greedy games are identical unless an argmax is a near-tie.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_gymnasium_tpu.config import EngineConfig as JEngineConfig
from tetris_gymnasium_tpu.models import ActorCriticCNN as FlaxActorCritic
from tetris_gymnasium_tpu.rl import evaluate as jevaluate
from tetris_gymnasium_tpu.utils import checkpoint as jckpt

from tetris_gymnasium_torch.config import EngineConfig
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.rl import evaluate
from tetris_gymnasium_torch.utils.checkpoint import load_actor_critic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPISODES, MAX_STEPS, SEED = 8, 400, 0


@pytest.fixture(scope="module")
def jax_stats():
    net = FlaxActorCritic(dtype=jnp.float32)
    template = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 20, 10), jnp.int8))
    params = jckpt.restore(os.path.join(REPO, "results", "ppo_lines.npz"), template)
    out = jax.jit(
        lambda p, key: jevaluate.evaluate_policy(
            jevaluate.greedy_logits(net, p), EPISODES, JEngineConfig(), key, max_steps=MAX_STEPS
        )
    )(params, jax.random.PRNGKey(SEED))
    return {k: np.asarray(v) for k, v in jax.device_get(out).items()}


@pytest.fixture(scope="module")
def torch_stats():
    net = load_actor_critic(
        os.path.join(REPO, "results", "ppo_lines_params.npz"), device="cpu", dtype=torch.float32
    )
    return evaluate.evaluate_policy(
        evaluate.greedy_logits(net), EPISODES, EngineConfig(), prng_key(SEED),
        max_steps=MAX_STEPS, device="cpu",
    )


@pytest.mark.parametrize(
    "key", ["lines_mean", "length_mean", "return_mean", "episodes_completed", "truncated"]
)
def test_stats_equal_jax(jax_stats, torch_stats, key):
    assert torch_stats[key] == pytest.approx(float(jax_stats[key]), rel=0, abs=0)


def test_policy_plays(torch_stats):
    """Most games end inside the cap and the policy clears lines."""
    assert torch_stats["episodes_completed"] >= 6
    assert torch_stats["lines_mean"] > 3
    assert 1 <= torch_stats["iterations"] <= MAX_STEPS
    assert torch_stats["lines_std"] >= 0


def test_stats_of_frozen_states():
    """_stats on a hand-made batch: only finished games count."""
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    s = turbo.init(batch_keys(prng_key(0), 4, device="cpu"), EngineConfig(), device="cpu")
    s = s.replace(
        game_over=torch.tensor([True, True, False, False]),
        lines=torch.tensor([2, 4, 100, 100], dtype=torch.int32),
        steps=torch.tensor([10, 30, 5, 5], dtype=torch.int32),
        score=torch.tensor([1.0, 3.0, 9.0, 9.0]),
    )
    st = evaluate._stats(s, 7)
    assert st["episodes_completed"] == 2 and st["truncated"] == 2
    assert st["lines_mean"] == 3.0 and st["length_mean"] == 20.0 and st["return_mean"] == 2.0
    assert (st["return_min"], st["return_max"], st["lines_std"]) == (1.0, 3.0, 1.0)
    assert st["max_steps"] == 7 and st["completed_frac"] == 0.5


def test_unported_paths_raise():
    """The flagship engine and its rgb84 frames are ported, and PPO on them
    (the AtariActorCritic) builds; the frames stay flagship-only (a
    ValueError, as in JAX) and unknown observation kinds raise."""
    from tetris_gymnasium_torch.models.networks import AtariActorCritic
    from tetris_gymnasium_torch.rl import ppo
    from tetris_gymnasium_torch.rl.engines import env_fns

    assert len(env_fns(EngineConfig(), "flagship", obs="rgb84", device="cpu")) == 3
    with pytest.raises(ValueError, match="flagship"):
        env_fns(EngineConfig(), "turbo", obs="rgb84", device="cpu")
    ts = ppo.init_train_state(prng_key(0), 4, EngineConfig(auto_reset=True), ppo.PPOConfig(),
                              impl="flagship", obs="rgb84", device="cpu")
    assert isinstance(ts.net, AtariActorCritic) and ts.last_obs.shape == (4, 84, 84)
    with pytest.raises(ValueError, match="flagship"):
        ppo.init_train_state(prng_key(0), 4, EngineConfig(auto_reset=True), ppo.PPOConfig(),
                             impl="turbo", obs="rgb84", device="cpu")
    with pytest.raises(ValueError):
        env_fns(EngineConfig(), "turbo", obs="pixels", device="cpu")
