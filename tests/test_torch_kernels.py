"""The CUDA kernels against their plain PyTorch versions, and the dispatch.

Tests marked ``cuda`` need a card and skip without one; on a machine with
one they run with ``python -m pytest --noconftest tests/test_torch_kernels.py
-m cuda`` (``tests/conftest.py`` imports JAX, which this file does not need).
The dispatch tests run anywhere: a CPU tensor never reaches a kernel and a
kernel wrapper refuses a CPU tensor.
"""
import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.rl import ppo

NO_LAUNCHES = {"turbo_step": 0, "turbo_init": 0, "observe_board": 0, "gae": 0, "ppo_sample": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_equal(a, b, what):
    if a.dtype in (torch.uint32, torch.float32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), what


@pytest.mark.cuda
@pytest.mark.parametrize(
    "config",
    [EngineConfig(auto_reset=True), EngineConfig(gravity_enabled=False, queue_kind="uniform")],
    ids=["autoreset", "nograv-uniform"],
)
def test_kernels_match_plain(cuda, config):
    B = 1024
    keys = batch_keys(prng_key(3), B, device=cuda)
    s = turbo.init(keys, config, device=cuda)
    for k in turbo.FIELDS:
        _assert_equal(getattr(s, k), getattr(turbo.init_plain(keys, config), k), f"init {k}")
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    for i in range(150):
        _assert_equal(turbo.observe_board(s, config), turbo.observe_board_plain(s, config), f"obs {i}")
        a = torch.randint(0, 8, (B,), generator=g, device=cuda, dtype=torch.int32)
        ks, _, kr, kd, kinfo = turbo.step(s, a, config)
        ps, pr, pd, pl = turbo.step_plain(s, a, config)
        for k in turbo.FIELDS:
            _assert_equal(getattr(ks, k), getattr(ps, k), f"{k} @ {i}")
        for got, want, name in ((kr, pr, "reward"), (kd, pd, "done"), (kinfo["lines_cleared"], pl, "lines")):
            _assert_equal(got, want, f"{name} @ {i}")
        s = ks


@pytest.mark.cuda
def test_launch_counts(cuda):
    config = EngineConfig()
    kernels.reset_launches()
    s = turbo.init(batch_keys(prng_key(0), 64, device=cuda), config, device=cuda)
    for _ in range(3):
        turbo.observe_board(s, config)
        s = turbo.step(s, torch.zeros(64, dtype=torch.int32, device=cuda), config)[0]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**NO_LAUNCHES, "turbo_step": 3, "turbo_init": 1, "observe_board": 3}


def test_cpu_tensors_run_the_plain_versions():
    config = EngineConfig(auto_reset=True)
    kernels.reset_launches()
    s = turbo.init(batch_keys(prng_key(0), 8, device="cpu"), config, device="cpu")
    turbo.observe_board(s, config)
    s, _, r, d, _ = turbo.step(s, torch.full((8,), 5, dtype=torch.int32), config)
    assert kernels.LAUNCHES == NO_LAUNCHES
    assert s.rows.device.type == "cpu" and r.dtype == torch.float32 and d.dtype == torch.bool


def test_kernel_wrappers_refuse_cpu_tensors():
    config = EngineConfig()
    s = turbo.init(batch_keys(prng_key(0), 4, device="cpu"), config, device="cpu")
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.turbo_step(s, a, config, turbo.PIECES, RewardsMapping())
    with pytest.raises(ValueError, match="CUDA"):
        kernels.turbo_init(torch.from_numpy(np.zeros((4, 2), np.uint32)), config, turbo.PIECES)
    with pytest.raises(ValueError):
        kernels.observe_board(s, config, turbo.PIECES)


@pytest.mark.cuda
@pytest.mark.parametrize("T, B, p_done", [(128, 8192, 1 / 200), (16, 1, 0.5), (7, 1000, 1.0)])
def test_gae_kernel_bit_equal_to_plain(cuda, T, B, p_done):
    g = torch.Generator(device=cuda)
    g.manual_seed(T + B)
    reward = torch.randn((T, B), generator=g, device=cuda)
    value = torch.randn((T, B), generator=g, device=cuda)
    done = torch.rand((T, B), generator=g, device=cuda) < p_done
    last = torch.randn((B,), generator=g, device=cuda)
    got = kernels.gae(reward, value, done, last, 0.999, 0.95)
    want = ppo.gae_plain(reward, value, done, last, 0.999, 0.95)
    for a, b in zip(got, want):
        _assert_equal(a, b, "gae")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 1001, 8192])
def test_sample_kernel_matches_plain(cuda, B):
    g = torch.Generator(device=cuda)
    g.manual_seed(B)
    for scale in (0.01, 1.0, 30.0):
        logits = torch.randn((B, 8), generator=g, device=cuda) * scale
        for seed in range(4):
            key = prng_key(seed)
            a, lp = kernels.sample_actions(logits, key)
            pa, plp = ppo.sample_actions_plain(logits, key)
            _assert_equal(a, pa, "action")
            torch.testing.assert_close(lp, plp, rtol=0, atol=1e-6)


def test_ppo_dispatch_runs_plain_versions_on_cpu():
    kernels.reset_launches()
    reward = torch.zeros((4, 3))
    adv, tgt = ppo.gae(ppo.PPOConfig(), ppo.Transition(None, None, None, reward, reward,
                                                        reward.bool()), torch.zeros(3))
    a, lp = ppo.sample_actions(torch.zeros((3, 8)), prng_key(0))
    assert kernels.LAUNCHES == NO_LAUNCHES and adv.shape == (4, 3) and a.shape == (3,)


def test_ppo_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gae(x, x, x.bool(), torch.zeros(3), 0.99, 0.95)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.sample_actions(torch.zeros((3, 8)), prng_key(0))
    with pytest.raises(NotImplementedError):
        kernels.sample_actions(torch.zeros((3, 5)), prng_key(0))


def test_step_kernel_refuses_other_geometry():
    with pytest.raises(NotImplementedError):
        kernels._check_step_config(EngineConfig(width=8), kernels.bb.turbo_tables())
    with pytest.raises(NotImplementedError):
        kernels._check_step_config(EngineConfig(queue_size=5), kernels.bb.turbo_tables())


def test_library_names_follow_the_sources():
    """A changed source or flag set builds a new library instead of reusing a stale one."""
    paths = {name: kernels._lib_path(src) for name, src in kernels.SOURCES.items()}
    assert len(set(paths.values())) == len(paths)
    for name, p in paths.items():
        assert p.parent == kernels.BUILD_DIR and p.name.startswith(kernels.SOURCES[name].stem)
