"""The CUDA kernels against their plain PyTorch versions, and the dispatch.

Tests marked ``cuda`` need a card and skip without one; on a machine with
one they run with ``python -m pytest --noconftest tests/test_torch_kernels.py
-m cuda`` (``tests/conftest.py`` imports JAX, which this file does not need).
The dispatch tests run anywhere: a CPU tensor never reaches a kernel and a
kernel wrapper refuses a CPU tensor.
"""
import shutil

import numpy as np
import pytest
import torch

from tetris_gymnasium_torch import kernels
from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.core import turbo_grouped as tg
from tetris_gymnasium_torch.ops import threefry
from tetris_gymnasium_torch.ops.threefry import prng_key
from tetris_gymnasium_torch.parallel.mesh import batch_keys
from tetris_gymnasium_torch.ops import framestack
from tetris_gymnasium_torch.rl import buffers, dqn, grouped_dqn, ppo

NO_LAUNCHES = {name: 0 for name in kernels.LAUNCHES}


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
    """Each geometry maps to the defines of its own build, and a config past
    a static limit of the engine kernels raises naming that limit."""
    tables = kernels.bb.turbo_tables()
    default = dict(kernels.engine_defines(EngineConfig(), tables))
    assert default == {"TETRIS_HEIGHT": 20, "TETRIS_WIDTH": 10, "TETRIS_PAD": 4, "TETRIS_QS": 4,
                       "TETRIS_HS": 1, "TETRIS_NP": 7, "TETRIS_S": 4}
    wide = dict(kernels.engine_defines(EngineConfig(width=61, height=12, queue_size=3), tables))
    assert wide == {**default, "TETRIS_HEIGHT": 12, "TETRIS_WIDTH": 61, "TETRIS_QS": 3}
    # every geometry of the JAX package's tests (the 6x6 pieces' padding 6 among them)
    for kw in (dict(width=30, height=20), dict(width=28, height=14), dict(width=14, height=30),
               dict(width=8, height=12, queue_size=2, queue_kind="uniform"),
               dict(queue_size=7, holder_size=2), dict(width=6, height=8), dict(width=7, height=12),
               dict(width=9, height=15, queue_size=3), dict(width=14, height=24),
               dict(width=30, height=10), dict(width=40, height=14, padding=6, queue_size=2),
               dict(width=30, height=16, padding=6, queue_size=2), dict(width=6, height=8, padding=2)):
        assert kernels.engine_defines(EngineConfig(**kw), tables, flagship=True)
    src = kernels.SOURCES["turbo_step"]
    paths = {kernels._lib_path(src, kernels.engine_defines(EngineConfig(width=w), tables))
             for w in (10, 30, 61)}
    assert len(paths) == 3 and kernels._lib_path(src) not in paths
    assert kernels.engine_defines(EngineConfig(width=60, height=40), tables, flagship=True)
    for kw, flagship, why in ((dict(height=61), False, "padded height 65"),
                              (dict(width=121), False, "padded width 129"),
                              (dict(width=70, height=40), True, "padded board of 3432 cells"),
                              (dict(queue_size=17), False, "queue size 17"),
                              (dict(holder_size=0), False, "holder size 0"),
                              (dict(queue_kind="always_o"), False, "queue_kind")):
        with pytest.raises(NotImplementedError, match=why):
            kernels.engine_defines(EngineConfig(**kw), tables, flagship=flagship)


def test_library_names_follow_the_sources():
    """A changed source or flag set builds a new library instead of reusing a stale one."""
    paths = {name: kernels._lib_path(src) for name, src in kernels.SOURCES.items()}
    assert len(set(paths.values())) == len(paths)
    for name, p in paths.items():
        assert p.parent == kernels.BUILD_DIR and p.name.startswith(kernels.SOURCES[name].stem)


def test_library_names_cover_included_headers(tmp_path):
    """An edit to a header that a source includes, directly or through
    another header, gives the source a new library."""
    for name in ("ppo_sample.cu", "sample_group.cuh", "threefry.cuh"):
        shutil.copy(kernels.PACKAGE_DIR / "csrc" / name, tmp_path / name)
    source, header = tmp_path / "ppo_sample.cu", tmp_path / "threefry.cuh"
    assert kernels._sources_of(source) == [source, tmp_path / "sample_group.cuh", header]
    before = kernels._lib_path(source)
    header.write_text(header.read_text() + "\n// edited\n")
    after = kernels._lib_path(source)
    assert after != before and after.name.startswith("ppo_sample_")
    assert [p.name for p in kernels._sources_of(kernels.SOURCES["replay"])] == \
        ["replay.cu", "bulk.cuh", "threefry.cuh"]


# ---------------------------------------------------------------------------
# Grouped placements, masked epsilon-greedy, replay
# ---------------------------------------------------------------------------

GROUPED = EngineConfig(gravity_enabled=False, auto_reset=True)


def _grouped_states(device, B, steps, config=GROUPED, seed=0):
    """States of a random-legal-placement trajectory (plain versions on the CPU)."""
    gs, _ = tg.reset(batch_keys(prng_key(seed), B, device="cpu"), config, device="cpu")
    rng = np.random.default_rng(seed)
    out = [gs.env]
    for _ in range(steps):
        q = torch.from_numpy(rng.standard_normal((B, config.width * 4)).astype(np.float32))
        gs, *_ = tg.step(gs, grouped_dqn.act_plain(q, gs.mask.T), config)
        out.append(gs.env)
    return [turbo.TurboState(**{k: getattr(s, k).to(device) for k in turbo.FIELDS}) for s in out]


@pytest.mark.cuda
@pytest.mark.parametrize("config", [GROUPED, EngineConfig(width=6, height=8, gravity_enabled=False)],
                         ids=["10x20", "6x8"])
def test_grouped_placements_kernel_matches_plain(cuda, config):
    for s in _grouped_states(cuda, 300, 12, config):
        for mode, plain in (("features", tg.placements_plain), ("boards", tg.placement_boards_plain)):
            for max_clear in (4, config.height):
                got = kernels.grouped_placements(s, config, turbo.PIECES, max_clear, mode)
                want = plain(s, config, max_clear=max_clear)
                for a, b, name in zip(got, want, ("obs", "mask", "game_over", "lines")):
                    _assert_equal(a, b, f"{mode} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 1001, 4096])
def test_grouped_act_kernel_matches_plain(cuda, B):
    g = torch.Generator(device=cuda)
    g.manual_seed(B)
    q = torch.randn((B, 40), generator=g, device=cuda)
    mask_ab = (torch.rand((40, B), generator=g, device=cuda) < 0.5).float()
    mask_ab[:, : min(B, 3)] = 0.0  # envs with every candidate illegal
    for eps in (0.0, 0.4, 1.0):
        keys = threefry.split(prng_key(B), 2)
        got = kernels.grouped_act(q, mask_ab.T, keys[0], keys[1], eps)
        _assert_equal(got, grouped_dqn.act_plain(q, mask_ab.T, keys[0], keys[1], eps), f"eps {eps}")
    _assert_equal(kernels.grouped_act(q, mask_ab.T, fill=float("-inf")),
                  grouped_dqn.act_plain(q, mask_ab.T, fill=float("-inf")), "greedy")


@pytest.mark.cuda
def test_replay_kernels_match_plain(cuda):
    B, capacity = 64, 256
    example = {"obs": torch.zeros((B, 40, 13), device=cuda), "mask": torch.zeros((B, 40), device=cuda),
               "action": torch.zeros(B, dtype=torch.int32, device=cuda),
               "done": torch.zeros(B, dtype=torch.bool, device=cuda)}
    kbuf = buffers.create(example, capacity, B)
    pbuf = buffers.create(example, capacity, B)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    for t in range(7):  # wraps after 4 blocks
        mask_ab = (torch.rand((40, B), generator=g, device=cuda) < 0.5).float()
        block = {"obs": torch.randn((B, 40, 13), generator=g, device=cuda), "mask": mask_ab.T,
                 "action": torch.randint(0, 40, (B,), generator=g, device=cuda, dtype=torch.int32),
                 "done": torch.rand(B, generator=g, device=cuda) < 0.1}
        kbuf = buffers.add(kbuf, block)
        pbuf = buffers.add_plain(pbuf, block)
        for k in example:
            _assert_equal(kbuf.data[k], pbuf.data[k], f"add {k} @ {t}")
        if t:
            key = threefry.fold_in(prng_key(9), t)
            kc, kn = buffers.sample_with_next(kbuf, key, 256, B)
            pc, pn = buffers.sample_with_next_plain(pbuf, key, 256, B)
            for k in example:
                _assert_equal(kc[k], pc[k], f"sample {k} @ {t}")
                _assert_equal(kn[k], pn[k], f"next {k} @ {t}")
    ks, ps = buffers.sample(kbuf, prng_key(1), 100), buffers.sample_plain(pbuf, prng_key(1), 100)
    for k in example:
        _assert_equal(ks[k], ps[k], f"sample {k}")


@pytest.mark.cuda
def test_grouped_train_step_launch_counts(cuda):
    cfg = grouped_dqn.GroupedDQNConfig(buffer_size=256, batch_size=16, learning_starts=2)
    ts = grouped_dqn.init_grouped_dqn_state(prng_key(0), 64, GROUPED, cfg, device=cuda)
    step = grouped_dqn.make_train_step(GROUPED, cfg)
    kernels.reset_launches()
    for _ in range(3):
        ts, _ = step(ts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**NO_LAUNCHES, "grouped_act": 3, "turbo_step": 3, "turbo_init": 3,
                                "grouped_placements": 3, "replay_add": 3, "replay_sample": 1}


def test_grouped_dispatch_runs_plain_versions_on_cpu():
    kernels.reset_launches()
    cfg = grouped_dqn.GroupedDQNConfig(buffer_size=16, batch_size=4, learning_starts=1)
    ts = grouped_dqn.init_grouped_dqn_state(prng_key(0), 4, GROUPED, cfg, device="cpu")
    step = grouped_dqn.make_train_step(GROUPED, cfg)
    for _ in range(2):
        ts, _ = step(ts)
    assert kernels.LAUNCHES == NO_LAUNCHES and ts.buffer.size == 8


def test_grouped_kernel_wrappers_refuse_cpu_tensors():
    s = turbo.init(batch_keys(prng_key(0), 4, device="cpu"), GROUPED, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.grouped_placements(s, GROUPED, turbo.PIECES)
    with pytest.raises(NotImplementedError):
        kernels.grouped_placements(s, EngineConfig(height=70), turbo.PIECES)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.grouped_act(torch.zeros((4, 40)), torch.ones((4, 40)))
    data = {"x": torch.zeros((8, 3))}
    with pytest.raises(ValueError, match="CUDA"):
        kernels.replay_add(data, {"x": torch.ones((4, 3))}, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.replay_sample(data, prng_key(0), 4, 8)


# ---------------------------------------------------------------------------
# Frame-stack push, stacked replay sample, the DQN's epsilon-greedy
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("B, K", [(1024, 4), (512, 4), (1, 2), (1001, 2)])
def test_framestack_push_kernel_matches_plain(cuda, B, K):
    g = torch.Generator(device=cuda)
    g.manual_seed(B + K)
    stack = torch.randint(-1, 2, (B, K, 20, 10), generator=g, device=cuda, dtype=torch.int8)
    for t in range(3):
        obs = torch.randint(-1, 2, (B, 20, 10), generator=g, device=cuda, dtype=torch.int8)
        done = torch.rand((B,), generator=g, device=cuda) < 0.15
        got = kernels.framestack_push(stack, obs, done)
        _assert_equal(got, framestack.push_plain(stack, obs, done), f"push {t}")
        stack = got
    odd = torch.randint(-1, 2, (B, K, 3, 5), generator=g, device=cuda, dtype=torch.int8)
    odd_obs = torch.randint(-1, 2, (B, 3, 5), generator=g, device=cuda, dtype=torch.int8)
    done = torch.rand((B,), generator=g, device=cuda) < 0.5
    _assert_equal(kernels.framestack_push(odd, odd_obs, done),
                  framestack.push_plain(odd, odd_obs, done), "15-byte frames")


def _stacked_buffers(device, B, blocks, adds, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    example = {"obs": torch.zeros((B, 20, 10), dtype=torch.int8, device=device),
               "action": torch.zeros(B, dtype=torch.int32, device=device),
               "reward": torch.zeros(B, device=device),
               "done": torch.zeros(B, dtype=torch.bool, device=device)}
    kbuf, pbuf = (buffers.create(example, blocks * B, B) for _ in range(2))
    for _ in range(adds):
        window = torch.randint(-1, 2, (B, 4, 20, 10), generator=g, device=device, dtype=torch.int8)
        block = {"obs": window[:, -1], "action": torch.randint(0, 8, (B,), generator=g, device=device,
                                                                dtype=torch.int32),
                 "reward": torch.randn((B,), generator=g, device=device),
                 "done": torch.rand((B,), generator=g, device=device) < 0.15}
        kbuf = buffers.add(kbuf, block)
        pbuf = buffers.add_plain(pbuf, block)
        for k in example:
            _assert_equal(kbuf.data[k], pbuf.data[k], f"strided add {k}")
    return kbuf, pbuf


@pytest.mark.cuda
@pytest.mark.parametrize("K", [4, 2])
def test_replay_sample_stacked_kernel_matches_plain(cuda, K):
    B = 64
    kbuf, pbuf = _stacked_buffers(cuda, B, 12, 30, K)  # wraps 2.5 times
    for t in range(4):
        key = threefry.fold_in(prng_key(21), t)
        kc, kn = buffers.sample_with_next_stacked(kbuf, key, 512, B, K)
        pc, pn = buffers.sample_with_next_stacked_plain(pbuf, key, 512, B, K)
        assert kc["obs"].shape == (512, K, 20, 10)
        for k in kc:
            _assert_equal(kc[k], pc[k], f"stacked sample {k}")
            _assert_equal(kn[k], pn[k], f"stacked successor {k}")
    start, n_valid = buffers._stacked_window(kbuf, B, K)
    _, _, off = kernels.replay_sample_stacked(kbuf.data, prng_key(3), 1001, n_valid, start, B, K,
                                             return_offsets=True)
    np.testing.assert_array_equal(off.cpu().numpy(), threefry.randint(prng_key(3), 1001, n_valid))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 1001, 1024])
def test_dqn_act_kernel_matches_plain(cuda, B):
    g = torch.Generator(device=cuda)
    g.manual_seed(B)
    q = torch.randn((B, 8), generator=g, device=cuda)
    q[: min(B, 3), 2:5] = 7.0  # ties: the lowest index wins
    counters = torch.arange(B, dtype=torch.int64, device=cuda)
    for eps in (0.0, 0.4, 1.0):
        act_key, eps_key = threefry.split(prng_key(B + 1))
        a, ra, eu = kernels.dqn_act(q, act_key, eps_key, eps, return_draws=True)
        _assert_equal(a, dqn.act_plain(q, act_key, eps_key, eps), f"eps {eps}")
        _assert_equal(ra, threefry.randint_lanes(act_key, B, 8, cuda).to(torch.int32), "randint")
        _assert_equal(eu, threefry.bits_to_uniform_lanes(threefry.random_bits32_lanes(eps_key, counters)),
                      "uniform")
    _assert_equal(kernels.dqn_act(q), dqn.act_plain(q), "greedy")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_dqn_train_step_launch_counts(cuda, K):
    cfg = dqn.DQNConfig(buffer_size=64 * 8, batch_size=16, learning_starts=2, frame_stack=K)
    config = EngineConfig(auto_reset=True)
    ts = dqn.init_dqn_state(prng_key(0), 64, config, cfg, device=cuda)
    step = dqn.make_train_step(config, cfg)
    kernels.reset_launches()
    for _ in range(6):
        ts, _ = step(ts)
    torch.cuda.synchronize()
    learn = 6 - max(2, K)
    want = {**NO_LAUNCHES, "dqn_act": 6, "turbo_step": 6, "observe_board": 6, "replay_add": 6}
    want.update({"replay_sample": learn} if K == 1 else
                {"replay_sample_stacked": learn, "framestack_push": 6})
    assert kernels.LAUNCHES == want


def test_dqn_dispatch_runs_plain_versions_on_cpu():
    kernels.reset_launches()
    cfg = dqn.DQNConfig(buffer_size=4 * 6, batch_size=4, learning_starts=1, frame_stack=2)
    config = EngineConfig(auto_reset=True)
    ts = dqn.init_dqn_state(prng_key(0), 4, config, cfg, device="cpu")
    step = dqn.make_train_step(config, cfg)
    for _ in range(3):
        ts, _ = step(ts)
    assert kernels.LAUNCHES == NO_LAUNCHES and ts.buffer.size == 12 and ts.obs.shape == (4, 2, 20, 10)


def test_dqn_kernel_wrappers_refuse_cpu_tensors():
    stack = torch.zeros((4, 2, 3, 5), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.framestack_push(stack, stack[:, 0].contiguous(), torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dqn_act(torch.zeros((4, 8)))
    data = {"obs": torch.zeros((12, 3), dtype=torch.int8), "done": torch.zeros(12, dtype=torch.bool)}
    with pytest.raises(ValueError, match="CUDA"):
        kernels.replay_sample_stacked(data, prng_key(0), 4, 4, 0, 4, 2)
    with pytest.raises(NotImplementedError):
        kernels.replay_sample_stacked(data, prng_key(0), 4, 4, 0, 1, 17)


# ---------------------------------------------------------------------------
# The flagship engine and its 84x84 frame
# ---------------------------------------------------------------------------

FLAGSHIP_P = (0.1, 0.1, 0.08, 0.1, 0.07, 0.3, 0.15, 0.1)  # biased towards drops and swaps


def _flagship_actions(B, g, dev):
    p = torch.tensor(FLAGSHIP_P, device=dev).expand(B, -1)
    return torch.multinomial(p, 1, replacement=True, generator=g)[:, 0].to(torch.int32)


def _assert_flagship_equal(a, b, what):
    from tetris_gymnasium_torch.core import engine

    for k in engine.FIELDS:
        _assert_equal(getattr(a, k), getattr(b, k), f"{what}: {k}")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "config",
    [EngineConfig(auto_reset=True), EngineConfig(gravity_enabled=False, queue_kind="uniform")],
    ids=["autoreset", "nograv-uniform"],
)
def test_flagship_kernels_match_plain(cuda, config):
    """``flagship_init``, ``flagship_step``, ``flagship_observe_board`` and
    ``render_rgb84`` bit-equal to their plain versions on a trajectory, and
    the trajectory equal to ``turbo_step``'s on the same keys and actions."""
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops import bitboard as bb

    B = 301
    keys = batch_keys(prng_key(5), B, device=cuda)
    s = engine.init(keys, config, device=cuda)
    _assert_flagship_equal(s, engine.init_plain(keys, config), "init")
    ts = turbo.init(keys, config, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    for i in range(60):
        _assert_equal(engine.observe_board(s, config), engine.observe_board_plain(s, config), f"obs {i}")
        _assert_equal(engine.observe_board(s, config), turbo.observe_board(ts, config), f"turbo obs {i}")
        _assert_equal(engine.render_rgb84(s, config), engine.render_rgb84_plain(s, config), f"rgb84 {i}")
        a = _flagship_actions(B, g, cuda)
        ks, _, kr, kd, kinfo = engine.step(s, a, config)
        ps, pr, pd, pl = engine.step_plain(s, a, config)
        _assert_flagship_equal(ks, ps, f"step {i}")
        for got, want in ((kr, pr), (kd, pd), (kinfo["lines_cleared"], pl)):
            _assert_equal(got, want, f"outputs {i}")
        ts, _, tr, td, _ = turbo.step(ts, a, config)
        _assert_equal(bb.pack_board(ks.board).T, turbo.u32_to_lanes(ts.rows), f"turbo rows {i}")
        _assert_equal(ks.queue.T, ts.queue, f"turbo queue {i}")
        _assert_equal(kr, tr, f"turbo reward {i}")
        _assert_equal(kd, td, f"turbo done {i}")
        s = ks


@pytest.mark.cuda
def test_flagship_step_clears_any_number_of_rows(cuda):
    """Hard drops onto stacks of up to eight full rows clear them all, as the plain version does."""
    from tetris_gymnasium_torch.core import engine

    config = EngineConfig(auto_reset=True)
    B = 256
    s = engine.init(batch_keys(prng_key(6), B, device=cuda), config, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(6)
    n_full = torch.randint(0, 9, (B,), generator=g, device=cuda)
    rows = torch.arange(20, device=cuda)[None, :, None]
    board = s.board.clone()
    board[:, :20, 4:14] = torch.where(rows >= 20 - n_full[:, None, None], 2, board[:, :20, 4:14])
    s = s.replace(board=board)
    a = torch.full((B,), 5, dtype=torch.int32, device=cuda)
    ks, _, kr, kd, kinfo = engine.step(s, a, config)
    ps, pr, pd, pl = engine.step_plain(s, a, config)
    _assert_flagship_equal(ks, ps, "surgery")
    _assert_equal(kinfo["lines_cleared"], pl, "lines")
    assert int(pl.max()) >= 8


@pytest.mark.cuda
def test_pixel_dqn_launch_counts(cuda):
    from tetris_gymnasium_torch.models.networks import AtariQNetwork

    cfg = dqn.DQNConfig(buffer_size=16 * 8, batch_size=8, learning_starts=4, frame_stack=4)
    config = EngineConfig(auto_reset=True)
    ts = dqn.init_dqn_state(prng_key(0), 16, config, cfg, net=AtariQNetwork(in_channels=4),
                            impl="flagship", obs="rgb84", device=cuda)
    step = dqn.make_train_step(config, cfg, impl="flagship", obs="rgb84")
    kernels.reset_launches()
    for _ in range(6):
        ts, _ = step(ts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**NO_LAUNCHES, "dqn_act": 6, "flagship_step": 6, "render_rgb84": 6,
                                "framestack_push": 6, "replay_add": 6, "replay_sample_stacked": 2}


def test_flagship_dispatch_runs_plain_versions_on_cpu():
    from tetris_gymnasium_torch.core import engine

    kernels.reset_launches()
    config = EngineConfig(auto_reset=True)
    s = engine.init(batch_keys(prng_key(0), 4, device="cpu"), config, device="cpu")
    s = engine.step(s, torch.full((4,), 5, dtype=torch.int32), config)[0]
    assert engine.observe_board(s, config).shape == (4, 20, 10)
    assert engine.render_rgb84(s, config).shape == (4, 84, 84)
    assert kernels.LAUNCHES == NO_LAUNCHES


def test_flagship_kernel_wrappers_refuse_cpu_tensors():
    from tetris_gymnasium_torch.core import engine

    config = EngineConfig()
    s = engine.init_plain(batch_keys(prng_key(0), 4, device="cpu"), config)
    a = torch.zeros(4, dtype=torch.int32)
    for call in (lambda: kernels.flagship_step(s, a, config, engine.PIECES, RewardsMapping()),
                 lambda: kernels.flagship_observe_board(s, config, engine.PIECES),
                 lambda: kernels.render_rgb84(s, config, engine.PIECES)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flagship_init(torch.zeros((4, 2), dtype=torch.uint32), config, engine.PIECES)
    with pytest.raises(NotImplementedError, match="padded width"):
        kernels.flagship_step(s, a, EngineConfig(width=121), engine.PIECES, RewardsMapping())
    # render_rgb84 takes a 6x8 board, refusing only the CPU tensor; it
    # refuses a composite wider than 84 as JAX's resize does, and a board
    # past the engine kernels' limits by name
    small = EngineConfig(width=6, height=8)
    s8 = engine.init_plain(batch_keys(prng_key(0), 4, device="cpu"), small)
    assert engine.render_rgb84(s8, small).shape == (4, 84, 84)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.render_rgb84(s8, small, engine.PIECES)
    with pytest.raises(ValueError, match="only enlarges"):
        kernels.render_rgb84(s, EngineConfig(width=70), engine.PIECES)
    with pytest.raises(NotImplementedError, match="cells > 3072"):
        kernels.render_rgb84(s, EngineConfig(width=60, height=60), engine.PIECES)


def test_engine_sources_share_one_header():
    """The turbo and flagship kernels take their RNG, draws and bit helpers
    from one header, which names every library that includes it; the id
    image and the feature vector are shared headers too."""
    for name, chain in (("turbo_step", ["turbo_step.cu"]), ("flagship_step", ["flagship_step.cu"]),
                        ("render_rgb84", ["render_rgb84.cu", "id_image.cuh"]),
                        ("observe_dict", ["observe_dict.cu", "id_image.cuh"]),
                        ("grouped_flagship", ["grouped_flagship.cu", "engine_common.cuh",
                                              "features.cuh"])):
        names = [p.name for p in kernels._sources_of(kernels.SOURCES[name])]
        assert names[: len(chain)] == chain and "engine_common.cuh" in names
    assert [p.name for p in kernels._sources_of(kernels.SOURCES["features"])] == \
        ["features.cu", "features.cuh"]


# ---------------------------------------------------------------------------
# The Gymnasium surface: grouped_flagship, feature_vector, observe_dict, compose_rgb
# ---------------------------------------------------------------------------

ALL_FLAGS = [tuple(bool(m >> k & 1) for k in range(4)) for m in range(16)]


def _surface_states(dev, B, steps, seed):
    """Flagship states along a random trajectory, then hand-built stacks:
    garbage ids, full rows, pieces in random spots and a full holder."""
    from tetris_gymnasium_torch.core import engine

    config = EngineConfig(auto_reset=True)
    s = engine.init(batch_keys(prng_key(seed), B, device=dev), config, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    out = [s]
    for _ in range(steps):
        s = engine.step(s, _flagship_actions(B, g, dev), config, obs_fn=engine.no_obs)[0]
        out.append(s)
    board = s.board.clone()
    inner = board[:, 2:20, 4:14]
    garbage = torch.randint(-3, 12, inner.shape, generator=g, device=dev, dtype=torch.int8)
    keep = torch.rand(inner.shape, generator=g, device=dev) < 0.5
    full = torch.rand((B, 18, 1), generator=g, device=dev) < 0.3
    inner[:] = torch.where(keep | full, garbage.abs() % 9 * full + garbage * ~full, 0)
    out.append(s.replace(
        board=board,
        piece=torch.randint(-1, 8, (B,), generator=g, device=dev, dtype=torch.int32),
        rotation=torch.randint(0, 4, (B,), generator=g, device=dev, dtype=torch.int32),
        x=torch.randint(-3, 18, (B,), generator=g, device=dev, dtype=torch.int32),
        y=torch.randint(-2, 22, (B,), generator=g, device=dev, dtype=torch.int32),
        holder_count=torch.randint(0, 2, (B,), generator=g, device=dev, dtype=torch.int32),
    ))
    return config, out


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 301])
def test_grouped_flagship_kernel_matches_plain(cuda, B):
    from tetris_gymnasium_torch.core import grouped
    from tetris_gymnasium_torch.ops.observations import FeatureFlags

    config, states = _surface_states(cuda, B, 40, seed=B)
    for i, s in enumerate(states[::4] + states[-1:]):
        want = grouped.placements_plain(s, config)
        for got, ref, what in zip(kernels.grouped_flagship(s, config, turbo.PIECES, "ids"), want,
                                  ("ids", "mask", "over", "lines")):
            _assert_equal(got, ref, f"{what} @ {i}")
        _assert_equal(kernels.grouped_flagship(s, config, turbo.PIECES, "boards")[0],
                      want[0].float(), f"boards @ {i}")
        for flags in ALL_FLAGS:
            flags = FeatureFlags(*flags)
            got = kernels.grouped_flagship(s, config, turbo.PIECES, "features", flags)[0]
            ref = grouped.grouped_observation_plain(s, config, mode="features",
                                                    feature_flags=flags)[0]
            _assert_equal(got, ref, f"features {flags} @ {i}")


@pytest.mark.cuda
def test_feature_vector_kernel_matches_plain(cuda):
    from tetris_gymnasium_torch.ops.observations import FeatureFlags, feature_vector_plain

    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    boards = torch.randint(-5, 9, (1001, 24, 18), generator=g, device=cuda, dtype=torch.int8)
    boards *= torch.rand((1001, 24, 18), generator=g, device=cuda) < 0.4
    boards[:5] = 0
    boards[5:10, :20, 4] = 3  # a full column
    crop = boards[:, :20, 4:14]
    for flags in ALL_FLAGS:
        flags = FeatureFlags(*flags)
        _assert_equal(kernels.feature_vector(crop, flags), feature_vector_plain(crop, flags),
                      str(flags))


@pytest.mark.cuda
def test_observe_dict_and_compose_rgb_kernels_match_plain(cuda):
    from tetris_gymnasium_torch.core import engine
    from tetris_gymnasium_torch.ops.observations import compose_rgb_plain

    config, states = _surface_states(cuda, 257, 40, seed=9)
    for i, s in enumerate(states):
        got, want = kernels.observe_dict(s, config, engine.PIECES), engine.observe_dict_plain(s, config)
        for k in want:
            _assert_equal(got[k], want[k], f"{k} @ {i}")
        strips = kernels.observe_dict(s, config, engine.PIECES, strips_only=True)
        assert strips.keys() == {"queue", "holder"}
        for k in strips:
            _assert_equal(strips[k], want[k], f"strips_only {k} @ {i}")
        _assert_equal(engine.render_rgb(s, config), engine.render_rgb_plain(s, config), f"rgb @ {i}")
        _assert_equal(kernels.render_rgb84(s, config, engine.PIECES),
                      engine.render_rgb84_plain(s, config), f"rgb84 @ {i}")
    g = torch.Generator(device=cuda)
    g.manual_seed(10)
    boards = torch.randint(0, 256, (80, 24, 18), generator=g, device=cuda, dtype=torch.uint8)
    q = torch.randint(0, 12, (2, 4, 16), generator=g, device=cuda, dtype=torch.uint8)
    h = torch.randint(0, 12, (2, 4, 4), generator=g, device=cuda, dtype=torch.uint8)
    _assert_equal(kernels.compose_rgb(boards, q, h, engine.PIECES, 40),
                  compose_rgb_plain(boards, q, h, engine.PIECES, 40), "ids outside the palette")


@pytest.mark.cuda
def test_shell_launch_counts(cuda):
    from tetris_gymnasium_torch.envs import Tetris
    from tetris_gymnasium_torch.wrappers import FeatureVectorObservation, GroupedActionsObservations

    env = Tetris(render_mode="rgb_array", device=cuda)
    env.reset(seed=0)
    kernels.reset_launches()
    for a in range(8):
        env.step(a)
    env.render()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**NO_LAUNCHES, "flagship_step": 8, "observe_dict": 9,
                                "compose_rgb": 1}
    base = Tetris(device=cuda)
    genv = GroupedActionsObservations(base, [FeatureVectorObservation(base)])
    _, info = genv.reset(seed=1)
    kernels.reset_launches()
    genv.step(int(np.nonzero(info["action_mask"])[0][0]))
    assert kernels.LAUNCHES == {**NO_LAUNCHES, "flagship_step": 1, "grouped_flagship": 1,
                                "observe_dict": 1, "feature_vector": 1}
    host = GroupedActionsObservations(base, [FeatureVectorObservation(base)], mode="host")
    _, info = host.reset(seed=1)
    kernels.reset_launches()
    host.step(int(np.nonzero(info["action_mask"])[0][0]))  # info["board"], then 40 candidates at once
    assert kernels.LAUNCHES == {**NO_LAUNCHES, "flagship_step": 1, "grouped_flagship": 1,
                                "observe_dict": 1, "feature_vector": 2}


def test_surface_dispatch_runs_plain_versions_on_cpu():
    from tetris_gymnasium_torch.core import engine, grouped
    from tetris_gymnasium_torch.ops.observations import feature_vector

    kernels.reset_launches()
    config = EngineConfig()
    s = engine.init(batch_keys(prng_key(0), 3, device="cpu"), config, device="cpu")
    assert engine.step(s, torch.zeros(3, dtype=torch.int32), config)[1]["board"].shape == (3, 24, 18)
    assert engine.render_rgb(s, config).shape == (3, 24, 34, 3)
    for mode in grouped.MODES:
        assert grouped.grouped_observation(s, config, mode=mode)[1].shape == (3, 40)
    assert feature_vector(s.board[:, :20, 4:14]).shape == (3, 13)
    assert kernels.LAUNCHES == NO_LAUNCHES


def test_surface_kernel_wrappers_refuse_cpu_tensors():
    from tetris_gymnasium_torch.core import engine

    config = EngineConfig()
    s = engine.init_plain(batch_keys(prng_key(0), 2, device="cpu"), config)
    d = engine.observe_dict_plain(s, config)
    for call in (lambda: kernels.grouped_flagship(s, config, engine.PIECES, "boards"),
                 lambda: kernels.feature_vector(s.board[:, :20, 4:14], (True,) * 4),
                 lambda: kernels.observe_dict(s, config, engine.PIECES),
                 lambda: kernels.compose_rgb(d["board"], d["queue"], d["holder"], engine.PIECES)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_surface_kernels_refuse_other_geometry():
    """The surface kernels are built for every geometry: at width 8 they
    refuse only the CPU tensors, and they refuse by name only past their
    static limits (or, where JAX's composite fails, with its TypeError)."""
    from tetris_gymnasium_torch.core import engine

    config = EngineConfig(width=8)
    s = engine.init_plain(batch_keys(prng_key(0), 2, device="cpu"), config)
    d = engine.observe_dict_plain(s, config)
    for call in (lambda: kernels.grouped_flagship(s, config, engine.PIECES, "boards"),
                 lambda: kernels.feature_vector(s.board[:, :20, 4:12], (True,) * 4),
                 lambda: kernels.observe_dict(s, config, engine.PIECES),
                 lambda: kernels.compose_rgb(d["board"], d["queue"], d["holder"], engine.PIECES),
                 lambda: kernels.grouped_placements(turbo.from_flagship(s, config), config,
                                                    engine.PIECES)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(NotImplementedError, match="65 rows"):
        kernels.feature_vector(torch.zeros((2, 65, 10), dtype=torch.int8), (True,) * 4)
    with pytest.raises(NotImplementedError, match="129 columns"):
        kernels.feature_vector(torch.zeros((2, 20, 129), dtype=torch.int8), (True,) * 4)
    with pytest.raises(NotImplementedError, match="cells > 3072"):
        kernels.grouped_flagship(s, EngineConfig(width=120, height=30), engine.PIECES, "boards")
    with pytest.raises(NotImplementedError, match="padded width"):
        kernels.grouped_placements(turbo.from_flagship(s, config), EngineConfig(width=121),
                                   engine.PIECES)
    with pytest.raises(TypeError, match="lower than"):
        kernels.compose_rgb(d["board"][:, :7], d["queue"], d["holder"], engine.PIECES)


# ---------------------------------------------------------------------------
# Other geometries: the engine kernels built for each, and heights
# ---------------------------------------------------------------------------

WIDE = [EngineConfig(width=30, height=20, auto_reset=True),
        EngineConfig(width=61, height=12, queue_size=3, auto_reset=True),
        EngineConfig(width=28, height=14, gravity_enabled=False),
        EngineConfig(width=8, height=12, queue_size=2, queue_kind="uniform", auto_reset=True)]
WIDE_IDS = ["30x20", "61x12-q3", "28x14-nograv", "8x12-q2-uniform"]


def _oversize_pieces():
    from tetris_gymnasium_torch.components import Tetromino
    from tetris_gymnasium_torch.components.tetromino import pieces_from_tetrominoes

    return pieces_from_tetrominoes([
        Tetromino(2, (255, 0, 0), np.ones((2, 2), np.uint8)),
        Tetromino(3, (0, 255, 0), np.ones((1, 6), np.uint8)),
        Tetromino(4, (0, 0, 255), np.array([[0, 1, 0], [1, 1, 1], [0, 0, 0]], np.uint8))])


def _engine_kernels_against_plain(dev, config, pieces, B, steps, seed):
    """Both engines' kernels against their plain versions along one
    trajectory, and the turbo engine against the flagship engine."""
    from tetris_gymnasium_torch.core import engine

    keys = batch_keys(prng_key(seed), B, device=dev)
    ts, fs = turbo.init(keys, config, pieces, device=dev), engine.init(keys, config, pieces, device=dev)
    for k in turbo.FIELDS:
        _assert_equal(getattr(ts, k), getattr(turbo.init_plain(keys, config, pieces), k), f"init {k}")
    _assert_flagship_equal(fs, engine.init_plain(keys, config, pieces), "flagship init")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    for i in range(steps):
        _assert_equal(turbo.observe_board(ts, config, pieces), turbo.observe_board_plain(ts, config, pieces),
                      f"obs {i}")
        _assert_equal(turbo.heights(ts, config), turbo.heights_plain(ts, config), f"heights {i}")
        _assert_equal(engine.observe_board(fs, config, pieces), engine.observe_board_plain(fs, config, pieces),
                      f"flagship obs {i}")
        a = _flagship_actions(B, g, dev)
        ks, _, kr, kd, kinfo = turbo.step(ts, a, config, pieces)
        ps, pr, pd, pl = turbo.step_plain(ts, a, config, pieces)
        for k in turbo.FIELDS:
            _assert_equal(getattr(ks, k), getattr(ps, k), f"{k} @ {i}")
        for got, want in ((kr, pr), (kd, pd), (kinfo["lines_cleared"], pl)):
            _assert_equal(got, want, f"outputs @ {i}")
        fks, _, fr, fd, finfo = engine.step(fs, a, config, pieces, obs_fn=engine.no_obs)
        fps, *fouts = engine.step_plain(fs, a, config, pieces)
        _assert_flagship_equal(fks, fps, f"flagship step {i}")
        for got, want in zip((fr, fd, finfo["lines_cleared"]), fouts):
            _assert_equal(got, want, f"flagship outputs @ {i}")
        _assert_equal(turbo.from_flagship(fks, config).rows, ks.rows, f"turbo rows {i}")
        ts, fs = ks, fks


@pytest.mark.cuda
@pytest.mark.parametrize("config", WIDE, ids=WIDE_IDS)
def test_engine_kernels_match_plain_at_other_geometries(cuda, config):
    _engine_kernels_against_plain(cuda, config, turbo.PIECES, 1001, 100, 11)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [10, 30])  # padded 22 (one word) and 42 (two)
def test_engine_kernels_take_oversize_pieces(cuda, width):
    """The 6x6 pieces: two-word table entries whose rows straddle a word."""
    pieces, pad = _oversize_pieces()
    config = EngineConfig(width=width, height=16, padding=pad, queue_size=2, queue_kind="uniform",
                          auto_reset=True)
    _engine_kernels_against_plain(cuda, config, pieces, 513, 100, 12)


@pytest.mark.cuda
@pytest.mark.parametrize("gap", [0, 12, 14, 26])
@pytest.mark.parametrize("n_rows", [1, 2])
def test_line_clears_across_the_word_boundary(cuda, gap, n_rows):
    """A flat I dropped into a 4-wide gap clears the row on both engines'
    kernels as on their plain versions (tests/test_wide_boards.py:118-157)."""
    from tetris_gymnasium_torch.core import engine

    config = EngineConfig(width=30, height=20)
    B, pad = 64, config.padding
    s = engine.init(batch_keys(prng_key(7), B, device=cuda), config, device=cuda)
    board = s.board.clone()
    board[:, 20 - n_rows : 20, pad : pad + 30] = 2
    board[:, 20 - n_rows : 20, pad + gap : pad + gap + 4] = 0
    zero = torch.zeros(B, dtype=torch.int32, device=cuda)
    s = s.replace(board=board, piece=zero, rotation=zero.clone(), y=zero.clone(),
                  x=torch.full((B,), gap + pad, dtype=torch.int32, device=cuda))
    ts = turbo.from_flagship(s, config)
    a = torch.full((B,), 5, dtype=torch.int32, device=cuda)
    ks, _, _, _, kinfo = turbo.step(ts, a, config)
    ps, _, _, pl = turbo.step_plain(ts, a, config)
    for k in turbo.FIELDS:
        _assert_equal(getattr(ks, k), getattr(ps, k), k)
    fks, _, _, _, finfo = engine.step(s, a, config, obs_fn=engine.no_obs)
    _assert_flagship_equal(fks, engine.step_plain(s, a, config)[0], "flagship")
    assert (pl == 1).all() and (kinfo["lines_cleared"] == 1).all() and (finfo["lines_cleared"] == 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("config", [EngineConfig(), WIDE[0], WIDE[1]], ids=["10x20", "30x20", "61x12"])
def test_heights_kernel_matches_plain(cuda, config):
    """Hand-built stacks: random cells under random column tops, B = 1 and 4097."""
    g = torch.Generator(device=cuda)
    g.manual_seed(13)
    for B in (1, 4097):
        s = turbo.init(batch_keys(prng_key(B), B, device=cuda), config, device=cuda)
        H, W, pad = config.height, config.width, config.padding
        cells = torch.rand((B, H, W), generator=g, device=cuda) < 0.4
        tops = torch.randint(0, H + 1, (B, 1, W), generator=g, device=cuda)
        cells &= torch.arange(H, device=cuda)[None, :, None] >= tops
        board = torch.nn.functional.pad(cells.to(torch.int8) * 2, (pad, pad, 0, pad), value=1)
        from tetris_gymnasium_torch.core import engine

        es = engine.init_plain(batch_keys(prng_key(B), B, device=cuda), config).replace(board=board)
        s = s.replace(rows=turbo.from_flagship(es, config).rows)
        kernels.reset_launches()
        _assert_equal(turbo.heights(s, config), turbo.heights_plain(s, config), f"B={B}")
        assert kernels.LAUNCHES == {**NO_LAUNCHES, "heights": 1}


def test_heights_dispatch_and_refusals():
    """On a CPU tensor heights runs its plain version; the wrapper refuses
    CPU tensors, and the rows' shape follows the words of a row."""
    config = EngineConfig(width=30, height=20)
    s = turbo.init(batch_keys(prng_key(0), 3, device="cpu"), config, device="cpu")
    kernels.reset_launches()
    assert turbo.heights(s, config).shape == (30, 3) and (turbo.heights(s, config) == 0).all()
    assert kernels.LAUNCHES == NO_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        kernels.heights(s, config)
    assert kernels._rows_shape(config, 5) == (24, 2, 5)
    assert kernels._rows_shape(EngineConfig(), 5) == (24, 5)


# ---------------------------------------------------------------------------
# The surface kernels at other geometries
# ---------------------------------------------------------------------------

SURFACE_WIDE = WIDE + [EngineConfig(queue_size=1, holder_size=2, auto_reset=True)]
SURFACE_WIDE_IDS = WIDE_IDS + ["queue1-holder2"]


def _surface_kernels_against_plain(dev, config, pieces, B, steps, seed):
    """The six surface kernels against their plain versions along one
    flagship trajectory: the Dict observation (and its strips), the
    composite, the 84x84 frame where the composite is at most 84 on a side,
    the feature vector, the flagship grouped engine in its three modes and
    the turbo grouped engine in both."""
    from tetris_gymnasium_torch.core import engine, grouped
    from tetris_gymnasium_torch.ops.observations import (FeatureFlags, compose_rgb_plain,
                                                         feature_vector_plain)

    S, pad = int(pieces.matrices.shape[-1]), config.padding
    rgb84 = max(config.padded_height, config.padded_width + S * max(config.queue_size,
                                                                   config.holder_size)) <= 84
    s = engine.init(batch_keys(prng_key(seed), B, device=dev), config, pieces, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    for i in range(steps):
        d, dp = kernels.observe_dict(s, config, pieces), engine.observe_dict_plain(s, config, pieces)
        for k in dp:
            _assert_equal(d[k], dp[k], f"observe_dict {k} @ {i}")
        for k, v in kernels.observe_dict(s, config, pieces, strips_only=True).items():
            _assert_equal(v, dp[k], f"strips {k} @ {i}")
        _assert_equal(kernels.compose_rgb(d["board"], d["queue"], d["holder"], pieces),
                      compose_rgb_plain(dp["board"], dp["queue"], dp["holder"], pieces), f"rgb @ {i}")
        if rgb84:
            _assert_equal(kernels.render_rgb84(s, config, pieces),
                          engine.render_rgb84_plain(s, config, pieces), f"rgb84 @ {i}")
        crop = s.board[:, :-pad, pad:-pad]
        for flags in ALL_FLAGS[:: 5 if i else 1]:
            flags = FeatureFlags(*flags)
            _assert_equal(kernels.feature_vector(crop, flags), feature_vector_plain(crop, flags),
                          f"features {flags} @ {i}")
        if i % 5 == 0:
            want = grouped.placements_plain(s, config, pieces)
            for got, ref, what in zip(kernels.grouped_flagship(s, config, pieces, "ids"), want,
                                      ("ids", "mask", "over", "lines")):
                _assert_equal(got, ref, f"grouped {what} @ {i}")
            _assert_equal(kernels.grouped_flagship(s, config, pieces, "boards")[0], want[0].float(),
                          f"grouped boards @ {i}")
            _assert_equal(kernels.grouped_flagship(s, config, pieces, "features")[0],
                          grouped.grouped_observation_plain(s, config, pieces, "features")[0],
                          f"grouped features @ {i}")
            ts = turbo.from_flagship(s, config)
            for max_clear in (4, config.height):
                for mode, plain in (("features", tg.placements_plain), ("boards", tg.placement_boards_plain)):
                    for got, ref in zip(kernels.grouped_placements(ts, config, pieces, max_clear, mode),
                                        plain(ts, config, pieces, max_clear)):
                        _assert_equal(got, ref, f"turbo grouped {mode} max_clear={max_clear} @ {i}")
        s = engine.step(s, _flagship_actions(B, g, dev), config, pieces, obs_fn=engine.no_obs)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("config", SURFACE_WIDE, ids=SURFACE_WIDE_IDS)
def test_surface_kernels_match_plain_at_other_geometries(cuda, config):
    _surface_kernels_against_plain(cuda, config, turbo.PIECES, 257, 40, 21)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [10, 30])
def test_surface_kernels_take_oversize_pieces(cuda, width):
    """The 6x6 pieces: two-word piece entries, 6-row thumbnails."""
    pieces, pad = _oversize_pieces()
    config = EngineConfig(width=width, height=16, padding=pad, queue_size=2, queue_kind="uniform",
                          auto_reset=True)
    _surface_kernels_against_plain(cuda, config, pieces, 129, 40, 22)


# ---------------------------------------------------------------------------
# The compat functional engine and the exact grayscale
# ---------------------------------------------------------------------------

FN_CONFIGS = [(dict(), "bag"), (dict(gravity_enabled=False), "bag"), (dict(queue_size=5), "uniform"),
              (dict(width=30), "bag"), (dict(width=8, height=12, padding=2), "bag")]
FN_IDS = ["default", "nograv", "uniform5", "30x20", "8x12-pad2"]


def _fn_equal(got, want, what):
    from tetris_gymnasium_torch.core import fn_env

    if isinstance(want, fn_env.FnState):
        for k in fn_env.FIELDS:
            _assert_equal(getattr(got, k), getattr(want, k), f"{what} {k}")
    else:
        _assert_equal(got, want, what)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kind", FN_CONFIGS, ids=FN_IDS)
def test_fn_kernels_match_plain(cuda, kw, kind):
    """``fn_reset``, ``fn_step`` and ``fn_observe`` bit-equal to their plain
    versions along 120 random steps (actions 0-7) at B = 1001."""
    from tetris_gymnasium_torch.config import EnvConfig
    from tetris_gymnasium_torch.core import fn_env
    from tetris_gymnasium_torch.ops.queue import BAG_QUEUE, UNIFORM_QUEUE

    config, qf = EnvConfig(**kw), (BAG_QUEUE if kind == "bag" else UNIFORM_QUEUE)
    B = 1001
    keys = batch_keys(prng_key(9), B, device=cuda)
    got = fn_env.reset(keys, config, queue_fns=qf)
    want = fn_env.reset_plain(keys, config, queue_fns=qf)
    for a, b, what in zip(got, want, ("keys", "state", "obs")):
        _fn_equal(a, b, f"reset {what}")
    s = want[1]
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    for i in range(120):
        _assert_equal(fn_env.observe(s, config), fn_env.observe_plain(s, config), f"obs {i}")
        a = torch.randint(0, 8, (B,), generator=g, device=cuda, dtype=torch.int32)
        ks, ko, kr, kt, kinfo = fn_env.step(s, a, config, queue_fns=qf)
        want = fn_env.step_plain(s, a, config, queue_fns=qf)
        for got_, ref, what in zip((ks, ko, kr, kt, kinfo["lines_cleared"]), want,
                                   ("state", "obs", "reward", "terminated", "lines")):
            _fn_equal(got_, ref, f"step {i} {what}")
        s = ks


@pytest.mark.cuda
def test_fn_launch_counts(cuda):
    from tetris_gymnasium_torch.config import EnvConfig
    from tetris_gymnasium_torch.core import fn_env

    config = EnvConfig()
    kernels.reset_launches()
    _, s, _ = fn_env.batched_reset(batch_keys(prng_key(0), 64, device=cuda), config=config)
    fn_env.rollout(s, torch.zeros((5, 64), dtype=torch.int32, device=cuda), config)
    fn_env.observe(s, config)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**NO_LAUNCHES, "fn_reset": 1, "fn_step": 5, "fn_observe": 1}


@pytest.mark.cuda
def test_grayscale_u8_exact_kernel_matches_plain(cuda):
    from tetris_gymnasium_torch.ops import image

    i = torch.arange(1 << 24, device=cuda, dtype=torch.int32)
    rgb = torch.stack([i >> 16, (i >> 8) & 255, i & 255], dim=-1).to(torch.uint8)
    _assert_equal(image.grayscale_u8_exact(rgb), image.grayscale_u8_exact_plain(rgb), "all triples")
    odd = rgb[1:1000]  # not on a 4-byte boundary: the one-pixel path
    _assert_equal(image.grayscale_u8_exact(odd), image.grayscale_u8_exact_plain(odd), "unaligned")


def test_fn_kernel_wrappers_refuse_cpu_tensors_and_named_limits():
    from tetris_gymnasium_torch.config import EnvConfig
    from tetris_gymnasium_torch.core import fn_env

    config = EnvConfig()
    keys = batch_keys(prng_key(0), 2, device="cpu")
    _, s, _ = fn_env.reset(keys, config, device="cpu")
    a = torch.zeros(2, dtype=torch.int32)
    for call in (lambda: kernels.fn_reset(keys, config, turbo.PIECES),
                 lambda: kernels.fn_step(s, a, config, turbo.PIECES),
                 lambda: kernels.fn_observe(s, config, turbo.PIECES)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    for bad, match in ((EnvConfig(queue_size=8), "queue size 8"), (EnvConfig(padding=0), "padding 0"),
                       (EnvConfig(width=80, height=40), "3056")):
        with pytest.raises(NotImplementedError, match=match):
            kernels.fn_defines(bad, turbo.PIECES)
    with pytest.raises(NotImplementedError, match="BAG_QUEUE and UNIFORM_QUEUE"):
        fn_env._queue_fns_kind(fn_env.QueueFns(create=None, next_piece=None))
    assert kernels.fn_defines(EnvConfig(width=8, height=12, padding=2), turbo.PIECES) == (
        ("TETRIS_HEIGHT", 12), ("TETRIS_WIDTH", 8), ("TETRIS_PAD", 2), ("TETRIS_QS", 7), ("TETRIS_NP", 7),
        ("TETRIS_S", 4))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 1001])
def test_sampling_kernels_at_a_global_counter_offset(cuda, B):
    """``ppo_sample``, ``turbo_step``'s sampling build and ``dqn_act`` at env
    offsets 0, B and 3B: equal to their plain versions at that offset and to
    the slice of one launch over 4B envs (a rank's share of a larger batch)."""
    import dataclasses

    config, rw = EngineConfig(auto_reset=True), RewardsMapping()
    g = torch.Generator(device=cuda)
    g.manual_seed(9)
    full = 4 * B
    logits = torch.randn((full, 8), generator=g, device=cuda) * 3
    q = torch.randn((full, 8), generator=g, device=cuda)
    key, eps_key = prng_key(7), prng_key(8)
    s = turbo.init(batch_keys(prng_key(6), full, device=cuda), config, device=cuda)
    obs_full = torch.empty((full, 20, 10), dtype=torch.int8, device=cuda)
    whole = (kernels.sample_actions(logits, key),
             kernels.turbo_step(s, None, config, turbo.PIECES, rw, obs=obs_full, logits=logits,
                                act_key=key),
             kernels.dqn_act(q, key, eps_key, 0.5))
    for off in (0, B, 3 * B):
        x, qx = logits[off:off + B].contiguous(), q[off:off + B].contiguous()
        got = kernels.sample_actions(x, key, env_offset=off)
        plain = ppo.sample_actions_plain(x, key, off)
        for i in range(2):
            _assert_equal(got[i], plain[i], f"ppo_sample @ {off}")
            _assert_equal(got[i], whole[0][i][off:off + B], f"ppo_sample slice @ {off}")
        part = dataclasses.replace(s, **{k: getattr(s, k)[..., off:off + B].contiguous()
                                         for k in turbo.FIELDS})
        obs = torch.empty((B, 20, 10), dtype=torch.int8, device=cuda)
        ks, kr, kd, kl, ka, klp = kernels.turbo_step(part, None, config, turbo.PIECES, rw, obs=obs,
                                                     logits=x, act_key=key, env_offset=off)
        ws, wr, wd, wl, wa, wlp = whole[1]
        for k in turbo.FIELDS:
            _assert_equal(getattr(ks, k), getattr(ws, k)[..., off:off + B], f"turbo {k} @ {off}")
        for a, b, what in ((kr, wr, "reward"), (kd, wd, "done"), (kl, wl, "lines"),
                           (ka, wa, "action"), (klp, wlp, "log_prob"), (obs, obs_full, "obs")):
            _assert_equal(a, b[off:off + B], f"turbo {what} @ {off}")
        _assert_equal(ka, plain[0], f"turbo action vs plain @ {off}")
        act = kernels.dqn_act(qx, key, eps_key, 0.5, env_offset=off)
        _assert_equal(act, dqn.act_plain(qx, key, eps_key, 0.5, env_offset=off), f"dqn_act @ {off}")
        _assert_equal(act, whole[2][off:off + B], f"dqn_act slice @ {off}")


def test_sampling_kernels_check_their_global_counters():
    kernels._check_counters(0, 2**28 - 1, 8)
    kernels._check_counters(2**28 - 2, 1, 8)
    kernels._check_counters(2**31 - 5, 4, 1)
    for args in ((2**28 - 1, 1, 8), (2**31 - 4, 4, 1)):
        with pytest.raises(ValueError, match="32-bit counters"):
            kernels._check_counters(*args)
    with pytest.raises(ValueError, match="env_offset must be >= 0"):
        kernels._check_counters(-1, 4, 8)
    config = EngineConfig()
    s = turbo.init(batch_keys(prng_key(0), 4, device="cpu"), config, device="cpu")
    with pytest.raises(ValueError, match="env_offset without logits"):
        kernels.turbo_step(s, torch.zeros(4, dtype=torch.int32), config, turbo.PIECES,
                           RewardsMapping(), env_offset=4)
