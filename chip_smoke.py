#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``); no card fails.
2. build: every CUDA kernel of ``tetris_gymnasium_torch/csrc`` with ``nvcc``.
3. ``turbo_step`` and ``turbo_init`` against their plain PyTorch versions on
   the card, bit for bit, over random-action rollouts (B = 4096 with
   auto-reset; B = 4096 without gravity and with custom rewards; B = 512,
   the evaluation's shape; uniform pieces) and hand-built boards with up to
   six full rows.
4. ``observe_board`` against its plain version on every state of phase 3.
5. The main path: the committed PPO policy (``results/ppo_lines_params.npz``,
   bf16 trunk) plays 512 greedy games of at most 2000 steps through
   ``rl.evaluate.evaluate_policy``; every kernel's launch count is read.  A
   small fp32 evaluation on the card must equal the same evaluation run by
   the plain versions on the CPU.
6. Times with CUDA events at the evaluation's shape (B = 512), the
   training's (B = 8192) and B = 65536, beside each kernel's byte bound at
   3.35 TB/s.
7. ``gae`` against ``rl.ppo.gae_plain`` (bit-equal) and ``ppo_sample``
   against ``rl.ppo.sample_actions_plain`` (uniforms bit-equal, actions
   equal, log-probs within ``LOG_PROB_TOL``) at the training's shapes and at
   ragged ones.
8. A small fp32 PPO train step (64 envs, 8 steps, 2 epochs of 2
   minibatches, the committed weights) on the card against the same step on
   the CPU: rollouts bit-equal, parameter changes within 1e-3 of the largest.
9. The training path: ``examples/train_ppo.py``'s code warm-starts from the
   committed weights at 8192 envs x 128 steps, 6 epochs of 8 minibatches,
   bf16 trunk, lr 4e-5, ent-coef 0.004, for 3 train steps; every kernel's
   launch count is read, the metrics must be finite and the weights must
   move, and 512 greedy games of the trained weights must still clear 9.5
   lines each.  On the first minibatch of one more rollout, the training
   update must lower that minibatch's loss, and the clipped surrogate must
   be lower a small step down its gradient than a step up it (the sign of
   the gradient).  The train step's time is split into rollout, GAE and update
   with CUDA events, and one minibatch's into gather, forward, backward and
   optimizer.
10. ``gae`` and ``ppo_sample`` times at B = 8192 and 65536 beside their
    bounds.

Then the kernels line (launch counts of the training path, times at its
B = 8192) and, last, the device line.  Any failed check raises, so the exit
code is not 0.  The script imports nothing of JAX.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PARAMS = os.path.join(REPO, "results", "ppo_lines_params.npz")
EVAL_EPISODES, EVAL_MAX_STEPS, EVAL_SEED = 512, 2000, 0
JAX_LINES = 10.41  # JAX package, 512 greedy episodes (README.md)
MIN_LINES = 9.5
# The training path: examples/train_ppo.py warm-started at the phase-F
# settings of docs/scale/rl.md (lr 4e-5, ent-coef 0.004), default rewards.
TRAIN_ENVS, TRAIN_T, TRAIN_STEPS = 8192, 128, 3
TRAIN_ARGV = [
    "--n-envs", str(TRAIN_ENVS), "--rollout-len", str(TRAIN_T), "--update-epochs", "6",
    "--n-minibatches", "8", "--iterations", str(TRAIN_STEPS), "--chunk", str(TRAIN_STEPS),
    "--lr", "4e-5", "--ent-coef", "0.004", "--seed", "1", "--init-params", PARAMS,
]
# ppo_sample's log-prob against the plain version: logf and expf are within
# 1 and 2 ulps of exact (CUDA's documented error bounds), so
# a sum of exps is within 2 ulps (2**-22 relative) and its log within
# 2**-22 absolute plus an ulp of the result; both sides call the same
# functions, so bit-equality is expected and this bound is what is allowed.
LOG_PROB_ULPS = 2
# Peak rates of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM,
# 67 TFLOP/s float32 outside the tensor cores, counting an FMA as two, so
# 33.5e12 32-bit lane operations a second.
OPS_PER_S = 33.5e12
SAMPLE_OPS_PER_ELEMENT = 100  # threefry 75, uniform 6, gumbel 4, argmax 9, softmax 6
GAE_OPS_PER_ELEMENT = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# Largest |kernel - plain version| seen, by kernel.
MAX_ERR = {"turbo_step": 0.0, "turbo_init": 0.0, "observe_board": 0.0, "gae": 0.0,
           "ppo_sample": 0.0}


def bits(t):
    """A tensor's bits as int64 (floats by their bit patterns)."""
    if t.dtype in (torch.uint32, torch.float32):
        return t.view(torch.int32).to(torch.int64)
    return t.to(torch.int64)


def values(t):
    if t.dtype == torch.uint32:
        return (t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).to(torch.float64)
    return t.to(torch.float64)


def diff(kernel, a, b, what):
    """Records max |a - b| for ``kernel``; raises unless a and b are bit-equal."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    if a.numel():
        err = float((values(a) - values(b)).abs().max())
        MAX_ERR[kernel] = max(MAX_ERR[kernel], err)
    if not torch.equal(bits(a), bits(b)):
        bad = (bits(a) != bits(b)).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: kernel and plain version differ at {bad}")


def call_ms(fn, n):
    """Time per call as launched from Python (host overhead included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n, replays=7):
    """Device time per call: ``n`` calls captured in one CUDA graph; the
    median over ``replays`` timed replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(replays + 1)]
    marks[0].record()
    for m in marks[1:]:
        graph.replay()
        m.record()
    torch.cuda.synchronize()
    per = sorted(a.elapsed_time(b) / n for a, b in zip(marks, marks[1:]))
    del graph
    return per[len(per) // 2]


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, REPO)
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys
    from tetris_gymnasium_torch.rl.evaluate import evaluate_policy, greedy_logits
    from tetris_gymnasium_torch.utils.checkpoint import load_actor_critic

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    builds = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": [{k: b[k] for k in ("name", "seconds", "cached")} for b in builds]})
    for b in builds:
        for line in b["ptxas"].splitlines():
            print(f"  [{b['name']}] {line.strip()}", flush=True)

    # -- helpers ----------------------------------------------------------------
    def state_diff(kernel, ks, ps, what):
        for k in turbo.FIELDS:
            diff(kernel, getattr(ks, k), getattr(ps, k), f"{what}: {k}")

    # -- 3./4. kernels against their plain versions ---------------------------
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    runs = [
        ("autoreset", 4096, 500, EngineConfig(auto_reset=True), RewardsMapping()),
        ("nograv-rewards", 4096, 500, EngineConfig(gravity_enabled=False),
         RewardsMapping(alife=0.5, game_over=-2.0)),
        ("eval-shape", EVAL_EPISODES, 500, EngineConfig(), RewardsMapping()),
        ("uniform", 4096, 200, EngineConfig(auto_reset=True, queue_kind="uniform"),
         RewardsMapping()),
    ]
    checked = {"turbo_step": 0, "turbo_init": 0, "observe_board": 0}
    t0 = time.perf_counter()
    summary = []
    for name, B, T, cfg, rw in runs:
        keys = batch_keys(prng_key(0), B, device=dev)
        s = kernels.turbo_init(keys, cfg, turbo.PIECES)
        state_diff("turbo_init", s, turbo.init_plain(keys, cfg), f"{name} init")
        checked["turbo_init"] += 1
        n_done = n_lines = 0
        for i in range(T):
            diff("observe_board", kernels.observe_board(s, cfg, turbo.PIECES),
                 turbo.observe_board_plain(s, cfg), f"{name} obs @ {i}")
            checked["observe_board"] += 1
            a = torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32)
            ks, kr, kd, kl = kernels.turbo_step(s, a, cfg, turbo.PIECES, rw)
            ps, pr, pd, pl = turbo.step_plain(s, a, cfg, rewards=rw)
            state_diff("turbo_step", ks, ps, f"{name} step {i}")
            diff("turbo_step", kr, pr, f"{name} reward @ {i}")
            diff("turbo_step", kd, pd, f"{name} done @ {i}")
            diff("turbo_step", kl, pl, f"{name} lines @ {i}")
            checked["turbo_step"] += 1
            n_done += int((kd & ~s.game_over).sum())
            n_lines += int(kl.sum())
            s = ks
        summary.append({"run": name, "B": B, "steps": T, "episodes_ended": n_done,
                        "lines": n_lines})

    # hand-built boards: random stacks with 0..6 full rows and random pieces
    B = 4096
    cfg = EngineConfig()
    pad, height, width = cfg.padding, cfg.height, cfg.width
    play = ((1 << width) - 1) << pad
    s = kernels.turbo_init(batch_keys(prng_key(5), B, device=dev), cfg, turbo.PIECES)
    rows = turbo.u32_to_lanes(s.rows)
    garbage = torch.randint(0, 1 << width, (height - 8, B), generator=g, device=dev) << pad
    keep = torch.rand((height - 8, B), generator=g, device=dev) < 0.6
    rows[8:height] |= torch.where(keep, garbage, 0)
    n_full = torch.randint(0, 7, (B,), generator=g, device=dev)
    full = torch.arange(height, device=dev)[:, None] >= height - n_full
    rows[:height] |= torch.where(full, play, 0)
    s = s.replace(
        rows=turbo.lanes_to_u32(rows).contiguous(),
        piece=torch.randint(0, 7, (B,), generator=g, device=dev, dtype=torch.int32),
        rotation=torch.randint(0, 4, (B,), generator=g, device=dev, dtype=torch.int32),
        x=torch.randint(-3, 18, (B,), generator=g, device=dev, dtype=torch.int32),
        y=torch.randint(0, 5, (B,), generator=g, device=dev, dtype=torch.int32),
    )
    surgery = {}
    for max_clear in (4, height):
        a = torch.where(torch.rand((B,), generator=g, device=dev) < 0.5, 5,
                        torch.randint(0, 8, (B,), generator=g, device=dev)).to(torch.int32)
        ks, kr, kd, kl = kernels.turbo_step(s, a, cfg, turbo.PIECES, RewardsMapping(), max_clear)
        ps, pr, pd, pl = turbo.step_plain(s, a, cfg, max_clear=max_clear)
        state_diff("turbo_step", ks, ps, f"surgery max_clear={max_clear}")
        diff("turbo_step", kr, pr, "surgery reward")
        diff("turbo_step", kd, pd, "surgery done")
        diff("turbo_step", kl, pl, "surgery lines")
        diff("observe_board", kernels.observe_board(s, cfg, turbo.PIECES),
             turbo.observe_board_plain(s, cfg), "surgery obs")
        checked["turbo_step"] += 1
        checked["observe_board"] += 1
        surgery[max_clear] = {"lines_max": int(kl.max()), "done": int(kd.sum())}
        if max_clear == 4:
            # a drop onto five full rows overflows the envelope and ends the game
            over = (n_full >= 5) & kd & (kr == 0)
            if not bool(over.any()):
                raise AssertionError("no 5-full-row drop ended its game under max_clear=4")
        elif int(kl.max()) < 5:
            raise AssertionError("max_clear=20 cleared no 5-row stack")
    torch.cuda.synchronize()
    emit({"phase": "turbo_step", "bit_equal": True, "max_abs_err": MAX_ERR, "runs": summary,
          "surgery": surgery, "comparisons": checked["turbo_step"],
          "init_comparisons": checked["turbo_init"], "seconds": time.perf_counter() - t0})
    emit({"phase": "observe_board", "bit_equal": True, "comparisons": checked["observe_board"]})

    # -- 5. the main path --------------------------------------------------------
    # the same small fp32 evaluation on the card and in the plain CPU versions
    small = {}
    for where in ("cuda", "cpu"):
        net32 = load_actor_critic(PARAMS, device=where, dtype=torch.float32)
        small[where] = evaluate_policy(greedy_logits(net32), 8, EngineConfig(), prng_key(0),
                                       max_steps=400, device=where)
    for k in ("lines_mean", "length_mean", "return_mean", "episodes_completed", "truncated"):
        if small["cuda"][k] != small["cpu"][k]:
            raise AssertionError(f"small fp32 evaluation: {k} {small['cuda'][k]} on the card, "
                                 f"{small['cpu'][k]} on the CPU")

    net = load_actor_critic(PARAMS, device=dev)  # bf16 trunk, as the JAX evaluation ran
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = evaluate_policy(greedy_logits(net), EVAL_EPISODES, EngineConfig(), prng_key(EVAL_SEED),
                            max_steps=EVAL_MAX_STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    emit({"phase": "main_path", "stats": stats, "launches": launches, "seconds": wall,
          "ms_per_iteration": 1e3 * wall / max(stats["iterations"], 1),
          "small_fp32_equal_cpu": small["cuda"], "jax_reference_lines": JAX_LINES})
    it = stats["iterations"]
    if launches != {"turbo_step": it, "observe_board": it, "turbo_init": 1, "gae": 0,
                    "ppo_sample": 0}:
        raise AssertionError(f"launch counts {launches} do not match {it} iterations")
    if not stats["lines_mean"] >= MIN_LINES or stats["episodes_completed"] < 500:
        raise AssertionError(f"the policy played below the gate: {stats}")
    for k, v in stats.items():
        if v != v or abs(v) == float("inf"):
            raise AssertionError(f"stat {k} is not finite: {v}")

    # -- 6. times ----------------------------------------------------------------
    def state_bytes(s):
        return nbytes(*(getattr(s, k) for k in turbo.FIELDS))

    def time_kernels(B, cfg, n_kernel, n_plain):
        s = kernels.turbo_init(batch_keys(prng_key(1), B, device=dev), cfg, turbo.PIECES)
        # a state in mid-game: 40 random steps in
        for _ in range(40):
            a = torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32)
            s = kernels.turbo_step(s, a, cfg, turbo.PIECES, RewardsMapping())[0]
        a = torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32)
        keys = batch_keys(prng_key(2), B, device=dev)
        fns = {
            "turbo_step": (lambda: kernels.turbo_step(s, a, cfg, turbo.PIECES, RewardsMapping()),
                           lambda: turbo.step_plain(s, a, cfg),
                           2 * state_bytes(s) + nbytes(a) + B * (4 + 1 + 4)),
            "turbo_init": (lambda: kernels.turbo_init(keys, cfg, turbo.PIECES),
                           lambda: turbo.init_plain(keys, cfg),
                           nbytes(keys) + state_bytes(s)),
            "observe_board": (lambda: kernels.observe_board(s, cfg, turbo.PIECES),
                              lambda: turbo.observe_board_plain(s, cfg),
                              nbytes(s.rows[: cfg.height], s.piece, s.rotation, s.x, s.y,
                                     s.game_over) + B * cfg.height * cfg.width),
        }
        out = {}
        for name, (kernel_fn, plain_fn, io) in fns.items():
            out[name] = {
                "ms": device_ms(kernel_fn, n_kernel),
                "plain_ms": device_ms(plain_fn, n_plain),
                "call_ms": call_ms(kernel_fn, n_kernel),
                "plain_call_ms": call_ms(plain_fn, n_plain),
                "bytes": io,
            }
        for v in out.values():
            v["bound_ms"] = 1e3 * v["bytes"] / HBM_BYTES_PER_S
        return out

    times = {}
    for B, cfg in ((EVAL_EPISODES, EngineConfig()), (TRAIN_ENVS, EngineConfig(auto_reset=True)),
                   (65536, EngineConfig(auto_reset=True))):
        times[B] = time_kernels(B, cfg, n_kernel=200, n_plain=10)
        emit({"phase": "times", "B": B, "auto_reset": cfg.auto_reset, "kernels": times[B],
              "env_steps_per_s": B / (times[B]["turbo_step"]["ms"] * 1e-3),
              "nvidia_smi": smi})

    # where an iteration of the main path goes, at its shape
    cfg = EngineConfig()
    s = kernels.turbo_init(batch_keys(prng_key(EVAL_SEED), EVAL_EPISODES, device=dev), cfg,
                           turbo.PIECES)
    obs = kernels.observe_board(s, cfg, turbo.PIECES)
    act = greedy_logits(net)
    with torch.inference_mode():
        net_device = device_ms(lambda: net(obs), 50)
    net_call = call_ms(lambda: act(obs), 50)
    t512 = times[EVAL_EPISODES]
    emit({"phase": "breakdown", "B": EVAL_EPISODES, "iteration_ms": 1e3 * wall / max(it, 1),
          "policy_call_ms": net_call, "policy_device_ms": net_device,
          "turbo_step_call_ms": t512["turbo_step"]["call_ms"],
          "observe_board_call_ms": t512["observe_board"]["call_ms"],
          "device_ms_per_iteration": net_device + t512["turbo_step"]["ms"]
          + t512["observe_board"]["ms"],
          "nvidia_smi": smi})

    # -- 7.-10. the training slice ------------------------------------------------
    check_ppo_kernels(dev)
    check_small_train_step()
    train = train_full_width(dev, smi)
    ppo_times = time_ppo_kernels(dev, smi)

    sources = {
        "turbo_step": ("tetris_gymnasium_torch/csrc/turbo_step.cu",
                       "tetris_gymnasium_tpu/core/turbo.py:639"),
        "turbo_init": ("tetris_gymnasium_torch/csrc/turbo_step.cu",
                       "tetris_gymnasium_tpu/core/turbo.py:440"),
        "observe_board": ("tetris_gymnasium_torch/csrc/observe_board.cu",
                          "tetris_gymnasium_tpu/core/turbo.py:738"),
        "gae": ("tetris_gymnasium_torch/csrc/gae.cu", "tetris_gymnasium_tpu/rl/ppo.py:147"),
        "ppo_sample": ("tetris_gymnasium_torch/csrc/ppo_sample.cu",
                       "tetris_gymnasium_tpu/rl/ppo.py:184"),
    }
    at_train = {**times[TRAIN_ENVS], **ppo_times[TRAIN_ENVS]}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": train["launches"][name], "launches_eval": launches[name],
         "max_abs_err": MAX_ERR[name], "ms": at_train[name]["ms"],
         "plain_ms": at_train[name]["plain_ms"], "bound_ms": at_train[name]["bound_ms"],
         "bound_by": at_train[name].get("bound_by", "bytes"), "library_ms": None}
        for name, (src, rep) in sources.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def check_ppo_kernels(dev) -> None:
    """Phase 7: ``gae`` and ``ppo_sample`` against their plain versions."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.rl import ppo

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    t0 = time.perf_counter()
    gae_runs = []
    for T, B, p_done in ((TRAIN_T, TRAIN_ENVS, 1 / 200), (TRAIN_T, TRAIN_ENVS, 0.0),
                         (TRAIN_T, TRAIN_ENVS, 1.0), (TRAIN_T, 1, 1 / 200), (TRAIN_T, 1000, 0.3),
                         (5, 8191, 1 / 200)):
        reward = torch.randn((T, B), generator=g, device=dev)
        value = torch.randn((T, B), generator=g, device=dev) * 10
        done = torch.rand((T, B), generator=g, device=dev) < p_done
        last = torch.randn((B,), generator=g, device=dev) * 10
        got = kernels.gae(reward, value, done, last, 0.999, 0.95)
        want = ppo.gae_plain(reward, value, done, last, 0.999, 0.95)
        diff("gae", got[0], want[0], f"gae advantages T={T} B={B} p_done={p_done}")
        diff("gae", got[1], want[1], f"gae targets T={T} B={B} p_done={p_done}")
        gae_runs.append({"T": T, "B": B, "dones": int(done.sum())})

    sample_runs = []
    worst_ulps = 0
    lp_bit_equal = True
    for B, n_keys in ((TRAIN_ENVS, 16), (1, 4), (1001, 4)):
        counters = torch.arange(B * 8, dtype=torch.int64, device=dev).reshape(B, 8)
        for scale in ("near-ties", 1.0, 30.0):
            if scale == "near-ties":  # many logits equal, the rest 2**-20 apart
                logits = torch.randint(0, 3, (B, 8), generator=g, device=dev).float() * 2**-20
            else:
                logits = torch.randn((B, 8), generator=g, device=dev) * scale
            for i in range(n_keys):
                key = threefry.fold_in(threefry.prng_key(11), i)
                a, lp, u = kernels.sample_actions(logits, key, return_uniforms=True)
                pa, plp = ppo.sample_actions_plain(logits, key)
                pu = threefry.bits_to_uniform_lanes(threefry.random_bits32_lanes(key, counters),
                                                    threefry.TINY, 1.0)
                diff("ppo_sample", u, pu, f"uniforms B={B} scale={scale} key {i}")
                diff("ppo_sample", a, pa, f"actions B={B} scale={scale} key {i}")
                err = (lp.double() - plp.double()).abs()
                MAX_ERR["ppo_sample"] = max(MAX_ERR["ppo_sample"], float(err.max()))
                ulp = torch.from_numpy(np.spacing(plp.abs().cpu().numpy())).to(dev).double()
                tol = 2.0**-22 + LOG_PROB_ULPS * ulp
                if bool((err > tol).any()):
                    raise AssertionError(f"log_prob B={B} scale={scale} key {i}: max error "
                                         f"{float(err.max())} beyond the logf/expf bound")
                worst_ulps = max(worst_ulps, int((err / ulp).max()))
                lp_bit_equal &= torch.equal(bits(lp), bits(plp))
        sample_runs.append({"B": B, "keys": n_keys})
    torch.cuda.synchronize()
    emit({"phase": "ppo_kernels", "gae_bit_equal": True, "gae_runs": gae_runs,
          "sample_uniforms_bit_equal": True, "sample_actions_equal": True,
          "sample_log_prob_bit_equal": lp_bit_equal, "sample_log_prob_max_ulps": worst_ulps,
          "sample_runs": sample_runs, "max_abs_err": {k: MAX_ERR[k] for k in ("gae", "ppo_sample")},
          "seconds": time.perf_counter() - t0})


def check_small_train_step() -> None:
    """Phase 8: a small fp32 train step on the card against the same step on the CPU."""
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.models.networks import ActorCriticCNN
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.rl import ppo
    from tetris_gymnasium_torch.rl.engines import env_fns
    from tetris_gymnasium_torch.utils.checkpoint import load_flat

    t0 = time.perf_counter()
    cfg = ppo.PPOConfig(rollout_len=8, update_epochs=2, n_minibatches=2)
    env_config = EngineConfig(auto_reset=True)
    start = load_flat(PARAMS)
    out = {}
    for where in ("cuda", "cpu"):
        ts = ppo.init_train_state(prng_key(0), 64, env_config, cfg,
                                  net=ActorCriticCNN(dtype=torch.float32), device=where,
                                  params=start)
        _, env_step, observe = env_fns(env_config, device=where)
        traj = ppo.rollout(ts, cfg, env_step, observe)[0]
        ts, metrics = ppo.make_train_step(env_config, cfg)(ts)
        out[where] = (traj, to_flax_params(ts.net.state_dict()),
                      {k: float(v) for k, v in metrics.items()})
    (tc, pc, mc), (tp, pp, mp) = out["cuda"], out["cpu"]
    for k in ("obs", "action", "reward", "done"):
        if not torch.equal(getattr(tc, k).cpu(), getattr(tp, k)):
            raise AssertionError(f"small train step: rollout {k} differs between card and CPU")
    worst = 0.0
    for k, p0 in start.items():
        dc, dp = pc[k] - p0, pp[k] - p0
        scale = float(np.abs(dp).max())
        rel = float(np.abs(dc - dp).max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if scale == 0 or rel > 1e-3:
            raise AssertionError(f"small train step: {k} changed by {rel} of its largest change "
                                 f"({scale}) between card and CPU")
    emit({"phase": "small_train_step", "rollout_bit_equal": True,
          "param_change_max_rel_diff": worst, "metrics_cuda": mc, "metrics_cpu": mp,
          "seconds": time.perf_counter() - t0})


def train_full_width(dev, smi) -> dict:
    """Phase 9: the training path at full width, then its checks."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.examples import train_ppo
    from tetris_gymnasium_torch.models.convert import to_flax_params
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.rl import ppo
    from tetris_gymnasium_torch.rl.engines import env_fns
    from tetris_gymnasium_torch.rl.evaluate import evaluate_policy, greedy_logits
    from tetris_gymnasium_torch.utils.checkpoint import load_flat

    args = train_ppo.parse_args(TRAIN_ARGV)
    events = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.setdefault(name, []).append(ev)

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, records = train_ppo.train(args, marks=mark)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {"turbo_init": 1, "turbo_step": TRAIN_STEPS * TRAIN_T,
            "observe_board": TRAIN_STEPS * TRAIN_T + 1, "gae": TRAIN_STEPS,
            "ppo_sample": TRAIN_STEPS * TRAIN_T}
    if launches != want:
        raise AssertionError(f"training launch counts {launches}, want {want}")

    rec = records[-1]
    for k, v in rec.items():
        if not np.isfinite(v):
            raise AssertionError(f"training metric {k} is not finite: {v}")
    start = load_flat(PARAMS)
    trained = to_flax_params(ts.net.state_dict())
    moved = {k: float(np.abs(trained[k] - start[k]).max()) for k in start}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"some parameters did not move: {moved}")

    steps = []
    for i in range(TRAIN_STEPS):
        split = {"rollout_ms": events["start"][i].elapsed_time(events["rollout"][i]),
                 "gae_ms": events["rollout"][i].elapsed_time(events["gae"][i]),
                 "update_ms": events["gae"][i].elapsed_time(events["update"][i])}
        split["step_ms"] = events["start"][i].elapsed_time(events["update"][i])
        split["env_steps_per_s"] = TRAIN_ENVS * TRAIN_T / (split["step_ms"] * 1e-3)
        steps.append(split)
    emit({"phase": "train", "n_envs": TRAIN_ENVS, "rollout_len": TRAIN_T,
          "train_steps": TRAIN_STEPS, "record": rec, "launches": launches,
          "wall_s_with_setup": wall, "steps": steps, "param_max_change": moved,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "nvidia_smi": smi})

    # 512 greedy games of the trained weights
    t0 = time.perf_counter()
    stats = evaluate_policy(greedy_logits(ts.net), EVAL_EPISODES, EngineConfig(),
                            prng_key(EVAL_SEED), max_steps=EVAL_MAX_STEPS, device=dev)
    if not stats["lines_mean"] >= MIN_LINES or stats["episodes_completed"] < 500:
        raise AssertionError(f"the trained policy played below the gate: {stats}")

    # One more rollout; its first minibatch checks the gradient's sign.
    # (a) The training update (full loss, the run's Adam) must lower the full
    # loss of that minibatch.  (b) The value term dominates that loss here
    # (the committed value head was trained on other rewards), so the
    # clipped surrogate's own gradient g is checked by a central difference:
    # surrogate(w - eta*g) < surrogate(w + eta*g), with eta moving no weight
    # by more than the run's learning rate.  A fresh Adam step of the
    # surrogate alone moves every weight by about the learning rate, which
    # overshoots this near-deterministic policy; it is reported at lr and
    # lr / 10, not gated.
    cfg = ppo.PPOConfig(rollout_len=TRAIN_T, ent_coef=0.004, learning_rate=4e-5)
    _, env_step, observe = env_fns(EngineConfig(auto_reset=True), device=dev)
    traj, _, last_obs, key = ppo.rollout(ts, cfg, env_step, observe)
    with torch.no_grad():
        _, last_value = ts.net(last_obs)
    adv, tgt = ppo.gae(cfg, traj, last_value)
    _, perm_keys = ppo.epoch_keys(key, 1)
    batch, b_adv, b_tgt = next(ppo.minibatches(traj, adv, tgt, cfg, perm_keys))

    def losses(net):
        with torch.no_grad():
            total, (pg, _, _) = ppo.loss_fn(net, cfg, batch, b_adv, b_tgt, cfg.ent_coef)
        return total.item(), pg.item()

    def surrogate_grads(net):
        net.zero_grad()
        ppo.loss_fn(net, cfg, batch, b_adv, b_tgt, cfg.ent_coef)[1][0].backward()
        return [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in net.parameters()]

    def shifted(net, grads, step):
        out = copy.deepcopy(net)
        with torch.no_grad():
            for p, gr in zip(out.parameters(), grads):
                p.add_(gr, alpha=step)
        return out

    probe = {"minibatch": int(batch.action.shape[0])}
    probe["total_before"], probe["surrogate_before"] = losses(ts.net)
    grads = surrogate_grads(ts.net)
    eta = cfg.learning_rate / max(float(gr.abs().max()) for gr in grads)
    probe["surrogate_minus_eta_g"] = losses(shifted(ts.net, grads, -eta))[1]
    probe["surrogate_plus_eta_g"] = losses(shifted(ts.net, grads, eta))[1]
    for lr in (cfg.learning_rate, cfg.learning_rate / 10):
        net = copy.deepcopy(ts.net)
        opt = ppo.make_optimizer(cfg._replace(learning_rate=lr), net.parameters())
        surrogate_grads(net)
        opt.step()
        probe[f"surrogate_after_surrogate_adam_lr{lr:g}"] = losses(net)[1]
    loss = ppo.loss_fn(ts.net, cfg, batch, b_adv, b_tgt, cfg.ent_coef)[0]
    ts.optimizer.zero_grad()
    loss.backward()
    ts.optimizer.step()
    probe["total_after"], probe["surrogate_after"] = losses(ts.net)
    emit({"phase": "train_checks", "eval_after_training": stats, "gradient_sign_probe": probe,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    if not probe["total_after"] < probe["total_before"]:
        raise AssertionError(f"the training update raised its minibatch's loss: {probe}")
    if not probe["surrogate_minus_eta_g"] < probe["surrogate_plus_eta_g"]:
        raise AssertionError(f"the surrogate rises against its gradient: {probe}")

    # where the update's time goes: one minibatch at a time, CUDA events between parts
    marks = []

    def part(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    batches = ppo.minibatches(traj, adv, tgt, cfg, perm_keys)
    for _ in range(4):
        part("start")
        b, ba, bt = next(batches)
        part("gather")
        total, _ = ppo.loss_fn(ts.net, cfg, b, ba, bt, cfg.ent_coef)
        part("forward")
        ts.optimizer.zero_grad()
        total.backward()
        part("backward")
        ts.optimizer.step()
        part("optimizer")
    torch.cuda.synchronize()
    parts = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        if name != "start":
            parts[name] = parts.get(name, 0.0) + a.elapsed_time(b) / 4
    obs = traj.obs[0]
    with torch.no_grad():
        policy_ms = device_ms(lambda: ts.net(obs), 20)
        policy_call = call_ms(lambda: ts.net(obs), 20)
    emit({"phase": "train_breakdown", "minibatch_ms": parts, "policy_forward_device_ms": policy_ms,
          "policy_forward_call_ms": policy_call, "B": TRAIN_ENVS, "nvidia_smi": smi})
    return {"launches": launches, "steps": steps}


def time_ppo_kernels(dev, smi) -> dict:
    """Phase 10: ``gae`` and ``ppo_sample`` device times beside their bounds."""
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.rl import ppo

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    out = {}
    for B in (TRAIN_ENVS, 65536):
        T = TRAIN_T
        reward = torch.randn((T, B), generator=g, device=dev)
        value = torch.randn((T, B), generator=g, device=dev)
        done = torch.rand((T, B), generator=g, device=dev) < 1 / 200
        last = torch.randn((B,), generator=g, device=dev)
        logits = torch.randn((B, 8), generator=g, device=dev) * 3
        key = prng_key(5)
        fns = {
            "gae": (lambda: kernels.gae(reward, value, done, last, 0.999, 0.95),
                    lambda: ppo.gae_plain(reward, value, done, last, 0.999, 0.95),
                    nbytes(reward, value, done, last) + 2 * nbytes(reward),
                    GAE_OPS_PER_ELEMENT * T * B),
            "ppo_sample": (lambda: kernels.sample_actions(logits, key),
                           lambda: ppo.sample_actions_plain(logits, key),
                           nbytes(logits) + B * (4 + 4), SAMPLE_OPS_PER_ELEMENT * B * 8),
        }
        out[B] = {}
        for name, (kernel_fn, plain_fn, io, ops) in fns.items():
            bytes_ms, ops_ms = 1e3 * io / HBM_BYTES_PER_S, 1e3 * ops / OPS_PER_S
            out[B][name] = {
                "ms": device_ms(kernel_fn, 100),
                "plain_ms": device_ms(plain_fn, 3 if name == "gae" else 10),
                "call_ms": call_ms(kernel_fn, 100),
                "bytes": io, "operations": ops, "bytes_ms": bytes_ms, "operations_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            }
        emit({"phase": "ppo_times", "B": B, "T": TRAIN_T, "kernels": out[B], "nvidia_smi": smi})
    return out


if __name__ == "__main__":
    main()
