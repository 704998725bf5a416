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
6. Times with CUDA events at the main path's shapes (B = 512) and at
   B = 65536, beside each kernel's byte bound at 3.35 TB/s.

Then the kernels line and, last, the device line.  Any failed check raises,
so the exit code is not 0.  The script imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PARAMS = os.path.join(REPO, "results", "ppo_lines_params.npz")
EVAL_EPISODES, EVAL_MAX_STEPS, EVAL_SEED = 512, 2000, 0
JAX_LINES = 10.41  # JAX package, 512 greedy episodes (README.md)
MIN_LINES = 9.5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> None:
    import torch

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
    max_err = {"turbo_step": 0.0, "turbo_init": 0.0, "observe_board": 0.0}

    def bits(t):
        """A tensor's bits as int64 (floats by their bit patterns)."""
        if t.dtype in (torch.uint32, torch.float32):
            return t.view(torch.int32).to(torch.int64)
        return t.to(torch.int64)

    def values(t):
        if t.dtype == torch.uint32:
            return turbo.u32_to_lanes(t).to(torch.float64)
        return t.to(torch.float64)

    def diff(kernel, a, b, what):
        """Records max |a - b| for ``kernel``; raises unless a and b are bit-equal."""
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        if a.numel():
            err = float((values(a) - values(b)).abs().max())
            max_err[kernel] = max(max_err[kernel], err)
        if not torch.equal(bits(a), bits(b)):
            bad = (bits(a) != bits(b)).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: kernel and plain version differ at {bad}")

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
    emit({"phase": "turbo_step", "bit_equal": True, "max_abs_err": max_err, "runs": summary,
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
    if launches != {"turbo_step": it, "observe_board": it, "turbo_init": 1}:
        raise AssertionError(f"launch counts {launches} do not match {it} iterations")
    if not stats["lines_mean"] >= MIN_LINES or stats["episodes_completed"] < 500:
        raise AssertionError(f"the policy played below the gate: {stats}")
    for k, v in stats.items():
        if v != v or abs(v) == float("inf"):
            raise AssertionError(f"stat {k} is not finite: {v}")

    # -- 6. times ----------------------------------------------------------------
    def call_ms(fn, n):
        """Time per call as issued from Python (host overhead included)."""
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
    for B, cfg in ((EVAL_EPISODES, EngineConfig()), (65536, EngineConfig(auto_reset=True))):
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

    sources = {
        "turbo_step": ("tetris_gymnasium_torch/csrc/turbo_step.cu",
                       "tetris_gymnasium_tpu/core/turbo.py:639"),
        "turbo_init": ("tetris_gymnasium_torch/csrc/turbo_step.cu",
                       "tetris_gymnasium_tpu/core/turbo.py:440"),
        "observe_board": ("tetris_gymnasium_torch/csrc/observe_board.cu",
                          "tetris_gymnasium_tpu/core/turbo.py:738"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": max_err[name], "ms": t512[name]["ms"],
         "plain_ms": t512[name]["plain_ms"], "bound_ms": t512[name]["bound_ms"],
         "bound_by": "bytes", "library_ms": None}
        for name, (src, rep) in sources.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
