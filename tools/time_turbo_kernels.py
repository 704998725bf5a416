#!/usr/bin/env python3
"""Device ms of ``turbo_step``, ``observe_board``, PPO's sampling step and
``gae`` for the port found under ``--repo``, at the main paths' batches:

    python tools/time_turbo_kernels.py [--repo DIR] [--label NAME] [--batches 512,1024,8192,65536]
                                       [--ptxas] [--kernels step|init] [--ablate]

For each batch B: ``turbo_step`` as the wrapper launches it, without and
with the observation written in the same launch (where the tree's
``kernels.turbo_step`` takes ``obs``), each lanes-per-env build of
``kernels.STEP_LANES`` with and without it, ``observe_board`` alone and
the least launch the card takes (a CUDA graph of ``torch.cuda._sleep(0)``),
on mid-game states (40 random steps in, auto-reset on; the evaluation's B =
512 without it, as ``chip_smoke.py`` phase 6 times them), beside the byte
bound at 3.35 TB/s.  PPO's rollout step at each B: the sampling step (one
``turbo_step`` launch that samples the action from logits ``f32[B, 8]``,
steps and observes; as the wrapper launches it and each lanes build, where
the tree's ``kernels.turbo_step`` takes ``logits``) beside ``ppo_sample``
alone and ``ppo_sample`` + ``turbo_step`` with the observation (the two
launches a rollout step takes without it, in one graph), and ``gae`` at T =
128 (as the wrapper launches it, and each build of ``kernels.GAE_BUILDS``
where the tree has them), each beside its byte bound, and ``gae`` again
on inputs read from HBM (``_cold``: a read of 128 MiB before each launch
evicts the L2, and that read's own time is taken off), as the path gives
them after the policy's forward pass.  Then
``flagship_step`` (B = 512), ``grouped_placements`` (features, B = 1024, no
gravity) and ``grouped_flagship`` (features, B = 4096), whose sources share
``csrc/engine_common.cuh``.  Each time is the
median over 7 replays of a CUDA graph of 200 launches (50 at 65536).  With
``--ptxas`` it first builds ``turbo_step`` for the default board and
``chip_smoke.py``'s wide geometries, and ``gae``, and prints each build's
registers and spills.

``--kernels init``: ``turbo_init`` at ``INIT_SHAPES`` (10x20 at B = 512,
the evaluation; 1024, the grouped DQN, whose step re-initialises from the
state's ``[2, B]`` key through ``turbo.init_from_key``, timed that way too
as ``init_from_key``; 8192, ``TetrisVectorEnv``; 65536; 30x20 and 61x12 at
4096, 8192 and 65536), each beside its byte bound (the keys read once, the
state written once).  ``--ptxas`` builds ``turbo_step.cu`` at the default
board and ``chip_smoke.py``'s wide geometries first; ``--ablate`` times
``turbo_init`` at ``INIT_ABLATE_SHAPES`` beside patched copies of the
tree's sources (``INIT_ABLATIONS``, for this tree's design; an older tree
runs its own copy of this tool), built under ``DIR/build/ablate/``; most of
their states are wrong by design, only their times mean anything.

Prints one JSON line with the card's name and power limit.  To
compare two trees on one card, unpack the other into a directory that
``.gitignore`` lists and run both in one call, in turns: A, B, B, A.  Needs
a card; builds the kernels of ``DIR`` into its own ``build/``.
"""
import argparse
import ctypes
import inspect
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
L2_FLUSH_BYTES = 128 * 2**20  # over twice the H100's 50 MB L2

# --kernels init: the shapes (geometry, B), the shapes --ablate takes, and
# its patched copies of the sources: (variant, [(file, text, replacement),
# ...]), the files those of csrc/.
INIT_SHAPES = [("10x20", 512), ("10x20", 1024), ("10x20", 8192), ("10x20", 65536),
               ("30x20", 4096), ("30x20", 8192), ("30x20", 65536),
               ("61x12", 4096), ("61x12", 8192), ("61x12", 65536)]
INIT_ABLATE_SHAPES = [("10x20", 512), ("10x20", 1024), ("10x20", 8192), ("10x20", 65536), ("30x20", 8192),
                      ("30x20", 65536)]
# The design: env warps beside warps that stream the rows as 16-byte words,
# a short chain (the draws mixed at once, the bag in 4-bit entries of a
# word).
INIT_ABLATIONS = [
    ("no_rows", [("turbo_step.cu", "  for (; q < q1; q += S) {", "  for (; q < q0; q += S) {")]),
    ("no_chain", [("turbo_step.cu", "  Env e;\n  init_chain(e, k0, k1, uniform != 0, box);\n",
                   "  Env e{};\n  e.k0 = k0;\n  e.k1 = k1;\n")]),
    ("no_fields", [("turbo_step.cu", "  if (i < n) store_scalars(e, out, b, B);\n",
                    "  if (i < n) {\n    out.key[b] = e.k0;\n    out.piece[b] = e.x + e.queue[QS - 1];\n  }\n")]),
    ("no_rows_no_chain", [("turbo_step.cu", "  for (; q < q1; q += S) {", "  for (; q < q0; q += S) {"),
                          ("turbo_step.cu", "  Env e;\n  init_chain(e, k0, k1, uniform != 0, box);\n",
                           "  Env e{};\n  e.k0 = k0;\n  e.k1 = k1;\n")]),
    ("empty", [("turbo_step.cu", "  const int t = threadIdx.x, warp = t / 32, lane = t % 32;\n  const int base = blockIdx.x * E;",
                "  if (B > 0) return;\n  const int t = threadIdx.x, warp = t / 32, lane = t % 32;\n  const int base = blockIdx.x * E;")]),
    # a division by B a chunk in the stream's loop, in place of the
    # carried segment
    ("chunk_divides", [("turbo_step.cu", "      const uint32_t v = init_row_word(seg);",
                        "      const uint32_t v = init_row_word(4u * q / B);")]),
    # other shapes (their states are right): 128 envs a block at every B,
    # envs a block not rounded to whole warps, 128 threads a block (64
    # envs at most)
    ("envs_full", [("turbo_step.cu", "  return std::min(kInitEnvs, (per_sm + 31) / 32 * 32);",
                    "  return kInitEnvs;")]),
    ("envs_unaligned", [("turbo_step.cu", "  return std::min(kInitEnvs, (per_sm + 31) / 32 * 32);",
                         "  return std::min(kInitEnvs, std::max(1, per_sm));")]),
    ("threads128", [("turbo_step.cu", "constexpr int kInitThreads = 256;", "constexpr int kInitThreads = 128;")]),
    # engine_common.cuh's init_pieces (the steps' auto-reset: the draws one
    # after another, Fisher-Yates over a register array) in place of the
    # short chain; its states are right
    ("init_pieces", [("turbo_step.cu", "  Env e;\n  init_chain(e, k0, k1, uniform != 0, box);\n",
                      "  Env e;\n  init_pieces(e, k0, k1, uniform != 0, box);\n")]),
]


def _patched(csrc, patches):
    """``{file: text}`` of the files ``patches`` change, or None where one no longer holds its text."""
    texts = {}
    for name, old, new in patches:
        text = texts.get(name)
        if text is None:
            with open(os.path.join(csrc, name)) as f:
                text = f.read()
        if old not in text:
            return None
        texts[name] = text.replace(old, new)
    return texts


def init_main(args, repo, smi) -> None:
    """``--kernels init``: ``turbo_init``'s device ms at ``INIT_SHAPES``
    beside its byte bound (and ``turbo.init_from_key`` at the grouped DQN's
    1024), or with ``--ablate`` those of its patched copies."""
    from chip_smoke import device_ms, wide_geometries
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.ops import bitboard as bb
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    P = turbo.PIECES
    geos = {"10x20": EngineConfig(auto_reset=True),
            "30x20": EngineConfig(width=30, height=20, auto_reset=True),
            "61x12": EngineConfig(width=61, height=12, queue_size=3, auto_reset=True)}
    dev = torch.device("cuda")

    def defines(name):
        return kernels.engine_defines(geos[name], bb.turbo_tables(P))

    def time_init(name, B):
        cfg, keys = geos[name], batch_keys(prng_key(20 + B), B, device=dev)
        n = 50 if B >= 65536 else 200
        out = {"turbo_init": device_ms(lambda: kernels.turbo_init(keys, cfg, P), n)}
        if name == "10x20" and B == 1024:  # the grouped DQN's way, from the state's key
            key2b = kernels.turbo_init(keys, cfg, P).key
            out["init_from_key"] = device_ms(lambda: turbo.init_from_key(key2b, cfg, P), n)
        return out

    builds = {}
    jobs = [(name, defines(name)) for name in geos]
    if args.ptxas:
        jobs += [(name, kernels.engine_defines(cfg, bb.turbo_tables(p))) for name, cfg, p in wide_geometries()]
    jobs = [job for i, job in enumerate(jobs) if job[1] not in [d for _, d in jobs[:i]]]  # one a library
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        facts = list(pool.map(lambda job: kernels._compile("turbo_step", job[1]), jobs))
    if args.ptxas:
        builds = {name: {"seconds": f["seconds"], "extra_flags": f.get("extra_flags"),
                         "ptxas": [l.strip() for l in f["ptxas"].splitlines()
                                   if "turbo_init" in l or "registers" in l or "spill" in l]}
                  for (name, _), f in zip(jobs, facts)}
    if args.ablate:
        csrc = os.path.join(repo, "tetris_gymnasium_torch", "csrc")
        variants = INIT_ABLATIONS
        missing = [v for v, p in variants if _patched(csrc, p) is None]
        if missing:
            raise SystemExit(f"time_turbo_kernels: ablations {missing} do not match the sources")
        out = {f"full@{n}@{B}": time_init(n, B)["turbo_init"] for n, B in INIT_ABLATE_SHAPES}
        names = sorted({n for n, _ in INIT_ABLATE_SHAPES})

        def build(job):
            (variant, patches), name = job
            d = os.path.join(repo, "build", "ablate", f"turbo_init_{variant}_{name}")
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(csrc, d)
            for f, text in _patched(csrc, patches).items():
                with open(os.path.join(d, f), "w") as fh:
                    fh.write(text)
            so = os.path.join(d, "turbo_step.so")

            def nvcc(*extra):
                return subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *extra,
                                       *kernels._define_flags(defines(name)), "-o", so,
                                       os.path.join(d, "turbo_step.cu")], capture_output=True, text=True)

            r, extra = nvcc(), []
            if r.returncode and "Segmentation fault" in r.stderr:  # ptxas 12.9, as kernels._compile
                extra = ["-Xcicc", "-O1"]
                r = nvcc(*extra)
            if r.returncode:
                raise RuntimeError(f"nvcc failed for {variant} at {name}:\n{r.stderr[-3000:]}")
            return so, extra

        jobs = [(v, n) for v in variants for n in names]
        with ThreadPoolExecutor(max_workers=min(16, len(jobs))) as pool:
            libs = list(pool.map(build, jobs))
        flags = {f"{variant}@{name}": extra for ((variant, _), name), (_, extra) in zip(jobs, libs) if extra}
        for ((variant, _), name), (so, _) in zip(jobs, libs):
            lib = ctypes.CDLL(so)
            for fn, argtypes in kernels._ENTRY_POINTS["turbo_step"].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            kernels._LIBS[("turbo_step", defines(name))] = lib
            for n, B in INIT_ABLATE_SHAPES:
                if n == name:
                    out[f"{variant}@{n}@{B}"] = time_init(n, B)["turbo_init"]
            kernels._LIBS.pop(("turbo_step", defines(name)))  # back to the unpatched build
        print(json.dumps({"label": args.label, "repo": repo, "nvidia_smi": smi,
                          "extra_flags": flags, "builds": builds, "ablate_ms": out}), flush=True)
        return
    out = {"floor": device_ms(lambda: torch.cuda._sleep(0), 200)}
    shape = getattr(kernels, "turbo_init_shape", None)
    for name, B in INIT_SHAPES:
        cfg, keys = geos[name], batch_keys(prng_key(20 + B), B, device=dev)
        s = kernels.turbo_init(keys, cfg, P)
        io = keys.numel() * 4 + sum(getattr(s, k).numel() * getattr(s, k).element_size()
                                    for k in turbo.FIELDS)
        out.update({f"{k}@{name}@{B}": v for k, v in time_init(name, B).items()})
        out[f"bound@{name}@{B}"] = 1e3 * io / HBM_BYTES_PER_S
        if shape is not None:
            out[f"shape@{name}@{B}"] = shape(cfg, P, B)
        del s
    print(json.dumps({"label": args.label, "repo": repo, "nvidia_smi": smi, "builds": builds, "ms": out}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--batches", default="512,1024,8192,65536")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--kernels", choices=("step", "init"), default="step")
    ap.add_argument("--ablate", action="store_true", help="with --kernels init")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_turbo_kernels: needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.repo))
    if args.kernels == "init":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        init_main(args, os.path.abspath(args.repo), smi)
        return
    from chip_smoke import _flagship_actions, _grouped_actions, device_ms, nbytes
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops import bitboard as bb
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    fused = "obs" in inspect.signature(kernels.turbo_step).parameters
    sampled = "logits" in inspect.signature(kernels.turbo_step).parameters
    lanes_all = getattr(kernels, "STEP_LANES", ())
    gae_builds = getattr(kernels, "GAE_BUILDS", ())
    builds = {}
    if args.ptxas:
        from concurrent.futures import ThreadPoolExecutor

        from chip_smoke import wide_geometries

        geos = [("10x20", EngineConfig(), turbo.PIECES)] + list(wide_geometries())
        jobs = {}  # one build a set of defines (30x20 with and without gravity share one)
        for name, cfg, P in geos:
            defines = kernels.engine_defines(cfg, bb.turbo_tables(P))
            if defines not in jobs.values():
                jobs[name] = defines
        jobs = list(jobs.items()) + [("gae", ())]
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            facts = list(pool.map(lambda job: kernels._compile(
                "gae" if job[0] == "gae" else "turbo_step", job[1]), jobs))
        builds = {name: {"seconds": f["seconds"], "extra_flags": f.get("extra_flags"),
                         "ptxas": [l.strip() for l in f["ptxas"].splitlines()
                                   if "registers" in l or "spill" in l or "Compiling" in l]}
                  for (name, _), f in zip(jobs, facts)}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    rw = RewardsMapping()
    out = {}

    def floor():
        torch.cuda._sleep(0)

    out["launch_floor_ms"] = device_ms(floor, 200)
    flush_buf = torch.ones(L2_FLUSH_BYTES // 4, device=dev)
    sink = torch.empty((), device=dev)

    def flush():
        torch.sum(flush_buf, dim=0, out=sink)

    def cold_ms(fn, n):
        return device_ms(lambda: (flush(), fn()), n) - device_ms(flush, n)

    for B in (int(b) for b in args.batches.split(",")):
        cfg = EngineConfig(auto_reset=B != 512)
        n = 50 if B >= 65536 else 200
        s = kernels.turbo_init(batch_keys(prng_key(1), B, device=dev), cfg, turbo.PIECES)
        for _ in range(40):
            a = torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32)
            s = kernels.turbo_step(s, a, cfg, turbo.PIECES, rw)[0]
        a = torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32)
        obs = torch.empty((B, cfg.height, cfg.width), dtype=torch.int8, device=dev)
        step_bytes = 2 * nbytes(*(getattr(s, k) for k in turbo.FIELDS)) + nbytes(a) + B * 9
        obs_bytes = B * cfg.height * cfg.width
        row = {"turbo_step": device_ms(lambda: kernels.turbo_step(s, a, cfg, turbo.PIECES, rw), n),
               "observe_board": device_ms(lambda: kernels.observe_board(s, cfg, turbo.PIECES), n),
               "step_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S,
               "observe_bound_ms": 1e3 * (nbytes(s.rows[: cfg.height], s.piece, s.rotation, s.x,
                                                 s.y, s.game_over) + obs_bytes) / HBM_BYTES_PER_S,
               "fused_bound_ms": 1e3 * (step_bytes + obs_bytes) / HBM_BYTES_PER_S}
        if fused:
            row["lanes"] = kernels.step_lanes(B, cfg.height * cfg.width)
            row["turbo_step_obs"] = device_ms(
                lambda: kernels.turbo_step(s, a, cfg, turbo.PIECES, rw, obs=obs), n)
            for L in lanes_all:
                row[f"turbo_step_L{L}"] = device_ms(
                    lambda: kernels.turbo_step(s, a, cfg, turbo.PIECES, rw, lanes=L), n)
                row[f"turbo_step_obs_L{L}"] = device_ms(
                    lambda: kernels.turbo_step(s, a, cfg, turbo.PIECES, rw, obs=obs, lanes=L), n)
            # PPO's rollout step: the sample and the step in one launch, or two
            x = torch.randn((B, 8), generator=g, device=dev) * 3
            key = prng_key(7)
            sample_bytes = B * (8 * 4 + 4 + 4)
            row["ppo_sample"] = device_ms(lambda: kernels.sample_actions(x, key), n)
            row["ppo_sample_then_turbo_step_obs"] = device_ms(
                lambda: kernels.turbo_step(s, kernels.sample_actions(x, key)[0], cfg,
                                           turbo.PIECES, rw, obs=obs), n)
            row["sample_step_bound_ms"] = 1e3 * (step_bytes + obs_bytes + sample_bytes) \
                / HBM_BYTES_PER_S
            if sampled:
                row["sample_step"] = device_ms(lambda: kernels.turbo_step(
                    s, None, cfg, turbo.PIECES, rw, obs=obs, logits=x, act_key=key), n)
                for L in lanes_all:
                    row[f"sample_step_L{L}"] = device_ms(lambda: kernels.turbo_step(
                        s, None, cfg, turbo.PIECES, rw, obs=obs, lanes=L, logits=x,
                        act_key=key), n)
        # GAE over a rollout of 128 steps at this batch
        T = 128
        reward = torch.randn((T, B), generator=g, device=dev)
        value = torch.randn((T, B), generator=g, device=dev)
        done = torch.rand((T, B), generator=g, device=dev) < 1 / 200
        last = torch.randn((B,), generator=g, device=dev)
        row["gae"] = device_ms(lambda: kernels.gae(reward, value, done, last, 0.999, 0.95), n)
        row["gae_cold"] = cold_ms(lambda: kernels.gae(reward, value, done, last, 0.999, 0.95), n)
        row["gae_bound_ms"] = 1e3 * (17 * T * B + 4 * B) / HBM_BYTES_PER_S
        if gae_builds:
            row["gae_build"] = kernels.gae_build(B, reward, value, done, reward, value)
            for build in gae_builds:
                row[f"gae_{build}"] = device_ms(
                    lambda: kernels.gae(reward, value, done, last, 0.999, 0.95, build=build), n)
                row[f"gae_{build}_cold"] = cold_ms(
                    lambda: kernels.gae(reward, value, done, last, 0.999, 0.95, build=build), n)
        out[B] = row
        del s, a, obs, reward, value, done
    P = engine.PIECES
    fcfg = EngineConfig(auto_reset=True)
    fs = kernels.flagship_init(batch_keys(prng_key(31), 512, device=dev), fcfg, P)
    for _ in range(40):
        fs = kernels.flagship_step(fs, _flagship_actions(512, g, dev), fcfg, P, rw)[0]
    fa = _flagship_actions(512, g, dev)
    out["flagship_step@512"] = device_ms(lambda: kernels.flagship_step(fs, fa, fcfg, P, rw), 200)
    gcfg = EngineConfig(gravity_enabled=False, auto_reset=True)
    gs, _ = tg.reset(batch_keys(prng_key(1), 1024, device=dev), gcfg, device=dev)
    for _ in range(20):
        gs = tg.step(gs, _grouped_actions(gs, g, dev, wild=0.0), gcfg)[0]
    out["grouped_placements_features@1024"] = device_ms(
        lambda: kernels.grouped_placements(gs.env, gcfg, turbo.PIECES, 4, "features"), 200)
    fs4 = kernels.flagship_init(batch_keys(prng_key(32), 4096, device=dev), fcfg, P)
    for _ in range(40):
        fs4 = kernels.flagship_step(fs4, _flagship_actions(4096, g, dev), fcfg, P, rw)[0]
    out["grouped_flagship_features@4096"] = device_ms(
        lambda: kernels.grouped_flagship(fs4, fcfg, P, "features"), 200)
    print(json.dumps({"label": args.label, "repo": os.path.abspath(args.repo), "nvidia_smi": smi,
                      "builds": builds, "ms": out}), flush=True)


if __name__ == "__main__":
    main()
