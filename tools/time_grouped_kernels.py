#!/usr/bin/env python3
"""Device ms of ``grouped_act`` and ``grouped_flagship`` for the port found
under ``--repo``:

    python tools/time_grouped_kernels.py [--repo DIR] [--label NAME] [--ptxas] [--ablate]

``grouped_act`` with exploration (epsilon 0.3) at B = 1024 (the grouped
DQN's batch), 4096 and 65536, its greedy launch (fill -inf, no draws, the
evaluation's) at 512, 1024 and 65536, and as a yardstick beside the greedy
launch ``torch.where(mask > 0, q, fill).argmax(-1)`` (two calls, so no
library time); the mask is the engine's ``[A, B]`` transposed, as the path
passes it.  Each as the wrapper takes it, and, where the tree has them,
each lane width of ``kernels.GROUPED_ACT_LANES``.  ``grouped_flagship`` in its
three modes (features under all flags, boards, ids) at 10x20 for B = 1,
4096 and 65536 and at 30x20 and 61x12 for B = 4096 and 65536, on mid-game
states (40 random flagship steps in); float32 boards at 61x12 and 65536
envs (70.6 GB) are left out.  Each the median over 7 replays of a CUDA
graph of 100 launches (10 at 65536, 3 for wide boards at 65536).

With ``--ptxas`` it first builds both sources (``grouped_flagship.cu`` at
the three geometries) and prints each kernel's registers, spills and shared
memory, and, where the tree has them, each build's blocks an SM
(``kernels.grouped_flagship_occupancy``, ``kernels.grouped_act_occupancy``).
With ``--ablate`` it times, in place of all that, ``grouped_flagship`` at
10x20 (its three modes, B = 1, 4096 and 65536) and ``grouped_act`` (B =
1024, 4096 and 65536) beside patched copies of their sources that each skip
or change one part (``ABLATIONS``: one list for the one-thread-a-candidate
sources that rebuild every output cell, one for the sources with an env's
shared pass, taken by which the tree at ``--repo`` holds; built under
``DIR/build/ablate/``): their outputs are wrong by design, only their times
mean anything.  Prints one JSON line with
the card's name and power limit.  To compare two trees on one card, unpack
the other into a directory that ``.gitignore`` lists and run both in one
call, in turns: A, B, B, A.  Needs a card; builds the kernels of ``DIR``
into its own ``build/``.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACT_B = (1024, 4096, 65536)
GREEDY_B = (512, 1024, 65536)
FLAGSHIP_B = (1, 4096, 65536)
WIDE_B = (4096, 65536)
WIDE = ("30x20", "61x12")
MID_GAME_STEPS = 40
EPSILON = 0.3

# --ablate's patched copies, by the tree whose sources they patch (the first
# list whose first patch the tree's grouped_flagship.cu holds):
# (source, variant, [(text, replacement), ...]).
_NO_THREEFRY = ("grouped_act", "no_threefry", [("tf::gumbel_uniform(tf::bits(p.act_k0, p.act_k1, 0u, c))",
                                                 "tf::gumbel_uniform(c * 2654435761u)")])
_BLOCKS = "constexpr int kEnvs = 256 / A > 1 ? 256 / A : 1;  // envs a block"
ABLATIONS = [
    [  # one thread a candidate, every output cell rebuilt
        # every output cell a function of its index alone (no rebuild from the board)
        ("grouped_flagship", "no_cells", [("    const int c = i / BOARD, rem = i % BOARD;\n",
                                           "    return static_cast<int8_t>(i);\n"
                                           "    const int c = i / BOARD, rem = i % BOARD;\n")]),
        # the kept rows are not folded into the height counters
        ("grouped_flagship", "no_fold", [("          acc.add_row(m);\n", "          if (false) acc.add_row(m);\n")]),
        # a constant hit map (every piece lands on the same row)
        ("grouped_flagship", "no_hit_map", [("    const HitMask hm = hit_map(rows, pword, x);\n",
                                             "    const HitMask hm = HitMask{1} << (H - S);\n")]),
        # the window rows are not summed cell by cell
        ("grouped_flagship", "no_window_sums", [("      for (int c = 0; c < WIDTH; ++c) {\n        const int j = PAD + c - xc;\n",
                                                 "      for (int c = 0; c < 0; ++c) {\n        const int j = PAD + c - xc;\n")]),
        _NO_THREEFRY,
    ],
    [  # an env's shared pass, then the candidates
        # no shared pass (the candidates read whatever shared memory holds)
        ("grouped_flagship", "no_shared_pass", [("  for (int i = threadIdx.x; i < o_full + n_env * HEIGHT; i += blockDim.x) {",
                                                 "  for (int i = threadIdx.x; i < 0; i += blockDim.x) {")]),
        # no candidates (the staged vectors are written as they are)
        ("grouped_flagship", "no_candidates", [("  if (e < n_env) {\n    const int b = b0 + e;",
                                                "  if (false) {\n    const int b = b0 + e;")]),
        # every placed candidate folded into the height counters, none patched
        ("grouped_flagship", "fold_all", [("      } else if (n == 0) {", "      } else if (n == 0 && false) {")]),
        # every window patched cell by cell
        ("grouped_flagship", "cell_window", [("odd = pid8 <= 0;", "odd = true;")]),
        # blocks of 128 and of 64 threads' worth of envs
        ("grouped_flagship", "blocks128", [(_BLOCKS, _BLOCKS.replace("256", "128"))]),
        ("grouped_flagship", "blocks64", [(_BLOCKS, _BLOCKS.replace("256", "64"))]),
        _NO_THREEFRY,
    ],
]


def _ablations(repo):
    """The list of ``ABLATIONS`` that patches the tree at ``repo``."""
    with open(os.path.join(repo, "tetris_gymnasium_torch", "csrc", "grouped_flagship.cu")) as f:
        text = f.read()
    for variants in ABLATIONS:
        if text.count(variants[0][2][0][0]) == 1:
            return variants
    raise SystemExit("time_grouped_kernels: no ablation list patches this tree's grouped_flagship.cu")


def _patched_libs(repo, kernels, jobs):
    """Build each ``(source, variant, patches, defines)`` of ``jobs`` from a
    patched copy of ``DIR``'s ``csrc/``; returns the libraries' paths."""
    csrc = os.path.join(repo, "tetris_gymnasium_torch", "csrc")

    def build(job):
        source, variant, patches, defines = job
        with open(os.path.join(csrc, f"{source}.cu")) as f:
            text = f.read()
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"time_grouped_kernels: {source}.cu does not hold {old!r} once")
            text = text.replace(old, new)
        d = os.path.join(repo, "build", "ablate", f"{source}_{variant}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        path, so = os.path.join(d, f"{source}.cu"), os.path.join(d, f"{source}.so")
        with open(path, "w") as f:
            f.write(text)
        r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *kernels._define_flags(defines),
                            "-o", so, path], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {source} {variant}:\n{r.stderr[-3000:]}")
        return so

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return list(pool.map(build, jobs))


def _load(kernels, so, source, defines):
    lib = ctypes.CDLL(so)
    for fn, argtypes in kernels._ENTRY_POINTS[source].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    kernels._LIBS[(source, defines)] = lib


def _ptxas_lines(text):
    return [l.strip() for l in text.splitlines()
            if "registers" in l or "spill" in l or "Compiling" in l or "smem" in l]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_grouped_kernels: needs a CUDA card")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from chip_smoke import _flagship_actions, device_ms, wide_geometries
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.ops import threefry
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys
    from tetris_gymnasium_torch.pieces import PIECES

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    geos = {"10x20": (EngineConfig(auto_reset=True), PIECES)}
    geos.update({name: (cfg, P) for name, cfg, P in wide_geometries() if name in WIDE})
    act_lanes = getattr(kernels, "GROUPED_ACT_LANES", ())
    jobs = [("grouped_flagship", kernels.engine_defines(c, turbo.tables_for(P, "cpu")[0], flagship=True))
            for c, P in geos.values()] + [("grouped_act", ())]
    builds = {}
    if args.ptxas:
        for job in jobs:  # ptxas speaks only when it compiles
            path = kernels._lib_path(kernels.SOURCES[job[0]], job[1])
            if path.exists():
                path.unlink()
    # every library the run loads, built in parallel (flagship_step makes the states)
    steps = [("flagship_step", d) for _, d in jobs[:-1]]
    with ThreadPoolExecutor(max_workers=len(jobs) + len(steps)) as pool:
        facts = list(pool.map(lambda job: kernels._compile(*job), jobs + steps))[:len(jobs)]
    if args.ptxas:
        for name, f in zip([*geos, "grouped_act"], facts):
            builds[name] = {"ptxas": _ptxas_lines(f["ptxas"]), "extra_flags": f.get("extra_flags", [])}
            if name in geos and hasattr(kernels, "grouped_flagship_occupancy"):
                builds[name]["occupancy"] = kernels.grouped_flagship_occupancy(*geos[name])
        if hasattr(kernels, "grouped_act_occupancy"):
            builds["grouped_act"]["occupancy"] = kernels.grouped_act_occupancy()

    def mid_game(cfg, P, B):
        s = kernels.flagship_init(batch_keys(prng_key(17 + B), B, device=dev), cfg, P)
        for _ in range(MID_GAME_STEPS):
            s = kernels.flagship_step(s, _flagship_actions(B, g, dev), cfg, P, RewardsMapping())[0]
        return s

    def act_inputs(B, A=40):
        q = torch.randn((B, A), generator=g, device=dev)
        mask = (torch.rand((A, B), generator=g, device=dev) < 0.5).float().T  # the engine's [A, B]
        return q, mask

    def act_times(B, tag, reps):
        q, mask = act_inputs(B)
        ak, ek = threefry.split(prng_key(B))
        out = {f"grouped_act{tag}": device_ms(lambda: kernels.grouped_act(q, mask, ak, ek, EPSILON), reps)}
        for lanes in act_lanes:
            out[f"grouped_act_l{lanes}{tag}"] = device_ms(
                lambda: kernels.grouped_act(q, mask, ak, ek, EPSILON, lanes=lanes), reps)
        return out

    def greedy_times(B, tag, reps):
        q, mask = act_inputs(B)
        fill = float("-inf")
        out = {f"grouped_act_greedy{tag}": device_ms(lambda: kernels.grouped_act(q, mask, fill=fill), reps),
               f"where_argmax{tag}": device_ms(lambda: torch.where(mask > 0, q, fill).argmax(-1), reps)}
        for lanes in act_lanes:
            out[f"grouped_act_greedy_l{lanes}{tag}"] = device_ms(
                lambda: kernels.grouped_act(q, mask, fill=fill, lanes=lanes), reps)
        return out

    def flagship_times(name, B, modes, reps):
        cfg, P = geos[name]
        s = mid_game(cfg, P, B)
        out = {}
        for mode in modes:
            big = B >= 65536 and mode == "boards" and name != "10x20"
            out[f"grouped_flagship_{mode}@{name}@{B}"] = device_ms(
                lambda: kernels.grouped_flagship(s, cfg, P, mode), 3 if big else reps)
        del s
        torch.cuda.empty_cache()
        return out

    out = {"floor": device_ms(lambda: torch.cuda._sleep(0), 200)}
    if args.ablate:
        cfg, P = geos["10x20"]
        defines = kernels.engine_defines(cfg, turbo.tables_for(P, "cpu")[0], flagship=True)
        states = {B: mid_game(cfg, P, B) for B in FLAGSHIP_B}
        acts = {B: (*act_inputs(B), *threefry.split(prng_key(B))) for B in ACT_B}

        def time_all(variant, source):
            res = {}
            if source == "grouped_flagship":
                for B, s in states.items():
                    for mode in ("features", "boards", "ids"):
                        res[f"grouped_flagship_{mode}_{variant}@{B}"] = device_ms(
                            lambda: kernels.grouped_flagship(s, cfg, P, mode), 10 if B >= 65536 else 100)
            else:
                for B, (q, mask, ak, ek) in acts.items():
                    res[f"grouped_act_{variant}@{B}"] = device_ms(
                        lambda: kernels.grouped_act(q, mask, ak, ek, EPSILON), 10 if B >= 65536 else 100)
            return res

        out.update(time_all("full", "grouped_flagship"))
        out.update(time_all("full", "grouped_act"))
        jobs = [(src, variant, patches, defines if src == "grouped_flagship" else ())
                for src, variant, patches in _ablations(repo)]
        for (src, variant, _, d), so in zip(jobs, _patched_libs(repo, kernels, jobs)):
            _load(kernels, so, src, d)
            out.update(time_all(variant, src))
            kernels._LIBS.pop((src, d))  # back to the unpatched build
        print(json.dumps({"label": args.label, "nvidia_smi": smi, "builds": builds, "ablate_ms": out}),
              flush=True)
        return

    for B in ACT_B:
        out.update(act_times(B, f"@{B}", 10 if B >= 65536 else 100))
    for B in GREEDY_B:
        out.update(greedy_times(B, f"@{B}", 10 if B >= 65536 else 100))
    for B in FLAGSHIP_B:
        out.update(flagship_times("10x20", B, ("features", "boards", "ids"), 10 if B >= 65536 else 100))
    for name in WIDE:
        for B in WIDE_B:
            modes = ("features", "ids") if (name == "61x12" and B >= 65536) else ("features", "boards", "ids")
            out.update(flagship_times(name, B, modes, 10 if B >= 65536 else 100))
    print(json.dumps({"label": args.label, "repo": repo, "nvidia_smi": smi, "act_lanes": list(act_lanes),
                      "builds": builds, "ms": out}), flush=True)


if __name__ == "__main__":
    main()
