#!/usr/bin/env python3
"""Device ms of ``grouped_act``, ``grouped_flagship`` and
``grouped_placements`` for the port found under ``--repo``:

    python tools/time_grouped_kernels.py [--repo DIR] [--label NAME] [--ptxas] [--ablate]
        [--kernels act,flagship,placements]

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
envs (70.6 GB) are left out.  ``grouped_placements``
(the turbo grouped engine's) in both modes at 10x20 for B = 256, 512 (the
grouped evaluation's episodes), 1024 (the grouped DQN's batch), 4096 and
65536 and at 30x20, 61x12 and 30x14 (chip_smoke.py phase 36's geometry)
for B = 4096 and 65536, on mid-game states (20 random legal placements
in); float32 boards at 61x12 and 65536 envs (46.8 GB) are left out.  Each
the median over 7 replays of a CUDA graph of 100 launches (10 at 65536, 3
for wide boards at 65536).  ``--kernels`` times only the kernels it names
(all three by default).

With ``--ptxas`` it first builds both sources (``grouped_flagship.cu`` at
its three geometries, ``grouped_placements.cu`` at its four) and prints
each kernel's registers, spills and shared memory, and, where the tree has
them, each build's blocks an SM (``kernels.grouped_flagship_occupancy``,
``kernels.grouped_placements_occupancy``, ``kernels.grouped_act_occupancy``).
With ``--ablate`` it times, in place of all that, ``grouped_flagship`` at
10x20 (its three modes, B = 1, 4096 and 65536), ``grouped_act`` (B =
1024, 4096 and 65536) and ``grouped_placements`` (both modes, at 10x20 for
B = 256, 512, 1024, 4096 and 65536 and at 61x12 for 4096) beside patched
copies of this tree's sources that each skip or change one part
(``ABLATIONS``; built under ``DIR/build/ablate/``): their outputs are
wrong by design, only their times mean anything.  An older tree's ablation is
that tree's own copy of this tool.  Prints one JSON line with
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
PLACEMENT_B = (256, 512, 1024, 4096, 65536)
PLACEMENT_WIDE = WIDE + ("30x14",)  # 30x14: the turbo grouped engine's wide path (chip_smoke.py phase 36)
PLACEMENT_STEPS = 20

# --ablate's patched copies of this tree's sources: source -> [(variant,
# [(text, replacement), ...]), ...].  An older tree's are in its own copy of
# this tool (run it with --repo pointing at that tree).
_BLOCKS = "constexpr int kEnvs = 256 / A > 1 ? 256 / A : 1;  // envs a block"
ABLATIONS = {
    "grouped_flagship": [
        # no shared pass (the candidates read whatever shared memory holds)
        ("no_shared_pass", [("  for (int i = threadIdx.x; i < o_full + n_env * HEIGHT; i += blockDim.x) {",
                             "  for (int i = threadIdx.x; i < 0; i += blockDim.x) {")]),
        # no candidates (the staged vectors are written as they are)
        ("no_candidates", [("  if (e < n_env) {\n    const int b = b0 + e;",
                            "  if (false) {\n    const int b = b0 + e;")]),
        # every placed candidate folded into the height counters, none patched
        ("fold_all", [("      } else if (n == 0) {", "      } else if (n == 0 && false) {")]),
        # every window patched cell by cell
        ("cell_window", [("odd = pid8 <= 0;", "odd = true;")]),
        # blocks of 128 and of 64 threads' worth of envs
        ("blocks128", [(_BLOCKS, _BLOCKS.replace("256", "128"))]),
        ("blocks64", [(_BLOCKS, _BLOCKS.replace("256", "64"))]),
    ],
    "grouped_act": [
        # the noise's threefry replaced by a multiplicative hash
        ("no_threefry", [("tf::gumbel_uniform(tf::bits(p.act_k0, p.act_k1, 0u, c))",
                          "tf::gumbel_uniform(c * 2654435761u)")]),
    ],
    "grouped_placements": [
        # no shared pass (the candidates read whatever shared memory holds)
        ("no_shared_pass", [("  for (int i = threadIdx.x; i < o_rows + n_env * HEIGHT; i += blockDim.x) {",
                             "  for (int i = threadIdx.x; i < 0; i += blockDim.x) {")]),
        # the shared pass without the env's totals (sum, filled cells, maximum, bumpiness)
        ("no_totals", [("        atomicAdd(&es.sum, HEIGHT - top);\n", "        if (false) {\n"),
                       ("        if (col > PAD) atomicAdd(&es.bump, abs((lm ? first_bit(lm) : HEIGHT) - top));\n",
                        "        }\n")]),
        # no candidates (the staged vectors and chunks are written as they are)
        ("no_candidates", [("  if (e < n_env) {\n    const EnvShared& es = senv[e];",
                            "  if (false) {\n    const EnvShared& es = senv[e];")]),
        # every placed candidate through the block's column pass, none patched
        ("columns_all", [("      } else if (n == 0) {", "      } else if (n == 0 && false) {")]),
        # the batch-minor mask, game_over and lines are not written out
        ("no_ab_outputs", [("  for (int i = threadIdx.x; i < n_cand; i += blockDim.x) {\n    const int a = i / n_env",
                            "  for (int i = threadIdx.x; i < 0; i += blockDim.x) {\n    const int a = i / n_env")]),
        # the staged features are not written out
        ("no_features_write", [("  if (feat) {\n    if constexpr (kStageFeatures) {",
                                "  if (feat) {\n    if constexpr (false) {")]),
        # each thread stores its own features vector (none staged)
        ("unstaged", [("constexpr bool kStageFeatures = kStatic",
                       "constexpr bool kStageFeatures = false && kStatic")]),
        # the boards chunks are not built (the stream writes what shared memory holds)
        ("no_board_build", [("      build_row(buf + cr * WIDTH,", "      if (false) build_row(buf + cr * WIDTH,")]),
        # the boards chunks are built but not written out
        ("no_board_stream", [("    for (int i = threadIdx.x; i < nc * kCells / 4; i += blockDim.x) {",
                              "    for (int i = threadIdx.x; i < 0; i += blockDim.x) {")]),
        # every batch in blocks of the build's kEnvs envs, and of 128 threads' worth
        ("envs_full", [("  return std::min(kEnvs, std::max(1, (B + sms - 1) / sms));", "  return kEnvs;")]),
        ("blocks128", [(_BLOCKS, _BLOCKS.replace("256", "128"))]),
    ],
}


# (geometry, B) of each source's ablation timings
_ABLATED = {"grouped_flagship": [("10x20", B) for B in FLAGSHIP_B],
            "grouped_act": [(None, B) for B in ACT_B],
            "grouped_placements": [("10x20", B) for B in (256, 512, 1024, 4096, 65536)] + [("61x12", 4096)]}


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
    ap.add_argument("--kernels", default="act,flagship,placements")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_grouped_kernels: needs a CUDA card")
    chosen = {"grouped_" + k for k in args.kernels.split(",")}
    if not chosen <= set(ABLATIONS):
        raise SystemExit("time_grouped_kernels: --kernels takes act, flagship and placements")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from chip_smoke import GROUPED_WIDE, _flagship_actions, _grouped_actions, device_ms, wide_geometries
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
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
    geos["30x14"] = (EngineConfig(**GROUPED_WIDE), PIECES)
    act_lanes = getattr(kernels, "GROUPED_ACT_LANES", ())

    def defines(source, name):
        cfg, P = geos[name]
        return kernels.engine_defines(cfg, turbo.tables_for(P, "cpu")[0],
                                      flagship=source in kernels.FLAGSHIP_SOURCES)

    names = {"grouped_flagship": ("10x20",) + WIDE, "grouped_placements": ("10x20",) + PLACEMENT_WIDE}
    jobs = [(src, defines(src, name)) for src in ("grouped_flagship", "grouped_placements")
            if src in chosen for name in names[src]]
    jobs += [("grouped_act", ())] if "grouped_act" in chosen else []
    if args.ptxas:
        for job in jobs:  # ptxas speaks only when it compiles
            path = kernels._lib_path(kernels.SOURCES[job[0]], job[1])
            if path.exists():
                path.unlink()
    # every library the run loads, built in parallel (flagship_step and
    # turbo_step make the states)
    steps = [("flagship_step" if src == "grouped_flagship" else "turbo_step",
              defines("flagship_step" if src == "grouped_flagship" else "turbo_step", name))
             for src in ("grouped_flagship", "grouped_placements") if src in chosen for name in names[src]]
    with ThreadPoolExecutor(max_workers=len(jobs) + len(steps)) as pool:
        facts = list(pool.map(lambda job: kernels._compile(*job), jobs + steps))[:len(jobs)]
    builds = {}
    if args.ptxas:
        for (src, d), f in zip(jobs, facts):
            name = src if src == "grouped_act" else next(n for n in geos if defines(src, n) == d)
            entry = builds.setdefault(src, {})[name] = {"ptxas": _ptxas_lines(f["ptxas"]),
                                                         "extra_flags": f.get("extra_flags", [])}
            if src == "grouped_flagship" and hasattr(kernels, "grouped_flagship_occupancy"):
                entry["occupancy"] = kernels.grouped_flagship_occupancy(*geos[name])
            if src == "grouped_placements" and hasattr(kernels, "grouped_placements_occupancy"):
                entry["occupancy"] = kernels.grouped_placements_occupancy(*geos[name])
            if src == "grouped_act" and hasattr(kernels, "grouped_act_occupancy"):
                entry["occupancy"] = kernels.grouped_act_occupancy()

    def mid_game(cfg, P, B):
        s = kernels.flagship_init(batch_keys(prng_key(17 + B), B, device=dev), cfg, P)
        for _ in range(MID_GAME_STEPS):
            s = kernels.flagship_step(s, _flagship_actions(B, g, dev), cfg, P, RewardsMapping())[0]
        return s

    def placement_state(name, B):
        cfg, P = geos[name]
        cfg = cfg._replace(gravity_enabled=False, auto_reset=True)
        gs, _ = tg.reset(batch_keys(prng_key(18 + B), B, device=dev), cfg, P, device=dev)
        for _ in range(PLACEMENT_STEPS):
            gs = tg.step(gs, _grouped_actions(gs, g, dev, wild=0.0), cfg, P)[0]
        return cfg, P, gs.env

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

    def placement_times(name, B, modes, reps, tag=""):
        cfg, P, s = placement_state(name, B)
        out = {}
        for mode in modes:
            big = B >= 65536 and mode == "boards" and name != "10x20"
            out[f"grouped_placements_{mode}{tag}@{name}@{B}"] = device_ms(
                lambda: kernels.grouped_placements(s, cfg, P, 4, mode), 3 if big else reps)
        del s
        torch.cuda.empty_cache()
        return out

    out = {"floor": device_ms(lambda: torch.cuda._sleep(0), 200)}
    if args.ablate:
        def ablation_inputs(src, name, B):
            if src == "grouped_flagship":
                return mid_game(*geos[name], B)
            if src == "grouped_placements":
                return placement_state(name, B)
            return (*act_inputs(B), *threefry.split(prng_key(B)))

        inputs = {(src, name, B): ablation_inputs(src, name, B)
                  for src in sorted(chosen) for name, B in _ABLATED[src]}

        def time_all(variant, src, name):
            res = {}
            reps = lambda B: 10 if B >= 65536 else 100
            for (s_, n_, B), x in inputs.items():
                if s_ != src or n_ != name:
                    continue
                at = f"{name}@{B}" if name else f"{B}"
                if src == "grouped_flagship":
                    c, p = geos[name]
                    for mode in ("features", "boards", "ids"):
                        res[f"grouped_flagship_{mode}_{variant}@{at}"] = device_ms(
                            lambda: kernels.grouped_flagship(x, c, p, mode), reps(B))
                elif src == "grouped_placements":
                    c, p, st = x
                    for mode in ("features", "boards"):
                        res[f"grouped_placements_{mode}_{variant}@{at}"] = device_ms(
                            lambda: kernels.grouped_placements(st, c, p, 4, mode), reps(B))
                else:
                    q, mask, ak, ek = x
                    res[f"grouped_act_{variant}@{at}"] = device_ms(
                        lambda: kernels.grouped_act(q, mask, ak, ek, EPSILON), reps(B))
            return res

        geo_names = {src: sorted({n for n, _ in _ABLATED[src]}, key=str) for src in chosen}
        for src in sorted(chosen):
            for name in geo_names[src]:
                out.update(time_all("full", src, name))
        jobs = [(src, variant, patches, name, defines(src, name) if name else ())
                for src in sorted(chosen) for variant, patches in ABLATIONS[src] for name in geo_names[src]]
        for (src, variant, _, name, d), so in zip(jobs, _patched_libs(repo, kernels, [
                (src, f"{variant}_{name}" if name else variant, patches, d)
                for src, variant, patches, name, d in jobs])):
            _load(kernels, so, src, d)
            out.update(time_all(variant, src, name))
            kernels._LIBS.pop((src, d))  # back to the unpatched build
        print(json.dumps({"label": args.label, "nvidia_smi": smi, "builds": builds, "ablate_ms": out}),
              flush=True)
        return

    if "grouped_act" in chosen:
        for B in ACT_B:
            out.update(act_times(B, f"@{B}", 10 if B >= 65536 else 100))
        for B in GREEDY_B:
            out.update(greedy_times(B, f"@{B}", 10 if B >= 65536 else 100))
    if "grouped_flagship" in chosen:
        for B in FLAGSHIP_B:
            out.update(flagship_times("10x20", B, ("features", "boards", "ids"), 10 if B >= 65536 else 100))
        for name in WIDE:
            for B in WIDE_B:
                modes = ("features", "ids") if (name == "61x12" and B >= 65536) else ("features", "boards", "ids")
                out.update(flagship_times(name, B, modes, 10 if B >= 65536 else 100))
    if "grouped_placements" in chosen:
        for B in PLACEMENT_B:
            out.update(placement_times("10x20", B, ("features", "boards"), 10 if B >= 65536 else 100))
        for name in PLACEMENT_WIDE:
            for B in WIDE_B:
                modes = ("features",) if (name == "61x12" and B >= 65536) else ("features", "boards")
                out.update(placement_times(name, B, modes, 10 if B >= 65536 else 100))
    print(json.dumps({"label": args.label, "repo": repo, "nvidia_smi": smi, "act_lanes": list(act_lanes),
                      "builds": builds, "ms": out}), flush=True)


if __name__ == "__main__":
    main()
