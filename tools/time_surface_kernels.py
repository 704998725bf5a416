#!/usr/bin/env python3
"""Device ms of the six surface kernels' default builds (10x20, the 7
standard pieces) at the shapes the earlier slices time them, and of the
pixel path's two redesigned kernels, for the port found under ``--repo``:

    python tools/time_surface_kernels.py [--repo DIR] [--label NAME] [--ptxas]
                                         [--batches 512,2048,65536] [--ablate]

``grouped_flagship`` features at B = 4096 (``chip_smoke.py`` phase 30),
``grouped_placements`` features at B = 1024 (phase 16), ``feature_vector``,
``observe_dict`` and ``compose_rgb`` at B = 1, 4096 and 65536 (phase 30);
``render_rgb84`` and ``flagship_step`` (as the wrapper takes it, and each
build of ``kernels.FLAGSHIP_LANES`` where the tree has them) at B = 512,
2048 and 65536 at 10x20 (phases 24-25, 45-46; ``--batches`` sets these)
and at B = 4096 and 65536 at 30x20 and 61x12 (phases 34, 39), beside the
launch floor.  Each on mid-game states, as the median over 7 replays of a
CUDA graph of 100 launches (10 at 65536).  What the other tree lacks is skipped.  With
``--ptxas`` it first builds ``render_rgb84`` and ``flagship_step`` at the
three geometries and prints each build's registers, spills and shared
memory.  With ``--ablate`` it times, in place of all that, the two pixel
kernels at 10x20 and ``--batches`` beside patched copies of their sources
that each skip one part (``ABLATIONS``, built under ``DIR/build/ablate/``):
the copies compute wrong frames and games by design, only their times mean
anything.  Prints one JSON line with the card's name and power limit.  To
compare two trees on one card, unpack the other into a directory that
``.gitignore`` lists and run both in one call, in turns: A, B, B, A.  Needs
a card; builds the kernels of ``DIR`` into its own ``build/``.
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
WIDE_B = (4096, 65536)  # B of the two pixel kernels at 30x20 and 61x12

# --ablate's patched copies: (source, variant, [(text, replacement), ...]).
_NO_STEP = ("    if (!e.game_over) {  // a finished", "    if (false) {  // a finished")
_NO_RESET = ("    if (p.auto_reset && done) {  // the counter", "    if (false) {  // the counter")
_NO_PACK = ("    pack_band(bd, bd_ids);\n",
            "    for (int r = 0; r < Band<L>::R; ++r) for (int j = 0; j < NW; ++j) bd.rows[r][j] = 0u;\n")
_NO_BOARDS = [("  stage_boards_in<", "  if (false) stage_boards_in<"),
              ("  stage_boards_out<", "  if (false) stage_boards_out<")]
ABLATIONS = [
    # what is left: the fields' loads and stores, the boards' staging, the pack
    ("flagship_step", "no_step_no_reset", [_NO_STEP, _NO_RESET]),
    ("flagship_step", "no_step_no_reset_no_pack", [_NO_STEP, _NO_RESET, _NO_PACK]),
    ("flagship_step", "no_step_no_reset_no_boards", [_NO_STEP, _NO_RESET, *_NO_BOARDS]),
    ("flagship_step", "no_pack", [_NO_PACK]),
    ("flagship_step", "no_lock_ids", [("          band_stamp_ids(", "          if (false) band_stamp_ids("),
                                      ("          band_commit_ids(", "          if (false) band_commit_ids(")]),
    ("flagship_step", "no_reset", [_NO_RESET]),
    ("flagship_step", "no_clear", [("const int nl = band_clear_lines(bd, HEIGHT, bits[t], &full);",
                                    "const int nl = 0;")]),
    ("render_rgb84", "no_vertical", [("  if (tid < kQuads * kGroups) {", "  if (false) {")]),
    ("render_rgb84", "no_horizontal", [("  if (band < kBands) {", "  if (false) {")]),
    ("render_rgb84", "no_image", [("cell < H * IW; cell += kThreads", "cell < 0; cell += kThreads")]),
]


def ablate(repo, kernels, defines, cases, time_both) -> dict:
    """Device ms of each ``ABLATIONS`` copy and of the unpatched build
    ("full") on each ``B: (state, action)`` of ``cases``, made beforehand by
    the unpatched build; ``time_both(state, action)`` times the two kernels
    as the loaded libraries have them."""
    csrc = os.path.join(repo, "tetris_gymnasium_torch", "csrc")

    def build(job):
        source, variant, patches = job
        with open(os.path.join(csrc, f"{source}.cu")) as f:
            text = f.read()
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"time_surface_kernels: {source}.cu no longer holds {old!r}")
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

    with ThreadPoolExecutor(max_workers=len(ABLATIONS)) as pool:
        libs = list(pool.map(build, ABLATIONS))
    out = {}
    for B, case in cases.items():
        out.update({f"{k}_full@{B}": v for k, v in time_both(*case).items()})
    for (source, variant, _), so in zip(ABLATIONS, libs):
        lib = ctypes.CDLL(so)
        for fn, argtypes in kernels._ENTRY_POINTS[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        kernels._LIBS[(source, defines)] = lib
        for B, case in cases.items():
            out.update({f"{k}_{variant}@{B}": v for k, v in time_both(*case).items()
                        if k.startswith(source)})
        kernels._LIBS.pop((source, defines))  # back to the unpatched build
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--batches", default="512,2048,65536",
                    help="B of the two pixel kernels at 10x20")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    pixel_b = tuple(int(x) for x in args.batches.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("time_surface_kernels: needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.repo))
    from chip_smoke import _flagship_actions, _grouped_actions, device_ms
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops import bitboard as bb
    from tetris_gymnasium_torch.ops.observations import FeatureFlags
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    P, rw = engine.PIECES, RewardsMapping()
    geos = {"10x20": EngineConfig(auto_reset=True),
            "30x20": EngineConfig(width=30, height=20, auto_reset=True),
            "61x12": EngineConfig(width=61, height=12, queue_size=3, auto_reset=True)}
    builds = {}
    if args.ptxas:
        jobs = [(name, src, kernels.engine_defines(cfg, bb.turbo_tables(P), flagship=True))
                for name, cfg in geos.items() for src in ("render_rgb84", "flagship_step")]
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            facts = list(pool.map(lambda job: kernels._compile(job[1], job[2]), jobs))
        builds = {f"{src}@{name}": {"seconds": f["seconds"], "extra_flags": f.get("extra_flags"),
                                    "ptxas": [l.strip() for l in f["ptxas"].splitlines()
                                              if "registers" in l or "spill" in l or "Compiling" in l]}
                  for (name, src, _), f in zip(jobs, facts)}
    kernels.build([] if args.ablate else [(geos["30x20"], P), (geos["61x12"], P)])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(30)
    cfg, flags = geos["10x20"], FeatureFlags()
    lanes_builds = getattr(kernels, "FLAGSHIP_LANES", ())
    out = {"floor": device_ms(lambda: torch.cuda._sleep(0), 200)}

    def flagship_states(B, c=cfg):
        s = kernels.flagship_init(batch_keys(prng_key(30 + B), B, device=dev), c, P)
        for _ in range(40):
            s = kernels.flagship_step(s, _flagship_actions(B, g, dev), c, P, rw)[0]
        return s

    if args.ablate:
        def time_both(s, a):
            n = 10 if a.shape[0] >= 65536 else 100
            return {"render_rgb84": device_ms(lambda: kernels.render_rgb84(s, cfg, P), n),
                    **{f"flagship_step_lanes{L}": device_ms(
                        lambda: kernels.flagship_step(s, a, cfg, P, rw, lanes=L), n)
                       for L in lanes_builds}}

        cases = {B: (flagship_states(B), _flagship_actions(B, g, dev)) for B in pixel_b}
        out = ablate(os.path.abspath(args.repo), kernels,
                     kernels.engine_defines(cfg, bb.turbo_tables(P), flagship=True), cases, time_both)
        print(json.dumps({"label": args.label, "nvidia_smi": smi, "builds": builds, "ablate_ms": out}),
              flush=True)
        return
    for B in (1, 4096, 65536):
        n = 10 if B >= 65536 else 100
        s = flagship_states(B)
        d = kernels.observe_dict(s, cfg, P)
        crop = s.board[:, :20, 4:14]
        out[f"feature_vector@{B}"] = device_ms(lambda: kernels.feature_vector(crop, flags), n)
        out[f"observe_dict@{B}"] = device_ms(lambda: kernels.observe_dict(s, cfg, P), n)
        out[f"compose_rgb@{B}"] = device_ms(
            lambda: kernels.compose_rgb(d["board"], d["queue"], d["holder"], P), n)
        if B == 4096:
            out[f"grouped_flagship_features@{B}"] = device_ms(
                lambda: kernels.grouped_flagship(s, cfg, P, "features"), n)
        del s, d, crop
    # the pixel path's two kernels, each flagship_step build where the tree has them
    for name, c in geos.items():
        for B in (pixel_b if name == "10x20" else WIDE_B):
            n = 10 if B >= 65536 else 100
            s = flagship_states(B, c)
            a = _flagship_actions(B, g, dev)
            out[f"render_rgb84@{name}@{B}"] = device_ms(lambda: kernels.render_rgb84(s, c, P), n)
            out[f"flagship_step@{name}@{B}"] = device_ms(
                lambda: kernels.flagship_step(s, a, c, P, rw), n)
            for L in lanes_builds:
                out[f"flagship_step_lanes{L}@{name}@{B}"] = device_ms(
                    lambda: kernels.flagship_step(s, a, c, P, rw, lanes=L), n)
            del s, a
    gcfg = EngineConfig(gravity_enabled=False, auto_reset=True)
    gs, _ = tg.reset(batch_keys(prng_key(1), 1024, device=dev), gcfg, device=dev)
    for _ in range(20):
        gs = tg.step(gs, _grouped_actions(gs, g, dev, wild=0.0), gcfg)[0]
    out["grouped_placements_features@1024"] = device_ms(
        lambda: kernels.grouped_placements(gs.env, gcfg, turbo.PIECES, 4, "features"), 100)
    print(json.dumps({"label": args.label, "repo": os.path.abspath(args.repo), "nvidia_smi": smi,
                      "flagship_lanes": list(lanes_builds), "builds": builds, "ms": out}), flush=True)


if __name__ == "__main__":
    main()
