#!/usr/bin/env python3
"""Where ``turbo_step``'s time goes, without a profiler: device ms of
patched copies of the kernel that skip one part of a step each.

    python tools/ablate_turbo_step.py [--batches 512,1024,8192]

Each variant copies ``tetris_gymnasium_torch/csrc`` into
``build/ablate/<variant>/``, applies its text patches to the copy, builds
``turbo_step.cu`` for the default board with ``nvcc`` and times
``turbo_step_launch`` on the same mid-game state as
``tools/time_turbo_kernels.py`` (40 random steps in, auto-reset on but at
B = 512), each lanes count without and with the observation.  The patched
kernels compute wrong games by design: only their times are read, beside
the unpatched build's ("base").  ``lanes`` adds the group sizes 2, 4 and 16
to the launcher's switch, to time lane counts the wrapper does not build.
A variant whose build fails (ptxas of CUDA 12.9 crashes on some) is
reported and skipped.  Prints one JSON line with the card's name and power
limit.  Needs a card.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
SWITCH_8 = ("    case 8:\n      return launch_lanes<8>(in, out, action, reward, done, lines, packed, "
            "box, obs, B, params, s);\n")
VARIANTS = {
    "base": [],
    # loads and stores only: no action, no gravity, no commit, no reset
    "no_step": [("turbo_step.cu", "  if (!e.game_over) {  // a finished", "  if (false) {  // a finished"),
                ("turbo_step.cu", "if (p.auto_reset && done) {", "if (false) {")],
    "no_action": [("turbo_step.cu", "    if constexpr (L == 1) apply_action<false>(e, a, uniform, packed, box);\n"
                   "    else band_apply_action(e, rows, a, uniform, packed, box);\n", "")],
    "no_swap": [("engine_common.cuh", "  if (a == kSwap && !e.has_swapped) {", "  if (false) {"),
                ("turbo_band.cuh", "  if (a == kSwap && !e.has_swapped) {", "  if (false) {")],
    "no_shuffle": [("engine_common.cuh", "  for (int i = NP - 1; i > 0; --i) {", "  for (int i = NP - 1; i > NP; --i) {")],
    "no_draw": [("turbo_step.cu", "const int new_piece = queue_draw(e, uniform);",
                 "const int new_piece = e.queue[0];")],
    "no_reset": [("turbo_step.cu", "if (p.auto_reset && done) {", "if (false) {")],
    "lanes": [("turbo_step.cu", SWITCH_8, "".join(
        SWITCH_8.replace("8", str(n)) for n in (2, 4, 8, 16)))],
}
LANES = {"lanes": (1, 2, 4, 8, 16)}


def build(name, patches, nvcc_flags, out_dir):
    d = out_dir / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(HERE / "tetris_gymnasium_torch" / "csrc", d)
    for f, old, new in patches:
        text = (d / f).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: the patch for {f} no longer matches the source")
        (d / f).write_text(text.replace(old, new))
    so = d / "turbo_step.so"
    r = subprocess.run(["/usr/local/cuda/bin/nvcc", *nvcc_flags, "-o", str(so), str(d / "turbo_step.cu")],
                       capture_output=True, text=True)
    return so if r.returncode == 0 else r.stderr.strip().splitlines()[-1:]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="512,1024,8192")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_turbo_step: needs a CUDA card")
    sys.path.insert(0, str(HERE))
    from chip_smoke import device_ms
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import turbo
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out_dir = HERE / "build" / "ablate"
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda kv: build(*kv, kernels.NVCC_FLAGS, out_dir), VARIANTS.items())))
    failed = {k: v for k, v in built.items() if not isinstance(v, Path)}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    rw = RewardsMapping()
    ms = {}
    for B in (int(b) for b in args.batches.split(",")):
        cfg = EngineConfig(auto_reset=B != 512)
        s = kernels.turbo_init(batch_keys(prng_key(1), B, device=dev), cfg, turbo.PIECES)
        for _ in range(40):
            a = torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32)
            s = kernels.turbo_step(s, a, cfg, turbo.PIECES, rw)[0]
        a = torch.randint(0, 8, (B,), generator=g, device=dev, dtype=torch.int32)
        obs = torch.empty((B, cfg.height, cfg.width), dtype=torch.int8, device=dev)
        _, packed, box = turbo.tables_for(turbo.PIECES, dev)
        out = kernels._empty_state(cfg, 7, B, dev)
        reward = torch.empty(B, device=dev)
        done = torch.empty(B, dtype=torch.bool, device=dev)
        lines = torch.empty(B, dtype=torch.int32, device=dev)
        params = kernels._StepParams(1, int(cfg.auto_reset), 0, 4, float(rw.alife), float(rw.game_over))
        in_p, out_p = kernels._ptrs(s), kernels._ptrs(out)
        for name, so in built.items():
            if name in failed:
                continue
            fn = ctypes.CDLL(str(so)).turbo_step_launch
            fn.argtypes = kernels._ENTRY_POINTS["turbo_step"]["turbo_step_launch"]
            fn.restype = ctypes.c_int
            for lanes in LANES.get(name, kernels.STEP_LANES):
                for o in (None, obs):
                    def call():
                        rc = fn(ctypes.byref(in_p), ctypes.byref(out_p), a.data_ptr(), reward.data_ptr(),
                                done.data_ptr(), lines.data_ptr(), packed.data_ptr(), box.data_ptr(),
                                None if o is None else o.data_ptr(), B, lanes, ctypes.byref(params),
                                torch.cuda.current_stream().cuda_stream)
                        if rc:
                            raise RuntimeError(f"{name}: CUDA error {rc}")
                    key = f"{name}@{B}/L{lanes}{'+obs' if o is not None else ''}"
                    ms[key] = device_ms(call, 50 if B >= 65536 else 200)
        del s, a, obs, out
    print(json.dumps({"nvidia_smi": smi, "failed_builds": failed, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
