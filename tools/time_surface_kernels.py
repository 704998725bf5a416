#!/usr/bin/env python3
"""Device ms of the six surface kernels' default builds (10x20, the 7
standard pieces) at the shapes the earlier slices time them, for the port
found under ``--repo``:

    python tools/time_surface_kernels.py [--repo DIR] [--label NAME]

``grouped_flagship`` features at B = 4096 and ``render_rgb84`` at B = 512
(``chip_smoke.py`` phases 30 and 25), ``grouped_placements`` features at
B = 1024 (phase 16), ``feature_vector``, ``observe_dict`` and
``compose_rgb`` at B = 1, 4096 and 65536 (phase 30), each on mid-game
states, as the median over 7 replays of a CUDA graph of 100 launches (10 at
65536).  Prints one JSON line with the card's name and power limit.  To
compare two trees on one card, unpack the other into a directory that
``.gitignore`` lists and run both in one call, in turns: A, B, B, A.  Needs
a card; builds the kernels of ``DIR`` into its own ``build/``.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_surface_kernels: needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.repo))
    from chip_smoke import _flagship_actions, _grouped_actions, device_ms
    from tetris_gymnasium_torch import kernels
    from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
    from tetris_gymnasium_torch.core import engine, turbo
    from tetris_gymnasium_torch.core import turbo_grouped as tg
    from tetris_gymnasium_torch.ops.observations import FeatureFlags
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    kernels.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(30)
    P, cfg, flags = engine.PIECES, EngineConfig(auto_reset=True), FeatureFlags()
    out = {}

    def flagship_states(B):
        s = kernels.flagship_init(batch_keys(prng_key(30 + B), B, device=dev), cfg, P)
        for _ in range(40):
            s = kernels.flagship_step(s, _flagship_actions(B, g, dev), cfg, P, RewardsMapping())[0]
        return s

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
    s = flagship_states(512)
    out["render_rgb84@512"] = device_ms(lambda: kernels.render_rgb84(s, cfg, P), 100)
    gcfg = EngineConfig(gravity_enabled=False, auto_reset=True)
    gs, _ = tg.reset(batch_keys(prng_key(1), 1024, device=dev), gcfg, device=dev)
    for _ in range(20):
        gs = tg.step(gs, _grouped_actions(gs, g, dev, wild=0.0), gcfg)[0]
    out["grouped_placements_features@1024"] = device_ms(
        lambda: kernels.grouped_placements(gs.env, gcfg, turbo.PIECES, 4, "features"), 100)
    print(json.dumps({"label": args.label, "repo": os.path.abspath(args.repo), "nvidia_smi": smi,
                      "ms": out}), flush=True)


if __name__ == "__main__":
    main()
