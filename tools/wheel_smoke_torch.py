"""Post-install smoke test of the PyTorch/CUDA port's wheel.

Run against an INSTALLED ``tetris_gymnasium_torch`` (not the repo tree):
imports the package, steps the plain turbo and compat engines on the CPU,
and, where a CUDA card is present, builds one kernel (``fn_step`` at 10x20)
from the installed package's own ``csrc/`` into its build directory
(``kernels.BUILD_DIR``: the per-user cache, or
``$TETRIS_GYMNASIUM_TORCH_BUILD_DIR``), launches it and holds it bit for
bit against ``fn_env.step_plain``.  Prints one JSON line.

    pip wheel . --no-deps --no-build-isolation -w dist
    pip install --target /tmp/site dist/tetris_gymnasium_tpu-*.whl
    cd /tmp && PYTHONPATH=/tmp/site python /path/to/tools/wheel_smoke_torch.py

``--device cpu`` skips the card even where one is present.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _under(path: str, parent: str) -> bool:
    path, parent = os.path.realpath(path), os.path.realpath(parent)
    return os.path.commonpath([path, parent]) == parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("auto", "cpu"), default="auto")
    args = ap.parse_args(argv)

    import torch

    import tetris_gymnasium_torch
    from tetris_gymnasium_torch import kernels

    pkg_dir = os.path.dirname(os.path.realpath(tetris_gymnasium_torch.__file__))
    repo_pkg = os.path.join(os.path.dirname(os.path.dirname(os.path.realpath(__file__))),
                            "tetris_gymnasium_torch")
    if pkg_dir == os.path.realpath(repo_pkg):
        print(f"ERROR: imported the repo tree ({pkg_dir}), not the installed wheel")
        return 1
    csrc = sorted(os.listdir(os.path.join(pkg_dir, "csrc")))
    if any(not _under(str(p), pkg_dir) for p in kernels.SOURCES.values()):
        print(f"ERROR: a kernel source lies outside the installed package {pkg_dir}")
        return 1
    build_dir = str(kernels.BUILD_DIR)
    if _under(build_dir, os.path.dirname(pkg_dir)):
        print(f"ERROR: the build directory {build_dir} lies inside {os.path.dirname(pkg_dir)}")
        return 1

    from tetris_gymnasium_torch.config import EngineConfig, EnvConfig
    from tetris_gymnasium_torch.core import fn_env, turbo
    from tetris_gymnasium_torch.ops.threefry import prng_key
    from tetris_gymnasium_torch.parallel.mesh import batch_keys

    cfg = EngineConfig(auto_reset=True)
    states = turbo.init(batch_keys(prng_key(0), 32, device="cpu"), cfg, device="cpu")
    for _ in range(16):  # no-ops: gravity advances, no auto-reset on a fresh board
        states = turbo.step(states, torch.full((32,), 7, dtype=torch.int32), cfg)[0]
    assert int(states.steps.min()) == 16, "the turbo engine did not take 16 steps"

    env_cfg = EnvConfig()
    g = torch.Generator().manual_seed(0)
    _, s, _ = fn_env.reset(batch_keys(prng_key(1), 64, device="cpu"), env_cfg, device="cpu")
    actions = torch.randint(0, 7, (32, 64), generator=g, dtype=torch.int32)
    final, (_, reward, _, _) = fn_env.rollout(s, actions, env_cfg)
    out = {"package": pkg_dir, "csrc_files": len(csrc), "build_dir": build_dir,
           "turbo_steps": 16, "fn_steps": 32, "fn_score_sum": float(final.score.sum())}

    if args.device == "auto" and torch.cuda.is_available():
        dev = torch.device("cuda")
        kernels.reset_launches()
        facts = kernels._compile("fn_env", kernels.fn_defines(env_cfg, fn_env.PIECES))
        lib = kernels._lib_path(kernels.SOURCES["fn_env"], kernels.fn_defines(env_cfg, fn_env.PIECES))
        if not (lib.exists() and _under(str(lib), build_dir)):
            print(f"ERROR: fn_env's library {lib} is not in {build_dir}")
            return 1
        _, sd, _ = fn_env.reset(batch_keys(prng_key(1), 4096, device=dev), env_cfg, device=dev)
        for t in range(32):
            a = torch.randint(0, 7, (4096,), generator=g, dtype=torch.int32).to(dev)
            got = kernels.fn_step(sd, a, env_cfg, fn_env.PIECES)
            want = fn_env.step_plain(sd, a, env_cfg)
            for k in fn_env.FIELDS:
                if not torch.equal(getattr(got[0], k), getattr(want[0], k)):
                    print(f"ERROR: fn_step's {k} differs from step_plain at step {t}")
                    return 1
            for x, y, name in zip(got[1:], want[1:], ("obs", "reward", "terminated", "lines")):
                if not torch.equal(x, y):
                    print(f"ERROR: fn_step's {name} differs from step_plain at step {t}")
                    return 1
            sd = got[0]
        torch.cuda.synchronize()
        out.update(card=torch.cuda.get_device_name(0), library=str(lib), built=not facts["cached"],
                   build_seconds=facts["seconds"], fn_step_launches=kernels.LAUNCHES["fn_step"],
                   fn_step_equal_steps=32)
    print(json.dumps(out))
    print("wheel smoke (torch) OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
