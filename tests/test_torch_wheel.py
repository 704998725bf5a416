"""The port's wheel: it ships the kernel sources, and an installed port
builds its kernels outside ``site-packages``.

The tree's sources are copied to ``tmp_path`` and the wheel is built there
(``pip wheel --no-deps --no-build-isolation --no-index``), never in the
repo; it must hold every file of ``tetris_gymnasium_torch/csrc/``.  It is
installed with ``pip install --target`` and ``tools/wheel_smoke_torch.py``
runs in a subprocess outside the tree: the installed package is imported,
the plain engines step on the CPU (on a card it also builds ``fn_step``
into the cache and holds it against ``step_plain``).  The build directory
of the installed package resolves to the per-user cache, outside the
install, and ``TETRIS_GYMNASIUM_TORCH_BUILD_DIR`` overrides it; in the repo
tree it stays ``build/torch_kernels/``.
"""
import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from tetris_gymnasium_torch import kernels

REPO = Path(__file__).resolve().parent.parent
_TREE = ("pyproject.toml", "README.md", "LICENSE", "tetris_gymnasium_tpu", "tetris_gymnasium_torch")


def _run(cmd, cwd, env=None, timeout=300):
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"{cmd} failed:\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """``(wheel, site)``: the wheel built from a copy of the tree, and the
    directory it is installed into."""
    root = tmp_path_factory.mktemp("wheel")
    src = root / "src"
    src.mkdir()
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc")
    for name in _TREE:
        path = REPO / name
        if path.is_dir():
            shutil.copytree(path, src / name, ignore=ignore)
        else:
            shutil.copy(path, src / name)
    dist, site = root / "dist", root / "site"
    pip = [sys.executable, "-m", "pip"]
    _run(pip + ["wheel", ".", "--no-deps", "--no-build-isolation", "--no-index", "-q", "-w", str(dist)],
         cwd=src)
    (wheel,) = dist.glob("*.whl")
    _run(pip + ["install", "--no-deps", "--no-index", "-q", "--target", str(site), str(wheel)], cwd=root)
    return wheel, site


def _env(site, **extra):
    env = {k: v for k, v in os.environ.items() if k != kernels.BUILD_DIR_ENV}
    env.update(PYTHONPATH=str(site), **extra)
    return env


def test_the_wheel_holds_every_kernel_source(installed):
    wheel, _ = installed
    names = set(zipfile.ZipFile(wheel).namelist())
    csrc = sorted(p.name for p in (REPO / "tetris_gymnasium_torch" / "csrc").iterdir() if p.is_file())
    assert len(csrc) >= 22
    missing = [n for n in csrc if f"tetris_gymnasium_torch/csrc/{n}" not in names]
    assert not missing, f"the wheel lacks {missing}"


def test_the_installed_port_runs_its_smoke_outside_the_tree(installed, tmp_path):
    _, site = installed
    cache = tmp_path / "cache"
    out = _run([sys.executable, str(REPO / "tools" / "wheel_smoke_torch.py"), "--device", "cpu"],
               cwd=tmp_path, env=_env(site, XDG_CACHE_HOME=str(cache)))
    facts = json.loads(out.splitlines()[-2])
    assert Path(facts["package"]) == (site / "tetris_gymnasium_torch").resolve()
    assert facts["csrc_files"] == len(list((REPO / "tetris_gymnasium_torch" / "csrc").iterdir()))
    assert Path(facts["build_dir"]) == (cache / "tetris_gymnasium_torch" / "kernels").resolve()
    assert out.splitlines()[-1] == "wheel smoke (torch) OK"


def _build_dir_of_installed(site, cwd, **extra) -> Path:
    code = "from tetris_gymnasium_torch import kernels; print(kernels.BUILD_DIR)"
    return Path(_run([sys.executable, "-c", code], cwd=cwd, env=_env(site, **extra)).strip())


def test_the_build_directory_of_an_installed_port(installed, tmp_path):
    _, site = installed
    home = tmp_path / "home"
    got = _build_dir_of_installed(site, tmp_path, HOME=str(home), XDG_CACHE_HOME="")
    assert got == (home / ".cache" / "tetris_gymnasium_torch" / "kernels").resolve()
    assert site.resolve() not in got.parents
    xdg = tmp_path / "xdg"
    got = _build_dir_of_installed(site, tmp_path, XDG_CACHE_HOME=str(xdg))
    assert got == (xdg / "tetris_gymnasium_torch" / "kernels").resolve()
    mine = tmp_path / "mine"
    got = _build_dir_of_installed(site, tmp_path, **{kernels.BUILD_DIR_ENV: str(mine)})
    assert got == mine.resolve()


def test_the_source_tree_builds_into_build_torch_kernels(monkeypatch):
    monkeypatch.delenv(kernels.BUILD_DIR_ENV, raising=False)
    assert kernels.build_dir() == REPO / "build" / "torch_kernels"
    monkeypatch.setenv(kernels.BUILD_DIR_ENV, "/nonexistent/kernels")
    assert kernels.build_dir() == Path("/nonexistent/kernels")
    assert all(p.parent == REPO / "tetris_gymnasium_torch" / "csrc" for p in kernels.SOURCES.values())
