"""Build, bind and launch the port's hand-written CUDA kernels.

Sources live in ``csrc/`` (shipped in the wheel as package data); each is
compiled on first use by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, named by the hash of its source, its headers, its flags
and its defines, and loaded with ``ctypes``.  The libraries go to
``BUILD_DIR`` (:func:`build_dir`): ``build/torch_kernels/`` beside the
package in a source tree (the directory that holds ``pyproject.toml``;
gitignored), else the per-user cache
``$XDG_CACHE_HOME/tetris_gymnasium_torch/kernels`` (``~/.cache/...`` without
``XDG_CACHE_HOME``), so that an installed package never writes into
``site-packages``.  The environment variable
``TETRIS_GYMNASIUM_TORCH_BUILD_DIR`` overrides both.  Only the sources in
the package's own ``csrc/`` are ever built.  Every
source that reads an engine state or a board is built once for each
geometry it is called at (``GEOMETRY_SOURCES``): :func:`engine_defines`
turns a config into the ``TETRIS_*`` defines of
``csrc/engine_common.cuh``; :func:`feature_defines` and
:func:`compose_defines` take them from the shapes of their inputs.
Pointers and the stream go in as ``c_void_p``; the stream is PyTorch's
current one; each C entry point returns ``cudaGetLastError()`` and the
wrapper raises if it is not 0.

Kernels, with the JAX function each replaces:

* ``turbo_step`` (``csrc/turbo_step.cu`` with ``csrc/turbo_band.cuh``):
  ``core/turbo.py:step :639``, with ``_shift :205``, ``_hit_map_r :251`` and
  ``_clear_lines_wide :326`` (``ops/bitboard_wide.py:108-215`` in the turbo
  layout) at any geometry, one thread or a group of lanes an env
  (:func:`step_lanes`), and with an ``obs`` output also ``observe_board
  :738`` of the state it stores, in the same launch; with ``logits`` too,
  ``ppo_sample``'s work (the action sampled in the launch, PPO's rollout);
* ``turbo_init`` (``csrc/turbo_step.cu``): ``core/turbo.py:_init_from_key :440``,
  reached through ``init :497``;
* ``observe_board`` (``csrc/observe_board.cu``): ``core/turbo.py:observe_board :738``;
* ``heights`` (``csrc/heights.cu``): ``core/turbo.py:heights :760``;
* ``gae`` (``csrc/gae.cu``): ``rl/ppo.py:_gae :147``, in two builds
  (:func:`gae_build`);
* ``ppo_sample`` (``csrc/ppo_sample.cu``): the sampling tail of
  ``rl/ppo.py:policy_step :184-187``;
* ``grouped_placements`` (``csrc/grouped_placements.cu``):
  ``core/turbo_grouped.py:_candidate_rows :103`` with ``_features_from_rows
  :65``, ``placements :152`` and ``placement_boards :177``, an env's shared
  work once a block, the boards built a row at a time in shared memory and
  streamed out in 16-byte stores (:func:`grouped_placements_occupancy`);
* ``grouped_act`` (``csrc/grouped_act.cu``): the masked epsilon-greedy of
  ``rl/grouped_dqn.py:train_step :165-174`` and ``_masked_random :78``, and
  ``rl/evaluate.py:greedy_masked_q :141``, a group of 8, 16 or 32 lanes an
  env (:func:`grouped_act_lanes`);
* ``replay_add`` and ``replay_sample`` (``csrc/replay.cu``):
  ``rl/buffers.py:add :46``, ``sample_with_next :70`` and ``sample :64``;
  ``replay_add`` on one flat grid apportioned to the fields by their bytes,
  a word a thread, a transposed field through a shared-memory tile;
  ``replay_sample`` a group of 8, 16 or 32 lanes a chunk of a sample's
  words, every field's and both rows' loads of a lane in flight before its
  stores (:func:`replay_sample_shape`);
* ``replay_sample_stacked`` (``csrc/replay.cu`` with ``csrc/bulk.cuh``):
  ``rl/buffers.py:sample_with_next_stacked :111``, a warp a sample, in two
  builds (:func:`replay_stacked_build`): the sample's <= K + 1 distinct
  frames staged in shared memory by bulk asynchronous copies, or word
  copies for frames that are not whole 16-byte words;
* ``framestack_push`` (``csrc/framestack.cu``): ``ops/framestack.py:push :37``;
* ``dqn_act`` (``csrc/dqn_act.cu``): the epsilon-greedy of
  ``rl/dqn.py:train_step :143-147`` and ``rl/evaluate.py:greedy_q :124``,
  a thread an env, its row's loads in flight before the draws, randint's
  split of the action key made on the card (a build for A = 8 and one for
  any A; :func:`dqn_act_shape`);
* ``flagship_step``, ``flagship_init`` and ``flagship_observe_board``
  (``csrc/flagship_step.cu``): the flagship engine's ``core/engine.py:step
  :451`` (with ``_commit :289`` over ``ops/bitboard.py:58-230`` or
  ``ops/bitboard_wide.py:108-215``), ``init_state :131`` and
  ``observe_board :274``; the step a group of 8 or 16 lanes an env
  (:func:`flagship_step_lanes`), the init its boards as a stream of
  16-byte words of their constant pattern beside one RNG chain a thread
  (:func:`flagship_init_shape`), the observation one env a warp for a
  small batch and 1-4 for a large one, their playfield rows in whole words
  and their frames staged in the warp's own shared memory
  (:func:`flagship_observe_board_shape`);
* ``render_rgb84`` (``csrc/render_rgb84.cu``): ``core/engine.py:render_rgb
  :529`` with ``ops/observations.py:compose_rgb :84`` and
  ``ops/image.py:preprocess_rgb84 :197``, state to 84x84 gray frame, the
  resize as JAX's two passes in shared memory (its table: :func:`pack_taps`);
* ``grouped_flagship`` (``csrc/grouped_flagship.cu``): the flagship grouped
  engine's ``core/grouped.py:placements :98`` (``_candidate :68``,
  ``_frame_overlap :57``) and ``grouped_observation :113``, an env's shared
  work (column tops, heights, full rows) built once for its candidates, the
  boards built a row at a time in shared memory and streamed out
  (:func:`grouped_flagship_occupancy`);
* ``feature_vector`` (``csrc/features.cu``):
  ``ops/observations.py:feature_vector :57``, a warp an env, a crop row a
  lane with every load in flight (its aligned 16-byte words, or its bytes:
  :func:`_feature_words`), the row masks turned into column masks by a bit
  transpose across the warp (:func:`feature_vector_shape`);
* ``observe_dict`` and ``compose_rgb`` (``csrc/observe_dict.cu``):
  ``core/engine.py:observe_dict :257`` and ``ops/observations.py:compose_rgb
  :84`` (``render_rgb :529`` is the two in turn); ``observe_dict`` a warp an
  env, the env's piece work once, one vote on the collision, the board and
  mask in whole words (:func:`observe_dict_shape`); ``compose_rgb`` a lane
  a run of 16 pixels, the palette a launch parameter copied on chip while
  the ids are in flight, whole-word stores (:func:`compose_rgb_shape`);
* ``fn_reset``, ``fn_step`` and ``fn_observe`` (``csrc/fn_env.cu``): the
  compat engine's ``core/fn_env.py:reset :210``, ``step :189`` (with
  ``_update :124``, ``_lock_piece :80``, ``ops/board.py:clear_lines_compat
  :203`` and the queues of ``ops/queue.py``) and ``observe :64``, built for
  each geometry (:func:`fn_defines`); the step a group of 8 lanes an env
  over bit rows of occupancy, its boards staged by bulk asynchronous copies
  or word copies (:func:`fn_step_build`); the reset its board and
  observation as streams of 16-byte words beside one short RNG chain an env
  (:func:`fn_reset_shape`);
* ``grayscale_u8_exact`` (``csrc/gray_exact.cu``):
  ``ops/image.py:grayscale_u8_exact :176`` with ``_gray_tables :125``.

``csrc/bulk.cuh`` holds the bulk-copy and mbarrier helpers of ``fn_step``
and ``replay_sample_stacked``; ``csrc/threefry.cuh`` JAX's threefry blocks
and random bits for ``ppo_sample``, ``turbo_step``'s sample,
``grouped_act``, ``replay_sample``, ``replay_sample_stacked``, ``dqn_act``
and the ``fn_*`` kernels; ``csrc/sample_group.cuh`` PPO's sampling tail,
shared by ``ppo_sample.cu`` and the sampling builds of ``turbo_step.cu``
and ``flagship_step.cu``;
``csrc/engine_common.cuh`` the engines' RNG, draws and bit helpers, shared by
``turbo_step.cu``, ``flagship_step.cu`` and ``grouped_flagship.cu``, and
``csrc/turbo_band.cuh`` the band helpers of the lanes builds of
``turbo_step.cu`` and ``flagship_step.cu``; ``csrc/id_image.cuh`` the id
image of the observation, shared by ``render_rgb84.cu`` and
``observe_dict.cu``; ``csrc/board_words.cuh`` the whole-word board helpers
of ``observe_dict`` and ``flagship_observe_board``; ``csrc/features.cuh`` the
feature vector's flags and the grouped kernels' accumulator, shared by
``features.cu``, ``grouped_flagship.cu`` and ``grouped_placements.cu``;
``csrc/sm_count.cuh`` the card's SM count, read by the launchers of
``dqn_act.cu``, ``fn_env.cu``, ``grouped_placements.cu`` and the sources
that include ``board_words.cuh``.

Every kernel takes any geometry within the static limits that
:func:`engine_defines` names (padded height <= 64, padded width <= 128,
piece side <= 8, 1-32 pieces, queue <= 16, holder <= 8; a flagship board of
<= 3072 cells), ``feature_vector`` any crop of <= 64 rows and <= 128
columns; ``observe_board`` and ``heights`` take the geometry as run-time
arguments.  On CUDA tensors a config past a limit raises
``NotImplementedError`` naming it; where the JAX function itself refuses
(a composite over 84 pixels for the 84x84 frame, a board lower than the two
strips of the sidebar) the wrapper raises JAX's error.  The plain versions
take every geometry on the CPU.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream without
synchronising, and adds one to ``LAUNCHES[name]`` per launch
(``feature_vector`` and ``compose_rgb`` also to ``LAUNCHES_BY_BATCH``'s
``"name@B"``).  Wrappers take CUDA tensors only; the plain versions for CPU tensors are in
:mod:`tetris_gymnasium_torch.core.turbo`, :mod:`~tetris_gymnasium_torch.core.turbo_grouped`,
:mod:`~tetris_gymnasium_torch.core.engine`,
:mod:`~tetris_gymnasium_torch.rl.ppo`, :mod:`~tetris_gymnasium_torch.rl.grouped_dqn`,
:mod:`~tetris_gymnasium_torch.rl.dqn`, :mod:`~tetris_gymnasium_torch.rl.buffers`,
:mod:`~tetris_gymnasium_torch.ops.framestack`, :mod:`~tetris_gymnasium_torch.core.fn_env`
and :mod:`~tetris_gymnasium_torch.ops.image`, which dispatch.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tetris_gymnasium_torch.config import EngineConfig, EnvConfig, RewardsMapping
from tetris_gymnasium_torch.core import engine, fn_env, turbo
from tetris_gymnasium_torch.ops import bitboard as bb
from tetris_gymnasium_torch.ops import bitboard_wide as bbw
from tetris_gymnasium_torch.pieces import PieceSet

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR_ENV = "TETRIS_GYMNASIUM_TORCH_BUILD_DIR"


def build_dir() -> Path:
    """Where the kernels' libraries go: ``$TETRIS_GYMNASIUM_TORCH_BUILD_DIR``
    if set; ``build/torch_kernels/`` of the source tree when the package
    lies in one (its parent holds ``pyproject.toml``); else the per-user
    cache ``$XDG_CACHE_HOME/tetris_gymnasium_torch/kernels``, ``XDG_CACHE_HOME``
    defaulting to ``~/.cache``."""
    override = os.environ.get(BUILD_DIR_ENV)
    if override:
        return Path(override).expanduser().resolve()
    if (PACKAGE_DIR.parent / "pyproject.toml").is_file():
        return PACKAGE_DIR.parent / "build" / "torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache).expanduser().resolve() / "tetris_gymnasium_torch" / "kernels"


BUILD_DIR = build_dir()
SOURCES = {
    "turbo_step": PACKAGE_DIR / "csrc" / "turbo_step.cu",
    "observe_board": PACKAGE_DIR / "csrc" / "observe_board.cu",
    "heights": PACKAGE_DIR / "csrc" / "heights.cu",
    "gae": PACKAGE_DIR / "csrc" / "gae.cu",
    "ppo_sample": PACKAGE_DIR / "csrc" / "ppo_sample.cu",
    "grouped_placements": PACKAGE_DIR / "csrc" / "grouped_placements.cu",
    "grouped_act": PACKAGE_DIR / "csrc" / "grouped_act.cu",
    "replay": PACKAGE_DIR / "csrc" / "replay.cu",
    "framestack": PACKAGE_DIR / "csrc" / "framestack.cu",
    "dqn_act": PACKAGE_DIR / "csrc" / "dqn_act.cu",
    "flagship_step": PACKAGE_DIR / "csrc" / "flagship_step.cu",
    "render_rgb84": PACKAGE_DIR / "csrc" / "render_rgb84.cu",
    "grouped_flagship": PACKAGE_DIR / "csrc" / "grouped_flagship.cu",
    "features": PACKAGE_DIR / "csrc" / "features.cu",
    "observe_dict": PACKAGE_DIR / "csrc" / "observe_dict.cu",
    "fn_env": PACKAGE_DIR / "csrc" / "fn_env.cu",
    "gray_exact": PACKAGE_DIR / "csrc" / "gray_exact.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launch counts, one per kernel: added to where a wrapper launches, nowhere
# else; "turbo_step_obs" counts the turbo_step launches that also wrote the
# board observation, "turbo_step_sample" and "flagship_step_sample" the
# turbo_step and flagship_step launches that also sampled the action from
# PPO's logits (ppo_sample's work in the step's launch).
LAUNCHES = {
    "turbo_step": 0, "turbo_step_obs": 0, "turbo_step_sample": 0, "turbo_init": 0,
    "observe_board": 0, "gae": 0, "ppo_sample": 0, "grouped_placements": 0, "grouped_act": 0,
    "replay_add": 0, "replay_sample": 0, "replay_sample_stacked": 0, "framestack_push": 0,
    "dqn_act": 0, "flagship_step": 0, "flagship_step_sample": 0, "flagship_init": 0,
    "flagship_observe_board": 0, "render_rgb84": 0, "grouped_flagship": 0, "feature_vector": 0,
    "observe_dict": 0, "compose_rgb": 0, "heights": 0, "fn_reset": 0, "fn_step": 0,
    "fn_observe": 0, "grayscale_u8_exact": 0,
}

# feature_vector's and compose_rgb's launches by batch, "name@B", added to
# beside LAUNCHES[name]: the observation wrappers' paths launch each kernel
# at B = 1 (the env's board) and at their candidates' batch.
LAUNCHES_BY_BATCH: dict = {}

# Builds forced in place of the wrapper's pick, for the checks that hold
# each build against its plain version: "feature_vector" True (the words
# build) or False (the bytes build), "compose_rgb" 16 or 1 (pixels a run).
# Set only through _forced.
_FORCE: dict = {}

_LIBS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_BATCH.clear()


@contextlib.contextmanager
def _forced(kernel: str, build):
    """Launch ``kernel`` (``"feature_vector"`` or ``"compose_rgb"``) in
    ``build`` inside the block (``None``: the wrapper's pick)."""
    _FORCE[kernel] = build
    try:
        yield
    finally:
        del _FORCE[kernel]


def _count_batch(name: str, B: int) -> None:
    key = f"{name}@{B}"
    LAUNCHES_BY_BATCH[key] = LAUNCHES_BY_BATCH.get(key, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources_of(source: Path) -> list:
    """``source`` and every local header it includes, recursively, in include order."""
    seen, todo = [], [source]
    while todo:
        path = todo.pop(0)
        if path not in seen:
            seen.append(path)
            todo += [path.parent / name for name in _LOCAL_INCLUDE.findall(path.read_text())]
    return seen


def _define_flags(defines) -> list:
    return [f"-D{k}={v}" for k, v in defines]


def _lib_path(source: Path, defines=()) -> Path:
    """The library of ``source`` built with ``defines`` (``(name, value)``
    pairs), named by the hash of the source, the local headers it includes,
    the flags and the defines, so that an edit to any of them rebuilds."""
    digest = hashlib.sha256()
    for path in _sources_of(source):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + _define_flags(defines)).encode())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def _compile(name: str, defines=()) -> dict:
    """Compile one source unless its library exists; returns build facts."""
    source = SOURCES[name]
    out = _lib_path(source, defines)
    if out.exists():
        return {"name": name, "defines": dict(defines), "seconds": 0.0, "cached": True,
                "ptxas": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()

    def nvcc(*extra):
        return subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *extra, *_define_flags(defines), "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )

    proc, extra = nvcc(), []
    if proc.returncode != 0 and "Segmentation fault" in proc.stderr:
        # ptxas of CUDA 12.9 crashes on the PTX that cicc makes at -O3 of
        # turbo_step_kernel at 30x14 and 30x18 (and -O1 or -O2 in ptxas do not
        # help); the PTX of cicc at -O1 compiles.  Said in the build facts.
        extra = ["-Xcicc", "-O1"]
        proc = nvcc(*extra)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return {
        "name": name,
        "defines": dict(defines),
        "seconds": time.perf_counter() - t0,
        "cached": False,
        "extra_flags": extra,
        "ptxas": "\n".join(l for l in proc.stderr.splitlines() if "ptxas" in l or "spill" in l),
    }


def _geometry_jobs(config: EngineConfig, pieces: PieceSet) -> list:
    """``(source, defines)`` of every build that a state of ``config`` and
    ``pieces`` is run with: each source of ``GEOMETRY_SOURCES`` whose static
    limits take it, and ``features`` at its playfield's shape."""
    t = bb.turbo_tables(pieces)
    jobs = []
    for name in GEOMETRY_SOURCES:
        try:
            jobs.append((name, engine_defines(config, t, flagship=name in FLAGSHIP_SOURCES)))
        except NotImplementedError:
            pass
    try:
        jobs.append(("features", feature_defines(config.height, config.width)))
    except NotImplementedError:
        pass
    return jobs


def build(geometries=(), fn_geometries=()) -> list:
    """Compile every kernel source in parallel, one ``nvcc`` each, two for
    each core at a time (seventy at once have crashed ``nvcc``): the
    per-geometry sources for the default geometry and for each ``(config,
    pieces)`` of ``geometries`` (:func:`_geometry_jobs`), ``fn_env.cu`` for
    the default :class:`EnvConfig` and each ``(config, pieces)`` of
    ``fn_geometries`` (:func:`fn_defines`), the others once."""
    from tetris_gymnasium_torch.pieces import PIECES

    per_geometry = GEOMETRY_SOURCES + ("features", "fn_env")
    jobs = [(name, ()) for name in SOURCES if name not in per_geometry]
    for config, pieces in ((EngineConfig(), PIECES), *geometries):
        jobs += [job for job in _geometry_jobs(config, pieces) if job not in jobs]
    for config, pieces in ((EnvConfig(), PIECES), *fn_geometries):
        job = ("fn_env", fn_defines(config, pieces))
        jobs += [job] if job not in jobs else []
    # the longest builds first, so that none of them starts last
    rank = {name: i for i, name in enumerate(_SLOW_BUILDS)}
    jobs.sort(key=lambda job: rank.get(job[0], len(rank)))
    with ThreadPoolExecutor(max_workers=min(len(jobs), 2 * (os.cpu_count() or 4))) as pool:
        return list(pool.map(lambda job: _compile(*job), jobs))


# Sources by their nvcc time a geometry on the card's machine, longest first
# (chip_smoke.py's build phase): build() starts them first.
_SLOW_BUILDS = ("turbo_step", "flagship_step", "grouped_flagship", "grouped_placements")


class _StatePtrs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in turbo.FIELDS]


class _StepParams(ctypes.Structure):
    _fields_ = [
        ("gravity", ctypes.c_int),
        ("auto_reset", ctypes.c_int),
        ("uniform", ctypes.c_int),
        ("max_clear", ctypes.c_int),
        ("r_alife", ctypes.c_float),
        ("r_game_over", ctypes.c_float),
    ]


class _SampleArgs(ctypes.Structure):  # csrc/sample_group.cuh:SampleArgs
    _fields_ = [
        ("logits", ctypes.c_void_p),
        ("action", ctypes.c_void_p),
        ("log_prob", ctypes.c_void_p),
        ("k0", ctypes.c_uint32),
        ("k1", ctypes.c_uint32),
        ("env_offset", ctypes.c_uint32),
    ]


class _ObsGeometry(ctypes.Structure):
    _fields_ = [
        (name, ctypes.c_int)
        for name in ("height", "width", "padding", "rows_h", "padded_width", "size", "n_entries",
                     "nw", "nt")
    ]


class _PlacementParams(ctypes.Structure):
    _fields_ = [("max_clear", ctypes.c_int), ("mode", ctypes.c_int)]


class _ActParams(ctypes.Structure):
    _fields_ = [
        ("A", ctypes.c_int), ("mask_sb", ctypes.c_longlong), ("mask_sa", ctypes.c_longlong),
        ("fill", ctypes.c_float), ("explore", ctypes.c_int),
        ("act_k0", ctypes.c_uint32), ("act_k1", ctypes.c_uint32),
        ("eps_k0", ctypes.c_uint32), ("eps_k1", ctypes.c_uint32), ("epsilon", ctypes.c_float),
    ]


_MAX_REPLAY_FIELDS = 8  # csrc/replay.cu:kMaxFields
_MAX_STACK = 16  # csrc/replay.cu:kMaxStack


class _ReplayField(ctypes.Structure):
    _fields_ = [
        ("store", ctypes.c_void_p), ("src", ctypes.c_void_p), ("out_cur", ctypes.c_void_p),
        ("out_nxt", ctypes.c_void_p), ("row_bytes", ctypes.c_longlong),
        ("src_stride", ctypes.c_longlong), ("word", ctypes.c_int), ("transposed", ctypes.c_int),
    ]


class _ReplayFields(ctypes.Structure):
    _fields_ = [("f", _ReplayField * _MAX_REPLAY_FIELDS), ("n", ctypes.c_int)]


class _SampleParams(ctypes.Structure):
    _fields_ = [
        ("hi_k0", ctypes.c_uint32), ("hi_k1", ctypes.c_uint32),
        ("lo_k0", ctypes.c_uint32), ("lo_k1", ctypes.c_uint32),
        ("span", ctypes.c_uint32), ("multiplier", ctypes.c_uint32),
        ("start", ctypes.c_longlong), ("capacity", ctypes.c_longlong),
        ("batch", ctypes.c_longlong), ("n", ctypes.c_int),
    ]


class _StackParams(ctypes.Structure):
    _fields_ = [("done", ctypes.c_void_p), ("obs_field", ctypes.c_int), ("k", ctypes.c_int),
                ("bulk", ctypes.c_int)]


class _DqnActParams(ctypes.Structure):  # csrc/dqn_act.cu:DqnActParams
    _fields_ = [
        ("A", ctypes.c_int), ("act_k0", ctypes.c_uint32), ("act_k1", ctypes.c_uint32),
        ("eps_k0", ctypes.c_uint32), ("eps_k1", ctypes.c_uint32), ("epsilon", ctypes.c_float),
        ("env_offset", ctypes.c_uint32), ("vec", ctypes.c_int), ("multiplier", ctypes.c_uint32),
    ]


class _FlagshipPtrs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in engine.FIELDS]


class _FlagshipParams(ctypes.Structure):
    _fields_ = [
        ("gravity", ctypes.c_int),
        ("auto_reset", ctypes.c_int),
        ("uniform", ctypes.c_int),
        ("r_alife", ctypes.c_float),
        ("r_game_over", ctypes.c_float),
    ]


_RENDER_FIELDS = ("board", "piece", "rotation", "x", "y", "queue", "holder_piece",
                  "holder_rotation", "holder_count")


class _RenderPtrs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _RENDER_FIELDS]


_MAX_PALETTE = 34  # csrc/observe_dict.cu:kMaxPalette: 32 pieces, empty and bedrock


class _ComposePalette(ctypes.Structure):  # csrc/observe_dict.cu:ComposePalette
    _fields_ = [("rgb", ctypes.c_uint32 * _MAX_PALETTE), ("group_magic", ctypes.c_uint32),
                ("group_shift", ctypes.c_int)]


class _FnPtrs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in fn_env.FIELDS]


class _FnParams(ctypes.Structure):
    _fields_ = [("gravity", ctypes.c_int), ("uniform", ctypes.c_int), ("bulk", ctypes.c_int)]


_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry points of each source: name -> argtypes (every one returns cudaGetLastError()).
_ENTRY_POINTS = {
    "turbo_step": {
        "turbo_step_launch": [ctypes.POINTER(_StatePtrs), ctypes.POINTER(_StatePtrs),
                              _P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.POINTER(_StepParams),
                              ctypes.POINTER(_SampleArgs), _P],
        "turbo_init_launch": [_P, ctypes.POINTER(_StatePtrs), _P, _I, _I, _I, _P],
        "turbo_init_shape": [_I, _P],
    },
    "observe_board": {
        "observe_board_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 ctypes.POINTER(_ObsGeometry), _P],
    },
    "heights": {
        "heights_launch": [_P, _P, _I, _I, _I, _I, _I, _P],
    },
    "gae": {
        "gae_launch": [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, ctypes.c_float, _I, _P],
    },
    "ppo_sample": {
        "ppo_sample_launch": [_P, _P, _P, _P, _I, ctypes.c_uint32, ctypes.c_uint32, _I, _P],
    },
    "grouped_placements": {
        "grouped_placements_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      ctypes.POINTER(_PlacementParams), _P],
        "grouped_placements_occupancy": [_P],
    },
    "grouped_act": {
        "grouped_act_launch": [_P, _P, _P, _P, _P, _I, ctypes.POINTER(_ActParams), _I, _P],
        "grouped_act_occupancy": [_P],
    },
    "replay": {
        "replay_add_launch": [ctypes.POINTER(_ReplayFields), ctypes.c_longlong, _I, _P],
        "replay_sample_launch": [ctypes.POINTER(_ReplayFields), ctypes.POINTER(_SampleParams),
                                 _P, _P],
        "replay_sample_shape": [ctypes.POINTER(_ReplayFields), ctypes.c_longlong, _I, _P],
        "replay_sample_stacked_launch": [ctypes.POINTER(_ReplayFields),
                                         ctypes.POINTER(_SampleParams),
                                         ctypes.POINTER(_StackParams), _P, _P],
    },
    "framestack": {
        "framestack_push_launch": [_P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I, _P],
    },
    "dqn_act": {
        "dqn_act_launch": [_P, _P, _P, _P, _I, _I, ctypes.POINTER(_DqnActParams), _P],
        "dqn_act_shape": [_I, _I, _P],
    },
    "flagship_step": {
        "flagship_step_launch": [ctypes.POINTER(_FlagshipPtrs), ctypes.POINTER(_FlagshipPtrs),
                                 _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 ctypes.POINTER(_FlagshipParams), ctypes.POINTER(_SampleArgs),
                                 _P],
        "flagship_init_launch": [_P, ctypes.POINTER(_FlagshipPtrs), _P, _I, _I, _P],
        "flagship_init_shape": [_I, _P],
        "flagship_observe_board_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
        "flagship_observe_board_shape": [_I, _P],
    },
    "render_rgb84": {
        "render_rgb84_launch": [ctypes.POINTER(_RenderPtrs), _P, _P, _P, _P, _I, _P],
    },
    "grouped_flagship": {
        "grouped_flagship_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "grouped_flagship_occupancy": [_P],
    },
    "features": {
        "feature_vector_launch": [_P, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I, _P, _P],
        "feature_vector_shape": [_I, _P],
    },
    "observe_dict": {
        "observe_dict_launch": [ctypes.POINTER(_RenderPtrs), _P, _P, _P, _P, _P, _P, _P, _I, _P],
        "compose_rgb_launch": [_P, _P, _P, ctypes.POINTER(_ComposePalette), _I, _I, _P, _P],
        "compose_rgb_shape": [_I, _P],
        "observe_dict_shape": [_I, _P],
    },
    "fn_env": {
        "fn_step_launch": [ctypes.POINTER(_FnPtrs), ctypes.POINTER(_FnPtrs), _P, _P, _P, _P, _P,
                           _P, _P, _I, ctypes.POINTER(_FnParams), _P],
        "fn_step_occupancy": [_I, _P, _P, _P, _P],
        "fn_reset_launch": [_P, _P, ctypes.POINTER(_FnPtrs), _P, _P, _I, _I, _P],
        "fn_reset_shape": [_I, _P],
        "fn_observe_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    },
    "gray_exact": {
        "gray_exact_launch": [_P, _P, ctypes.c_longlong, _P, _P],
    },
}


def _lib(name: str, defines=()) -> ctypes.CDLL:
    lib = _LIBS.get((name, defines))
    if lib is None:
        _compile(name, defines)
        lib = ctypes.CDLL(str(_lib_path(SOURCES[name], defines)))
        for fn, argtypes in _ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[(name, defines)] = lib
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# The sources built once for each geometry (csrc/engine_common.cuh's
# defines), those of them that keep flagship boards in shared memory, and
# features.cu, built once for each playfield shape (feature_defines).
GEOMETRY_SOURCES = ("turbo_step", "flagship_step", "grouped_placements", "grouped_flagship",
                    "observe_dict", "render_rgb84")
FLAGSHIP_SOURCES = ("flagship_step", "grouped_flagship", "observe_dict", "render_rgb84")
# Static limits of the engine kernels (engine_defines).
MAX_PADDED_HEIGHT = 64  # hit maps and full-row masks are 64-bit words at most
MAX_PADDED_WIDTH = 128  # an env's rows live in registers: 4 words a row at most
MAX_PIECE_SIDE = 8  # a piece table entry is 2 words at most
MAX_PIECES = 32  # the bag lives in registers
MAX_QUEUE = 16
MAX_HOLDER = 8
MAX_BOARD_CELLS = 3072  # flagship: the shared memory of the band steps, the observation,
# grouped_flagship and render_rgb84 is laid out for boards up to this size
MAX_FEATURE_HEIGHT = 64  # feature_vector: 7 bit planes of height counters
MAX_FEATURE_WIDTH = 128  # feature_vector: 4 words a row
_STATE_DTYPES = {
    "key": torch.uint32, "rows": torch.uint32, "has_swapped": torch.bool,
    "game_over": torch.bool, "score": torch.float32,
}


def _rows_shape(config: EngineConfig, B: int) -> tuple:
    """``(H, B)``, or ``(H, NW, B)`` when a row takes more than one word."""
    if not bbw.wide(config.padded_width):
        return (config.padded_height, B)
    return (config.padded_height, turbo.n_words(config), B)


def _state_shapes(config: EngineConfig, n_pieces: int, B: int) -> dict:
    shapes = {k: (B,) for k in turbo.FIELDS}
    shapes.update(
        key=(2, B), rows=_rows_shape(config, B), bag=(n_pieces, B),
        queue=(config.queue_size, B), holder_piece=(config.holder_size, B),
        holder_rotation=(config.holder_size, B),
    )
    return shapes


def engine_defines(config: EngineConfig, t: bb.Tables, flagship: bool = False) -> tuple:
    """The ``TETRIS_*`` defines (``(name, value)`` pairs) that build the
    sources of ``GEOMETRY_SOURCES`` for ``config`` and the piece tables
    ``t`` (the sources of ``FLAGSHIP_SOURCES`` with ``flagship``), or
    ``NotImplementedError`` naming the static limit the config passes.  The
    limits:

    * padded height at most 64: the hit map over the window starts and the
      mask of full rows are 64-bit words at most;
    * padded width at most 128: an env's rows live in registers, 4 words a
      row at most;
    * piece box side at most 8, and inside the padded board: a packed piece
      table entry is 2 words at most;
    * 1 to 32 pieces, a queue of 1 to 16 and a holder of 1 to 8: the bag,
      queue and holder live in registers;
    * with ``flagship``, a padded board of at most 3072 cells: the flagship
      step's band builds (16 boards a block), its observation,
      ``grouped_flagship`` and ``render_rgb84`` lay out their shared memory
      for boards up to that size;
    * ``queue_kind`` ``"bag"`` or ``"uniform"``.

    Every geometry of the JAX package's tests is inside them.
    """
    return _defines(config, t.n_pieces, t.size, flagship)


def _defines(config: EngineConfig, n_pieces: int, S: int, flagship: bool) -> tuple:
    H, PW = config.padded_height, config.padded_width
    for ok, why in (
        (H <= MAX_PADDED_HEIGHT, f"padded height {H} > {MAX_PADDED_HEIGHT}: hit maps and "
                                 "full-row masks are 64-bit words at most"),
        (PW <= MAX_PADDED_WIDTH, f"padded width {PW} > {MAX_PADDED_WIDTH}: an env's rows live in "
                                 "registers, 4 words a row at most"),
        (S <= MAX_PIECE_SIDE, f"piece box side {S} > {MAX_PIECE_SIDE}: a piece table entry is "
                              "2 words at most"),
        (S <= min(H, PW), f"piece box side {S} exceeds the padded board {H}x{PW}"),
        (1 <= n_pieces <= MAX_PIECES, f"{n_pieces} pieces: 1 to {MAX_PIECES} are built"),
        (1 <= config.queue_size <= MAX_QUEUE, f"queue size {config.queue_size}: 1 to {MAX_QUEUE} "
                                              "are built"),
        (1 <= config.holder_size <= MAX_HOLDER, f"holder size {config.holder_size}: 1 to "
                                                f"{MAX_HOLDER} are built"),
        (not flagship or H * PW <= MAX_BOARD_CELLS,
         f"padded board of {H * PW} cells > {MAX_BOARD_CELLS}: the flagship kernels lay out "
         "their shared memory for boards up to that size"),
        (config.queue_kind in ("bag", "uniform"), f"queue_kind {config.queue_kind!r} has no kernel"),
    ):
        if not ok:
            raise NotImplementedError(
                f"the engine kernels: {why} (pass device='cpu' for the plain versions)")
    return (("TETRIS_HEIGHT", config.height), ("TETRIS_WIDTH", config.width),
            ("TETRIS_PAD", config.padding), ("TETRIS_QS", config.queue_size),
            ("TETRIS_HS", config.holder_size), ("TETRIS_NP", n_pieces), ("TETRIS_S", S))


def feature_defines(height: int, width: int) -> tuple:
    """The defines that build ``features.cu`` for a ``height`` x ``width``
    crop, or ``NotImplementedError`` naming the static limit passed: at most
    64 rows (the height counters are 7 bit planes) and 128 columns (a row
    mask is 4 words)."""
    for ok, why in (
        (1 <= height <= MAX_FEATURE_HEIGHT, f"{height} rows: 1 to {MAX_FEATURE_HEIGHT} are built "
                                            "(7 bit planes of height counters)"),
        (1 <= width <= MAX_FEATURE_WIDTH, f"{width} columns: 1 to {MAX_FEATURE_WIDTH} are built "
                                          "(4 words a row mask)"),
    ):
        if not ok:
            raise NotImplementedError(f"feature_vector: {why} (pass a CPU tensor for the plain version)")
    return (("TETRIS_HEIGHT", height), ("TETRIS_WIDTH", width))


def compose_defines(board_shape, queue_shape, holder_shape, n_palette: int) -> tuple:
    """The defines that build ``observe_dict.cu``'s ``compose_rgb`` for id
    boards ``[N, H, PW]``, strips ``[M, S, S * QS]`` and ``[M, S, S * HS]``
    and a palette of ``n_palette`` colours (2 + the pieces).  The composite
    needs no padding, so the build takes the shell's, ``padding = S`` (less
    on a board narrower than ``2 S + 1``): at every geometry whose padding
    is its pieces' side this is ``observe_dict``'s own build.  Raises
    ``TypeError``, as JAX's composite does, on a board lower than the two
    strips, and ``NotImplementedError`` past :func:`engine_defines`' limits."""
    (H, PW), (S, qw), (hs, hw) = board_shape[1:], queue_shape[1:], holder_shape[1:]
    if hs != S or qw % S or hw % S or not qw or not hw:
        raise ValueError(f"compose_rgb: strips {tuple(queue_shape)} and {tuple(holder_shape)} are not "
                         "[M, S, S * size] thumbnails of one side S")
    if H < 2 * S:
        raise TypeError(f"compose_rgb: a board of {H} rows is lower than the sidebar's two {S}-row "
                        "strips (the JAX composite's bedrock separator would have a negative height)")
    pad = min(S, (PW - 1) // 2)
    config = EngineConfig(width=PW - 2 * pad, height=H - pad, padding=pad, queue_size=qw // S,
                          holder_size=hw // S)
    return _defines(config, n_palette - 2, S, flagship=True)


def _check_fields(state, names, shapes: dict, dtypes: dict, device) -> None:
    """Each field ``names`` of ``state``: contiguous, on ``device``, of its shape
    and dtype (int32 where ``dtypes`` names none)."""
    for k in names:
        v = getattr(state, k)
        want = dtypes.get(k, torch.int32)
        if not v.is_cuda or v.device != device or v.dtype != want \
                or tuple(v.shape) != shapes[k] or not v.is_contiguous():
            raise ValueError(
                f"state.{k}: want a contiguous CUDA {want} tensor of shape {shapes[k]} on "
                f"{device}, got {v.dtype} {tuple(v.shape)} on {v.device} "
                f"(contiguous={v.is_contiguous()})"
            )


def _empty(cls, shapes: dict, dtypes: dict, device):
    """A state dataclass ``cls`` of uninitialised CUDA buffers."""
    return cls(**{k: torch.empty(shapes[k], dtype=dtypes.get(k, torch.int32), device=device)
                  for k in shapes})


def _check_state(state: turbo.TurboState, config: EngineConfig, n_pieces: int, device) -> int:
    B = state.piece.shape[0]
    _check_fields(state, turbo.FIELDS, _state_shapes(config, n_pieces, B), _STATE_DTYPES, device)
    return B


def _ptrs(state: turbo.TurboState) -> _StatePtrs:
    return _StatePtrs(*(getattr(state, k).data_ptr() for k in turbo.FIELDS))


def _empty_state(config: EngineConfig, n_pieces: int, B: int, device) -> turbo.TurboState:
    return _empty(turbo.TurboState, _state_shapes(config, n_pieces, B), _STATE_DTYPES, device)


# Lanes an env of turbo_step's builds (csrc/turbo_step.cu:turbo_step_launch).
# One thread an env is the fastest build from these batches up, without and
# with the observation in the same launch; below them a group of 8 lanes
# shares an env's rows (PERF.md, the times of each build on an H100).
STEP_LANES = (1, 8)
ONE_LANE_FROM_B = 8192
ONE_LANE_FROM_B_OBS = 16384
_STEP_THREADS = 128  # csrc/turbo_step.cu:kThreads
_MAX_SMEM = 227 * 1024  # shared memory a block can take (dynamic)


def step_lanes(B: int, frame_bytes: int = 0) -> int:
    """The lanes an env that ``turbo_step`` takes at batch ``B``, without an
    observation (``frame_bytes`` 0) or with one of ``frame_bytes`` an env: 1
    from ``ONE_LANE_FROM_B`` (``ONE_LANE_FROM_B_OBS``) envs up, else 8; 8
    also where one lane an env could not stage its block's observations in
    shared memory."""
    one_from = ONE_LANE_FROM_B_OBS if frame_bytes else ONE_LANE_FROM_B
    if B >= one_from and _STEP_THREADS * frame_bytes <= _MAX_SMEM:
        return 1
    return 8


def _check_obs(obs: torch.Tensor, config: EngineConfig, B: int, device) -> None:
    want = (B, config.height, config.width)
    if not isinstance(obs, torch.Tensor) or obs.dtype != torch.int8 or tuple(obs.shape) != want \
            or not obs.is_contiguous() or not obs.is_cuda or obs.device != device:
        got = (f"{obs.dtype} {tuple(obs.shape)} on {obs.device} (contiguous={obs.is_contiguous()})"
               if isinstance(obs, torch.Tensor) else type(obs).__name__)
        raise ValueError(f"obs: want a contiguous CUDA int8 tensor of shape {want} on {device}, "
                         f"got {got}")


def turbo_step(state: turbo.TurboState, action: torch.Tensor, config: EngineConfig,
               pieces: PieceSet, rewards: RewardsMapping, max_clear: int = 4,
               obs: torch.Tensor = None, lanes: int = None, logits: torch.Tensor = None,
               act_key=None, env_offset: int = 0):
    """Launch ``turbo_step``: returns ``(new_state, reward f32[B], done bool[B], lines int32[B])``.

    The new state is in new buffers; ``state`` is left as it was.  With
    ``obs``, an ``int8[B, height, width]`` tensor, the same launch also
    writes ``observe_board`` of the new state (after auto-reset) into it.
    With ``logits`` (``f32[B, 8]``, only together with ``obs``) and
    ``act_key`` (the step's ``uint32[2]`` key on the host), the launch
    samples each env's action as :func:`sample_actions` does and steps with
    it: ``action`` is ignored (pass None) and ``(action int32[B], log_prob
    f32[B])`` are returned after ``lines``; ``env_offset`` is the global
    index of env 0 (a rank's first env), so env ``b`` draws at the global
    env's counters.  ``lanes`` (one of ``STEP_LANES``) overrides
    :func:`step_lanes`' choice.
    """
    if lanes is not None and lanes not in STEP_LANES:
        raise ValueError(f"lanes must be one of {STEP_LANES}, got {lanes}")
    device = state.rows.device
    B = state.piece.shape[0]
    sample = logits is not None
    if sample:
        if obs is None:
            raise ValueError("turbo_step samples its action only together with obs")
        key = _sample_args(logits, act_key, env_offset, B, device)
    elif act_key is not None:
        raise ValueError("act_key without logits")
    elif env_offset:
        raise ValueError("env_offset without logits")
    if obs is not None:
        _check_obs(obs, config, B, device)
    t, packed, box = turbo.tables_for(pieces, device)
    defines = engine_defines(config, t)
    if max_clear < 0:
        raise ValueError(f"max_clear must be >= 0, got {max_clear}")
    frame = config.height * config.width if obs is not None else 0
    lanes = step_lanes(B, frame) if lanes is None else lanes
    if (_STEP_THREADS // lanes) * frame > _MAX_SMEM:
        raise NotImplementedError(
            f"turbo_step stages {_STEP_THREADS // lanes} observations of {frame} bytes a block in "
            f"{_MAX_SMEM} bytes of shared memory")
    _check_state(state, config, t.n_pieces, device)
    if sample:
        action = torch.empty((B,), dtype=torch.int32, device=device)
        log_prob = torch.empty((B,), dtype=torch.float32, device=device)
    elif not action.is_cuda or action.dtype != torch.int32 or tuple(action.shape) != (B,) \
            or not action.is_contiguous() or action.device != device:
        raise ValueError(f"action: want a contiguous int32[{B}] tensor on {device}")
    out = _empty_state(config, t.n_pieces, B, device)
    reward = torch.empty((B,), dtype=torch.float32, device=device)
    done = torch.empty((B,), dtype=torch.bool, device=device)
    lines = torch.empty((B,), dtype=torch.int32, device=device)
    result = (out, reward, done, lines) + ((action, log_prob) if sample else ())
    if B == 0:
        return result
    params = _StepParams(
        int(config.gravity_enabled), int(config.auto_reset), int(config.queue_kind == "uniform"),
        int(max_clear), float(np.float32(rewards.alife)), float(np.float32(rewards.game_over)),
    )
    in_p, out_p = _ptrs(state), _ptrs(out)
    smp = _SampleArgs(logits.data_ptr(), action.data_ptr(), log_prob.data_ptr(), int(key[0]),
                      int(key[1]), int(env_offset)) if sample else None
    rc = _lib("turbo_step", defines).turbo_step_launch(
        ctypes.byref(in_p), ctypes.byref(out_p), action.data_ptr(), reward.data_ptr(),
        done.data_ptr(), lines.data_ptr(), packed.data_ptr(), box.data_ptr(),
        None if obs is None else obs.data_ptr(), B, lanes, ctypes.byref(params),
        None if smp is None else ctypes.byref(smp), _stream(device),
    )
    _check(rc, "turbo_step")
    LAUNCHES["turbo_step"] += 1
    if obs is not None:
        LAUNCHES["turbo_step_obs"] += 1
    if sample:
        LAUNCHES["turbo_step_sample"] += 1
    return result


def turbo_init(keys: torch.Tensor, config: EngineConfig, pieces: PieceSet,
               key_rows: bool = False) -> turbo.TurboState:
    """Launch ``turbo_init``: fresh episodes from per-env keys ``uint32[B,
    2]``, or with ``key_rows`` from the state's layout ``uint32[2, B]``
    (``TurboState.key``), read where it lies.

    The kernel reads an env's ``[B, 2]`` key as one 8-byte word (a copy is
    made of keys that do not start on an 8-byte boundary); a copy is made
    of keys that are not contiguous."""
    device = keys.device
    t, _, box = turbo.tables_for(pieces, device)
    defines = engine_defines(config, t)
    want = "[2, B]" if key_rows else "[B, 2]"
    if not keys.is_cuda or keys.dtype != torch.uint32 or keys.ndim != 2 \
            or keys.shape[0 if key_rows else 1] != 2:
        raise ValueError(f"keys: want a CUDA uint32{want} tensor, got {keys.dtype} "
                         f"{tuple(keys.shape)} on {keys.device}")
    keys = keys.contiguous()
    if not key_rows and keys.data_ptr() % 8:
        keys = keys.clone()
    B = keys.shape[1 if key_rows else 0]
    if config.padded_height * turbo.n_words(config) * B >= 2**31:
        raise ValueError(f"turbo_init: {B} envs' rows pass the kernel's 31-bit word index")
    out = _empty_state(config, t.n_pieces, B, device)
    if B == 0:
        return out
    out_p = _ptrs(out)
    rc = _lib("turbo_step", defines).turbo_init_launch(
        keys.data_ptr(), ctypes.byref(out_p), box.data_ptr(), B,
        int(config.queue_kind == "uniform"), int(key_rows), _stream(device),
    )
    _check(rc, "turbo_init")
    LAUNCHES["turbo_init"] += 1
    return out


def observe_board(state: turbo.TurboState, config: EngineConfig, pieces: PieceSet) -> torch.Tensor:
    """Launch ``observe_board``: ``int8[B, height, width]`` board with the piece as -1."""
    device = state.rows.device
    t, packed, _ = turbo.tables_for(pieces, device)
    if t.size > 31 or 16 * config.height * config.width > 227 * 1024:
        raise NotImplementedError(
            f"observe_board takes piece boxes of side <= 31 and 16 frames in 227 KB of shared "
            f"memory; got side {t.size}, {config.height}x{config.width} frames")
    B = state.piece.shape[0]
    want = {
        "rows": (torch.uint32, _rows_shape(config, B)), "piece": (torch.int32, (B,)),
        "rotation": (torch.int32, (B,)), "x": (torch.int32, (B,)), "y": (torch.int32, (B,)),
        "game_over": (torch.bool, (B,)),
    }
    for k, (dt, shape) in want.items():
        v = getattr(state, k)
        if not v.is_cuda or v.dtype != dt or tuple(v.shape) != shape or not v.is_contiguous() \
                or v.device != device:
            raise ValueError(f"state.{k}: want a contiguous {dt}{list(shape)} tensor on {device}")
    out = torch.empty((B, config.height, config.width), dtype=torch.int8, device=device)
    if B == 0:
        return out
    geom = _ObsGeometry(
        config.height, config.width, config.padding, config.padded_height,
        config.padded_width, t.size, t.n_pieces * 4, turbo.n_words(config), t.n_words,
    )
    rc = _lib("observe_board").observe_board_launch(
        state.rows.data_ptr(), state.piece.data_ptr(), state.rotation.data_ptr(),
        state.x.data_ptr(), state.y.data_ptr(), state.game_over.data_ptr(), packed.data_ptr(),
        out.data_ptr(), B, ctypes.byref(geom), _stream(device),
    )
    _check(rc, "observe_board")
    LAUNCHES["observe_board"] += 1
    return out


def heights(state: turbo.TurboState, config: EngineConfig) -> torch.Tensor:
    """Launch ``heights``: column heights ``int32[width, B]`` of the packed rows."""
    device = state.rows.device
    B = state.rows.shape[-1]
    _check_tensor(state.rows, "state.rows", torch.uint32, _rows_shape(config, B), device)
    out = torch.empty((config.width, B), dtype=torch.int32, device=device)
    if B == 0 or config.width == 0:
        return out
    rc = _lib("heights").heights_launch(
        state.rows.data_ptr(), out.data_ptr(), B, config.height, config.width, config.padding,
        turbo.n_words(config), _stream(device),
    )
    _check(rc, "heights")
    LAUNCHES["heights"] += 1
    return out


def _check_counters(env_offset: int, B: int, per_env: int) -> None:
    """The global counters ``[env_offset * per_env, (env_offset + B) * per_env)`` fit in 31 bits."""
    if env_offset < 0:
        raise ValueError(f"env_offset must be >= 0, got {env_offset}")
    if (env_offset + B) * per_env >= 2**31:
        raise ValueError(f"envs [{env_offset}, {env_offset + B}) too many for 32-bit counters")


def _check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if not t.is_cuda or t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous CUDA {dtype} tensor of shape {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


# The builds of csrc/gae.cu: TMA tensor copies where every row of every
# [T, B] array lies on 16 bytes, else a cp.async a word.
GAE_BUILDS = ("tma", "cp_async")


def gae_build(B: int, *tensors: torch.Tensor) -> str:
    """The build of ``gae`` that the wrapper takes for batch ``B`` and its
    ``[T, B]`` tensors (inputs and outputs): ``"tma"`` where ``B % 16 ==
    0`` and every tensor starts on 16 bytes, so that each array is a TMA
    tensor (its rows' stride a multiple of 16 bytes), else ``"cp_async"``."""
    if B % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return "tma"
    return "cp_async"


def gae(reward: torch.Tensor, value: torch.Tensor, done: torch.Tensor, last_value: torch.Tensor,
        gamma: float, gae_lambda: float, build: str = None):
    """Launch ``gae``: returns ``(advantages f32[T, B], targets f32[T, B])``.

    ``reward`` and ``value`` are ``f32[T, B]``, ``done`` is ``bool[T, B]``,
    ``last_value`` is ``f32[B]``.  ``gamma`` and ``gamma * gae_lambda`` (the
    product formed in double) are rounded to float32 once, as JAX does.
    ``build`` (one of ``GAE_BUILDS``) overrides :func:`gae_build`'s choice;
    ``"tma"`` raises where the rows do not lie on 16 bytes.
    """
    if build is not None and build not in GAE_BUILDS:
        raise ValueError(f"build must be one of {GAE_BUILDS}, got {build!r}")
    device = reward.device
    if reward.ndim != 2:
        raise ValueError(f"reward: want [T, B], got {tuple(reward.shape)}")
    T, B = reward.shape
    _check_tensor(reward, "reward", torch.float32, (T, B), device)
    _check_tensor(value, "value", torch.float32, (T, B), device)
    _check_tensor(done, "done", torch.bool, (T, B), device)
    _check_tensor(last_value, "last_value", torch.float32, (B,), device)
    advantages = torch.empty((T, B), dtype=torch.float32, device=device)
    targets = torch.empty((T, B), dtype=torch.float32, device=device)
    if T * B == 0:
        return advantages, targets
    fits = gae_build(B, reward, value, done, advantages, targets)
    if build == "tma" and fits != "tma":
        raise ValueError(f"gae's tma build needs B % 16 == 0 and 16-byte aligned tensors, "
                         f"got B = {B}")
    build = fits if build is None else build
    rc = _lib("gae").gae_launch(
        reward.data_ptr(), value.data_ptr(), done.data_ptr(), last_value.data_ptr(),
        advantages.data_ptr(), targets.data_ptr(), T, B,
        float(np.float32(gamma)), float(np.float32(gamma * gae_lambda)), int(build == "tma"),
        _stream(device),
    )
    _check(rc, "gae")
    LAUNCHES["gae"] += 1
    return advantages, targets


def sample_actions(logits: torch.Tensor, act_key, return_uniforms: bool = False,
                   env_offset: int = 0):
    """Launch ``ppo_sample``: returns ``(action int32[B], log_prob f32[B])``.

    ``logits`` is ``f32[B, 8]``; ``act_key`` is the step's ``uint32[2]``
    key on the host (``jax.random.categorical``'s key); ``env_offset`` is
    the global index of env 0, so row ``b`` draws at the counters of global
    env ``env_offset + b``.  With
    ``return_uniforms`` the kernel also writes the uniforms ``f32[B, 8]``
    behind its Gumbel noise, returned third, so that a check can hold them
    against JAX's bits.
    """
    device = logits.device
    if logits.ndim != 2 or logits.shape[1] != 8:
        raise NotImplementedError(f"ppo_sample is built for [B, 8] logits, got {tuple(logits.shape)}")
    B = logits.shape[0]
    _check_tensor(logits, "logits", torch.float32, (B, 8), device)
    _check_counters(env_offset, B, 8)
    key = np.asarray(act_key, dtype=np.uint32)
    action = torch.empty((B,), dtype=torch.int32, device=device)
    log_prob = torch.empty((B,), dtype=torch.float32, device=device)
    uniforms = torch.empty((B, 8), dtype=torch.float32, device=device) if return_uniforms else None
    out = (action, log_prob, uniforms) if return_uniforms else (action, log_prob)
    if B == 0:
        return out
    rc = _lib("ppo_sample").ppo_sample_launch(
        logits.data_ptr(), action.data_ptr(), log_prob.data_ptr(),
        uniforms.data_ptr() if return_uniforms else None, B, int(key[0]), int(key[1]),
        int(env_offset), _stream(device),
    )
    _check(rc, "ppo_sample")
    LAUNCHES["ppo_sample"] += 1
    return out


# ---------------------------------------------------------------------------
# Grouped placements, masked epsilon-greedy, replay
# ---------------------------------------------------------------------------

_GROUPED_MODES = {"features": 0, "boards": 1}


def grouped_placements(state: turbo.TurboState, config: EngineConfig, pieces: PieceSet,
                       max_clear: int = 4, mode: str = "features"):
    """Launch ``grouped_placements``: ``(obs, mask f32[A, B], game_over bool[A, B],
    lines int32[A, B])``, ``obs`` ``f32[B, A, width + 3]`` (features) or
    ``f32[B, A, height, width]`` (boards).  Built for each geometry within
    :func:`engine_defines`' limits; rows of one word or of several."""
    if mode not in _GROUPED_MODES:
        raise ValueError(f"unknown turbo grouped observation mode: {mode}")
    device = state.rows.device
    t, packed, box = turbo.tables_for(pieces, device)
    defines = engine_defines(config, t)
    if max_clear < 0:
        raise ValueError(f"max_clear must be >= 0, got {max_clear}")
    B = state.piece.shape[0]
    A = config.width * 4
    _check_tensor(state.rows, "state.rows", torch.uint32, _rows_shape(config, B), device)
    _check_tensor(state.piece, "state.piece", torch.int32, (B,), device)
    _check_tensor(state.rotation, "state.rotation", torch.int32, (B,), device)
    obs_shape = (B, A, config.width + 3) if mode == "features" else (B, A, config.height, config.width)
    obs = torch.empty(obs_shape, dtype=torch.float32, device=device)
    mask = torch.empty((A, B), dtype=torch.float32, device=device)
    game_over = torch.empty((A, B), dtype=torch.bool, device=device)
    lines = torch.empty((A, B), dtype=torch.int32, device=device)
    if B == 0:
        return obs, mask, game_over, lines
    params = _PlacementParams(int(max_clear), _GROUPED_MODES[mode])
    rc = _lib("grouped_placements", defines).grouped_placements_launch(
        state.rows.data_ptr(), state.piece.data_ptr(), state.rotation.data_ptr(),
        packed.data_ptr(), box.data_ptr(), obs.data_ptr(), mask.data_ptr(), game_over.data_ptr(),
        lines.data_ptr(), B, ctypes.byref(params), _stream(device),
    )
    _check(rc, "grouped_placements")
    LAUNCHES["grouped_placements"] += 1
    return obs, mask, game_over, lines


def grouped_placements_occupancy(config: EngineConfig, pieces: PieceSet) -> dict:
    """The shape of ``grouped_placements``' build at ``config``: envs and
    threads a block, static shared memory, candidates a boards chunk and
    the chunk's buffers (2 where they fit in 227 KB), whether the features
    are staged, and for the features and the boards mode the dynamic shared
    memory and the blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs a card."""
    defines = engine_defines(config, turbo.tables_for(pieces, "cpu")[0])
    vals = (ctypes.c_int * 10)()
    _check(_lib("grouped_placements", defines).grouped_placements_occupancy(ctypes.addressof(vals)),
           "grouped_placements_occupancy")
    keys = ("envs_per_block", "threads_per_block", "static_smem_bytes", "chunk_candidates",
            "chunk_buffers", "features_staged", "features_dynamic_smem_bytes",
            "features_blocks_per_sm", "boards_dynamic_smem_bytes", "boards_blocks_per_sm")
    return dict(zip(keys, list(vals)))


# Lanes an env of grouped_act's builds (csrc/grouped_act.cu): the A
# candidates split across a group of 8, 16 or 32 lanes, whose running bests
# a shuffle butterfly combines.  On an H100 (PERF.md; 40 candidates)
# the widest group is the fastest while the batch's lanes stay within
# GROUPED_ACT_LANE_BUDGET (32 at 1024 envs, 16 at 4096): below it one env's
# chain of draws is the time, above it the idle lanes of a wide group (A = 40
# over 32 lanes: 8 of them take two candidates) and its longer butterfly
# (8 at 65536, 2.1x faster than 32).
GROUPED_ACT_LANES = (8, 16, 32)
GROUPED_ACT_LANE_BUDGET = 65536


def grouped_act_lanes(B: int) -> int:
    """The lanes an env that ``grouped_act`` takes at batch ``B``: the widest
    of ``GROUPED_ACT_LANES`` whose ``B * lanes`` stays within
    ``GROUPED_ACT_LANE_BUDGET``, else 8."""
    fits = [L for L in GROUPED_ACT_LANES if B * L <= GROUPED_ACT_LANE_BUDGET]
    return max(fits, default=min(GROUPED_ACT_LANES))


def grouped_act_occupancy() -> dict:
    """Blocks an SM holds of each ``grouped_act`` build
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), by lanes; needs a card."""
    vals = (ctypes.c_int * len(GROUPED_ACT_LANES))()
    _check(_lib("grouped_act").grouped_act_occupancy(ctypes.addressof(vals)), "grouped_act_occupancy")
    return {f"lanes{L}": v for L, v in zip(GROUPED_ACT_LANES, vals)}


def grouped_act(q: torch.Tensor, mask: torch.Tensor, act_key=None, eps_key=None,
                epsilon: float = 0.0, fill: float = -1e9, return_uniforms: bool = False,
                lanes: int = None):
    """Launch ``grouped_act``: masked epsilon-greedy actions ``int32[B]``.

    ``q`` is ``f32[B, A]``, contiguous; ``mask`` is ``f32[B, A]`` with any
    strides (the engine's ``[A, B]`` mask transposed is a view).  With
    ``act_key`` and ``eps_key`` (host ``uint32[2]`` keys) an env explores
    where its uniform is below ``epsilon`` (a float32 value) and then takes
    the Gumbel-max of the legal candidates; without them the action is the
    greedy one.  ``fill`` is the value of an illegal candidate.  With
    ``return_uniforms`` the uniforms behind the noise ``f32[B, A]`` and the
    exploration draw ``f32[B]`` come back too.  ``lanes`` (one of
    ``GROUPED_ACT_LANES``) overrides :func:`grouped_act_lanes`' choice.
    """
    if lanes is not None and lanes not in GROUPED_ACT_LANES:
        raise ValueError(f"lanes must be one of {GROUPED_ACT_LANES}, got {lanes}")
    device = q.device
    if q.ndim != 2:
        raise ValueError(f"q: want [B, A], got {tuple(q.shape)}")
    B, A = q.shape
    _check_tensor(q, "q", torch.float32, (B, A), device)
    if not mask.is_cuda or mask.device != device or mask.dtype != torch.float32 \
            or tuple(mask.shape) != (B, A):
        raise ValueError(f"mask: want a CUDA float32 tensor of shape {(B, A)} on {device}")
    explore = act_key is not None
    if explore != (eps_key is not None):
        raise ValueError("act_key and eps_key go together")
    if return_uniforms and not explore:
        raise ValueError("return_uniforms needs the random keys")
    if B * A >= 2**31:
        raise ValueError(f"{B} x {A} candidates too many for 32-bit counters")
    ak = np.asarray(act_key if explore else (0, 0), dtype=np.uint32)
    ek = np.asarray(eps_key if explore else (0, 0), dtype=np.uint32)
    action = torch.empty((B,), dtype=torch.int32, device=device)
    noise_u = torch.empty((B, A), dtype=torch.float32, device=device) if return_uniforms else None
    eps_u = torch.empty((B,), dtype=torch.float32, device=device) if return_uniforms else None
    out = (action, noise_u, eps_u) if return_uniforms else action
    if B == 0:
        return out
    lanes = grouped_act_lanes(B) if lanes is None else lanes
    params = _ActParams(
        A, mask.stride(0), mask.stride(1), float(np.float32(fill)), int(explore),
        int(ak[0]), int(ak[1]), int(ek[0]), int(ek[1]), float(np.float32(epsilon)),
    )
    rc = _lib("grouped_act").grouped_act_launch(
        q.data_ptr(), mask.data_ptr(), action.data_ptr(),
        noise_u.data_ptr() if return_uniforms else None,
        eps_u.data_ptr() if return_uniforms else None, B, ctypes.byref(params), int(lanes),
        _stream(device),
    )
    _check(rc, "grouped_act")
    LAUNCHES["grouped_act"] += 1
    return out


# replay_add's threads a block and most blocks a field of words (csrc/replay.cu)
_ADD_THREADS, _ADD_MAX_RUNS = 256, 32768


def _copy_word(row_bytes: int, *tensors, stride: int = 0) -> int:
    """The widest copy granule (16, 4 or 1 bytes) that the entry size, a
    source row stride in bytes and every pointer allow."""
    for word in (16, 4):
        if row_bytes % word == 0 and stride % word == 0 \
                and all(t.data_ptr() % word == 0 for t in tensors):
            return word
    return 1


def _rows_contiguous(x: torch.Tensor) -> bool:
    """Each ``x[b]`` is contiguous (the rows may lie at any stride)."""
    expect = 1
    for size, stride in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def _replay_fields(fields) -> _ReplayFields:
    if len(fields) > _MAX_REPLAY_FIELDS:
        raise NotImplementedError(f"the replay kernels take at most {_MAX_REPLAY_FIELDS} fields")
    out = _ReplayFields()
    out.n = len(fields)
    for i, f in enumerate(fields):
        out.f[i] = f
    return out


def replay_add(data: dict, transitions: dict, pos: int) -> None:
    """Launch ``replay_add``: write one env batch into every store of ``data`` at entry ``pos``.

    Each transition is ``[B, ...]`` with its store's dtype and trailing
    shape, and each of its rows ``x[b]`` contiguous (the rows may lie at any
    stride, as the newest frame ``window[:, -1]`` of a frame stack does), or
    a 2-D ``[B, n]`` view of a contiguous batch-minor ``[n, B]`` tensor of
    4-byte elements (written transposed).  ``pos + B`` must not pass the
    capacity.  Writes in place.
    """
    if set(transitions) != set(data):
        raise ValueError(f"transition fields {sorted(transitions)} differ from {sorted(data)}")
    B = next(iter(transitions.values())).shape[0]
    fields = []
    for name, store in data.items():
        x = transitions[name]
        device = store.device
        capacity = store.shape[0]
        if not x.is_cuda or x.device != device or x.dtype != store.dtype \
                or tuple(x.shape) != (B,) + tuple(store.shape[1:]):
            raise ValueError(f"{name}: want a CUDA {store.dtype} tensor of shape "
                             f"{(B,) + tuple(store.shape[1:])} on {device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if not 0 <= pos <= capacity - B:
            raise ValueError(f"block [{pos}, {pos + B}) outside capacity {capacity}")
        _check_tensor(store, f"store {name}", store.dtype, store.shape, device)
        row_bytes = store[0].numel() * store.element_size()
        transposed = not _rows_contiguous(x)
        if transposed and not (x.ndim == 2 and x.element_size() == 4 and x.stride() == (1, B)):
            raise ValueError(f"{name}: want contiguous rows or the transpose of a "
                             f"contiguous [n, B] tensor of 4-byte elements")
        src_stride = row_bytes if transposed or B <= 1 else x.stride(0) * x.element_size()
        word = 4 if transposed else _copy_word(row_bytes, store, x, stride=src_stride)
        if not transposed and B * (row_bytes // word) + _ADD_MAX_RUNS * _ADD_THREADS >= 2**32:
            # the kernel counts a field's words in 32 bits (csrc/replay.cu:add_words)
            raise NotImplementedError(f"replay_add: {name} holds {B * (row_bytes // word)} words of "
                                      f"{word} bytes, past the kernel's 32-bit word index")
        fields.append(_ReplayField(store.data_ptr(), x.data_ptr(), None, None, row_bytes,
                                   src_stride, word, int(transposed)))
    if B == 0:
        return
    device = next(iter(data.values())).device
    rc = _lib("replay").replay_add_launch(ctypes.byref(_replay_fields(fields)), int(pos), B,
                                          _stream(device))
    _check(rc, "replay_add")
    LAUNCHES["replay_add"] += 1


def _sample_setup(data: dict, key, n: int, maxval: int, start: int, batch: int,
                  return_offsets: bool, window: tuple = None):
    """The set-up that both replay samples share: the checks, the outputs and
    the launch's arguments.  ``window`` is ``(field, k)`` where that field
    comes back as ``k``-frame windows ``[n, k, ...]``.  Returns ``(out,
    fields, params, offsets, stream)``, ``out`` as the wrappers return it."""
    from tetris_gymnasium_torch.ops import threefry

    stores = list(data.items())
    device = stores[0][1].device
    capacity = stores[0][1].shape[0]
    if n >= 2**31 or capacity >= 2**31:
        raise ValueError(f"{n} samples or capacity {capacity} too large for 32-bit counters")
    span, multiplier = threefry.randint_span(maxval)
    k_hi, k_lo = threefry.split(np.asarray(key, dtype=np.uint32))
    cur, nxt, fields = {}, ({} if batch > 0 else None), []
    for name, store in stores:
        if store.shape[0] != capacity:
            raise ValueError(f"store {name} has {store.shape[0]} entries, not {capacity}")
        _check_tensor(store, f"store {name}", store.dtype, store.shape, device)
        row_bytes = store[0].numel() * store.element_size()
        per = (window[1],) if window is not None and name == window[0] else ()
        cur[name] = torch.empty((n,) + per + tuple(store.shape[1:]), dtype=store.dtype,
                                device=device)
        outs = [cur[name]]
        if nxt is not None:
            nxt[name] = torch.empty_like(cur[name])
            outs.append(nxt[name])
        word = _copy_word(row_bytes, store, *outs)
        fields.append(_ReplayField(store.data_ptr(), None, cur[name].data_ptr(),
                                   nxt[name].data_ptr() if nxt is not None else None,
                                   row_bytes, row_bytes, word, 0))
    offsets = torch.empty((n,), dtype=torch.int32, device=device) if return_offsets else None
    out = (cur, nxt, offsets) if return_offsets else (cur, nxt)
    params = _SampleParams(int(k_hi[0]), int(k_hi[1]), int(k_lo[0]), int(k_lo[1]), span,
                           multiplier, int(start), capacity, int(batch), n)
    return (out, ctypes.byref(_replay_fields(fields)), ctypes.byref(params),
            offsets.data_ptr() if return_offsets else None, _stream(device))


def replay_sample(data: dict, key, n: int, maxval: int, start: int = 0, batch: int = 0,
                  return_offsets: bool = False):
    """Launch ``replay_sample``: ``n`` entries of every store, drawn on the card.

    The offsets are ``jax.random.randint(key, (n,), 0, maxval)``, from the
    host ``uint32[2]`` key; entry ``i`` is ``(start + off) % capacity``.
    With ``batch > 0`` the successors ``(i + batch) % capacity`` come too.
    Returns ``(cur, nxt)`` dicts (``nxt`` None without successors), and the
    offsets ``int32[n]`` third with ``return_offsets``.
    """
    if not (0 <= start < 2**31 and 0 <= batch < 2**31):
        raise ValueError(f"start {start} and batch {batch} must lie in [0, 2**31)")
    out, fields, params, offsets, stream = _sample_setup(data, key, n, maxval, start, batch,
                                                         return_offsets)
    if n == 0:
        return out
    _check(_lib("replay").replay_sample_launch(fields, params, offsets, stream), "replay_sample")
    LAUNCHES["replay_sample"] += 1
    return out


def replay_sample_shape(data: dict, n: int, batch: int = 0) -> dict:
    """The shape of ``replay_sample``'s launch for ``n`` samples of the
    stores ``data`` (with successors when ``batch > 0``): lanes a unit, a
    chunk of a sample's words (the fewest of 8, 16 and 32 that cover a
    sample at 16 words a lane, widened to 32 while n's warps give the
    card's SMs at most 16 each), words a lane (4 while the units' warps
    still fit 16 an SM, else 16), units (chunks) a sample, units a block
    (as many as give every SM of the card a block, up to 256 threads, in
    whole warps) and the sample's words; needs a card."""
    fields = []
    for store in data.values():
        row_bytes = store[0].numel() * store.element_size()
        fields.append(_ReplayField(store.data_ptr(), None, None, None, row_bytes, row_bytes,
                                   _copy_word(row_bytes, store), 0))
    vals = (ctypes.c_int * 5)()
    _check(_lib("replay").replay_sample_shape(ctypes.byref(_replay_fields(fields)), int(batch), n,
                                              ctypes.addressof(vals)), "replay_sample_shape")
    return dict(zip(("lanes", "words_per_lane", "chunks", "units_per_block", "words"), list(vals)))


# The builds of replay_sample_stacked: the bulk build stages a sample's
# <= K + 1 distinct frames in shared memory with bulk asynchronous copies
# (frames of a multiple of 16 bytes on 16-byte boundaries, K + 1 of them in
# 200 KB), the words build copies each output frame in the field's words.
REPLAY_STACKED_BUILDS = ("bulk", "words")
_MAX_STAGE_BYTES = 200 * 1024  # csrc/replay.cu:kMaxStage


def replay_stacked_build(row_bytes: int, k: int, *tensors: torch.Tensor) -> str:
    """The build of ``replay_sample_stacked`` that the wrapper takes for an
    obs entry of ``row_bytes`` bytes, ``k``-frame windows and the obs
    field's store and outputs: ``"bulk"`` where ``row_bytes`` is a multiple
    of 16, every tensor starts on 16 bytes and ``k + 1`` frames fit the
    stage, else ``"words"``."""
    if row_bytes % 16 == 0 and (k + 1) * row_bytes <= _MAX_STAGE_BYTES \
            and all(t.data_ptr() % 16 == 0 for t in tensors):
        return "bulk"
    return "words"


def replay_sample_stacked(data: dict, key, n: int, maxval: int, start: int, batch: int, k: int,
                          obs_key: str = "obs", done_key: str = "done",
                          return_offsets: bool = False, build: str = None):
    """Launch ``replay_sample_stacked``: ``n`` entries and their successors,
    the ``obs_key`` field rebuilt as ``k``-frame windows, drawn on the card.

    The offsets are ``jax.random.randint(key, (n,), 0, maxval)``; entry ``i``
    is ``(start + (k - 1) * batch + off) % capacity`` and its successor
    ``(i + batch) % capacity``.  The window of an entry looks back ``batch``
    entries a frame and stops at the first ``done`` (``done_key``, a bool
    store), repeating the episode's first frame from there; it comes oldest
    first, ``[n, k, ...]``.  Returns ``(cur, nxt)`` dicts, and the offsets
    ``int32[n]`` third with ``return_offsets``.  ``build`` (one of
    ``REPLAY_STACKED_BUILDS``) overrides :func:`replay_stacked_build`'s
    choice; ``"bulk"`` raises where the frames do not allow it.
    """
    if build is not None and build not in REPLAY_STACKED_BUILDS:
        raise ValueError(f"build must be one of {REPLAY_STACKED_BUILDS}, got {build!r}")
    capacity = next(iter(data.values())).shape[0]
    if not 1 <= k <= _MAX_STACK:
        raise NotImplementedError(f"replay_sample_stacked takes 1 <= k <= {_MAX_STACK}, got {k}")
    if batch <= 0 or capacity < (k + 1) * batch:
        raise ValueError(f"want 0 < batch and capacity >= (k+1)*batch, got batch {batch}, "
                         f"capacity {capacity}, k {k}")
    names = list(data)
    if obs_key not in names or done_key not in names:
        raise ValueError(f"fields {names} lack {obs_key!r} or {done_key!r}")
    done = data[done_key]
    _check_tensor(done, f"store {done_key}", torch.bool, (capacity,), done.device)
    out, fields, params, offsets, stream = _sample_setup(
        data, key, n, maxval, int(start) + (k - 1) * int(batch), batch, return_offsets,
        window=(obs_key, k))
    if n == 0:
        return out
    obs_store = data[obs_key]
    cur, nxt = out[0], out[1]
    row_bytes = obs_store[0].numel() * obs_store.element_size()
    fits = replay_stacked_build(row_bytes, k, obs_store, cur[obs_key], nxt[obs_key])
    if build == "bulk" and fits != "bulk":
        raise ValueError(f"replay_sample_stacked's bulk build needs frames of a multiple of 16 bytes "
                         f"on 16-byte boundaries, K + 1 of them in {_MAX_STAGE_BYTES} bytes; got "
                         f"{row_bytes} bytes, k {k}")
    build = fits if build is None else build
    stack = _StackParams(done.data_ptr(), names.index(obs_key), int(k), int(build == "bulk"))
    _check(_lib("replay").replay_sample_stacked_launch(fields, params, ctypes.byref(stack), offsets,
                                                       stream), "replay_sample_stacked")
    LAUNCHES["replay_sample_stacked"] += 1
    return out


# ---------------------------------------------------------------------------
# Frame stacking and the DQN's epsilon-greedy
# ---------------------------------------------------------------------------


def framestack_push(stack: torch.Tensor, obs: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """Launch ``framestack_push``: the window ``[B, K, ...]`` with ``obs``
    ``[B, ...]`` rolled in as its newest frame, or repeated K times where
    ``done`` (``bool[B]``).  The output is new; ``stack`` is left as it was."""
    device = stack.device
    if stack.ndim < 2:
        raise ValueError(f"stack: want [B, K, ...], got {tuple(stack.shape)}")
    B, k = stack.shape[:2]
    _check_tensor(stack, "stack", stack.dtype, stack.shape, device)
    _check_tensor(obs, "obs", stack.dtype, (B,) + tuple(stack.shape[2:]), device)
    _check_tensor(done, "done", torch.bool, (B,), device)
    out = torch.empty_like(stack)
    if out.numel() == 0:
        return out
    frame_bytes = obs[0].numel() * obs.element_size()
    word = _copy_word(frame_bytes, stack, obs, out)
    rc = _lib("framestack").framestack_push_launch(
        stack.data_ptr(), obs.data_ptr(), done.data_ptr(), out.data_ptr(), B, k, frame_bytes,
        word, _stream(device),
    )
    _check(rc, "framestack_push")
    LAUNCHES["framestack_push"] += 1
    return out


def dqn_act(q: torch.Tensor, act_key=None, eps_key=None, epsilon: float = 0.0,
            return_draws: bool = False, env_offset: int = 0):
    """Launch ``dqn_act``: epsilon-greedy actions ``int32[B]`` from ``q`` ``f32[B, A]``.

    With ``act_key`` and ``eps_key`` (host ``uint32[2]`` keys) an env takes
    ``randint(act_key, (B,), 0, A)`` where ``uniform(eps_key, (B,))`` is
    below ``epsilon`` (a float32 value), and the argmax of its row
    otherwise; without them the action is the argmax.  Both draws of row
    ``b`` are at counter ``env_offset + b``, the global env index; the
    kernel splits ``act_key`` itself, as ``randint`` does, so the host makes
    no draw.  With ``return_draws`` the randint draws ``int32[B]`` and the
    uniforms ``f32[B]`` come back too.  A build for A = 8 and one for any
    other A; a thread an env (:func:`dqn_act_shape`).
    """
    device = q.device
    if q.ndim != 2 or q.shape[1] < 1:
        raise ValueError(f"q: want [B, A] with A >= 1, got {tuple(q.shape)}")
    B, A = q.shape
    _check_tensor(q, "q", torch.float32, (B, A), device)
    explore = act_key is not None
    if explore != (eps_key is not None):
        raise ValueError("act_key and eps_key go together")
    if return_draws and not explore:
        raise ValueError("return_draws needs the random keys")
    _check_counters(env_offset, B, 1)
    ak = np.asarray(act_key if explore else (0, 0), dtype=np.uint32)
    ek = np.asarray(eps_key if explore else (0, 0), dtype=np.uint32)
    action = torch.empty((B,), dtype=torch.int32, device=device)
    random_a = torch.empty((B,), dtype=torch.int32, device=device) if return_draws else None
    eps_u = torch.empty((B,), dtype=torch.float32, device=device) if return_draws else None
    out = (action, random_a, eps_u) if return_draws else action
    if B == 0:
        return out
    params = _DqnActParams(A, int(ak[0]), int(ak[1]), int(ek[0]), int(ek[1]),
                           float(np.float32(epsilon)), int(env_offset))
    rc = _lib("dqn_act").dqn_act_launch(
        q.data_ptr(), action.data_ptr(), random_a.data_ptr() if return_draws else None,
        eps_u.data_ptr() if return_draws else None, B, int(explore), ctypes.byref(params),
        _stream(device),
    )
    _check(rc, "dqn_act")
    LAUNCHES["dqn_act"] += 1
    return out


def dqn_act_shape(B: int, A: int = 8) -> dict:
    """The shape of ``dqn_act``'s launch for a batch of B rows of A values:
    threads (envs) a block, 32 to 128 (128, or where B gives the card's SMs
    fewer each, as many whole warps as give every SM a block), blocks, and
    the build's action count (8, or 0 for the build that takes any A);
    needs a card."""
    vals = (ctypes.c_int * 3)()
    _check(_lib("dqn_act").dqn_act_shape(B, A, ctypes.addressof(vals)), "dqn_act_shape")
    return dict(zip(("threads_per_block", "blocks", "build_actions"), list(vals)))


# ---------------------------------------------------------------------------
# The flagship engine and its 84x84 frame
# ---------------------------------------------------------------------------

_FLAGSHIP_DTYPES = {
    "key": torch.uint32, "board": torch.int8, "has_swapped": torch.bool,
    "game_over": torch.bool, "score": torch.float32,
}
_DEVICE_TABLES: dict = {}


def _flagship_shapes(config: EngineConfig, n_pieces: int, B: int) -> dict:
    shapes = {k: (B,) for k in engine.FIELDS}
    shapes.update(
        key=(2, B), board=(B, config.padded_height, config.padded_width), bag=(B, n_pieces),
        queue=(B, config.queue_size), holder_piece=(B, config.holder_size),
        holder_rotation=(B, config.holder_size),
    )
    return shapes


def _check_flagship_state(state, config: EngineConfig, n_pieces: int, device, names) -> int:
    """Checks the fields ``names`` of a flagship state; returns B.  The board
    must start on a 16-byte boundary: the kernels move it in 16-byte words."""
    B = state.piece.shape[0]
    _check_fields(state, names, _flagship_shapes(config, n_pieces, B), _FLAGSHIP_DTYPES, device)
    if state.board.data_ptr() % 16:
        raise ValueError("state.board must start on a 16-byte boundary")
    return B


def _flagship_ptrs(state) -> _FlagshipPtrs:
    return _FlagshipPtrs(*(getattr(state, k).data_ptr() for k in engine.FIELDS))


def _empty_flagship_state(config: EngineConfig, n_pieces: int, B: int, device):
    return _empty(engine.EngineState, _flagship_shapes(config, n_pieces, B), _FLAGSHIP_DTYPES,
                  device)


def _ids_for(pieces: PieceSet, device) -> torch.Tensor:
    """The pieces' cell ids as int32 on ``device`` (cached)."""
    ck = ("ids", pieces.ids.tobytes(), str(device))
    hit = _DEVICE_TABLES.get(ck)
    if hit is None:
        hit = _DEVICE_TABLES[ck] = torch.as_tensor(pieces.ids.astype(np.int32), device=device)
    return hit


# Lanes an env of flagship_step's builds (csrc/flagship_step.cu:
# flagship_step_launch): a group of 8 or 16 lanes sharing an env's rows in
# bands, 16 envs a block.  On an H100 (PERF.md, each build's times at B =
# 512-65536 and at three geometries) 16 lanes are the fastest below
# FLAGSHIP_EIGHT_LANES_FROM_B envs; from there 8 lanes are where 16 lanes
# would hold more than one row each (padded height above 16: at 24, 2 rows
# on 12 of the 16 lanes against 3 rows on each of 8), and 16 stay where
# each of their lanes holds one row.
FLAGSHIP_LANES = (8, 16)
FLAGSHIP_EIGHT_LANES_FROM_B = 4096


def flagship_step_lanes(B: int, padded_height: int) -> int:
    """The lanes an env that ``flagship_step`` takes at batch ``B`` on a
    board of ``padded_height`` rows: 8 from ``FLAGSHIP_EIGHT_LANES_FROM_B``
    envs up where the padded height passes 16, else 16."""
    return 8 if B >= FLAGSHIP_EIGHT_LANES_FROM_B and padded_height > 16 else 16


def _sample_args(logits, act_key, env_offset: int, B: int, device):
    """The host side of a step's sampling build: the checked ``act_key`` as
    ``uint32[2]``, after the checks of the counters and of ``logits``."""
    if act_key is None:
        raise ValueError("logits need act_key")
    key = np.asarray(act_key, dtype=np.uint32)
    if key.shape != (2,):
        raise ValueError(f"act_key: want a uint32[2] key, got shape {key.shape}")
    _check_counters(env_offset, B, 8)
    _check_tensor(logits, "logits", torch.float32, (B, 8), device)
    return key


def flagship_step(state, action: torch.Tensor, config: EngineConfig, pieces: PieceSet,
                  rewards: RewardsMapping, lanes: int = None, logits: torch.Tensor = None,
                  act_key=None, env_offset: int = 0):
    """Launch ``flagship_step``: returns ``(new_state, reward f32[B], done bool[B], lines int32[B])``.

    The new state is in new buffers; ``state`` is left as it was.  With
    ``logits`` (``f32[B, 8]``) and ``act_key`` (the step's ``uint32[2]`` key
    on the host), the launch samples each env's action as
    :func:`sample_actions` does and steps with it: ``action`` is ignored
    (pass None) and ``(action int32[B], log_prob f32[B])`` are returned
    after ``lines``; ``env_offset`` is the global index of env 0 (a rank's
    first env), so env ``b`` draws at the global env's counters.  ``lanes``
    (one of ``FLAGSHIP_LANES``) overrides :func:`flagship_step_lanes`' choice.
    """
    if lanes is not None and lanes not in FLAGSHIP_LANES:
        raise ValueError(f"lanes must be one of {FLAGSHIP_LANES}, got {lanes}")
    device = state.board.device
    t, packed, box = turbo.tables_for(pieces, device)
    defines = engine_defines(config, t, flagship=True)
    B = state.piece.shape[0]
    sample = logits is not None
    if sample:
        key = _sample_args(logits, act_key, env_offset, B, device)
    elif act_key is not None:
        raise ValueError("act_key without logits")
    elif env_offset:
        raise ValueError("env_offset without logits")
    _check_flagship_state(state, config, t.n_pieces, device, engine.FIELDS)
    if sample:
        action = torch.empty((B,), dtype=torch.int32, device=device)
        log_prob = torch.empty((B,), dtype=torch.float32, device=device)
    elif not action.is_cuda or action.dtype != torch.int32 or tuple(action.shape) != (B,) \
            or not action.is_contiguous() or action.device != device:
        raise ValueError(f"action: want a contiguous int32[{B}] tensor on {device}")
    out = _empty_flagship_state(config, t.n_pieces, B, device)
    reward = torch.empty((B,), dtype=torch.float32, device=device)
    done = torch.empty((B,), dtype=torch.bool, device=device)
    lines = torch.empty((B,), dtype=torch.int32, device=device)
    result = (out, reward, done, lines) + ((action, log_prob) if sample else ())
    if B == 0:
        return result
    params = _FlagshipParams(
        int(config.gravity_enabled), int(config.auto_reset), int(config.queue_kind == "uniform"),
        float(np.float32(rewards.alife)), float(np.float32(rewards.game_over)),
    )
    in_p, out_p = _flagship_ptrs(state), _flagship_ptrs(out)
    smp = _SampleArgs(logits.data_ptr(), action.data_ptr(), log_prob.data_ptr(), int(key[0]),
                      int(key[1]), int(env_offset)) if sample else None
    rc = _lib("flagship_step", defines).flagship_step_launch(
        ctypes.byref(in_p), ctypes.byref(out_p), action.data_ptr(), reward.data_ptr(),
        done.data_ptr(), lines.data_ptr(), packed.data_ptr(), box.data_ptr(),
        _ids_for(pieces, device).data_ptr(), B,
        flagship_step_lanes(B, config.padded_height) if lanes is None else lanes,
        ctypes.byref(params), None if smp is None else ctypes.byref(smp), _stream(device),
    )
    _check(rc, "flagship_step")
    LAUNCHES["flagship_step"] += 1
    if sample:
        LAUNCHES["flagship_step_sample"] += 1
    return result


def flagship_init(keys: torch.Tensor, config: EngineConfig, pieces: PieceSet):
    """Launch ``flagship_init``: fresh episodes from per-env keys ``uint32[B, 2]``.

    The kernel reads an env's key as one 8-byte word (a copy is made of keys
    that do not start on an 8-byte boundary) and writes the new board, which
    ``torch.empty`` starts on a 16-byte boundary, in 16-byte words."""
    device = keys.device
    t, _, box = turbo.tables_for(pieces, device)
    defines = engine_defines(config, t, flagship=True)
    if not keys.is_cuda or keys.dtype != torch.uint32 or keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys: want a CUDA uint32[B, 2] tensor, got {keys.dtype} {tuple(keys.shape)}")
    keys = keys.contiguous()
    if keys.data_ptr() % 8:
        keys = keys.clone()
    B = keys.shape[0]
    out = _empty_flagship_state(config, t.n_pieces, B, device)
    if B == 0:
        return out
    out_p = _flagship_ptrs(out)
    rc = _lib("flagship_step", defines).flagship_init_launch(
        keys.data_ptr(), ctypes.byref(out_p), box.data_ptr(), B,
        int(config.queue_kind == "uniform"), _stream(device),
    )
    _check(rc, "flagship_init")
    LAUNCHES["flagship_init"] += 1
    return out


def flagship_observe_board(state, config: EngineConfig, pieces: PieceSet) -> torch.Tensor:
    """Launch ``flagship_observe_board``: ``int8[B, height, width]``, the
    occupancy with the active piece added as -1 unless the game is over;
    envs a warp and warps a block from B
    (:func:`flagship_observe_board_shape`)."""
    device = state.board.device
    t, packed, _ = turbo.tables_for(pieces, device)
    defines = engine_defines(config, t, flagship=True)
    B = _check_flagship_state(state, config, t.n_pieces, device,
                              ("board", "piece", "rotation", "x", "y", "game_over"))
    out = torch.empty((B, config.height, config.width), dtype=torch.int8, device=device)
    if B == 0:
        return out
    rc = _lib("flagship_step", defines).flagship_observe_board_launch(
        state.board.data_ptr(), state.piece.data_ptr(), state.rotation.data_ptr(),
        state.x.data_ptr(), state.y.data_ptr(), state.game_over.data_ptr(), packed.data_ptr(),
        out.data_ptr(), B, _stream(device),
    )
    _check(rc, "flagship_observe_board")
    LAUNCHES["flagship_observe_board"] += 1
    return out


def _shape_of(source: str, fn: str, keys: tuple, config: EngineConfig, pieces: PieceSet,
              B: int, flagship: bool = True) -> dict:
    """``{keys[i]: out[i]}`` of the C function ``fn(B, out)`` of ``source``'s build at ``config``."""
    defines = engine_defines(config, turbo.tables_for(pieces, "cpu")[0], flagship=flagship)
    vals = (ctypes.c_int * len(keys))()
    _check(getattr(_lib(source, defines), fn)(B, ctypes.addressof(vals)), fn)
    return dict(zip(keys, list(vals)))


def turbo_init_shape(config: EngineConfig, pieces: PieceSet, B: int) -> dict:
    """The shape of ``turbo_init``'s launch for a batch of B at ``config``:
    envs a block (128, or where B gives the card's SMs fewer each, as many
    as give every SM a block, rounded up to whole warps) and threads a
    block, the warps past the envs' streaming the rows; needs a card."""
    return _shape_of("turbo_step", "turbo_init_shape", ("envs_per_block", "threads_per_block"),
                     config, pieces, B, flagship=False)


def flagship_init_shape(config: EngineConfig, pieces: PieceSet, B: int) -> dict:
    """The shape of ``flagship_init``'s launch for a batch of B at
    ``config``: envs a block (256, or where B gives the card's SMs fewer
    each, as many as give every SM a block), threads a block, bytes of a
    board word; needs a card."""
    return _shape_of("flagship_step", "flagship_init_shape",
                     ("envs_per_block", "threads_per_block", "word_bytes"), config, pieces, B)


def flagship_observe_board_shape(config: EngineConfig, pieces: PieceSet, B: int) -> dict:
    """The shape of ``flagship_observe_board``'s launch for a batch of B at
    ``config``: envs a warp (one while B gives the card's SMs at most 16
    warps each, else 1-4, the count whose playfield words fill the warp's
    rounds best), warps a block (8, or where the batch's warps give the
    card's SMs fewer each, as many as give every SM a block), words of an
    env's playfield rows, bytes of a word, words a lane; needs a card."""
    return _shape_of("flagship_step", "flagship_observe_board_shape",
                     ("envs_per_warp", "warps_per_block", "words_per_env", "word_bytes",
                      "words_per_lane"), config, pieces, B)


RGB84 = 84  # csrc/render_rgb84.cu:OUT


def pack_taps(src: np.ndarray, coef: np.ndarray) -> np.ndarray:
    """The 84 taps of :func:`ops.image.area_zoom_taps` packed one word an
    output, as ``csrc/render_rgb84.cu`` reads them: ``s | c0 << 8 | c1 <<
    20``, source ``s`` with coefficient ``c0`` and ``s + 1`` with ``c1`` (0
    where the output has one tap), as int32 bits.  An enlargement's outputs
    take two adjacent sources at most, and the next output's first source
    is the same or the next one (the kernel's vertical pass relies on it)."""
    src, coef = np.asarray(src, np.int64), np.asarray(coef, np.int64)
    two = coef[:, 1] != 0
    step = np.diff(src[:, 0])
    if (two & (src[:, 1] != src[:, 0] + 1)).any() or (coef < 0).any() or (coef >= 1 << 12).any() \
            or (src < 0).any() or (src[:, 0] >= 1 << 8).any() or (step < 0).any() or (step > 1).any():
        raise AssertionError("an area zoom's taps are two adjacent sources with 11-bit coefficients, "
                             "each output's first source the last one's or the next")
    return (src[:, 0] | coef[:, 0] << 8 | coef[:, 1] << 20).astype(np.uint32).view(np.int32)


def _render_table(config: EngineConfig, pieces: PieceSet, device) -> torch.Tensor:
    """The int32 table ``render_rgb84`` reads (cached): the 84 packed taps
    (:func:`pack_taps`) of the output rows over the id image's height and of
    the output columns over its width, the palette and the gray weights, in
    the order of ``csrc/render_rgb84.cu:T_*``.  The id image is the
    composite's: the padded board and a sidebar of ``S * max(queue, holder)``
    columns, ``S`` the pieces' side (``engine.render_rgb`` composites the
    strips as they are).  Raises JAX's ``ValueError`` where the image is
    larger than 84 on a side, and its ``TypeError`` where it is lower than
    the sidebar's two strips."""
    from tetris_gymnasium_torch.ops import image

    S = int(pieces.matrices.shape[-1])
    if config.padded_height < 2 * S:
        raise TypeError(f"render_rgb84: a board of {config.padded_height} rows is lower than the "
                        f"sidebar's two {S}-row strips (JAX's composite fails there too)")
    ck = ("render", config.padded_height, config.padded_width, S, config.queue_size,
          config.holder_size, pieces.palette.tobytes(), str(device))
    hit = _DEVICE_TABLES.get(ck)
    if hit is None:
        img_w = config.padded_width + S * max(config.queue_size, config.holder_size)
        rows = pack_taps(*image.area_zoom_taps(config.padded_height, RGB84))
        cols = pack_taps(*image.area_zoom_taps(img_w, RGB84))
        parts = [rows, cols, pieces.palette.astype(np.int32), np.asarray(image._W22)]
        flat = np.concatenate([np.asarray(x, dtype=np.int32).ravel() for x in parts])
        hit = _DEVICE_TABLES[ck] = torch.as_tensor(flat, device=device)
    return hit


def render_rgb84(state, config: EngineConfig, pieces: PieceSet) -> torch.Tensor:
    """Launch ``render_rgb84``: the 84x84 gray frames ``uint8[B, 84, 84]`` of
    ``preprocess_rgb84(render_rgb(state))``, at any geometry within
    :func:`engine_defines`' flagship limits whose composite is at most 84
    pixels on a side (``ValueError`` past it, as JAX's resize raises)."""
    device = state.board.device
    t, packed, _ = turbo.tables_for(pieces, device)
    table = _render_table(config, pieces, device)
    defines = engine_defines(config, t, flagship=True)
    if pieces.palette.shape != (t.n_pieces + 2, 3):
        raise NotImplementedError(f"render_rgb84 is built for a {t.n_pieces + 2}-entry palette")
    B = _check_flagship_state(state, config, t.n_pieces, device, _RENDER_FIELDS)
    out = torch.empty((B, RGB84, RGB84), dtype=torch.uint8, device=device)
    if B == 0:
        return out
    ptrs = _RenderPtrs(*(getattr(state, k).data_ptr() for k in _RENDER_FIELDS))
    rc = _lib("render_rgb84", defines).render_rgb84_launch(
        ctypes.byref(ptrs), packed.data_ptr(), _ids_for(pieces, device).data_ptr(),
        table.data_ptr(), out.data_ptr(), B, _stream(device),
    )
    _check(rc, "render_rgb84")
    LAUNCHES["render_rgb84"] += 1
    return out


# ---------------------------------------------------------------------------
# The Gymnasium surface: grouped placements, features, the Dict obs, the composite
# ---------------------------------------------------------------------------

_GROUPED_FLAGSHIP_MODES = {"features": 0, "boards": 1, "ids": 2}
_FEATURE_BITS = (1, 2, 4, 8)  # csrc/features.cuh: kHeight, kMaxHeight, kHoles, kBumpiness


def _feature_bits(flags) -> int:
    return sum(bit for bit, on in zip(_FEATURE_BITS, flags) if on)


def grouped_flagship(state, config: EngineConfig, pieces: PieceSet, mode: str = "boards",
                     flags=None):
    """Launch ``grouped_flagship``: every placement of every env's active
    piece, ``(obs, mask f32[B, A], game_over bool[B, A], lines int32[B, A])``
    with ``obs`` ``f32[B, A, n]`` (``features``, under ``flags``, default
    all), ``f32[B, A, H_pad, W_pad]`` (``boards``) or ``int8[B, A, H_pad,
    W_pad]`` (``ids``), ``A = width * 4``.  Built for each geometry within
    :func:`engine_defines`' flagship limits."""
    from tetris_gymnasium_torch.ops.observations import FeatureFlags, n_features

    if mode not in _GROUPED_FLAGSHIP_MODES:
        raise ValueError(f"unknown grouped_flagship mode: {mode}")
    flags = FeatureFlags() if flags is None else flags
    device = state.board.device
    t, packed, box = turbo.tables_for(pieces, device)
    defines = engine_defines(config, t, flagship=True)
    B = _check_flagship_state(state, config, t.n_pieces, device, ("board", "piece", "rotation"))
    A = config.width * 4
    board_shape = (B, A, config.padded_height, config.padded_width)
    if mode == "features":
        obs = torch.empty((B, A, n_features(config.width, flags)), dtype=torch.float32, device=device)
    else:
        obs = torch.empty(board_shape, dtype=torch.float32 if mode == "boards" else torch.int8,
                          device=device)
    mask = torch.empty((B, A), dtype=torch.float32, device=device)
    game_over = torch.empty((B, A), dtype=torch.bool, device=device)
    lines = torch.empty((B, A), dtype=torch.int32, device=device)
    if B == 0:
        return obs, mask, game_over, lines
    rc = _lib("grouped_flagship", defines).grouped_flagship_launch(
        state.board.data_ptr(), state.piece.data_ptr(), state.rotation.data_ptr(), packed.data_ptr(),
        box.data_ptr(), _ids_for(pieces, device).data_ptr(), obs.data_ptr(), mask.data_ptr(),
        game_over.data_ptr(), lines.data_ptr(), B, _GROUPED_FLAGSHIP_MODES[mode],
        _feature_bits(flags), _stream(device),
    )
    _check(rc, "grouped_flagship")
    LAUNCHES["grouped_flagship"] += 1
    return obs, mask, game_over, lines


def grouped_flagship_occupancy(config: EngineConfig, pieces: PieceSet) -> dict:
    """The shape of ``grouped_flagship``'s build at ``config``: envs and
    threads a block, static shared memory, candidates a boards chunk,
    whether the features are staged, and for the features mode (all flags)
    and the boards mode the dynamic shared memory and the blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs a card."""
    defines = engine_defines(config, turbo.tables_for(pieces, "cpu")[0], flagship=True)
    vals = (ctypes.c_int * 9)()
    _check(_lib("grouped_flagship", defines).grouped_flagship_occupancy(ctypes.addressof(vals)),
           "grouped_flagship_occupancy")
    keys = ("envs_per_block", "threads_per_block", "static_smem_bytes", "chunk_candidates",
            "features_staged", "features_dynamic_smem_bytes", "features_blocks_per_sm",
            "boards_dynamic_smem_bytes", "boards_blocks_per_sm")
    return dict(zip(keys, list(vals)))


def _feature_words(playfield: torch.Tensor) -> bool:
    """Whether every 16-byte word that holds a byte of the crop's rows lies
    inside the tensor's storage, so that ``feature_vector`` may load whole
    aligned words and crop them in registers (its words build)."""
    storage = playfield.untyped_storage()
    lo, hi = storage.data_ptr(), storage.data_ptr() + storage.nbytes()
    first = playfield.data_ptr()
    last = first + sum((n - 1) * st for n, st in zip(playfield.shape, playfield.stride())) + 1
    return first // 16 * 16 >= lo and -(-last // 16) * 16 <= hi


def feature_vector(playfield: torch.Tensor, flags) -> torch.Tensor:
    """Launch ``feature_vector``: ``int32[B, n]`` features of an ``int8[B,
    height, width]`` playfield, read in place at any batch and row stride
    (the crop ``board[:, :-pad, pad:-pad]`` of a padded board is a view).
    Built for each crop shape (:func:`feature_defines`: at most 64 rows and
    128 columns); a warp an env, envs a block and blocks from B
    (:func:`feature_vector_shape`).  Its rows are loaded as the aligned
    16-byte words that hold them where those lie inside the tensor's
    storage (:func:`_feature_words`), else byte by byte."""
    from tetris_gymnasium_torch.ops.observations import n_features

    if playfield.ndim != 3:
        raise ValueError(f"playfield: want [B, height, width], got {tuple(playfield.shape)}")
    defines = feature_defines(*playfield.shape[1:])
    device = playfield.device
    if not playfield.is_cuda or playfield.dtype != torch.int8 or playfield.stride(2) != 1:
        raise ValueError(f"playfield: want a CUDA int8 tensor with unit column stride, got "
                         f"{playfield.dtype} on {device}, strides {playfield.stride()}")
    B = playfield.shape[0]
    n = n_features(playfield.shape[2], flags)
    out = torch.empty((B, n), dtype=torch.int32, device=device)
    if B == 0 or n == 0:
        return out
    inside = _feature_words(playfield)
    words = _FORCE.get("feature_vector")
    words = inside if words is None else words
    if words and not inside:
        raise ValueError("feature_vector: the words build would read past the tensor's storage")
    rc = _lib("features", defines).feature_vector_launch(
        playfield.data_ptr(), playfield.stride(0), playfield.stride(1), B, _feature_bits(flags),
        int(words), out.data_ptr(), _stream(device),
    )
    _check(rc, "feature_vector")
    LAUNCHES["feature_vector"] += 1
    _count_batch("feature_vector", B)
    return out


def feature_vector_shape(height: int, width: int, B: int) -> dict:
    """The shape of ``feature_vector``'s launch for a batch of B at a
    ``height`` x ``width`` crop: envs (warps) a block, ``min(8, ceil(B /
    SMs))``, blocks (every env's, at most 8 an SM: past that the warps
    stride over the batch), the 16-byte words a row loads at most in the
    words build and the rows a lane; needs a card."""
    vals = (ctypes.c_int * 4)()
    _check(_lib("features", feature_defines(height, width)).feature_vector_shape(
        B, ctypes.addressof(vals)), "feature_vector_shape")
    return dict(zip(("envs_per_block", "blocks", "words_per_row", "rows_per_lane"), list(vals)))


def observe_dict(state, config: EngineConfig, pieces: PieceSet, strips_only: bool = False) -> dict:
    """Launch ``observe_dict``: the Dict observation, ``board`` and
    ``active_tetromino_mask`` ``uint8[B, H_pad, W_pad]``, ``holder``
    ``uint8[B, S, S * holder_size]``, ``queue`` ``uint8[B, S, S *
    queue_size]`` (``S`` the pieces' side); with ``strips_only`` the holder
    and queue strips alone (``engine.queue_holder_strips``).  Built for each
    geometry within :func:`engine_defines`' flagship limits; a warp an env,
    envs a block from B (:func:`observe_dict_shape`)."""
    device = state.board.device
    t, packed, box = turbo.tables_for(pieces, device)
    defines = engine_defines(config, t, flagship=True)
    B = _check_flagship_state(state, config, t.n_pieces, device, _RENDER_FIELDS)
    hw = (B, config.padded_height, config.padded_width)
    S = t.size
    out = {} if strips_only else {
        "board": torch.empty(hw, dtype=torch.uint8, device=device),
        "active_tetromino_mask": torch.empty(hw, dtype=torch.uint8, device=device),
    }
    out["holder"] = torch.empty((B, S, S * config.holder_size), dtype=torch.uint8, device=device)
    out["queue"] = torch.empty((B, S, S * config.queue_size), dtype=torch.uint8, device=device)
    if B == 0:
        return out
    ptrs = _RenderPtrs(*(getattr(state, k).data_ptr() for k in _RENDER_FIELDS))
    rc = _lib("observe_dict", defines).observe_dict_launch(
        ctypes.byref(ptrs), packed.data_ptr(), box.data_ptr(), _ids_for(pieces, device).data_ptr(),
        None if strips_only else out["board"].data_ptr(),
        None if strips_only else out["active_tetromino_mask"].data_ptr(), out["holder"].data_ptr(),
        out["queue"].data_ptr(), B, _stream(device),
    )
    _check(rc, "observe_dict")
    LAUNCHES["observe_dict"] += 1
    return out


def observe_dict_shape(config: EngineConfig, pieces: PieceSet, B: int) -> dict:
    """The shape of ``observe_dict``'s launch for a batch of B at ``config``:
    envs (warps) a block, ``min(8, ceil(B / SMs))``, bytes of a board word
    (the widest of 16, 8, 4, 2 and 1 that the padded board is a whole
    number of) and board words a lane; needs a card."""
    return _shape_of("observe_dict", "observe_dict_shape", ("envs_per_block", "word_bytes", "words_per_lane"),
                     config, pieces, B)


_PALETTES: dict = {}


def group_divider(group: int) -> tuple:
    """``(magic, shift)`` with ``n // group == (n * magic >> 32) >> shift``
    for every ``0 <= n < 2**31`` (``magic = ceil(2**(31 + s) / group)``,
    ``s = ceil(log2 group)``, ``shift = s - 1``); ``(0, -1)`` for group 1."""
    if group == 1:
        return 0, -1
    s = (group - 1).bit_length()
    return -(-(1 << (31 + s)) // group), s - 1


def _compose_palette(pieces: PieceSet, group: int) -> _ComposePalette:
    """``compose_rgb``'s palette parameter: colour i as ``r | g << 8 | b
    << 16``, and :func:`group_divider`'s multiplier."""
    pal = np.asarray(pieces.palette, np.uint32)
    key = (pal.tobytes(), group)
    hit = _PALETTES.get(key)
    if hit is None:
        if pal.shape[0] > _MAX_PALETTE:
            raise NotImplementedError(f"compose_rgb: {pal.shape[0]} palette colours > {_MAX_PALETTE}")
        hit = _PALETTES[key] = _ComposePalette()
        for i, (r, g, b) in enumerate(pal):
            hit.rgb[i] = int(r) | int(g) << 8 | int(b) << 16
        hit.group_magic, hit.group_shift = group_divider(group)
    return hit


def compose_rgb(board: torch.Tensor, queue_strip: torch.Tensor, holder_strip: torch.Tensor,
                pieces: PieceSet, group: int = 1) -> torch.Tensor:
    """Launch ``compose_rgb``: ``uint8[N, H, W + S * max(QS, HS), 3]``
    composites of the id boards ``uint8[N, H, W]`` with the strips
    ``uint8[M, S, S * QS]`` and ``uint8[M, S, S * HS]`` of board ``n``'s env
    ``n // group`` (``N = M * group``).  The build follows the shapes and
    the palette (:func:`compose_defines`); a lane a run of 16 pixels, 1 for
    a batch too small to fill the card, the palette a launch parameter
    (:func:`compose_rgb_shape`)."""
    device = board.device
    if board.ndim != 3 or queue_strip.ndim != 3 or holder_strip.ndim != 3:
        raise ValueError(f"compose_rgb: want [N, H, W] boards and [M, S, S * n] strips, got "
                         f"{tuple(board.shape)}, {tuple(queue_strip.shape)}, {tuple(holder_strip.shape)}")
    defines = compose_defines(board.shape, queue_strip.shape, holder_strip.shape,
                              pieces.palette.shape[0])
    N = board.shape[0]
    if group < 1 or N % group:
        raise ValueError(f"{N} boards do not split into groups of {group}")
    M = N // group
    _check_tensor(board, "board", torch.uint8, board.shape, device)
    _check_tensor(queue_strip, "queue_strip", torch.uint8, (M,) + tuple(queue_strip.shape[1:]), device)
    _check_tensor(holder_strip, "holder_strip", torch.uint8, (M,) + tuple(holder_strip.shape[1:]),
                  device)
    side = max(queue_strip.shape[2], holder_strip.shape[2])
    H, IW = board.shape[1], board.shape[2] + side
    if N * H * IW >= 2 ** 31:
        raise NotImplementedError(f"compose_rgb: {N} images of {H * IW} pixels pass the kernel's "
                                  "32-bit count of runs")
    out = torch.empty((N, H, IW, 3), dtype=torch.uint8, device=device)
    if N == 0:
        return out
    run = {None: 0, 16: 16, 1: 1}[_FORCE.get("compose_rgb")]  # 0: the launch picks
    rc = _lib("observe_dict", defines).compose_rgb_launch(
        board.data_ptr(), queue_strip.data_ptr(), holder_strip.data_ptr(),
        ctypes.byref(_compose_palette(pieces, int(group))), N, run, out.data_ptr(), _stream(device),
    )
    _check(rc, "compose_rgb")
    LAUNCHES["compose_rgb"] += 1
    _count_batch("compose_rgb", N)
    return out


def compose_rgb_shape(config: EngineConfig, pieces: PieceSet, N: int) -> dict:
    """The shape of ``compose_rgb``'s launch for N images at ``config``:
    pixels a run (16, or 1 where 16-pixel runs would give the SMs fewer
    than 256 lanes each), warps a block (8, fewer only where the runs fill
    fewer), bytes of a store word (the widest of 16, 8, 4, 2 and 1 that an image's bytes and a run's
    are a whole number of), runs an image and the pixels of its last run;
    needs a card."""
    return _shape_of("observe_dict", "compose_rgb_shape",
                     ("run_pixels", "warps_per_block", "store_bytes", "runs_per_image", "tail_pixels"),
                     config, pieces, N)


# ---------------------------------------------------------------------------
# The compat functional engine and the exact grayscale
# ---------------------------------------------------------------------------

MAX_FN_BOARD_CELLS = 3056  # csrc/fn_env.cu: 16 boards and their windows in 48 KB of shared memory
MAX_FN_PADDED_SIDE = 64  # csrc/fn_env.cu: fn_step's bit rows and maps of window starts are 64-bit words
MAX_FN_QUEUE = 32  # csrc/fn_env.cu: the queue lives in registers
_FN_DTYPES = {"rng_key": torch.uint32, "board": torch.int8, "game_over": torch.bool,
              "score": torch.float32}


def fn_defines(config: EnvConfig, pieces: PieceSet) -> tuple:
    """The ``TETRIS_*`` defines that build ``csrc/fn_env.cu`` for ``config``
    and ``pieces``, or ``NotImplementedError`` naming the static limit
    passed: a padding of at least 1 (JAX's crop of padding 0 is empty), a
    padded board of at most 3056 cells (16 boards of a block in 48 KB of
    shared memory) and at most 64 rows and 64 columns (``fn_step``'s bit
    rows are 64-bit words), a piece box side of at most 8 inside the padded board
    (a matrix is one 64-bit mask), binary piece matrices, and a queue of 1
    to 32 that is no longer than the piece set (the bag draws ``arange(
    queue_size)`` as piece indices)."""
    mats = np.asarray(pieces.matrices)
    n, S = int(mats.shape[0]), int(mats.shape[-1])
    H, PW, qs = config.padded_height, config.padded_width, config.queue_size
    for ok, why in (
        (config.padding >= 1 and config.height >= 1 and config.width >= 1,
         f"padding {config.padding}, {config.height}x{config.width}: a padding of at least 1 and a "
         "non-empty playfield are built (JAX's crop of padding 0 is empty)"),
        (H * PW <= MAX_FN_BOARD_CELLS, f"padded board of {H * PW} cells > {MAX_FN_BOARD_CELLS}: a "
                                       "block keeps 16 boards in 48 KB of shared memory"),
        (max(H, PW) <= MAX_FN_PADDED_SIDE, f"padded board {H}x{PW}: at most {MAX_FN_PADDED_SIDE} "
                                           "rows and columns (fn_step's bit rows are 64-bit words)"),
        (S <= 8 and S <= min(H, PW), f"piece box side {S}: at most 8 (a 64-bit mask) and inside the "
                                     f"padded board {H}x{PW}"),
        (bool(np.isin(mats, (0, 1)).all()), "piece matrices must be binary"),
        (1 <= qs <= min(MAX_FN_QUEUE, n), f"queue size {qs}: 1 to {MAX_FN_QUEUE} and at most the "
                                          f"{n} pieces are built"),
    ):
        if not ok:
            raise NotImplementedError(f"the fn_env kernels: {why} (pass device='cpu' for the plain versions)")
    return (("TETRIS_HEIGHT", config.height), ("TETRIS_WIDTH", config.width),
            ("TETRIS_PAD", config.padding), ("TETRIS_QS", qs), ("TETRIS_NP", n), ("TETRIS_S", S))


def _fn_masks(pieces: PieceSet, device) -> torch.Tensor:
    """The piece matrices as 64-bit masks ``[n * 4]`` (bit ``i * S + j``) on
    ``device``, cached; int64 with the bits of csrc/fn_env.cu's uint64."""
    ck = ("fn_masks", pieces.matrices.tobytes(), pieces.matrices.shape, str(device))
    hit = _DEVICE_TABLES.get(ck)
    if hit is None:
        mats = np.asarray(pieces.matrices) > 0
        n, S = mats.shape[0], mats.shape[-1]
        weights = np.uint64(1) << np.arange(S * S, dtype=np.uint64)
        masks = (mats.reshape(n * 4, S * S).astype(np.uint64) * weights).sum(axis=1, dtype=np.uint64)
        hit = _DEVICE_TABLES[ck] = torch.as_tensor(masks.view(np.int64), device=device)
    return hit


def _fn_shapes(config: EnvConfig, B: int) -> dict:
    shapes = {k: (B,) for k in fn_env.FIELDS}
    shapes.update(rng_key=(B, 2), board=(B, config.padded_height, config.padded_width),
                  queue=(B, config.queue_size))
    return shapes


def _fn_ptrs(state) -> _FnPtrs:
    return _FnPtrs(*(getattr(state, k).data_ptr() for k in fn_env.FIELDS))


def _queue_uniform(queue_kind: str) -> int:
    if queue_kind not in ("bag", "uniform"):
        raise ValueError(f"queue_kind {queue_kind!r}: the fn_env kernels draw 'bag' or 'uniform'")
    return int(queue_kind == "uniform")


# The builds of fn_step: the block's boards staged by bulk asynchronous
# copies (cp.async.bulk) where a board's bytes are a multiple of 16 and both
# board tensors start on 16 bytes, else by the block's 16-byte or byte words.
FN_STEP_BUILDS = ("bulk", "words")


def fn_step_build(config: EnvConfig, *boards: torch.Tensor) -> str:
    """The build of ``fn_step`` that the wrapper takes for ``config`` and its
    input and output boards: ``"bulk"`` where a padded board's bytes are a
    multiple of 16 (so every block's span is) and every board starts on 16
    bytes, else ``"words"``."""
    cells = config.padded_height * config.padded_width
    if cells % 16 == 0 and all(b.data_ptr() % 16 == 0 for b in boards):
        return "bulk"
    return "words"


def fn_step_occupancy(config: EnvConfig, pieces: PieceSet, build: str = "bulk") -> dict:
    """Blocks an SM holds of ``fn_step``'s ``build`` at ``config``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), with its envs and
    threads a block and dynamic shared memory; needs a card."""
    if build not in FN_STEP_BUILDS:
        raise ValueError(f"build must be one of {FN_STEP_BUILDS}, got {build!r}")
    vals = [ctypes.c_int() for _ in range(4)]
    rc = _lib("fn_env", fn_defines(config, pieces)).fn_step_occupancy(
        int(build == "bulk"), *(ctypes.addressof(v) for v in vals))
    _check(rc, "fn_step_occupancy")
    blocks, envs, threads, smem = (v.value for v in vals)
    return {"build": build, "blocks_per_sm": blocks, "envs_per_block": envs,
            "threads_per_block": threads, "dynamic_smem_bytes": smem,
            "threads_per_sm": blocks * threads}


def fn_step(state, action: torch.Tensor, config: EnvConfig, pieces: PieceSet, queue_kind: str = "bag",
            build: str = None):
    """Launch ``fn_step``: ``(new_state, obs int8[B, height, width], reward
    f32[B], terminated bool[B], lines int32[B])`` of one compat step; the new
    state is in new buffers, ``state`` is left as it was.  ``build`` (one of
    ``FN_STEP_BUILDS``) overrides :func:`fn_step_build`'s choice; ``"bulk"``
    raises where the boards do not allow it."""
    if build is not None and build not in FN_STEP_BUILDS:
        raise ValueError(f"build must be one of {FN_STEP_BUILDS}, got {build!r}")
    device = state.board.device
    defines = fn_defines(config, pieces)
    uniform = _queue_uniform(queue_kind)
    B = state.piece.shape[0]
    _check_fields(state, fn_env.FIELDS, _fn_shapes(config, B), _FN_DTYPES, device)
    _check_tensor(action, "action", torch.int32, (B,), device)
    out = _empty(fn_env.FnState, _fn_shapes(config, B), _FN_DTYPES, device)
    obs = torch.empty((B, config.height, config.width), dtype=torch.int8, device=device)
    reward = torch.empty((B,), dtype=torch.float32, device=device)
    terminated = torch.empty((B,), dtype=torch.bool, device=device)
    lines = torch.empty((B,), dtype=torch.int32, device=device)
    if B == 0:
        return out, obs, reward, terminated, lines
    fits = fn_step_build(config, state.board, out.board)
    if build == "bulk" and fits != "bulk":
        raise ValueError(f"fn_step's bulk build needs boards of a multiple of 16 bytes on 16-byte "
                         f"boundaries, got {config.padded_height}x{config.padded_width}")
    build = fits if build is None else build
    params = _FnParams(int(config.gravity_enabled), uniform, int(build == "bulk"))
    in_p, out_p = _fn_ptrs(state), _fn_ptrs(out)
    rc = _lib("fn_env", defines).fn_step_launch(
        ctypes.byref(in_p), ctypes.byref(out_p), action.data_ptr(), obs.data_ptr(),
        reward.data_ptr(), terminated.data_ptr(), lines.data_ptr(),
        _fn_masks(pieces, device).data_ptr(), _ids_for(pieces, device).data_ptr(), B,
        ctypes.byref(params), _stream(device),
    )
    _check(rc, "fn_step")
    LAUNCHES["fn_step"] += 1
    return out, obs, reward, terminated, lines


def fn_reset(keys: torch.Tensor, config: EnvConfig, pieces: PieceSet, queue_kind: str = "bag"):
    """Launch ``fn_reset``: ``(keys uint32[B, 2], state, obs int8[B, height,
    width])``, fresh episodes from per-env keys ``uint32[B, 2]``.  The board
    and the observation go out as streams of 16-byte words beside one short
    RNG chain an env (:func:`fn_reset_shape`)."""
    device = keys.device
    defines = fn_defines(config, pieces)
    uniform = _queue_uniform(queue_kind)
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys: want [B, 2], got {tuple(keys.shape)}")
    keys = keys.contiguous()
    B = keys.shape[0]
    _check_tensor(keys, "keys", torch.uint32, (B, 2), device)
    if keys.data_ptr() % 8:
        keys = keys.clone()
    keys_out = torch.empty_like(keys)
    out = _empty(fn_env.FnState, _fn_shapes(config, B), _FN_DTYPES, device)
    obs = torch.empty((B, config.height, config.width), dtype=torch.int8, device=device)
    if B == 0:
        return keys_out, out, obs
    out_p = _fn_ptrs(out)
    rc = _lib("fn_env", defines).fn_reset_launch(
        keys.data_ptr(), keys_out.data_ptr(), ctypes.byref(out_p), obs.data_ptr(),
        _fn_masks(pieces, device).data_ptr(), B, uniform, _stream(device),
    )
    _check(rc, "fn_reset")
    LAUNCHES["fn_reset"] += 1
    return keys_out, out, obs


def fn_reset_shape(config: EnvConfig, pieces: PieceSet, B: int) -> dict:
    """The shape of ``fn_reset``'s launch for a batch of B at ``config``:
    envs a block (``min(E, ceil(B / SMs))``, E the largest power of two up
    to 128 whose boards and observations take at most 128 KB, 64 at 30x20,
    rounded up to ``env_align``, the envs whose boards and observations are
    whole 16-byte words), threads and blocks; needs a card."""
    vals = (ctypes.c_int * 4)()
    _check(_lib("fn_env", fn_defines(config, pieces)).fn_reset_shape(B, ctypes.addressof(vals)),
           "fn_reset_shape")
    return dict(zip(("envs_per_block", "threads_per_block", "blocks", "env_align"), list(vals)))


def fn_observe(state, config: EnvConfig, pieces: PieceSet) -> torch.Tensor:
    """Launch ``fn_observe``: ``int8[B, height, width]``, the occupancy with
    the active piece added as -1 unless the game is over."""
    device = state.board.device
    defines = fn_defines(config, pieces)
    B = state.piece.shape[0]
    _check_fields(state, ("board", "piece", "rotation", "x", "y", "game_over"),
                  _fn_shapes(config, B), _FN_DTYPES, device)
    obs = torch.empty((B, config.height, config.width), dtype=torch.int8, device=device)
    if B == 0:
        return obs
    rc = _lib("fn_env", defines).fn_observe_launch(
        state.board.data_ptr(), state.piece.data_ptr(), state.rotation.data_ptr(),
        state.x.data_ptr(), state.y.data_ptr(), state.game_over.data_ptr(),
        _fn_masks(pieces, device).data_ptr(), obs.data_ptr(), B, _stream(device),
    )
    _check(rc, "fn_observe")
    LAUNCHES["fn_observe"] += 1
    return obs


def grayscale_u8_exact(rgb: torch.Tensor) -> torch.Tensor:
    """Launch ``grayscale_u8_exact``: ``uint8[...]`` gray values of a
    contiguous ``uint8[..., 3]`` image."""
    from tetris_gymnasium_torch.ops import image
    from tetris_gymnasium_torch.utils.device import constant

    device = rgb.device
    if rgb.ndim < 1 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb: want [..., 3], got {tuple(rgb.shape)}")
    _check_tensor(rgb, "rgb", torch.uint8, rgb.shape, device)
    out = torch.empty(rgb.shape[:-1], dtype=torch.uint8, device=device)
    n = out.numel()
    if n == 0:
        return out
    tables = constant(np.stack(image._gray_tables()), device)
    rc = _lib("gray_exact").gray_exact_launch(rgb.data_ptr(), out.data_ptr(), n, tables.data_ptr(),
                                              _stream(device))
    _check(rc, "grayscale_u8_exact")
    LAUNCHES["grayscale_u8_exact"] += 1
    return out
