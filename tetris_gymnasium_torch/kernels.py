"""Build, bind and launch the port's hand-written CUDA kernels.

Sources live in ``csrc/``; each is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/torch_kernels/`` (gitignored), named by the hash of its source, and
loaded with ``ctypes``.  Pointers and the stream go in as ``c_void_p``; the
stream is PyTorch's current one; each C entry point returns
``cudaGetLastError()`` and the wrapper raises if it is not 0.

Kernels, with the JAX function each replaces:

* ``turbo_step`` (``csrc/turbo_step.cu``): ``core/turbo.py:step :639``;
* ``turbo_init`` (``csrc/turbo_step.cu``): ``core/turbo.py:_init_from_key :440``,
  reached through ``init :497``;
* ``observe_board`` (``csrc/observe_board.cu``): ``core/turbo.py:observe_board :738``;
* ``gae`` (``csrc/gae.cu``): ``rl/ppo.py:_gae :147``;
* ``ppo_sample`` (``csrc/ppo_sample.cu``): the sampling tail of
  ``rl/ppo.py:policy_step :184-187``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream without
synchronising, and adds one to ``LAUNCHES[name]`` per launch.  Wrappers
take CUDA tensors only; the plain versions for CPU tensors are in
:mod:`tetris_gymnasium_torch.core.turbo` and
:mod:`tetris_gymnasium_torch.rl.ppo`, which dispatch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tetris_gymnasium_torch.config import EngineConfig, RewardsMapping
from tetris_gymnasium_torch.core import turbo
from tetris_gymnasium_torch.ops import bitboard as bb
from tetris_gymnasium_torch.pieces import PieceSet

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
SOURCES = {
    "turbo_step": PACKAGE_DIR / "csrc" / "turbo_step.cu",
    "observe_board": PACKAGE_DIR / "csrc" / "observe_board.cu",
    "gae": PACKAGE_DIR / "csrc" / "gae.cu",
    "ppo_sample": PACKAGE_DIR / "csrc" / "ppo_sample.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launch counts, one per kernel: added to where a wrapper launches, nowhere else.
LAUNCHES = {"turbo_step": 0, "turbo_init": 0, "observe_board": 0, "gae": 0, "ppo_sample": 0}

_LIBS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def _compile(name: str) -> dict:
    """Compile one source unless its library exists; returns build facts."""
    source = SOURCES[name]
    out = _lib_path(source)
    if out.exists():
        return {"name": name, "seconds": 0.0, "cached": True, "ptxas": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return {
        "name": name,
        "seconds": time.perf_counter() - t0,
        "cached": False,
        "ptxas": "\n".join(l for l in proc.stderr.splitlines() if "ptxas" in l),
    }


def build() -> list:
    """Compile every kernel source in parallel (one ``nvcc`` each)."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        return list(pool.map(_compile, SOURCES))


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


class _ObsGeometry(ctypes.Structure):
    _fields_ = [
        (name, ctypes.c_int)
        for name in ("height", "width", "padding", "rows_h", "padded_width", "size", "n_entries")
    ]


_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry points of each source: name -> argtypes (every one returns cudaGetLastError()).
_ENTRY_POINTS = {
    "turbo_step": {
        "turbo_step_launch": [ctypes.POINTER(_StatePtrs), ctypes.POINTER(_StatePtrs),
                              _P, _P, _P, _P, _P, _P, _I, ctypes.POINTER(_StepParams), _P],
        "turbo_init_launch": [_P, ctypes.POINTER(_StatePtrs), _P, _I, _I, _P],
    },
    "observe_board": {
        "observe_board_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 ctypes.POINTER(_ObsGeometry), _P],
    },
    "gae": {
        "gae_launch": [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, ctypes.c_float, _P],
    },
    "ppo_sample": {
        "ppo_sample_launch": [_P, _P, _P, _P, _I, ctypes.c_uint32, ctypes.c_uint32, _P],
    },
}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        _compile(name)
        lib = ctypes.CDLL(str(_lib_path(SOURCES[name])))
        for fn, argtypes in _ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# Geometry the turbo_step kernel is compiled for (csrc/turbo_step.cu).
_STEP_GEOMETRY = dict(width=10, height=20, padding=4, queue_size=4, holder_size=1)
_STATE_DTYPES = {
    "key": torch.uint32, "rows": torch.uint32, "has_swapped": torch.bool,
    "game_over": torch.bool, "score": torch.float32,
}


def _state_shapes(config: EngineConfig, n_pieces: int, B: int) -> dict:
    shapes = {k: (B,) for k in turbo.FIELDS}
    shapes.update(
        key=(2, B), rows=(config.padded_height, B), bag=(n_pieces, B),
        queue=(config.queue_size, B), holder_piece=(config.holder_size, B),
        holder_rotation=(config.holder_size, B),
    )
    return shapes


def _check_step_config(config: EngineConfig, t: bb.Tables) -> None:
    got = {k: getattr(config, k) for k in _STEP_GEOMETRY}
    if got != _STEP_GEOMETRY or (t.n_pieces, t.size) != (7, 4):
        raise NotImplementedError(
            f"the turbo_step kernel is built for {_STEP_GEOMETRY} and the 7 standard "
            f"pieces; got {got}, {t.n_pieces} pieces of side {t.size}"
        )
    if config.queue_kind not in ("bag", "uniform"):
        raise NotImplementedError(f"queue_kind {config.queue_kind!r} has no kernel")


def _check_state(state: turbo.TurboState, config: EngineConfig, n_pieces: int, device) -> int:
    B = state.piece.shape[0]
    shapes = _state_shapes(config, n_pieces, B)
    for k in turbo.FIELDS:
        v = getattr(state, k)
        want = _STATE_DTYPES.get(k, torch.int32)
        if not v.is_cuda or v.device != device or v.dtype != want \
                or tuple(v.shape) != shapes[k] or not v.is_contiguous():
            raise ValueError(
                f"state.{k}: want a contiguous CUDA {want} tensor of shape {shapes[k]} on "
                f"{device}, got {v.dtype} {tuple(v.shape)} on {v.device} "
                f"(contiguous={v.is_contiguous()})"
            )
    return B


def _ptrs(state: turbo.TurboState) -> _StatePtrs:
    return _StatePtrs(*(getattr(state, k).data_ptr() for k in turbo.FIELDS))


def _empty_state(config: EngineConfig, n_pieces: int, B: int, device) -> turbo.TurboState:
    shapes = _state_shapes(config, n_pieces, B)
    return turbo.TurboState(**{
        k: torch.empty(shapes[k], dtype=_STATE_DTYPES.get(k, torch.int32), device=device)
        for k in turbo.FIELDS
    })


def turbo_step(state: turbo.TurboState, action: torch.Tensor, config: EngineConfig,
               pieces: PieceSet, rewards: RewardsMapping, max_clear: int = 4):
    """Launch ``turbo_step``: returns ``(new_state, reward f32[B], done bool[B], lines int32[B])``.

    The new state is in new buffers; ``state`` is left as it was.
    """
    device = state.rows.device
    t, packed, box = turbo.tables_for(pieces, device)
    _check_step_config(config, t)
    if max_clear < 0:
        raise ValueError(f"max_clear must be >= 0, got {max_clear}")
    B = _check_state(state, config, t.n_pieces, device)
    if not action.is_cuda or action.dtype != torch.int32 or tuple(action.shape) != (B,) \
            or not action.is_contiguous() or action.device != device:
        raise ValueError(f"action: want a contiguous int32[{B}] tensor on {device}")
    out = _empty_state(config, t.n_pieces, B, device)
    reward = torch.empty((B,), dtype=torch.float32, device=device)
    done = torch.empty((B,), dtype=torch.bool, device=device)
    lines = torch.empty((B,), dtype=torch.int32, device=device)
    if B == 0:
        return out, reward, done, lines
    params = _StepParams(
        int(config.gravity_enabled), int(config.auto_reset), int(config.queue_kind == "uniform"),
        int(max_clear), float(np.float32(rewards.alife)), float(np.float32(rewards.game_over)),
    )
    in_p, out_p = _ptrs(state), _ptrs(out)
    rc = _lib("turbo_step").turbo_step_launch(
        ctypes.byref(in_p), ctypes.byref(out_p), action.data_ptr(), reward.data_ptr(),
        done.data_ptr(), lines.data_ptr(), packed.data_ptr(), box.data_ptr(), B,
        ctypes.byref(params), _stream(device),
    )
    _check(rc, "turbo_step")
    LAUNCHES["turbo_step"] += 1
    return out, reward, done, lines


def turbo_init(keys: torch.Tensor, config: EngineConfig, pieces: PieceSet) -> turbo.TurboState:
    """Launch ``turbo_init``: fresh episodes from per-env keys ``uint32[B, 2]``."""
    device = keys.device
    t, _, box = turbo.tables_for(pieces, device)
    _check_step_config(config, t)
    if not keys.is_cuda or keys.dtype != torch.uint32 or keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys: want a CUDA uint32[B, 2] tensor, got {keys.dtype} {tuple(keys.shape)}")
    keys = keys.contiguous()
    B = keys.shape[0]
    out = _empty_state(config, t.n_pieces, B, device)
    if B == 0:
        return out
    out_p = _ptrs(out)
    rc = _lib("turbo_step").turbo_init_launch(
        keys.data_ptr(), ctypes.byref(out_p), box.data_ptr(), B,
        int(config.queue_kind == "uniform"), _stream(device),
    )
    _check(rc, "turbo_init")
    LAUNCHES["turbo_init"] += 1
    return out


def observe_board(state: turbo.TurboState, config: EngineConfig, pieces: PieceSet) -> torch.Tensor:
    """Launch ``observe_board``: ``int8[B, height, width]`` board with the piece as -1."""
    turbo.check_geometry(config)
    device = state.rows.device
    t, packed, _ = turbo.tables_for(pieces, device)
    B = state.piece.shape[0]
    want = {
        "rows": (torch.uint32, (config.padded_height, B)), "piece": (torch.int32, (B,)),
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
        config.padded_width, t.size, t.n_pieces * 4,
    )
    rc = _lib("observe_board").observe_board_launch(
        state.rows.data_ptr(), state.piece.data_ptr(), state.rotation.data_ptr(),
        state.x.data_ptr(), state.y.data_ptr(), state.game_over.data_ptr(), packed.data_ptr(),
        out.data_ptr(), B, ctypes.byref(geom), _stream(device),
    )
    _check(rc, "observe_board")
    LAUNCHES["observe_board"] += 1
    return out


def _check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if not t.is_cuda or t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous CUDA {dtype} tensor of shape {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


def gae(reward: torch.Tensor, value: torch.Tensor, done: torch.Tensor, last_value: torch.Tensor,
        gamma: float, gae_lambda: float):
    """Launch ``gae``: returns ``(advantages f32[T, B], targets f32[T, B])``.

    ``reward`` and ``value`` are ``f32[T, B]``, ``done`` is ``bool[T, B]``,
    ``last_value`` is ``f32[B]``.  ``gamma`` and ``gamma * gae_lambda`` (the
    product formed in double) are rounded to float32 once, as JAX does.
    """
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
    rc = _lib("gae").gae_launch(
        reward.data_ptr(), value.data_ptr(), done.data_ptr(), last_value.data_ptr(),
        advantages.data_ptr(), targets.data_ptr(), T, B,
        float(np.float32(gamma)), float(np.float32(gamma * gae_lambda)), _stream(device),
    )
    _check(rc, "gae")
    LAUNCHES["gae"] += 1
    return advantages, targets


def sample_actions(logits: torch.Tensor, act_key, return_uniforms: bool = False):
    """Launch ``ppo_sample``: returns ``(action int32[B], log_prob f32[B])``.

    ``logits`` is ``f32[B, 8]``; ``act_key`` is the step's ``uint32[2]``
    key on the host (``jax.random.categorical``'s key).  With
    ``return_uniforms`` the kernel also writes the uniforms ``f32[B, 8]``
    behind its Gumbel noise, returned third, so that a check can hold them
    against JAX's bits.
    """
    device = logits.device
    if logits.ndim != 2 or logits.shape[1] != 8:
        raise NotImplementedError(f"ppo_sample is built for [B, 8] logits, got {tuple(logits.shape)}")
    B = logits.shape[0]
    _check_tensor(logits, "logits", torch.float32, (B, 8), device)
    if B * 8 >= 2**31:
        raise ValueError(f"batch {B} too large for 32-bit counters")
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
        _stream(device),
    )
    _check(rc, "ppo_sample")
    LAUNCHES["ppo_sample"] += 1
    return out
