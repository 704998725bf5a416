"""Profiling helpers around ``torch.profiler``.

Port of ``tetris_gymnasium_tpu/utils/profiling.py``.  Where the JAX package
traces one XLA program, a step here is a sequence of launches: the
hand-written kernels of :mod:`tetris_gymnasium_torch.kernels` (``turbo_step``,
``gae``, ...) appear in the trace under their own names, beside cuDNN's.

    from tetris_gymnasium_torch.utils import profiling

    with profiling.trace("/tmp/tetris-trace"):  # a Chrome trace lands there
        ts, metrics = train_step(ts)

    with profiling.annotate("rollout"):
        ...

    stats = profiling.time_fn(lambda: step(states, actions), repeats=20)
    # {"mean_s": ..., "best_s": ..., "calls_per_s": ...}
"""
from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import Any, Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """``torch.profiler.profile`` over CPU and CUDA activities as a no-op-when-
    disabled context manager; writes ``trace.json`` (Chrome format) into
    ``logdir``.  ``logdir=None`` disables it.  Yields the profiler (None
    when disabled)."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region for trace attribution (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def _fence(out) -> None:
    """Wait for the card when any tensor of ``out`` lies on it."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "__dataclass_fields__"):
            stack.extend(getattr(x, f) for f in x.__dataclass_fields__)


def time_fn(fn: Callable[[], Any], repeats: int = 10, warmup: int = 2) -> Dict[str, float]:
    """Wall-clock a callable, each call fenced by ``torch.cuda.synchronize()``
    when its result holds a tensor on the card, so the time includes the
    device's work, not only its enqueue."""
    for _ in range(warmup):
        _fence(fn())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _fence(fn())
        times.append(time.perf_counter() - t0)
    mean = sum(times) / len(times)
    return {
        "mean_s": mean,
        "best_s": min(times),
        "calls_per_s": 1.0 / mean if mean else float("inf"),
    }


def save_device_memory_profile(path: str) -> None:
    """Write the card's allocator snapshot (``torch.cuda.memory._snapshot()``,
    pickled, as ``torch.cuda.memory._dump_snapshot`` writes it; PyTorch's
    memory viz reads it).  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("save_device_memory_profile needs a CUDA card")
    with open(path, "wb") as f:
        pickle.dump(torch.cuda.memory._snapshot(), f)
