"""Training observability: a steps-per-second meter and a scalar logger.

Port of ``tetris_gymnasium_tpu/utils/metrics.py``.  :class:`SpsMeter` is
plain Python; :class:`ScalarLogger` writes TensorBoard event files through
``torch.utils.tensorboard.SummaryWriter`` where it imports, and prints
``[step] tag=value`` lines to stdout otherwise.  For device profiling see
:mod:`tetris_gymnasium_torch.utils.profiling`.
"""
from __future__ import annotations

import time
from typing import Optional


class SpsMeter:
    """Steps-per-second over a sliding window of ``report_every`` calls."""

    def __init__(self, steps_per_call: int, report_every: int = 100):
        self.steps_per_call = steps_per_call
        self.report_every = report_every
        self._t0 = time.perf_counter()
        self._start = self._t0
        self._calls = 0
        self._total_calls = 0

    def tick(self) -> Optional[float]:
        """Count one call; returns the window's SPS every ``report_every`` calls."""
        self._calls += 1
        self._total_calls += 1
        if self._calls < self.report_every:
            return None
        now = time.perf_counter()
        sps = self._calls * self.steps_per_call / (now - self._t0)
        self._t0 = now
        self._calls = 0
        return sps

    @property
    def lifetime_sps(self) -> float:
        dt = time.perf_counter() - self._start
        return self._total_calls * self.steps_per_call / max(dt, 1e-9)


class ScalarLogger:
    """TensorBoard scalar logger with a stdout fallback."""

    def __init__(self, logdir: Optional[str] = None):
        self._writer = None
        if logdir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._writer = SummaryWriter(logdir)

    def log(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)
        else:
            print(f"[{step}] {tag}={value:.6g}", flush=True)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
