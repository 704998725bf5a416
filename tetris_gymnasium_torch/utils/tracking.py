"""Optional experiment tracking: wandb when available, silent no-op otherwise.

Port of ``tetris_gymnasium_tpu/utils/tracking.py:16-67``.  The ``--wandb``
flag of the trainers requests it; when ``import wandb`` fails the tracker
prints one warning to stderr and then does nothing.  The JSONL records stay
the source of truth: each record logged here is the same dict the trainer
writes there.  ``wandb.init`` contacts its server unless ``WANDB_MODE`` is
``offline`` or ``disabled``; on a machine without a network, set one.
"""
from __future__ import annotations

import sys
from typing import Optional


class Tracker:
    """Log training scalars (and videos) to wandb if requested and present."""

    def __init__(
        self,
        enabled: bool,
        project: str = "tetris-gymnasium-tpu",
        run_name: Optional[str] = None,
        config: Optional[dict] = None,
    ):
        self._run = None
        if not enabled:
            return
        try:
            import wandb
        except ImportError:
            print(
                "wandb requested but not importable; continuing without "
                "experiment tracking (JSONL logging is unaffected)",
                file=sys.stderr,
            )
            return
        self._run = wandb.init(project=project, name=run_name, config=config or {})

    @property
    def active(self) -> bool:
        return self._run is not None

    def log(self, record: dict, step: int) -> None:
        """Mirror one JSONL record as wandb scalars."""
        if self._run is not None:
            self._run.log({k: v for k, v in record.items() if isinstance(v, (int, float))},
                          step=step)

    def log_video(self, path: str, step: int, tag: str = "episode") -> None:
        """Attach a recorded episode video/GIF to the run."""
        if self._run is not None:
            import wandb

            self._run.log({tag: wandb.Video(path)}, step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
            self._run = None
