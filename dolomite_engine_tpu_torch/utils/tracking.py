"""Experiment tracking and the progress bar, process 0 only (counterpart of
`dolomite_engine_tpu/utils/tracking.py`).

The aim and wandb backends are not ported (ROADMAP.md Queue A, 'Serving fleet and
observability'): naming one raises. With no tracker, every method is a no-op, as in the
JAX package.
"""

from __future__ import annotations

from typing import Any

from .logger import process_index

TRACKERS_NOT_PORTED = (
    "the aim and wandb experiment trackers are not ported yet: ROADMAP.md Queue A, "
    "'Serving fleet and observability'"
)


class ProgressBar:
    """tqdm progress bar on process 0 only."""

    def __init__(self, start: int, end: int, desc: str | None = None) -> None:
        self._bar = None
        if process_index() == 0:
            from tqdm import tqdm

            self._bar = tqdm(initial=start, total=end, desc=desc)

    def update(self, n: int = 1) -> None:
        if self._bar is not None:
            self._bar.update(n)

    def track(self, step: int) -> None:
        if self._bar is not None:
            self._bar.n = step
            self._bar.refresh()

    def set_postfix(self, **metrics) -> None:
        """Loss / throughput readout next to the bar, at log intervals."""
        if self._bar is not None:
            formatted = {k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in metrics.items()}
            self._bar.set_postfix(formatted, refresh=False)

    def close(self) -> None:
        if self._bar is not None:
            self._bar.close()


class ExperimentsTracker:
    def __init__(
        self,
        experiment_name: str | None = None,
        tracker_name=None,
        aim_args=None,
        wandb_args=None,
        checkpoint_metadata: dict | None = None,
    ) -> None:
        if tracker_name is not None:
            raise NotImplementedError(TRACKERS_NOT_PORTED)
        self.tracker_name = None
        self.enabled = False
        self.run = None

    def log_args(self, args) -> None:
        pass

    def track(self, values: dict[str, Any], step: int | None = None, context: str | None = None) -> None:
        pass

    def finish(self) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass
