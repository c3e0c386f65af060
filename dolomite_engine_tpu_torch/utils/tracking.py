"""Experiment tracking and the progress bar, process 0 only (counterpart of
`dolomite_engine_tpu/utils/tracking.py`).

`ExperimentsTracker` drives aim or wandb on process 0 as the JAX package's does: the arg
tree, scalar dicts with a step and a train / val context, and the run's hash or id in
`state_dict` so a resumed run appends to it. When the named package is not installed it
warns and turns tracking off, as JAX does. The path where aim or wandb is installed is
untested: neither can be installed where the port's tests run. With no tracker, every
method is a no-op.
"""

from __future__ import annotations

import importlib.util
import logging
from typing import Any

from .logger import log_rank_0, process_index


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, f"{name}."))
        else:
            flat[name] = value
    return flat


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
        from ..enums import ExperimentsTrackerName

        self.tracker_name = tracker_name
        self.enabled = tracker_name is not None and process_index() == 0
        self.run = None
        checkpoint_metadata = checkpoint_metadata or {}
        if not self.enabled:
            return
        if tracker_name not in (ExperimentsTrackerName.aim, ExperimentsTrackerName.wandb):
            raise ValueError(f"unexpected tracker {tracker_name}")
        package = tracker_name.value
        if importlib.util.find_spec(package) is None:
            log_rank_0(logging.WARNING, f"{package} is not installed, tracking disabled")
            self.enabled = False
            return
        if tracker_name == ExperimentsTrackerName.aim:
            import aim

            self.run = aim.Run(
                run_hash=checkpoint_metadata.get("run_hash"),
                experiment=aim_args.experiment if aim_args else experiment_name,
                repo=aim_args.repo if aim_args else None,
            )
        else:
            import wandb

            kwargs = {}
            if wandb_args is not None:
                kwargs = {"project": wandb_args.project, "name": wandb_args.name, "entity": wandb_args.entity}
            run_id = checkpoint_metadata.get("run_id")
            if run_id is not None:
                kwargs.update({"id": run_id, "resume": "must"})
            self.run = wandb.init(**kwargs)

    def _is_aim(self) -> bool:
        from ..enums import ExperimentsTrackerName

        return self.tracker_name == ExperimentsTrackerName.aim

    def log_args(self, args) -> None:
        """Log the whole (flattened) config tree."""
        if not self.enabled or self.run is None:
            return
        flat = _flatten(args.to_dict())
        if self._is_aim():
            for key, value in flat.items():
                self.run[key] = value
        else:
            self.run.config.update(flat, allow_val_change=True)

    def track(self, values: dict[str, Any], step: int | None = None, context: str | None = None) -> None:
        if not self.enabled or self.run is None:
            return
        if self._is_aim():
            for key, value in values.items():
                self.run.track(value, name=key, step=step, context={"subset": context})
        else:
            prefix = f"{context}/" if context else ""
            self.run.log({f"{prefix}{k}": v for k, v in values.items()}, step=step)

    def finish(self) -> None:
        if not self.enabled or self.run is None:
            return
        if self._is_aim():
            self.run.close()
        else:
            self.run.finish()

    def state_dict(self) -> dict:
        """The run's aim hash or wandb id, so a resumed run appends to it."""
        if self.run is None:
            return {}
        return {"run_hash": self.run.hash} if self._is_aim() else {"run_id": self.run.id}

    def load_state_dict(self, state: dict) -> None:
        pass
