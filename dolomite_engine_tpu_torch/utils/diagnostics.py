"""Training health: per-group tensor statistics, anomaly detection, the crash flight
recorder, the one-shot model report, and the serving SLO monitor.

Counterpart of `dolomite_engine_tpu/utils/diagnostics.py`: `HealthMonitor` (EWMA z-scores
over loss and grad norm, the rolling-median straggler detector, ``anomaly`` events, the optional
escalation to the abort path), `FlightRecorder` (on by default: the last
``flight_recorder_steps`` step records, dumped to
``<save_path>/telemetry/flight-record-rank-<N>.json`` on a crash, a stall, a NaN abort or
a preemption) and `emit_model_report`; and the per-group tensor statistics of
``health.interval > 0`` (`per_group_health`, `group_health`), computed in the train step on
the device and written every ``interval`` steps as a ``health`` record. `ServingSLOMonitor`
(a copy of the JAX package's) watches a serving engine or fleet once a step: TTFT burn
rates per tier, queue growth, the draft accept rate and the KV-handoff latency.
"""

from __future__ import annotations

import json
import logging
import math
import os
import socket
import sys
import time
from collections import deque
from typing import Any

import torch

from .logger import log_rank_0, process_index

# environment variables worth preserving at the moment of death (snapshot filters by prefix)
_ENV_SNAPSHOT_PREFIXES = ("CUDA_", "NVIDIA_", "TORCH_", "PYTORCH_", "DOLOMITE_")

# --------------------------------------------------------------------- anomaly detectors


class EWMADetector:
    """Per-signal EWMA mean/variance with z-score flagging.

    Each sample is scored against the state BEFORE it is folded in, then folded in
    regardless — a genuine regime change (warmup ending, LR decay kink) flags briefly and
    then stops, instead of flagging forever. Non-finite samples flag immediately and are NOT
    folded in (they would poison the running moments). No flags during the first
    ``warmup`` samples of a signal — the moments are meaningless cold.
    """

    def __init__(self, alpha: float = 0.05, threshold: float = 6.0, warmup: int = 20) -> None:
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = max(int(warmup), 1)
        self._signals: dict[str, list[float]] = {}  # name -> [mean, var, count]

    def update(self, name: str, value: float) -> tuple[float | None, bool]:
        """Score + fold one sample; returns (z_score or None, flagged)."""
        value = float(value)
        if not math.isfinite(value):
            return None, True
        state = self._signals.get(name)
        if state is None:
            self._signals[name] = [value, 0.0, 1]
            return None, False
        mean, var, count = state
        delta = value - mean
        z_score = None
        flagged = False
        if count >= self.warmup:
            # a constant-so-far signal has var 0; the floor makes any jump off it flag
            z_score = delta / math.sqrt(max(var, 1e-24))
            flagged = abs(z_score) >= self.threshold
        mean += self.alpha * delta
        var = (1.0 - self.alpha) * (var + self.alpha * delta * delta)
        self._signals[name] = [mean, var, count + 1]
        return z_score, flagged


class StragglerDetector:
    """Rolling-median step-time guard: flags a step slower than ``factor`` x the median of
    the last ``window`` steady steps. Samples always enter the window — a persistent
    regression (new slower regime after e.g. a topology change) stops flagging once the
    median catches up, so only *relative* stragglers and fresh regressions fire."""

    def __init__(self, window: int = 50, factor: float = 2.0, min_samples: int = 10) -> None:
        self.factor = factor
        self.min_samples = max(int(min_samples), 2)
        self._times: deque[float] = deque(maxlen=max(int(window), self.min_samples))

    def update(self, step_seconds: float) -> tuple[float | None, bool]:
        """Score + fold one steady-step time; returns (ratio to median or None, flagged)."""
        ratio = None
        flagged = False
        if len(self._times) >= self.min_samples:
            ordered = sorted(self._times)
            median = ordered[len(ordered) // 2]
            if median > 0:
                ratio = step_seconds / median
                flagged = ratio >= self.factor
        self._times.append(step_seconds)
        return ratio, flagged


# --------------------------------------------------------------------- flight recorder


def environment_snapshot() -> dict:
    """Process/environment snapshot attached to every flight-record dump."""
    snapshot: dict[str, Any] = {
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "cwd": os.getcwd(),
        "python": sys.version.split()[0],
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "process_index": process_index(),
    }
    if torch.cuda.is_available():
        snapshot["device_count"] = torch.cuda.device_count()
        snapshot["device_kind"] = torch.cuda.get_device_name(0)
    snapshot["env"] = {
        key: os.environ[key]
        for key in sorted(os.environ)
        if key.startswith(_ENV_SNAPSHOT_PREFIXES)
    }
    return snapshot


class FlightRecorder:
    """Bounded ring buffer of per-step records, dumped with an environment snapshot at the
    moment of death.

    :meth:`record` is deque-append cheap and runs every step; :meth:`dump` writes
    ``{reason, error, environment, records}`` to ``path`` (tmp-file + rename, so a crash
    mid-dump never leaves a torn file). The FIRST dump wins — it is the one closest to the
    fault (a stall-watchdog dump should not be overwritten by the generic
    unhandled-exception dump of the same RuntimeError unwinding the loop).
    """

    def __init__(self, capacity: int, path: str | None, rank: int = 0) -> None:
        self.path = path
        self.rank = rank
        self.records: deque[dict] = deque(maxlen=max(int(capacity), 1))
        self._dumped: str | None = None

    def record(self, step: int, **fields) -> None:
        entry = {"step": step}
        entry.update({key: value for key, value in fields.items() if value is not None})
        self.records.append(entry)

    @property
    def dumped_path(self) -> str | None:
        return self._dumped

    def dump(self, reason: str, error: BaseException | None = None) -> str | None:
        """Write the flight record; no-op if pathless or already dumped. Never raises."""
        if self.path is None or self._dumped is not None:
            return self._dumped
        payload = {
            "schema": 1,
            "reason": reason,
            "error": repr(error) if error is not None else None,
            "ts": round(time.time(), 3),
            "rank": self.rank,
            "environment": environment_snapshot(),
            "records": list(self.records),
        }
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp_path = f"{self.path}.tmp"
            with open(tmp_path, "w") as f:
                json.dump(payload, f, indent=1, default=str)
            os.replace(tmp_path, self.path)
        except Exception as dump_error:  # the dump is a best effort on a dying process
            log_rank_0(logging.WARNING, f"flight-record dump failed: {dump_error!r}")
            return None
        self._dumped = self.path
        log_rank_0(
            logging.WARNING,
            f"flight record ({reason}, last {len(payload['records'])} step(s)) written to "
            f"{self.path}",
        )
        return self.path


def crash_reason(error: BaseException) -> str:
    """Classify a loop-killing exception into the flight-record reason vocabulary."""
    message = str(error)
    if "non-finite" in message:
        return "nan_abort"
    if "stalled" in message:
        return "loader_stall"
    if "anomalous" in message:
        return "anomaly_abort"
    return f"exception:{type(error).__name__}"


# --------------------------------------------------------------------- per-group stats


def health_groups(names: list[str] | None, count: int) -> dict[str, list[int]]:
    """Parameter indices by health group: the first component of each parameter name
    (the JAX params tree's top-level keys, e.g. ``transformer`` and ``lm_head``), in
    sorted order; without names one ``params`` group (JAX's non-mapping tree)."""
    if names is None:
        return {"params": list(range(count))}
    groups: dict[str, list[int]] = {}
    for i, name in enumerate(names):
        groups.setdefault(name.split(".")[0], []).append(i)
    return {key: groups[key] for key in sorted(groups)}


def squared_norms(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor's squared fp32 norm, on its device: on a card from one fused
    ``_foreach_norm`` pass, elsewhere the summed fp32 squares (JAX's ``sum(square(x))``;
    the CPU's norm kernels lose precision on tensors of a few million elements)."""
    tensors = [t.detach().float() for t in tensors]
    if tensors and tensors[0].device.type == "cuda":
        return [n.square() for n in torch._foreach_norm(tensors)]
    return [t.square().sum() for t in tensors]


def group_health(
    param_sq: list[torch.Tensor], grad_sq: list[torch.Tensor], update_sq: list[torch.Tensor] | None, groups: dict
) -> dict[str, dict[str, torch.Tensor]]:
    """Per group: the parameter norm, the gradient norm and ``||p' - p|| / ||p||``, from
    each tensor's squared norm (`update_sq` None: a skipped step, ratio 0). The values
    stay on the device until `HealthMonitor.emit_health` reads them."""
    health: dict[str, dict[str, torch.Tensor]] = {"param_norm": {}, "grad_norm": {}, "update_ratio": {}}
    for name, indices in groups.items():
        param_norm = torch.stack([param_sq[i] for i in indices]).sum().sqrt()
        health["param_norm"][name] = param_norm
        health["grad_norm"][name] = torch.stack([grad_sq[i] for i in indices]).sum().sqrt()
        update = (
            torch.zeros_like(param_norm)
            if update_sq is None
            else torch.stack([update_sq[i] for i in indices]).sum().sqrt()
        )
        health["update_ratio"][name] = update / (param_norm + 1e-12)
    return health


def per_group_health(params, grads, new_params, names: list[str] | None = None) -> dict:
    """The JAX package's `per_group_health` over lists of tensors: ``{"param_norm",
    "grad_norm", "update_ratio"}`` by group (`health_groups` of `names`), the update norm
    measured from the parameters before and after. The train step computes the same from
    the optimizer's tracked update (`make_train_step(collect_health=True)`)."""
    update_sq = [(new.float() - old.float()).square().sum() for new, old in zip(new_params, params)]
    groups = health_groups(names, len(params))
    return group_health(squared_norms(params), squared_norms(grads), update_sq, groups)


# --------------------------------------------------------------------- health monitor


class HealthMonitor:
    """Host side of the training health subsystem, one instance per train loop.

    Per step (:meth:`observe_step`): feed loss/grad-norm into the EWMA z-score detector and
    step time into the straggler detector, append the flight-recorder entry, and write an
    ``anomaly`` event per flag. With ``abort_after_consecutive_anomalies`` set, N consecutive
    flagged steps dump the flight record and raise — the same abort contract as
    ``handle_nonfinite_step``, so the operator story (restart from last checkpoint) is one
    story. Every ``interval`` steps (:meth:`emit_health`) the step's per-group statistics
    are read to the host and written as a ``health`` record + fanned out to the tracker.
    """

    def __init__(
        self,
        telemetry,
        interval: int = 0,
        ewma_alpha: float = 0.05,
        zscore_threshold: float = 6.0,
        warmup_steps: int = 20,
        straggler_window: int = 50,
        straggler_factor: float = 2.0,
        abort_after_consecutive_anomalies: int | None = None,
        flight_recorder: FlightRecorder | None = None,
    ) -> None:
        self.telemetry = telemetry
        self.interval = max(int(interval), 0)
        self.abort_after = abort_after_consecutive_anomalies
        self.flight_recorder = flight_recorder
        self.detector = EWMADetector(
            alpha=ewma_alpha, threshold=zscore_threshold, warmup=warmup_steps
        )
        self.straggler = StragglerDetector(window=straggler_window, factor=straggler_factor)
        self._consecutive_anomalies = 0
        self._seen_first_step = False

    # ------------------------------------------------------------------ cadence

    @property
    def wants_step_metrics(self) -> bool:
        """True when the loop should sync loss/grad-norm every step (health monitoring on —
        same per-step host-sync cost as ``skip_nonfinite_steps``)."""
        return self.interval > 0

    def health_due(self, step: int) -> bool:
        return self.interval > 0 and step % self.interval == 0

    # ------------------------------------------------------------------ per step

    def observe_step(
        self,
        step: int,
        loss: float | None = None,
        grad_norm: float | None = None,
        step_seconds: float = 0.0,
        data_seconds: float = 0.0,
        skipped: bool = False,
    ) -> list[dict]:
        """Once per train step, after the step ran. Returns the anomalies flagged; raises
        RuntimeError past the consecutive-anomaly abort threshold."""
        anomalies: list[dict] = []
        if skipped:
            # the jitted step already refused the update; record it as the anomaly it is
            # (handle_nonfinite_step owns the nan_skips counter/event)
            anomalies.append({"signal": "nonfinite_step"})
        for signal_name, value in (("loss", loss), ("grad_norm", grad_norm)):
            if value is None or skipped:
                continue
            z_score, flagged = self.detector.update(signal_name, value)
            if flagged:
                anomaly = {"signal": signal_name, "value": value}
                if z_score is not None:
                    anomaly["zscore"] = round(z_score, 3)
                anomalies.append(anomaly)
        if not self._seen_first_step:
            self._seen_first_step = True  # first step is compile; keep it out of the median
        else:
            ratio, flagged = self.straggler.update(step_seconds)
            if flagged:
                anomalies.append(
                    {
                        "signal": "step_time",
                        "value": round(step_seconds, 6),
                        "ratio": round(ratio, 3),
                    }
                )

        if self.flight_recorder is not None:
            self.flight_recorder.record(
                step,
                loss=loss,
                grad_norm=grad_norm,
                step_seconds=round(step_seconds, 6),
                data_seconds=round(data_seconds, 6),
                skipped=skipped or None,
                anomalies=[a["signal"] for a in anomalies] or None,
            )
        for anomaly in anomalies:
            self.telemetry.event("anomaly", step=step, **anomaly)

        if anomalies:
            self._consecutive_anomalies += 1
        else:
            self._consecutive_anomalies = 0
        if self.abort_after is not None and self._consecutive_anomalies >= self.abort_after:
            self.dump_flight_record("anomaly_abort")
            raise RuntimeError(
                f"aborting: {self._consecutive_anomalies} consecutive anomalous training "
                f"steps (threshold logging_args.telemetry.health."
                f"abort_after_consecutive_anomalies={self.abort_after}) — see the anomaly "
                "events and flight record; resume from the last checkpoint"
            )
        return anomalies

    def emit_health(self, step: int, health_tree) -> dict | None:
        """Read the step's per-group statistics and write the ``health`` record (+ tracker
        fanout). Never raises: a failed health read must not kill a healthy run."""
        try:
            stats = {
                metric: {group: float(value) for group, value in groups.items()}
                for metric, groups in health_tree.items()
            }
        except Exception as error:  # observational: the run goes on
            log_rank_0(logging.WARNING, f"health stats sync failed: {error!r}")
            return None
        self.telemetry.emit_record("health", step=step, stats=stats)
        tracker = getattr(self.telemetry, "experiments_tracker", None)
        if tracker is not None:
            scalars = {
                f"health/{metric}/{group}": value
                for metric, groups in stats.items()
                for group, value in groups.items()
                if math.isfinite(value)
            }
            if scalars:
                tracker.track(scalars, step=step, context="health")
        return stats

    # ------------------------------------------------------------------ crash path

    def dump_flight_record(self, reason: str, error: BaseException | None = None) -> str | None:
        """Crash-hook entry point (also called directly by the loops' except path)."""
        if self.flight_recorder is None:
            return None
        return self.flight_recorder.dump(reason, error=error)



def build_health_monitor(args, telemetry) -> HealthMonitor:
    """The HealthMonitor from ``args.logging_args.telemetry.health``. Flight-record dumps
    land next to the telemetry sink: ``<save_path>/telemetry/flight-record-rank-<N>.json``."""
    health_args = args.logging_args.telemetry.health
    flight_recorder = None
    save_path = args.save_args.save_path
    if health_args.flight_recorder_steps > 0 and save_path is not None:
        flight_recorder = FlightRecorder(
            health_args.flight_recorder_steps,
            os.path.join(save_path, "telemetry", f"flight-record-rank-{process_index():05d}.json"),
            rank=process_index(),
        )
    return HealthMonitor(
        telemetry,
        interval=health_args.interval,
        ewma_alpha=health_args.ewma_alpha,
        zscore_threshold=health_args.zscore_threshold,
        warmup_steps=health_args.warmup_steps,
        straggler_window=health_args.straggler_window,
        straggler_factor=health_args.straggler_factor,
        abort_after_consecutive_anomalies=health_args.abort_after_consecutive_anomalies,
        flight_recorder=flight_recorder,
    )


# --------------------------------------------------------------------- serving SLO alerts


class ServingSLOMonitor:
    """SLO burn-rate alerts over serving signals (docs/OBSERVABILITY.md "Live metrics").

    The serving-side counterpart of :class:`HealthMonitor`: attached to a
    ``ServingEngine`` (``slo_monitor=``) it is fed once per engine step and watches four
    signal families, emitting the same ``anomaly`` event records the training detector
    writes, so one summary/alerting path reads both:

    - **TTFT burn rate** (per tier with a ``TierSLO.ttft_target_s``): each step scores
      "is this tier's p99 TTFT over target" into two sliding windows — a fast window
      (default 5 steps) that must be *fully* burning and a slow window (default 60
      steps) that must be burning past ``slow_burn`` — the classic multi-window
      burn-rate gate: the fast window gives detection latency, the slow window keeps a
      single slow request from paging anyone. One alert per (replica, tier) while the
      condition holds; the key re-arms after the fast window clears.
    - **Queue growth**: per-step queue-depth delta through the EWMA z-score detector —
      sustained admission faster than drain flags, a steady-state queue does not.
    - **Accept-rate collapse** (speculation only): the cumulative draft accept rate
      through the EWMA detector, flagging only downward breaks (a drafter suddenly
      mispredicting, e.g. an out-of-distribution workload shift).
    - **Handoff latency** (disaggregated fleets): per-transfer KV-handoff wall time,
      flagging only upward breaks (the interconnect degrading under the fleet).

    Signals are keyed by (replica, tier) so one monitor serves a whole fleet; state
    mutation is CPython-atomic (dict/deque ops) and event emission locks inside
    Telemetry, so threaded replicas share an instance safely. Alerts are mirrored on
    ``self.alerts`` for the obs server's ``/statusz`` and for tests.
    """

    def __init__(
        self,
        telemetry,
        fast_window: int = 5,
        slow_window: int = 60,
        fast_burn: float = 1.0,
        slow_burn: float = 0.5,
        ewma_alpha: float = 0.05,
        zscore_threshold: float = 6.0,
        warmup: int = 20,
    ) -> None:
        if fast_window < 1 or slow_window < fast_window:
            raise ValueError(
                f"need 1 <= fast_window <= slow_window, got {fast_window}/{slow_window}"
            )
        self.telemetry = telemetry
        self.fast_window = fast_window
        self.slow_window = slow_window
        self.fast_burn = fast_burn
        self.slow_burn = slow_burn
        self.detector = EWMADetector(
            alpha=ewma_alpha, threshold=zscore_threshold, warmup=warmup
        )
        self._burn: dict[tuple, tuple[deque, deque]] = {}
        self._alerting: set[tuple] = set()
        self._last_queue: dict[Any, int] = {}
        self.alerts: list[dict] = []

    # ------------------------------------------------------------------ emission

    def _alert(self, step: int, anomaly: dict) -> None:
        self.alerts.append({"step": step, **anomaly})
        self.telemetry.event("anomaly", step=step, **anomaly)

    def _observe_burn(self, key: tuple, step: int, violated: bool, fields: dict) -> None:
        windows = self._burn.get(key)
        if windows is None:
            windows = self._burn[key] = (
                deque(maxlen=self.fast_window),
                deque(maxlen=self.slow_window),
            )
        fast, slow = windows
        sample = 1.0 if violated else 0.0
        fast.append(sample)
        slow.append(sample)
        fast_rate = sum(fast) / len(fast)
        slow_rate = sum(slow) / len(slow)
        firing = (
            len(fast) == self.fast_window
            and fast_rate >= self.fast_burn
            and slow_rate >= self.slow_burn
        )
        if firing and key not in self._alerting:
            self._alerting.add(key)
            self._alert(
                step,
                {
                    **fields,
                    "fast_burn_rate": round(fast_rate, 3),
                    "slow_burn_rate": round(slow_rate, 3),
                },
            )
        elif key in self._alerting and fast_rate < self.fast_burn:
            self._alerting.discard(key)  # cleared: the next sustained burn re-alerts

    # ------------------------------------------------------------------ signal feeds

    def observe_engine(self, engine) -> None:
        """Once per engine step (``ServingEngine.step`` calls this when attached)."""
        step = engine._step_count
        stats = engine.stats
        replica = engine.replica_id
        for tier, slo in sorted(engine.scheduler.tier_slos.items()):
            target = slo.ttft_target_s
            if target is None:
                continue
            p99 = stats.ttft_p99_s(tier)
            if p99 is None:
                continue  # a tier with no admitted traffic cannot burn its budget
            self._observe_burn(
                ("ttft", replica, tier),
                step,
                p99 > target,
                {
                    "signal": "ttft_burn_rate",
                    "replica_id": replica,
                    "tier": tier,
                    "ttft_p99_ms": round(p99 * 1e3, 3),
                    "ttft_target_ms": round(target * 1e3, 3),
                },
            )
        depth = engine.scheduler.queue_depth
        previous = self._last_queue.get(replica)
        self._last_queue[replica] = depth
        if previous is not None:
            z_score, flagged = self.detector.update(f"queue_growth/{replica}", depth - previous)
            if flagged and depth > previous:
                anomaly = {
                    "signal": "queue_growth",
                    "replica_id": replica,
                    "queue_depth": depth,
                    "growth": depth - previous,
                }
                if z_score is not None:
                    anomaly["zscore"] = round(z_score, 3)
                self._alert(step, anomaly)
        if engine.speculating:
            rate = stats.accept_rate()
            if rate is not None:
                z_score, flagged = self.detector.update(f"accept_rate/{replica}", rate)
                if flagged and (z_score is None or z_score < 0):
                    anomaly = {
                        "signal": "accept_rate_collapse",
                        "replica_id": replica,
                        "accept_rate": round(rate, 4),
                    }
                    if z_score is not None:
                        anomaly["zscore"] = round(z_score, 3)
                    self._alert(step, anomaly)

    def observe_handoff(self, latency_s: float, replica_id=None, step: int = 0) -> None:
        """One KV-handoff wall time (the router feeds this per new transfer)."""
        z_score, flagged = self.detector.update("handoff_latency", latency_s)
        if flagged and (z_score is None or z_score > 0):
            anomaly = {
                "signal": "handoff_latency",
                "replica_id": replica_id,
                "handoff_latency_ms": round(latency_s * 1e3, 3),
            }
            if z_score is not None:
                anomaly["zscore"] = round(z_score, 3)
            self._alert(step, anomaly)


# --------------------------------------------------------------------- model report


def summarize_param_groups(named_params) -> dict[str, dict]:
    """Per-top-level-module parameter counts and bytes (``transformer``, ``lm_head``)."""
    groups: dict[str, dict] = {}
    for name, param in named_params:
        group = groups.setdefault(name.split(".")[0], {"parameters": 0, "bytes": 0})
        group["parameters"] += param.numel()
        group["bytes"] += param.numel() * param.element_size()
    return groups


def build_model_report(
    model: torch.nn.Module,
    optimizer=None,
    model_tflops_per_step: float | None = None,
    remat: dict | None = None,
) -> dict:
    """One-shot introspection record: the parameters by group, the optimizer state's bytes,
    and whether the persistent state fits the card (activations and gradients excluded:
    a floor)."""
    named = list(model.named_parameters())
    moments = [] if optimizer is None else optimizer.state_tensors()
    totals = {
        "parameters": sum(p.numel() for _, p in named),
        "param_bytes": sum(p.numel() * p.element_size() for _, p in named),
        "optimizer_bytes": sum(t.numel() * t.element_size() for t in moments),
        "fp8_bytes": 0,
    }
    state_bytes = totals["param_bytes"] + totals["optimizer_bytes"]
    device = named[0][1].device if named else torch.device("cpu")
    bytes_limit = torch.cuda.get_device_properties(device).total_memory if device.type == "cuda" else None
    report = {
        "devices": 1,
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "param_groups": summarize_param_groups(named),
        "totals": totals,
        "hbm": {
            "state_bytes_per_device": state_bytes,
            "bytes_limit": bytes_limit,
            "state_fraction_of_limit": round(state_bytes / bytes_limit, 4) if bytes_limit else None,
        },
        "mesh": None,
        "model_tflops_per_step": model_tflops_per_step,
    }
    if remat:
        report["remat"] = remat
    return report


def emit_model_report(
    telemetry, state, model_tflops_per_step: float | None = None, remat: dict | None = None
) -> dict:
    """Build and emit the ``model_report`` record of a TrainState (right after the state
    is made)."""
    report = build_model_report(state.model, state.optimizer, model_tflops_per_step, remat)
    telemetry.emit_record("model_report", **report)
    totals = report["totals"]
    log_rank_0(
        logging.INFO,
        f"model report: {totals['parameters']:,} params, "
        f"{totals['param_bytes'] / 1e9:.3f} GB params + "
        f"{totals['optimizer_bytes'] / 1e9:.3f} GB optimizer state"
        + (
            f" ({100 * report['hbm']['state_fraction_of_limit']:.1f}% of the card's memory)"
            if report["hbm"]["state_fraction_of_limit"] is not None
            else ""
        ),
    )
    return report
