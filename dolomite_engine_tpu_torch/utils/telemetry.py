"""Always-on training telemetry: goodput accounting and the rank-tagged JSONL sink, and
the bounded latency sketches of the serving statistics.

Counterpart of `dolomite_engine_tpu/utils/telemetry.py`. The train loop feeds a goodput
breakdown per logging window (first step, dataloader wait, step, checkpoint, eval, the
rest as ``other``), steady-state MFU against the card's peak, and device-memory gauges
from `torch.cuda`; cross-module counters (checkpoint I/O retries, preemptions, loader
stalls, non-finite skips) reach the active instance through `get_telemetry`, a no-op when
no loop installed one. The records have the JAX package's kinds and keys:

    {"kind": "run_start", "ts", "rank", "schema", "devices", "device_kind",
     "peak_tflops_per_device", "model_tflops_per_step", "host", "pid", "torch_version",
     "cuda_version", "config_hash", "kernels"}
    {"kind": "step",   "ts", "rank", "step", "t": {"data", "step" | "compile"}}
    {"kind": "window", "ts", "rank", "step", "window_seconds",
     "goodput": {"compile", "data", "step", "checkpoint", "eval", "other", "goodput_pct"},
     "step_time": {"count", "mean", "min", "max"}, "mfu_pct", "tflops_per_group",
     "counters": {...}, "gauges": {...}}
    {"kind": "event",  "ts", "rank", "event", "step", ...}
    {"kind": "model_report", "ts", "rank", "param_groups", "totals", "hbm", ...}
    {"kind": "health", "ts", "rank", "step", "stats"}      # per-group norms (diagnostics.py)
    {"kind": "run_end", "ts", "rank", "step", "status", "counters"}

`run_start` names torch's and CUDA's versions where the JAX record names jax's and
jaxlib's, and its ``kernels`` maps each kernel to the path this run's device takes
(``cuda`` or ``plain``). The serving fleet reads the registry through `observe` (quantile
sketches kept in memory, never written), `counters_snapshot` / `gauges_snapshot` /
`quantiles_snapshot` / `snapshot`, and the `KNOWN_COUNTERS` / `KNOWN_EVENTS` /
`KNOWN_GAUGES` tables, whose names are the JAX package's. On-demand profiling is not ported
(ROADMAP.md Queue A, 'Serving fleet and observability').
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Any

import torch

SCHEMA_VERSION = 1

# every literal counter name used through the registry; `count(..., event=True)` names must
# additionally appear in KNOWN_EVENTS (they write an event record under the same name)
KNOWN_COUNTERS: tuple[str, ...] = (
    "nan_skips",
    "io_retries",
    "io_failures",
    "loader_stalls",
    "preemptions",
    "checkpoints_saved",
    "checkpoints_pruned",
    "loader_batches",
    "profiles_captured",
    # async input pipeline (data/prefetch.py): consumer found the prefetch queue empty at
    # a steady-state step — the background worker is not keeping up with the loop
    "prefetch_stalls",
    # serving engine (serving/engine.py)
    "serving_requests_admitted",
    "serving_requests_completed",
    "serving_requests_rejected",
    "serving_requests_cancelled",
    "serving_prefill_tokens",
    "serving_decode_tokens",
    # paged-pool prefix caching (serving/prefix_cache.py): prompt tokens whose K/V were
    # already resident (skipped prefill) vs tokens actually computed — hit rate is
    # hit / (hit + miss), rendered by tools/telemetry_summary.py
    "serving_prefix_hit_tokens",
    "serving_prefix_miss_tokens",
    # speculative decoding (serving/engine.py): draft tokens proposed by the configured
    # drafter (n-gram lookup or draft model) vs accepted by the verify step —
    # accept rate is accepted / proposed, rendered by tools/telemetry_summary.py
    "serving_draft_tokens_proposed",
    "serving_draft_tokens_accepted",
    # contention-aware scheduling (serving/engine.py): slots evicted for a higher tier
    # or for physical pages (swap or drop-and-recompute), KV pages moved out to / back
    # from the host swap pool, and admissions that reused a live session's pinned prefix
    "serving_preemptions",
    "serving_pages_swapped_out",
    "serving_pages_swapped_in",
    "serving_session_hits",
    # distributed serving router (serving/cluster/router.py): requests placed on a
    # replica / shed at the fleet-wide admission bound / routed by prefix affinity
    "router_requests_routed",
    "router_requests_rejected",
    "router_prefix_affinity_hits",
    # fleet fault tolerance (serving/cluster/router.py + health.py): replicas declared
    # dead (crash/wedge/thread death), in-flight requests migrated to a survivor,
    # requests cancelled under capacity loss (lowest tier first), and completed
    # drain_replica operations
    "router_replica_crashes",
    "router_requests_rerouted",
    "router_requests_shed",
    "router_drains",
    # prefill/decode disaggregation (serving/cluster/disagg.py): KV page transfers from
    # a prefill worker's pool into a decode worker's pool
    "cluster_kv_handoffs",
)

KNOWN_EVENTS: tuple[str, ...] = (
    "nan_skips",
    "io_failures",
    "loader_stalls",
    "preemptions",
    "profile_start",
    "profiles_captured",
    "anomaly",
    # serving-fleet fault tolerance (serving/cluster/health.py + router.py): one event
    # per downward health edge, per completed drain/rejoin, and when a threaded
    # Router.wait timed out with work still pending (fields name who/why)
    "replica_suspect",
    "replica_dead",
    "replica_drained",
    "replica_rejoined",
    "router_wait_incomplete",
)

# every literal gauge name set through the registry (dynamic names — the per-device
# memory/host-RSS fan-out in collect_memory_gauges — are exempt, same rule as counters).
# The three tables keep the JAX package's names, so both `/metrics` pages list the same series
KNOWN_GAUGES: tuple[str, ...] = (
    # async input pipeline (data/prefetch.py): queue occupancy after each consumed batch
    "prefetch/queue_depth",
    # serving engine (serving/engine.py)
    "serving/queue_depth",
    "serving/slot_occupancy",
    # paged KV pool (serving/kv_cache.py): physical pages referenced by slots/prefix
    # index, and the fraction of allocated page capacity not holding valid tokens
    "serving/pages_in_use",
    "serving/page_fragmentation",
    # resident K/V bytes per cached token (all layers; quantized pools include their
    # per-page scale rows amortized over the page) — halves under kv_dtype=bf16 vs
    # fp32 and halves again under int8/fp8
    "serving/kv_bytes_per_token",
    # speculative decoding (serving/engine.py): cumulative draft acceptance rate and
    # accepted draft tokens per verify step (only written when speculation is enabled)
    "serving/accept_rate",
    "serving/accepted_tokens_per_step",
    # distributed serving (serving/cluster/): fleet-wide waiting requests across all
    # replicas, and the latest prefill->decode KV handoff wall time
    "router/queue_depth",
    "cluster/handoff_latency_ms",
    # fleet fault tolerance (serving/cluster/router.py): replicas whose health state
    # is `healthy` (suspect/dead/parked excluded); only written when health
    # monitoring is on
    "router/replicas_healthy",
)

# goodput buckets, in reporting order; "other" is the window remainder (python overhead,
# logging, host syncs) and is derived, never accumulated directly
GOODPUT_BUCKETS = ("compile", "data", "step", "checkpoint", "eval")

# pre-seeded at 0 in every Telemetry so window records always carry the full
# fault-tolerance set
CANONICAL_COUNTERS = (
    "nan_skips",
    "io_retries",
    "io_failures",
    "loader_stalls",
    "preemptions",
    "checkpoints_saved",
    "checkpoints_pruned",
)

# bf16 dense peak TFLOP/s per card, by a substring of `torch.cuda.get_device_name`: the
# H100 SXM (NVIDIA's data sheet, at the 700 W limit)
_PEAK_TFLOPS_BY_NAME: tuple[tuple[str, float], ...] = (("h100 80gb hbm3", 989.0),)


def nearest_rank(ordered, q: float):
    """Nearest-rank quantile over an already-sorted sequence (the serving engine's p99
    convention: rank = ceil(q * n), clamped into range). None on empty input."""
    n = len(ordered)
    if n == 0:
        return None
    rank = min(n - 1, max(0, int(-(-q * n // 1)) - 1))
    return ordered[rank]


class QuantileSketch:
    """Bounded nearest-rank quantile sketch: fixed-size uniform reservoir + exact running
    count/sum.

    A long-running serve holds at most ``capacity`` floats per series while quantile
    queries stay nearest-rank over a uniform subsample. Below capacity the reservoir *is*
    the full stream in insertion order, so ``mean()``/``quantile()`` equal the exact
    list-based computation. Replacement uses a deterministic 64-bit LCG seeded per
    sketch, so results are reproducible for a given insertion order without touching any
    global RNG.

    Not thread-safe on its own; :meth:`Telemetry.observe` wraps it in the registry lock.
    """

    __slots__ = ("capacity", "values", "count", "total", "_rng")

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"QuantileSketch capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.values: list[float] = []
        self.count = 0  # samples offered over the stream's lifetime
        self.total = 0.0  # exact running sum (mean never degrades to the subsample's)
        self._rng = 0x9E3779B97F4A7C15

    def append(self, value: float) -> None:
        """Offer one sample (named ``append`` so it drops into list call sites)."""
        value = float(value)
        self.count += 1
        self.total += value
        if len(self.values) < self.capacity:
            self.values.append(value)
            return
        # algorithm R: replace a random retained sample with probability capacity/count
        self._rng = (self._rng * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        slot = self._rng % self.count
        if slot < self.capacity:
            self.values[slot] = value

    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def quantile(self, q: float) -> float | None:
        return nearest_rank(sorted(self.values), q)

    def snapshot(self) -> dict[str, float | int | None]:
        ordered = sorted(self.values)
        return {
            "count": self.count,
            "mean": self.mean(),
            "p50": nearest_rank(ordered, 0.50),
            "p90": nearest_rank(ordered, 0.90),
            "p99": nearest_rank(ordered, 0.99),
        }

    def __len__(self) -> int:
        return len(self.values)

    def __iter__(self):
        return iter(self.values)

    def __bool__(self) -> bool:
        return bool(self.values)


def detect_peak_tflops_per_device(device: torch.device | str | None = None) -> float | None:
    """The card's peak bf16 TFLOP/s for MFU. `DOLOMITE_PEAK_TFLOPS_PER_DEVICE` overrides;
    None for a CPU or a card not in the table (MFU is then left out, not made up)."""
    env = os.environ.get("DOLOMITE_PEAK_TFLOPS_PER_DEVICE")
    if env:
        return float(env)
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    for pattern, peak in _PEAK_TFLOPS_BY_NAME:
        if pattern in name:
            return peak
    return None


def collect_memory_gauges(device: torch.device | str | None = None) -> dict[str, int]:
    """Device-memory gauges from `torch.cuda` (none for a CPU device) and the host's peak
    RSS."""
    gauges: dict[str, int] = {}
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda" and torch.cuda.is_available():
        index = device.index if device.index is not None else torch.cuda.current_device()
        gauges[f"device{index}/bytes_in_use"] = int(torch.cuda.memory_allocated(index))
        gauges[f"device{index}/peak_bytes_in_use"] = int(torch.cuda.max_memory_allocated(index))
        gauges[f"device{index}/bytes_limit"] = int(torch.cuda.get_device_properties(index).total_memory)
    import resource

    # ru_maxrss is KiB on Linux
    gauges["host/peak_rss_bytes"] = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    return gauges


def step_annotation(step: int):
    """Label one train step in captured traces."""
    return torch.profiler.record_function(f"train_step#{step}")


def trace_annotation(name: str):
    """Named scope in captured traces (dataloader fetch, checkpoint save, eval) matching
    the goodput bucket names."""
    return torch.profiler.record_function(name)


def kernel_paths(device: torch.device) -> dict[str, str]:
    from ..ops.kernels import KERNELS

    path = "cuda" if device.type == "cuda" else "plain"
    return {spec.name: path for spec in KERNELS}


class Telemetry:
    """Process-local metrics registry -> JSONL sink.

    Counters are cumulative over the run (thread-safe: the stall watchdog counts from its
    thread); gauges are last-value-wins; the goodput buckets accumulate seconds within the
    current logging window and reset at :meth:`emit_window`. The first
    :meth:`record_step` of a run goes to the ``compile`` bucket (first-call warm-up: kernel
    builds, allocator growth) and is left out of the steady-state step times and MFU.
    """

    def __init__(
        self,
        sink_path: str | None = None,
        experiments_tracker=None,
        model_tflops_per_step: float | None = None,
        peak_tflops_per_device: float | None = None,
        devices_per_group: int = 1,
        device: torch.device | str = "cpu",
        rank: int | None = None,
        config_hash: str | None = None,
    ) -> None:
        from .logger import process_index

        self.rank = process_index() if rank is None else rank
        self.device = torch.device(device)
        self.experiments_tracker = experiments_tracker
        self.model_tflops_per_step = model_tflops_per_step
        self.peak_tflops_per_device = peak_tflops_per_device
        self.devices_per_group = max(int(devices_per_group), 1)
        self.sink_path = sink_path

        self._lock = threading.Lock()
        self.counters: dict[str, int] = {name: 0 for name in CANONICAL_COUNTERS}
        self.gauges: dict[str, Any] = {}
        self._sketches: dict[str, QuantileSketch] = {}
        self._buckets: dict[str, float] = {k: 0.0 for k in GOODPUT_BUCKETS}
        self._step_times: list[float] = []
        self._window_start = time.perf_counter()
        self._seen_first_step = False
        self._last_step = 0

        self._file = None
        if sink_path is not None:
            sink_dir = os.path.dirname(sink_path)
            if sink_dir:
                os.makedirs(sink_dir, exist_ok=True)
            self._file = open(sink_path, "a")

        on_card = self.device.type == "cuda"
        self._emit(
            {
                "kind": "run_start",
                "schema": SCHEMA_VERSION,
                "devices": torch.cuda.device_count() if on_card else 1,
                "device_kind": torch.cuda.get_device_name(self.device) if on_card else "cpu",
                "peak_tflops_per_device": peak_tflops_per_device,
                "model_tflops_per_step": model_tflops_per_step,
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "torch_version": torch.__version__,
                "cuda_version": torch.version.cuda,
                "config_hash": config_hash,
                "kernels": kernel_paths(self.device),
            }
        )

    def _emit(self, record: dict) -> None:
        """One record = one line, flushed at once, written under the lock."""
        if self._file is None:
            return
        record = {"ts": round(time.time(), 3), "rank": self.rank, **record}
        line = json.dumps(record, default=str)
        with self._lock:
            if self._file is not None and not self._file.closed:
                self._file.write(line + "\n")
                self._file.flush()

    def count(self, name: str, value: int = 1, event: bool = False, step: int | None = None) -> None:
        """Increment a cumulative counter; `event=True` also writes an event record at once
        (for increments whose process may die before the next window)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value
        if event:
            self.event(name, step=step, total=self.counters[name])

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """Offer one latency or duration sample to the named in-memory quantile sketch
        (TTFT, ITL, step time). Nothing is written to the sink, so the serving engine feeds
        these unconditionally; non-finite samples are dropped (a NaN would poison the
        running sum)."""
        value = float(value)
        if value != value or value in (float("inf"), float("-inf")):
            return
        with self._lock:
            sketch = self._sketches.get(name)
            if sketch is None:
                sketch = self._sketches[name] = QuantileSketch()
            sketch.append(value)

    # point-in-time copies under the registry lock, which the observability server
    # (serving/obs_server.py) reads from its HTTP thread while engines keep writing

    def counters_snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def gauges_snapshot(self) -> dict[str, Any]:
        with self._lock:
            return dict(self.gauges)

    def quantiles_snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {name: sketch.snapshot() for name, sketch in self._sketches.items()}

    def snapshot(self) -> dict[str, dict]:
        """Counters, gauges and quantile summaries in one locked pass."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "quantiles": {name: sketch.snapshot() for name, sketch in self._sketches.items()},
            }

    def event(self, name: str, step: int | None = None, **fields) -> None:
        record = {"kind": "event", "event": name}
        if step is not None:
            record["step"] = step
        record.update(fields)
        self._emit(record)

    def emit_record(self, kind: str, step: int | None = None, **fields) -> None:
        record: dict[str, Any] = {"kind": kind}
        if step is not None:
            record["step"] = step
        record.update(fields)
        self._emit(record)

    @contextmanager
    def timer(self, bucket: str):
        """Accumulate a wall-clock scope into a goodput bucket (checkpoint saves, eval)."""
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self._buckets[bucket] = self._buckets.get(bucket, 0.0) + elapsed

    def record_step(self, step: int, data_seconds: float, step_seconds: float) -> None:
        """Per-step accounting: dataloader wait + step wall time (the step ends in the
        host's read of its loss)."""
        self._last_step = step
        timings: dict[str, float] = {"data": round(data_seconds, 6)}
        with self._lock:
            self._buckets["data"] += data_seconds
            if not self._seen_first_step:
                self._seen_first_step = True
                self._buckets["compile"] += step_seconds
                timings["compile"] = round(step_seconds, 6)
            else:
                self._buckets["step"] += step_seconds
                self._step_times.append(step_seconds)
                timings["step"] = round(step_seconds, 6)
        self._emit({"kind": "step", "step": step, "t": timings})

    def current_mfu(self) -> float | None:
        """Steady-state MFU %% over the current window: analytic model TFLOPs per step /
        mean step time, against the group's peak. None before a steady step or when a
        peak or the model FLOPs are unknown."""
        if not self.model_tflops_per_step or not self.peak_tflops_per_device:
            return None
        with self._lock:
            if not self._step_times:
                return None
            mean_step = sum(self._step_times) / len(self._step_times)
        achieved = self.model_tflops_per_step / mean_step
        return 100.0 * achieved / (self.peak_tflops_per_device * self.devices_per_group)

    def emit_window(self, step: int) -> dict | None:
        """Close the current logging window: write the window record, fan scalars out to
        the experiments tracker, reset the window accumulators."""
        now = time.perf_counter()
        mfu = self.current_mfu()
        for name, value in collect_memory_gauges(self.device).items():
            self.gauge(name, value)
        with self._lock:
            wall = max(now - self._window_start, 1e-9)
            buckets = {k: round(self._buckets.get(k, 0.0), 6) for k in GOODPUT_BUCKETS}
            accounted = sum(buckets.values())
            buckets["other"] = round(max(wall - accounted, 0.0), 6)
            buckets["goodput_pct"] = round(100.0 * self._buckets["step"] / wall, 3)
            step_times = self._step_times
            step_stats = None
            if step_times:
                step_stats = {
                    "count": len(step_times),
                    "mean": round(sum(step_times) / len(step_times), 6),
                    "min": round(min(step_times), 6),
                    "max": round(max(step_times), 6),
                }
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            self._buckets = {k: 0.0 for k in GOODPUT_BUCKETS}
            self._step_times = []
            self._window_start = now

        tflops_per_group = None
        if self.model_tflops_per_step and step_stats:
            tflops_per_group = round(self.model_tflops_per_step / step_stats["mean"], 3)
        record = {
            "kind": "window",
            "step": step,
            "window_seconds": round(wall, 6),
            "goodput": buckets,
            "step_time": step_stats,
            "mfu_pct": round(mfu, 3) if mfu is not None else None,
            "tflops_per_group": tflops_per_group,
            "counters": counters,
            "gauges": gauges,
        }
        self._emit(record)

        if self.experiments_tracker is not None:
            scalars = {f"goodput/{k}_seconds": v for k, v in buckets.items() if k != "goodput_pct"}
            scalars["goodput/goodput_pct"] = buckets["goodput_pct"]
            if mfu is not None:
                scalars["goodput/mfu_pct"] = round(mfu, 3)
            for name, value in counters.items():
                scalars[f"counter/{name}"] = value
            for name, value in gauges.items():
                if isinstance(value, (int, float)):
                    scalars[f"gauge/{name}"] = value
            self.experiments_tracker.track(scalars, step=step, context="telemetry")
        return record

    def close(self, status: str = "ok") -> None:
        """End of run: the run_end record with how it ended (``ok``, ``preempted`` or
        ``error:<ExceptionType>``), then close the sink."""
        self._emit({"kind": "run_end", "step": self._last_step, "status": status, "counters": dict(self.counters)})
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


class _NullTelemetry:
    """No-op stand-in returned by :func:`get_telemetry` when no train loop installed a real
    instance."""

    rank = 0
    counters: dict[str, int] = {}

    def count(self, name, value=1, event=False, step=None) -> None:
        pass

    def gauge(self, name, value) -> None:
        pass

    def event(self, name, step=None, **fields) -> None:
        pass

    def emit_record(self, kind, step=None, **fields) -> None:
        pass

    def observe(self, name, value) -> None:
        pass

    def counters_snapshot(self) -> dict:
        return {}

    def gauges_snapshot(self) -> dict:
        return {}

    def quantiles_snapshot(self) -> dict:
        return {}

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "quantiles": {}}

    def timer(self, bucket):
        return nullcontext()

    def record_step(self, step, data_seconds, step_seconds) -> None:
        pass

    def current_mfu(self):
        return None

    def emit_window(self, step):
        return None

    def close(self, status: str = "ok") -> None:
        pass


_NULL = _NullTelemetry()
_ACTIVE: Telemetry | None = None


def install_telemetry(telemetry: Telemetry) -> None:
    """Make `telemetry` the process-wide instance cross-module counters report to."""
    global _ACTIVE
    _ACTIVE = telemetry


def uninstall_telemetry() -> None:
    global _ACTIVE
    _ACTIVE = None


def get_telemetry() -> Telemetry | _NullTelemetry:
    """The active instance, or a shared no-op when none is installed."""
    return _ACTIVE if _ACTIVE is not None else _NULL


def stable_config_hash(args) -> str:
    """Short stable hash of the resolved config tree."""
    blob = json.dumps(args.to_dict(), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def build_telemetry(
    args,
    experiments_tracker=None,
    model_tflops_per_step: float | None = None,
    devices_per_group: int = 1,
    device: torch.device | str = "cpu",
) -> Telemetry:
    """Telemetry from `args.logging_args.telemetry`. The default sink hangs off
    `save_args.save_path`: ``<save_path>/telemetry/rank-<process>.jsonl``."""
    from .logger import process_index

    targs = args.logging_args.telemetry
    sink_path = None
    if targs.jsonl_sink:
        sink_path = targs.jsonl_path
        if sink_path is None and args.save_args.save_path is not None:
            sink_path = os.path.join(args.save_args.save_path, "telemetry", f"rank-{process_index():05d}.jsonl")
    return Telemetry(
        sink_path=sink_path,
        experiments_tracker=experiments_tracker,
        model_tflops_per_step=model_tflops_per_step,
        peak_tflops_per_device=targs.peak_tflops_per_device or detect_peak_tflops_per_device(device),
        devices_per_group=devices_per_group,
        device=device,
        config_hash=stable_config_hash(args),
    )
