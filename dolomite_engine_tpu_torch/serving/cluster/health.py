"""Replica health tracking: step-progress heartbeats, exception counting, wedge watchdog.

(Copy of `dolomite_engine_tpu/serving/cluster/health.py`: the port keeps its own, as it imports nothing of the JAX package.)

The training tier's :class:`~...utils.fault_tolerance.StallWatchdog` answers "did this
blocking call hang?" with a dedicated worker thread per guarded call. A serving fleet
needs the inverted shape — many replicas, one observer — so the monitor keeps
per-replica heartbeat records that the :class:`~.router.Router` sweeps from its own
driving loop (`step`/`wait`/`drain`): no watchdog threads, and the same code path works
for synchronous and threaded replicas.

Health is a three-state ladder, each downward edge emitting a telemetry event:

- **healthy** — steps complete, exceptions reset the ladder on the next success;
- **suspect** — a step raised (fewer than ``max_consecutive_exceptions`` times in a
  row), or an in-progress step has been running longer than ``suspect_after_s``
  (possibly just slow); suspect replicas still route and step — the state is a warning,
  not a verdict;
- **dead** — ``max_consecutive_exceptions`` consecutive raises, an in-progress step
  older than ``dead_after_s`` (wedged), or a replica worker thread death reported via
  :meth:`mark_dead`. Dead is terminal until :meth:`reset` (replica rejoin): the router
  stops routing to it and migrates its in-flight work
  (:meth:`~.router.Router.drain_replica` reuses the same machinery).

A replica whose step raised may hold corrupt device state (the engine's device steps
write its pools in place), which is why recovery *re-routes* instead of retrying in place:
the consecutive-exception threshold only tolerates faults that happen *between* engine
mutations (submit-time rejections, transfer setup), never a resumed half-step.

Instantiating a monitor is opt-in (``Router(health=...)``); without one, every hook
site is a single ``monitor is None`` check — the tracing off-path discipline.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass
from typing import Callable

from ...utils.telemetry import get_telemetry


class ReplicaHealth(str, enum.Enum):
    healthy = "healthy"
    suspect = "suspect"
    dead = "dead"

    def __str__(self) -> str:  # plain value in records/logs
        return self.value


@dataclass
class _ReplicaRecord:
    state: ReplicaHealth = ReplicaHealth.healthy
    step_started: float | None = None  # heartbeat: a step is in progress since then
    last_progress: float = 0.0
    consecutive_exceptions: int = 0
    last_error: str | None = None


class ReplicaHealthMonitor:
    """Shared health ledger for a replica fleet (see module docs).

    Replica step loops call :meth:`begin_step`/:meth:`end_step` (one heartbeat per work
    step); the router calls :meth:`sweep` from its driving loop to run the wedged-step
    watchdog and drain newly-dead replica ids. All methods are thread-safe — threaded
    replicas heartbeat concurrently with the router's sweep.
    """

    def __init__(
        self,
        *,
        max_consecutive_exceptions: int = 2,
        suspect_after_s: float = 1.0,
        dead_after_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if max_consecutive_exceptions < 1:
            raise ValueError("max_consecutive_exceptions must be >= 1")
        if dead_after_s < suspect_after_s:
            raise ValueError(
                f"dead_after_s ({dead_after_s}) must be >= suspect_after_s ({suspect_after_s})"
            )
        self.max_consecutive_exceptions = max_consecutive_exceptions
        self.suspect_after_s = suspect_after_s
        self.dead_after_s = dead_after_s
        self.clock = clock
        self._lock = threading.Lock()
        self._records: dict[int, _ReplicaRecord] = {}
        # dead transitions queued for the router's next sweep (exception-driven deaths
        # happen on replica threads; the router must not learn about them mid-submit)
        self._pending_dead: list[int] = []

    # ------------------------------------------------------------------ registry

    def register(self, replica_id: int) -> None:
        with self._lock:
            self._records.setdefault(
                replica_id, _ReplicaRecord(last_progress=self.clock())
            )

    def state(self, replica_id: int) -> ReplicaHealth:
        with self._lock:
            record = self._records.get(replica_id)
            return record.state if record is not None else ReplicaHealth.healthy

    def states(self) -> dict[int, ReplicaHealth]:
        with self._lock:
            return {rid: record.state for rid, record in sorted(self._records.items())}

    def is_routable(self, replica_id: int) -> bool:
        """Suspect replicas still route (a slow step is not a verdict); dead never."""
        return self.state(replica_id) is not ReplicaHealth.dead

    # ------------------------------------------------------------------ heartbeats

    def begin_step(self, replica_id: int) -> None:
        with self._lock:
            record = self._records.setdefault(replica_id, _ReplicaRecord())
            record.step_started = self.clock()

    def end_step(self, replica_id: int, error: BaseException | None = None) -> None:
        """Close a heartbeat. A successful step resets the exception ladder (and a
        merely-slow suspect back to healthy); a raising step climbs it. A step that
        *completed* but took longer than ``dead_after_s`` counts as a wedge too — in
        synchronous fleets nothing can sweep while the step blocks the driving
        thread, so the verdict has to land at the step boundary."""
        events: list[tuple[str, dict]] = []
        with self._lock:
            record = self._records.setdefault(replica_id, _ReplicaRecord())
            started, record.step_started = record.step_started, None
            record.last_progress = self.clock()
            if record.state is ReplicaHealth.dead:
                return  # terminal until reset(); a late wedged-step wake-up changes nothing
            took = None if started is None else record.last_progress - started
            if error is None and took is not None and took >= self.dead_after_s:
                record.last_error = f"step wedged for {took:.3f}s (completed late)"
                events = self._degrade_locked(
                    replica_id, record, to_dead=True, reason=record.last_error
                )
            elif error is None:
                record.consecutive_exceptions = 0
                record.last_error = None
                record.state = ReplicaHealth.healthy
                return
            else:
                record.consecutive_exceptions += 1
                record.last_error = repr(error)
                events = self._degrade_locked(
                    replica_id,
                    record,
                    to_dead=record.consecutive_exceptions
                    >= self.max_consecutive_exceptions,
                    reason=f"step raised: {error!r}",
                )
        self._emit(events)

    def mark_dead(self, replica_id: int, reason: str) -> None:
        """Force a replica dead (a worker thread died sticky — there will be no more
        heartbeats for the threshold to count)."""
        with self._lock:
            record = self._records.setdefault(replica_id, _ReplicaRecord())
            record.last_error = reason
            events = self._degrade_locked(replica_id, record, to_dead=True, reason=reason)
        self._emit(events)

    def reset(self, replica_id: int) -> None:
        """Return a replica to healthy (rejoin after drain / engine replacement)."""
        with self._lock:
            self._records[replica_id] = _ReplicaRecord(last_progress=self.clock())
            if replica_id in self._pending_dead:
                self._pending_dead.remove(replica_id)

    # ------------------------------------------------------------------ watchdog

    def sweep(self) -> list[int]:
        """Run the wedged-step watchdog and drain newly-dead replica ids. Called by the
        router from its driving loop; each dead replica is returned exactly once."""
        now = self.clock()
        events: list[tuple[str, dict]] = []
        with self._lock:
            for replica_id, record in self._records.items():
                if record.state is ReplicaHealth.dead or record.step_started is None:
                    continue
                stalled = now - record.step_started
                if stalled >= self.dead_after_s:
                    record.last_error = f"step wedged for {stalled:.3f}s"
                    events += self._degrade_locked(
                        replica_id, record, to_dead=True, reason=record.last_error
                    )
                elif stalled >= self.suspect_after_s:
                    events += self._degrade_locked(
                        replica_id,
                        record,
                        to_dead=False,
                        reason=f"step slow for {stalled:.3f}s",
                    )
            dead, self._pending_dead = self._pending_dead, []
        self._emit(events)
        return dead

    # ------------------------------------------------------------------ internals

    def _degrade_locked(
        self, replica_id: int, record: _ReplicaRecord, *, to_dead: bool, reason: str
    ) -> list[tuple[str, dict]]:
        """Walk the ladder downward (healthy -> suspect -> dead), collecting one
        telemetry event per edge; emission happens outside the lock."""
        events: list[tuple[str, dict]] = []
        if record.state is ReplicaHealth.healthy:
            record.state = ReplicaHealth.suspect
            events.append(("replica_suspect", {"replica_id": replica_id, "reason": reason}))
        if to_dead and record.state is ReplicaHealth.suspect:
            record.state = ReplicaHealth.dead
            self._pending_dead.append(replica_id)
            events.append(("replica_dead", {"replica_id": replica_id, "reason": reason}))
        return events

    def _emit(self, events: list[tuple[str, dict]]) -> None:
        if not events:
            return
        telemetry = get_telemetry()
        for name, fields in events:
            if name == "replica_suspect":
                telemetry.event("replica_suspect", **fields)
            else:
                telemetry.event("replica_dead", **fields)


__all__ = ["ReplicaHealth", "ReplicaHealthMonitor"]
