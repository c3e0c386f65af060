"""Deterministic fault injection for the serving fleet (the chaos-test seam).

(Copy of `dolomite_engine_tpu/serving/cluster/faults.py`: the port keeps its own, as it imports nothing of the JAX package.)

Fault tolerance that is only exercised by real hardware failures is fault tolerance
that has never run. This module makes replica failures *reproducible*: a
:class:`FaultPlan` is an explicit list of :class:`Fault` specs (or a seed-derived one
via :meth:`FaultInjector.seeded`), and an :class:`FaultInjector` installed on an
:class:`~.router.EngineReplica` fires them at exact, countable points of the replica's
lifecycle:

- ``crash``   — raise :class:`InjectedFault` in ``EngineReplica.step()`` from work-step
  N onward (sticky, modelling a dead process; the engine is never half-stepped — the
  fault fires at the step boundary, so host bookkeeping stays consistent and the
  router's recompute-based migration is bit-exact);
- ``wedge``   — block step N for ``wedge_s`` seconds before touching the engine
  (modelling a hung device call; the wedged-step watchdog in
  :class:`~.health.ReplicaHealthMonitor` is what must notice);
- ``handoff`` — raise inside :meth:`~.disagg.KVHandoff.transfer` at transfer N (the
  disaggregation seam failing mid-copy);
- ``reject``  — raise ``QueueFullError`` at submit N (a replica refusing new work, the
  router must spill to another candidate).

The injector is a **test seam with a zero-cost off path**: every instrumented site is a
single ``injector is None`` check, the same discipline as tracing — no injector, no
extra work, byte-identical behavior (asserted in tests/test_torch_serving_faults.py).

Step/submit/transfer indices count only *work* (steps where the engine had something to
do), so fault timing is independent of idle polling in threaded mode — the same plan
fires at the same engine state in synchronous and threaded drives.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from ..scheduler import QueueFullError

FAULT_KINDS = ("crash", "wedge", "handoff", "reject")


class InjectedFault(RuntimeError):
    """The exception a planned ``crash`` / ``handoff`` fault raises."""


@dataclass(frozen=True)
class Fault:
    """One planned fault on one replica. ``at`` is the zero-based work-step index for
    crash/wedge, the submit index for reject, the transfer index for handoff."""

    kind: str
    replica_id: int
    at: int = 0
    wedge_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}, expected one of {FAULT_KINDS}")
        if self.kind == "wedge" and self.wedge_s <= 0:
            raise ValueError("wedge fault needs wedge_s > 0")


@dataclass
class FiredFault:
    """Audit entry: which fault fired, where, at which index (test introspection)."""

    fault: Fault
    site: str  # "step" | "submit" | "transfer"
    index: int


class FaultInjector:
    """Fires a deterministic fault plan at a replica's instrumented sites.

    One injector may serve several replicas (faults carry their ``replica_id``); the
    per-replica site counters live here so the plan's indices are stable however the
    fleet is driven. Thread-safe: threaded replicas consult it concurrently.
    """

    def __init__(self, faults: list[Fault] | tuple[Fault, ...] = (), *, sleep=time.sleep) -> None:
        self.faults = list(faults)
        self.fired: list[FiredFault] = []
        self._sleep = sleep
        self._lock = threading.Lock()
        self._steps: dict[int, int] = {}
        self._submits: dict[int, int] = {}
        self._transfers: dict[int, int] = {}
        # crash faults are sticky (a dead process stays dead); wedge/handoff/reject
        # fire exactly once. `_recorded` keeps the audit log to one entry per fault.
        self._spent: set[int] = set()
        self._recorded: set[int] = set()

    @classmethod
    def seeded(
        cls,
        seed: int,
        replica_ids: list[int] | tuple[int, ...],
        *,
        kinds: tuple[str, ...] = ("crash",),
        count: int = 1,
        step_range: tuple[int, int] = (2, 10),
        wedge_s: float = 0.25,
    ) -> "FaultInjector":
        """Seed-derived fault plan: the same seed always yields the same faults — the
        chaos matrix is a loop over seeds, each a reproducible failure scenario."""
        gen = random.Random(seed)
        faults = [
            Fault(
                kind=gen.choice(list(kinds)),
                replica_id=gen.choice(list(replica_ids)),
                at=gen.randrange(*step_range),
                wedge_s=wedge_s,
            )
            for _ in range(count)
        ]
        return cls(faults)

    # ------------------------------------------------------------------ sites

    def _next_index(self, table: dict[int, int], replica_id: int) -> int:
        with self._lock:
            index = table.get(replica_id, 0)
            table[replica_id] = index + 1
        return index

    def _fire(self, fault_index: int, fault: Fault, site: str, index: int) -> None:
        with self._lock:
            if fault.kind != "crash":  # crash stays armed: every later step raises too
                self._spent.add(fault_index)
            if fault_index not in self._recorded:
                self._recorded.add(fault_index)
                self.fired.append(FiredFault(fault=fault, site=site, index=index))

    def on_step(self, replica_id: int) -> None:
        """Consulted by ``EngineReplica.step`` before each step that has work. May
        sleep (wedge) or raise (crash); raising here never leaves the engine
        half-stepped."""
        index = self._next_index(self._steps, replica_id)
        for i, fault in enumerate(self.faults):
            if fault.replica_id != replica_id:
                continue
            if fault.kind == "crash" and index >= fault.at:
                self._fire(i, fault, "step", index)
                raise InjectedFault(
                    f"planned crash: replica {replica_id} at work step {index} "
                    f"(armed at {fault.at})"
                )
            if fault.kind == "wedge" and index == fault.at and i not in self._spent:
                self._fire(i, fault, "step", index)
                self._sleep(fault.wedge_s)

    def on_submit(self, replica_id: int) -> None:
        """Consulted by ``EngineReplica.submit``; a ``reject`` fault raises
        QueueFullError so the router exercises its spill path."""
        index = self._next_index(self._submits, replica_id)
        for i, fault in enumerate(self.faults):
            if (
                fault.replica_id == replica_id
                and fault.kind == "reject"
                and index == fault.at
                and i not in self._spent
            ):
                self._fire(i, fault, "submit", index)
                raise QueueFullError(
                    f"planned rejection: replica {replica_id} refused submit {index}"
                )

    def on_transfer(self, replica_id: int) -> None:
        """Consulted by ``KVHandoff.transfer`` before copying pages; a ``handoff``
        fault raises, modelling the transfer seam failing mid-handoff."""
        index = self._next_index(self._transfers, replica_id)
        for i, fault in enumerate(self.faults):
            if (
                fault.replica_id == replica_id
                and fault.kind == "handoff"
                and index == fault.at
                and i not in self._spent
            ):
                self._fire(i, fault, "transfer", index)
                raise InjectedFault(
                    f"planned handoff failure: replica {replica_id} at transfer {index}"
                )


__all__ = ["FAULT_KINDS", "Fault", "FaultInjector", "FiredFault", "InjectedFault"]
