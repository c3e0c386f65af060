"""Telemetry-driven request router over N engine replicas, with fleet fault tolerance.

(Copy of `dolomite_engine_tpu/serving/cluster/router.py`: the port keeps its own, as it imports nothing of the JAX package.)

The router is the batch-parallel layer of the serving tier: each replica is a whole
engine (single-device, TP-sharded, or disaggregated) owning its own KV pool and queue;
the router does admission control and replica selection using the same signals the
engines already export as serving telemetry:

- **session affinity first**: a request carrying a ``session_id`` goes back to the
  replica that served the session's previous turn (tracked router-side with the same
  TTL discipline as the engines' session pins) — that replica's prefix index holds the
  conversation's pinned pages, so the turn re-attaches instead of re-prefilling;
- **prefix affinity next**: the replica whose prefix index holds the longest resident
  prefix for the prompt (probed side-effect-free via `prefix_match_len`) wins when the
  match covers at least one full KV page — re-prefilling a resident prefix elsewhere
  costs more than any load imbalance at page granularity;
- **least-loaded otherwise**: (queue depth, slot occupancy) lexicographic, replica id as
  the deterministic tie-break;
- **admission control**: a replica at its queue bound is skipped; when every replica is
  full the router rejects (`QueueFullError`) instead of buffering unboundedly — exactly
  the engine's own backpressure contract, one level up.

Replicas step either synchronously (`Router.step`/`drain` — deterministic, what the
tests and batch drivers use) or on background threads (`start`/`wait`/`stop` — the
CPU-testable proof-of-concept of independently-running replicas; per-replica locks keep
submit and step serialized per engine).

Fault tolerance (docs/FAULT_TOLERANCE.md "Serving fleet"): with a
:class:`~.health.ReplicaHealthMonitor` installed (``Router(health=...)``), every replica
step is heartbeated and a replica that crashes, wedges, or loses its worker thread walks
healthy -> suspect -> dead. A dead replica is quarantined — the router stops routing to
it — and **every in-flight request it held is re-routed** to a surviving replica: the
request's committed tokens re-enter through the drop-and-recompute resume primitive
(`ServingEngine.adopt_inflight`), so the adoptive replica re-prefills the prefix through
its radix cache and continues greedy **bit-exact** (sampled streams too — the sampling
generator continues from the state the request carries). Re-routing has a bounded per-request attempt budget
with backoff; when the surviving fleet genuinely lacks capacity the lowest tiers are
shed (cancelled via ``on_finish``) instead of failing the fleet. Sticky sessions re-pin
to the adoptive replica. `drain_replica`/`rejoin_replica` reuse the same migration
machinery for planned maintenance (rolling weight updates via
`ServingEngine.swap_params`). Without a monitor every hook is one ``None`` check and
behavior is byte-identical to the health-unaware router (asserted in
tests/test_torch_serving_faults.py).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

from ...utils.telemetry import get_telemetry
from ...utils.tracing import RequestTrace
from ..scheduler import QueueFullError, RequestState, RequestStatus
from .disagg import DisaggregatedEngine
from .health import ReplicaHealthMonitor


class NoLiveReplicasError(RuntimeError):
    """Raised when every replica in the fleet is dead or parked — there is nowhere to
    route; distinct from QueueFullError (live but full: retry later)."""


class DrainTimeoutError(RuntimeError):
    """`Router.drain(timeout_s=...)` gave up — the message names the stuck replicas
    and their in-flight request ids."""


@dataclass
class RouterStats:
    routed: int = 0
    rejected: int = 0
    affinity_hits: int = 0
    session_affinity_hits: int = 0
    per_replica_routed: dict[int, int] = field(default_factory=dict)
    # fleet fault tolerance (all zero when health monitoring is off and no fault fired)
    replica_crashes: int = 0
    rerouted: int = 0  # in-flight requests adopted by a surviving replica
    reroute_retries: int = 0  # extra placement attempts beyond each request's first
    shed: int = 0  # cancelled under capacity loss (lowest tier first)
    drains: int = 0  # completed drain_replica operations

    def affinity_hit_rate(self) -> float | None:
        return self.affinity_hits / self.routed if self.routed else None


class EngineReplica:
    """One routable engine (ServingEngine or DisaggregatedEngine) plus its worker thread.

    The lock serializes `submit` (router thread) against `step` (replica thread) — the
    engines are host-side single-threaded by design. In synchronous mode the lock is
    uncontended and free.

    Failure seams: a worker-thread exception is captured **sticky** and re-raised at
    the next `step()` (and by `Router.wait`) instead of dying silently; with a health
    monitor attached the thread death is reported via `mark_dead` so the router
    migrates the replica's work. ``fault_injector`` installs a deterministic chaos
    plan (serving/cluster/faults.py) — both seams are a single ``None`` check when
    unused, the tracing off-path discipline.
    """

    def __init__(self, replica_id: int, engine: Any, fault_injector=None) -> None:
        self.replica_id = replica_id
        self.engine = engine
        # stamp the id on every underlying engine so their serving records carry it
        if isinstance(engine, DisaggregatedEngine):
            engine.prefill.replica_id = replica_id
            for worker in engine.workers:
                worker.replica_id = replica_id
        else:
            engine.replica_id = replica_id
        self.fault_injector = fault_injector
        if fault_injector is not None and isinstance(engine, DisaggregatedEngine):
            # a planned `handoff` fault fires inside the KV transfer seam
            engine.handoff.fault_injector = fault_injector
            engine.handoff.replica_id = replica_id
        self.monitor: ReplicaHealthMonitor | None = None  # set by Router(health=...)
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._error: BaseException | None = None  # sticky worker-thread failure
        # quarantined = the router declared this replica dead (or parked it) and
        # migrated its work; a late-waking wedged thread must not step requests that
        # now run elsewhere
        self._quarantined = False

    # ------------------------------------------------------------------ signals

    @property
    def queue_depth(self) -> int:
        engine = self.engine
        if isinstance(engine, DisaggregatedEngine):
            return engine.queue_depth
        return engine.scheduler.queue_depth

    @property
    def occupancy(self) -> float:
        engine = self.engine
        if isinstance(engine, DisaggregatedEngine):
            return engine.occupancy
        return engine.pool.occupancy

    @property
    def slots_active(self) -> int:
        engine = self.engine
        if isinstance(engine, DisaggregatedEngine):
            return sum(w.pool.num_active for w in engine.workers)
        return engine.pool.num_active

    @property
    def page_size(self) -> int:
        engine = self.engine
        pool = engine.prefill.pool if isinstance(engine, DisaggregatedEngine) else engine.pool
        return getattr(pool, "page_size", 0)

    @property
    def error(self) -> BaseException | None:
        """The sticky failure that killed this replica's worker thread, if any."""
        return self._error

    def prefix_match_len(self, prompt_ids: list[int]) -> int:
        with self._lock:
            return self.engine.prefix_match_len(prompt_ids)

    def load(self) -> tuple[int, float, int]:
        return (self.queue_depth, self.occupancy, self.replica_id)

    # ------------------------------------------------------------------ driving

    def submit(self, **spec: Any) -> RequestState:
        if self.fault_injector is not None:
            self.fault_injector.on_submit(self.replica_id)
        with self._lock:
            return self.engine.submit(**spec)

    def step(self) -> bool:
        if self._error is not None:
            raise self._error  # sticky: a crashed replica fails loudly, never silently
        if self._quarantined:
            return False
        injector, monitor = self.fault_injector, self.monitor
        if injector is None and monitor is None:  # the off path, byte-identical
            with self._lock:
                if not self.engine.has_work():
                    return False
                return bool(self.engine.step())
        with self._lock:
            has_work = self.engine.has_work()
        if not has_work:
            return False
        if monitor is not None:
            monitor.begin_step(self.replica_id)
        error: BaseException | None = None
        try:
            if injector is not None:
                # fires OUTSIDE the lock: a wedge must not block submit/probe/release
                # on this replica's lock, and a crash fires at the step boundary so
                # the engine is never left half-stepped
                injector.on_step(self.replica_id)
            if self._quarantined:
                # woke from a wedge after the watchdog declared us dead: our work has
                # been migrated — stepping it here would double-run requests
                return False
            with self._lock:
                if self.engine.has_work():
                    self.engine.step()
            return True
        except BaseException as exc:
            error = exc
            raise
        finally:
            if monitor is not None:
                monitor.end_step(self.replica_id, error=error)

    def has_work(self) -> bool:
        return self.engine.has_work()

    def start(self) -> None:
        assert self._thread is None, "replica thread already running"
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    worked = self.step()
                except BaseException as exc:  # noqa: BLE001 — sticky capture by design
                    # capture sticky and report, instead of dying silently while the
                    # router keeps routing here: the next step()/Router.wait re-raises;
                    # with a monitor the router migrates our in-flight work
                    self._error = exc
                    if self.monitor is not None:
                        self.monitor.mark_dead(
                            self.replica_id, f"replica thread died: {exc!r}"
                        )
                    return
                if not worked:
                    time.sleep(0.002)  # idle: yield instead of spinning on the lock

        self._thread = threading.Thread(
            target=loop, name=f"replica-{self.replica_id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------ recovery

    def quarantine(self) -> None:
        """Take this replica out of service without joining its thread (it may be
        wedged mid-step; the flag stops it from stepping migrated work if it wakes)."""
        self._quarantined = True
        self._stop.set()

    def reset_failure(self) -> None:
        """Clear the sticky failure + quarantine (rejoin after repair/drain)."""
        self._error = None
        self._quarantined = False

    def release_inflight(self) -> list[RequestState]:
        with self._lock:
            return self.engine.release_inflight()

    def adopt_inflight(self, state: RequestState) -> None:
        with self._lock:
            self.engine.adopt_inflight(state)

    def inflight_request_ids(self) -> list[int]:
        with self._lock:
            return self.engine.inflight_request_ids()

    def swap_params(self, params) -> None:
        with self._lock:
            self.engine.swap_params(params)


class Router:
    """Admission control + replica selection over a replica fleet (see module docs)."""

    def __init__(
        self,
        replicas: list[EngineReplica],
        *,
        record_interval: int = 0,
        session_ttl_s: float = 300.0,
        clock=time.monotonic,
        trace_requests: bool = False,
        health: ReplicaHealthMonitor | None = None,
        reroute_attempts: int = 3,
        reroute_backoff_s: float = 0.05,
        reroute_backoff_max_s: float = 1.0,
        metrics: Any = None,
        slo_monitor: Any = None,
        flight_recorder: Any = None,
    ) -> None:
        if not replicas:
            raise ValueError("router needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        if reroute_attempts < 1:
            raise ValueError("reroute_attempts must be >= 1")
        self.replicas = replicas
        self.record_interval = record_interval
        self.session_ttl_s = session_ttl_s
        self.clock = clock
        # per-request tracing (utils/tracing.py): the router opens the trace — so the
        # placement decision itself is a span — and hands it down through submit; the
        # engine that finishes the request emits the single trace record. Zero-cost
        # no-op when off (the default): no objects, no records, nothing extra written.
        self.trace_requests = trace_requests
        # fleet fault tolerance (off = None: every hook below is one None check and
        # routing behavior is byte-identical to the health-unaware router)
        self.health = health
        self.reroute_attempts = reroute_attempts
        self.reroute_backoff_s = reroute_backoff_s
        self.reroute_backoff_max_s = reroute_backoff_max_s
        if health is not None:
            for replica in replicas:
                health.register(replica.replica_id)
                replica.monitor = health
        # live observability plane (docs/OBSERVABILITY.md "Live metrics"; all default
        # None — every hook is one None check and the off path writes nothing extra):
        # a ClusterMetricsAggregator that emits a `fleet` record alongside each router
        # record, a ServingSLOMonitor fed fleet-level signals (KV-handoff latency), and
        # a FlightRecorder ring dumped when a replica is declared dead
        self.metrics = metrics
        self.slo_monitor = slo_monitor
        self.flight_recorder = flight_recorder
        self._obs_steps = 0  # router-step clock for flight-record/alert entries
        # last step exception per replica, sync mode only: the ladder owns
        # life/death, but the flight record wants to name the cause at _recover_dead
        self._step_errors: dict[int, BaseException] = {}
        self._handoff_transfers_seen = 0
        self._handoff_latency_seen = 0.0
        self._dead: set[int] = set()  # quarantined after crash/wedge (until rejoin)
        self._parked: set[int] = set()  # drained for maintenance (until rejoin)
        self._started = False  # threaded mode is live (drain/rejoin manage threads)
        self.stats = RouterStats()
        self._last_record_routed = 0
        # session_id -> (replica list index, expires_at): sticky placement so every
        # turn of a conversation lands where its pinned prefix pages live
        self._sessions: dict[str, tuple[int, float]] = {}

    # ------------------------------------------------------------------ routing

    def _routable(self) -> list[EngineReplica]:
        if not self._dead and not self._parked:
            return self.replicas
        return [
            r
            for r in self.replicas
            if r.replica_id not in self._dead and r.replica_id not in self._parked
        ]

    def _replica_by_id(self, replica_id: int) -> EngineReplica | None:
        for replica in self.replicas:
            if replica.replica_id == replica_id:
                return replica
        return None

    def _session_replica(self, session_id: str | None) -> EngineReplica | None:
        """The replica remembered for a live session (None when unknown/expired, or
        when the pinned replica is dead/parked — the session re-pins on placement)."""
        if session_id is None:
            return None
        entry = self._sessions.get(session_id)
        if entry is None:
            return None
        index, expires_at = entry
        if expires_at < self.clock():
            del self._sessions[session_id]
            return None
        replica = self.replicas[index]
        if replica.replica_id in self._dead or replica.replica_id in self._parked:
            return None
        return replica

    def select(
        self, prompt_ids: list[int], session_id: str | None = None
    ) -> tuple[EngineReplica, bool]:
        """Pick a replica for `prompt_ids`: (replica, used_affinity). A live session's
        replica wins outright; otherwise the longest resident prefix (>= one full
        page), otherwise least-loaded. Dead/parked replicas never route."""
        routable = self._routable()
        if not routable:
            raise NoLiveReplicasError(
                f"no live replicas: {len(self._dead)} dead, {len(self._parked)} parked"
            )
        sticky = self._session_replica(session_id)
        if sticky is not None:
            return sticky, True
        best: EngineReplica | None = None
        best_len = 0
        for replica in routable:
            match = replica.prefix_match_len(prompt_ids)
            if match > best_len:
                best, best_len = replica, match
        if best is not None and best_len >= best.page_size > 0:
            return best, True
        return min(routable, key=lambda r: r.load()), False

    def submit(self, **spec: Any) -> RequestState:
        """Route one request spec (the kwargs of `ServingEngine.submit`). Raises
        QueueFullError only when EVERY live replica is at its admission bound (and
        NoLiveReplicasError when the fleet has no live replica at all)."""
        session_id = spec.get("session_id")
        trace = spec.get("trace")
        route = None
        if trace is None and self.trace_requests:
            trace = RequestTrace(clock=self.clock)
            spec["trace"] = trace
        if trace is not None:
            root = trace.ensure_root(t0=self.clock())
            route = trace.begin("route", parent=root, session=session_id is not None)
        chosen, affinity = self.select(spec["prompt_ids"], session_id)
        candidates = [chosen] + sorted(
            (r for r in self._routable() if r is not chosen), key=lambda r: r.load()
        )
        for replica in candidates:
            try:
                state = replica.submit(**spec)
            except QueueFullError:
                continue
            if route is not None:
                trace.end(
                    route,
                    replica_id=replica.replica_id,
                    affinity=bool(affinity and replica is chosen),
                    spilled=replica is not chosen,
                )
            self.stats.routed += 1
            self.stats.per_replica_routed[replica.replica_id] = (
                self.stats.per_replica_routed.get(replica.replica_id, 0) + 1
            )
            get_telemetry().count("router_requests_routed")
            if affinity and replica is chosen:
                self.stats.affinity_hits += 1
                get_telemetry().count("router_prefix_affinity_hits")
                if self._session_replica(session_id) is replica:
                    self.stats.session_affinity_hits += 1
            if session_id is not None:
                # remember where the session actually landed (a full sticky replica may
                # have spilled to another — the pin follows the latest placement)
                self._sessions[session_id] = (
                    self.replicas.index(replica),
                    self.clock() + self.session_ttl_s,
                )
            if (
                self.record_interval
                and self.stats.routed - self._last_record_routed >= self.record_interval
            ):
                self.emit_router_record()
            return state
        self.stats.rejected += 1
        get_telemetry().count("router_requests_rejected")
        raise QueueFullError(
            f"all {len(candidates)} live replica(s) are at their admission bound"
        )

    # ------------------------------------------------------------------ driving

    def _step_routable(self) -> bool:
        """Advance every live replica one engine step. With a health monitor a raising
        replica is contained (its heartbeat counted the failure; the ladder decides);
        without one the exception propagates — the pre-health contract."""
        worked = False
        for replica in self.replicas:
            if replica.replica_id in self._dead or replica.replica_id in self._parked:
                continue
            if self.health is None:
                worked = replica.step() or worked
                continue
            try:
                worked = replica.step() or worked
            except Exception as exc:
                # remember the cause for _recover_dead's flight record — but NOT in
                # the replica's sticky slot: that would short-circuit the next step()
                # before the monitor heartbeat, starving the ladder of the repeat
                # failures it needs to declare death
                self._step_errors[replica.replica_id] = exc
                worked = True  # the failed step consumed time; let recovery rerun us
        return worked

    def step(self) -> bool:
        """Synchronous mode: advance every live replica with pending work one engine
        step, then run health recovery (watchdog sweep + migration of dead replicas'
        in-flight work)."""
        worked = self._step_routable()
        self._sweep_health()
        self._observe_plane()
        return worked

    def drain(self, timeout_s: float | None = None) -> None:
        """Run until every routed request finished; emit serving + router records.

        ``timeout_s`` bounds the loop: on expiry, raises :class:`DrainTimeoutError`
        naming each stuck replica and its in-flight request ids — without it a wedged
        replica (no health monitor to declare it dead) spins this loop forever."""
        deadline = None if timeout_s is None else self.clock() + timeout_s
        while self.step():
            if deadline is not None and self.clock() > deadline:
                stuck = {
                    replica.replica_id: replica.inflight_request_ids()
                    for replica in self.replicas
                    if replica.replica_id not in self._dead and replica.has_work()
                }
                raise DrainTimeoutError(
                    f"drain did not finish within {timeout_s}s; stuck replicas "
                    f"(replica_id -> in-flight request ids): {stuck}. A wedged "
                    "replica without a health monitor blocks drain forever — pass "
                    "Router(health=ReplicaHealthMonitor(...)) to detect it and "
                    "migrate its work, or stop() the fleet."
                )
        for replica in self.replicas:
            if replica.replica_id not in self._dead:
                replica.engine.emit_serving_record()
        self.emit_router_record()

    def start(self) -> None:
        """Threaded mode: one background stepping thread per live replica."""
        self._started = True
        for replica in self._routable():
            replica.start()

    def wait(self, timeout_s: float = 60.0) -> bool:
        """Block until every live replica is idle (threaded mode). True = drained.

        Runs health recovery while waiting (thread deaths and wedges surface here);
        without a monitor a replica's sticky thread failure is re-raised — never a
        silent hang. A timeout emits a ``router_wait_incomplete`` telemetry event
        naming who still has work before returning False."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self._sweep_health()
            self._observe_plane()
            if self.health is None:
                for replica in self.replicas:
                    if replica.error is not None:
                        raise replica.error
            if not any(replica.has_work() for replica in self._routable()):
                return True
            time.sleep(0.005)
        pending = {
            str(replica.replica_id): replica.inflight_request_ids()
            for replica in self.replicas
            if replica.replica_id not in self._dead and replica.has_work()
        }
        get_telemetry().event(
            "router_wait_incomplete", timeout_s=timeout_s, pending=pending
        )
        return False

    def stop(self) -> None:
        self._started = False
        for replica in self.replicas:
            replica.stop()

    # ------------------------------------------------------------- observability

    def _observe_plane(self) -> None:
        """Feed the attached flight recorder and SLO monitor once per router
        iteration (sync `step` and the threaded `wait` poll loop). One None check on
        the off path; never writes telemetry records itself."""
        if self.flight_recorder is None and self.slo_monitor is None:
            return
        self._obs_steps += 1
        if self.flight_recorder is not None:
            self.flight_recorder.record(
                self._obs_steps,
                queue_depths=[r.queue_depth for r in self.replicas],
                slots_active=[r.slots_active for r in self.replicas],
                dead=sorted(self._dead) or None,
                rerouted=self.stats.rerouted or None,
                shed=self.stats.shed or None,
            )
        if self.slo_monitor is not None:
            handoffs = [
                r.engine.handoff
                for r in self.replicas
                if isinstance(r.engine, DisaggregatedEngine)
            ]
            transfers = sum(h.transfers for h in handoffs)
            new = transfers - self._handoff_transfers_seen
            if new > 0:
                latency = sum(h._latency_sum for h in handoffs)
                self.slo_monitor.observe_handoff(
                    (latency - self._handoff_latency_seen) / new, step=self._obs_steps
                )
                self._handoff_transfers_seen = transfers
                self._handoff_latency_seen = latency

    # ------------------------------------------------------------- fault recovery

    def _sweep_health(self) -> None:
        """Run the wedge watchdog and migrate every replica it newly declared dead."""
        if self.health is None:
            return
        for replica_id in self.health.sweep():
            replica = self._replica_by_id(replica_id)
            if replica is not None and replica_id not in self._dead:
                self._recover_dead(replica)

    def _recover_dead(self, replica: EngineReplica) -> None:
        """Quarantine a dead replica and re-route its entire in-flight population to
        the surviving fleet (shedding lowest tiers if capacity is genuinely gone)."""
        self._dead.add(replica.replica_id)
        replica.quarantine()
        self.stats.replica_crashes += 1
        get_telemetry().count("router_replica_crashes")
        if self.flight_recorder is not None:
            # the serving flight record: dump the recent router/engine-step ring at
            # the moment of death, named for the replica that died. Threaded mode
            # leaves the cause in the replica's sticky slot; sync mode parked it in
            # _step_errors (the sticky slot would have starved the health ladder).
            cause = replica.error
            if cause is None:
                cause = self._step_errors.get(replica.replica_id)
            self.flight_recorder.record(
                self._obs_steps,
                replica_dead=replica.replica_id,
                error=repr(cause) if cause is not None else None,
            )
            self.flight_recorder.dump(f"replica_dead:{replica.replica_id}", error=cause)
        orphans = replica.release_inflight()
        failed = self._place_orphans(orphans, src=replica)
        # capacity loss: shed what could not be placed, lowest tier (then youngest)
        # first — graceful degradation instead of failing the whole fleet
        for state in sorted(failed, key=lambda s: (-s.tier, -s.seq)):
            self._shed(state)
        if self.record_interval:
            self.emit_router_record()

    def _place_orphans(
        self, orphans: list[RequestState], *, src: EngineReplica
    ) -> list[RequestState]:
        """Re-route released requests in (tier, FCFS) order; returns the ones whose
        retry budget ran out (caller decides: shed on crash, restore on drain)."""
        return [state for state in orphans if not self._reroute_one(state, src)]

    def _reroute_candidates(
        self, prompt_ids: list[int], exclude: EngineReplica
    ) -> list[EngineReplica]:
        """Adoption order for a migrating request: longest page-granular resident
        prefix first (the adoptive replica re-prefills the committed tokens — a radix
        hit makes that nearly free), then least-loaded."""

        def rank(replica: EngineReplica):
            pages = (
                replica.prefix_match_len(prompt_ids) // replica.page_size
                if replica.page_size
                else 0
            )
            return (-pages, replica.load())

        return sorted(
            (r for r in self._routable() if r is not exclude), key=rank
        )

    def _reroute_one(self, state: RequestState, src: EngineReplica) -> bool:
        """Move one in-flight request from `src` to a surviving replica, bounded by
        the per-request attempt budget (`reroute_attempts`) with backoff between full
        sweeps. The committed prefix rides along host-side; the adoptive engine's
        recompute-resume continues the stream bit-exact."""
        tr = state.trace
        span = None
        if tr is not None:
            # the request left `src` mid-flight: close whatever phase was open there
            # and account the migration as its own span under the root, so the
            # request's lifecycle stays ONE tree across replicas
            t0 = self.clock()
            for name in ("queue_wait", "prefill", "decode", "handoff", "preempt_park"):
                open_span = tr.open.pop(name, None)
                if open_span is not None:
                    tr.end(open_span, t1=t0, rerouted=True)
            tr.phase_parent = None
            span = tr.begin(
                "reroute",
                parent=tr.root,
                t0=t0,
                src_replica=src.replica_id,
                committed_tokens=len(state.tokens),
            )
        prompt = state.request.prompt_ids + state.tokens
        attempts = 0
        backoff = self.reroute_backoff_s
        placed: EngineReplica | None = None
        while placed is None and attempts < self.reroute_attempts:
            swept_all = True
            for replica in self._reroute_candidates(prompt, exclude=src):
                if attempts >= self.reroute_attempts:
                    swept_all = False
                    break
                attempts += 1
                if attempts > 1:
                    self.stats.reroute_retries += 1
                try:
                    replica.adopt_inflight(state)
                except QueueFullError:
                    continue
                placed = replica
                break
            if placed is not None or attempts >= self.reroute_attempts:
                break
            if not swept_all or attempts == 0:
                break  # no candidates at all: nowhere to place
            # every live candidate was full: give the fleet room to drain a little
            if self._started:
                time.sleep(backoff)
                backoff = min(backoff * 2, self.reroute_backoff_max_s)
            else:
                self._step_routable()
        if placed is None:
            if tr is not None:
                tr.end(span, attempts=attempts, failed=True)
            return False
        state.reroutes += 1
        self.stats.rerouted += 1
        get_telemetry().count("router_requests_rerouted")
        session = state.request.session_id
        if session is not None:
            # the conversation follows the migration: later turns land where the
            # request now lives (its prefix pages will be registered there)
            self._sessions[session] = (
                self.replicas.index(placed),
                self.clock() + self.session_ttl_s,
            )
        if tr is not None:
            tr.end(span, dst_replica=placed.replica_id, attempts=attempts)
            tr.open["queue_wait"] = tr.begin(
                "queue_wait",
                parent=tr.root,
                t0=self.clock(),
                tier=state.tier,
                segment=state.preemptions + state.reroutes,
            )
        return True

    def _shed(self, state: RequestState) -> None:
        """Cancel a request the surviving fleet cannot absorb (deliver `on_finish` so
        callers see a terminal state, exactly like a deadline cancellation)."""
        state.status = RequestStatus.cancelled
        state.finish_t = self.clock()
        self.stats.shed += 1
        get_telemetry().count("router_requests_shed")
        tr = state.trace
        if tr is not None:
            tr.end(
                tr.root,
                t1=state.finish_t,
                status=str(RequestStatus.cancelled),
                generated_tokens=state.num_generated,
                preemptions=state.preemptions,
            )
            get_telemetry().emit_record(
                "trace",
                trace_id=tr.trace_id,
                request_id=state.request.request_id,
                spans=tr.span_records(),
            )
        if state.request.on_finish is not None:
            state.request.on_finish(state)

    # --------------------------------------------------------------- drain/rejoin

    def drain_replica(self, replica_id: int) -> None:
        """Take a replica out of rotation for maintenance: stop new placements,
        migrate its ENTIRE in-flight population to the surviving fleet (no shedding —
        this is a planned operation; if the fleet cannot absorb the work the drain is
        rolled back and raises), and park it. While parked the replica can e.g.
        `swap_params`; `rejoin_replica` returns it to rotation — the rolling-update
        primitive."""
        replica = self._replica_by_id(replica_id)
        if replica is None:
            raise ValueError(f"unknown replica id {replica_id}")
        if replica_id in self._dead:
            raise ValueError(f"replica {replica_id} is dead; rejoin_replica revives it")
        if replica_id in self._parked:
            return  # already parked
        if len(self._routable()) <= 1:
            raise ValueError("cannot drain the last live replica")
        self._parked.add(replica_id)  # placements stop before migration starts
        if self._started:
            replica.stop()  # quiesce its stepping thread; rejoin restarts it
        orphans = replica.release_inflight()
        failed = self._place_orphans(orphans, src=replica)
        if failed:
            # roll back: restore the un-placeable work and return to rotation
            for state in failed:
                replica.adopt_inflight(state)
            self._parked.discard(replica_id)
            if self._started:
                replica.start()
            raise DrainTimeoutError(
                f"drain_replica({replica_id}): surviving fleet could not absorb "
                f"{len(failed)} of {len(orphans)} in-flight request(s) within the "
                f"retry budget (request ids "
                f"{[s.request.request_id for s in failed]}); drain rolled back"
            )
        self.stats.drains += 1
        get_telemetry().count("router_drains")
        get_telemetry().event(
            "replica_drained", replica_id=replica_id, migrated=len(orphans)
        )
        if self.record_interval:
            self.emit_router_record()

    def rejoin_replica(self, replica_id: int) -> None:
        """Return a parked (or repaired dead) replica to rotation: clear its sticky
        failure + quarantine, reset its health record, and restart its stepping
        thread when the fleet runs threaded."""
        replica = self._replica_by_id(replica_id)
        if replica is None:
            raise ValueError(f"unknown replica id {replica_id}")
        replica.stop()  # join any finished/crashed thread so start() is clean
        replica.reset_failure()
        self._parked.discard(replica_id)
        self._dead.discard(replica_id)
        if self.health is not None:
            self.health.reset(replica_id)
        if self._started:
            replica.start()
        get_telemetry().event("replica_rejoined", replica_id=replica_id)

    # ------------------------------------------------------------------ telemetry

    def _health_state(self, replica: EngineReplica) -> str:
        if replica.replica_id in self._dead:
            return "dead"
        if replica.replica_id in self._parked:
            return "parked"
        if self.health is not None:
            return str(self.health.state(replica.replica_id))
        return "healthy"

    def emit_router_record(self) -> None:
        """One ``router`` telemetry record: instantaneous per-replica queue/slot state
        plus cumulative routing counters (docs/OBSERVABILITY.md). Fleet-health fields
        appear only when health monitoring is on or a fault-tolerance action fired, so
        the record is byte-identical to the health-unaware router otherwise."""
        telemetry = get_telemetry()
        self._last_record_routed = self.stats.routed
        queue_depths = [r.queue_depth for r in self.replicas]
        telemetry.gauge("router/queue_depth", sum(queue_depths))
        handoffs = [
            r.engine.handoff
            for r in self.replicas
            if isinstance(r.engine, DisaggregatedEngine)
        ]
        transfers = sum(h.transfers for h in handoffs)
        latency_ms = (
            round(1e3 * sum(h._latency_sum for h in handoffs) / transfers, 3)
            if transfers
            else None
        )
        hit_rate = self.stats.affinity_hit_rate()
        stats = self.stats
        fields: dict[str, Any] = dict(
            replicas=len(self.replicas),
            queue_depths=queue_depths,
            slots_active=[r.slots_active for r in self.replicas],
            routed=stats.routed,
            rejected=stats.rejected,
            prefix_affinity_hits=stats.affinity_hits,
            handoff_latency_ms=latency_ms,
            counters={
                "per_replica_routed": {
                    str(k): v for k, v in sorted(stats.per_replica_routed.items())
                },
                "prefix_affinity_hit_rate": None if hit_rate is None else round(hit_rate, 4),
                "session_affinity_hits": stats.session_affinity_hits,
                "sessions_tracked": len(self._sessions),
                "kv_handoffs": transfers,
            },
        )
        if (
            self.health is not None
            or self._dead
            or self._parked
            or stats.rerouted
            or stats.shed
            or stats.drains
        ):
            states = {str(r.replica_id): self._health_state(r) for r in self.replicas}
            fields["health"] = states
            fields["reroutes"] = stats.rerouted
            fields["reroute_retries"] = stats.reroute_retries
            fields["counters"]["replica_crashes"] = stats.replica_crashes
            fields["counters"]["requests_shed"] = stats.shed
            fields["counters"]["drains"] = stats.drains
            telemetry.gauge(
                "router/replicas_healthy",
                sum(1 for s in states.values() if s == "healthy"),
            )
        telemetry.emit_record("router", **fields)
        if self.metrics is not None:
            # the fleet aggregate rides the router record's cadence, so readers get
            # one merged cross-replica view per per-replica view
            self.metrics.emit_fleet_record()


def route_batch(router: Router, request_specs: list[dict]) -> list[RequestState]:
    """Offline driver: route every spec with backpressure (a full fleet makes room by
    stepping) and drain. Results keep submission order — the router-level analogue of
    `serving.engine.serve_batch`."""
    states: list[RequestState] = []
    index = 0
    while index < len(request_specs):
        try:
            states.append(router.submit(**request_specs[index]))
            index += 1
        except QueueFullError:
            if not router.step():  # nothing progressed and everything is full: bug guard
                raise
    router.drain()
    return states


__all__ = [
    "DrainTimeoutError",
    "EngineReplica",
    "NoLiveReplicasError",
    "Router",
    "RouterStats",
    "route_batch",
]
