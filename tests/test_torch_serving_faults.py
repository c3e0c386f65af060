"""Fleet fault tolerance in the port against the JAX package, on the CPU.

The cases of `tests/test_serving_faults.py` at its sizes (2 slots, 16-token pages and
prefill chunks) over the fleet tests' tiny model (`tests/torch_fleet.py`): the seeded
fault plans and the health ladder equal the JAX package's step for step; a replica crashed
mid-decode or mid-prefill, wedged, or failing its KV handoff has its requests migrated,
and their greedy tokens are the JAX fleet's (fp32, exact) while the sampled request's
tokens are the port's own unmigrated run's (torch and JAX draw different streams); a
rejecting replica spills, a dead fleet raises `NoLiveReplicasError`, a stuck drain names
its requests; drain / `swap_params` / rejoin keeps the tokens, and `swap_params` on one
replica leaves the others' weights alone; the off path writes the router record of a
fleet without health monitoring, field for field.
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from dolomite_engine_tpu.serving import EngineReplica as JaxEngineReplica
from dolomite_engine_tpu.serving import FaultInjector as JaxFaultInjector
from dolomite_engine_tpu.serving import Fault as JaxFault
from dolomite_engine_tpu.serving import ReplicaHealthMonitor as JaxReplicaHealthMonitor
from dolomite_engine_tpu.serving import Router as JaxRouter
from dolomite_engine_tpu.serving import serve_batch as jax_serve_batch
from dolomite_engine_tpu_torch.serving import (
    DisaggregatedEngine,
    EngineReplica,
    Fault,
    FaultInjector,
    QueueFullError,
    ReplicaHealth,
    ReplicaHealthMonitor,
    RequestStatus,
    Router,
    serve_batch,
)
from dolomite_engine_tpu_torch.serving.cluster import DrainTimeoutError, NoLiveReplicasError
from dolomite_engine_tpu_torch.utils.telemetry import Telemetry, install_telemetry, uninstall_telemetry
from tests.torch_fleet import (
    fleet_models,
    fleet_workload,
    for_jax,
    greedy_rows,
    jax_engine,
    jax_sampling,
    one_torch_thread,
    port_engine,
    random_prompt,
)


@pytest.fixture(autouse=True)
def single_thread():
    threads = one_torch_thread()
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return fleet_models()


@pytest.fixture(scope="module")
def expected(models):
    """The port's unfaulted single-engine tokens on the shared workload, and the JAX
    engine's (greedy rows equal; the sampled row is a different stream)."""
    threads = one_torch_thread()
    port = [s.tokens for s in serve_batch(port_engine(models), [dict(s) for s in fleet_workload()])]
    torch.set_num_threads(threads)
    ref = [s.tokens for s in jax_serve_batch(jax_engine(models), jax_sampling(for_jax(fleet_workload())))]
    for row in greedy_rows(fleet_workload()):
        assert port[row] == ref[row], row
    return port


@pytest.fixture(scope="module")
def jax_crash_run(models):
    """The JAX fleet with replica 0 crashed at work step 6: its tokens and router stats."""
    injector = JaxFaultInjector([JaxFault(kind="crash", replica_id=0, at=6)])
    replicas = [JaxEngineReplica(i, jax_engine(models), fault_injector=injector) for i in range(2)]
    router = JaxRouter(replicas, health=JaxReplicaHealthMonitor(max_consecutive_exceptions=2, suspect_after_s=30.0, dead_after_s=60.0))
    states = [router.submit(**spec) for spec in jax_sampling(for_jax(fleet_workload()))]
    router.drain(timeout_s=120.0)
    return [s.tokens for s in states], router.stats


def _lenient_monitor(**overrides):
    kwargs = dict(max_consecutive_exceptions=2, suspect_after_s=30.0, dead_after_s=60.0)
    kwargs.update(overrides)
    return ReplicaHealthMonitor(**kwargs)


def _two_replicas(models, injector=None):
    return [EngineReplica(i, port_engine(models), fault_injector=injector) for i in range(2)]


def _submit_workload(router):
    done = []
    states = [router.submit(**spec, on_finish=done.append) for spec in fleet_workload()]
    return states, done


class _StubEngine:
    """The engine surface the router reads, without a model."""

    def __init__(self, *, step_error=None, busy_ids=()):
        self.busy_ids = list(busy_ids)
        self.step_error = step_error
        self.scheduler = SimpleNamespace(queue_depth=0)
        self.pool = SimpleNamespace(occupancy=0.0, num_active=len(self.busy_ids), page_size=0)

    def prefix_match_len(self, prompt_ids):
        return 0

    def has_work(self):
        return bool(self.busy_ids) or self.step_error is not None

    def step(self):
        if self.step_error is not None:
            raise self.step_error
        return bool(self.busy_ids)

    def inflight_request_ids(self):
        return sorted(self.busy_ids)

    def release_inflight(self):
        self.busy_ids = []
        return []

    def emit_serving_record(self):
        pass


# ------------------------------------------------------------------- the primitives


@pytest.mark.parametrize("seed", [7, 8])
def test_fault_injector_seeded_matches_jax(seed):
    kwargs = dict(kinds=("crash", "wedge", "reject"), count=4, step_range=(2, 10), wedge_s=0.3)
    got = FaultInjector.seeded(seed, [0, 1], **kwargs).faults
    want = JaxFaultInjector.seeded(seed, [0, 1], **kwargs).faults
    assert [(f.kind, f.replica_id, f.at, f.wedge_s) for f in got] == [(f.kind, f.replica_id, f.at, f.wedge_s) for f in want]
    assert got == FaultInjector.seeded(seed, [0, 1], **kwargs).faults


def test_fault_validation():
    with pytest.raises(ValueError):
        Fault(kind="meteor", replica_id=0)
    with pytest.raises(ValueError):
        Fault(kind="wedge", replica_id=0)
    injector = FaultInjector([Fault(kind="reject", replica_id=0, at=0)])
    with pytest.raises(QueueFullError):
        injector.on_submit(0)
    injector.on_submit(0)  # one-shot: the retry goes through
    assert [f.site for f in injector.fired] == ["submit"]


def _ladder(monitor_class):
    """A scripted life of replica 0 (flake, recovery, two crashes, reset, a wedge) and
    the monitor's state and sweep after each event."""
    now = [0.0]
    monitor = monitor_class(max_consecutive_exceptions=2, suspect_after_s=1.0, dead_after_s=5.0, clock=lambda: now[0])
    monitor.register(0)
    log = [str(monitor.state(0))]

    def step(error=None, late=0.0):
        monitor.begin_step(0)
        now[0] += late
        monitor.end_step(0, error=error)
        log.append((str(monitor.state(0)), monitor.is_routable(0), monitor.sweep()))

    step(RuntimeError("flake"))
    step()
    step(late=2.0)  # a slow step: suspect
    step()
    step(RuntimeError("crash"))
    step(RuntimeError("crash"))
    log.append(monitor.sweep())  # dead reported once
    monitor.reset(0)
    monitor.begin_step(0)
    now[0] += 6.0
    log.append((monitor.sweep(), str(monitor.state(0))))
    return log


def test_health_ladder_matches_jax():
    assert _ladder(ReplicaHealthMonitor) == _ladder(JaxReplicaHealthMonitor)
    assert _ladder(ReplicaHealthMonitor)[-1] == ([0], "dead")


# --------------------------------------------------------------------- migration


@pytest.mark.parametrize("mode", ["sync", "threaded"])
def test_crash_mid_decode_migrates(models, expected, jax_crash_run, mode):
    """Replica 0 crashes at work step 6 with tokens committed on both its slots: every
    request finishes on the survivor, greedy rows with the JAX fleet's tokens and the
    sampled row (on replica 0) with the port's unmigrated tokens."""
    injector = FaultInjector([Fault(kind="crash", replica_id=0, at=6)])
    replicas = _two_replicas(models, injector)
    router = Router(replicas, health=_lenient_monitor())
    states, done = _submit_workload(router)
    if mode == "sync":
        router.drain(timeout_s=120.0)
    else:
        router.start()
        assert router.wait(timeout_s=120.0)
        router.stop()
    jax_tokens, jax_stats = jax_crash_run
    assert [s.tokens for s in states] == expected
    for row in greedy_rows(fleet_workload()):
        assert states[row].tokens == jax_tokens[row]
    assert states[2].reroutes == 1 and states[2].rng_state is not None  # the sampled row migrated
    assert all(s.status == RequestStatus.completed for s in states) and len(done) == len(states)
    assert (router.stats.replica_crashes, router.stats.rerouted, router.stats.shed) == (1, 2, 0)
    assert (jax_stats.replica_crashes, jax_stats.rerouted, jax_stats.shed) == (1, 2, 0)
    assert router.health.state(0) is ReplicaHealth.dead
    assert [f.site for f in injector.fired] == ["step"]


def test_crash_mid_prefill_restarts_cleanly(models):
    """Crash during chunked prefill (work step 1, nothing committed): the orphan replays
    from scratch on the survivor, with the JAX fleet's tokens."""
    rs = np.random.RandomState(77)
    specs = [dict(prompt_ids=random_prompt(rs, 40), max_new_tokens=6), dict(prompt_ids=random_prompt(rs, 7), max_new_tokens=6)]
    want = [s.tokens for s in jax_serve_batch(jax_engine(models), for_jax(specs))]

    def run(engine_class, replica_class, router_class, fault, monitor_class, build, spec_list):
        injector = engine_class([fault(kind="crash", replica_id=0, at=1)])
        replicas = [replica_class(i, build(models), fault_injector=injector) for i in range(2)]
        router = router_class(replicas, health=monitor_class(max_consecutive_exceptions=2, suspect_after_s=30.0, dead_after_s=60.0))
        states = [router.submit(**spec) for spec in spec_list]
        router.drain(timeout_s=120.0)
        return states, router.stats

    states, stats = run(FaultInjector, EngineReplica, Router, Fault, ReplicaHealthMonitor, port_engine, [dict(s) for s in specs])
    jax_states, jax_stats = run(JaxFaultInjector, JaxEngineReplica, JaxRouter, JaxFault, JaxReplicaHealthMonitor, jax_engine, for_jax(specs))
    assert [s.tokens for s in states] == want == [s.tokens for s in jax_states]
    assert (stats.replica_crashes, stats.rerouted) == (jax_stats.replica_crashes, jax_stats.rerouted) == (1, 1)
    assert states[0].reroutes == 1


@pytest.mark.parametrize("mode", ["sync", "threaded"])
def test_wedge_detected_and_migrated(models, expected, mode):
    """A wedged step must not hang the fleet: the watchdog (threaded) or the late end of
    the step (sync) declares replica 0 dead, and its requests finish elsewhere with the
    unfaulted tokens."""
    injector = FaultInjector([Fault(kind="wedge", replica_id=0, at=3, wedge_s=1.2)])
    replicas = _two_replicas(models, injector)
    router = Router(replicas, health=ReplicaHealthMonitor(max_consecutive_exceptions=1, suspect_after_s=0.2, dead_after_s=0.4))
    states, done = _submit_workload(router)
    if mode == "sync":
        router.drain(timeout_s=120.0)
    else:
        router.start()
        assert router.wait(timeout_s=120.0)
        router.stop()
    assert [s.tokens for s in states] == expected
    assert all(s.status == RequestStatus.completed for s in states) and len(done) == len(states)
    assert router.stats.replica_crashes == 1 and router.stats.shed == 0
    assert router.health.state(0) is ReplicaHealth.dead
    assert [f.fault.kind for f in injector.fired] == ["wedge"]


def test_handoff_failure_migrates(models, expected):
    """A failed KV transfer on a disaggregated replica: the request caught mid-handoff
    (on both sides of the seam) migrates once and finishes with the unfaulted tokens."""
    rows = greedy_rows(fleet_workload())
    specs = [dict(fleet_workload()[i]) for i in rows]
    injector = FaultInjector([Fault(kind="handoff", replica_id=0, at=0)])
    disagg = DisaggregatedEngine(port_engine(models, prefill_only=True), [port_engine(models)])
    replicas = [EngineReplica(0, disagg, fault_injector=injector), EngineReplica(1, port_engine(models))]
    assert disagg.handoff.fault_injector is injector
    router = Router(replicas, health=_lenient_monitor(max_consecutive_exceptions=1))
    done = []
    states = [router.submit(**spec, on_finish=done.append) for spec in specs]
    router.drain(timeout_s=120.0)
    assert [s.tokens for s in states] == [expected[i] for i in rows]
    assert all(s.status == RequestStatus.completed for s in states) and len(done) == len(states)
    assert router.stats.replica_crashes == 1 and router.stats.shed == 0
    assert [f.site for f in injector.fired] == ["transfer"]


def test_reject_fault_spills_to_other_replica(models, expected):
    injector = FaultInjector([Fault(kind="reject", replica_id=0, at=0)])
    router = Router(_two_replicas(models, injector))
    state = router.submit(**dict(fleet_workload()[3]))
    router.drain(timeout_s=120.0)
    assert state.status == RequestStatus.completed and state.tokens == expected[3]
    assert router.stats.per_replica_routed == {1: 1} and router.stats.rejected == 0
    assert [f.site for f in injector.fired] == ["submit"]


def test_replica_thread_death_is_sticky():
    boom = RuntimeError("boom: planted thread death")
    replicas = [EngineReplica(0, _StubEngine(step_error=boom))]
    router = Router(replicas)
    router.start()
    with pytest.raises(RuntimeError, match="planted thread death"):
        router.wait(timeout_s=10.0)
    router.stop()
    assert replicas[0].error is boom
    with pytest.raises(RuntimeError, match="planted thread death"):
        replicas[0].step()


def test_no_live_replicas_error():
    router = Router([EngineReplica(0, _StubEngine(step_error=RuntimeError("boom")))], health=ReplicaHealthMonitor(max_consecutive_exceptions=1))
    router.step()
    router.step()
    with pytest.raises(NoLiveReplicasError):
        router.select([1, 2, 3])


def test_drain_timeout_names_stuck_replica():
    router = Router([EngineReplica(0, _StubEngine(busy_ids=[7, 12]))])
    with pytest.raises(DrainTimeoutError, match=r"0.*\[7, 12\]"):
        router.drain(timeout_s=0.05)


# ----------------------------------------------------------------- rolling update


def test_drain_swap_rejoin_roundtrip(models, expected, tmp_path):
    """Drain replica 0 mid-decode (its session request migrates), swap its weights (the
    same ones, as a JAX tree) while parked, rejoin it: the request keeps its tokens, the
    session's next turn follows the migration, and the rejoined replica takes traffic."""
    jax_model, params, _ = models
    sink = tmp_path / "roundtrip.jsonl"
    telemetry = Telemetry(sink_path=str(sink), rank=0)
    install_telemetry(telemetry)
    try:
        replicas = _two_replicas(models)
        router = Router(replicas, health=_lenient_monitor())
        spec = dict(fleet_workload()[0], session_id="sess-roundtrip")
        state = router.submit(**spec)
        assert router.stats.per_replica_routed == {0: 1}
        for _ in range(4):
            router.step()
        assert state.tokens  # the drain migrates mid-decode
        router.drain_replica(0)
        assert router.stats.drains == 1 and state.reroutes == 1
        replicas[0].swap_params(jax.tree.map(np.asarray, nn.unbox(params)))
        router.rejoin_replica(0)
        router.drain(timeout_s=120.0)
        assert state.status == RequestStatus.completed and state.tokens == expected[0]
        router.submit(prompt_ids=spec["prompt_ids"] + state.tokens, max_new_tokens=4, session_id="sess-roundtrip")
        assert router.stats.per_replica_routed.get(1, 0) == 1 and router.stats.session_affinity_hits == 1
        fresh = router.submit(**dict(fleet_workload()[3]))
        assert router.stats.per_replica_routed[0] == 2
        router.drain(timeout_s=120.0)
        assert fresh.tokens == expected[3]  # the swapped-in weights are the same ones
    finally:
        uninstall_telemetry()
        telemetry.close()
    events = [r["event"] for r in map(json.loads, open(sink)) if r.get("kind") == "event" and r["event"].startswith("replica_")]
    assert events == ["replica_drained", "replica_rejoined"]


def test_swap_params_leaves_other_replicas_alone(models, expected):
    """Engines built over one model share its weights; `swap_params` on one gives it
    weights of its own and the others keep serving the shared ones."""
    _, _, model = models
    before = {name: t.clone() for name, t in model.state_dict().items()}
    a, b = port_engine(models), port_engine(models)
    assert a.model is b.model  # one set of weights
    perturbed = {name: t + 0.5 if t.is_floating_point() else t for name, t in model.state_dict().items()}
    a.swap_params(perturbed)
    assert all(torch.equal(model.state_dict()[name], t) for name, t in before.items())
    spec = dict(fleet_workload()[0])
    (on_b,) = serve_batch(b, [dict(spec)])
    (on_a,) = serve_batch(a, [dict(spec)])
    assert on_b.tokens == expected[0]
    assert on_a.tokens != expected[0]  # a serves its own weights
    a.swap_params(model.state_dict())
    (back,) = serve_batch(a, [dict(spec)])
    assert back.tokens == expected[0]
    with pytest.raises(ValueError, match="does not have"):
        a.swap_params({"no.such.weight": torch.zeros(1)})


def test_off_path_is_byte_identical(models, expected, tmp_path):
    """No monitor, no injector: the router record carries exactly the health-unaware
    field set, no fleet counter or gauge exists, and the tokens are the unfaulted ones."""
    sink = tmp_path / "offpath.jsonl"
    telemetry = Telemetry(sink_path=str(sink), rank=0)
    install_telemetry(telemetry)
    try:
        router = Router(_two_replicas(models))
        states = [router.submit(**dict(fleet_workload()[i])) for i in (0, 3)]
        router.drain(timeout_s=120.0)
        assert [s.tokens for s in states] == [expected[0], expected[3]]
        for name in ("router_replica_crashes", "router_requests_rerouted", "router_requests_shed", "router_drains"):
            assert name not in telemetry.counters
        assert "router/replicas_healthy" not in telemetry.gauges
    finally:
        uninstall_telemetry()
        telemetry.close()
    records = [json.loads(line) for line in open(sink)]
    router_record = [r for r in records if r["kind"] == "router"][-1]
    assert set(router_record) == {
        "kind", "ts", "rank", "replicas", "queue_depths", "slots_active", "routed", "rejected",
        "prefix_affinity_hits", "handoff_latency_ms", "counters",
    }
    assert set(router_record["counters"]) == {
        "per_replica_routed", "prefix_affinity_hit_rate", "session_affinity_hits", "sessions_tracked", "kv_handoffs",
    }
    assert not any(r["kind"] == "trace" for r in records)
    assert all(s.trace is None for s in states)


def test_migration_of_a_sampled_request_mid_prefill_handoff_and_decode(models):
    """Three sampled requests, one per phase when replica 0 dies (decoding, mid-prefill
    of a 3-chunk prompt, queued): each finishes with its unmigrated stream."""
    from dolomite_engine_tpu_torch.serving import SamplingParams

    rs = np.random.RandomState(5)
    specs = [
        dict(prompt_ids=random_prompt(rs, n), max_new_tokens=10, sampling=SamplingParams(do_sample=True, temperature=t, top_k=k), seed=s)
        for n, t, k, s in ((12, 0.8, 0, 11), (40, 1.1, 20, 12), (9, 0.7, 0, 13), (33, 1.0, 0, 14))
    ]
    alone = [s.tokens for s in serve_batch(port_engine(models, num_slots=4), [dict(s) for s in specs])]
    injector = FaultInjector([Fault(kind="crash", replica_id=0, at=4)])
    router = Router(_two_replicas(models, injector), health=_lenient_monitor())
    states = [router.submit(**dict(s)) for s in specs]
    router.drain(timeout_s=120.0)
    assert [s.tokens for s in states] == alone
    assert router.stats.rerouted >= 2
