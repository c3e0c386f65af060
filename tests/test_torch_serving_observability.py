"""The fleet's observability plane in the port against the JAX package, on the CPU.

The cases of `tests/test_serving_observability.py` over the fleet tests' tiny model
(`tests/torch_fleet.py`, fp32, greedy): the registry's snapshot API and the known series
tables equal the JAX package's; the same two-replica run in both packages gives equal
deterministic `fleet_snapshot` counters, and `/metrics` renders the same series names and
label sets with equal counter values; `/healthz` flips to 503 naming the replica a crash
killed; `ServingSLOMonitor` fed the same synthetic series raises the JAX monitor's alerts;
a two-tier overload alerts its violated tier only; flight records are dumped on a replica's
death and on an engine exception; the off path writes the same records with or without a
scraper.
"""

import json
import math
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dolomite_engine_tpu.serving import ClusterMetricsAggregator as JaxClusterMetricsAggregator
from dolomite_engine_tpu.serving import EngineReplica as JaxEngineReplica
from dolomite_engine_tpu.serving import ObservabilityServer as JaxObservabilityServer
from dolomite_engine_tpu.serving import Router as JaxRouter
from dolomite_engine_tpu.serving import TierSLO as JaxTierSLO
from dolomite_engine_tpu.utils import telemetry as jax_telemetry
from dolomite_engine_tpu.utils.diagnostics import ServingSLOMonitor as JaxServingSLOMonitor
from dolomite_engine_tpu_torch.serving import (
    ClusterMetricsAggregator,
    EngineReplica,
    Fault,
    FaultInjector,
    ObservabilityServer,
    ReplicaHealth,
    ReplicaHealthMonitor,
    Router,
    TierSLO,
    serve_batch,
)
from dolomite_engine_tpu_torch.utils import telemetry as port_telemetry
from dolomite_engine_tpu_torch.utils.diagnostics import FlightRecorder, ServingSLOMonitor
from dolomite_engine_tpu_torch.utils.telemetry import (
    QuantileSketch,
    Telemetry,
    get_telemetry,
    install_telemetry,
    nearest_rank,
    uninstall_telemetry,
)
from tests.torch_fleet import fleet_models, for_jax, jax_engine, one_torch_thread, port_engine, random_prompt, read_sink


@pytest.fixture(autouse=True)
def single_thread():
    threads = one_torch_thread()
    yield
    torch.set_num_threads(threads)
    uninstall_telemetry()


@pytest.fixture(scope="module")
def models():
    return fleet_models()


def _specs(count, max_new=4, seed=3, **extra):
    rs = np.random.RandomState(seed)
    return [dict(prompt_ids=random_prompt(rs, 12 + i), max_new_tokens=max_new, **extra) for i in range(count)]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as response:
            return response.status, response.read().decode()
    except urllib.error.HTTPError as error:
        return error.code, error.read().decode()


def test_known_series_and_snapshot_api_match_jax():
    for name in ("KNOWN_COUNTERS", "KNOWN_EVENTS", "KNOWN_GAUGES"):
        assert getattr(port_telemetry, name) == getattr(jax_telemetry, name), name
    telemetry = Telemetry()
    reference = jax_telemetry.Telemetry()
    for registry in (telemetry, reference):
        registry.count("requests_admitted", 3)
        registry.gauge("serving/queue_depth", 5)
        for value in (0.25, float("nan"), float("inf"), 0.5, 0.125):
            registry.observe("serving/ttft_s", value)
    snapshot = telemetry.snapshot()
    assert snapshot == reference.snapshot()
    assert snapshot["quantiles"]["serving/ttft_s"]["count"] == 3  # non-finite samples dropped
    snapshot["counters"]["requests_admitted"] = 999  # a copy
    assert telemetry.counters_snapshot()["requests_admitted"] == 3
    assert telemetry.gauges_snapshot() == {"serving/queue_depth": 5}
    assert telemetry.quantiles_snapshot() == reference.quantiles_snapshot()
    uninstall_telemetry()
    assert get_telemetry().snapshot() == {"counters": {}, "gauges": {}, "quantiles": {}}
    sketch, want = QuantileSketch(capacity=64), jax_telemetry.QuantileSketch(capacity=64)
    for value in np.random.RandomState(0).rand(1000):
        sketch.append(value)
        want.append(value)
    assert sketch.snapshot() == want.snapshot() and len(sketch) == 64 and list(sketch) == list(want)


def _fleet(models, jax_side):
    """Two replicas (tier 0 with a TTFT target) serving 4 requests, under each package's
    own telemetry registry: (router, states, registry)."""
    registry = (jax_telemetry if jax_side else port_telemetry).Telemetry()
    (jax_telemetry if jax_side else port_telemetry).install_telemetry(registry)
    try:
        build = jax_engine if jax_side else port_engine
        slos = {0: (JaxTierSLO if jax_side else TierSLO)(ttft_target_s=60.0)}
        engines = [build(models, tier_slos=slos) for _ in range(2)]
        router = (JaxRouter if jax_side else Router)([(JaxEngineReplica if jax_side else EngineReplica)(i, e) for i, e in enumerate(engines)])
        specs = for_jax(_specs(4)) if jax_side else _specs(4)
        states = [router.submit(**s) for s in specs]
        router.drain(timeout_s=120.0)
    finally:
        (jax_telemetry if jax_side else port_telemetry).uninstall_telemetry()
    return router, states, registry


@pytest.fixture(scope="module")
def fleets(models):
    threads = one_torch_thread()
    try:
        return _fleet(models, False), _fleet(models, True)
    finally:
        torch.set_num_threads(threads)


DETERMINISTIC = ("replicas", "queue_depth", "slots_active", "num_slots", "admitted", "completed", "preempted", "rejected", "sessions_live", "health")


def test_fleet_snapshot_matches_jax(fleets):
    (router, states, _), (jax_router, jax_states, _) = fleets
    assert [s.tokens for s in states] == [s.tokens for s in jax_states]
    snapshot = ClusterMetricsAggregator.for_router(router).fleet_snapshot()
    want = JaxClusterMetricsAggregator.for_router(jax_router).fleet_snapshot()
    assert {key: snapshot[key] for key in DETERMINISTIC} == {key: want[key] for key in DETERMINISTIC}
    assert snapshot["admitted"] == snapshot["completed"] == 4 and snapshot["replicas"] == 2
    for replica_id, entry in snapshot["per_replica"].items():
        assert {k: entry[k] for k in ("admitted", "completed", "num_slots", "queue_depth")} == {
            k: want["per_replica"][replica_id][k] for k in ("admitted", "completed", "num_slots", "queue_depth")
        }
    engines = [r.engine for r in router.replicas]
    pooled = sorted(t for e in engines for t in e.stats.ttft_s_by_tier[0])
    assert snapshot["tiers"]["0"]["ttft_p99_ms"] == pytest.approx(nearest_rank(pooled, 0.99) * 1e3, rel=1e-3)


def _series(body):
    """Prometheus text -> {(name, labels): value} over the sample lines."""
    out = {}
    for line in body.splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        out[key] = float(value)
    return out


def test_metrics_list_the_jax_series_with_equal_counters(fleets):
    (router, _, registry), (jax_router, _, jax_registry) = fleets
    got = _series(ObservabilityServer(0, aggregator=ClusterMetricsAggregator.for_router(router), telemetry=registry).render_metrics())
    want = _series(
        JaxObservabilityServer(0, aggregator=JaxClusterMetricsAggregator.for_router(jax_router), telemetry=jax_registry).render_metrics()
    )
    assert set(got) == set(want)
    counters = [key for key in got if key.split("{")[0].endswith("_total")]
    assert counters and {key: got[key] for key in counters} == {key: want[key] for key in counters}
    assert got["dolomite_serving_requests_admitted_total"] == 4
    assert got["dolomite_fleet_replicas"] == 2
    for name in port_telemetry.KNOWN_COUNTERS:
        assert f"dolomite_{name.replace('/', '_')}_total" in got, name


def test_metrics_healthz_statusz_over_http(fleets):
    (router, _, registry), _ = fleets
    server = ObservabilityServer(0, aggregator=ClusterMetricsAggregator.for_router(router), telemetry=registry).start()
    try:
        status, body = _get(f"{server.url}/metrics")
        assert status == 200 and 'dolomite_serving_queue_depth{replica_id="0"} ' in body
        assert '\ndolomite_serving_ttft_s{quantile="0.99"} ' in body
        status, body = _get(f"{server.url}/healthz")
        assert status == 200 and json.loads(body)["replicas"] == {"0": "healthy", "1": "healthy"}
        status, body = _get(f"{server.url}/statusz")
        assert status == 200 and json.loads(body)["fleet"]["replicas"] == 2
        assert _get(f"{server.url}/nonsense")[0] == 404
    finally:
        server.stop()


def test_healthz_flips_on_injected_crash(models):
    injector = FaultInjector([Fault(kind="crash", replica_id=0, at=2)])
    replicas = [EngineReplica(i, port_engine(models), fault_injector=injector) for i in range(2)]
    router = Router(replicas, health=ReplicaHealthMonitor(max_consecutive_exceptions=2, suspect_after_s=30.0, dead_after_s=60.0))
    server = ObservabilityServer(0, aggregator=ClusterMetricsAggregator.for_router(router)).start()
    try:
        assert _get(f"{server.url}/healthz")[0] == 200
        states = [router.submit(**s) for s in _specs(3, seed=6)]
        router.drain(timeout_s=120.0)
        assert all(s.status.value == "completed" for s in states)
        assert router.health.state(0) is ReplicaHealth.dead
        status, body = _get(f"{server.url}/healthz")
        payload = json.loads(body)
        assert status == 503 and payload["status"] == "unhealthy" and payload["dead"] == ["0"]
        assert payload["replicas"]["1"] == "healthy"
        assert json.loads(_get(f"{server.url}/statusz")[1])["fleet"]["health"]["0"] == "dead"
    finally:
        server.stop()


# ------------------------------------------------------------------ SLO burn-rate


class _EngineView:
    """What `ServingSLOMonitor.observe_engine` reads of an engine, from a script."""

    def __init__(self, tier_slos):
        self._step_count = 0
        self.replica_id = 0
        self.speculating = True
        self.scheduler = SimpleNamespace(tier_slos=tier_slos, queue_depth=0)
        self.p99 = {}
        self.rate = None
        self.stats = SimpleNamespace(ttft_p99_s=lambda tier: self.p99.get(tier), accept_rate=lambda: self.rate)


def _alerts(monitor_class, telemetry_class, slo_class):
    """The JAX test's burn sequence on one key, then an engine-fed run (a TTFT p99 over
    target from step 10, the queue jumping at step 40, the accept rate collapsing at step
    50) and a handoff-latency spike: the monitor's alerts."""
    monitor = monitor_class(telemetry_class(), fast_window=3, slow_window=6, warmup=5)
    key, fields = ("ttft", 0, 1), {"signal": "ttft_burn_rate", "replica_id": 0, "tier": 1}
    for step, violated in enumerate((True, True, True, True, False, False, False, True, True, True)):
        monitor._observe_burn(key, step, violated, fields)
    engine = _EngineView({0: slo_class(ttft_target_s=0.5), 2: slo_class(ttft_target_s=60.0)})
    for step in range(60):
        engine._step_count = step
        engine.p99 = {0: 0.2 if step < 10 else 0.9, 2: 1.0}
        engine.scheduler.queue_depth = 2 + step % 2 + (30 if step >= 40 else 0)
        engine.rate = 0.8 + 0.01 * (step % 3) if step < 50 else 0.05
        monitor.observe_engine(engine)
    for step, latency in enumerate([0.001 + 1e-5 * (i % 4) for i in range(20)] + [0.05]):
        monitor.observe_handoff(latency, replica_id=1, step=step)
    return monitor.alerts


def test_slo_monitor_raises_the_jax_alerts():
    got = _alerts(ServingSLOMonitor, Telemetry, TierSLO)
    assert got == _alerts(JaxServingSLOMonitor, jax_telemetry.Telemetry, JaxTierSLO)
    assert {a["signal"] for a in got} == {"ttft_burn_rate", "queue_growth", "accept_rate_collapse", "handoff_latency"}
    assert [a["step"] for a in got if a["signal"] == "ttft_burn_rate" and a["tier"] == 1] == [2, 9]  # gate and re-arm
    assert {a["tier"] for a in got if a["signal"] == "ttft_burn_rate" and a["replica_id"] == 0 and "ttft_p99_ms" in a} == {0}
    with pytest.raises(ValueError):
        ServingSLOMonitor(Telemetry(), fast_window=5, slow_window=3)


def test_two_tier_overload_alerts_violated_tier_only(models, tmp_path):
    sink = tmp_path / "alerts.jsonl"
    telemetry = Telemetry(sink_path=str(sink), rank=0)
    install_telemetry(telemetry)
    try:
        monitor = ServingSLOMonitor(telemetry, fast_window=3, slow_window=10)
        engine = port_engine(models, tier_slos={0: TierSLO(ttft_target_s=60.0), 2: TierSLO(ttft_target_s=1e-6)}, slo_monitor=monitor)
        states = serve_batch(engine, _specs(2, max_new=8, seed=8, priority=0) + _specs(2, max_new=8, seed=9, priority=2))
        assert all(s.status.value == "completed" for s in states)
    finally:
        uninstall_telemetry()
        telemetry.close()
    assert {a["signal"] for a in monitor.alerts} == {"ttft_burn_rate"}
    assert {a["tier"] for a in monitor.alerts} == {2} and len(monitor.alerts) == 1
    assert monitor.alerts[0]["ttft_p99_ms"] > monitor.alerts[0]["ttft_target_ms"]
    assert len([r for r in read_sink(sink) if r.get("event") == "anomaly"]) == 1


# ------------------------------------------------------------------ flight recorder


def test_flight_record_dumped_on_replica_death(models, tmp_path):
    injector = FaultInjector([Fault(kind="crash", replica_id=0, at=2)])
    replicas = [EngineReplica(i, port_engine(models), fault_injector=injector) for i in range(2)]
    dump_path = tmp_path / "flight-record-serving.json"
    router = Router(
        replicas, health=ReplicaHealthMonitor(max_consecutive_exceptions=2, suspect_after_s=30.0, dead_after_s=60.0),
        flight_recorder=FlightRecorder(64, str(dump_path)),
    )
    states = [router.submit(**s) for s in _specs(3, seed=10)]
    router.drain(timeout_s=120.0)
    assert all(s.status.value == "completed" for s in states)
    payload = json.loads(dump_path.read_text())
    assert payload["reason"] == "replica_dead:0" and payload["error"] is not None
    assert any("queue_depths" in r for r in payload["records"])
    assert any(r.get("replica_dead") == 0 for r in payload["records"])


def test_flight_record_dumped_on_engine_exception(models, tmp_path):
    dump_path = tmp_path / "flight-record-engine.json"
    engine = port_engine(models, flight_recorder=FlightRecorder(64, str(dump_path)), replica_id=0)
    assert serve_batch(engine, _specs(1, max_new=2, seed=12))[0].status.value == "completed"
    engine.submit(**_specs(1, seed=13)[0])

    def boom():
        raise RuntimeError("injected engine fault")

    engine._step_once = boom
    with pytest.raises(RuntimeError, match="injected engine fault"):
        engine.step()
    payload = json.loads(dump_path.read_text())
    assert payload["reason"] == "exception:RuntimeError"
    assert payload["records"][-1]["error"] == repr(RuntimeError("injected engine fault"))
    assert all(r.get("replica_id", 0) == 0 for r in payload["records"])


def test_off_path_records_are_unchanged(models, tmp_path):
    """A scraper attached (nothing emitting) leaves the sink's timing-free fields equal,
    record for record, to a run without one; no fleet record and no anomaly appear."""

    def run(sink, scraped):
        telemetry = Telemetry(sink_path=str(sink), rank=0)
        install_telemetry(telemetry)
        try:
            router = Router([EngineReplica(i, port_engine(models)) for i in range(2)])
            server = ObservabilityServer(0, aggregator=ClusterMetricsAggregator.for_router(router)).start() if scraped else None
            try:
                states = [router.submit(**s) for s in _specs(4, seed=14)]
                router.drain(timeout_s=120.0)
                if scraped:
                    assert _get(f"{server.url}/metrics")[0] == 200 and _get(f"{server.url}/healthz")[0] == 200
            finally:
                if server is not None:
                    server.stop()
        finally:
            uninstall_telemetry()
            telemetry.close()
        return [s.tokens for s in states]

    assert run(tmp_path / "off.jsonl", False) == run(tmp_path / "on.jsonl", True)
    timing = ("ts", "ttft_ms", "prefill_tok_s", "decode_tok_s", "handoff_latency_ms", "tiers", "itl_ms")

    def normalize(records):
        return [{k: v for k, v in r.items() if k not in timing} for r in records]

    off, on = normalize(read_sink(tmp_path / "off.jsonl")), normalize(read_sink(tmp_path / "on.jsonl"))
    assert off == on
    assert not any(r["kind"] == "fleet" or r.get("event") == "anomaly" for r in off)


def test_stats_reservoirs_stay_bounded(fleets):
    (router, _, _), _ = fleets
    for replica in router.replicas:
        stats = replica.engine.stats
        assert isinstance(stats.ttft_s, QuantileSketch) and len(stats.ttft_s) <= stats.ttft_s.capacity
        assert stats.mean_ttft_s() == pytest.approx(stats.ttft_s.total / stats.ttft_s.count)
        assert math.isfinite(stats.ttft_p99_s(0) or 0.0)
