"""Per-request tracing in the port against the JAX package, on the CPU.

The cases of `tests/test_serving_tracing.py` over the fleet tests' tiny model
(`tests/torch_fleet.py`, fp32, greedy, 8-token pages): for a plain run, a swap- and a
recompute-preempted request, n-gram speculation, a disaggregated handoff and a routed,
preempted and resumed request, each request's span tree has the JAX engine's span names,
parent structure and counting attributes, span for span in creation order (times and the
``backend`` stamp excluded: the port's chunks say ``plain`` / ``cuda``); every critical
path closes on its TTFT; tracing off writes the same records without the ``trace`` ones
and attaches no trace; `tools/trace_export.py` and `tools/trace_analyze_torch.py` read the
port's sink; the aggregation helpers give the JAX package's numbers.
"""

import json

import numpy as np
import pytest
import torch

from dolomite_engine_tpu.serving import DisaggregatedEngine as JaxDisaggregatedEngine
from dolomite_engine_tpu.serving import EngineReplica as JaxEngineReplica
from dolomite_engine_tpu.serving import Router as JaxRouter
from dolomite_engine_tpu.serving import serve_batch as jax_serve_batch
from dolomite_engine_tpu.utils import tracing as jax_tracing
from dolomite_engine_tpu_torch.serving import (
    DisaggregatedEngine,
    EngineReplica,
    Router,
    TierSLO,
    serve_batch,
)
from dolomite_engine_tpu_torch.utils.telemetry import Telemetry, install_telemetry, uninstall_telemetry
from dolomite_engine_tpu_torch.utils.tracing import (
    KNOWN_SPANS,
    RequestTrace,
    aggregate_critical_paths,
    critical_path,
    trace_record_critical_path,
)
from tests.torch_fleet import fleet_models, for_jax, jax_engine, one_torch_thread, port_engine, read_sink

PAGE = 8
TRACE_ENGINE = dict(max_len=48, page_size=PAGE, trace_requests=True)
# the counting attributes a span carries in both packages (times and `backend` aside)
ATTRS = (
    "tokens", "steps", "segment", "slot", "width", "pages_written", "final", "resume", "tier", "victims_evicted",
    "prefix_hit_tokens", "pages_reserved", "pages_reclaimed", "mode", "mid_prefill", "resident", "pages_swapped_out",
    "pages_swapped_in", "proposed", "accepted", "src_replica", "dst_replica", "pages", "replica_id", "status",
    "generated_tokens", "preemptions", "prompt_tokens", "max_new_tokens", "affinity", "spilled", "session",
)


@pytest.fixture(autouse=True)
def single_thread():
    threads = one_torch_thread()
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return fleet_models()


def _specs(count, length=20, max_new=6, seed=0, **extra):
    rs = np.random.RandomState(seed)
    return [dict(prompt_ids=list(map(int, rs.randint(3, 512, length))), max_new_tokens=max_new, **extra) for _ in range(count)]


def _shape(trace):
    """A trace's spans in creation order as (name, parent's name, counting attributes)."""
    by_id = {span.span_id: span for span in trace.spans}
    return [
        (
            span.name,
            None if span.parent_id is None else by_id[span.parent_id].name,
            {key: span.attrs[key] for key in ATTRS if key in span.attrs},
        )
        for span in trace.spans
    ]


def _assert_closes(state, slack=0.05):
    path = critical_path(state.trace.spans)
    assert path is not None and path["ttft_s"] is not None
    total = sum(path["buckets"].values())
    assert abs(total - path["ttft_s"]) <= slack * path["ttft_s"] + 1e-4, (path["buckets"], path["ttft_s"])
    return path


def _plain(models, jax_side):
    build = jax_engine if jax_side else port_engine
    specs = _specs(4, max_new=5)
    return (jax_serve_batch if jax_side else serve_batch)(build(models, **TRACE_ENGINE), for_jax(specs) if jax_side else specs)


def _preempted(models, jax_side, mode):
    build = jax_engine if jax_side else port_engine
    engine = build(models, **dict(TRACE_ENGINE, max_len=32, num_pages=5, preemption=mode, prefix_caching=mode == "recompute"))
    (hog_spec,) = _specs(1, length=PAGE, max_new=2 * PAGE, seed=1, priority=2)
    (high_spec,) = _specs(1, length=PAGE, max_new=4, seed=2, priority=0)
    hog = engine.submit(**(for_jax([hog_spec])[0] if jax_side else hog_spec))
    engine.step()
    high = engine.submit(**(for_jax([high_spec], 200)[0] if jax_side else high_spec))
    engine.drain()
    assert hog.preemptions == 1
    return [hog, high]


def _speculative(models, jax_side):
    build = jax_engine if jax_side else port_engine
    engine = build(models, **TRACE_ENGINE, speculate_ngram=True, draft_k=4)
    specs = [dict(prompt_ids=[5, 6, 7, 8] * 6, max_new_tokens=12)]
    states = (jax_serve_batch if jax_side else serve_batch)(engine, for_jax(specs) if jax_side else specs)
    windows = states[0].trace.find("verify_window")
    assert windows and sum(w.attrs["proposed"] for w in windows) == engine.stats.draft_tokens_proposed > 0
    return states


def _disaggregated(models, jax_side):
    build = jax_engine if jax_side else port_engine
    disagg_class = JaxDisaggregatedEngine if jax_side else DisaggregatedEngine
    cluster = disagg_class(build(models, **TRACE_ENGINE, prefill_only=True, replica_id=0), [build(models, max_len=48, page_size=PAGE, replica_id=1)])
    specs = _specs(2, max_new=4)
    states = [cluster.submit(**spec) for spec in (for_jax(specs) if jax_side else specs)]
    cluster.drain()
    return states


def _routed(models, jax_side):
    build = jax_engine if jax_side else port_engine
    engine = build(models, **dict(TRACE_ENGINE, max_len=32, num_pages=5, preemption="swap"))
    router = (JaxRouter if jax_side else Router)([(JaxEngineReplica if jax_side else EngineReplica)(0, engine)], trace_requests=True)
    (hog_spec,) = _specs(1, length=PAGE, max_new=2 * PAGE, seed=3, priority=2)
    (high_spec,) = _specs(1, length=PAGE, max_new=4, seed=4, priority=0)
    hog = router.submit(**(for_jax([hog_spec])[0] if jax_side else hog_spec))
    router.step()
    high = router.submit(**(for_jax([high_spec], 200)[0] if jax_side else high_spec))
    router.drain()
    assert hog.preemptions == 1
    return [hog, high]


CASES = {
    "plain": _plain,
    "swap": lambda models, jax_side: _preempted(models, jax_side, "swap"),
    "recompute": lambda models, jax_side: _preempted(models, jax_side, "recompute"),
    "speculative": _speculative,
    "disaggregated": _disaggregated,
    "routed": _routed,
}


@pytest.mark.parametrize("case", list(CASES))
def test_span_trees_match_jax(models, case):
    got = CASES[case](models, False)
    want = CASES[case](models, True)
    assert [s.tokens for s in got] == [s.tokens for s in want]
    for state, reference in zip(got, want):
        assert _shape(state.trace) == _shape(reference.trace)
        assert {s.name for s in state.trace.spans} <= set(KNOWN_SPANS)
        ids = {s.span_id for s in state.trace.spans}
        assert all(s.parent_id in ids for s in state.trace.spans if s is not state.trace.root)
        assert state.trace.root.t1 is not None and state.trace.root.attrs["status"] == "completed"
        _assert_closes(state)
    if case == "disaggregated":
        for state in got:
            (handoff,) = state.trace.find("handoff")
            assert (handoff.attrs["src_replica"], handoff.attrs["dst_replica"]) == (0, 1) and handoff.attrs["transfer_ms"] >= 0


def test_plain_tree_is_contiguous_and_closes(models):
    for state in _plain(models, False):
        tr = state.trace
        (queue,) = tr.find("queue_wait")
        (admission,) = tr.find("admission")
        (prefill,) = tr.find("prefill")
        (decode,) = tr.find("decode")
        assert queue.t1 == admission.t0 and admission.t1 == prefill.t0 and prefill.t1 == decode.t0
        assert queue.t0 == tr.root.t0 == state.submit_t
        chunks = tr.find("prefill_chunk")
        assert sum(c.attrs["tokens"] for c in chunks) == len(state.request.prompt_ids)
        assert all(c.attrs["backend"] == "plain" for c in chunks)  # the CPU: the plain versions
        assert decode.attrs["tokens"] == state.num_generated - 1
        assert _assert_closes(state)["buckets"]["parked"] == 0.0


def _run_to_sink(models, sink, trace):
    telemetry = Telemetry(sink_path=str(sink), rank=0)
    install_telemetry(telemetry)
    try:
        engine = port_engine(models, max_len=48, page_size=PAGE, trace_requests=trace, record_interval=3)
        states = serve_batch(engine, _specs(4))
    finally:
        uninstall_telemetry()
        telemetry.close()
    return states


def test_trace_off_is_free(models, tmp_path):
    """Tracing off: no trace object, no trace record, and every other record has the
    kind and fields of the traced run's (the values are times); the tokens are equal."""
    off = _run_to_sink(models, tmp_path / "off.jsonl", False)
    on = _run_to_sink(models, tmp_path / "on.jsonl", True)
    assert [s.tokens for s in off] == [s.tokens for s in on]
    assert all(s.trace is None for s in off) and all(s.trace is not None for s in on)
    records_off, records_on = read_sink(tmp_path / "off.jsonl"), read_sink(tmp_path / "on.jsonl")
    assert "trace" not in [r["kind"] for r in records_off]
    assert [r["kind"] for r in records_on].count("trace") == 4
    rest = [r for r in records_on if r["kind"] != "trace"]
    assert [r["kind"] for r in records_off] == [r["kind"] for r in rest]
    for a, b in zip(records_off, rest):
        assert set(a) == set(b)
    assert sum(r["kind"] == "serving" for r in records_off) >= 2  # record_interval and drain


@pytest.fixture(scope="module")
def traced_sink(models, tmp_path_factory):
    """One traced contended run's sink (with a torn last line), for the tools."""
    sink = tmp_path_factory.mktemp("traced") / "telemetry.jsonl"
    telemetry = Telemetry(sink_path=str(sink), rank=0)
    install_telemetry(telemetry)
    threads = one_torch_thread()
    try:
        engine = port_engine(
            models, **dict(TRACE_ENGINE, max_len=32, num_pages=5, preemption="swap"),
            tier_slos={0: TierSLO(ttft_target_s=0.5), 2: TierSLO(ttft_target_s=60.0)},
        )
        hog = engine.submit(**_specs(1, length=PAGE, max_new=2 * PAGE, seed=5, priority=2)[0])
        engine.step()
        engine.submit(**_specs(1, length=PAGE, max_new=4, seed=6, priority=0)[0])
        engine.drain()
        assert hog.preemptions == 1
    finally:
        torch.set_num_threads(threads)
        uninstall_telemetry()
        telemetry.close()
    with open(sink, "a") as f:
        f.write('{"kind": "trace", "trace_id": "torn-mid-')
    return sink


def test_trace_export_reads_the_port_sink(traced_sink, tmp_path):
    from tools import trace_export

    out = tmp_path / "perfetto.json"
    assert trace_export.main([str(traced_sink), "-o", str(out)]) == 0
    events = json.loads(out.read_text())["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    assert complete and {e["name"] for e in complete} <= set(KNOWN_SPANS)
    assert all(e["ts"] >= 0 and e["dur"] >= 0 and "trace_id" in e["args"] for e in complete)
    assert any(e["name"] == "preempt_park" for e in complete)
    names = {e["args"]["name"] for e in events if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "scheduler" in names and any(n.startswith("slot ") for n in names)


def test_trace_analyze_torch_attributes_by_tier(traced_sink, capsys):
    from tools import trace_analyze_torch

    assert trace_analyze_torch.main([str(traced_sink), "--per-request"]) == 0
    out = capsys.readouterr().out
    assert "critical-path TTFT attribution" in out and "| tier |" in out
    assert trace_analyze_torch.main([str(traced_sink), "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["requests"] == 2 and "0" in payload["slo_ttft_s_by_tier"]
    assert set(payload["tiers"]) == {"0", "2"}
    for entry in payload["tiers"].values():
        total = sum(entry["mean_buckets_s"].values())
        assert abs(total - entry["ttft_p50_s"]) <= 0.05 * entry["ttft_p50_s"] + 1e-3


def test_threaded_replicas_write_whole_trace_records(models, tmp_path):
    """Two replica threads finish requests at once: every sink line parses, each trace's
    span ids are unique and increasing, and the export gives one track per replica."""
    from tools.trace_export import export_trace_events

    sink = tmp_path / "telemetry.jsonl"
    telemetry = Telemetry(sink_path=str(sink), rank=0)
    install_telemetry(telemetry)
    try:
        router = Router([EngineReplica(i, port_engine(models, max_len=48, page_size=PAGE, trace_requests=True)) for i in range(2)], trace_requests=True)
        router.start()
        try:
            states = [router.submit(**spec) for spec in _specs(6, length=12, max_new=4, seed=11)]
            assert router.wait(timeout_s=120.0)
        finally:
            router.stop()
    finally:
        uninstall_telemetry()
        telemetry.close()
    assert all(s.status.value == "completed" for s in states)
    traces = [r for r in read_sink(sink) if r["kind"] == "trace"]
    assert len({t["trace_id"] for t in traces}) == 6
    for trace in traces:
        ids = [s["id"] for s in trace["spans"]]
        assert ids == sorted(set(ids))
    complete = [e for e in export_trace_events(traces)["traceEvents"] if e["ph"] == "X"]
    assert len({e["pid"] for e in complete}) >= 2


def test_critical_path_aggregation_matches_jax():
    """The analysis helpers on one hand-built trace: the port's numbers are the JAX
    package's."""

    def build(module):
        clock = iter(np.arange(0.0, 100.0, 0.5))
        trace = module.RequestTrace(trace_id="fixed", request_id=7, clock=lambda: next(clock))
        root = trace.ensure_root(t0=0.0, tier=1)
        for name, t0, t1 in (("queue_wait", 0.0, 3.0), ("admission", 3.0, 3.1), ("prefill", 3.1, 4.0)):
            trace.end(trace.begin(name, parent=root, t0=t0, segment=0), t1=t1)
        root.attrs["ttft_s"] = 4.0
        trace.end(root, t1=6.0, status="completed")
        path = module.trace_record_critical_path(trace.to_record())
        return path, module.aggregate_critical_paths([path], {1: 1.0}), module.percentile([1.0, 2.0, 3.0, 4.0], 0.5)

    import dolomite_engine_tpu_torch.utils.tracing as port_tracing

    got, want = build(port_tracing), build(jax_tracing)
    assert got == want
    assert got[0]["buckets"]["queue"] == pytest.approx(3.0) and got[1][1]["miss_top_bucket"] == "queue"
    assert RequestTrace is port_tracing.RequestTrace
    assert trace_record_critical_path is port_tracing.trace_record_critical_path
    assert aggregate_critical_paths is port_tracing.aggregate_critical_paths
