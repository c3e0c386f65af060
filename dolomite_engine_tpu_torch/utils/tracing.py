"""Per-request distributed tracing: span-structured request lifecycles for the serving tier.

(Copy of `dolomite_engine_tpu/utils/tracing.py`: the port keeps its own, as it imports nothing of the JAX package.)

Aggregate telemetry (counters, gauges, `serving`/`router` window records) answers "how is
the fleet doing"; it cannot answer "where did THIS request's time go" — the question every
TTFT SLO miss raises. This module is the per-request layer: a lightweight span API (the
same `trace_id`/`span_id`/parent/start/end/attributes shape as OpenTelemetry or vLLM's
request-timeline instrumentation, with zero dependencies) that the serving stack populates
end to end. One request yields ONE tree, whatever path it took: the `trace_id` rides the
:class:`~dolomite_engine_tpu_torch.serving.scheduler.RequestState` through the router
(`serving/cluster/router.py`), the scheduler, the engine's admission / chunked prefill /
decode / speculative verify, preemption park-and-resume, and a disaggregated prefill →
decode KV handoff (the handed-off `RequestState` carries the live trace across the seam,
so spans from both workers land in the same tree).

Traces are **off by default and zero-cost when off**: no trace object is ever allocated,
every instrumentation site is a single ``state.trace is not None`` check, nothing extra is
emitted to the telemetry sink, and no device work changes (tracing is pure host-side
bookkeeping — launch and host-sync counts are asserted unchanged in
tests/test_torch_serving_tracing.py).
Enabled via ``ServingEngine(trace_requests=True)`` / ``Router(trace_requests=True)`` /
``GenerationParameters.trace_requests`` / ``--trace`` on the serving CLIs, each finished
request emits one ``trace`` record (kind declared in `utils/telemetry.py` RECORD_SCHEMA)
into the same always-on JSONL sink as everything else.

Span names are a closed vocabulary (:data:`KNOWN_SPANS`); the dolo-lint ``tracing``
checker validates every literal call site against it, both directions, exactly like the
telemetry checker does for counters/gauges.

Phase spans are **contiguous by construction** — each phase begins at the timestamp the
previous one ended — so the critical-path TTFT decomposition
(:func:`critical_path`: queue + admission + prefill + parked ≈ measured TTFT) sums
exactly up to host bookkeeping, which is what lets tests assert the 5%% closure and lets
`tools/trace_analyze.py` say "tier-1 p99 misses are 71%% queue wait". `tools/
trace_export.py` converts trace records to Perfetto/Chrome ``trace_event`` JSON (one
track per replica/slot) for timeline inspection.
"""

from __future__ import annotations

import itertools
import time
import uuid
from typing import Any, Callable

# Span-name vocabulary: every literal name passed to `RequestTrace.begin` must be a key
# here (dolo-lint rule `tracing-unknown-span`; a declared name with no call site is
# `tracing-dead-span`). Docs: docs/OBSERVABILITY.md "Per-request tracing" span catalog.
KNOWN_SPANS: dict[str, str] = {
    # the root: submit -> finish; attrs carry tier, prompt/generated token counts,
    # ttft_s (stamped at first token), final status, preemption count
    "request": "whole request lifecycle (root span)",
    # router placement decision (serving/cluster/router.py): which replica and why
    "route": "router replica selection (policy, chosen replica, spill)",
    # one segment per wait: segment 0 is submit -> first admission; re-enqueued
    # (preempted) requests open a new segment PARENTED UNDER their preempt_park span
    "queue_wait": "waiting in the scheduler queue (per tier, one segment per enqueue)",
    # pop -> slot installed, incl. preemption-victim selection and page reclamation
    "admission": "admission attempt (victim selection, pages reserved, prefix hits)",
    # admission -> first token (or resume recompute); chunk children carry the
    # compute-vs-interleave split
    "prefill": "prefill phase of one residency (chunked; ends at first token)",
    "prefill_chunk": "one chunked-prefill device call (tokens, pages, kernel backend)",
    # one segment per residency: first token / resume -> finish / preempt; per-token
    # decode segments aggregate into this span's tokens/steps attrs (ITL = dur/tokens)
    "decode": "decode phase of one residency (aggregated per-token segments)",
    # speculative decoding: one verify forward scoring K+1 positions for this slot
    "verify_window": "speculative verify window (proposed vs accepted drafts)",
    # eviction -> decoding again; swap attrs carry page/byte traffic, recompute resumes
    # nest their queue_wait/admission/prefill spans under this span (re-parenting)
    "preempt_park": "preempted: parked (swap) or dropped (recompute) until resumed",
    # disaggregation: first token on the prefill worker -> pages adopted on the decode
    # worker (gather/scatter transfer latency, src/dst replica)
    "handoff": "prefill->decode KV page handoff across the disaggregation seam",
    # fleet fault tolerance (serving/cluster/router.py): replica died/drained mid-
    # flight -> adopted by a survivor (src/dst replica, committed tokens, attempts);
    # the adoptive replica's recompute-resume spans follow under the same root
    "reroute": "in-flight migration to a surviving replica (crash recovery / drain)",
}

# critical-path buckets for the TTFT window, in reporting order; spans map via
# _SPAN_BUCKET and only TOP-LEVEL phase spans (parent == root) are counted, so nested
# re-enqueue segments under a park span never double-bill
TTFT_BUCKETS = ("queue", "admission", "prefill", "parked", "handoff")

_SPAN_BUCKET = {
    "queue_wait": "queue",
    "admission": "admission",
    "prefill": "prefill",
    "preempt_park": "parked",
    "handoff": "handoff",
}


class Span:
    """One named, timed node of a request trace. ``t1 is None`` until ended."""

    __slots__ = ("span_id", "parent_id", "name", "t0", "t1", "attrs")

    def __init__(self, span_id: int, parent_id: int | None, name: str, t0: float, attrs: dict):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1: float | None = None
        self.attrs = attrs

    @property
    def duration_s(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> dict:
        return {
            "id": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "t0": round(self.t0, 6),
            "t1": None if self.t1 is None else round(self.t1, 6),
            "attrs": self.attrs,
        }


class RequestTrace:
    """The span tree of one request, shared by every component it passes through.

    The ``clock`` must be the same one the owning scheduler measures TTFT with (the
    engine passes ``scheduler.clock``), so span boundaries and the latency they explain
    live on one timeline. ``open`` holds the currently-open phase spans by name (the
    engine's bookkeeping); ``phase_parent`` is the span new phases nest under — the
    root normally, the active ``preempt_park`` span while a preempted request waits and
    re-admits (which is what re-parents re-enqueue segments under the park).
    """

    __slots__ = ("trace_id", "request_id", "clock", "spans", "root", "open", "phase_parent", "_ids")

    def __init__(
        self,
        trace_id: str | None = None,
        request_id: int | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.request_id = request_id
        self.clock = clock
        self.spans: list[Span] = []
        self.root: Span | None = None
        self.open: dict[str, Span] = {}
        self.phase_parent: Span | None = None
        self._ids = itertools.count(1)

    def begin(self, name: str, parent: Span | None = None, t0: float | None = None, **attrs: Any) -> Span:
        """Open (and record) a span. Span names must come from :data:`KNOWN_SPANS`
        (statically checked by the dolo-lint tracing rule)."""
        span = Span(
            next(self._ids),
            parent.span_id if parent is not None else None,
            name,
            self.clock() if t0 is None else t0,
            attrs,
        )
        self.spans.append(span)
        if self.root is None and parent is None:
            self.root = span
        return span

    def end(self, span: Span, t1: float | None = None, **attrs: Any) -> Span:
        span.t1 = self.clock() if t1 is None else t1
        if attrs:
            span.attrs.update(attrs)
        return span

    def drop(self, span: Span) -> None:
        """Unrecord a span (an admission attempt that rolled back, never completed)."""
        try:
            self.spans.remove(span)
        except ValueError:
            pass

    def ensure_root(self, t0: float | None = None, **attrs: Any) -> Span:
        """The root ``request`` span — created here on first need (engine submit, or the
        router before it), reused afterwards so router + engine share one tree."""
        if self.root is None:
            # dolint: the literal below IS the declaration-side name
            self.root = self.begin("request", t0=t0, **attrs)
        elif attrs:
            self.root.attrs.update(attrs)
        return self.root

    def find(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def span_records(self) -> list[dict]:
        return [s.to_dict() for s in self.spans]

    def to_record(self) -> dict:
        """The payload of one ``trace`` telemetry record (RECORD_SCHEMA kind)."""
        return {
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "spans": self.span_records(),
        }


# ---------------------------------------------------------------------- analysis

def _span_dicts(spans) -> list[dict]:
    return [s.to_dict() if isinstance(s, Span) else s for s in spans]


def critical_path(spans) -> dict | None:
    """Critical-path TTFT decomposition of one trace (Span objects or record dicts).

    The TTFT window is ``[submit, submit + ttft_s]`` (``ttft_s`` stamped on the root at
    first token; submit = the first queue segment's start). Only top-level phase spans
    (parent == root) are counted — their children (prefill chunks, re-enqueue segments
    under a park) refine, never add. Phases are contiguous by construction, so
    ``sum(buckets) ≈ ttft_s`` up to host bookkeeping between phases (``unattributed_s``).
    Returns None for a spanless/rootless record; ``ttft_s`` is None when the request
    never produced a token (cancelled while waiting — the whole window is queue time).
    """
    spans = _span_dicts(spans)
    root = next((s for s in spans if s["name"] == "request"), None)
    if root is None:
        return None
    attrs = root.get("attrs") or {}
    ttft = attrs.get("ttft_s")
    queue0 = [s for s in spans if s["name"] == "queue_wait" and s["parent"] == root["id"]]
    anchor = min((s["t0"] for s in queue0), default=root["t0"])
    window_end = None if ttft is None else anchor + ttft

    buckets = {name: 0.0 for name in TTFT_BUCKETS}
    route_s = decode_s = 0.0
    fallback_end = root["t1"] if root["t1"] is not None else max(
        (s["t1"] for s in spans if s["t1"] is not None), default=anchor
    )
    for span in spans:
        if span["parent"] != root["id"]:
            continue
        t0 = span["t0"]
        t1 = span["t1"] if span["t1"] is not None else fallback_end
        if span["name"] == "route":
            route_s += max(t1 - t0, 0.0)
            continue
        if span["name"] == "decode":
            decode_s += max(t1 - t0, 0.0)
            continue
        bucket = _SPAN_BUCKET.get(span["name"])
        if bucket is None:
            continue
        if window_end is not None:
            t0, t1 = max(t0, anchor), min(t1, window_end)
        buckets[bucket] += max(t1 - t0, 0.0)

    attributed = sum(buckets.values())
    return {
        "trace_id": None,  # filled by record-level callers
        "request_id": attrs.get("request_id"),
        "tier": attrs.get("tier"),
        "ttft_s": ttft,
        "buckets": buckets,
        "attributed_s": attributed,
        "unattributed_s": None if ttft is None else max(ttft - attributed, 0.0),
        "route_s": route_s,
        "decode_s": decode_s,
        "preemptions": attrs.get("preemptions", 0),
        "status": attrs.get("status"),
    }


def trace_record_critical_path(record: dict) -> dict | None:
    """`critical_path` over one ``trace`` telemetry record (kind == "trace")."""
    result = critical_path(record.get("spans") or [])
    if result is not None:
        result["trace_id"] = record.get("trace_id")
        if result.get("request_id") is None:
            result["request_id"] = record.get("request_id")
    return result


def percentile(samples: list[float], q: float) -> float | None:
    """Nearest-rank percentile (deterministic, matches EngineStats' convention)."""
    if not samples:
        return None
    ordered = sorted(samples)
    rank = min(len(ordered) - 1, max(0, int(-(-q * len(ordered) // 1)) - 1))
    return ordered[rank]


def aggregate_critical_paths(
    paths: list[dict], slo_ttft_s_by_tier: dict[int, float] | None = None
) -> dict:
    """Fleet-level attribution over many per-request decompositions.

    Returns ``{tier: {count, ttft_p50_s, ttft_p99_s, mean_buckets_s, bucket_shares,
    top_bucket, slo_ttft_s, misses, miss_top_bucket, miss_bucket_shares}}`` — the
    per-tier "p99 misses are N%% queue wait" answer. Tier None collects untiered
    requests; requests without a TTFT (cancelled while waiting) count toward ``count``
    but not the latency stats.
    """
    slo_ttft_s_by_tier = slo_ttft_s_by_tier or {}
    by_tier: dict[Any, list[dict]] = {}
    for path in paths:
        if path is None:
            continue
        by_tier.setdefault(path.get("tier"), []).append(path)

    def _bucket_stats(group: list[dict]) -> tuple[dict, dict, str | None]:
        sums = {name: 0.0 for name in TTFT_BUCKETS}
        for path in group:
            for name, value in path["buckets"].items():
                sums[name] += value
        total = sum(sums.values())
        means = {k: v / len(group) for k, v in sums.items()} if group else sums
        shares = {k: (v / total if total > 0 else 0.0) for k, v in sums.items()}
        top = max(shares, key=shares.get) if total > 0 else None
        return means, shares, top

    out: dict = {}
    for tier, group in sorted(by_tier.items(), key=lambda kv: (kv[0] is None, kv[0])):
        ttfts = [p["ttft_s"] for p in group if p["ttft_s"] is not None]
        means, shares, top = _bucket_stats(group)
        entry = {
            "count": len(group),
            "ttft_p50_s": percentile(ttfts, 0.50),
            "ttft_p99_s": percentile(ttfts, 0.99),
            "mean_buckets_s": means,
            "bucket_shares": shares,
            "top_bucket": top,
        }
        target = slo_ttft_s_by_tier.get(tier)
        if target is not None:
            misses = [p for p in group if p["ttft_s"] is not None and p["ttft_s"] > target]
            _, miss_shares, miss_top = _bucket_stats(misses)
            entry.update(
                slo_ttft_s=target,
                misses=len(misses),
                miss_bucket_shares=miss_shares,
                miss_top_bucket=miss_top,
            )
        out[tier] = entry
    return out
