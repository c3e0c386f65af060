"""Offline continuous-batching driver of the PyTorch port: prompts in, generations and serving stats out.

    python tools/serve_torch.py --model /path/to/dolomite-model \
        --prompt "def factorial(x):" --prompt "fibonacci in rust" \
        --max-new-tokens 128 --num-slots 8 --replicas 2 --disaggregate --trace \
        --metrics-port 0 --telemetry-sink serve.jsonl

The port's counterpart of `tools/serve.py`: every prompt becomes one request with its own
sampling params and deadline; the engine (`dolomite_engine_tpu_torch/serving/`) admits
them into KV slots as capacity frees up, or the fleet (`serving/cluster/`) routes them over
--replicas engines, each split into a prefill and a decode engine under --disaggregate.
Results print as JSONL in submission order; a summary (TTFT, prefill/decode tokens per
second, admission counters, the router's placement and handoffs) goes to stderr, and
--telemetry-sink records the `serving`, `router`, `fleet` and `trace` records. It runs on
the GPU unless ``--device cpu`` is given. Not ported: --tp (ROADMAP.md Queue A,
'Distribution'), --program-signatures (Queue A, 'Serving fleet and observability') and
--kernels (the port has no backend switch: a tensor's device picks the kernel).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True, help="dolomite-format model directory")
    p.add_argument("--prompt", action="append", default=[], help="prompt text (repeatable)")
    p.add_argument("--prompt-file", help="file with one prompt per line")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--do-sample", action="store_true")
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--num-slots", type=int, default=8, help="max concurrent requests")
    p.add_argument(
        "--max-len",
        type=int,
        default=None,
        help="per-slot cache length (default: longest prompt bucket + max_new_tokens)",
    )
    p.add_argument("--bucket-multiple", type=int, default=64, help="prefill width bucket")
    p.add_argument(
        "--dense-kv",
        action="store_true",
        help="use the dense [num_slots, max_len] slot pool instead of the paged pool",
    )
    p.add_argument("--page-size", type=int, default=16, help="tokens per KV page (multiple of 8)")
    p.add_argument(
        "--num-pages",
        type=int,
        default=None,
        help="physical KV pages (default: dense-parity capacity; set to the HBM budget "
        "to oversubscribe slots)",
    )
    p.add_argument(
        "--kv-dtype",
        type=str,
        default=None,
        choices=["bf16", "int8", "fp8"],
        help="paged-pool page storage: bf16 halves page bytes vs fp32; int8/fp8 store "
        "quantized pages + per-page scales (~2x sustainable slots again at fixed HBM, "
        "tolerance-level accuracy). Default: model/cache dtype",
    )
    p.add_argument(
        "--prefill-chunk-tokens",
        type=int,
        default=512,
        help="per-step prefill token budget (chunked prefill; multiple of 8)",
    )
    p.add_argument(
        "--no-prefix-cache",
        action="store_true",
        help="disable prefix caching (page-aligned prompt prefix reuse)",
    )
    p.add_argument(
        "--priority",
        type=int,
        default=0,
        help="priority tier for every request this run submits (0 = top tier; "
        "admission, prefill budget, and preemption are ordered tier-then-FCFS)",
    )
    p.add_argument(
        "--preemption",
        choices=["off", "swap", "recompute"],
        default="off",
        help="evict lower-tier slots when a higher-tier request cannot admit (or an "
        "oversubscribed pool runs dry): swap parks KV pages host-side "
        "(byte-identical restore), recompute rebuilds through the prefix cache; "
        "resumed requests are token-for-token identical either way",
    )
    p.add_argument(
        "--oversubscribe-ratio",
        type=float,
        default=1.0,
        help="admit up to ratio x allocatable pages of worst-case reservations "
        "(>= 1.0; > 1 requires --preemption swap|recompute)",
    )
    p.add_argument(
        "--session-id",
        default=None,
        help="treat every prompt as one turn of this conversation: finished turns pin "
        "their prefix pages against LRU eviction until the session TTL lapses",
    )
    p.add_argument(
        "--session-ttl",
        type=float,
        default=300.0,
        help="seconds a session's pinned prefix pages survive without a new turn",
    )
    p.add_argument(
        "--speculate-ngram",
        action="store_true",
        help="speculative decoding via n-gram/prompt-lookup self-drafting (no extra "
        "model; mutually exclusive with --draft-model)",
    )
    p.add_argument(
        "--draft-model",
        default=None,
        help="smaller dolomite-format checkpoint that drafts for the target "
        "(speculative decoding; must share the target's tokenizer)",
    )
    p.add_argument(
        "--draft-k",
        type=int,
        default=4,
        help="draft tokens proposed per engine step (K >= 1)",
    )
    p.add_argument(
        "--tp",
        type=int,
        default=1,
        help="tensor-parallel size per engine replica: not ported (ROADMAP.md Queue A, "
        "'Distribution'); only 1 runs",
    )
    p.add_argument(
        "--replicas",
        type=int,
        default=1,
        help="engine replicas behind the telemetry-driven router "
        "(serving/cluster/router.py): prefix-affinity + least-loaded selection",
    )
    p.add_argument(
        "--disaggregate",
        action="store_true",
        help="split each replica into a prefill worker and a decode worker with an "
        "explicit KV page handoff (serving/cluster/disagg.py)",
    )
    p.add_argument(
        "--health-monitoring",
        action="store_true",
        help="fleet fault tolerance (docs/FAULT_TOLERANCE.md 'Serving fleet'): "
        "heartbeat every replica step, declare crashed/wedged replicas dead "
        "(healthy->suspect->dead with telemetry events), and migrate their in-flight "
        "requests to surviving replicas token for token. Implies the router path even with "
        "--replicas 1; zero overhead when off",
    )
    p.add_argument(
        "--trace",
        action="store_true",
        help="per-request distributed tracing (docs/OBSERVABILITY.md): every request "
        "emits a span tree (queue/admission/prefill chunks/decode/preemption/handoff) "
        "as `trace` records into --telemetry-sink; render with tools/trace_export.py "
        "(Perfetto) and tools/trace_analyze_torch.py (critical-path TTFT attribution). Off "
        "by default; zero overhead when off",
    )
    p.add_argument(
        "--program-signatures",
        action="store_true",
        help="the JAX engine's compiled-program records: not ported (ROADMAP.md Queue A, "
        "'Serving fleet and observability')",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        help="serve live observability endpoints on 127.0.0.1:<port> while the batch "
        "runs (docs/OBSERVABILITY.md 'Live metrics'): Prometheus /metrics, /healthz "
        "(503 once any replica is declared dead), /statusz (fleet JSON). Also emits "
        "`fleet` telemetry records (cross-replica aggregate) into --telemetry-sink. "
        "0 binds an ephemeral port; off by default with byte-identical records",
    )
    p.add_argument(
        "--slo-alerts",
        action="store_true",
        help="SLO burn-rate alerting over serving signals (per-tier TTFT p99 vs "
        "--ttft-slo-ms, queue growth, accept-rate collapse, KV-handoff latency): "
        "emits `anomaly` telemetry events with fast/slow burn-rate fields; off by "
        "default with byte-identical records",
    )
    p.add_argument(
        "--ttft-slo-ms",
        type=float,
        default=None,
        help="TTFT p99 target (ms) for the submitted --priority tier; the SLO the "
        "--slo-alerts burn-rate monitor gates against",
    )
    p.add_argument(
        "--flight-record",
        default=None,
        help="serving flight recorder: ring-buffer recent engine/router step records "
        "and dump them as JSON to this path on replica death or unhandled engine "
        "exception (docs/OBSERVABILITY.md 'Live metrics')",
    )
    p.add_argument("--max-waiting", type=int, default=128, help="waiting-queue bound")
    p.add_argument("--deadline-s", type=float, default=None, help="per-request wall budget")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", help="write JSONL here instead of stdout")
    p.add_argument("--telemetry-sink", help="serving telemetry JSONL path")
    p.add_argument("--dtype", default="bf16", choices=["fp32", "bf16"], help="compute dtype of the model")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Serve every prompt; prints one JSON line each and the summary, and returns the
    requests' states."""
    args = parse_args(argv)

    prompts = list(args.prompt)
    if args.prompt_file:
        with open(args.prompt_file) as f:
            prompts.extend(line.rstrip("\n") for line in f if line.strip())
    if not prompts:
        raise SystemExit("no prompts: pass --prompt and/or --prompt-file")

    from dolomite_engine_tpu_torch.device import resolve_device
    from dolomite_engine_tpu_torch.enums import Mode
    from dolomite_engine_tpu_torch.generate import load_draft_model
    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning
    from dolomite_engine_tpu_torch.serving import SamplingParams, ServingEngine, serve_batch
    from dolomite_engine_tpu_torch.utils.telemetry import Telemetry, install_telemetry, uninstall_telemetry

    if args.replicas < 1:
        raise SystemExit(f"--replicas must be >= 1, got {args.replicas}")
    if args.tp != 1:
        raise NotImplementedError(f"--tp {args.tp} is not ported yet: ROADMAP.md Queue A, 'Distribution'")
    if args.program_signatures:
        raise NotImplementedError(
            "--program-signatures is not ported yet: ROADMAP.md Queue A, 'Serving fleet and observability'"
        )
    device = resolve_device(args.device)
    model = ModelWrapperForFinetuning(None, mode=Mode.inference, model_name=args.model, dtype=args.dtype, device="meta")
    model.load_pretrained_params(args.model, device)
    assert model.tokenizer is not None, "serving requires a tokenizer"

    telemetry = None
    if args.telemetry_sink:
        telemetry = Telemetry(sink_path=args.telemetry_sink, device=device)
        install_telemetry(telemetry)

    # live observability plane (all default-off; the off path builds none of this and
    # its telemetry records stay byte-identical)
    from dolomite_engine_tpu_torch.utils.telemetry import get_telemetry

    slo_monitor = None
    if args.slo_alerts:
        from dolomite_engine_tpu_torch.utils.diagnostics import ServingSLOMonitor

        slo_monitor = ServingSLOMonitor(get_telemetry())
    flight_recorder = None
    if args.flight_record:
        from dolomite_engine_tpu_torch.utils.diagnostics import FlightRecorder

        flight_recorder = FlightRecorder(256, args.flight_record)
    tier_slos = None
    if args.ttft_slo_ms is not None:
        from dolomite_engine_tpu_torch.serving import TierSLO

        tier_slos = {args.priority: TierSLO(ttft_target_s=args.ttft_slo_ms / 1e3)}

    draft_model, draft_params = load_draft_model(args.draft_model, device)

    prompt_ids = [
        model.tokenizer(text, add_special_tokens=False)["input_ids"] for text in prompts
    ]
    multiple = args.bucket_multiple
    max_len = args.max_len
    if max_len is None:
        longest = max(len(ids) for ids in prompt_ids)
        max_len = -(-longest // multiple) * multiple + args.max_new_tokens

    pad_token_id = next(
        (t for t in (model.tokenizer.pad_token_id, model.eos_token_id) if t is not None), 0
    )

    def build_engine(**overrides):
        kwargs = dict(
            num_slots=args.num_slots,
            max_len=max_len,
            prefill_bucket_multiple=multiple,
            max_waiting=args.max_waiting,
            eos_token_id=model.eos_token_id,
            pad_token_id=pad_token_id,
            seed=args.seed,
            record_interval=100,
            paged=not args.dense_kv,
            page_size=args.page_size,
            num_pages=args.num_pages,
            kv_dtype=args.kv_dtype,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            prefix_caching=not args.no_prefix_cache,
            preemption=args.preemption,
            oversubscribe_ratio=args.oversubscribe_ratio,
            session_ttl_s=args.session_ttl,
            speculate_ngram=args.speculate_ngram,
            draft_model=draft_model,
            draft_params=draft_params,
            draft_k=args.draft_k,
            trace_requests=args.trace,
            tier_slos=tier_slos,
            slo_monitor=slo_monitor,
            flight_recorder=flight_recorder,
            device=device,
        )
        kwargs.update(overrides)
        return ServingEngine(model.model, None, **kwargs)

    router = None
    if args.replicas > 1 or args.disaggregate or args.health_monitoring:
        from dolomite_engine_tpu_torch.serving.cluster import (
            DisaggregatedEngine,
            EngineReplica,
            ReplicaHealthMonitor,
            Router,
        )

        if args.disaggregate and args.dense_kv:
            raise SystemExit("--disaggregate requires the paged KV pool (drop --dense-kv)")
        replicas = []
        for replica_id in range(args.replicas):
            if args.disaggregate:
                prefill = build_engine(
                    prefill_only=True,
                    speculate_ngram=False,
                    draft_model=None,
                    draft_params=None,
                    preemption="off",
                    oversubscribe_ratio=1.0,
                )
                replica_engine = DisaggregatedEngine(prefill, [build_engine()])
            else:
                replica_engine = build_engine()
            replicas.append(EngineReplica(replica_id, replica_engine))
        router = Router(
            replicas,
            record_interval=100,
            trace_requests=args.trace,
            health=ReplicaHealthMonitor() if args.health_monitoring else None,
            slo_monitor=slo_monitor,
            flight_recorder=flight_recorder,
        )
    else:
        engine = build_engine()

    obs_server = None
    if args.metrics_port is not None:
        from dolomite_engine_tpu_torch.serving import ClusterMetricsAggregator, ObservabilityServer

        if router is not None:
            aggregator = ClusterMetricsAggregator.for_router(router)
            router.metrics = aggregator  # fleet records ride the router record cadence
        else:
            aggregator = ClusterMetricsAggregator([engine])
        obs_server = ObservabilityServer(
            args.metrics_port, aggregator=aggregator, slo_monitor=slo_monitor
        ).start()
        print(
            f"observability: {obs_server.url}/metrics (/healthz, /statusz)",
            file=sys.stderr,
        )

    sampling = SamplingParams(
        do_sample=args.do_sample,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
    )
    specs = [
        dict(
            prompt_ids=ids,
            max_new_tokens=args.max_new_tokens,
            sampling=sampling,
            deadline_s=args.deadline_s,
            priority=args.priority,
            session_id=args.session_id,
        )
        for ids in prompt_ids
    ]
    if router is not None:
        from dolomite_engine_tpu_torch.serving.cluster import route_batch

        states = route_batch(router, specs)
    else:
        states = serve_batch(engine, specs)

    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for text, state in zip(prompts, states):
            out.write(
                json.dumps(
                    {
                        "prompt": text,
                        "generated_text": model.tokenizer.decode(
                            state.tokens, skip_special_tokens=True
                        ),
                        "num_generated_tokens": state.num_generated,
                        "status": str(state.status),
                        "ttft_ms": None
                        if state.ttft_s is None
                        else round(state.ttft_s * 1e3, 1),
                    }
                )
                + "\n"
            )
    finally:
        if out is not sys.stdout:
            out.close()

    if obs_server is not None:
        if router is None:
            # router runs emit the aggregate on the router record cadence; single-engine
            # runs get one final fleet record so the sink always carries the aggregate
            obs_server.aggregator.emit_fleet_record()
        obs_server.stop()
    if slo_monitor is not None and slo_monitor.alerts:
        by_signal: dict[str, int] = {}
        for alert in slo_monitor.alerts:
            by_signal[alert["signal"]] = by_signal.get(alert["signal"], 0) + 1
        summary = ", ".join(f"{k}={v}" for k, v in sorted(by_signal.items()))
        print(f"slo alerts: {len(slo_monitor.alerts)} ({summary})", file=sys.stderr)

    if telemetry is not None:
        uninstall_telemetry()
        telemetry.close()

    if router is not None:
        from dolomite_engine_tpu_torch.serving.cluster import DisaggregatedEngine

        completed = sum(1 for s in states if str(s.status) == "completed")
        cancelled = sum(1 for s in states if str(s.status) == "cancelled")
        hit_rate = router.stats.affinity_hit_rate()
        handoffs = [
            r.engine.handoff for r in router.replicas
            if isinstance(r.engine, DisaggregatedEngine)
        ]
        transfers = sum(h.transfers for h in handoffs)
        handoff_info = ""
        if handoffs:
            mean_ms = (
                1e3 * sum(h.mean_latency_s * h.transfers for h in handoffs) / transfers
                if transfers
                else 0.0
            )
            handoff_info = f", kv handoffs={transfers} (mean {mean_ms:.1f}ms)"
        print(
            f"router: {router.stats.routed} routed / {router.stats.rejected} rejected "
            f"over {len(router.replicas)} replica(s), admissions per replica "
            f"{dict(sorted(router.stats.per_replica_routed.items()))}, "
            f"prefix-affinity hit rate "
            f"{'n/a' if hit_rate is None else f'{hit_rate:.1%}'}"
            f"{handoff_info}; {completed} completed, {cancelled} cancelled",
            file=sys.stderr,
        )
        if router.health is not None:
            rstats = router.stats
            healthy = sum(
                1 for s in router.health.states().values() if str(s) == "healthy"
            )
            print(
                f"fleet: {healthy}/{len(router.replicas)} replicas healthy, "
                f"{rstats.replica_crashes} crashed, {rstats.rerouted} requests "
                f"rerouted, {rstats.shed} shed, {rstats.drains} drains",
                file=sys.stderr,
            )
        return states

    stats = engine.stats
    ttft = stats.mean_ttft_s()
    prefill_rate = stats.prefill_tok_s()
    decode_rate = stats.decode_tok_s()
    hit_rate = stats.prefix_hit_rate()
    spec_info = ""
    if engine.speculating:
        accept = stats.accept_rate()
        per_step = stats.accepted_tokens_per_step()
        spec_info = (
            f", speculation accept rate={'n/a' if accept is None else f'{accept:.1%}'} "
            f"({stats.draft_tokens_accepted}/{stats.draft_tokens_proposed} drafts, "
            f"{0.0 if per_step is None else per_step:.2f} accepted/step)"
        )
    contention_info = ""
    if stats.preemptions or args.session_id:
        contention_info = (
            f", preemptions={stats.preemptions} "
            f"(pages swapped {stats.pages_swapped_out} out / {stats.pages_swapped_in} in), "
            f"session hits={stats.session_hits}"
        )
    paged_info = ""
    if engine.paged:
        kv_info = f" [{engine.pool.kv_dtype}]" if engine.pool.kv_dtype else ""
        paged_info = (
            f", pages={engine.pool.pages_in_use}/{engine.pool.num_pages - 1}{kv_info} "
            f"(frag {engine.pool.page_fragmentation:.1%}), "
            f"prefix hit rate={'n/a' if hit_rate is None else f'{hit_rate:.1%}'} "
            f"({stats.prefix_hit_tokens} of "
            f"{stats.prefix_hit_tokens + stats.prefix_miss_tokens} prompt tokens reused)"
        )
    print(
        f"served {len(states)} request(s): "
        f"completed={stats.completed} cancelled={stats.cancelled}, "
        f"ttft={'n/a' if ttft is None else f'{ttft * 1e3:.0f}ms'}, "
        f"prefill={'n/a' if prefill_rate is None else f'{prefill_rate:.0f}'} tok/s, "
        f"decode={'n/a' if decode_rate is None else f'{decode_rate:.0f}'} tok/s, "
        f"free slots={engine.pool.num_free}/{engine.pool.num_slots}"
        f"{spec_info}{paged_info}{contention_info}",
        file=sys.stderr,
    )
    return states


if __name__ == "__main__":
    main()
