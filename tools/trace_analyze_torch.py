"""Critical-path TTFT attribution over per-request trace records.

    python tools/trace_analyze_torch.py <run_dir | telemetry_dir | *.jsonl> [...] [--json] [--per-request]

The PyTorch port's copy of `tools/trace_analyze.py`, over the port's own `utils/tracing.py`
(the trace records of both packages have one schema).

Reads the run's JSONL telemetry sink(s), decomposes every ``trace`` record's TTFT into
critical-path buckets (queue wait / admission / prefill / parked / handoff —
`dolomite_engine_tpu_torch.utils.tracing.critical_path`; the phases are contiguous by
construction so the buckets sum to the measured TTFT), and prints the per-tier answer
the aggregate telemetry cannot give: where the time of the requests that MISSED their
TTFT SLO actually went ("tier 1 p99 misses are 71% queue wait"). SLO targets come from
the same sink's ``serving`` records (the per-tier ``ttft_target_ms`` the engine already
reports) — no extra flags needed when the run had `tier_slos`.

``--per-request`` prints one line per trace (worst TTFT first); ``--json`` emits the
aggregate as one machine-readable JSON object instead of markdown.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.trace_export import find_sink_files  # noqa: E402  (path shim above)

from dolomite_engine_tpu_torch.utils.tracing import (  # noqa: E402
    TTFT_BUCKETS,
    aggregate_critical_paths,
    trace_record_critical_path,
)


def read_records(files: list[str]) -> tuple[list[dict], int]:
    records: list[dict] = []
    bad = 0
    for path in files:
        with open(path, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except json.JSONDecodeError:
                    bad += 1
                    continue
                if isinstance(record, dict):
                    records.append(record)
    return records, bad


def slo_targets_from_serving(records: list[dict]) -> dict[int, float]:
    """Per-tier TTFT targets (seconds) from the latest ``serving`` record's tiers map."""
    targets: dict[int, float] = {}
    for record in records:
        if record.get("kind") != "serving":
            continue
        for tier, info in (record.get("tiers") or {}).items():
            target_ms = (info or {}).get("ttft_target_ms")
            if target_ms is not None:
                targets[int(tier)] = target_ms / 1e3
    return targets


def _ms(value) -> str:
    return "n/a" if value is None else f"{value * 1e3:.1f}ms"


def render(paths: list[dict], aggregate: dict, per_request: bool) -> str:
    lines: list[str] = []
    lines.append(f"critical-path TTFT attribution over {len(paths)} traced request(s)")
    lines.append("")
    header = "| tier | n | ttft p50 | ttft p99 | " + " | ".join(TTFT_BUCKETS) + " | top bucket |"
    lines.append(header)
    lines.append("|" + "---|" * (len(TTFT_BUCKETS) + 5))
    for tier, entry in aggregate.items():
        shares = entry["bucket_shares"]
        cells = " | ".join(f"{100.0 * shares[b]:.1f}%" for b in TTFT_BUCKETS)
        lines.append(
            f"| {'-' if tier is None else tier} | {entry['count']} "
            f"| {_ms(entry['ttft_p50_s'])} | {_ms(entry['ttft_p99_s'])} | {cells} "
            f"| {entry['top_bucket'] or '-'} |"
        )
    lines.append("")
    for tier, entry in aggregate.items():
        if entry.get("slo_ttft_s") is None:
            continue
        misses = entry.get("misses", 0)
        if not misses:
            lines.append(
                f"tier {tier}: 0/{entry['count']} TTFT SLO misses "
                f"(target {_ms(entry['slo_ttft_s'])})"
            )
            continue
        top = entry.get("miss_top_bucket")
        share = (entry.get("miss_bucket_shares") or {}).get(top, 0.0)
        lines.append(
            f"tier {tier}: {misses}/{entry['count']} TTFT SLO misses "
            f"(target {_ms(entry['slo_ttft_s'])}) — {100.0 * share:.0f}% {top} on the "
            f"missed requests' critical path"
        )
    if per_request:
        lines.append("")
        lines.append("| request | tier | ttft | " + " | ".join(TTFT_BUCKETS) + " | unattributed |")
        lines.append("|" + "---|" * (len(TTFT_BUCKETS) + 4))
        ordered = sorted(paths, key=lambda p: -(p["ttft_s"] or 0.0))
        for path in ordered:
            cells = " | ".join(_ms(path["buckets"][b]) for b in TTFT_BUCKETS)
            lines.append(
                f"| {path.get('request_id', '?')} | {'-' if path['tier'] is None else path['tier']} "
                f"| {_ms(path['ttft_s'])} | {cells} | {_ms(path['unattributed_s'])} |"
            )
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("paths", nargs="+", help="sink .jsonl file(s) or run directories")
    parser.add_argument("--json", action="store_true", help="emit the aggregate as JSON")
    parser.add_argument(
        "--per-request", action="store_true", help="one line per trace, worst TTFT first"
    )
    parsed = parser.parse_args(argv)

    files = find_sink_files(parsed.paths)
    if not files:
        print(f"no .jsonl sinks found under {parsed.paths}", file=sys.stderr)
        return 1
    records, bad = read_records(files)
    traces = [r for r in records if r.get("kind") == "trace"]
    if not traces:
        print(
            "no trace records found — was serving run with --trace / trace_requests?",
            file=sys.stderr,
        )
        return 1
    paths = [p for p in (trace_record_critical_path(r) for r in traces) if p is not None]
    targets = slo_targets_from_serving(records)
    aggregate = aggregate_critical_paths(paths, targets)
    if parsed.json:
        print(
            json.dumps(
                {
                    "requests": len(paths),
                    "slo_ttft_s_by_tier": {str(k): v for k, v in targets.items()},
                    "tiers": {str(k): v for k, v in aggregate.items()},
                }
            )
        )
    else:
        print(render(paths, aggregate, parsed.per_request))
    if bad:
        print(f"({bad} malformed line(s) skipped)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
