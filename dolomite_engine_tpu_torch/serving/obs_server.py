"""Live observability endpoints for the serving plane: /metrics, /healthz, /statusz.

(Copy of `dolomite_engine_tpu/serving/obs_server.py`: the port keeps its own, as it imports nothing of the JAX package.)

A stdlib-only (``http.server``) HTTP thread a load balancer or Prometheus scraper can
poll while the fleet serves — the live counterpart of the post-hoc JSONL sink, and the
surface the future HTTP front door mounts (ROADMAP item 2). Three endpoints:

- ``/metrics`` — Prometheus text exposition. Every ``KNOWN_COUNTERS`` /
  ``KNOWN_GAUGES`` name is always present (0 when nothing has written it yet), so a
  scrape is schema-complete by construction — the CI parity gate asserts exactly this.
  Telemetry quantile sketches render as summaries (``{quantile="0.99"}`` + ``_count`` /
  ``_sum``) and the :class:`~dolomite_engine_tpu_torch.serving.cluster.metrics.
  ClusterMetricsAggregator` contributes fleet series labeled ``replica_id`` / ``tier``.
- ``/healthz`` — 200 while every replica is live, 503 the moment the health ladder
  (``ReplicaHealthMonitor`` via the router) declares any replica dead; the JSON body
  names per-replica states either way.
- ``/statusz`` — the full fleet snapshot as JSON (per-replica queue depths, slot/page
  occupancy, sessions, preemptions, accept rate) plus recent SLO alerts.

Naming map (docs/OBSERVABILITY.md "Live metrics"): registry name -> ``dolomite_`` +
name with every non-``[A-Za-z0-9_]`` char replaced by ``_``; counters get a
``_total`` suffix. ``serving/queue_depth`` -> ``dolomite_serving_queue_depth``,
``router_requests_routed`` -> ``dolomite_router_requests_routed_total``.

Off-path guarantee: nothing constructs this server unless asked
(``tools/serve_torch.py --metrics-port`` or an explicit import); scrapes read locked
registry snapshots and never write telemetry, so a served run's JSONL records are
byte-identical with or without a scraper attached.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ..utils.telemetry import KNOWN_COUNTERS, KNOWN_GAUGES, get_telemetry

__all__ = ["ObservabilityServer", "prometheus_name"]


def prometheus_name(name: str, counter: bool = False) -> str:
    """Registry name -> Prometheus metric name (the documented naming map)."""
    sanitized = "".join(ch if (ch.isalnum() or ch == "_") else "_" for ch in name)
    return f"dolomite_{sanitized}{'_total' if counter else ''}"


def _fmt(value: Any) -> str:
    number = float(value)
    if number == int(number) and abs(number) < 1e15:
        return str(int(number))
    return format(number, ".10g")


def _labelstr(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{key}="{value}"' for key, value in sorted(labels.items()))
    return "{" + inner + "}"


class ObservabilityServer:
    """Serve /metrics, /healthz, /statusz from a daemon thread.

    ``aggregator``/``slo_monitor`` are optional context (a bare engine run can expose
    registry counters alone); ``telemetry`` defaults to whatever instance is installed
    at scrape time, so construction order does not matter. ``port=0`` binds an
    ephemeral port (tests); read :attr:`port` after :meth:`start`.
    """

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        *,
        aggregator: Any = None,
        health: Any = None,
        telemetry: Any = None,
        slo_monitor: Any = None,
    ) -> None:
        self._requested_port = port
        self.host = host
        self.aggregator = aggregator
        self.health = health
        self.slo_monitor = slo_monitor
        self._telemetry = telemetry
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------------- renderers
    # Pure functions of current state, callable without a running server (the CI
    # smoke and the parity tests hit them both over HTTP and directly).

    def _registry(self) -> Any:
        return self._telemetry if self._telemetry is not None else get_telemetry()

    def render_metrics(self) -> str:
        snapshot = self._registry().snapshot()
        lines: list[str] = []

        counters = {name: 0 for name in KNOWN_COUNTERS}
        counters.update(snapshot["counters"])
        for name in sorted(counters):
            metric = prometheus_name(name, counter=True)
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {_fmt(counters[name])}")

        gauges: dict[str, Any] = {name: 0 for name in KNOWN_GAUGES}
        gauges.update(snapshot["gauges"])
        for name in sorted(gauges):
            value = gauges[name]
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                continue
            metric = prometheus_name(name)
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {_fmt(value)}")

        for name in sorted(snapshot["quantiles"]):
            summary = snapshot["quantiles"][name]
            metric = prometheus_name(name)
            lines.append(f"# TYPE {metric} summary")
            for quantile in ("p50", "p90", "p99"):
                if summary[quantile] is not None:
                    label = {"quantile": f"0.{quantile[1:]}"}
                    lines.append(f"{metric}{_labelstr(label)} {_fmt(summary[quantile])}")
            lines.append(f"{metric}_count {_fmt(summary['count'])}")
            if summary["mean"] is not None:
                lines.append(f"{metric}_sum {_fmt(summary['mean'] * summary['count'])}")

        if self.aggregator is not None:
            seen_types: set[str] = set()
            for name, labels, value in self.aggregator.series():
                metric = prometheus_name(name)
                if metric not in seen_types:
                    seen_types.add(metric)
                    lines.append(f"# TYPE {metric} gauge")
                lines.append(f"{metric}{_labelstr(labels)} {_fmt(value)}")

        return "\n".join(lines) + "\n"

    def health_states(self) -> dict[str, str]:
        if self.aggregator is not None:
            return self.aggregator.health_states()
        if self.health is not None:
            return {str(k): str(v) for k, v in self.health.states().items()}
        return {}

    def render_healthz(self) -> tuple[int, dict[str, Any]]:
        states = self.health_states()
        dead = sorted(replica for replica, state in states.items() if state == "dead")
        status = 503 if dead else 200
        return status, {
            "status": "unhealthy" if dead else "ok",
            "dead": dead,
            "replicas": states,
        }

    def render_statusz(self) -> dict[str, Any]:
        body: dict[str, Any] = {"telemetry": self._registry().snapshot()}
        if self.aggregator is not None:
            body["fleet"] = self.aggregator.fleet_snapshot()
        if self.slo_monitor is not None:
            body["alerts"] = list(self.slo_monitor.alerts[-50:])
        return body

    # ---------------------------------------------------------------- lifecycle

    @property
    def port(self) -> int:
        if self._server is not None:
            return self._server.server_address[1]
        return self._requested_port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ObservabilityServer":
        assert self._server is None, "observability server already running"
        obs = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, format, *args):  # noqa: A002 — stdlib signature
                pass  # scrapes must not spam the serving process's stderr

            def _respond(self, status: int, content_type: str, body: str) -> None:
                payload = body.encode()
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self) -> None:  # noqa: N802 — stdlib dispatch name
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._respond(
                            200, "text/plain; version=0.0.4", obs.render_metrics()
                        )
                    elif path == "/healthz":
                        status, body = obs.render_healthz()
                        self._respond(status, "application/json", json.dumps(body))
                    elif path == "/statusz":
                        self._respond(
                            200,
                            "application/json",
                            json.dumps(obs.render_statusz(), default=str),
                        )
                    else:
                        self._respond(404, "text/plain", "not found\n")
                except Exception as error:  # a bad scrape must never kill serving
                    try:
                        self._respond(500, "text/plain", f"scrape failed: {error!r}\n")
                    except Exception:
                        pass

        self._server = ThreadingHTTPServer((self.host, self._requested_port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="obs-server",
            daemon=True,
            kwargs={"poll_interval": 0.05},
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._server = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None
