"""Cross-replica metrics aggregation: per-replica ``EngineStats`` -> one fleet view.

(Copy of `dolomite_engine_tpu/serving/cluster/metrics.py`: the port keeps its own, as it imports nothing of the JAX package.)

The live observability plane (docs/OBSERVABILITY.md "Live metrics") needs fleet-level
numbers in three places — the ``/metrics``/``/statusz`` HTTP endpoints
(serving/obs_server.py), the ``fleet`` telemetry record kind, and (per ROADMAP) the
router's future scaling policy. :class:`ClusterMetricsAggregator` is the single
aggregation path all three read, so they can never disagree about what "fleet queue
depth" means.

Aggregation rules:

- **Totals** are sums over the fleet (queue depth, active slots, admitted/completed/
  preempted/rejected, live sessions); the fleet accept rate is recomputed from the
  summed draft-token counters, never a mean of per-replica rates.
- **Per-tier series** pool every replica's TTFT reservoir samples and take nearest-rank
  p99 over the pooled set (a mean of per-replica p99s would understate the slow
  replica); ITL means recombine exactly from each sketch's running count/sum.
- **Per-replica slices** carry the queue/slot/occupancy/session numbers plus the
  replica's health-ladder state, so ``/statusz`` and the ``fleet`` record name which
  replica is the outlier.

A :class:`~dolomite_engine_tpu_torch.serving.cluster.DisaggregatedEngine` replica aggregates
over its prefill worker + decode workers (their stats objects are disjoint by design).

Off-path discipline: nothing here writes telemetry unless :meth:`emit_fleet_record` is
called — an aggregator that is merely constructed (or scraped) leaves the JSONL sink
byte-identical.
"""

from __future__ import annotations

from typing import Any

from ...utils.telemetry import get_telemetry, nearest_rank
from .disagg import DisaggregatedEngine

__all__ = ["ClusterMetricsAggregator"]


def _component_engines(engine: Any) -> list[Any]:
    """The ServingEngines holding an engine's stats: itself, or prefill + decode
    workers for a disaggregated replica."""
    if isinstance(engine, DisaggregatedEngine):
        return [engine.prefill, *engine.workers]
    return [engine]


class ClusterMetricsAggregator:
    """Merge per-replica engine state into fleet-level series (labels: replica, tier).

    ``replicas`` may be ``EngineReplica`` wrappers (the router fleet) or bare engines
    (a standalone ``tools/serve_torch.py`` run aggregates a one-replica "fleet" through the
    same path). ``router``/``health`` are optional context: with a router attached the
    per-replica health states come from its ladder (dead/parked/suspect), and
    ``replicas_live`` counts only routable replicas.
    """

    def __init__(self, replicas: list[Any], *, router: Any = None, health: Any = None) -> None:
        if not replicas:
            raise ValueError("aggregator needs at least one replica or engine")
        self.router = router
        self.health = health if health is not None else getattr(router, "health", None)
        self._entries: list[tuple[int, Any, Any]] = []
        for index, item in enumerate(replicas):
            if hasattr(item, "engine") and hasattr(item, "replica_id"):
                self._entries.append((item.replica_id, item.engine, item))
            else:
                replica_id = getattr(item, "replica_id", None)
                self._entries.append((index if replica_id is None else replica_id, item, None))

    @classmethod
    def for_router(cls, router: Any) -> "ClusterMetricsAggregator":
        return cls(router.replicas, router=router)

    # ------------------------------------------------------------------ health

    def health_states(self) -> dict[str, str]:
        """replica_id -> health-ladder state. The router's view wins (it also knows
        quarantined/parked); a bare monitor is next; an unmonitored fleet is healthy
        by definition (there is nothing that could have said otherwise)."""
        if self.router is not None:
            return {
                str(r.replica_id): self.router._health_state(r)
                for r in self.router.replicas
            }
        if self.health is not None:
            return {str(k): str(v) for k, v in self.health.states().items()}
        return {str(replica_id): "healthy" for replica_id, _, _ in self._entries}

    # ------------------------------------------------------------------ aggregation

    def fleet_snapshot(self) -> dict[str, Any]:
        """One point-in-time fleet view (the body of the ``fleet`` record)."""
        states = self.health_states()
        totals = {
            "queue_depth": 0,
            "slots_active": 0,
            "num_slots": 0,
            "admitted": 0,
            "completed": 0,
            "preempted": 0,
            "rejected": 0,
            "sessions_live": 0,
        }
        proposed = accepted = 0
        tier_ttft: dict[int, list[float]] = {}
        tier_itl: dict[int, tuple[float, int]] = {}
        tiers: dict[int, dict[str, Any]] = {}
        per_replica: dict[str, dict[str, Any]] = {}

        for replica_id, engine, wrapper in self._entries:
            components = _component_engines(engine)
            slice_totals = {
                "queue_depth": (
                    wrapper.queue_depth
                    if wrapper is not None
                    else sum(c.scheduler.queue_depth for c in components)
                ),
                "slots_active": sum(c.pool.num_active for c in components),
                "num_slots": sum(c.pool.num_slots for c in components),
                "admitted": sum(c.stats.admitted for c in components),
                "completed": sum(c.stats.completed for c in components),
                "preempted": sum(c.stats.preemptions for c in components),
                "rejected": sum(c.stats.rejected for c in components),
                "sessions_live": sum(
                    c.prefix.sessions_live for c in components if c.prefix is not None
                ),
            }
            pages_in_use = sum(
                c.pool.pages_in_use for c in components if getattr(c, "paged", False)
            )
            replica_proposed = sum(c.stats.draft_tokens_proposed for c in components)
            replica_accepted = sum(c.stats.draft_tokens_accepted for c in components)
            proposed += replica_proposed
            accepted += replica_accepted
            for key in totals:
                totals[key] += slice_totals[key]

            occupancies = [c.pool.occupancy for c in components]
            per_replica[str(replica_id)] = {
                **slice_totals,
                "pages_in_use": pages_in_use,
                "occupancy": round(sum(occupancies) / len(occupancies), 4),
                "accept_rate": (
                    round(replica_accepted / replica_proposed, 4) if replica_proposed else None
                ),
                "health": states.get(str(replica_id), "healthy"),
            }

            for component in components:
                stats = component.stats
                depth_by_tier = component.scheduler.queue_depth_by_tier()
                for tier in (
                    set(depth_by_tier)
                    | set(stats.admitted_by_tier)
                    | set(stats.ttft_s_by_tier)
                    | set(component.scheduler.tier_slos)
                ):
                    entry = tiers.setdefault(
                        tier,
                        {"queue_depth": 0, "admitted": 0, "completed": 0, "preempted": 0},
                    )
                    entry["queue_depth"] += depth_by_tier.get(tier, 0)
                    entry["admitted"] += stats.admitted_by_tier.get(tier, 0)
                    entry["completed"] += stats.completed_by_tier.get(tier, 0)
                    entry["preempted"] += stats.preempted_by_tier.get(tier, 0)
                    ttft = stats.ttft_s_by_tier.get(tier)
                    if ttft is not None:
                        tier_ttft.setdefault(tier, []).extend(ttft)
                    itl = stats.itl_s_by_tier.get(tier)
                    if itl is not None and itl.count:
                        total_s, count = tier_itl.get(tier, (0.0, 0))
                        tier_itl[tier] = (total_s + itl.total, count + itl.count)

        for tier, entry in tiers.items():
            pooled = tier_ttft.get(tier)
            p99 = nearest_rank(sorted(pooled), 0.99) if pooled else None
            entry["ttft_p99_ms"] = None if p99 is None else round(p99 * 1e3, 3)
            itl_total, itl_count = tier_itl.get(tier, (0.0, 0))
            entry["itl_mean_ms"] = (
                round(1e3 * itl_total / itl_count, 3) if itl_count else None
            )

        return {
            "replicas": len(self._entries),
            "accept_rate": round(accepted / proposed, 4) if proposed else None,
            "health": states,
            "tiers": {str(tier): entry for tier, entry in sorted(tiers.items())},
            "per_replica": per_replica,
            **totals,
        }

    def series(self) -> list[tuple[str, dict[str, str], float]]:
        """Labeled numeric series for Prometheus exposition: (name, labels, value).
        Names are the slash-separated registry style; the obs server applies the
        Prometheus naming map (docs/OBSERVABILITY.md)."""
        snapshot = self.fleet_snapshot()
        out: list[tuple[str, dict[str, str], float]] = [
            ("fleet/replicas", {}, float(snapshot["replicas"])),
            (
                "fleet/replicas_live",
                {},
                float(sum(1 for s in snapshot["health"].values() if s == "healthy")),
            ),
            ("fleet/queue_depth", {}, float(snapshot["queue_depth"])),
            ("fleet/slots_active", {}, float(snapshot["slots_active"])),
        ]
        for replica_id, entry in snapshot["per_replica"].items():
            labels = {"replica_id": replica_id}
            for key in (
                "queue_depth",
                "slots_active",
                "num_slots",
                "pages_in_use",
                "occupancy",
                "admitted",
                "completed",
                "preempted",
                "sessions_live",
            ):
                out.append((f"serving/{key}", labels, float(entry[key])))
            if entry["accept_rate"] is not None:
                out.append(("serving/accept_rate", labels, float(entry["accept_rate"])))
        for tier, entry in snapshot["tiers"].items():
            labels = {"tier": tier}
            for key in ("queue_depth", "admitted", "completed", "preempted"):
                out.append((f"serving/tier_{key}", labels, float(entry[key])))
            if entry["ttft_p99_ms"] is not None:
                out.append(("serving/tier_ttft_p99_ms", labels, float(entry["ttft_p99_ms"])))
            if entry["itl_mean_ms"] is not None:
                out.append(("serving/tier_itl_mean_ms", labels, float(entry["itl_mean_ms"])))
        return out

    # ------------------------------------------------------------------ emission

    def emit_fleet_record(self, step: int | None = None) -> dict[str, Any]:
        """Write one ``fleet`` telemetry record (and return its fields). Only explicit
        callers reach this — attaching the aggregator alone never touches the sink."""
        snapshot = self.fleet_snapshot()
        get_telemetry().emit_record("fleet", step=step, **snapshot)
        return snapshot
