"""The serving fleet: prefill/decode disaggregation, a router over engine replicas, replica
health with crash migration, fault injection and fleet metrics (mirrors
`dolomite_engine_tpu/serving/cluster/`).

- :mod:`disagg` — a prefill-only engine computes prompts into pages and hands the K/V off
  to decode engines through an explicit :class:`KVHandoff` page copy.
- :mod:`router` — a router fronting N engine replicas: admission control and replica
  selection (session, then prefix affinity, then least loaded), synchronous or threaded
  stepping, crash re-routing with a retry budget, drain and rejoin.
- :mod:`health` + :mod:`faults` — the healthy -> suspect -> dead ladder with its wedge
  watchdog, and the deterministic fault-injection seam that makes it testable.
- :mod:`metrics` — per-replica ``EngineStats`` merged into fleet-level series for
  ``/metrics`` (`serving/obs_server.py`) and the ``fleet`` telemetry record.

The JAX package's ``sharded`` module (one engine over a TP / EP mesh) is not ported: its
names raise NotImplementedError naming the engine mesh of ROADMAP.md Queue A,
'Distribution', as ``ServingEngine(mesh=...)`` does.
"""

from .disagg import DisaggregatedEngine, KVHandoff
from .faults import Fault, FaultInjector, InjectedFault
from .health import ReplicaHealth, ReplicaHealthMonitor
from .metrics import ClusterMetricsAggregator
from .router import (
    DrainTimeoutError,
    EngineReplica,
    NoLiveReplicasError,
    Router,
    RouterStats,
    route_batch,
)


def _not_ported(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"serving.cluster.{name} (an engine over a TP / EP mesh) is not ported yet: "
            "ROADMAP.md Queue A, 'Distribution'"
        )

    refuse.__name__ = name
    return refuse


inference_mesh = _not_ported("inference_mesh")
inference_sharding_rules = _not_ported("inference_sharding_rules")
make_sharded_engine = _not_ported("make_sharded_engine")
shard_params = _not_ported("shard_params")

__all__ = [
    "ClusterMetricsAggregator",
    "DisaggregatedEngine",
    "DrainTimeoutError",
    "EngineReplica",
    "Fault",
    "FaultInjector",
    "InjectedFault",
    "KVHandoff",
    "NoLiveReplicasError",
    "ReplicaHealth",
    "ReplicaHealthMonitor",
    "Router",
    "RouterStats",
    "inference_mesh",
    "inference_sharding_rules",
    "make_sharded_engine",
    "route_batch",
    "shard_params",
]
