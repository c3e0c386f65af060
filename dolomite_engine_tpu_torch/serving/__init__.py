"""Serving: the continuous-batching engine over a paged or a dense KV pool, and the fleet
over it (mirrors `dolomite_engine_tpu/serving/`)."""

from .engine import EngineStats, ServingEngine, serve_batch
from .kv_cache import TRASH_PAGE, HostSwapPool, PagedKVCachePool, SlotKVCachePool
from .prefix_cache import PrefixCache, PrefixMatch, PrefixNode
from .scheduler import (
    QueueFullError,
    Request,
    RequestState,
    RequestStatus,
    SamplingParams,
    Scheduler,
    TierSLO,
)
from .obs_server import ObservabilityServer
from .speculation import DraftModelDrafter, NgramDrafter

from .cluster import (
    ClusterMetricsAggregator,
    DisaggregatedEngine,
    DrainTimeoutError,
    EngineReplica,
    Fault,
    FaultInjector,
    InjectedFault,
    KVHandoff,
    NoLiveReplicasError,
    ReplicaHealth,
    ReplicaHealthMonitor,
    Router,
    RouterStats,
    route_batch,
)
