"""Serving: the continuous-batching engine over a paged or a dense KV pool (mirrors
`dolomite_engine_tpu/serving/`)."""

from .engine import EngineStats, ServingEngine, serve_batch
from .kv_cache import TRASH_PAGE, PagedKVCachePool, SlotKVCachePool
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
