"""Serving: the paged continuous-batching engine (mirrors `dolomite_engine_tpu/serving/`)."""

from .engine import EngineStats, ServingEngine, serve_batch
from .kv_cache import TRASH_PAGE, PagedKVCachePool
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
