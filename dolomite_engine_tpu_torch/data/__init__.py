"""Data pipelines of the port (mirrors `dolomite_engine_tpu/data/`): the megatron
pretraining loaders and the async step prefetcher."""

from .prefetch import PrefetchingIterable, StepPrefetcher
