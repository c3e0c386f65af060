"""Megatron-order batch sampler: deterministic, resume-by-consumed-samples (a copy of
`dolomite_engine_tpu/data/megatron/sampler.py`).

Parity: reference `data/megatron/sampler.py` (47 LoC) — identical iteration order so loss
curves are comparable across the GPU engine and this framework for the same seed/data.
"""

from __future__ import annotations

from typing import Iterator


class MegatronBatchSampler:
    """Yields per-replica lists of sample indices. The global batch at step t is the contiguous
    index range [consumed + t*B, consumed + (t+1)*B) with B = micro_batch_size * num_replicas;
    replica r takes rows [r*micro : (r+1)*micro] of it."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        micro_batch_size: int,
        num_replicas: int,
        rank: int,
        drop_last: bool = True,
    ) -> None:
        assert total_samples > 0, f"no sample to consume: {total_samples}"
        assert consumed_samples < total_samples, (
            f"no samples left to consume: {consumed_samples}, {total_samples}"
        )
        assert micro_batch_size > 0
        assert 0 <= rank < num_replicas

        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.drop_last = drop_last
        self.micro_batch_times_num_replicas = micro_batch_size * num_replicas

    def __len__(self) -> int:
        return self.total_samples

    def __iter__(self) -> Iterator[list[int]]:
        batch = []
        start = self.rank * self.micro_batch_size
        end = start + self.micro_batch_size
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.micro_batch_times_num_replicas:
                yield batch[start:end]
                batch = []

        if batch and not self.drop_last:
            yield batch[start:end]
