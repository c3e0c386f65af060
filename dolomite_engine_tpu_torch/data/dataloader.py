"""Dataloaders: the resumable host-side batcher.

Counterpart of `dolomite_engine_tpu/data/dataloader.py`. `ResumableDataLoader` batches a
dataset through a sampler and checkpoints both (`state_dict` / `load_state_dict`), as
there. The JAX package's `ShardedDataLoader` (each host's shard assembled into a global
array over a mesh) and `DispatchingDataLoader` (process 0 reads and broadcasts) need
several devices: the port trains on one, so both raise.
"""

from __future__ import annotations

from typing import Callable, Iterator

_DISTRIBUTION = "is not ported yet: ROADMAP.md Queue A, 'Distribution' (the port trains on one device)"


class ResumableDataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler,
        collate_fn: Callable | None = None,
        drop_last: bool = False,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.collate_fn = collate_fn
        self.drop_last = drop_last

    def __iter__(self) -> Iterator:
        batch = []
        for idx in self.sampler:
            batch.append(self.dataset[idx])
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch) if self.collate_fn else batch
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch) if self.collate_fn else batch

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def state_dict(self) -> dict:
        return {
            "dataset": self.dataset.state_dict(),
            "sampler": self.sampler.state_dict() if self.sampler is not None else {},
        }

    def load_state_dict(self, state_dict: dict) -> None:
        self.dataset.load_state_dict(state_dict.get("dataset"))
        if self.sampler is not None:
            self.sampler.load_state_dict(state_dict.get("sampler"))


class ShardedDataLoader:
    """Per-host shards assembled into global arrays over a mesh: not ported."""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(f"ShardedDataLoader (a mesh's global batches) {_DISTRIBUTION}")


class DispatchingDataLoader:
    """Process 0 reads and broadcasts each batch over a mesh: not ported."""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(f"DispatchingDataLoader (distributed_args.dispatching_dataloader) {_DISTRIBUTION}")
