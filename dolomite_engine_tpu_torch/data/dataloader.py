"""Dataloaders: the resumable host-side batcher and the data-parallel feeds.

Counterpart of `dolomite_engine_tpu/data/dataloader.py`. `ResumableDataLoader` batches a
dataset through a sampler and checkpoints both (`state_dict` / `load_state_dict`), as
there. Over data-parallel ranks (one process a rank) `ShardedDataLoader` yields each
rank's own shard, sampled by that rank (the JAX package assembles the hosts' shards into
one global array; here each rank's shard is its part of the global batch as it is), and
`DispatchingDataLoader` lets rank 0 alone read storage and broadcast each global batch,
of which every rank keeps its rows.
"""

from __future__ import annotations

import json
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..utils import get_telemetry


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
    """Wraps this rank's loader, whose sampler already takes its shard of the global batch
    (``num_replicas`` = the world): yields its batches as the loader made them (the step
    moves them to the rank's device, as at one rank) and checkpoints the loader."""

    def __init__(self, local_loader) -> None:
        self.local_loader = local_loader

    def __iter__(self) -> Iterator:
        for batch in self.local_loader:
            get_telemetry().count("loader_batches")
            yield batch

    def __len__(self) -> int:
        return len(self.local_loader)

    def state_dict(self) -> dict:
        return self.local_loader.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        self.local_loader.load_state_dict(state_dict)


class DispatchingDataLoader:
    """Single-reader feed: ONLY rank 0 owns a loader (and so reads the corpus), which
    yields the whole global batch; every other rank passes ``local_loader=None`` and never
    touches storage.

    Per step rank 0 broadcasts a fixed-size int32 header (per key its dtype code and
    shape, all -1 when the source is exhausted) and then each array; the receivers
    allocate them from the header. Every rank then keeps its rows of each array: rank r
    the r-th of `world` equal slices of the batch dimension (a packed batch is one row,
    which cannot be split, and raises). Key names ride a one-time schema broadcast with
    the first batch; the loader's length is broadcast at construction. The broadcasts run
    on the host over a gloo group of all ranks, the loader's own: a prefetch thread drives
    the loader, and its collectives must not interleave with the training step's. The dtypes, the int64 cast with its range check and the dimension
    limit are the JAX package's (its collective downcasts int64, so it announces int32).
    Without a process group it is a pass-through of one rank."""

    _SCHEMA_BYTES = 4096
    _MAX_DIMS = 6
    # 0 = the key is None
    _DTYPES = [None, torch.int32, torch.float32, torch.bfloat16, torch.bool]

    def __init__(self, local_loader) -> None:
        distributed = dist.is_available() and dist.is_initialized()
        self.group = dist.new_group(backend="gloo") if distributed else None
        self.rank = dist.get_rank() if distributed else 0
        self.world = dist.get_world_size() if distributed else 1
        assert (local_loader is not None) == (self.rank == 0), (
            "rank 0 must own the loader; every other rank must pass None"
        )
        self.local_loader = local_loader
        self._keys: list[str] | None = None
        # eager: __init__ runs on every rank, and len() must be right on the receivers
        # before the first batch
        length = torch.tensor([len(local_loader) if local_loader is not None else 0], dtype=torch.int32)
        self._length = int(self._broadcast(length)[0])

    def _broadcast(self, tensor: torch.Tensor) -> torch.Tensor:
        if self.world > 1:
            dist.broadcast(tensor, src=0, group=self.group)
        return tensor

    def _broadcast_schema(self, batch: dict | None) -> None:
        if self._keys is not None:
            return
        buf = torch.zeros(self._SCHEMA_BYTES, dtype=torch.uint8)
        if self.local_loader is not None:
            # batch None: the source is empty; the receivers then stop at once
            raw = json.dumps({"keys": sorted(batch.keys()) if batch is not None else []}).encode()
            assert len(raw) < self._SCHEMA_BYTES, "batch schema exceeds the schema buffer"
            buf[: len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        buf = self._broadcast(buf)
        self._keys = json.loads(bytes(buf[buf != 0].tolist()).decode())["keys"]

    def _prepared(self, batch: dict) -> dict:
        """The batch's arrays as the tensors to send, checked as the JAX package checks
        them."""
        out = {}
        for key in self._keys:
            value = batch.get(key)
            if value is None:
                out[key] = None
                continue
            tensor = torch.as_tensor(np.asarray(value)) if not isinstance(value, torch.Tensor) else value
            if tensor.dim() > self._MAX_DIMS:
                raise ValueError(
                    f"DispatchingDataLoader cannot broadcast batch key '{key}' with ndim {tensor.dim()}; "
                    f"the header carries at most {self._MAX_DIMS} dims"
                )
            if tensor.dtype == torch.int64:
                info = np.iinfo(np.int32)
                if tensor.numel() and (int(tensor.min()) < info.min or int(tensor.max()) > info.max):
                    raise ValueError(
                        f"DispatchingDataLoader batch key '{key}' holds int64 values outside int32 range; "
                        "the header announces int32, so they would be truncated"
                    )
                tensor = tensor.to(torch.int32)
            if tensor.dtype not in self._DTYPES:
                raise ValueError(
                    f"DispatchingDataLoader cannot broadcast batch key '{key}' of dtype "
                    f"{str(tensor.dtype).removeprefix('torch.')}; supported: "
                    f"{[str(dt).removeprefix('torch.') for dt in self._DTYPES if dt is not None]}"
                )
            out[key] = tensor
        return out

    def _header(self, batch: dict | None) -> torch.Tensor:
        """[n_keys, 1 + MAX_DIMS] int32: the dtype code and the padded shape; all -1 =
        exhausted."""
        header = torch.full((len(self._keys), 1 + self._MAX_DIMS), -1, dtype=torch.int32)
        if batch is not None:
            for row, key in enumerate(self._keys):
                value = batch[key]
                if value is None:
                    header[row, 0] = 0
                    continue
                header[row, 0] = self._DTYPES.index(value.dtype)
                header[row, 1 : 1 + value.dim()] = torch.tensor(value.shape, dtype=torch.int32)
        return header

    def _rows(self, key: str, value: torch.Tensor) -> torch.Tensor:
        rows = value.shape[0]
        if rows % self.world:
            raise ValueError(
                f"DispatchingDataLoader batch key '{key}' has {rows} rows, which do not split over "
                f"{self.world} ranks (a packed batch is one row: use the sharded loader)"
            )
        per = rows // self.world
        return value[self.rank * per : (self.rank + 1) * per]

    def __iter__(self) -> Iterator:
        source = iter(self.local_loader) if self.local_loader is not None else None
        first = True
        while True:
            batch = next(source, None) if source is not None else None
            if first:
                self._broadcast_schema(batch)
                first = False
            prepared = self._prepared(batch) if batch is not None else None
            header = self._broadcast(self._header(prepared))
            if (header < 0).all():  # the source is exhausted: every rank stops this epoch
                return
            out = {}
            for row, key in enumerate(self._keys):
                code = int(header[row, 0])
                if code <= 0:
                    out[key] = None
                    continue
                shape = tuple(int(d) for d in header[row, 1:] if d >= 0)
                if prepared is not None:
                    value = prepared[key]
                else:
                    value = torch.empty(shape, dtype=self._DTYPES[code])
                out[key] = self._rows(key, self._broadcast(value))
            get_telemetry().count("loader_batches")
            yield out

    def __len__(self) -> int:
        if self.local_loader is not None:
            return len(self.local_loader)  # live: may change after load_state_dict
        return self._length

    def state_dict(self) -> dict:
        # only the reading rank has loader state; rank 0 writes the checkpoint's
        return self.local_loader.state_dict() if self.local_loader is not None else {}

    def load_state_dict(self, state_dict: dict) -> None:
        if self.local_loader is not None:
            self.local_loader.load_state_dict(state_dict)
