"""Weighted blend over multiple GPTDatasets via greedy max-error index assignment (a copy of
`dolomite_engine_tpu/data/megatron/blended_dataset.py`).

Parity: reference `data/megatron/blended_dataset.py` (166 LoC): dataset_index/
dataset_sample_index built by the native helper, cached as .npy when a cache path is set.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from collections import OrderedDict

import numpy as np

from ...utils import log_rank_0
from .native import build_blending_indices, normalize


class BlendedDataset:
    def __init__(
        self,
        datasets: list,
        weights: list[float],
        size: int,
        config,
        caching_allowed: bool = True,
    ) -> None:
        assert len(datasets) < np.iinfo(np.int16).max
        assert len(datasets) == len(weights)
        assert np.isclose(sum(weights), 1.0)

        weights = normalize(weights)

        self.datasets = datasets
        self.weights = weights
        self.size = size
        self.config = config
        self.caching_allowed = caching_allowed

        unique_identifiers = OrderedDict(
            [
                ("class", type(self).__name__),
                ("datasets", [d.unique_description_hash for d in datasets]),
                ("weights", weights),
                ("size", size),
            ]
        )
        self.unique_description = json.dumps(unique_identifiers, indent=4)
        self.unique_description_hash = hashlib.md5(
            self.unique_description.encode("utf-8")
        ).hexdigest()

        self.dataset_index, self.dataset_sample_index = self._build_indices()

        # bounds check: the last sample must resolve, size must not over-run any sub-dataset
        _ = self[self.size - 1]

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> dict:
        if idx >= self.size:
            raise IndexError(f"index {idx} out of range for BlendedDataset of size {self.size}")
        dataset_id = int(self.dataset_index[idx])
        dataset_sample_id = int(self.dataset_sample_index[idx])
        return {"dataset_id": dataset_id, **self.datasets[dataset_id][dataset_sample_id]}

    def _build_indices(self) -> tuple[np.ndarray, np.ndarray]:
        path_to_cache = getattr(self.config, "path_to_cache", None)

        if path_to_cache:
            get_path = lambda suffix: os.path.join(
                path_to_cache, f"{self.unique_description_hash}-{type(self).__name__}-{suffix}"
            )
            path_to_description = get_path("description.txt")
            path_to_dataset_index = get_path("dataset_index.npy")
            path_to_dataset_sample_index = get_path("dataset_sample_index.npy")
            cache_hit = all(
                map(
                    os.path.isfile,
                    [path_to_description, path_to_dataset_index, path_to_dataset_sample_index],
                )
            )
            if cache_hit:
                return (
                    np.load(path_to_dataset_index, allow_pickle=True, mmap_mode="r"),
                    np.load(path_to_dataset_sample_index, allow_pickle=True, mmap_mode="r"),
                )

        log_rank_0(logging.INFO, f"building {type(self).__name__} indices (size={self.size})")
        dataset_index, dataset_sample_index = build_blending_indices(self.weights, self.size)

        if path_to_cache and self.caching_allowed:
            os.makedirs(path_to_cache, exist_ok=True)
            with open(path_to_description, "wt") as writer:
                writer.write(self.unique_description)
            np.save(path_to_dataset_index, dataset_index, allow_pickle=True)
            np.save(path_to_dataset_sample_index, dataset_sample_index, allow_pickle=True)

        return dataset_index, dataset_sample_index
