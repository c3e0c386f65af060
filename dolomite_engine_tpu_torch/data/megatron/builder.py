"""Builder wiring indexed datasets -> per-split GPTDatasets -> blended datasets.

Parity: reference `data/megatron/blended_megatron_dataset_builder.py` (448 LoC). Supports the
reference's four data-path options:
  1/2. `blend` (single prefix, or weighted [w1, p1, w2, p2, ...]) + `split` "99,1,0";
  3.   `blend_per_split` (separate blends for train/valid/test);
  4.   weighted split paths (per-group list of {path, split "0:0.9", weight}) via
       `build_dataset_single_split`.

A copy of `dolomite_engine_tpu/data/megatron/builder.py`. The port builds in one process
(`data/megatron/__init__.py`), which writes the caches itself.
"""

from __future__ import annotations

import math
from copy import deepcopy

import numpy as np

from .blended_dataset import BlendedDataset
from .gpt_dataset import GPTDataset, GPTDatasetConfig, Split
from .indexed_dataset import MMapIndexedDataset
from .native import normalize


class BlendedMegatronDatasetBuilder:
    def __init__(
        self,
        cls: type,
        sizes: list[int],
        config: GPTDatasetConfig,
        tokenizer,
        caching_allowed: bool = True,
    ) -> None:
        self.cls = cls
        self.sizes = sizes
        self.config = config
        self.tokenizer = tokenizer
        self.caching_allowed = caching_allowed

    def build(self) -> list:
        """One dataset (or None) per split; val/test may be lists when blended per split."""
        if self.config.blend:
            blend = self.config.blend
            split = self.config.split_vector

            if len(blend) == 1:
                return self._build_megatron_dataset_splits(blend[0], split, self.sizes)

            prefixes, weights, sizes_per_dataset = _get_prefixes_weights_and_sizes_for_blend(
                blend, self.sizes
            )

            megatron_datasets = [[] for _ in range(len(Split))]
            for i, prefix in enumerate(prefixes):
                splits_i = self._build_megatron_dataset_splits(prefix, split, sizes_per_dataset[i])
                for j, ds in enumerate(splits_i):
                    megatron_datasets[j].append(ds)

            size_per_split = list(map(sum, zip(*sizes_per_dataset)))

            blended = []
            for i in range(len(megatron_datasets)):
                if split[i] == 0.0:
                    blended.append(None)
                else:
                    blended.append(
                        BlendedDataset(
                            datasets=megatron_datasets[i],
                            weights=weights,
                            size=size_per_split[i],
                            config=self.config,
                            caching_allowed=self.caching_allowed,
                        )
                    )
            return blended

        # blend_per_split
        blended = []
        for i in range(len(Split)):
            blend = self.config.blend_per_split[i]
            if not blend:
                blended.append(None)
                continue

            split_spoof = [0.0] * len(Split)
            split_spoof[i] = 1.0
            sizes_spoof = [0] * len(Split)
            sizes_spoof[i] = self.sizes[i]

            if len(blend) == 1:
                blended.append(
                    self._build_megatron_dataset_splits(blend[0], split_spoof, sizes_spoof)[i]
                )
            else:
                prefixes, weights, sizes_per_dataset = _get_prefixes_weights_and_sizes_for_blend(
                    blend, sizes_spoof
                )
                datasets = [
                    self._build_megatron_dataset_splits(p, split_spoof, sizes_per_dataset[j])[i]
                    for j, p in enumerate(prefixes)
                ]
                size_per_split = list(map(sum, zip(*sizes_per_dataset)))
                blended.append(
                    BlendedDataset(
                        datasets=datasets,
                        weights=weights,
                        size=size_per_split[i],
                        config=self.config,
                        caching_allowed=self.caching_allowed,
                    )
                )
        return blended

    def _build_megatron_dataset_splits(
        self, path_prefix: str, split: list[float], sizes: list[int]
    ) -> list:
        """Slice one indexed dataset's sequences into train/valid/test sub-ranges."""
        indexed_dataset = MMapIndexedDataset(path_prefix)
        split_idx_bounds = _get_split_indices(split, indexed_dataset.sequence_lengths.shape[0])
        dtype = _dtype_for_range(split_idx_bounds)
        split_indices = [
            np.arange(split_idx_bounds[i], split_idx_bounds[i + 1], dtype=dtype)
            for i in range(len(Split))
        ]

        datasets = []
        for i, split_enum in enumerate(Split):
            if split[i] == 0.0:
                datasets.append(None)
            else:
                datasets.append(
                    self.cls(
                        indexed_dataset=indexed_dataset,
                        indexed_indices=split_indices[i],
                        num_samples=sizes[i],
                        index_split=split_enum,
                        tokenizer=self.tokenizer,
                        config=self.config,
                        caching_allowed=self.caching_allowed,
                    )
                )
        return datasets

    # ------------------------------------------------------- option 4: weighted split paths
    def build_dataset_single_split(
        self,
        group_names: list[list[str]],
        split_paths: list[list[str]],
        split_splits: list[list[str]],
        split_weights: list[list[float]],
        data_split: Split,
    ) -> list:
        """One (possibly blended) dataset per GROUP, for one split. Each group entry carries an
        explicit fractional range "start:end" into its indexed dataset."""
        assert len(split_paths) == len(group_names) == len(split_splits) == len(split_weights)

        out = []
        data_split_index = data_split.value
        for names, paths, splits, weights in zip(
            group_names, split_paths, split_splits, split_weights
        ):
            assert len(paths) == len(splits) == len(weights)

            if len(paths) == 1:
                assert weights[0] == 1
                out.append(
                    self._build_single_split(
                        names[0], paths[0], splits[0], self.sizes[data_split_index], data_split
                    )
                )
            else:
                blend = []
                for w, p in zip(weights, paths):
                    blend += [w, p]
                _, norm_weights, sizes = _get_prefixes_weights_and_sizes_for_blend(blend, self.sizes)

                datasets = [
                    self._build_single_split(
                        name, path, split, size[data_split_index], data_split
                    )
                    for name, path, split, size in zip(names, paths, splits, sizes)
                ]
                size_per_split = list(map(sum, zip(*sizes)))
                out.append(
                    BlendedDataset(
                        datasets=datasets,
                        weights=norm_weights,
                        size=size_per_split[data_split_index],
                        config=self.config,
                        caching_allowed=self.caching_allowed,
                    )
                )
        return out

    def _build_single_split(
        self, group_name: str, path_prefix: str, split: str, size: int, data_split: Split
    ):
        indexed_dataset = MMapIndexedDataset(path_prefix)
        start_frac, end_frac = (float(x) for x in split.split(":"))

        config = deepcopy(self.config)
        config.name = group_name
        config.split = split

        num_elements = indexed_dataset.sequence_lengths.shape[0]
        start = int(start_frac * num_elements)
        end = int(end_frac * num_elements)
        if start == end:
            return None

        indices = np.arange(start, end, dtype=_dtype_for_range([start, end]))
        return self.cls(
            indexed_dataset=indexed_dataset,
            indexed_indices=indices,
            num_samples=size,
            index_split=data_split,
            tokenizer=self.tokenizer,
            config=config,
            caching_allowed=self.caching_allowed,
        )


def _get_split_indices(split: list[float], num_elements: int) -> list[int]:
    """[0.9, 0.09, 0.01] over 1000 sequences -> [0, 900, 990, 1000]."""
    bounds = [0]
    for pct in split:
        bounds.append(bounds[-1] + int(round(pct * float(num_elements))))
    bounds[1:] = [b - (bounds[-1] - num_elements) for b in bounds[1:]]
    assert bounds[-1] == num_elements
    return bounds


def _get_prefixes_weights_and_sizes_for_blend(
    blend: list, target_num_samples_per_split: list[int]
) -> tuple[list[str], list[float], list[list[int]]]:
    """["30", "p1", "70", "p2"] -> (["p1","p2"], [0.3,0.7], per-dataset per-split sizes with a
    0.5% oversampling margin)."""
    weights, prefixes = zip(
        *[(float(blend[i]), str(blend[i + 1]).strip()) for i in range(0, len(blend), 2)]
    )
    weights = normalize(weights)
    sizes_per_dataset = [
        [int(math.ceil(target * weight * 1.005)) for target in target_num_samples_per_split]
        for weight in weights
    ]
    return list(prefixes), weights, sizes_per_dataset


def _dtype_for_range(bounds: list[int]):
    return np.int32 if max(bounds) <= np.iinfo(np.int32).max else np.int64
