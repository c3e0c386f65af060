"""Proportional blended sampler with deterministic resume (a copy of
`dolomite_engine_tpu/data/sampler.py`, numpy only, so the same seed, ratios, epoch and
replicas give the same index stream).

Per-subset shuffled over/undersampling to hit the requested sampling ratios, a global
permutation, pad-or-drop to a multiple of ``num_replicas``, a rank-strided subsample and
epoch auto-increment, as there. One divergence: a restored sampler continues its epoch at
the saved index (the reference's ``start_index``). The JAX copy replays to the index in a
generator it then drops, so its next pass restarts the epoch from index 0 and a
mid-epoch resume repeats batches (ROADMAP.md Queue C). After a full pass the state is the
next epoch at index 0.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np

from ..enums import DatasetSplit
from .base import BlendedDatasets


class BlendedDistributedSampler:
    def __init__(
        self,
        dataset: BlendedDatasets,
        data_sampling_ratios: list[int],
        num_replicas: int,
        rank: int,
        ignore_sampling_proportion_for_validation: bool = True,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ) -> None:
        assert 0 <= rank < num_replicas
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

        self.num_examples_in_each_dataset = dataset.get_num_examples_in_each_dataset()
        self.num_datasets = dataset.get_num_datasets()

        if self.dataset.split == DatasetSplit.val and ignore_sampling_proportion_for_validation:
            self.num_samples_by_dataset = self.num_examples_in_each_dataset
        else:
            self.num_samples_by_dataset = _get_num_samples_by_dataset(
                data_sampling_ratios, len(dataset)
            )

        total = sum(self.num_samples_by_dataset)
        if self.drop_last and total % self.num_replicas != 0:
            self.num_samples = total // self.num_replicas
        else:
            self.num_samples = math.ceil(total / self.num_replicas)
        self.total_size = self.num_samples * self.num_replicas

        self.start_indices = np.cumsum([0] + self.num_examples_in_each_dataset[:-1]).tolist()
        self.index = 0  # resumption cursor
        self._start_index = 0  # where the next pass starts (a restored state's index)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed + self.epoch)

    def _get_indices_in_data_subset(
        self, num_samples_in_subset: int, subset_size: int, rng: np.random.Generator
    ) -> np.ndarray:
        """Over/undersample one subset to its quota: whole-epoch tiles plus a partial draw
        (shuffled = a permutation prefix, consuming exactly one rng call iff needed)."""
        if self.shuffle:
            draw = lambda k: rng.permutation(subset_size)[:k]  # noqa: E731
        else:
            draw = np.arange
        full_epochs, remainder = divmod(num_samples_in_subset, subset_size)
        if full_epochs == 0:
            return draw(num_samples_in_subset)
        tiles = np.tile(np.arange(subset_size), full_epochs)
        return np.concatenate([tiles, draw(remainder)]) if remainder else tiles

    def __iter__(self) -> Iterator[int]:
        rng = self._rng()

        indices = []
        for dataset_index in range(self.num_datasets):
            sub = self._get_indices_in_data_subset(
                self.num_samples_by_dataset[dataset_index],
                self.num_examples_in_each_dataset[dataset_index],
                rng,
            )
            indices.extend((sub + self.start_indices[dataset_index]).tolist())

        if self.shuffle:
            perm_rng = self._rng()
            indices = np.asarray(indices)[perm_rng.permutation(len(indices))].tolist()

        if self.drop_last:
            indices = indices[: self.total_size]
        else:
            shortfall = self.total_size - len(indices)
            if shortfall > 0:
                # wrap-around pad to a replica multiple (may cycle the list several times)
                indices += (indices * math.ceil(shortfall / len(indices)))[:shortfall]

        assert len(indices) == self.total_size

        indices = indices[self.rank : self.total_size : self.num_replicas]
        assert len(indices) == self.num_samples

        start, self._start_index = self._start_index, 0
        self.index = start
        for i in indices[start:]:
            self.index += 1
            yield i

        self.set_epoch(self.epoch + 1)
        self.index = 0

    def __len__(self) -> int:
        return self.num_samples

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "index": self.index}

    def load_state_dict(self, state_dict: dict) -> None:
        self.set_epoch(state_dict["epoch"])
        self.index = self._start_index = state_dict["index"]

    def __repr__(self) -> str:
        x = ""
        for i, dataset in enumerate(self.dataset.datasets):
            name = f"{dataset.__class__.__name__} ({dataset.data_name})"
            x += (
                f"number of samples of {name} in 1 epoch of the entire dataset = "
                f"{self.num_samples_by_dataset[i]}\n"
            )
            x += (
                f"number of epochs of {name} in 1 epoch of the entire dataset = "
                f"{self.num_samples_by_dataset[i] / max(len(dataset), 1)}\n\n"
            )
        return x.rstrip()


def _get_num_samples_by_dataset(data_sampling_ratio: list[int], total_examples: int) -> list[int]:
    ratios = np.asarray(data_sampling_ratio, dtype=np.float64)
    num = (ratios / ratios.sum() * total_examples).astype(np.int64)
    num[-1] = total_examples - num[:-1].sum()
    return num.tolist()
