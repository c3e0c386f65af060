"""Megatron-style pretraining dataloaders over mmap token corpora.

Counterpart of `dolomite_engine_tpu/data/megatron/__init__.py`: the same datasets, splits,
index caches and sample order. Each data-parallel rank yields its own plain int64 CPU
batches, ``{"text": [micro_batch_size, seq + 1]}`` (the YAML's micro batch, JAX's
per-device batch), so the ranks' rows at a step are the rows of the JAX package's global
micro batch; moving them to the device is the prefetcher's job (`data/prefetch.py`).
Rank 0 builds the index caches while the others wait on a barrier, then read them.
"""

from __future__ import annotations

import logging
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from ...defaults import INPUT_FORMAT, OUTPUT_FORMAT
from ...utils import log_rank_0
from .blended_dataset import BlendedDataset
from .builder import BlendedMegatronDatasetBuilder
from .gpt_dataset import GPTDataset, GPTDatasetConfig, Split
from .indexed_dataset import MMapIndexedDataset, MMapIndexedDatasetBuilder
from .native import compile_helpers
from .sampler import MegatronBatchSampler

__all__ = [
    "BlendedDataset",
    "BlendedMegatronDatasetBuilder",
    "GPTDataset",
    "GPTDatasetConfig",
    "MMapIndexedDataset",
    "MMapIndexedDatasetBuilder",
    "MegatronBatchSampler",
    "Split",
    "get_megatron_gpt_dataloaders",
]


class MegatronDataLoader:
    """Iterates a batch sampler over a dataset, yielding {"text": int64 [B, seq+1]} CPU
    tensors. Resume is by reconstructing with the right consumed_samples (metadata, not
    loader state)."""

    def __init__(self, dataset, batch_sampler: MegatronBatchSampler) -> None:
        self.dataset = dataset
        self.batch_sampler = batch_sampler

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        for indices in self.batch_sampler:
            yield {"text": torch.from_numpy(np.stack([np.asarray(self.dataset[i]["text"]) for i in indices]))}

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state_dict: dict) -> None:
        pass


def get_megatron_gpt_dataloaders(args, tokenizer, consumed_samples: int):
    """Build (train, [val...], [test...]) dataloaders from TrainingArgs.

    class_args keys (same contract as the reference): sequence_length, eval_steps, plus ONE of
      - data_path: [prefix] or [w1, p1, w2, p2, ...], with split "99,1,0"
      - train_data_path/val_data_path/test_data_path: per-split blends
      - train/val/test_weighted_split_paths: groups of {path, split "a:b", weight}
    and optional seed, data_cache_path, fim_rate, fim_spm_rate.
    """
    assert len(args.datasets) == 1, "megatron pretraining expects exactly one dataset entry"
    dataset_args = args.datasets[0]
    class_args = dataset_args.class_args

    assert dataset_args.max_input_tokens is None
    assert dataset_args.max_output_tokens is None
    assert dataset_args.input_format == INPUT_FORMAT
    assert dataset_args.output_format == OUTPUT_FORMAT

    micro_batch_size = args.training_parameters.micro_batch_size
    sequence_length = class_args.get("sequence_length")

    distributed = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    rank = dist.get_rank() if distributed else 0
    # one data-parallel rank a process (tensor / context parallelism are not ported)
    dp_world_size = dist.get_world_size() if distributed else 1

    if rank == 0:
        compile_helpers()
    if distributed:
        dist.barrier()
        if rank != 0:
            compile_helpers()  # built by rank 0: loads it

    log_rank_0(logging.INFO, "> building train, validation, and test datasets for GPT ...")

    sizes = _get_train_val_test_samples(
        args.training_parameters.num_training_steps,
        micro_batch_size,
        args.training_parameters.gradient_accumulation_steps,
        args.training_parameters.eval_interval,
        class_args.get("eval_steps"),
        dp_world_size,
    )

    def _make_builder(caching_allowed: bool) -> BlendedMegatronDatasetBuilder:
        return BlendedMegatronDatasetBuilder(
            GPTDataset,
            sizes=sizes,
            config=GPTDatasetConfig(
                random_seed=class_args.get("seed", args.random_args.seed),
                sequence_length=sequence_length,
                blend=class_args.get("data_path"),
                blend_per_split=[
                    class_args.get("train_data_path"),
                    class_args.get("val_data_path"),
                    class_args.get("test_data_path"),
                ],
                split=class_args.get("split"),
                path_to_cache=class_args.get("data_cache_path"),
                return_document_ids=False,
                fim_rate=class_args.get("fim_rate", 0),
                fim_spm_rate=class_args.get("fim_spm_rate", 0.5),
            ),
            tokenizer=tokenizer,
            caching_allowed=caching_allowed,
        )

    def _build(builder: BlendedMegatronDatasetBuilder):
        data_path = class_args.get("data_path")
        train_data_path = class_args.get("train_data_path")
        train_weighted_split_paths = class_args.get("train_weighted_split_paths")

        if data_path is not None or train_data_path is not None:
            train_ds, val_ds, test_ds = builder.build()
            if not isinstance(val_ds, list):
                val_ds = [val_ds]
            if not isinstance(test_ds, list):
                test_ds = [test_ds]
        elif train_weighted_split_paths:

            def _parse_and_get_dataset(weighted_split_paths, dataset_split: Split):
                if weighted_split_paths is None:
                    return []
                names, paths, splits, weights = [], [], [], []
                for group in weighted_split_paths:
                    assert len(group) == 1
                    group_name = list(group.keys())[0]
                    entries = group[group_name]
                    names.append([group_name] * len(entries))
                    paths.append([d["path"] for d in entries])
                    splits.append([d["split"] for d in entries])
                    weights.append([d["weight"] for d in entries])
                return builder.build_dataset_single_split(
                    names, paths, splits, weights, dataset_split
                )

            assert (
                len(train_weighted_split_paths) == 1
            ), "only 1 dataset group can be passed for training"
            train_ds = _parse_and_get_dataset(train_weighted_split_paths, Split.train)[0]
            val_ds = _parse_and_get_dataset(class_args.get("val_weighted_split_paths"), Split.valid)
            test_ds = _parse_and_get_dataset(
                class_args.get("test_weighted_split_paths"), Split.test
            )
        else:
            raise NotImplementedError("no dataloading argument passed")

        return train_ds, val_ds, test_ds

    # rank 0 builds (and writes the caches) first; every other rank reads the caches
    if rank == 0:
        train_ds, val_ds, test_ds = _build(_make_builder(caching_allowed=True))
    if distributed:
        dist.barrier()
        if rank != 0:
            train_ds, val_ds, test_ds = _build(_make_builder(caching_allowed=False))

    log_rank_0(logging.INFO, "> finished creating GPT datasets ...")

    def _get_dataloader(dataset, consumed: int):
        if dataset is None:
            return None
        sampler = MegatronBatchSampler(
            total_samples=len(dataset),
            consumed_samples=consumed,
            micro_batch_size=micro_batch_size,
            num_replicas=dp_world_size,
            rank=rank,
        )
        return iter(MegatronDataLoader(dataset, sampler))

    train_loader = _get_dataloader(train_ds, consumed_samples)
    val_loaders = [_get_dataloader(ds, 0) for ds in val_ds]
    test_loaders = [_get_dataloader(ds, 0) for ds in test_ds]

    return train_loader, val_loaders, test_loaders


def _get_train_val_test_samples(
    num_training_steps: int,
    micro_batch_size: int,
    gradient_accumulation_steps: int,
    eval_interval: int | None,
    eval_steps: int | None,
    dp_world_size: int,
) -> tuple[int, int, int]:
    """Samples each split must hold (the JAX package's `_get_train_val_test_samples`)."""
    samples_per_step = micro_batch_size * gradient_accumulation_steps * dp_world_size
    train_samples = num_training_steps * samples_per_step
    eval_steps = eval_steps or 0
    eval_interval = eval_interval or num_training_steps
    val_samples = (num_training_steps // eval_interval + 1) * eval_steps * samples_per_step
    test_samples = eval_steps * samples_per_step
    return train_samples, val_samples, test_samples
