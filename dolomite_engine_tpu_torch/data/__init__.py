"""Data pipelines of the port (mirrors `dolomite_engine_tpu/data/`): the megatron
pretraining loaders, the async step prefetcher, the finetuning / generation dataset
registry (`get_datasets_list`) and the blended finetuning dataloader (`get_dataloader`)."""

from __future__ import annotations

import logging
from functools import partial

import torch
import torch.distributed as dist

from ..enums import DatasetSplit, Mode
from ..utils import log_rank_0
from .base import BaseDataset, BlendedDatasets
from .dataloader import DispatchingDataLoader, ResumableDataLoader, ShardedDataLoader
from .debug import DebugDataset
from .huggingface import HuggingFaceDataset, JSONLinesDataset, SST2Dataset
from .instruction_tuning import AlpacaDataset, DollyDataset, SlimOrcaDataset
from .prefetch import PrefetchingIterable, StepPrefetcher
from .sampler import BlendedDistributedSampler
from .utils import collate_fn, get_next_batch, infinite_iterator

_DATASETS_LIST = {
    "AlpacaDataset": AlpacaDataset,
    "DebugDataset": DebugDataset,
    "DollyDataset": DollyDataset,
    "HuggingFaceDataset": HuggingFaceDataset,
    "JSONLinesDataset": JSONLinesDataset,
    "SlimOrcaDataset": SlimOrcaDataset,
    "SST2Dataset": SST2Dataset,
}


def get_datasets_list(
    dataset_args_list,
    split: DatasetSplit,
    mode: Mode,
    tokenizer,
    is_encoder_decoder: bool = False,
    num_virtual_tokens: int = 0,
) -> tuple[list[BaseDataset], list[int]]:
    """The non-empty datasets of `dataset_args_list` for `split`, and their sampling
    ratios (each dataset's size where none is given)."""
    datasets_list = []
    data_sampling_ratios = []
    for data_args in dataset_args_list:
        if data_args.class_name not in _DATASETS_LIST:
            raise ValueError(f"invalid class_name ({data_args.class_name}) for dataset")

        dataset = _DATASETS_LIST[data_args.class_name](
            class_args=data_args.class_args,
            split=split,
            mode=mode,
            tokenizer=tokenizer,
            is_encoder_decoder=is_encoder_decoder,
            data_name=data_args.data_name,
            input_format=data_args.input_format,
            output_format=data_args.output_format,
            max_input_tokens=data_args.max_input_tokens,
            max_output_tokens=data_args.max_output_tokens,
            num_virtual_tokens=num_virtual_tokens,
        )

        if len(dataset) > 0:
            datasets_list.append(dataset)
            data_sampling_ratios.append(data_args.data_sampling_ratio)
            log_rank_0(
                logging.INFO,
                f"examples in {dataset.__class__.__name__} ({data_args.data_name}) = {len(dataset)}",
            )

    assert all(i is not None for i in data_sampling_ratios) or all(
        i is None for i in data_sampling_ratios
    ), "either all data_sampling_ratios should be specified or all should be None"
    if all(i is None for i in data_sampling_ratios):
        data_sampling_ratios = [len(i) for i in datasets_list]

    return datasets_list, data_sampling_ratios


def get_dataloader(
    args,
    split: DatasetSplit,
    mode: Mode,
    tokenizer,
    is_encoder_decoder: bool = False,
) -> ResumableDataLoader | ShardedDataLoader | DispatchingDataLoader | None:
    """The blended finetuning dataloader of `split` (None when it has no examples), the
    JAX package's `get_dataloader` with one process a data-parallel rank. Each rank samples
    its own strided shard of the global batch (``num_replicas`` = the world, ``rank`` =
    its rank) and yields its ``micro_batch_size`` examples; with more than one rank the
    loader is a `ShardedDataLoader`. ``dispatching_dataloader``: only rank 0 builds the
    datasets and samples the whole global batch, the data's presence is agreed by a
    broadcast, and every rank gets a `DispatchingDataLoader`.
    Batches are numpy arrays from `collate_fn` (tensors from the dispatching loader):
    left-padded with ``attention_mask``, or packed (padding-free) with ``position_ids`` /
    ``segment_ids``."""
    assert mode == Mode.training, "blended dataset is only supported in training mode"
    assert tokenizer is not None, (
        "finetuning data pipeline requires a tokenizer: set model_args.model_name or "
        "model_args.tokenizer_name"
    )
    distributed = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if distributed else 0
    world = dist.get_world_size() if distributed else 1
    dispatching = args.distributed_args.dispatching_dataloader

    datasets_list, data_sampling_ratios = [], []
    if not (dispatching and rank != 0):
        # the other ranks of a dispatching run never touch storage: the mode's point
        datasets_list, data_sampling_ratios = get_datasets_list(
            dataset_args_list=args.datasets,
            split=split,
            mode=Mode.training,
            tokenizer=tokenizer,
            is_encoder_decoder=is_encoder_decoder,
            num_virtual_tokens=args.tuning_args.get_num_virtual_tokens(),
        )

    if dispatching and distributed:
        # agreed by every rank: if rank 0 has no data for this split it returns None and
        # never joins the loader's broadcasts, so a receiver would wait forever
        has_data = torch.tensor([int(len(datasets_list) > 0)], dtype=torch.int32)
        dist.broadcast(has_data, src=0)
        if not int(has_data[0]):
            return None
        if rank != 0:
            return DispatchingDataLoader(None)
    elif len(datasets_list) == 0:
        return None

    blended_dataset = BlendedDatasets(datasets=datasets_list, split=split)
    # dispatching: rank 0 samples the WHOLE global batch; else each rank its shard
    num_replicas = 1 if dispatching else world
    sampler = BlendedDistributedSampler(
        dataset=blended_dataset,
        data_sampling_ratios=[1] if len(datasets_list) == 1 else data_sampling_ratios,
        num_replicas=num_replicas,
        rank=0 if dispatching else rank,
        ignore_sampling_proportion_for_validation=args.training_parameters.ignore_sampling_proportion_for_validation,
        shuffle=split == DatasetSplit.train,
        seed=args.random_args.seed,
        drop_last=False,
    )
    micro_batch_size = args.training_parameters.micro_batch_size
    local_batch = micro_batch_size * world // num_replicas
    loader = ResumableDataLoader(
        blended_dataset,
        batch_size=max(local_batch, 1),
        sampler=sampler,
        collate_fn=partial(
            collate_fn,
            mode=mode,
            loss_mask=args.training_parameters.loss_mask,
            eos_token_id=tokenizer.eos_token_id,
            is_encoder_decoder=is_encoder_decoder,
            use_padding_free_transformer=args.model_args.use_padding_free_transformer,
        ),
        drop_last=True,
    )
    _log_dataset(
        blended_dataset,
        sampler,
        split,
        args.training_parameters.num_training_steps,
        args.training_parameters.gradient_accumulation_steps,
        micro_batch_size,
        world,
    )
    if dispatching:
        return DispatchingDataLoader(loader)
    if world > 1:
        return ShardedDataLoader(loader)
    return loader


def _log_dataset(
    blended_dataset,
    sampler,
    split,
    num_training_steps,
    gradient_accumulation_steps,
    micro_batch_size,
    dp_world_size,
) -> None:
    log_rank_0(logging.INFO, f"{'-' * 25} {split.value} {'-' * 25}")
    log_rank_0(logging.INFO, repr(blended_dataset))

    if split == DatasetSplit.train and num_training_steps is not None:
        total_samples_seen = num_training_steps * gradient_accumulation_steps * micro_batch_size * dp_world_size
    else:
        num_steps = -(-len(blended_dataset) // (micro_batch_size * dp_world_size))
        total_samples_seen = num_steps * micro_batch_size * dp_world_size

    log_rank_0(logging.INFO, "*" * 57)
    log_rank_0(logging.INFO, f"total samples seen = {total_samples_seen}")
    log_rank_0(logging.INFO, f"total epochs for the dataset mixture = {total_samples_seen / len(blended_dataset)}")
    log_rank_0(logging.INFO, repr(sampler))
    log_rank_0(logging.INFO, "-" * 57)
