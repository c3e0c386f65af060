"""Data pipelines of the port (mirrors `dolomite_engine_tpu/data/`): the megatron
pretraining loaders, the async step prefetcher, and the finetuning / generation dataset
registry (`get_datasets_list`)."""

from __future__ import annotations

import logging

from ..enums import DatasetSplit, Mode
from ..utils import log_rank_0
from .base import BaseDataset, BlendedDatasets
from .debug import DebugDataset
from .huggingface import HuggingFaceDataset, JSONLinesDataset, SST2Dataset
from .instruction_tuning import AlpacaDataset, DollyDataset, SlimOrcaDataset
from .prefetch import PrefetchingIterable, StepPrefetcher
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


def get_dataloader(*args, **kwargs):
    """The blended finetuning dataloader: not ported yet."""
    raise NotImplementedError(
        "the finetuning dataloader is not ported yet: ROADMAP.md Queue A, 'Finetune and PEFT'"
    )
