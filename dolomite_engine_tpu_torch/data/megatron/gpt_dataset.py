"""GPT pretraining dataset: seq_len+1 token windows over shuffled document epochs, with
optional fill-in-the-middle (FIM) augmentation (a copy of
`dolomite_engine_tpu/data/megatron/gpt_dataset.py`).

Parity: reference `data/megatron/gpt_dataset.py` (578 LoC) + `megatron_dataset.py` +
`blended_megatron_dataset_config.py`:
  - document index = num_epochs copies of the split's doc ids, shuffled (optionally keeping the
    final epoch separately shuffled when it contributes < 80% of an epoch's samples)
    (reference `_build_document_index` 442-475, threshold logic 297-322);
  - sample index = (doc, offset) pairs from the native/vectorized builder (helpers);
  - shuffle index = permutation over samples (two-range when separate_final_epoch, 478-509);
  - all three cached as .npy keyed by an md5 of the identifying config (265-285);
  - FIM psm/spm per document segment between EOD tokens (170-237, permute 513-578). The
    reference calls megatron-tokenizer methods (`tokenizer.eod`/`detokenize`); here the HF
    tokenizer API is used (`decode`/`encode(add_special_tokens=False)`, eod = eos_token_id).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from collections import OrderedDict
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from ...utils import log_rank_0
from .indexed_dataset import MMapIndexedDataset
from .native import build_sample_idx, normalize


class Split(Enum):
    train = 0
    valid = 1
    test = 2


FIM_PREFIX = "<fim_prefix>"
FIM_MIDDLE = "<fim_middle>"
FIM_SUFFIX = "<fim_suffix>"
FIM_PAD = "<fim_pad>"


@dataclass
class GPTDatasetConfig:
    """Reference `blended_megatron_dataset_config.py:11-95` (torch/dist-free)."""

    random_seed: int
    sequence_length: int
    name: str | None = None
    blend: list[str] | None = None
    blend_per_split: list[list[str] | None] | None = None
    split: str | None = None
    split_vector: list[float] | None = field(init=False, default=None)
    path_to_cache: str | None = None
    return_document_ids: bool = False
    fim_rate: float = 0.0
    fim_spm_rate: float = 0.0

    def __post_init__(self) -> None:
        if self.blend_per_split is not None and any(self.blend_per_split):
            assert self.blend is None, "blend and blend_per_split are incompatible"
            assert len(self.blend_per_split) == len(Split)
            self.split = None
        elif self.blend is not None:
            assert self.split is not None, "both blend and split must be provided"
            self.split_vector = parse_and_normalize_split(self.split)


def parse_and_normalize_split(split: str) -> list[float]:
    """"99,1,0" -> [0.99, 0.01, 0.0] (reference `_parse_and_normalize_split`)."""
    import re

    parts = list(map(float, re.findall(r"[.0-9]+", split)))
    parts = parts + [0.0] * (len(Split) - len(parts))
    assert len(parts) == len(Split) and all(p >= 0.0 for p in parts)
    return normalize(parts)


class GPTDataset:
    """Samples are {"text": int64 [sequence_length + 1]} windows over the token stream."""

    def __init__(
        self,
        indexed_dataset: MMapIndexedDataset,
        indexed_indices: np.ndarray,
        num_samples: int,
        index_split: Split,
        tokenizer,
        config: GPTDatasetConfig,
        caching_allowed: bool = True,
    ) -> None:
        assert indexed_indices.size > 0
        assert num_samples > 0

        self.indexed_dataset = indexed_dataset
        self.indexed_indices = indexed_indices
        self.num_samples = num_samples
        self.index_split = index_split
        self.config = config
        self.caching_allowed = caching_allowed
        self.tokenizer = tokenizer

        unique_identifiers = OrderedDict(
            [
                ("class", type(self).__name__),
                ("path_prefix", indexed_dataset.path_prefix),
                ("num_samples", num_samples),
                ("index_split", index_split.name),
                ("name", config.name),
                ("split", config.split),
                ("random_seed", config.random_seed),
                ("sequence_length", config.sequence_length),
            ]
        )
        self.unique_description = json.dumps(unique_identifiers, indent=4)
        self.unique_description_hash = hashlib.md5(
            self.unique_description.encode("utf-8")
        ).hexdigest()

        self.fim_rate = config.fim_rate
        self.fim_spm_rate = config.fim_spm_rate
        self._fim_rng = np.random.RandomState(seed=config.random_seed)
        if self.fim_rate != 0:
            assert 0 <= self.fim_rate <= 1
            ids = tokenizer.convert_tokens_to_ids([FIM_SUFFIX, FIM_PREFIX, FIM_MIDDLE, FIM_PAD])
            self.suffix_tok_id, self.prefix_tok_id, self.middle_tok_id, self.pad_tok_id = ids
            self.eod_token_id = tokenizer.eos_token_id

        (
            self.document_index,
            self.sample_index,
            self.shuffle_index,
        ) = self._build_document_sample_shuffle_indices()

    def __len__(self) -> int:
        return self.sample_index.shape[0] - 1

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        text, document_ids = self._query(idx)
        if self.config.return_document_ids:
            return {"text": text, "document_ids": document_ids}
        return {"text": text}

    # ------------------------------------------------------------------ sample assembly
    def _query(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        idx = int(self.shuffle_index[idx])

        doc_beg, doc_beg_offset = self.sample_index[idx]
        doc_end, doc_end_offset = self.sample_index[idx + 1]

        document_ids = []
        parts = []
        if doc_beg == doc_end:
            document_ids.append(self.document_index[doc_beg])
            parts.append(
                self.indexed_dataset.get(
                    int(self.document_index[doc_beg]),
                    offset=int(doc_beg_offset),
                    length=int(doc_end_offset) - int(doc_beg_offset) + 1,
                )
            )
        else:
            for i in range(int(doc_beg), int(doc_end) + 1):
                document_ids.append(self.document_index[i])
                offset = int(doc_beg_offset) if i == doc_beg else 0
                length = int(doc_end_offset) + 1 if i == doc_end else None
                parts.append(
                    self.indexed_dataset.get(int(self.document_index[i]), offset=offset, length=length)
                )
        sample = np.concatenate(parts).astype(np.int64)

        if self.fim_rate != 0:
            sample = self._apply_fim(sample)

        return sample, np.asarray(document_ids, dtype=np.int64)

    def _apply_fim(self, sample: np.ndarray) -> np.ndarray:
        """Per-document-segment FIM between EOD tokens; output re-truncated/padded to the
        original length (reference gpt_dataset.py:170-237)."""
        sample_len = sample.shape[0]
        eod = self.eod_token_id
        breaks = np.argwhere(sample == eod)

        if breaks.shape != (0, 1):
            start = 0
            pieces = []
            for loc in np.nditer(breaks):
                if loc - start > 0:
                    pieces += [self._permute(sample[start:loc]), np.asarray([eod])]
                start = int(loc) + 1
            pieces.append(self._permute(sample[start:]))
            sample = np.concatenate(pieces)
        else:
            sample = self._permute(sample)

        diff = sample.shape[0] - sample_len
        if diff > 0:
            sample = sample[:sample_len]
        elif diff < 0:
            sample = np.concatenate([sample, np.full(-diff, self.pad_tok_id, dtype=np.int64)])
        return sample

    def _permute(self, segment: np.ndarray) -> np.ndarray:
        """PSM/SPM rearrangement of one document segment (reference permute 513-578, with
        truncate_or_pad=False as the reference call sites use)."""
        rng = self._fim_rng
        if not rng.binomial(1, self.fim_rate):
            return segment
        if segment.size == 0:
            return segment

        contents = self.tokenizer.decode(segment)
        boundaries = sorted(rng.randint(low=0, high=len(contents) + 1, size=2))

        encode = lambda s: np.asarray(
            self.tokenizer.encode(s, add_special_tokens=False), dtype=np.int64
        )
        prefix = encode(contents[: boundaries[0]])
        middle = encode(contents[boundaries[0] : boundaries[1]])
        suffix = encode(contents[boundaries[1] :])

        if rng.binomial(1, self.fim_spm_rate):
            # SPM (variant 2 from the FIM paper)
            return np.concatenate(
                [[self.prefix_tok_id, self.suffix_tok_id], suffix, [self.middle_tok_id], prefix, middle]
            )
        # PSM
        return np.concatenate(
            [[self.prefix_tok_id], prefix, [self.suffix_tok_id], suffix, [self.middle_tok_id], middle]
        )

    # ------------------------------------------------------------------ index building
    def _build_document_sample_shuffle_indices(self):
        path_to_cache = self.config.path_to_cache
        if path_to_cache is None:
            path_to_cache = os.path.join(
                self.indexed_dataset.path_prefix, "cache", f"{type(self).__name__}_indices"
            )

        def get_path(suffix: str) -> str:
            return os.path.join(
                path_to_cache, f"{self.unique_description_hash}-{type(self).__name__}-{suffix}"
            )

        path_to_description = get_path("description.txt")
        path_to_document_index = get_path("document_index.npy")
        path_to_sample_index = get_path("sample_index.npy")
        path_to_shuffle_index = get_path("shuffle_index.npy")
        cache_hit = all(
            map(
                os.path.isfile,
                [path_to_description, path_to_document_index, path_to_sample_index, path_to_shuffle_index],
            )
        )

        num_tokens_per_epoch = int(
            np.sum(self.indexed_dataset.sequence_lengths[self.indexed_indices])
        )
        sequence_length = self.config.sequence_length
        num_epochs = _get_num_epochs(num_tokens_per_epoch, sequence_length, self.num_samples)

        if not cache_hit and self.caching_allowed:
            log_rank_0(
                logging.INFO,
                f"building {type(self).__name__} {self.index_split.name} indices "
                f"({num_epochs} epochs, {num_tokens_per_epoch} tokens/epoch)",
            )

            if num_epochs == 1:
                separate_final_epoch = False
                num_samples_sans_final_epoch = self.num_samples
            else:
                num_samples_sans_final_epoch = (
                    (num_epochs - 1) * num_tokens_per_epoch - 1
                ) // sequence_length
                num_samples_from_final_epoch = self.num_samples - num_samples_sans_final_epoch
                num_samples_per_epoch = (num_tokens_per_epoch - 1) // sequence_length

                assert num_samples_from_final_epoch >= 0
                assert num_samples_from_final_epoch <= num_samples_per_epoch + 1

                # final epoch shuffled separately when it contributes < 80% of an epoch, so
                # early training doesn't over-sample its documents
                separate_final_epoch = num_samples_from_final_epoch < int(
                    0.80 * num_samples_per_epoch
                )

            rng = np.random.RandomState(self.config.random_seed)
            os.makedirs(path_to_cache, exist_ok=True)
            with open(path_to_description, "wt") as writer:
                writer.write(self.unique_description)

            document_index = _build_document_index(
                self.indexed_indices, num_epochs, rng, separate_final_epoch
            )
            np.save(path_to_document_index, document_index, allow_pickle=True)

            assert self.indexed_dataset.sequence_lengths.dtype == np.int32
            sample_index = build_sample_idx(
                self.indexed_dataset.sequence_lengths,
                document_index,
                sequence_length,
                num_epochs,
                num_tokens_per_epoch,
            )
            np.save(path_to_sample_index, sample_index, allow_pickle=True)

            if separate_final_epoch:
                shuffle_index = _build_shuffle_index(
                    num_samples_sans_final_epoch, sample_index.shape[0] - 1, rng
                )
            else:
                shuffle_index = _build_shuffle_index(
                    sample_index.shape[0] - 1, sample_index.shape[0] - 1, rng
                )
            np.save(path_to_shuffle_index, shuffle_index, allow_pickle=True)

        document_index = np.load(path_to_document_index, allow_pickle=True, mmap_mode="r")
        sample_index = np.load(path_to_sample_index, allow_pickle=True, mmap_mode="r")
        shuffle_index = np.load(path_to_shuffle_index, allow_pickle=True, mmap_mode="r")

        log_rank_0(
            logging.INFO,
            f"loaded {type(self).__name__} {self.index_split.name} indices: "
            f"{sample_index.shape[0] - 1} samples over {num_epochs} epochs",
        )
        return document_index, sample_index, shuffle_index


def _get_num_epochs(num_tokens_per_epoch: int, seq_length: int, num_samples: int) -> int:
    """Smallest epoch count whose token stream covers num_samples windows (the -1: windows
    overlap by one token; reference `_get_num_epochs`)."""
    num_epochs = 0
    num_tokens = 0
    while True:
        num_epochs += 1
        num_tokens += num_tokens_per_epoch
        if ((num_tokens - 1) // seq_length) >= num_samples:
            return num_epochs


def _build_document_index(
    documents: np.ndarray,
    num_epochs: int,
    rng: np.random.RandomState,
    separate_final_epoch: bool,
) -> np.ndarray:
    if not separate_final_epoch or num_epochs == 1:
        document_index = np.tile(np.asarray(documents), num_epochs).astype(documents.dtype)
        rng.shuffle(document_index)
        return document_index

    doc_idx_first = _build_document_index(documents, num_epochs - 1, rng, False)
    doc_idx_last = _build_document_index(documents, 1, rng, False)
    return np.concatenate((doc_idx_first, doc_idx_last))


def _build_shuffle_index(
    num_samples: int, total_size: int, rng: np.random.RandomState
) -> np.ndarray:
    dtype = np.uint32 if total_size < (np.iinfo(np.uint32).max - 1) else np.int64

    shuffle_first = np.arange(0, num_samples, dtype=dtype)
    rng.shuffle(shuffle_first)
    if num_samples == total_size:
        return shuffle_first

    shuffle_last = np.arange(num_samples, total_size, dtype=dtype)
    rng.shuffle(shuffle_last)
    return np.concatenate((shuffle_first, shuffle_last))
