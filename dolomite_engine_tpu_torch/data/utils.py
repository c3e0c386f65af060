"""Collate + iterator helpers (a copy of `dolomite_engine_tpu/data/utils.py`).

Parity: reference `dolomite_engine/data/utils.py:8-130` (`collate_fn`, `infinite_iterator`,
`get_next_batch`). Collate semantics preserved exactly: decoder-only left-pads input_ids with
EOS and builds attention_mask + labels per LossMask; encoder-decoder right-pads labels.
Padding-free mode returns packed fixed-shape tensors with segment/position ids (the TPU-native
form of the reference's list-of-lists + cu_seqlens) — XLA needs static shapes, so rows are padded
to `pad_to_multiple` (segment id 0 = padding).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from ..enums import LossMask, Mode

LABELS_MASK_VALUE = -100


def collate_fn(
    batch: list[dict],
    mode: Mode,
    loss_mask: LossMask,
    eos_token_id: int,
    is_encoder_decoder: bool,
    use_padding_free_transformer: bool,
    labels_mask_value: int = LABELS_MASK_VALUE,
    pad_to_multiple: int = 128,
) -> dict:
    inputs = [i["input"] for i in batch]
    outputs = [i["output"] for i in batch] if mode == Mode.training else None
    labels = None

    if is_encoder_decoder:
        if use_padding_free_transformer:
            raise NotImplementedError("padding free transformer only supports decoder only models")

        input_max_length = max(map(len, inputs))
        input_ids = [[eos_token_id] * (input_max_length - len(a)) + a for a in inputs]
        attention_mask = [[0] * (input_max_length - len(a)) + [1] * len(a) for a in inputs]

        if outputs is not None:
            assert loss_mask == LossMask.output_only, (
                "only output_only loss mask is supported with encoder decoder models"
            )
            output_max_length = max(map(len, outputs))
            labels = [a + [labels_mask_value] * (output_max_length - len(a)) for a in outputs]
    elif use_padding_free_transformer:
        # packed form: each row keeps its own tokens left-aligned with per-row padding to a
        # static length; segment_ids isolate documents, position_ids restart per document
        if outputs is not None:
            if loss_mask == LossMask.output_only:
                raw_labels = [
                    [labels_mask_value] * (len(a_in) - len(a_out)) + a_out
                    for a_in, a_out in zip(inputs, outputs)
                ]
            elif loss_mask == LossMask.no_mask:
                raw_labels = inputs
            else:
                raise ValueError(f"unexpected loss_mask ({loss_mask})")
        else:
            raw_labels = None

        total = sum(map(len, inputs))
        length = -(-max(total, 1) // pad_to_multiple) * pad_to_multiple

        input_ids = np.full((1, length), eos_token_id, dtype=np.int32)
        position_ids = np.zeros((1, length), dtype=np.int32)
        segment_ids = np.zeros((1, length), dtype=np.int32)
        labels_arr = np.full((1, length), labels_mask_value, dtype=np.int32)

        offset = 0
        for doc_idx, seq in enumerate(inputs):
            n = len(seq)
            input_ids[0, offset : offset + n] = seq
            position_ids[0, offset : offset + n] = np.arange(n)
            segment_ids[0, offset : offset + n] = doc_idx + 1
            if raw_labels is not None:
                labels_arr[0, offset : offset + n] = raw_labels[doc_idx]
            offset += n

        result = {
            "input_ids": input_ids,
            "position_ids": position_ids,
            "segment_ids": segment_ids,
        }
        if mode == Mode.training:
            # shift left by one for next-token prediction (model consumes pre-shifted labels)
            shifted = np.full_like(labels_arr, labels_mask_value)
            shifted[:, :-1] = labels_arr[:, 1:]
            boundary = segment_ids[:, :-1] != segment_ids[:, 1:]
            shifted[:, :-1][boundary] = labels_mask_value
            result["labels"] = shifted
        return result
    else:
        max_length = max(map(len, inputs))
        input_ids = [[eos_token_id] * (max_length - len(a)) + a for a in inputs]
        attention_mask = [[0] * (max_length - len(a)) + [1] * len(a) for a in inputs]

        if outputs is not None:
            if loss_mask == LossMask.output_only:
                labels = [[labels_mask_value] * (max_length - len(a)) + a for a in outputs]
            elif loss_mask == LossMask.no_mask:
                labels = inputs
            else:
                raise ValueError(f"unexpected loss_mask ({loss_mask})")

    result = {"input_ids": np.asarray(input_ids, dtype=np.int32)}
    if not use_padding_free_transformer:
        result["attention_mask"] = np.asarray(attention_mask, dtype=np.int32)
    if mode == Mode.training and labels is not None:
        labels_arr = np.asarray(labels, dtype=np.int32)
        if is_encoder_decoder:
            # decoder targets as-is (reference data/utils.py:44-49); the seq2seq model
            # builds the shifted-right decoder inputs itself (enc_dec_dolomite.shift_right)
            result["labels"] = labels_arr
        else:
            # labels are aligned to input positions; shift left for next-token prediction
            shifted = np.full_like(labels_arr, labels_mask_value)
            shifted[:, :-1] = labels_arr[:, 1:]
            result["labels"] = shifted
    return result


def infinite_iterator(x: Iterable | None) -> Iterable | None:
    if x is None:
        return None
    while True:
        for i in x:
            yield i


def get_next_batch(x: Iterable | None) -> dict | None:
    if x is None:
        return None
    return next(x)
