"""Finetuning dataset base classes (a copy of `dolomite_engine_tpu/data/base.py`).

Parity: reference `dolomite_engine/data/base.py:8-247` (`BaseDataset`, `BlendedDatasets`,
`get_max_input_length`/`get_max_output_length`). Framework-neutral Python — no torch Dataset
inheritance; a dataset is anything with __len__/__getitem__ returning
{"input": [ids], "output": [ids]}.

The tokenization CONTRACT (what loss-parity with the reference depends on):
  - prompts are tokenized without special tokens, then budget-truncated;
  - an encoder-decoder prompt ends with EOS (budget includes it), a decoder-only prompt
    does not;
  - training targets are truncated to leave room for exactly one EOS, then EOS-terminated;
  - decoder-only training examples store prompt+target in "input" and the target alone in
    "output" (the collator derives the prompt-masked labels from the two lengths);
  - the token budgets subtract PEFT virtual tokens from the stack they are prepended to
    (prompt side for decoder-only / encoder; see `get_max_input_length`).
"""

from __future__ import annotations

from bisect import bisect_right
from itertools import accumulate

from ..defaults import INPUT_FORMAT, OUTPUT_FORMAT
from ..enums import DatasetSplit, Mode


def get_max_input_length(
    max_input_tokens_specified: int | None, num_virtual_tokens: int, is_encoder_decoder: bool
) -> int | None:
    """Prompt-token budget: the user-specified cap minus prompt-tuning virtual tokens,
    minus the EOS the encoder appends (encoder-decoder only). None = unlimited."""
    if max_input_tokens_specified is None:
        return None
    eos_reserve = 1 if is_encoder_decoder else 0
    return max_input_tokens_specified - num_virtual_tokens - eos_reserve


def get_max_output_length(
    max_output_tokens_specified: int | None, num_virtual_tokens: int, is_encoder_decoder: bool
) -> int | None:
    """Target-token budget: always reserves one slot for EOS; virtual tokens only eat into
    the decoder budget on encoder-decoder models (they prefix the decoder there)."""
    if max_output_tokens_specified is None:
        return None
    virtual = num_virtual_tokens if is_encoder_decoder else 0
    return max_output_tokens_specified - 1 - virtual


class BaseDataset:
    def __init__(
        self,
        class_args: dict,
        split: DatasetSplit,
        mode: Mode,
        tokenizer,
        is_encoder_decoder: bool,
        data_name: str,
        input_format: str,
        output_format: str,
        max_input_tokens: int | None,
        max_output_tokens: int | None,
        num_virtual_tokens: int = 0,
    ) -> None:
        self.split = split
        self.mode = mode
        self.class_args = class_args
        self.tokenizer = tokenizer
        self.is_encoder_decoder = is_encoder_decoder
        self.num_virtual_tokens = num_virtual_tokens or 0
        self.data_name = data_name
        self.input_format = input_format
        self.output_format = output_format

        # identity formats skip the replace() on every example
        self.do_format_input = self.input_format != INPUT_FORMAT
        self.do_format_output = self.output_format != OUTPUT_FORMAT

        self.max_input_tokens = get_max_input_length(
            max_input_tokens, self.num_virtual_tokens, is_encoder_decoder
        )
        self.max_output_tokens = get_max_output_length(
            max_output_tokens, self.num_virtual_tokens, is_encoder_decoder
        )

        self.examples: list[dict] = []

    # -------------------------------------------------------------- formatting
    def construct_input_from_format(self, input: str) -> str:
        return (
            self.input_format.replace(INPUT_FORMAT, input, 1) if self.do_format_input else input
        )

    def construct_output_from_format(self, output: str) -> str:
        return (
            self.output_format.replace(OUTPUT_FORMAT, output, 1)
            if self.do_format_output
            else output
        )

    # -------------------------------------------------------------- tokenization
    def _tokenize(self, text: str) -> list[int]:
        return self.tokenizer(text, add_special_tokens=False)["input_ids"]

    def get_input_output_token_ids(self, input: str, output: str | None) -> dict:
        eos = self.tokenizer.eos_token_id
        budget_in, budget_out = self.max_input_tokens, self.max_output_tokens

        prompt = self._tokenize(input)
        if budget_in is not None:
            # enc-dec: get_max_input_length already reserved one slot for the EOS appended
            # below, yet we subtract 1 AGAIN — deliberately mirroring the reference
            # implementation's double reservation (parity quirk, one token shorter than
            # strictly necessary)
            keep = budget_in - 1 if self.is_encoder_decoder else budget_in
            del prompt[keep:]
        if self.is_encoder_decoder:
            prompt.append(eos)

        if self.mode != Mode.training:
            return {"input": prompt}

        target = self._tokenize(output)
        if budget_out is not None:
            del target[budget_out - 1 :]
        target.append(eos)

        example = {"input": prompt + target, "output": target}
        if self.is_encoder_decoder:
            example["input"] = prompt
        return example

    # -------------------------------------------------------------- resumable-iteration hooks
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state_dict: dict) -> None:
        return

    def __getitem__(self, index: int) -> dict:
        return self.examples[index]

    def __len__(self) -> int:
        return len(self.examples)


class BlendedDatasets:
    """Concatenation of datasets (reference `data/base.py:136-198`). Global indices map to
    (dataset, local index) via cumulative-size bisection — O(log n_datasets) per lookup with
    no per-example index materialization."""

    def __init__(self, datasets: list[BaseDataset], split: DatasetSplit) -> None:
        self.split = split
        self.datasets = datasets
        self._sizes = [len(d) for d in datasets]
        self._ends = list(accumulate(self._sizes))
        self.num_examples = self._ends[-1] if self._ends else 0

    def get_num_datasets(self) -> int:
        return len(self.datasets)

    def get_num_examples_in_each_dataset(self) -> list[int]:
        return list(self._sizes)

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state_dict: dict) -> None:
        return

    def __len__(self) -> int:
        return self.num_examples

    def __getitem__(self, index: int) -> dict:
        which = bisect_right(self._ends, index)
        start = self._ends[which - 1] if which else 0
        return self.datasets[which][index - start]

    def __repr__(self) -> str:
        lines = [
            f"number of datasets = {self.get_num_datasets()}",
            f"total examples in the entire dataset mixture = {len(self)}",
        ]
        lines += [
            f"examples in {d.__class__.__name__} ({d.data_name}) = {len(d)}"
            for d in self.datasets
        ]
        return "\n".join(lines)
