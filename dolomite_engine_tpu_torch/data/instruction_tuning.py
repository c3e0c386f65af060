"""Instruction-tuning datasets (a copy of `dolomite_engine_tpu/data/instruction_tuning.py`).

Parity: reference `dolomite_engine/data/instruction_tuning/` (`BaseInstructionDataset`,
`AlpacaDataset`, `DollyDataset`, `SlimOrcaDataset`): same prompt template
("{instruction}\\n\\n[input: {input}\\n]output:") and the same HF source datasets.
"""

from __future__ import annotations

from ..enums import DatasetSplit
from .base import BaseDataset


class BaseInstructionDataset(BaseDataset):
    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if self.do_format_input:
            raise ValueError(
                f"input_format for {self.__class__.__name__} should be '__input__'"
            )
        self.examples = self.prepare_examples()

    def construct_input_from_format(self, instruction: str, input: str) -> str:
        input_text = instruction + "\n\n"
        if not (input is None or input == ""):
            input_text += f"input: {input}\n"
        input_text += "output:"
        return input_text

    def prepare_examples(self) -> list[dict]:
        raise NotImplementedError()


class AlpacaDataset(BaseInstructionDataset):
    def prepare_examples(self) -> list[dict]:
        if self.split != DatasetSplit.train:
            return []
        from datasets import load_dataset

        data = load_dataset("tatsu-lab/alpaca")["train"]
        examples = []
        for raw in data:
            input = self.construct_input_from_format(raw["instruction"], raw.get("input", ""))
            output = self.construct_output_from_format(raw["output"].strip())
            examples.append(self.get_input_output_token_ids(input, output))
        return examples


class DollyDataset(BaseInstructionDataset):
    def prepare_examples(self) -> list[dict]:
        if self.split != DatasetSplit.train:
            return []
        from datasets import load_dataset

        data = load_dataset("databricks/databricks-dolly-15k")["train"]
        examples = []
        for raw in data:
            input = self.construct_input_from_format(raw["instruction"], raw.get("context", ""))
            output = self.construct_output_from_format(raw["response"].strip())
            examples.append(self.get_input_output_token_ids(input, output))
        return examples


class SlimOrcaDataset(BaseInstructionDataset):
    def prepare_examples(self) -> list[dict]:
        if self.split != DatasetSplit.train:
            return []
        from datasets import load_dataset

        data = load_dataset("Open-Orca/SlimOrca-Dedup")["train"]
        examples = []
        for raw in data:
            conv = raw["conversations"]
            input = self.construct_input_from_format(conv[0]["value"], conv[1]["value"])
            output = self.construct_output_from_format(conv[2]["value"].strip())
            examples.append(self.get_input_output_token_ids(input, output))
        return examples
