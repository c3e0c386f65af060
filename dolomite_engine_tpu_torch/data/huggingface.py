"""A copy of `dolomite_engine_tpu/data/huggingface.py`; `datasets` is imported only
inside the hub datasets' loaders. Parity: reference `dolomite_engine/data/huggingface.py` (`HuggingFaceDataset`) and
`data/sst2.py` (`SST2Dataset`)."""

from __future__ import annotations

from ..enums import DatasetKeys, DatasetSplit, Mode
from .base import BaseDataset


class HuggingFaceDataset(BaseDataset):
    """Any HF dataset with input/output keys."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.examples = self.prepare_examples()

    def prepare_examples(self) -> list[dict]:
        from datasets import load_dataset

        assert "data_path" in self.class_args, "`data_path` is not specified"
        data_path: str = self.class_args["data_path"]
        input_key: str = self.class_args.get("input_key", DatasetKeys.input.value)
        output_key: str = self.class_args.get("output_key", DatasetKeys.output.value)

        split = "validation" if self.split == DatasetSplit.val else self.split.value
        dataset = load_dataset(data_path)[split]

        examples = []
        for raw_example in dataset:
            input = self.construct_input_from_format(raw_example[input_key])
            output = (
                self.construct_output_from_format(raw_example[output_key])
                if self.mode == Mode.training
                else None
            )
            examples.append(self.get_input_output_token_ids(input, output))
        return examples


class SST2Dataset(BaseDataset):
    """SST-2 sentiment classification."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.examples = self.prepare_examples()

    def prepare_examples(self) -> list[dict]:
        from datasets import load_dataset

        split = "validation" if self.split == DatasetSplit.val else self.split.value
        raw_examples = load_dataset("sst2")[split]

        examples = []
        for raw_example in raw_examples:
            input = self.construct_input_from_format(raw_example["sentence"].strip())
            output = (
                self.construct_output_from_format(
                    "positive" if raw_example["label"] == 1 else "negative"
                )
                if self.mode == Mode.training
                else None
            )
            examples.append(self.get_input_output_token_ids(input, output))
        return examples


class JSONLinesDataset(BaseDataset):
    """Local jsonl directory dataset ({split}.jsonl with input/output keys)."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.examples = self.prepare_examples()

    def prepare_examples(self) -> list[dict]:
        import json
        import os

        data_path = self.class_args["data_path"]
        split = "val" if self.split == DatasetSplit.val else self.split.value
        file_path = os.path.join(data_path, f"{split}.jsonl")
        if not os.path.isfile(file_path):
            return []

        examples = []
        with open(file_path) as f:
            for line in f:
                raw = json.loads(line)
                input = self.construct_input_from_format(raw[DatasetKeys.input.value])
                output = (
                    self.construct_output_from_format(raw[DatasetKeys.output.value])
                    if self.mode == Mode.training
                    else None
                )
                examples.append(self.get_input_output_token_ids(input, output))
        return examples
