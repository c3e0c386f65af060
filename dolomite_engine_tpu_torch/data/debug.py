"""A copy of `dolomite_engine_tpu/data/debug.py`. Parity: reference `dolomite_engine/data/debug.py` (`DebugDataset`): synthetic fixed-token
examples for profiling/timing; requires max_input_tokens/max_output_tokens."""

from __future__ import annotations

from ..enums import Mode
from .base import BaseDataset


class DebugDataset(BaseDataset):
    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)

        if self.do_format_input:
            raise ValueError("DebugDataset does not support input formatting")
        if self.do_format_output:
            raise ValueError("DebugDataset does not support output formatting")

        self._length = self.class_args.get("num_examples")
        assert isinstance(self._length, int) and self._length > 0

        eos = self.tokenizer.eos_token_id if self.tokenizer is not None else 0
        self._token_id = self.class_args.get("token_id", eos)
        self._static_examples = self.class_args.get("static_examples", True)

        if self._static_examples:
            self._example = self._get_example(self._token_id)

    def _get_example(self, token_id: int) -> dict:
        if self.mode == Mode.training:
            return {
                "input": [token_id] * self.max_input_tokens,
                "output": [token_id] * (self.max_output_tokens + 1),
            }
        # reference emits {"output": ...} here (debug.py:59) but its own collate_fn reads
        # i["input"] (utils.py:26) — emit the key generation actually consumes
        return {"input": [token_id] * self.max_input_tokens}

    def __getitem__(self, index: int) -> dict:
        if not (-self._length <= index < self._length):
            raise IndexError(index)  # keeps the sequence-iteration protocol terminating
        if self._static_examples:
            return self._example
        return self._get_example(index % 100)

    def __len__(self) -> int:
        return self._length
