"""The port's finetuning / generation datasets and collate against the JAX package's.

Every dataset class of the registry is built on both sides from the same inputs with a
stub word tokenizer (``t<id>`` words, EOS 0): `JSONLinesDataset` over a directory the
test writes, `DebugDataset`, and the hub datasets (`HuggingFaceDataset`, `SST2Dataset`,
`AlpacaDataset`, `DollyDataset`, `SlimOrcaDataset`) over a stub `datasets.load_dataset`,
in training and inference modes, decoder-only and encoder-decoder (whose prompt budget
keeps the reference's double reservation), with and without token budgets and input /
output formats. Examples must be equal; `collate_fn`'s arrays equal in every branch;
`BlendedDatasets` and `get_datasets_list` index alike.
"""

import json
import sys
import types

import numpy as np
import pytest

from dolomite_engine_tpu import data as jax_data
from dolomite_engine_tpu.arguments import DatasetArgs as JaxDatasetArgs
from dolomite_engine_tpu.enums import DatasetSplit as JaxSplit
from dolomite_engine_tpu.enums import LossMask as JaxLossMask
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu_torch import data
from dolomite_engine_tpu_torch.arguments import DatasetArgs, TrainingArgs
from dolomite_engine_tpu_torch.enums import DatasetSplit, LossMask, Mode


class WordTokenizer:
    """``t<id>`` words to their ids, other words (the instruction templates') to 60-89;
    EOS (and pad) 0."""

    eos_token_id = 0
    pad_token_id = 0

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [self._id(word) for word in text.split()]}

    @staticmethod
    def _id(word):
        return int(word[1:]) if word[0] == "t" and word[1:].isdigit() else 60 + sum(map(ord, word)) % 30

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{i}" for i in ids if not (skip_special_tokens and i == self.eos_token_id))


def _text(rs, n):
    return " ".join(f"t{i}" for i in rs.randint(1, 50, n))


@pytest.fixture
def hub(monkeypatch):
    """A stub `datasets` module whose `load_dataset` serves small seeded splits."""
    rs = np.random.RandomState(0)

    def rows(make):
        return {split: [make(i) for i in range(4)] for split in ("train", "validation", "test")}

    tables = {
        "local/qa": rows(lambda i: {"question": _text(rs, 6 + i), "answer": _text(rs, 3 + i)}),
        "sst2": rows(lambda i: {"sentence": f" {_text(rs, 5 + i)} ", "label": i % 2}),
        "tatsu-lab/alpaca": rows(lambda i: {"instruction": _text(rs, 4), "input": "" if i % 2 else _text(rs, 3), "output": f" {_text(rs, 2)} "}),
        "databricks/databricks-dolly-15k": rows(lambda i: {"instruction": _text(rs, 4), "context": _text(rs, 2), "response": _text(rs, 3)}),
        "Open-Orca/SlimOrca-Dedup": rows(
            lambda i: {"conversations": [{"value": _text(rs, 3)}, {"value": _text(rs, 4)}, {"value": _text(rs, 2)}]}
        ),
    }
    module = types.ModuleType("datasets")
    module.load_dataset = lambda name: tables[name]
    monkeypatch.setitem(sys.modules, "datasets", module)


@pytest.fixture
def jsonl_dir(tmp_path):
    rs = np.random.RandomState(1)
    for split in ("train", "val", "test"):
        with open(tmp_path / f"{split}.jsonl", "w") as f:
            for i in range(5):
                f.write(json.dumps({"input": _text(rs, 4 + 3 * i), "output": _text(rs, 2 + i)}) + "\n")
    return str(tmp_path)


DATASETS = {
    "JSONLinesDataset": lambda path: {"data_path": path},
    "DebugDataset": lambda path: {"num_examples": 3, "token_id": 7},
    "HuggingFaceDataset": lambda path: {"data_path": "local/qa", "input_key": "question", "output_key": "answer"},
    "SST2Dataset": lambda path: {},
    "AlpacaDataset": lambda path: {},
    "DollyDataset": lambda path: {},
    "SlimOrcaDataset": lambda path: {},
}


# DebugDataset's examples are budget-sized, so it runs with the budgets only
@pytest.mark.parametrize(
    "class_name, budgets",
    [(name, budgets) for name in DATASETS for budgets in ((6, 4),) + ((None,) if name != "DebugDataset" else ())],
    ids=lambda value: "budgets" if isinstance(value, tuple) else ("unbounded" if value is None else value),
)
@pytest.mark.parametrize("mode", ["training", "inference"])
@pytest.mark.parametrize("encoder_decoder", [False, True], ids=["decoder", "encoder_decoder"])
def test_datasets_match_jax(hub, jsonl_dir, class_name, budgets, mode, encoder_decoder):
    formats = (
        ("__input__", "__output__")
        if class_name in ("DebugDataset", "AlpacaDataset", "DollyDataset", "SlimOrcaDataset")
        else ("t9 __input__ t8", "t7 __output__")
    )
    for split in ("train", "val", "test"):
        kwargs = dict(
            class_args=DATASETS[class_name](jsonl_dir), tokenizer=WordTokenizer(), is_encoder_decoder=encoder_decoder,
            data_name="d", input_format=formats[0], output_format=formats[1],
            max_input_tokens=None if budgets is None else budgets[0],
            max_output_tokens=None if budgets is None else budgets[1], num_virtual_tokens=1 if budgets else 0,
        )
        want = jax_data._DATASETS_LIST[class_name](split=JaxSplit(split), mode=JaxMode(mode), **kwargs)
        got = data._DATASETS_LIST[class_name](split=DatasetSplit(split), mode=Mode(mode), **kwargs)
        assert len(got) == len(want)
        assert [got[i] for i in range(len(got))] == [want[i] for i in range(len(want))]


def test_blended_and_registry_match_jax(jsonl_dir):
    args = [
        dict(class_name="JSONLinesDataset", data_name="a", class_args={"data_path": jsonl_dir}),
        dict(class_name="DebugDataset", data_name="b", class_args={"num_examples": 4}, max_input_tokens=3, max_output_tokens=2),
    ]
    want, want_ratios = jax_data.get_datasets_list(
        [JaxDatasetArgs(**a) for a in args], JaxSplit.test, JaxMode.inference, WordTokenizer()
    )
    got, ratios = data.get_datasets_list([DatasetArgs(**a) for a in args], DatasetSplit.test, Mode.inference, WordTokenizer())
    assert ratios == want_ratios == [5, 4]
    blended = data.BlendedDatasets(got, DatasetSplit.test)
    jax_blended = jax_data.BlendedDatasets(want, JaxSplit.test)
    assert len(blended) == len(jax_blended) == 9
    assert [blended[i] for i in range(9)] == [jax_blended[i] for i in range(9)]
    assert blended.get_num_examples_in_each_dataset() == [5, 4] and repr(blended) == repr(jax_blended)
    with pytest.raises(ValueError, match="invalid class_name"):
        data.get_datasets_list([DatasetArgs(class_name="Nope", data_name="c", class_args={})], DatasetSplit.test, Mode.inference, None)
    # the blended training loader over the same registry: micro batches of the collated rows
    training = TrainingArgs(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config={"model_type": "gpt_dolomite"}),
        tuning_args=dict(tuning_method="full_finetuning"), save_args=dict(save_path="unused", save_interval=1),
        datasets=[DatasetArgs(**args[0]).model_dump()], training_parameters=dict(num_training_steps=2, micro_batch_size=2, eval_during_training=False),
    )
    loader = data.get_dataloader(training, DatasetSplit.train, Mode.training, WordTokenizer())
    batches = list(loader)
    assert len(batches) == len(loader) > 0 and all(b["input_ids"].shape[0] == 2 for b in batches)
    assert all(b.keys() == {"input_ids", "attention_mask", "labels"} for b in batches)


def _batch(rs, rows=3):
    inputs = [list(rs.randint(1, 50, n)) for n in rs.randint(3, 9, rows)]
    return [{"input": i, "output": i[-2:]} for i in inputs]


@pytest.mark.parametrize("mode", ["training", "inference"])
@pytest.mark.parametrize("loss_mask", ["output_only", "no_mask"])
@pytest.mark.parametrize("layout", ["padded", "padding_free", "encoder_decoder"])
def test_collate_matches_jax(mode, loss_mask, layout):
    batch = _batch(np.random.RandomState(2))
    options = dict(eos_token_id=0, is_encoder_decoder=layout == "encoder_decoder", use_padding_free_transformer=layout == "padding_free", pad_to_multiple=16)
    if layout == "encoder_decoder" and loss_mask == "no_mask" and mode == "training":
        # the encoder-decoder collate takes only output_only labels, on both sides
        with pytest.raises(AssertionError, match="output_only"):
            jax_data.collate_fn(batch, mode=JaxMode.training, loss_mask=JaxLossMask.no_mask, **options)
        with pytest.raises(AssertionError, match="output_only"):
            data.collate_fn(batch, mode=Mode.training, loss_mask=LossMask.no_mask, **options)
        return
    if layout == "padded" and loss_mask == "no_mask" and mode == "training":
        # the reference's quirk: no_mask labels are the unpadded inputs, so rows of
        # different lengths do not stack, on both sides
        with pytest.raises(ValueError, match="inhomogeneous"):
            jax_data.collate_fn(batch, mode=JaxMode.training, loss_mask=JaxLossMask.no_mask, **options)
        with pytest.raises(ValueError, match="inhomogeneous"):
            data.collate_fn(batch, mode=Mode.training, loss_mask=LossMask.no_mask, **options)
        batch = [dict(row, input=row["input"][:3]) for row in batch]  # and rows of one length do
    want = jax_data.collate_fn(batch, mode=JaxMode(mode), loss_mask=JaxLossMask(loss_mask), **options)
    got = data.collate_fn(batch, mode=Mode(mode), loss_mask=LossMask(loss_mask), **options)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def test_iterators():
    it = data.infinite_iterator([1, 2])
    assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1]
    assert data.get_next_batch(iter([{"a": 1}])) == {"a": 1}
    assert data.get_next_batch(None) is None
    assert list(data.infinite_iterator(None)) == []  # a generator function: None ends it at once
