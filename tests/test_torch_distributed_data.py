"""The port's data-parallel loaders and the global-count loss, on the CPU over gloo.

- **Megatron**: at 2 ranks (micro batch 2 each), for consumed samples 0 and 12, each
  rank's train and val rows are its rows of the JAX package's global micro batch (its
  loader with a data-parallel world of 2: micro batch 4), device r's rows on rank r; rank
  0 alone writes the index caches (the other rank's ``np.save`` count is 0), as many
  files as a run of one rank writes.
- **Finetuning**: `get_dataloader` at 2 ranks against JAX's loader over a data-parallel
  world of 2 (its global batch): the sharded loader's two shards hold the global batch's
  examples, padded and packed; the dispatching loader gives rank r exactly JAX's device-r
  rows of the global batch (padded to the global length), and both ranks report the
  global loader's length.
- **`DispatchingDataLoader`**: the cases of `tests/data/test_multihost.py` (lockstep of a
  receiver that never reads storage, the None key, the length before the first batch,
  exhaustion, the int64 cast; and in one process the dtype rejection, the int64
  overflow and the excess dims).
- **The global-count loss** (`ops/loss.loss_denominator`): the finetuning loss and its
  gradients at 2 ranks, each rank holding examples with another number of label tokens,
  padded and packed, against one rank over all the examples: 1e-5 relative (1e-7
  absolute on the gradients, whose smallest entries are ~1e-5).
"""

import json

import jax
import numpy as np
import pytest
import torch
from transformers import AutoTokenizer

import chip_smoke
from dolomite_engine_tpu import data as jax_data
from dolomite_engine_tpu import distributed as jax_distributed
from dolomite_engine_tpu.arguments import TrainingArgs as JaxTrainingArgs
from dolomite_engine_tpu.data import megatron as jax_megatron
from dolomite_engine_tpu.enums import DatasetSplit as JaxSplit
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu_torch.data.dataloader import DispatchingDataLoader
from dolomite_engine_tpu_torch.data.megatron import MMapIndexedDatasetBuilder
from tests.torch_ranks import _FakeLoader, run_ranks

VOCAB, EOS = 64, 0
MICRO = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _megatron_config(tmp, cache):
    return dict(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=dict(model_type="gpt_dolomite", vocab_size=128, n_embd=32, n_layer=1, n_head=4)),
        tuning_args=dict(tuning_method="pretraining"),
        training_parameters=dict(num_training_steps=6, micro_batch_size=MICRO, gradient_accumulation_steps=2, eval_interval=3),
        datasets=[dict(class_name="MegatronDataset", data_name="Megatron", class_args=dict(
            data_path=[str(tmp / "corpus")], split="90,5,5", sequence_length=16, eval_steps=1, data_cache_path=str(tmp / cache),
        ))],
        save_args=dict(save_path="unused", save_interval=3),
        distributed_args=dict(stage=3),
    )


def _finetune_config(root, padding_free=False, dispatching=False):
    return dict(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=dict(model_type="gpt_dolomite", vocab_size=VOCAB, n_embd=32, n_layer=1, n_head=4), use_padding_free_transformer=padding_free),
        tokenizer_args=dict(tokenizer_name=str(root / "tokenizer")),
        tuning_args=dict(tuning_method="full_finetuning"),
        training_parameters=dict(num_training_steps=3, micro_batch_size=MICRO, gradient_accumulation_steps=1, eval_during_training=False),
        datasets=[dict(
            class_name="JSONLinesDataset", data_name="j", class_args=dict(data_path=str(root / "data")),
            input_format="__input__", output_format="__output__", max_input_tokens=16, max_output_tokens=8,
        )],
        save_args=dict(save_path="unused", save_interval=3),
        distributed_args=dict(stage=3, dispatching_dataloader=dispatching),
        random_args=dict(seed=3),
    )


def _examples(seed, count=4):
    """Finetuning examples whose output (label) lengths differ from example to example."""
    rs = np.random.RandomState(seed)
    examples = []
    for i in range(count):
        output = list(rs.randint(3, VOCAB, 2 + 2 * i)) + [EOS]
        examples.append({"input": list(rs.randint(3, VOCAB, rs.randint(3, 9))) + output, "output": output})
    return examples


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    builder = MMapIndexedDatasetBuilder(str(tmp / "corpus") + ".bin", dtype=np.uint16)
    for _ in range(150):
        builder.add_item(rng.randint(3, 128, size=rng.randint(10, 60)))
        builder.end_document()
    builder.finalize(str(tmp / "corpus") + ".idx")
    chip_smoke.word_tokenizer(str(tmp / "tokenizer"), VOCAB, EOS)
    (tmp / "data").mkdir()
    rs = np.random.RandomState(1)
    for split, count in (("train", 21), ("val", 6)):
        with open(tmp / "data" / f"{split}.jsonl", "w") as f:
            for _ in range(count):
                words = lambda n: " ".join(f"t{i}" for i in rs.randint(3, VOCAB, n))  # noqa: E731
                f.write(json.dumps({"input": words(rs.randint(2, 10)), "output": words(rs.randint(2, 7))}) + "\n")

    jobs = [
        ("megatron_rows", dict(args_config=_megatron_config(tmp, "cache-2"), consumed=0, steps=3)),
        ("megatron_rows", dict(args_config=_megatron_config(tmp, "cache-2"), consumed=12, steps=3)),
        ("finetuning_loader", dict(args_config=_finetune_config(tmp), steps=3, tokenizer_path=str(tmp / "tokenizer"))),
        ("finetuning_loader", dict(args_config=_finetune_config(tmp, padding_free=True), steps=3, tokenizer_path=str(tmp / "tokenizer"))),
        ("finetuning_loader", dict(args_config=_finetune_config(tmp, dispatching=True), steps=3, tokenizer_path=str(tmp / "tokenizer"))),
        ("dispatching", dict(kind="plain")),
        ("dispatching", dict(kind="int64")),
        ("finetuning_loss", dict(examples=_examples(0), padding_free=False)),
        ("finetuning_loss", dict(examples=_examples(0), padding_free=True)),
    ]
    names = ["megatron_0", "megatron_12", "sharded", "packed", "dispatched", "dispatch_plain", "dispatch_int64", "loss_padded", "loss_packed"]
    two = [dict(zip(names, r)) for r in run_ranks(2, tmp / "two", jobs)]
    one_jobs = [
        ("megatron_rows", dict(args_config=_megatron_config(tmp, "cache-1"), consumed=0, steps=1)),
        ("finetuning_loss", dict(examples=_examples(0), padding_free=False)),
        ("finetuning_loss", dict(examples=_examples(0), padding_free=True)),
    ]
    one = dict(zip(["megatron_0", "loss_padded", "loss_packed"], run_ranks(1, tmp / "one", one_jobs)[0]))
    return {"tmp": tmp, "two": two, "one": one}


# ------------------------------------------------------------------------------ megatron


@pytest.mark.parametrize("consumed", [0, 12])
def test_megatron_ranks_hold_jax_global_micro_batch(setup, consumed, monkeypatch):
    tmp = setup["tmp"]
    monkeypatch.setattr(jax_distributed, "get_data_parallel_world_size", lambda args: 2)
    train, val, _ = jax_megatron.get_megatron_gpt_dataloaders(JaxTrainingArgs(**_megatron_config(tmp, f"cache-jax-{consumed}")), None, consumed)
    want_train = [np.asarray(next(train)["text"]) for _ in range(3)]
    want_val = np.asarray(next(val[0])["text"])
    assert want_train[0].shape[0] == 2 * MICRO
    for rank, ranked in enumerate(r[f"megatron_{consumed}"] for r in setup["two"]):
        for got, want in zip(ranked["train"], want_train, strict=True):
            np.testing.assert_array_equal(got, want[rank * MICRO : (rank + 1) * MICRO])
        np.testing.assert_array_equal(ranked["val"][0], want_val[rank * MICRO : (rank + 1) * MICRO])


def test_megatron_caches_are_built_once(setup):
    first = [r["megatron_0"]["saved"] for r in setup["two"]]
    assert first[0] and first[1] == [], first  # rank 0 writes, rank 1 reads
    # the files one rank writes alone (their names hash the sample counts, which scale with
    # the world: compare the kinds)
    kinds = lambda names: sorted(name.split("-", 1)[1] for name in names)  # noqa: E731
    assert kinds(first[0]) == kinds(setup["one"]["megatron_0"]["saved"])
    assert all(r["megatron_12"]["saved"] == [] for r in setup["two"])  # a later build hits the caches


# ------------------------------------------------------------------------------ finetuning


def _jax_global_batches(tmp, padding_free, monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: 2)  # JAX's data-parallel world of 2
    tokenizer = AutoTokenizer.from_pretrained(str(tmp / "tokenizer"))
    loader = jax_data.get_dataloader(JaxTrainingArgs(**_finetune_config(tmp, padding_free)), JaxSplit.train, JaxMode.training, tokenizer)
    it = iter(loader)
    return [{k: None if v is None else np.asarray(v) for k, v in next(it).items()} for _ in range(3)], len(loader)


def _documents(batch):
    """The (input ids, labels) of each example of a collated batch, padding dropped."""
    if "segment_ids" in batch:
        out = []
        seg = batch["segment_ids"][0]
        for doc in range(1, seg.max() + 1):
            where = seg == doc
            out.append((tuple(batch["input_ids"][0][where]), tuple(batch["labels"][0][where][:-1])))
        return out
    out = []
    for ids, mask, labels in zip(batch["input_ids"], batch["attention_mask"], batch["labels"]):
        n = int(mask.sum())
        out.append((tuple(ids[-n:]), tuple(labels[-n:])))
    return out


@pytest.mark.parametrize("layout", ["sharded", "packed"])
def test_sharded_finetuning_loader_covers_jax_global_batch(setup, layout, monkeypatch):
    want, length = _jax_global_batches(setup["tmp"], layout == "packed", monkeypatch)
    ranks = [r[layout] for r in setup["two"]]
    assert [r["kind"] for r in ranks] == ["ShardedDataLoader"] * 2
    assert ranks[0]["state"] == ranks[1]["state"]  # rank-agnostic: epoch and cursor
    for step, batch in enumerate(want):
        got = sorted(_documents(ranks[0]["batches"][step]) + _documents(ranks[1]["batches"][step]))
        assert got == sorted(_documents(batch))
        assert len(_documents(ranks[0]["batches"][step])) == MICRO


def test_dispatching_finetuning_loader_gives_each_rank_its_jax_rows(setup, monkeypatch):
    want, length = _jax_global_batches(setup["tmp"], False, monkeypatch)
    ranks = [r["dispatched"] for r in setup["two"]]
    assert [r["kind"] for r in ranks] == ["DispatchingDataLoader"] * 2
    assert ranks[0]["length"] == ranks[1]["length"] == length
    for rank, ranked in enumerate(ranks):
        for got, batch in zip(ranked["batches"], want, strict=True):
            assert got.keys() == batch.keys()
            for key, value in batch.items():
                np.testing.assert_array_equal(got[key], value[rank * MICRO : (rank + 1) * MICRO], err_msg=key)


# ------------------------------------------------------------------------------ dispatching


def test_dispatching_loader_lockstep_at_two_ranks(setup):
    source, receiver = (r["dispatch_plain"] for r in setup["two"])
    assert source["length"] == receiver["length"] == 3  # before the first batch
    assert len(source["batches"]) == len(receiver["batches"]) == 3  # exhausted together
    for i, (mine, theirs) in enumerate(zip(source["batches"], receiver["batches"])):
        for rank, batch in enumerate((mine, theirs)):
            assert batch["position_ids"] is None
            np.testing.assert_array_equal(batch["input_ids"][0], np.full((4, 6), i))
            np.testing.assert_array_equal(batch["labels"][0], np.full((4, 6), 100 + i))
            np.testing.assert_array_equal(batch["mask"][0], (np.arange(48).reshape(8, 6) % 3 == 0)[rank * 4 : rank * 4 + 4])
            assert batch["mask"][1] == "torch.bool" and batch["input_ids"][1] == "torch.int32"
    assert source["state"] == {"cursor": 7} and receiver["state"] == {}
    for rank, ranked in enumerate(r["dispatch_int64"] for r in setup["two"]):
        for i, batch in enumerate(ranked["batches"]):
            ids, dtype = batch["ids"]
            assert dtype == "torch.int32"
            np.testing.assert_array_equal(ids, (np.arange(48).reshape(8, 6) + i)[rank * 4 : rank * 4 + 4])


@pytest.mark.parametrize(
    "kind, match",
    [("float64", "weights.*float64"), ("overflow", "ids.*int32 range"), ("deep", "deep.*ndim 7")],
)
def test_dispatching_loader_rejects(kind, match):
    loader = DispatchingDataLoader(_FakeLoader(kind))
    with pytest.raises(ValueError, match=match):
        next(iter(loader))


def test_dispatching_loader_int64_cast_at_one_rank():
    batch = next(iter(DispatchingDataLoader(_FakeLoader("int64"))))
    assert batch["ids"].dtype == torch.int32
    np.testing.assert_array_equal(batch["ids"].numpy(), np.arange(48).reshape(8, 6))


# ------------------------------------------------------------------------------ the loss


@pytest.mark.parametrize("layout", ["padded", "packed"])
def test_finetuning_loss_divides_by_the_global_count(setup, layout):
    one = setup["one"][f"loss_{layout}"]
    ranks = [r[f"loss_{layout}"] for r in setup["two"]]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    # each rank's share is its tokens' sum over the global count: the shares add up, where
    # a mean of the ranks' own means would weigh rank 0's fewer tokens up
    np.testing.assert_allclose(ranks[0]["local_loss"] + ranks[1]["local_loss"], one["loss"], rtol=1e-5)
    for name, grad in one["grads"].items():
        np.testing.assert_allclose(ranks[0]["grads"][name], grad, rtol=1e-5, atol=1e-7, err_msg=name)
