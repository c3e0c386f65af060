"""The port's megatron data pipeline against the JAX package's, on the CPU.

The same seeded corpora go through both packages; everything must be identical:

- the ``.bin`` / ``.idx`` bytes each builder writes;
- `GPTDataset`'s document, sample and shuffle indices and its samples, with FIM off and
  on (a character-level tokenizer), and over several epochs;
- `BlendedDataset`'s indices and samples;
- the sampler's batches from consumed 0 and from a resume point;
- the batch streams of `get_megatron_gpt_dataloaders` for ``data_path``, per-split paths
  and ``*_weighted_split_paths`` args (train, every val and test group), from consumed 0
  and from a resume point. The JAX side runs with a data-parallel world of one device,
  the port's;
- the port's native helpers against its numpy paths.
"""

import numpy as np
import pytest
import torch

from dolomite_engine_tpu import distributed as jax_distributed
from dolomite_engine_tpu.arguments import TrainingArgs as JaxTrainingArgs
from dolomite_engine_tpu.data import megatron as jax_megatron
from dolomite_engine_tpu.data.megatron.blended_dataset import BlendedDataset as JaxBlendedDataset
from dolomite_engine_tpu_torch.arguments import TrainingArgs
from dolomite_engine_tpu_torch.data import megatron
from dolomite_engine_tpu_torch.data.megatron import native
from dolomite_engine_tpu_torch.data.megatron.blended_dataset import BlendedDataset


class _CharTokenizer:
    """Character-level tokenizer for FIM: token id = codepoint, sentinels up top."""

    eos_token_id = 0

    def decode(self, ids):
        return "".join(chr(int(i)) for i in ids)

    def encode(self, text, add_special_tokens=False):
        return [ord(c) for c in text]

    def convert_tokens_to_ids(self, tokens):
        return [100_001, 100_002, 100_003, 100_004][: len(tokens)]


def _documents(seed, count=60, vocab=500):
    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(count):
        doc = rng.randint(1, vocab, size=rng.randint(5, 60))
        doc[-1] = 0  # EOS closes each document
        docs.append(doc)
    return docs


def _write(package, prefix, docs, dtype):
    builder = package.MMapIndexedDatasetBuilder(str(prefix) + ".bin", dtype=dtype)
    for doc in docs:
        builder.add_item(np.asarray(doc))
        builder.end_document()
    builder.finalize(str(prefix) + ".idx")


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_builders_write_the_same_bytes(tmp_path, dtype):
    docs = _documents(0)
    _write(jax_megatron, tmp_path / "jax", docs, dtype)
    _write(megatron, tmp_path / "port", docs, dtype)
    for suffix in (".bin", ".idx"):
        assert (tmp_path / f"jax{suffix}").read_bytes() == (tmp_path / f"port{suffix}").read_bytes()
    port = megatron.MMapIndexedDataset(str(tmp_path / "jax"))
    for i in (0, 7, 59):
        np.testing.assert_array_equal(port[i], docs[i])


def _gpt_dataset(package, tmp_path, side, num_samples, fim_rate, tokenizer, seed=1234):
    prefix = tmp_path / "corpus"
    if not package.MMapIndexedDataset.exists(str(prefix)):
        _write(package, prefix, _documents(1), np.int32)
    config = package.GPTDatasetConfig(
        random_seed=seed,
        sequence_length=16,
        blend=[str(prefix)],
        split="100,0,0",
        path_to_cache=str(tmp_path / f"cache-{side}"),
        fim_rate=fim_rate,
        fim_spm_rate=0.5,
    )
    return package.GPTDataset(
        indexed_dataset=package.MMapIndexedDataset(str(prefix)),
        indexed_indices=np.arange(60, dtype=np.int32),
        num_samples=num_samples,
        index_split=package.Split.train,
        tokenizer=tokenizer,
        config=config,
    )


@pytest.mark.parametrize(
    "num_samples, fim_rate", [(40, 0.0), (40, 0.5), (400, 0.0)], ids=["one-epoch", "fim", "several-epochs"]
)
def test_gpt_dataset_indices_and_samples(tmp_path, num_samples, fim_rate):
    tokenizer = _CharTokenizer() if fim_rate else None
    ours = _gpt_dataset(megatron, tmp_path, "port", num_samples, fim_rate, tokenizer)
    theirs = _gpt_dataset(jax_megatron, tmp_path, "jax", num_samples, fim_rate, _CharTokenizer() if fim_rate else None)
    for name in ("document_index", "sample_index", "shuffle_index"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name), err_msg=name)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours[i]["text"], theirs[i]["text"])
    if fim_rate:
        samples = np.concatenate([ours[i]["text"] for i in range(len(ours))])
        assert {100_001, 100_002, 100_003} & set(samples.tolist()), "no FIM sentinel: FIM never ran"


def test_blended_dataset_indices(tmp_path):
    def build(package, blended_cls, side):
        datasets = []
        for name, seed in (("x", 3), ("y", 4)):
            prefix = tmp_path / f"{side}-{name}"
            _write(package, prefix, _documents(seed, count=30), np.int32)
            config = package.GPTDatasetConfig(
                random_seed=5, sequence_length=8, blend=[str(prefix)], split="100,0,0",
                path_to_cache=str(tmp_path / f"cache-{side}"),
            )
            datasets.append(
                package.GPTDataset(
                    package.MMapIndexedDataset(str(prefix)), np.arange(30, dtype=np.int32), 50,
                    package.Split.train, None, config,
                )
            )
        return blended_cls(datasets, [0.3, 0.7], 80, datasets[0].config)

    ours, theirs = build(megatron, BlendedDataset, "port"), build(jax_megatron, JaxBlendedDataset, "jax")
    np.testing.assert_array_equal(ours.dataset_index, theirs.dataset_index)
    np.testing.assert_array_equal(ours.dataset_sample_index, theirs.dataset_sample_index)
    for i in range(80):
        np.testing.assert_array_equal(ours[i]["text"], theirs[i]["text"])


@pytest.mark.parametrize("consumed", [0, 37])
def test_sampler_batches(consumed):
    kwargs = dict(total_samples=200, consumed_samples=consumed, micro_batch_size=4, num_replicas=1, rank=0)
    assert list(megatron.MegatronBatchSampler(**kwargs)) == list(jax_megatron.MegatronBatchSampler(**kwargs))


def _corpus(tmp_path, name, seed, count=300):
    prefix = tmp_path / name
    _write(megatron, prefix, _documents(seed, count=count, vocab=128), np.uint16)
    return str(prefix)


def _class_args(tmp_path, layout):
    a, b = _corpus(tmp_path, "a", 10), _corpus(tmp_path, "b", 11)
    args = dict(eval_steps=2, sequence_length=32, data_cache_path=str(tmp_path / "cache"))
    if layout == "data_path":
        args.update(data_path=[0.6, a, 0.4, b], split="90,6,4")
    elif layout == "per_split":
        args.update(train_data_path=[a], val_data_path=[0.5, a, 0.5, b], test_data_path=[b])
    else:
        args.update(
            train_weighted_split_paths=[{"TRAIN": [{"path": a, "split": "0:0.9", "weight": 1}, {"path": b, "split": "0:0.9", "weight": 2}]}],
            val_weighted_split_paths=[
                {"VAL_A": [{"path": a, "split": "0.9:1", "weight": 1}]},
                {"VAL_B": [{"path": b, "split": "0.9:1", "weight": 1}]},
            ],
            test_weighted_split_paths=[{"TEST": [{"path": b, "split": "0.9:1", "weight": 1}]}],
        )
    return args


def _args(cls, class_args, cache):
    return cls(
        model_args=dict(
            model_class="AutoModelForCausalLM",
            pretrained_config=dict(model_type="gpt_dolomite", vocab_size=128, n_embd=32, n_layer=1, n_head=4),
        ),
        tuning_args=dict(tuning_method="pretraining"),
        training_parameters=dict(num_training_steps=6, micro_batch_size=2, gradient_accumulation_steps=2, eval_interval=3),
        datasets=[dict(class_name="MegatronDataset", data_name="Megatron", class_args=dict(class_args, data_cache_path=cache))],
        save_args=dict(save_path="unused", save_interval=3),
        distributed_args=dict(stage=0),
    )


def _drain(loader):
    return [] if loader is None else [np.asarray(batch["text"]) for batch in loader]


@pytest.mark.parametrize("layout", ["data_path", "per_split", "weighted_split_paths"])
@pytest.mark.parametrize("consumed", [0, 8])
def test_dataloader_streams_match(tmp_path, monkeypatch, layout, consumed):
    # the JAX package's data-parallel world on one device, as the port trains
    monkeypatch.setattr(jax_distributed, "get_data_parallel_world_size", lambda args: 1)
    class_args = _class_args(tmp_path, layout)
    port_args = _args(TrainingArgs, class_args, str(tmp_path / "cache-port"))
    jax_args = _args(JaxTrainingArgs, class_args, str(tmp_path / "cache-jax"))

    ours = megatron.get_megatron_gpt_dataloaders(port_args, None, consumed)
    theirs = jax_megatron.get_megatron_gpt_dataloaders(jax_args, None, consumed)
    train = [next(ours[0]) for _ in range(4)]
    assert all(batch["text"].dtype == torch.int64 and batch["text"].device.type == "cpu" for batch in train)
    np.testing.assert_array_equal(
        np.stack([b["text"].numpy() for b in train]), np.stack([np.asarray(next(theirs[0])["text"]) for _ in range(4)])
    )
    for split in (1, 2):
        assert len(ours[split]) == len(theirs[split])
        for mine, ref in zip(ours[split], theirs[split]):
            got, want = _drain(mine), _drain(ref)
            assert len(got) == len(want) > 0
            np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_native_helpers_match_numpy():
    assert native.compile_helpers()
    weights = [0.7, 0.1, 0.2]
    a = native.build_blending_indices(weights, 500, use_native=True)
    b = native.build_blending_indices(weights, 500, use_native=False)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    rng = np.random.RandomState(0)
    sizes = rng.randint(1, 50, size=40).astype(np.int32)
    for dtype in (np.int32, np.int64):
        doc_idx = rng.permutation(np.tile(np.arange(40), 3)).astype(dtype)
        tokens = int(sizes.sum())
        native_idx = native.build_sample_idx(sizes, doc_idx, 16, 3, tokens, use_native=True)
        numpy_idx = native.build_sample_idx(sizes, doc_idx, 16, 3, tokens, use_native=False)
        np.testing.assert_array_equal(native_idx, numpy_idx)
        assert native_idx.dtype == dtype
