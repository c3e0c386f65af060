"""The port's entry points and checkpoints over ranks, on the CPU over gloo.

- **Checkpoints**: `pretrain.main` at 2 ranks and ZeRO stage 3 saves at step 2 (an async
  save, its collectives on the checkpoint's own gloo group); a resumed run to step 4 gives
  the unbroken run's losses and grad norms bit for bit, and its step-4 checkpoint the
  unbroken one's weights. The unbroken step-4 checkpoint (sharded by 2 ranks) restored at
  1 rank (training: a wrapped model and its optimizer) and at 2 ranks gives bit-identical
  weights and first moments, and `load_checkpoint_for_inference` reads it into a plain,
  unwrapped model with the same weights. Every rank writes its own RNG state; the
  consumed samples count both ranks. A preemption notice that one rank receives makes
  both ranks save and stop.
- **`pretrain.main` against JAX's** (from a YAML, as ``--config`` reads it; `finetune.main`
  too): 3 steps at 2 ranks with micro batch 4 from the JAX
  run's initial weights, against JAX's `pretrain.main` over its 8 virtual devices at micro
  batch 1 (the same global batch of 8 rows): losses, grad norms, the eval losses (steps 0
  and 2) and the test loss within 1e-5 relative (fp32 sums reassociated).
- **`finetune.main`**: at 2 ranks (stage 3, the sharded loader, micro batch 3) against 1
  rank at micro batch 6 (the same global batches): losses, grad norms and eval losses
  within 1e-5 relative; then the same at 2 ranks with ``dispatching_dataloader``.
"""

import json

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

import chip_smoke
from dolomite_engine_tpu import pretrain as jax_pretrain
from dolomite_engine_tpu.arguments import TrainingArgs as JaxTrainingArgs
from dolomite_engine_tpu.model_wrapper import base as jax_model_base
from dolomite_engine_tpu.parallel.mesh import MeshManager as JaxMeshManager
from dolomite_engine_tpu_torch.data.megatron import MMapIndexedDatasetBuilder
from dolomite_engine_tpu_torch.utils import dump_yaml
from tests.torch_ranks import run_ranks

MODEL = dict(
    model_type="gpt_dolomite", vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4,
    attention_head_type="mha", position_embedding_type="rope", activation_function="swiglu",
    normalization_function="rmsnorm", add_bias=False, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    bos_token_id=0, eos_token_id=1, pad_token_id=2,
)
VOCAB, EOS = 64, 0


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pretrain_config(tmp, save, steps, micro, load=None, stage=3, **sections):
    config = dict(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=dict(MODEL)),
        tuning_args=dict(tuning_method="pretraining"),
        training_parameters=dict(
            num_training_steps=steps, micro_batch_size=micro, gradient_accumulation_steps=2,
            eval_during_training=True, eval_interval=2,
        ),
        datasets=[dict(class_name="MegatronDataset", data_name="Megatron", class_args=dict(
            eval_steps=1, data_cache_path=str(tmp / "cache"), data_path=[str(tmp / "corpus")], split="90,5,5",
            sequence_length=32,
        ))],
        optimizer_args=dict(class_args=dict(lr=1e-3)),
        save_args=dict(save_path=str(tmp / save), save_interval=2),
        distributed_args=dict(stage=stage),
        logging_args=dict(log_interval=1),
        random_args=dict(seed=7),
    )
    for key, value in sections.items():
        config[key] = dict(config.get(key, {}), **value)
    if load is not None:
        config["load_args"] = dict(load_path=str(tmp / load))
    return config


def _finetune_config(tmp, micro, dispatching=False):
    return dict(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=dict(MODEL, vocab_size=VOCAB, bos_token_id=EOS, eos_token_id=EOS, pad_token_id=EOS)),
        tokenizer_args=dict(tokenizer_name=str(tmp / "tokenizer")),
        tuning_args=dict(tuning_method="full_finetuning"),
        training_parameters=dict(
            num_training_steps=3, micro_batch_size=micro, gradient_accumulation_steps=1, eval_during_training=True,
            eval_interval=2, gradient_clipping=1.0,
        ),
        datasets=[dict(
            class_name="JSONLinesDataset", data_name="j", class_args=dict(data_path=str(tmp / "data")),
            input_format="__input__", output_format="__output__", max_input_tokens=16, max_output_tokens=8,
        )],
        optimizer_args=dict(class_name="TorchAdamW", class_args=dict(lr=1e-2, weight_decay=0.1, betas=[0.9, 0.95], eps=1e-10)),
        lr_scheduler_args=dict(lr_decay_style="cosine", num_warmup_steps=1),
        distributed_args=dict(stage=3, dispatching_dataloader=dispatching),
        save_args=dict(save_path=str(tmp / f"ft-{micro}-{dispatching}"), save_interval=3),
        logging_args=dict(log_interval=1),
        random_args=dict(seed=3),
    )


class _StubTokenizer:
    eos_token_id = 1
    pad_token_id = 2
    vocab_size = 128

    def __len__(self):
        return self.vocab_size

    def save_pretrained(self, path):
        pass


def _jax_pretrain(tmp, monkeypatch):
    """JAX's `pretrain.main` over the 8 virtual devices at micro batch 1: its initial
    weights, its per-step losses and grad norms, and its eval losses by step."""
    captured, steps, evals = {}, [], {}
    monkeypatch.setattr(jax_model_base.ModelWrapper, "_setup_tokenizer", lambda self, *a: setattr(self, "tokenizer", _StubTokenizer()))
    create = jax_pretrain.create_sharded_train_state

    def capturing(*args, **kwargs):
        state, shardings = create(*args, **kwargs)
        captured["params"] = jax.tree.map(np.asarray, nn.unbox(state.params))
        return state, shardings

    monkeypatch.setattr(jax_pretrain, "create_sharded_train_state", capturing)
    monkeypatch.setattr(jax_pretrain, "track_train_metrics", lambda **k: steps.append((k["global_step"], k["train_loss_step"], k["grad_norm"])))
    monkeypatch.setattr(jax_pretrain, "track_val_metrics", lambda step, loss, *a, **k: evals.__setitem__(step, float(loss)))
    JaxMeshManager.destroy()
    try:
        jax_pretrain.main(args=JaxTrainingArgs(**_pretrain_config(tmp, "jax", 3, 1, stage=3)))
    finally:
        JaxMeshManager.destroy()
    return captured["params"], steps, evals


@pytest.fixture(scope="module")
def setup(tmp_path_factory, eight_devices):
    tmp = tmp_path_factory.mktemp("train")
    rng = np.random.RandomState(0)
    builder = MMapIndexedDatasetBuilder(str(tmp / "corpus") + ".bin", dtype=np.uint16)
    for _ in range(200):
        builder.add_item(rng.randint(0, 128, size=rng.randint(10, 80)))
        builder.end_document()
    builder.finalize(str(tmp / "corpus") + ".idx")
    chip_smoke.word_tokenizer(str(tmp / "tokenizer"), VOCAB, EOS)
    (tmp / "data").mkdir()
    rs = np.random.RandomState(1)
    for split, count in (("train", 24), ("val", 6)):
        with open(tmp / "data" / f"{split}.jsonl", "w") as f:
            for _ in range(count):
                words = lambda n: " ".join(f"t{i}" for i in rs.randint(3, VOCAB, n))  # noqa: E731
                f.write(json.dumps({"input": words(rs.randint(2, 10)), "output": words(rs.randint(2, 7))}) + "\n")

    with pytest.MonkeyPatch.context() as monkeypatch:
        jax_params, jax_steps, jax_evals = _jax_pretrain(tmp, monkeypatch)

    def yaml(name, config):
        """The entry points read these runs from YAML files, as `--config` does."""
        dump_yaml(config, str(tmp / f"{name}.yml"))
        return str(tmp / f"{name}.yml")

    async_save = dict(save_args=dict(async_checkpointing=True, save_optimizer=True))
    two_jobs = [
        ("pretrain_main", dict(config=_pretrain_config(tmp, "unbroken", 4, 2))),
        ("pretrain_main", dict(config=_pretrain_config(tmp, "broken", 2, 2, **async_save))),
        ("pretrain_main", dict(config=_pretrain_config(tmp, "broken", 4, 2, load="broken", **async_save))),
        ("checkpoint_weights", dict(config=_pretrain_config(tmp, "unused", 4, 2, load="unbroken"))),
        ("checkpoint_weights", dict(config=_pretrain_config(tmp, "unused", 4, 2, load="broken"))),
        ("pretrain_main", dict(config=yaml("parity", _pretrain_config(tmp, "parity", 3, 4)), params=jax_params)),
        ("finetune_main", dict(config=yaml("finetune", _finetune_config(tmp, 3)))),
        ("finetune_main", dict(config=yaml("dispatching", _finetune_config(tmp, 3, dispatching=True)))),
        ("pretrain_preempted", dict(
            config=_pretrain_config(tmp, "preempted", 4, 2, fault_tolerance_args=dict(preemption_checkpointing=True)),
            notified_rank=1, at_step=2,
        )),
    ]
    names = ["unbroken", "first", "resumed", "restored", "restored_resumed", "parity", "finetune", "finetune_dispatching", "preempted"]
    two = [dict(zip(names, r)) for r in run_ranks(2, tmp / "two", two_jobs)]
    one_jobs = [
        ("checkpoint_weights", dict(config=_pretrain_config(tmp, "unused", 4, 2, load="unbroken"))),
        ("finetune_main", dict(config=yaml("finetune-one-rank", _finetune_config(tmp, 6)))),
    ]
    one = dict(zip(["restored", "finetune"], run_ranks(1, tmp / "one", one_jobs)[0]))
    return {"tmp": tmp, "two": two, "one": one, "jax_steps": jax_steps, "jax_evals": jax_evals}


def _curve(summary):
    return [(s["step"], s["loss"], s["grad_norm"]) for s in summary["steps"]]


# ------------------------------------------------------------------------------ checkpoints


def test_resume_at_two_ranks_is_bit_identical(setup):
    tmp = setup["tmp"]
    for ranked in setup["two"]:
        unbroken = _curve(ranked["unbroken"])
        assert _curve(ranked["first"]) == unbroken[:2]
        assert _curve(ranked["resumed"]) == unbroken[2:]  # bit for bit
    assert setup["two"][0]["unbroken"]["steps"][0]["loss"] == setup["two"][1]["unbroken"]["steps"][0]["loss"]
    step4 = json.loads((tmp / "unbroken" / "global_step4" / "metadata.json").read_text())
    assert step4["consumed_samples"] == 4 * 2 * 2 * 2  # steps x micro x accumulation x ranks
    assert {p.name for p in (tmp / "unbroken" / "global_step4").iterdir()} >= {"rng_state-0.json", "rng_state-1.json", "state"}
    restored = setup["two"][0]["restored"]["weights"]
    resumed = setup["two"][0]["restored_resumed"]["weights"]
    for name, value in restored.items():
        np.testing.assert_array_equal(resumed[name], value, err_msg=name)


def test_two_rank_checkpoint_loads_at_one_rank_bit_identical(setup):
    one = setup["one"]["restored"]
    two = setup["two"][0]["restored"]
    assert one["step"] == two["step"] == 4 and one["metadata"] == two["metadata"]
    assert one["weights"].keys() == two["weights"].keys() == one["plain"].keys()
    for name, value in two["weights"].items():
        np.testing.assert_array_equal(one["weights"][name], value, err_msg=name)
        np.testing.assert_array_equal(one["plain"][name], value, err_msg=name)  # the unwrapped inference load
        np.testing.assert_array_equal(one["mu"][name], two["mu"][name], err_msg=name)
    assert any(np.abs(v).sum() for v in one["mu"].values())  # the moments were written, not fresh zeros


def test_one_ranks_preemption_notice_makes_every_rank_save(setup):
    """Only rank 1 receives the notice, during step 2 of 4: both ranks stop after step 2 and
    save it (the notice is agreed over the ranks each step)."""
    tmp = setup["tmp"]
    for ranked in setup["two"]:
        assert ranked["preempted"]["preempted"] and [s["step"] for s in ranked["preempted"]["steps"]] == [1, 2]
    assert json.loads((tmp / "preempted" / "latest_checkpointed_iteration.json").read_text())["latest_checkpointed_iteration"] == 2


# ------------------------------------------------------------------------------ entry points


def test_pretrain_main_at_two_ranks_matches_jax_over_eight_devices(setup):
    want = setup["jax_steps"]
    for ranked in setup["two"]:
        got = _curve(ranked["parity"])
        assert [s for s, _, _ in got] == [s for s, _, _ in want] == [1, 2, 3]
        np.testing.assert_allclose([loss for _, loss, _ in got], [loss for _, loss, _ in want], rtol=1e-5)
        np.testing.assert_allclose([norm for _, _, norm in got], [norm for _, _, norm in want], rtol=1e-5)
        # JAX reports its test split's loss through the same call, at the last step
        evals = dict(ranked["parity"]["val_losses"], test=ranked["parity"]["test_loss"])
        want_evals = {0: setup["jax_evals"][0], 2: setup["jax_evals"][2], "test": setup["jax_evals"][3]}
        assert evals.keys() == want_evals.keys()
        for key, loss in want_evals.items():
            np.testing.assert_allclose(evals[key], loss, rtol=1e-5, err_msg=str(key))


@pytest.mark.parametrize("loader", ["finetune", "finetune_dispatching"])
def test_finetune_main_at_two_ranks_matches_one_rank(setup, loader):
    want = setup["one"]["finetune"]
    for ranked in setup["two"]:
        got = ranked[loader]
        assert [s for s, _, _ in _curve(got)] == [1, 2, 3]
        np.testing.assert_allclose([l for _, l, _ in _curve(got)], [l for _, l, _ in _curve(want)], rtol=1e-5)
        np.testing.assert_allclose([n for _, _, n in _curve(got)], [n for _, _, n in _curve(want)], rtol=1e-5)
        assert got["val_losses"].keys() == want["val_losses"].keys()
        for step, loss in want["val_losses"].items():
            np.testing.assert_allclose(got["val_losses"][step], loss, rtol=1e-5)
