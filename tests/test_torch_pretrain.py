"""The port's pretraining entry point against the JAX package's, on the CPU.

- **Loss parity**: the `tools/loss_parity.py` protocol (its seeded megatron corpus, the
  initial weights of `create_sharded_train_state(..., PRNGKey(1234))` carried over with
  `load_jax_params`, fp32, batch 8 x 64, AdamW at a constant 3e-4, clip 1.0): 200 steps
  through the port's `pretrain.train` over the port's loaders, dense and MoE, against the
  committed `LOSS_PARITY*.json` ``tpu_losses``, under the JAX test's 1 % bar; the port's
  batch stream equals the tool's `build_batches`.
- **The end-to-end path** (`tests/test_e2e_pretrain.py` on the port, ``device="cpu"``):
  the `latest` pointer and ``consumed_samples`` (12 after 3 steps of 2 x 2 on one
  device); a resumed run's losses and grad norms bit-identical to an unbroken run's;
  async checkpointing; ``keep_last_n``; ``resume_learning_rate: false`` (the schedule's
  counter alone restarts); ``save_optimizer: false``; a preemption notice's
  save-and-exit; the stall watchdog's abort with its flight record.
- **Carry-over**: JAX trains 3 steps, `load_jax_train_state` hands the state over, the
  port trains 3 more; against 6 JAX steps (bf16 first moment, a warm-up schedule).
- **Telemetry**: the sink's step, window and run_end records have the JAX package's keys.
"""

import importlib.util
import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp
from flax import linen as nn

from dolomite_engine_tpu.enums import LRDecaySchedule as JaxSchedule
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.model_wrapper.pretraining import ModelWrapperForPretraining as JaxWrapper
from dolomite_engine_tpu.optimization import get_optimizer as jax_get_optimizer
from dolomite_engine_tpu.optimization import get_scheduler as jax_get_scheduler
from dolomite_engine_tpu.train_utils import TrainState as JaxTrainState
from dolomite_engine_tpu.train_utils import make_train_step as jax_make_train_step
from dolomite_engine_tpu.utils.telemetry import Telemetry as JaxTelemetry
from dolomite_engine_tpu_torch import checkpointing, pretrain
from dolomite_engine_tpu_torch.arguments import TrainingArgs
from dolomite_engine_tpu_torch.data.megatron import MMapIndexedDatasetBuilder, get_megatron_gpt_dataloaders
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining, get_model
from dolomite_engine_tpu_torch.models import load_jax_params, load_jax_train_state
from dolomite_engine_tpu_torch.optimization import build_optimizer_from_args, get_optimizer, get_scheduler
from dolomite_engine_tpu_torch.train_utils import TrainState, make_train_step
from dolomite_engine_tpu_torch.utils import request_preemption

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run hundreds of small steps, and under the suite's
    parallel workers torch's spinning thread pool, oversubscribed, runs them many times
    slower than one thread does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loss_parity_tool():
    spec = importlib.util.spec_from_file_location("loss_parity", REPO / "tools" / "loss_parity.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------------------------ loss parity


@pytest.mark.parametrize("family", ["gpt_dolomite", "moe_dolomite"])
def test_loss_parity_200_steps(tmp_path, family):
    from dolomite_engine_tpu.distributed import create_sharded_train_state
    from dolomite_engine_tpu.parallel.mesh import MeshManager

    tool = _loss_parity_tool()
    config = tool._FAMILY_CONFIGS[family]
    tool.CONFIG = config  # the tool's corpus reads CONFIG's vocab and eos
    artifact = json.loads((REPO / ("LOSS_PARITY.json" if family == "gpt_dolomite" else f"LOSS_PARITY_{family}.json")).read_text())
    steps = artifact["steps"]
    assert steps == 200 and artifact["config"] == config
    reference_batches = tool.build_batches(steps, str(tmp_path))

    # the protocol's initial weights: create_sharded_train_state on one device, PRNGKey(1234)
    MeshManager.destroy()
    MeshManager(devices=jax.devices()[:1])
    try:
        jax_wrapper = JaxWrapper(
            mode=JaxMode.training, pretrained_config=config, dtype="fp32", sequence_length=tool.SEQ,
            reset_attention_mask=False, zero_stage=0,
        )
        schedule = jax_get_scheduler(0, 0, None, steps + 1, JaxSchedule.constant, 0.0, base_lr=tool.LR)
        jax_state, _ = create_sharded_train_state(
            jax_wrapper, jax_get_optimizer("TorchAdamW", dict(tool.ADAM), schedule), MeshManager.get_mesh(),
            jax.random.PRNGKey(1234),
        )
        params = jax.tree.map(np.asarray, jax_state.params)
    finally:
        MeshManager.destroy()

    args = TrainingArgs(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=config),
        tuning_args=dict(tuning_method="pretraining"),
        training_parameters=dict(
            num_training_steps=steps, micro_batch_size=tool.MICRO_BS, gradient_accumulation_steps=1,
            eval_during_training=False, gradient_clipping=tool.CLIP, prefetch_depth=2,
        ),
        datasets=[dict(class_name="MegatronDataset", data_name="Megatron", class_args=dict(
            data_path=[str(tmp_path / "corpus")], split="100,0,0", sequence_length=tool.SEQ, seed=1234,
            data_cache_path=str(tmp_path / "port-cache"),
        ))],
        optimizer_args=dict(class_name="TorchAdamW", class_args=dict(lr=tool.LR, **tool.ADAM)),
        lr_scheduler_args=dict(lr_decay_style="constant", num_warmup_steps=0),
        save_args=dict(save_path=str(tmp_path / "ckpt"), save_interval=steps),
        distributed_args=dict(stage=0),
        random_args=dict(seed=1234),
        logging_args=dict(log_interval=50),
    )
    model = get_model(args, device="cpu")
    load_jax_params(model.model, params, device="cpu")
    optimizer, lr_schedule = build_optimizer_from_args(args, model)
    train_loader, val_loaders, test_loaders = get_megatron_gpt_dataloaders(args, None, 0)
    seen = []

    def recording(loader):
        for micro in loader:
            seen.append(micro["text"].numpy().copy())
            yield micro

    summary = pretrain.train(
        args, model, TrainState(model.model, optimizer), lr_schedule, recording(train_loader), val_loaders,
        test_loaders, None,
    )
    np.testing.assert_array_equal(np.stack(seen[:steps]), reference_batches)
    losses = np.array([s["loss"] for s in summary["steps"]])
    want = np.array(artifact["tpu_losses"])
    gap = np.abs(losses - want) / np.abs(want)
    print(f"{family}: max relative gap to tpu_losses {gap.max():.3e}, final {gap[-1]:.3e}")
    assert gap.max() < 0.01, gap.max()  # the 1 % bar of tests/test_loss_parity.py


# ------------------------------------------------------------------------------ end to end


def _write_corpus(tmp_path, num_docs=200, vocab=128, seed=0) -> str:
    rng = np.random.RandomState(seed)
    prefix = str(tmp_path / "corpus")
    builder = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(num_docs):
        builder.add_item(rng.randint(0, vocab, size=rng.randint(10, 80)))
        builder.end_document()
    builder.finalize(prefix + ".idx")
    return prefix


def _training_args(tmp_path, prefix, num_steps=3, load_args=None, save_path="ckpt", **overrides) -> TrainingArgs:
    config = dict(
        model_args=dict(
            model_class="AutoModelForCausalLM",
            pretrained_config=dict(
                model_type="gpt_dolomite", vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4,
                attention_head_type="mha", position_embedding_type="rope", activation_function="swiglu",
                normalization_function="rmsnorm", add_bias=False, resid_pdrop=0.1, embd_pdrop=0.0,
                attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=2,
            ),
        ),
        tuning_args=dict(tuning_method="pretraining"),
        training_parameters=dict(
            num_training_steps=num_steps, micro_batch_size=2, gradient_accumulation_steps=2,
            eval_during_training=True, eval_interval=2,
        ),
        datasets=[dict(class_name="MegatronDataset", data_name="Megatron", class_args=dict(
            eval_steps=1, data_cache_path=str(tmp_path / "cache"), data_path=[prefix], split="90,5,5",
            sequence_length=32,
        ))],
        optimizer_args=dict(class_args=dict(lr=1e-3, mu_dtype="bf16")),
        save_args=dict(save_path=str(tmp_path / save_path), save_interval=2),
        distributed_args=dict(stage=0),
        logging_args=dict(log_interval=1),
        random_args=dict(seed=7),
        fault_tolerance_args=dict(skip_nonfinite_steps=True),
    )
    for key, value in overrides.items():
        config[key] = dict(config.get(key, {}), **value)
    if load_args is not None:
        config["load_args"] = load_args
    return TrainingArgs(**config)


def _latest(path: Path) -> int:
    return json.loads((path / "latest_checkpointed_iteration.json").read_text())["latest_checkpointed_iteration"]


def _metadata(path: Path, step: int) -> dict:
    return json.loads((path / f"global_step{step}" / "metadata.json").read_text())


def _curve(summary):
    return [(s["step"], s["loss"], s["grad_norm"]) for s in summary["steps"]]


def test_save_resume_is_bit_identical(tmp_path):
    """Dropout on (resid_pdrop 0.1): the resumed run draws the same masks too."""
    prefix = _write_corpus(tmp_path)
    ckpt = tmp_path / "ckpt"
    first = pretrain.main(_training_args(tmp_path, prefix, num_steps=3), device="cpu")
    assert _latest(ckpt) == 3
    assert _metadata(ckpt, 3)["consumed_samples"] == 12  # 3 steps x micro 2 x accum 2 x 1 device
    layout = {p.name for p in (ckpt / "global_step3").iterdir()}
    assert layout == {"state", "rng_state-0.json", "metadata.json", "training_config.yml", "experiments_tracker.json"}

    resumed = pretrain.main(_training_args(tmp_path, prefix, num_steps=5, load_args=dict(load_path=str(ckpt))), device="cpu")
    assert _latest(ckpt) == 5 and _metadata(ckpt, 5)["consumed_samples"] == 20

    unbroken = pretrain.main(_training_args(tmp_path, prefix, num_steps=5, save_path="ckpt-unbroken"), device="cpu")
    assert _curve(first) == _curve(unbroken)[:3]
    assert _curve(resumed) == _curve(unbroken)[3:]  # bit for bit
    # (val loaders restart at their first batch on a resume, as the JAX package's do)
    assert resumed["test_loss"] == unbroken["test_loss"]


def test_async_checkpointing_commits_and_resumes(tmp_path):
    prefix = _write_corpus(tmp_path)
    ckpt = tmp_path / "ckpt"
    pretrain.main(_training_args(tmp_path, prefix, save_args=dict(async_checkpointing=True)), device="cpu")
    assert checkpointing._PENDING is None  # train() committed the in-flight save
    assert _latest(ckpt) == 3
    args = _training_args(
        tmp_path, prefix, num_steps=4, load_args=dict(load_path=str(ckpt)), save_args=dict(async_checkpointing=True)
    )
    pretrain.main(args, device="cpu")
    assert _latest(ckpt) == 4 and _metadata(ckpt, 4)["consumed_samples"] == 16


def test_keep_last_n_prunes_at_commit(tmp_path):
    prefix = _write_corpus(tmp_path)
    args = _training_args(tmp_path, prefix, num_steps=4, save_args=dict(save_interval=1, keep_last_n=2))
    pretrain.main(args, device="cpu")
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("global_step*")) == ["global_step3", "global_step4"]


def _fresh_state(args):
    model = get_model(args, device="cpu")
    optimizer, _ = build_optimizer_from_args(args, model)
    return TrainState(model.model, optimizer)


def test_resume_without_the_learning_rate_restarts_only_the_schedule(tmp_path):
    prefix = _write_corpus(tmp_path)
    ckpt = tmp_path / "ckpt"
    pretrain.main(_training_args(tmp_path, prefix), device="cpu")
    saved = _fresh_state(_training_args(tmp_path, prefix, load_args=dict(load_path=str(ckpt))))
    checkpointing.load_checkpoint_for_training(_training_args(tmp_path, prefix, load_args=dict(load_path=str(ckpt))), saved)
    assert (saved.step, saved.optimizer.count, saved.optimizer.schedule_count) == (3, 3, 3)

    args = _training_args(
        tmp_path, prefix,
        load_args=dict(load_path=str(ckpt), load_lr_scheduler=False, resume_learning_rate=False),
    )
    state = _fresh_state(args)
    _, start, metadata, generator = checkpointing.load_checkpoint_for_training(args, state)
    assert (start, metadata["consumed_samples"], state.step) == (3, 12, 3)
    assert (state.optimizer.count, state.optimizer.schedule_count) == (3, 0)
    assert generator is not None
    for got, want in zip([*state.optimizer.mu, *state.optimizer.nu], [*saved.optimizer.mu, *saved.optimizer.nu]):
        assert torch.equal(got, want) and got.abs().sum() > 0
    assert state.optimizer.mu[0].dtype == torch.bfloat16


def test_save_optimizer_false(tmp_path):
    prefix = _write_corpus(tmp_path)
    ckpt = tmp_path / "ckpt"
    pretrain.main(_training_args(tmp_path, prefix, save_args=dict(save_optimizer=False)), device="cpu")
    keys = checkpointing._state_metadata(str(ckpt / "global_step3" / "state"))
    assert not any(key.startswith("optimizer.") for key in keys) and "model.transformer.wte.weight" in keys

    args = _training_args(tmp_path, prefix, load_args=dict(load_path=str(ckpt)))
    with pytest.raises(ValueError, match="save_optimizer=False"):
        checkpointing.load_checkpoint_for_training(args, _fresh_state(args))
    args = _training_args(
        tmp_path, prefix, load_args=dict(load_path=str(ckpt), load_optimizer=False, load_lr_scheduler=False)
    )
    state = _fresh_state(args)
    checkpointing.load_checkpoint_for_training(args, state)
    tree = {"model": {k: torch.empty_like(v) for k, v in state.model.state_dict().items()}}
    dcp.load(tree, checkpoint_id=str(ckpt / "global_step3" / "state"), no_dist=True)  # the saved params
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, tree["model"][name])
    assert state.optimizer.count == 0 and all(m.abs().sum() == 0 for m in state.optimizer.mu)


def test_preemption_saves_and_exits(tmp_path):
    prefix = _write_corpus(tmp_path)
    ckpt = tmp_path / "ckpt"
    request_preemption()  # a notice arriving during step 1
    summary = pretrain.main(_training_args(tmp_path, prefix, num_steps=5), device="cpu")
    assert summary["preempted"] and [s["step"] for s in summary["steps"]] == [1]
    assert _latest(ckpt) == 1 and _metadata(ckpt, 1)["consumed_samples"] == 4
    assert summary["test_loss"] is None  # the grace window is for saving
    records = [json.loads(line) for line in (ckpt / "telemetry" / "rank-00000.jsonl").read_text().splitlines()]
    assert records[-1]["kind"] == "run_end" and records[-1]["status"] == "preempted"


def test_stall_watchdog_aborts_with_a_flight_record(tmp_path, monkeypatch):
    prefix = _write_corpus(tmp_path)
    release = threading.Event()

    def wedged(args, tokenizer, consumed):
        train, val, test = get_megatron_gpt_dataloaders(args, tokenizer, consumed)

        def stream():
            for _ in range(4):  # two steps of accumulation 2, then the storage hangs
                yield next(train)
            release.wait(30)

        return stream(), val, test

    monkeypatch.setattr(pretrain, "get_megatron_gpt_dataloaders", wedged)
    args = _training_args(tmp_path, prefix, num_steps=5, fault_tolerance_args=dict(dataloader_stall_timeout_seconds=1.0))
    try:
        with pytest.raises(RuntimeError, match="stalled"):
            pretrain.main(args, device="cpu")
    finally:
        release.set()
    record = json.loads((tmp_path / "ckpt" / "telemetry" / "flight-record-rank-00000.json").read_text())
    assert record["reason"] == "loader_stall" and [r["step"] for r in record["records"]] == [1, 2]


# ------------------------------------------------------------------------------ carry-over

CARRY_CONFIG = dict(
    model_type="gpt_dolomite", vocab_size=512, n_positions=64, n_embd=128, n_layer=2, n_head=4,
    attention_head_type="gqa", num_key_value_heads=2, position_embedding_type="rope",
    activation_function="swiglu", normalization_function="rmsnorm", add_bias=False, resid_pdrop=0.0,
    embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=2, tie_word_embeddings=True,
)
CARRY_ADAM = dict(betas=(0.9, 0.95), eps=1e-10, weight_decay=0.1, mu_dtype="bf16")


def test_jax_run_continues_in_the_port():
    """6 JAX steps against 3 JAX steps + 3 port steps from the handed-over state: losses
    within 1e-5 relative (the fp32 step's reassociation, as `test_torch_train.py`),
    counters and the bf16 first moment carried exactly. The final parameters: a last-bit
    difference in the fp32 gradient can round an element's bf16 first moment one ulp
    (2^-8 relative) the other way, which moves its update by up to lr x 2^-8 (|m / sqrt(v)|
    <= 1); so within 3 x lr x 2^-8 over the port's 3 steps."""
    seq, batch, steps = 32, 4, 6
    rs = np.random.RandomState(3)
    batches = rs.randint(3, 512, (steps, 1, batch, seq + 1))
    jax_wrapper = JaxWrapper(mode=JaxMode.training, pretrained_config=CARRY_CONFIG, dtype="fp32", sequence_length=seq, zero_stage=0)
    params = nn.unbox(jax_wrapper.model.init(jax.random.PRNGKey(0), **jax_wrapper.get_dummy_inputs())["params"])
    tx = jax_get_optimizer("TorchAdamW", dict(CARRY_ADAM), jax_get_scheduler(2, 0, None, steps, JaxSchedule.cosine, 0.1, base_lr=3e-3))
    jax_step = jax.jit(jax_make_train_step(lambda p, micro, rng: jax_wrapper.loss(p, micro["text"], train=True), tx, gradient_clipping=1.0))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params))
    want, handed_over = [], None
    for t in range(steps):
        if t == 3:
            handed_over = jax.tree.map(np.asarray, state)
        state, metrics = jax_step(state, {"text": jnp.asarray(batches[t])}, jax.random.PRNGKey(t))
        want.append(float(metrics["loss"]))

    port = ModelWrapperForPretraining(CARRY_CONFIG, dtype="fp32", device="cpu")
    optimizer = get_optimizer(
        "TorchAdamW", dict(CARRY_ADAM), get_scheduler(2, 0, None, steps, "cosine", 0.1, base_lr=3e-3),
        port.model.named_parameters(),
    )
    train_state = TrainState(port.model, optimizer)
    load_jax_train_state(train_state, handed_over)
    assert (train_state.step, optimizer.count, optimizer.schedule_count) == (3, 3, 3)
    jax_mu = handed_over.opt_state[0].mu["transformer"]["wte"]["embedding"]
    assert torch.equal(optimizer.mu[0], torch.from_numpy(np.asarray(jax_mu, np.float32)).bfloat16())
    step = make_train_step(lambda micro: port.loss(micro["text"]), optimizer, gradient_clipping=1.0)
    got = [step(train_state, {"text": torch.from_numpy(batches[t])})["loss"] for t in range(3, steps)]
    np.testing.assert_allclose(got, want[3:], rtol=1e-5)
    atol = 3 * 3e-3 * 2**-8
    wte = np.asarray(state.params["transformer"]["wte"]["embedding"])
    np.testing.assert_allclose(port.model.transformer.wte.weight.detach().numpy(), wte, rtol=0, atol=atol)
    c_fc = np.asarray(state.params["transformer"]["h_1"]["mlp"]["c_fc"]["kernel"]).T
    np.testing.assert_allclose(port.model.transformer.h[1].mlp.c_fc.weight.detach().numpy(), c_fc, rtol=0, atol=atol)


# ------------------------------------------------------------------------------ telemetry


def _records(path: Path) -> dict[str, dict]:
    records = {}
    for line in path.read_text().splitlines():
        record = json.loads(line)
        records[record["kind"]] = record  # the last of each kind
    return records


def test_telemetry_records_have_the_jax_keys(tmp_path):
    prefix = _write_corpus(tmp_path)
    pretrain.main(_training_args(tmp_path, prefix), device="cpu")
    ours = _records(tmp_path / "ckpt" / "telemetry" / "rank-00000.jsonl")

    reference = JaxTelemetry(sink_path=str(tmp_path / "jax.jsonl"), model_tflops_per_step=1.0)
    reference.record_step(1, 0.1, 0.5)
    reference.record_step(2, 0.1, 0.5)
    with reference.timer("checkpoint"):
        pass
    reference.emit_window(2)
    reference.close("ok")
    theirs = _records(tmp_path / "jax.jsonl")

    for kind in ("step", "window", "run_end"):
        assert set(ours[kind]) == set(theirs[kind]), kind
    assert set(ours["window"]["goodput"]) == set(theirs["window"]["goodput"])
    assert set(ours["window"]["step_time"]) == set(theirs["window"]["step_time"])
    assert set(ours["window"]["counters"]) >= set(theirs["window"]["counters"])
    assert set(ours["run_start"]) - {"torch_version", "cuda_version"} == set(theirs["run_start"]) - {"jax_version", "jaxlib_version"}
    assert ours["window"]["mfu_pct"] is None  # no peak for a CPU: MFU is left out, not made up
    assert {"param_groups", "totals", "hbm"} <= set(ours["model_report"])
