"""The port's YAML -> args path against the JAX package's, on the CPU.

Every training (and unsharding) YAML under `configs/` loads to the same dict through both
`load_yaml`s and to the same `to_dict()` through both `args_from_dict`s; an unknown key
is refused as pydantic's ``extra="forbid"`` refuses it; each option the port does not run
raises `NotImplementedError` naming its ROADMAP item (a pinned kernel family a
`ValueError`), and the options it does run pass (the training options, remat policies,
offload, health and fp8, also run `pretrain.main`, on the dense and the MoE family).
"""

import copy
from pathlib import Path

import pytest
import torch
from pydantic import ValidationError

from dolomite_engine_tpu.arguments import args_from_dict as jax_args_from_dict
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.utils import load_yaml as jax_load_yaml
from dolomite_engine_tpu_torch.arguments import TrainingArgs, args_from_dict, check_ported_options, get_args
from dolomite_engine_tpu_torch.enums import Mode
from dolomite_engine_tpu_torch.utils import load_yaml

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p for p in (REPO / "configs").rglob("*.yml") if "generat" not in p.name)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's spinning thread pool,
    oversubscribed, slows these small steps and the workers running beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: str(p.relative_to(REPO / "configs")))
def test_yaml_to_args_matches_jax(path):
    config = load_yaml(str(path))
    assert config == jax_load_yaml(str(path))
    mode = "unsharding" if "unshard" in path.name else "training"
    ours = args_from_dict(copy.deepcopy(config), Mode(mode))
    theirs = jax_args_from_dict(copy.deepcopy(config), JaxMode(mode))
    assert ours.to_dict() == theirs.to_dict()


def test_get_args_reads_the_config_flag(monkeypatch):
    path = REPO / "configs/pretraining-examples/pretrain-v5e-256-granite-3b.yml"
    monkeypatch.setattr("sys.argv", ["pretrain", "--config", str(path)])
    assert get_args(Mode.training).to_dict() == args_from_dict(load_yaml(str(path)), Mode.training).to_dict()


def _base() -> dict:
    return dict(
        model_args=dict(
            model_class="AutoModelForCausalLM",
            pretrained_config=dict(model_type="gpt_dolomite", vocab_size=64, n_embd=32, n_layer=1, n_head=4),
        ),
        tuning_args=dict(tuning_method="pretraining"),
        training_parameters=dict(num_training_steps=2, micro_batch_size=1, eval_interval=1),
        datasets=[dict(class_name="MegatronDataset", data_name="Megatron", class_args=dict(sequence_length=8))],
        save_args=dict(save_path="unused", save_interval=1),
        distributed_args=dict(stage=0),
    )


def _with(path: str, value) -> dict:
    config = _base()
    *parents, leaf = path.split(".")
    node = config
    for key in parents:
        node = node.setdefault(key, {})
    node[leaf] = value
    return config


def test_unknown_key_fails():
    with pytest.raises(ValidationError, match="extra"):
        TrainingArgs(**_with("training_parameters.no_such_key", 1))
    with pytest.raises(ValidationError, match="extra"):
        TrainingArgs(**dict(_base(), no_such_block={}))


def test_ported_options_pass():
    check_ported_options(TrainingArgs(**_base()))
    check_ported_options(
        TrainingArgs(
            **_with("distributed_args", dict(stage=0, gradient_checkpointing_method="block",
                                             gradient_checkpointing_args=dict(checkpoint_every=1, policy="full")))
        )
    )
    check_ported_options(TrainingArgs(**_with("model_args.scan_layers", True)))
    check_ported_options(TrainingArgs(**_with("kernel_args", dict(rmsnorm="auto", fused_ce="auto"))))


UNPORTED = [
    ("distributed_args", dict(stage=0, tensor_parallel_size=2), "'Distribution'"),
    ("distributed_args", dict(stage=0, tensor_parallel_size=2, sequence_parallel=True), "'Distribution'"),
    ("distributed_args", dict(stage=0, context_parallel_size=2), "'Distribution'"),
    ("distributed_args", dict(stage=0, expert_parallel_size=2), "'Distribution'"),
    ("distributed_args", dict(stage=0, tensor_parallel_size=2, tensor_parallel_word_embeddings=True), "'Distribution'"),
    ("model_args.model_name", "ibm-granite/granite-3b-code-base", "'Interop and tools'"),
    ("logging_args.telemetry", dict(on_demand_profiling=True), "'Serving fleet and observability'"),
    ("logging_args.telemetry", dict(program_signatures=True), "'Serving fleet and observability'"),
]


@pytest.mark.parametrize("path, value, item", UNPORTED, ids=[f"{p}={v}" for p, v, _ in UNPORTED])
def test_unported_option_raises_naming_its_item(path, value, item):
    config = _with(path, value)
    if path == "model_args.model_name":
        del config["model_args"]["pretrained_config"]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A, {item}"):
        check_ported_options(TrainingArgs(**config))


@pytest.mark.parametrize(
    "tracker, tracker_args", [("wandb", dict(wandb_args=dict(project="p", name="n"))), ("aim", dict(aim_args=dict(repo="r", experiment="e")))]
)
def test_missing_tracker_warns_and_turns_tracking_off(tracker, tracker_args, monkeypatch):
    """Naming aim or wandb where the package is not installed (neither is, where these
    tests run) is accepted by both packages' option checks, and both trackers warn and
    turn tracking off, as the JAX package does."""
    import importlib.util
    import logging

    from dolomite_engine_tpu.enums import ExperimentsTrackerName as JaxTrackerName
    from dolomite_engine_tpu.utils import packages as jax_packages
    from dolomite_engine_tpu.utils import tracking as jax_tracking
    from dolomite_engine_tpu_torch.enums import ExperimentsTrackerName
    from dolomite_engine_tpu_torch.utils import tracking

    real_find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == tracker else real_find_spec(name, *a))
    jax_packages._is_available.cache_clear()
    check_ported_options(TrainingArgs(**_with("logging_args", dict(experiments_tracker_name=tracker, **tracker_args))))
    try:
        for module, names in ((tracking, ExperimentsTrackerName), (jax_tracking, JaxTrackerName)):
            warnings = []
            monkeypatch.setattr(module, "log_rank_0", lambda level, message: warnings.append((level, message)))
            run = module.ExperimentsTracker(experiment_name="e", tracker_name=names(tracker))
            assert not run.enabled and run.run is None
            assert warnings == [(logging.WARNING, f"{tracker} is not installed, tracking disabled")]
            run.track({"loss": 1.0}, step=1, context="train")  # a no-op
            run.finish()
            assert run.state_dict() == {}
    finally:
        jax_packages._is_available.cache_clear()


# the training options, each once refused here: the ZeRO stages, data_parallel_size
# (held to the world of one), zero_topology and dispatching_dataloader since the
# data-parallel slice
TRAINING_OPTIONS = [
    ("distributed_args.stage", 3),
    ("distributed_args", dict(stage=1, data_parallel_size=1)),
    ("distributed_args", dict(stage=2, zero_topology=dict(data_parallel_replication_world_size=1, data_parallel_sharding_world_size=1))),
    ("distributed_args", dict(stage=0, dispatching_dataloader=True)),
    ("distributed_args", dict(stage=0, cpu_offload=True)),
    (
        "distributed_args",
        dict(stage=0, gradient_checkpointing_method="block", gradient_checkpointing_args=dict(policy="save_dots")),
    ),
    ("mixed_precision_args.dtype", "fp8"),
    ("logging_args.telemetry", dict(health=dict(interval=1))),
]


@pytest.mark.parametrize("path, value", TRAINING_OPTIONS, ids=[f"{p}={v}" for p, v in TRAINING_OPTIONS])
def test_training_option_parses_and_runs(tmp_path, path, value):
    """Each option parses, passes `check_ported_options` and runs 2 steps of
    `pretrain.main` on the CPU over a tiny megatron corpus."""
    _run_two_steps(tmp_path, _with(path, value))


MOE = dict(model_type="moe_dolomite", vocab_size=64, n_embd=32, n_layer=1, n_head=4, num_experts=4, num_experts_per_tok=2)
# the MoE family under each option, a raw remat policy and an optimizer outside the AdamW family
MOE_OPTIONS = TRAINING_OPTIONS + [
    (
        "distributed_args",
        dict(stage=0, gradient_checkpointing_method="block",
             gradient_checkpointing_args=dict(checkpoint_policy="dots_with_no_batch_dims_saveable")),
    ),
    ("optimizer_args", dict(class_name="ApexFusedLAMB")),
]


@pytest.mark.parametrize("path, value", MOE_OPTIONS, ids=[f"{p}={v}" for p, v in MOE_OPTIONS])
def test_training_option_runs_on_moe(tmp_path, path, value):
    config = _with(path, value)
    config["model_args"]["pretrained_config"] = dict(MOE)
    _run_two_steps(tmp_path, config)


def _run_two_steps(tmp_path, config):
    import numpy as np

    from dolomite_engine_tpu_torch import pretrain
    from dolomite_engine_tpu_torch.data.megatron import MMapIndexedDatasetBuilder

    rng = np.random.RandomState(0)
    prefix = str(tmp_path / "corpus")
    builder = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(100):
        builder.add_item(rng.randint(3, 64, size=rng.randint(10, 40)))
        builder.end_document()
    builder.finalize(prefix + ".idx")
    config["datasets"][0]["class_args"].update(
        data_path=[prefix], data_cache_path=str(tmp_path / "cache"), split="90,5,5", eval_steps=1
    )
    config["save_args"] = dict(save_path=str(tmp_path / "ckpt"), save_interval=2)
    args = TrainingArgs(**config)
    check_ported_options(args)
    summary = pretrain.main(args, device="cpu")
    losses = [s["loss"] for s in summary["steps"]]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_pinned_kernel_family_raises():
    with pytest.raises(ValueError, match="no backend switch"):
        check_ported_options(TrainingArgs(**_with("kernel_args", dict(fused_ce="pallas"))))
