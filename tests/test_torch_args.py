"""The port's YAML -> args path against the JAX package's, on the CPU.

Every training (and unsharding) YAML under `configs/` loads to the same dict through both
`load_yaml`s and to the same `to_dict()` through both `args_from_dict`s; an unknown key
is refused as pydantic's ``extra="forbid"`` refuses it; each option the port does not run
raises `NotImplementedError` naming its ROADMAP item (a pinned kernel family a
`ValueError`), and the options it does run pass.
"""

import copy
from pathlib import Path

import pytest
from pydantic import ValidationError

from dolomite_engine_tpu.arguments import args_from_dict as jax_args_from_dict
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.utils import load_yaml as jax_load_yaml
from dolomite_engine_tpu_torch.arguments import TrainingArgs, args_from_dict, check_ported_options, get_args
from dolomite_engine_tpu_torch.enums import Mode
from dolomite_engine_tpu_torch.utils import load_yaml

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p for p in (REPO / "configs").rglob("*.yml") if "generat" not in p.name)


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
    ("distributed_args.stage", 3, "'Distribution'"),
    ("distributed_args", dict(stage=0, tensor_parallel_size=2), "'Distribution'"),
    ("distributed_args", dict(stage=0, tensor_parallel_size=2, sequence_parallel=True), "'Distribution'"),
    ("distributed_args", dict(stage=0, context_parallel_size=2), "'Distribution'"),
    ("distributed_args", dict(stage=0, expert_parallel_size=2), "'Distribution'"),
    ("distributed_args", dict(stage=0, data_parallel_size=2), "'Distribution'"),
    ("distributed_args", dict(stage=0, dispatching_dataloader=True), "'Distribution'"),
    ("distributed_args", dict(stage=0, cpu_offload=True), "'CPU offload'"),
    (
        "distributed_args",
        dict(stage=0, gradient_checkpointing_method="block", gradient_checkpointing_args=dict(policy="save_dots")),
        "'Remat policies'",
    ),
    ("mixed_precision_args.dtype", "fp8", "'fp8 training'"),
    ("model_args.model_name", "ibm-granite/granite-3b-code-base", "'Interop and tools'"),
    ("logging_args", dict(experiments_tracker_name="wandb", wandb_args=dict(project="p", name="n")), "'Serving fleet and observability'"),
    ("logging_args", dict(experiments_tracker_name="aim", aim_args=dict(repo="r", experiment="e")), "'Serving fleet and observability'"),
    ("logging_args.telemetry", dict(on_demand_profiling=True), "'Serving fleet and observability'"),
    ("logging_args.telemetry", dict(program_signatures=True), "'Serving fleet and observability'"),
    ("logging_args.telemetry", dict(health=dict(interval=5)), "'Training health metrics'"),
]


@pytest.mark.parametrize("path, value, item", UNPORTED, ids=[f"{p}={v}" for p, v, _ in UNPORTED])
def test_unported_option_raises_naming_its_item(path, value, item):
    config = _with(path, value)
    if path == "model_args.model_name":
        del config["model_args"]["pretrained_config"]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A, {item}"):
        check_ported_options(TrainingArgs(**config))


def test_pinned_kernel_family_raises():
    with pytest.raises(ValueError, match="no backend switch"):
        check_ported_options(TrainingArgs(**_with("kernel_args", dict(fused_ce="pallas"))))
