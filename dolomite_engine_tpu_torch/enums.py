"""Run-level enums (the subset of `dolomite_engine_tpu/enums.py` the port uses, same values)."""

from enum import Enum


class Mode(Enum):
    training = "training"
    inference = "inference"
    unsharding = "unsharding"


class DatasetSplit(Enum):
    """dataset split"""

    train = "train"
    val = "val"
    test = "test"


class DatasetKeys(Enum):
    """standard keys in the dataset"""

    input = "input"
    output = "output"
    generated_text = "generated_text"
    num_generated_tokens = "num_generated_tokens"


class TuningMethod(Enum):
    pretraining = "pretraining"
    full_finetuning = "full_finetuning"
    prompt_tuning = "prompt_tuning"
    lora = "lora"


class LossMask(Enum):
    output_only = "output_only"
    no_mask = "no_mask"


class DistributedBackend(Enum):
    """The YAML's backend names; the port runs one process and accepts every name."""

    jax = "jax"
    torch = "torch"
    deepspeed = "deepspeed"


class FP8Backend(Enum):
    msamp = "msamp"
    nvte = "nvte"


class GradientCheckpointingMethod(Enum):
    """`block` = rematerialize every k-th transformer block."""

    block = "block"


class ExperimentsTrackerName(Enum):
    aim = "aim"
    wandb = "wandb"


class KernelBackend(Enum):
    """The YAML's per-family kernel choice. The port has no backend switch: the tensor's
    device decides, so it accepts only ``auto``."""

    xla = "xla"
    pallas = "pallas"
    auto = "auto"


# MoE compute-path names (configs also accept None and the reference spelling "scattermoe")
MOE_IMPLEMENTATIONS = ("scattermoe", "scatter", "eager", "auto")


class AttentionImplementation(Enum):
    """``eager``: explicit QK^T softmax V with an fp32 softmax; ``sdpa``: the same
    computation (the JAX package's XLA-fused path); ``flash_attention_2``: the causal /
    segment-id flash kernel on a CUDA device (packed, padding-free batches). ``ring`` and
    ``ulysses`` need a sequence-parallel mesh, which the port does not build yet, so they
    compute sdpa, as the JAX package does outside such a mesh."""

    eager = "eager"
    sdpa = "sdpa"
    flash_attention_2 = "flash_attention_2"
    ring = "ring"
    ulysses = "ulysses"


def normalize_moe_implementation(value: str) -> str:
    """Reference name "scattermoe" -> "scatter"."""
    return {"scattermoe": "scatter"}.get(value, value)


class ParamsGroupMethod(Enum):
    mup = "mup"


class LRDecaySchedule(Enum):
    constant = "constant"
    cosine = "cosine"
    exponential = "exponential"
    linear = "linear"
    power = "power"
