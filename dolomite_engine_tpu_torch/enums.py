"""Run-level enums (the subset of `dolomite_engine_tpu/enums.py` the port uses, same values)."""

from enum import Enum


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
