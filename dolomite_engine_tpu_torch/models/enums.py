"""Model-library enums (copy of `dolomite_engine_tpu/models/enums.py`)."""

from enum import Enum


class InitMethod(Enum):
    normal = "normal"
    mup = "mup"


class PositionEmbeddingType(Enum):
    learned_absolute = "learned_absolute"
    alibi = "alibi"
    rope = "rope"
    nope = "nope"
    # T5-style learned bucketed relative attention bias (enc_dec_dolomite only; enables
    # weight-exact import of HF t5/flan-t5 checkpoints, hf_interop/conversion.py)
    relative_bucketed = "relative_bucketed"


class AttentionHeadType(Enum):
    mha = "mha"
    mqa = "mqa"
    gqa = "gqa"
