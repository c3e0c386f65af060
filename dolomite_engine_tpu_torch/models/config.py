"""Model configuration (copy of `dolomite_engine_tpu/models/config.py`'s `CommonConfig`).

Framework-neutral: the same field names, defaults and validation — including
`head_dim`, `num_key_value_heads` and the mha/mqa/gqa head-type rules — so a config
built for the JAX package builds the same model here. `MoEConfig` adds the MoE knobs, and
each other family's config its own (`GPTCrossLayerConfig`, `DenseMoEConfig`,
`EncDecDolomiteConfig`, `RNNDolomiteConfig`), with the JAX package's checks and errors.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

from .enums import AttentionHeadType, InitMethod, PositionEmbeddingType


@dataclass
class CommonConfig:
    model_type: str = "gpt_dolomite"

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    num_key_value_heads: int | None = None
    n_inner: int | None = None
    activation_function: str = "gelu_pytorch_tanh"
    attention_head_type: str = "mqa"
    resid_pdrop: float = 0.1
    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    normalization_function: str = "layernorm"
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    scale_attn_weights: bool = True
    attention_multiplier: float | None = None
    use_cache: bool = True
    bos_token_id: int = 50256
    eos_token_id: int = 50256
    pad_token_id: int = 50256
    attention_softmax_in_fp32: bool = True
    add_bias: bool = True
    position_embedding_type: str = "learned_absolute"
    rope_theta: float = 10000
    rope_scaling: dict | None = None
    m_emb: float | None = None
    m_width: float | None = None
    m_residual: float | None = None
    init_method: str = "normal"
    upcast_logits_for_loss: bool = False
    tie_word_embeddings: bool = True
    # compute the LM-head loss chunked along the sequence axis without materializing
    # [B, S, V] logits. Training-only; requires tie_word_embeddings.
    fused_lm_head_loss: bool = False
    loss_chunk_size: int = 256
    # PaLM-style z-loss: coef * mean(logsumexp(logits)^2) added to the LM loss, keeping
    # the softmax normalizer near 1 (stabilizes bf16 pretraining). 0 disables. Computed
    # identically by the plain and the chunked fused loss paths.
    z_loss_coef: float = 0.0
    # per-head width when it differs from n_embd // n_head (HF T5's d_kv: flan-t5-small is
    # 512 wide with 6 heads of 64); None derives it from n_embd
    attention_head_dim: int | None = None

    def __post_init__(self) -> None:
        if self.n_inner is None:
            self.n_inner = 4 * self.n_embd

        if self.fused_lm_head_loss and not self.tie_word_embeddings:
            raise ValueError(
                "fused_lm_head_loss requires tie_word_embeddings (the chunked loss reads the "
                "tied embedding table; an untied lm_head would silently fall back to "
                "materializing full logits)"
            )

        if self.attention_multiplier is not None:
            assert self.scale_attn_weights

        # validate enums
        InitMethod(self.init_method)
        pe_type = PositionEmbeddingType(self.position_embedding_type)
        if pe_type not in self.supported_position_embeddings():
            # an unsupported type would build a model with NO position information and
            # train silently position-blind — fail at config time instead
            raise ValueError(
                f"{type(self).__name__} does not support position_embedding_type="
                f"'{self.position_embedding_type}' (supported: "
                f"{sorted(t.value for t in self.supported_position_embeddings())})"
            )
        head_type = AttentionHeadType(self.attention_head_type)

        if head_type == AttentionHeadType.mha:
            if self.num_key_value_heads is None:
                self.num_key_value_heads = self.n_head
            assert self.n_head == self.num_key_value_heads, (
                "MultiHeadAttention should have same number of heads for query, keys and values"
            )
        elif head_type == AttentionHeadType.mqa:
            if self.num_key_value_heads is None:
                self.num_key_value_heads = 1
            assert self.num_key_value_heads == 1, (
                "MultiQueryAttention should have 1 head for keys and values"
            )
        elif head_type == AttentionHeadType.gqa:
            assert self.num_key_value_heads is not None, (
                "`num_key_value_heads` needs to be specified with GroupedQueryAttention"
            )
            assert self.n_head % self.num_key_value_heads == 0, (
                "GroupedQueryAttention needs n_head divisible by num_key_value_heads"
            )

    @classmethod
    def supported_position_embeddings(cls) -> frozenset[PositionEmbeddingType]:
        """Types this family actually builds; relative_bucketed is enc_dec-only."""
        return frozenset(
            {
                PositionEmbeddingType.learned_absolute,
                PositionEmbeddingType.alibi,
                PositionEmbeddingType.rope,
                PositionEmbeddingType.nope,
            }
        )

    # HF attribute_map aliases
    @property
    def hidden_size(self) -> int:
        return self.n_embd

    @property
    def max_position_embeddings(self) -> int:
        return self.n_positions

    @property
    def num_attention_heads(self) -> int:
        return self.n_head

    @property
    def num_hidden_layers(self) -> int:
        return self.n_layer

    @property
    def head_dim(self) -> int:
        if self.attention_head_dim is not None:
            return self.attention_head_dim
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head

    # ------------------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CommonConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save_pretrained(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, "config.json"), "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def from_pretrained(cls, path: str) -> "CommonConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_dict(json.load(f))


@dataclass
class MoEConfig(CommonConfig):
    """The MoE knobs of `dolomite_engine_tpu/models/config.py`'s `MoEConfig`."""

    model_type: str = "moe_dolomite"
    num_experts: int = 8
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.01


@dataclass
class GPTCrossLayerConfig(CommonConfig):
    """Cross-layer KV sharing (`dolomite_engine_tpu/models/config.py`'s
    `GPTCrossLayerConfig`): ``sharing_pattern[i]`` is the layer whose K/V layer i attends
    with (default: each its own), consecutive equal entries form one KV group, and every
    parent references itself. The head type is forced to ``gqa``. `joint_residual_stream`
    adds a group's input to every sub-layer's residual after attention."""

    model_type: str = "gpt_crosslayer"
    sharing_pattern: list[int] | None = None
    joint_residual_stream: bool = False

    def __post_init__(self) -> None:
        self.attention_head_type = "gqa"
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.n_head
        super().__post_init__()
        if self.sharing_pattern is None:
            self.sharing_pattern = list(range(self.n_layer))
        assert len(self.sharing_pattern) == self.n_layer
        assert all(
            self.sharing_pattern[i] == i for i in set(self.sharing_pattern)
        ), "a filled sharing pattern doesn't have a parent layer"
        assert all(
            self.sharing_pattern[i] <= self.sharing_pattern[i + 1]
            for i in range(len(self.sharing_pattern) - 1)
        )
        assert all(0 <= p < self.n_layer for p in self.sharing_pattern)


@dataclass
class DenseMoEConfig(CommonConfig):
    """Dense training, sparse inference (`dolomite_engine_tpu/models/config.py`'s
    `DenseMoEConfig`): one KV head an expert (``num_key_value_heads = num_experts``), the
    head type ``mha`` when the experts equal the heads, else ``gqa``."""

    model_type: str = "dense_moe"
    num_experts: int = 8

    def __post_init__(self) -> None:
        assert self.n_head % self.num_experts == 0, (
            "number of attention heads must be divisible by the number of experts"
        )
        self.num_key_value_heads = self.num_experts
        self.attention_head_type = "mha" if self.num_experts == self.n_head else "gqa"
        super().__post_init__()


@dataclass
class EncDecDolomiteConfig(CommonConfig):
    """The encoder-decoder family's knobs (`dolomite_engine_tpu/models/config.py`'s
    `EncDecDolomiteConfig`): `n_layer` counts decoder blocks and `n_encoder_layer` (default
    the same) encoder blocks; `decoder_start_token_id` (default the BOS, else the pad token,
    else 0) seeds the shifted-right decoder input; `init_residual_branches` is set per stack
    for the depth-scaled init (2 a block in the encoder, 3 in the decoder); the two
    ``relative_attention_*`` fields size T5's bucketed relative bias
    (``position_embedding_type="relative_bucketed"``)."""

    model_type: str = "enc_dec_dolomite"
    position_embedding_type: str = "rope"
    n_encoder_layer: int | None = None
    decoder_start_token_id: int | None = None
    init_residual_branches: int | None = None
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128

    @classmethod
    def supported_position_embeddings(cls) -> frozenset[PositionEmbeddingType]:
        return frozenset({PositionEmbeddingType.rope, PositionEmbeddingType.relative_bucketed})

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.n_encoder_layer is None:
            self.n_encoder_layer = self.n_layer
        if self.decoder_start_token_id is None:
            self.decoder_start_token_id = next(
                (t for t in (self.bos_token_id, self.pad_token_id) if t is not None), 0
            )


@dataclass
class RNNDolomiteConfig(CommonConfig):
    """The DeltaNet / attention hybrid (`dolomite_engine_tpu/models/config.py`'s
    `RNNDolomiteConfig`): `attention_pattern` is a string over ``d`` (DeltaNet) and ``a``
    (softmax attention), one letter a layer, default all ``d``."""

    model_type: str = "rnn_dolomite"
    attention_pattern: str | None = None

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.attention_pattern is None:
            self.attention_pattern = "d" * self.n_layer
        assert len(self.attention_pattern) == self.n_layer
        assert set(self.attention_pattern) <= {"a", "d"}
