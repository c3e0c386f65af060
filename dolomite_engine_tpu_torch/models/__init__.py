"""Models of the port (mirrors `dolomite_engine_tpu/models/`)."""

from .config import CommonConfig
from .gpt_dolomite import CausalLMOutput, GPTDolomiteForCausalLM, GPTDolomiteModel, load_jax_params
