"""HF interop of the port (mirrors `dolomite_engine_tpu/hf_interop/`)."""

from .conversion import export_to_huggingface, import_from_huggingface
from .weights import interleave_qkv, params_to_state_dict, split_qkv, state_dict_to_params
