"""Model wrappers of the port (mirrors `dolomite_engine_tpu/model_wrapper/`)."""

from .pretraining import ModelWrapperForPretraining
