"""Dataset format markers (a copy of `dolomite_engine_tpu/defaults.py`)."""

INPUT_FORMAT = "__input__"
OUTPUT_FORMAT = "__output__"
