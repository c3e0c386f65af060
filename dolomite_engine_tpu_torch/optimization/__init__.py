"""Optimizers and LR schedules of the port (mirrors `dolomite_engine_tpu/optimization/`)."""

from .optimizer import TorchAdamW, build_optimizer_from_args, get_optimizer
from .scheduler import get_scheduler, get_scheduler_factor
