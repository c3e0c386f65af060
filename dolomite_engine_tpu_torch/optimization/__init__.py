"""Optimizers and LR schedules of the port (mirrors `dolomite_engine_tpu/optimization/`)."""

from .optimizer import TorchAdamW, get_optimizer
from .scheduler import get_scheduler, get_scheduler_factor
