"""Process-0 logging utilities (counterpart of `dolomite_engine_tpu/utils/logger.py`).

The rank is `torch.distributed`'s when a process group is initialized, else 0.
"""

import logging

import torch.distributed as dist

_LOGGER_NAME = "dolomite_engine_tpu_torch"


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def set_logger(level: int = logging.INFO, colored_log: bool = False) -> None:
    handler = logging.StreamHandler()
    fmt = "%(asctime)s - [%(levelname)s]: %(message)s"
    if colored_log:
        try:
            import colorlog

            handler.setFormatter(colorlog.ColoredFormatter("%(log_color)s" + fmt))
        except ImportError:
            handler.setFormatter(logging.Formatter(fmt))
    else:
        handler.setFormatter(logging.Formatter(fmt))

    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(level)
    logger.handlers.clear()
    logger.addHandler(handler)
    logger.propagate = False


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def log_rank_0(level: int, msg: str) -> None:
    if process_index() == 0:
        get_logger().log(level, msg)


def run_rank_n(func, rank: int = 0):
    """Decorator: run `func` only on process `rank` (others return None)."""

    def wrapper(*args, **kwargs):
        return func(*args, **kwargs) if process_index() == rank else None

    return wrapper
