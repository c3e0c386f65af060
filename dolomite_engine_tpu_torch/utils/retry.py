"""Bounded exponential-backoff retry for checkpoint I/O (a copy of
`dolomite_engine_tpu/utils/retry.py`).

Long pretraining runs checkpoint to network filesystems (GCS fuse mounts, NFS) whose
transient errors — stale handles, 5xx-backed EIO, momentary unmounts — would otherwise kill
a run that has hours of un-checkpointed progress in flight. Every durable-path operation in
`checkpointing.py` (the state write and read, the `latest` pointer read/write, metadata probes)
goes through :func:`retry_io`; the attempt/backoff knobs ride
`FaultToleranceArgs.checkpoint_io_*` (arguments.py).

Deliberately NOT retried: programming errors (TypeError/ValueError from mismatched trees),
KeyboardInterrupt, and anything outside `retry_on` — retrying those only delays the real
traceback.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, TypeVar

from .logger import log_rank_0
from .telemetry import get_telemetry

T = TypeVar("T")

# OSError covers IOError/FileNotFoundError/fuse EIO; TimeoutError is raised by some
# object-store clients on slow reads. ConnectionError is an OSError subclass already.
TRANSIENT_IO_ERRORS: tuple[type[BaseException], ...] = (OSError, TimeoutError)


def retry_io(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay_seconds: float = 1.0,
    max_delay_seconds: float = 30.0,
    retry_on: tuple[type[BaseException], ...] = TRANSIENT_IO_ERRORS,
    description: str | None = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Run ``fn()`` up to ``attempts`` times, sleeping ``base * 2**i`` (capped at
    ``max_delay_seconds``) between tries. Re-raises the last error once attempts are
    exhausted; errors not in ``retry_on`` propagate immediately."""
    assert attempts >= 1, f"attempts must be >= 1, got {attempts}"
    what = description or getattr(fn, "__name__", "operation")
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as error:
            if attempt == attempts - 1:
                log_rank_0(
                    logging.ERROR,
                    f"{what} failed after {attempts} attempt(s): {error!r}",
                )
                # exhausted retries usually crash the run next — make the record durable
                get_telemetry().count("io_failures", event=True)
                raise
            get_telemetry().count("io_retries")
            delay = min(base_delay_seconds * (2**attempt), max_delay_seconds)
            log_rank_0(
                logging.WARNING,
                f"{what} failed (attempt {attempt + 1}/{attempts}): {error!r}; "
                f"retrying in {delay:.1f}s",
            )
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
