"""Preemption-safe shutdown + dataloader stall watchdog (a copy of
`dolomite_engine_tpu/utils/fault_tolerance.py`).

Training jobs get preempted: maintenance events and spot reclaims deliver SIGTERM with a short
grace window, and an interactive ^C sends SIGINT. Without handling, either kills the run on
the spot and loses everything since the last checkpoint. :func:`install_preemption_handler`
turns the first signal into a flag the train loops (pretrain.py/finetune.py) poll once per
step; the loop then writes a final synchronous checkpoint and exits cleanly. A second SIGINT
still raises KeyboardInterrupt so a wedged save can be broken out of by hand.

:class:`StallWatchdog` guards the other silent failure mode: a `next(train_dataloader)` that
never returns (hung storage mount, dead data worker). It fetches batches on a dedicated
daemon thread and raises if a single fetch exceeds the configured wall-clock budget —
turning an invisible hang into a crash that the scheduler (or operator) can restart from the
last checkpoint.

Both are config-gated via ``FaultToleranceArgs`` (arguments.py).
"""

from __future__ import annotations

import logging
import queue
import signal
import threading
from typing import Any, Iterator

from .logger import log_rank_0
from .telemetry import get_telemetry

_PREEMPTION = threading.Event()
_SIGNAL_COUNTS: dict[int, int] = {}
_PREVIOUS_HANDLERS: dict[int, Any] = {}

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)

# callbacks run when a fault-tolerance guard is about to end the run (preemption notice,
# stall watchdog): the crash flight recorder (utils/diagnostics.py) registers its dump here
# so the last-N-steps record is on disk while the process is still alive to write it
_CRASH_HOOKS: list = []


def register_crash_hook(hook) -> None:
    """Register `hook(reason: str)` to run at the moment a fault-tolerance guard fires."""
    if hook not in _CRASH_HOOKS:
        _CRASH_HOOKS.append(hook)


def unregister_crash_hook(hook) -> None:
    try:
        _CRASH_HOOKS.remove(hook)
    except ValueError:
        pass


def run_crash_hooks(reason: str) -> None:
    """Invoke every registered hook; a failing hook must never mask the original fault."""
    for hook in list(_CRASH_HOOKS):
        try:
            hook(reason)
        except Exception as error:
            log_rank_0(logging.WARNING, f"crash hook failed ({reason}): {error!r}")


def _handle_signal(signum: int, frame) -> None:
    _SIGNAL_COUNTS[signum] = _SIGNAL_COUNTS.get(signum, 0) + 1
    if signum == signal.SIGINT and _SIGNAL_COUNTS[signum] > 1:
        # second ^C: the operator wants out NOW, even mid-save
        raise KeyboardInterrupt
    if not _PREEMPTION.is_set():
        _PREEMPTION.set()
        # the process is going away — write the event record + flight record now, not at
        # the next window (the grace period may not reach one)
        get_telemetry().count("preemptions", event=True)
        run_crash_hooks("preemption")
        log_rank_0(
            logging.WARNING,
            f"received signal {signal.Signals(signum).name}: finishing the current step, "
            "writing a final checkpoint, then exiting",
        )


def install_preemption_handler(signals: tuple[int, ...] = _DEFAULT_SIGNALS) -> None:
    """Route SIGTERM/SIGINT (maintenance/preemption notices, ^C) to the preemption flag.

    Idempotent; only the first install records the previous handlers (restored by
    :func:`uninstall_preemption_handler`). Must run on the main thread — Python only
    delivers signals there. Outside the main thread (some test runners) it degrades to a
    warning instead of crashing the run.
    """
    if threading.current_thread() is not threading.main_thread():
        log_rank_0(
            logging.WARNING,
            "preemption handler not installed: signal handlers require the main thread",
        )
        return
    for signum in signals:
        if signum not in _PREVIOUS_HANDLERS:
            _PREVIOUS_HANDLERS[signum] = signal.signal(signum, _handle_signal)


def uninstall_preemption_handler() -> None:
    """Restore the pre-install signal handlers and clear the flag (training end, tests)."""
    while _PREVIOUS_HANDLERS:
        signum, previous = _PREVIOUS_HANDLERS.popitem()
        signal.signal(signum, previous)
    _SIGNAL_COUNTS.clear()
    _PREEMPTION.clear()


def preemption_requested() -> bool:
    """Polled by the train loops once per step."""
    return _PREEMPTION.is_set()


def request_preemption() -> None:
    """Set the flag programmatically (tests; external orchestrators with their own notice
    channel can call this from a watcher thread)."""
    _PREEMPTION.set()


def reset_preemption() -> None:
    _PREEMPTION.clear()
    _SIGNAL_COUNTS.clear()


class StallWatchdog:
    """Iterator wrapper that bounds the wall-clock time of each ``next()``.

    The wrapped iterator is driven from ONE dedicated daemon thread (generators are not
    thread-safe across callers; a single worker keeps the contract). If a fetch exceeds
    ``timeout_seconds`` the main thread raises RuntimeError — the worker may stay blocked
    inside the hung ``next()``, but being a daemon it never blocks interpreter exit.

    ``timeout_seconds=None`` is a true pass-through (no thread is started).
    """

    def __init__(
        self,
        iterable,
        timeout_seconds: float | None,
        description: str = "dataloader",
    ) -> None:
        self._iterator: Iterator = iter(iterable)
        self.timeout_seconds = timeout_seconds
        self.description = description
        self._request: queue.Queue | None = None
        self._response: queue.Queue | None = None
        self._thread: threading.Thread | None = None

    def _ensure_worker(self) -> None:
        if self._thread is not None:
            return
        self._request = queue.Queue()
        self._response = queue.Queue()
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name=f"stall-watchdog[{self.description}]"
        )
        self._thread.start()

    def _worker(self) -> None:
        while self._request.get():
            try:
                self._response.put(("item", next(self._iterator)))
            except BaseException as error:  # incl. StopIteration — re-raised by __next__
                self._response.put(("raise", error))

    def __iter__(self) -> "StallWatchdog":
        return self

    def __next__(self):
        if self.timeout_seconds is None:
            return next(self._iterator)
        self._ensure_worker()
        self._request.put(True)
        try:
            kind, payload = self._response.get(timeout=self.timeout_seconds)
        except queue.Empty:
            # the raise below usually kills the run — record the stall durably first
            get_telemetry().count("loader_stalls", event=True)
            run_crash_hooks("loader_stall")
            raise RuntimeError(
                f"{self.description} stalled: no batch within {self.timeout_seconds:.1f}s "
                "wall-clock — hung storage mount or dead data worker; aborting so the run "
                "can be restarted from the last checkpoint"
            ) from None
        if kind == "raise":
            raise payload
        return payload

    def close(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._request.put(False)  # worker exits at the next idle get()
