"""Async input pipeline: background prefetch, device double-buffering, exact resume.

Counterpart of `dolomite_engine_tpu/data/prefetch.py`, with the same contract. The loop
consumes *step batches*: ``gradient_accumulation_steps`` micro-batches stacked into one
``[accum, ...]`` batch. :class:`StepPrefetcher` moves the host work (sampling, stacking,
the host-to-device copy) onto ONE background daemon thread that runs up to ``depth`` step
batches ahead through a bounded queue, so the ``data`` goodput bucket measures only the
residual queue wait.

**Device placement.** With a CUDA `device`, the worker pins each assembled batch's
tensors in host memory and copies them with ``non_blocking=True`` on a side CUDA stream,
then records an event; the consumer's stream waits on that event before it hands the
batch over, and each tensor is marked as used by the consumer's stream
(``record_stream``), so the step never reads a buffer still being written and the
allocator never reuses one the step still reads. A CPU `device` (the tests) stacks and
hands over; ``device=None`` leaves the batch where the assembly put it.

``depth=0`` is the synchronous path: the same fetch/assemble sequence runs inline in
``next()`` with no thread and no queue (byte-identical batch order).

**Resume-exact.** The prefetcher snapshots the wrapped loader's state *before* fetching
each step batch and carries the snapshot through the queue with its batch: after the
loop consumes step ``k``, :meth:`state_dict` returns step ``k``'s pre-fetch snapshot plus
``skip_batches=1``, so batches buffered but not consumed are regenerated in order.

**Failure-transparent.** Worker exceptions (including ``StopIteration`` for finite
sources) are carried through the queue and re-raised at the consuming ``next()``;
:meth:`close` shuts the worker down on every loop exit path.

:class:`PrefetchingIterable` is the restartable sibling for finite eval loaders.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator

import torch

from ..utils.telemetry import get_telemetry, trace_annotation

# state_dict marker distinguishing prefetcher-written dataloader state from the bare
# loader state older checkpoints hold (load_state_dict accepts both)
_STATE_SCHEMA_KEY = "prefetch_schema"
_STATE_SCHEMA_VERSION = 1

# queue messages: ("item", pre-fetch loader snapshot, assembled batch),
# ("end", None, None) on source exhaustion, ("raise", None, exception) on worker failure
_ITEM, _END, _RAISE = "item", "end", "raise"


def _default_assemble(micros: list) -> Any:
    """micros_per_step=1 passthrough (eval loaders): the single micro IS the batch."""
    return micros[0] if len(micros) == 1 else list(micros)


def _map_tensors(batch, fn):
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, dict):
        return {key: _map_tensors(value, fn) for key, value in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_tensors(value, fn) for value in batch)
    return batch


class StepPrefetcher:
    """Bounded background prefetcher yielding fully-assembled step batches.

    Parameters
    ----------
    loader:
        The dataloader to drain. Any iterable; when it exposes
        ``state_dict``/``load_state_dict`` the prefetcher is checkpointable (finetune's
        ``ShardedDataLoader``/``DispatchingDataLoader``/test loaders). Bare iterators
        (megatron pretrain loaders, which resume via ``consumed_samples`` metadata) are
        wrapped statelessly.
    depth:
        Step batches buffered ahead (device-resident). 0 = synchronous inline path,
        byte-identical batch order and no thread.
    micros_per_step:
        Micro-batches fetched per yielded step batch (``gradient_accumulation_steps``).
    assemble_fn:
        ``assemble_fn(micros: list) -> batch`` — the stacking stage (e.g. ``torch.stack``
        over the accumulation axis), on host tensors. Runs on the worker thread.
    loop:
        True = cycle the loader forever (finetune epochs); False = propagate exhaustion as
        ``StopIteration``.
    device:
        Where the batch's tensors go: a CUDA device takes the pinned, side-stream copy
        described above; None leaves them on the host.
    """

    def __init__(
        self,
        loader,
        depth: int = 0,
        micros_per_step: int = 1,
        assemble_fn: Callable[[list], Any] | None = None,
        loop: bool = False,
        device: torch.device | str | None = None,
        description: str = "dataloader",
    ) -> None:
        assert depth >= 0, f"prefetch depth must be >= 0 (got {depth})"
        assert micros_per_step >= 1, (
            f"micros_per_step must be >= 1 (got {micros_per_step})"
        )
        self.loader = loader
        self.depth = int(depth)
        self.micros_per_step = int(micros_per_step)
        self.description = description
        self._assemble = assemble_fn or _default_assemble
        self._loop = loop
        self.device = None if device is None else torch.device(device)
        self._on_card = self.device is not None and self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._on_card and depth > 0 else None

        self._stateful = hasattr(loader, "state_dict") and hasattr(
            loader, "load_state_dict"
        )
        # resume contract: restore `_resume_snapshot` into the loader, discard
        # `_resume_skip` step batches, and the next batch produced is the next one the
        # consumer has not seen. Mutated only on the consuming thread.
        self._resume_snapshot = loader.state_dict() if self._stateful else None
        self._resume_skip = 0
        # step batches to discard when iteration starts (set by load_state_dict)
        self._start_skip = 0

        self._source: Iterator | None = None  # depth=0 inline micro stream
        self._queue: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._finished = False
        self._failure: BaseException | None = None
        self._consumed = 0

        # data wait of the most recent next(): queue-get wall time (async) or the raw
        # micro-fetch time (sync) — assembly/H2D excluded in both modes, so the loops'
        # `data` goodput bucket charges only time the step loop truly sat waiting on data
        self.last_wait_seconds = 0.0

    # ------------------------------------------------------------------ state
    def state_dict(self) -> dict:
        """Resume-exact state: the wrapped loader's snapshot from *before* the last
        consumed batch was fetched, plus how many step batches to discard on restore.
        Batches sitting in the prefetch queue are deliberately not represented — they are
        regenerated by the restored loader, in order."""
        if not self._stateful:
            return {}
        return {
            _STATE_SCHEMA_KEY: _STATE_SCHEMA_VERSION,
            "loader": self._resume_snapshot,
            "skip_batches": self._resume_skip,
        }

    def load_state_dict(self, state_dict: dict | None) -> None:
        """Accepts prefetcher state or bare loader state (checkpoints written before the
        prefetcher existed). Must run before iteration starts."""
        assert self._thread is None and self._source is None, (
            "StepPrefetcher.load_state_dict must run before iteration starts"
        )
        if not self._stateful or state_dict is None:
            return
        if isinstance(state_dict, dict) and _STATE_SCHEMA_KEY in state_dict:
            loader_state = state_dict.get("loader")
            skip = int(state_dict.get("skip_batches", 0))
        else:
            loader_state, skip = state_dict, 0
        if loader_state is not None:
            self.loader.load_state_dict(loader_state)
            self._resume_snapshot = loader_state
        self._resume_skip = skip
        self._start_skip = skip
        self._finished = False

    def _note_consumed(self, snapshot) -> None:
        if self._stateful:
            self._resume_snapshot = snapshot
            self._resume_skip = 1
        self._consumed += 1

    # ------------------------------------------------------------------ source plumbing
    def _micro_stream(self) -> Iterator:
        """Flat micro-batch stream, cycling epochs when `loop`, with the post-restore
        skip applied (discard whole step batches the consumer already saw)."""
        if self._loop:

            def _cycle():
                while True:
                    yield from iter(self.loader)

            stream = _cycle()
        else:
            stream = iter(self.loader)
        for _ in range(self._start_skip * self.micros_per_step):
            next(stream)
        self._start_skip = 0
        return stream

    def _fetch_step(self, stream: Iterator) -> tuple[Any, Any]:
        """One (pre-fetch snapshot, (assembled step batch, copy event)) on the worker;
        StopIteration propagates."""
        snapshot = self.loader.state_dict() if self._stateful else None
        with trace_annotation("data_fetch"):
            micros = [next(stream) for _ in range(self.micros_per_step)]
        with trace_annotation("prefetch_assemble"):
            batch = self._assemble(micros)
            event = None
            if self._on_card:
                with torch.cuda.stream(self._copy_stream):
                    batch = _map_tensors(
                        batch, lambda t: t.pin_memory().to(self.device, non_blocking=True)
                    )
                    event = torch.cuda.Event()
                    event.record(self._copy_stream)
            elif self.device is not None:
                batch = _map_tensors(batch, lambda t: t.to(self.device))
        return snapshot, (batch, event)

    def _hand_over(self, payload):
        """The consumer's side of a worker batch: its stream waits for the copy, and every
        tensor is marked as in use on that stream."""
        batch, event = payload
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            _map_tensors(batch, lambda t: t.record_stream(consumer))
        return batch

    # ------------------------------------------------------------------ worker
    def _offer(self, message) -> bool:
        """Bounded put that stays responsive to close(): never blocks past 50 ms without
        rechecking the stop flag, so a full queue cannot wedge shutdown."""
        while not self._stop.is_set():
            try:
                self._queue.put(message, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            stream = self._micro_stream()
            while not self._stop.is_set():
                snapshot, batch = self._fetch_step(stream)
                if not self._offer((_ITEM, snapshot, batch)):
                    return
        except StopIteration:
            self._offer((_END, None, None))
        except BaseException as error:  # re-raised at the consuming next()
            self._offer((_RAISE, None, error))

    def _ensure_worker(self) -> None:
        if self._thread is not None:
            return
        self._queue = queue.Queue(maxsize=self.depth)
        self._thread = threading.Thread(
            target=self._worker,
            daemon=True,
            name=f"step-prefetcher[{self.description}]",
        )
        self._thread.start()

    # ------------------------------------------------------------------ iteration
    def __iter__(self) -> "StepPrefetcher":
        return self

    def __next__(self):
        if self._failure is not None:
            raise self._failure
        if self._finished:
            raise StopIteration
        if self.depth == 0:
            return self._next_sync()
        return self._next_async()

    def _next_sync(self):
        if self._source is None:
            self._source = self._micro_stream()
        snapshot = self.loader.state_dict() if self._stateful else None
        start = time.perf_counter()
        try:
            with trace_annotation("data_fetch"):
                micros = [next(self._source) for _ in range(self.micros_per_step)]
        except StopIteration:
            self._finished = True
            raise
        self.last_wait_seconds = time.perf_counter() - start
        with trace_annotation("prefetch_assemble"):
            batch = self._assemble(micros)
            if self.device is not None:
                batch = _map_tensors(batch, lambda t: t.to(self.device))
        self._note_consumed(snapshot)
        return batch

    def _next_async(self):
        self._ensure_worker()
        telemetry = get_telemetry()
        empty_at_get = self._queue.empty()
        start = time.perf_counter()
        # a blocking get on purpose: a wedged worker must look exactly like a stalled
        # dataloader so the StallWatchdog wrapping this next() can abort the run
        kind, snapshot, payload = self._queue.get()
        self.last_wait_seconds = time.perf_counter() - start
        telemetry.gauge("prefetch/queue_depth", self._queue.qsize())
        if kind == _END:
            self._finished = True
            raise StopIteration
        if kind == _RAISE:
            self._failure = payload
            raise payload
        if empty_at_get and self._consumed > 0:
            # steady-state starvation only: the first fetch always waits on worker warmup
            telemetry.count("prefetch_stalls")
        self._note_consumed(snapshot)
        return self._hand_over(payload)

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def queue_depth(self) -> int:
        """Step batches currently buffered (0 in synchronous mode)."""
        return self._queue.qsize() if self._queue is not None else 0

    # ------------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Stop the worker on any loop exit path. Buffered batches are discarded — exact
        resume never depends on them (see :meth:`state_dict`). Safe to call repeatedly or
        on a never-started prefetcher."""
        self._stop.set()
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None and self._thread.is_alive():
            # a worker wedged inside the loader's next() stays blocked there — it is a
            # daemon thread and never holds up interpreter exit
            self._thread.join(timeout=2.0)


class PrefetchingIterable:
    """Restartable prefetch wrapper for finite eval loaders.

    Each ``__iter__`` call runs one full pass with its own worker thread and bounded
    queue; the worker is torn down when the pass ends — including when the consumer
    abandons the pass early (generator ``close()`` runs the ``finally``). ``depth=0``
    iterates the loader inline, unchanged. State-dict calls delegate to the wrapped
    loader (eval loaders are not checkpointed, but the wrapper stays transparent)."""

    def __init__(self, loader, depth: int = 0, description: str = "eval dataloader") -> None:
        assert depth >= 0, f"prefetch depth must be >= 0 (got {depth})"
        self.loader = loader
        self.depth = int(depth)
        self.description = description

    def __iter__(self):
        if self.depth == 0:
            yield from self.loader
            return
        pass_queue: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def _offer(message) -> bool:
            while not stop.is_set():
                try:
                    pass_queue.put(message, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def _worker() -> None:
            try:
                for item in self.loader:
                    if not _offer((_ITEM, item)):
                        return
                _offer((_END, None))
            except BaseException as error:
                _offer((_RAISE, error))

        thread = threading.Thread(
            target=_worker, daemon=True, name=f"eval-prefetcher[{self.description}]"
        )
        thread.start()
        try:
            while True:
                kind, payload = pass_queue.get()
                if kind == _END:
                    return
                if kind == _RAISE:
                    raise payload
                yield payload
        finally:
            stop.set()
            try:
                while True:
                    pass_queue.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=2.0)

    def __len__(self) -> int:
        return len(self.loader)

    def state_dict(self) -> dict:
        return self.loader.state_dict() if hasattr(self.loader, "state_dict") else {}

    def load_state_dict(self, state_dict) -> None:
        if hasattr(self.loader, "load_state_dict"):
            self.loader.load_state_dict(state_dict)
