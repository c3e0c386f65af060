"""The port's `StepPrefetcher` against the JAX package's, on the CPU.

Over one resumable loader both give the same step-batch sequence and the same resume
state, synchronously (depth 0) and from the worker thread (depth 2); the port's resume
from a checkpoint taken with batches still in the queue continues with exactly the first
batch the loop had not consumed; a worker's exception is re-raised at the consuming
``next()``, every time; ``close()`` stops a worker blocked on a full queue; the stall
watchdog fires through the prefetcher's queue get; a ``device`` puts the batch there. The
eval wrapper `PrefetchingIterable` gives the JAX package's passes, a pass abandoned half way
included.
"""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.data.prefetch import PrefetchingIterable as JaxPrefetchingIterable
from dolomite_engine_tpu.data.prefetch import StepPrefetcher as JaxStepPrefetcher
from dolomite_engine_tpu_torch.data.prefetch import PrefetchingIterable, StepPrefetcher
from dolomite_engine_tpu_torch.utils import StallWatchdog, install_telemetry, uninstall_telemetry
from dolomite_engine_tpu_torch.utils.telemetry import Telemetry


class _SeqLoader:
    """Resumable loader: micro-batch k is full((2, 4), k); the cursor advances across
    epochs of `n` batches, so every batch of the stream is distinct."""

    def __init__(self, n=4, sleep=0.0, fail_at=None):
        self.n, self.sleep, self.fail_at = n, sleep, fail_at
        self.cursor = 0

    def __iter__(self):
        for _ in range(self.n):
            if self.fail_at is not None and self.cursor == self.fail_at:
                raise RuntimeError("poisoned shard")
            if self.sleep:
                time.sleep(self.sleep)
            value = self.cursor
            self.cursor += 1
            yield {"x": np.full((2, 4), value, np.int64)}

    def __len__(self):
        return self.n

    def state_dict(self):
        return {"cursor": self.cursor}

    def load_state_dict(self, state):
        self.cursor = state["cursor"]


def _port(loader, depth, micros=1, loop=True, device="cpu"):
    return StepPrefetcher(
        loader, depth=depth, micros_per_step=micros, loop=loop, device=device, description="test loader",
        assemble_fn=lambda ms: {"x": torch.stack([torch.from_numpy(m["x"]) for m in ms])},
    )


def _jax(loader, depth, micros=1, loop=True):
    return JaxStepPrefetcher(
        loader, depth=depth, micros_per_step=micros, loop=loop, description="test loader",
        assemble_fn=lambda ms: {"x": jnp.stack([m["x"] for m in ms])},
    )


def _consume(prefetcher, steps):
    return [np.asarray(next(prefetcher)["x"]) for _ in range(steps)]


def _values(batches):
    return [int(batch.flat[0]) for batch in batches]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("micros", [1, 3])
def test_sequence_and_state_match_jax(depth, micros):
    ours, theirs = _port(_SeqLoader(), depth, micros), _jax(_SeqLoader(), depth, micros)
    try:
        for _ in range(3):
            got, want = _consume(ours, 3), _consume(theirs, 3)
            np.testing.assert_array_equal(np.stack(got), np.stack(want))
            assert ours.state_dict() == theirs.state_dict()
    finally:
        ours.close()
        theirs.close()


def test_resume_exact_with_nonempty_queue():
    prefetcher = _port(_SeqLoader(sleep=0.002), depth=3, micros=2)
    try:
        consumed = _values(_consume(prefetcher, 3))
        deadline = time.time() + 5
        while prefetcher.queue_depth == 0 and time.time() < deadline:
            time.sleep(0.005)
        assert prefetcher.queue_depth > 0  # the loader ran ahead of consumption
        state = json.loads(json.dumps(prefetcher.state_dict()))
    finally:
        prefetcher.close()

    resumed = _port(_SeqLoader(sleep=0.002), depth=3, micros=2)
    resumed.load_state_dict(state)
    try:
        tail = _values(_consume(resumed, 5))
    finally:
        resumed.close()
    reference = _jax(_SeqLoader(), depth=0, micros=2)
    assert consumed + tail == _values(_consume(reference, 8))


def test_worker_exception_reraised_at_next():
    prefetcher = _port(_SeqLoader(n=8, fail_at=2), depth=2, loop=False)
    try:
        assert _values(_consume(prefetcher, 2)) == [0, 1]
        with pytest.raises(RuntimeError, match="poisoned shard"):
            next(prefetcher)
        with pytest.raises(RuntimeError, match="poisoned shard"):
            next(prefetcher)  # the failure is sticky, not swallowed
    finally:
        prefetcher.close()


def test_finite_source_stop_iteration_propagates():
    prefetcher = _port(_SeqLoader(n=5), depth=2, loop=False)
    try:
        assert _values(np.asarray(b["x"]) for b in prefetcher) == [0, 1, 2, 3, 4]
        with pytest.raises(StopIteration):
            next(prefetcher)
    finally:
        prefetcher.close()


def test_close_with_full_queue_stops_worker():
    prefetcher = _port(_SeqLoader(n=100), depth=1)
    try:
        next(prefetcher)  # the worker then blocks offering into the full queue
        deadline = time.time() + 5
        while prefetcher.queue_depth == 0 and time.time() < deadline:
            time.sleep(0.005)
        assert prefetcher.queue_depth == 1
    finally:
        prefetcher.close()
    assert not prefetcher._thread.is_alive()


def test_stall_watchdog_fires_through_prefetcher():
    release = threading.Event()

    class _WedgedLoader(_SeqLoader):
        def __iter__(self):
            yield {"x": np.zeros((2, 4), np.int64)}
            release.wait(30)

    prefetcher = _port(_WedgedLoader(), depth=2, loop=False)
    watchdog = StallWatchdog(prefetcher, timeout_seconds=0.3, description="train dataloader")
    try:
        next(watchdog)
        with pytest.raises(RuntimeError, match="train dataloader stalled"):
            next(watchdog)
    finally:
        release.set()
        watchdog.close()
        prefetcher.close()


@pytest.mark.parametrize("depth", [0, 2])
def test_batches_land_on_the_device(depth):
    prefetcher = _port(_SeqLoader(), depth, micros=2, device="cpu")
    try:
        batch = next(prefetcher)
        assert batch["x"].device == torch.device("cpu") and batch["x"].shape == (2, 2, 4)
    finally:
        prefetcher.close()


def test_prefetch_telemetry_gauge_and_stall_counter(tmp_path):
    telemetry = Telemetry(sink_path=str(tmp_path / "sink.jsonl"))
    install_telemetry(telemetry)
    try:
        prefetcher = _port(_SeqLoader(sleep=0.02), depth=2)
        try:
            _consume(prefetcher, 4)  # the consumer outruns the 20 ms a batch worker
        finally:
            prefetcher.close()
        assert "prefetch/queue_depth" in telemetry.gauges
        assert telemetry.counters.get("prefetch_stalls", 0) >= 1
    finally:
        uninstall_telemetry()
        telemetry.close()


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetching_iterable_passes_match_jax(depth):
    ours, theirs = PrefetchingIterable(_SeqLoader(n=5), depth), JaxPrefetchingIterable(_SeqLoader(n=5), depth)
    for wrapped in (ours, theirs):
        for i, _ in enumerate(wrapped):  # a pass abandoned half way tears its worker down
            if i == 1:
                break
    assert [_values(b["x"] for b in ours) for _ in range(2)] == [_values(b["x"] for b in theirs) for _ in range(2)]
    with pytest.raises(RuntimeError, match="poisoned shard"):
        list(PrefetchingIterable(_SeqLoader(n=8, fail_at=1), depth))
