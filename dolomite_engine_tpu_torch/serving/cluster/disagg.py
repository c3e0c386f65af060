"""Prefill/decode disaggregation: a prefill worker pool feeding decode workers via KV handoff.

(Copy of `dolomite_engine_tpu/serving/cluster/disagg.py`, with the page copy in torch and
the handoff carrying the sampling generator's state where the JAX package carries its rng
carry.)

Prefill and decode have opposite hardware appetites — prefill is compute-bound (big
matmuls over whole prompts), decode is memory-bandwidth-bound (one token per step over a
large KV pool) — so production serving splits them onto separately-scaled pools
(DistServe, Zhong et al. 2024; Splitwise, Patel et al. 2024). The pieces here:

- **PrefillWorker** — a :class:`~..engine.ServingEngine` in ``prefill_only`` mode: it
  admits, chunk-prefills into its paged pool, streams the first token, then parks the
  finished prefill for handoff instead of decoding.
- **KVHandoff** — the explicit transfer seam: copy a request's prefix pages from the
  prefill pool into freshly-allocated pages of a decode pool. The in-process
  implementation is an `index_select` / `index_copy_` over the page dim of every array of
  a layer (device to device on one card; a quantized pool's scale rows travel with their
  codes). This interface is where an NVLink or network transfer lands when workers span
  cards or hosts.
- **DecodeWorker** — any plain paged engine: `ServingEngine.adopt_prefilled` installs
  the transferred request exactly as a local final prefill chunk would have (its sampling
  generator continues from the prefill side's state), so decode is token-for-token
  identical to the monolithic engine.
- **DisaggregatedEngine** — composes one prefill engine and N decode workers behind the
  ServingEngine driver interface (submit/step/drain/has_work), placing handoffs FCFS
  onto the least-loaded worker with capacity.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from ...ops.kv_quant import as_bytes
from ...utils.telemetry import get_telemetry
from ..engine import ServingEngine
from ..kv_cache import KVCacheList, PagedKVCachePool
from ..scheduler import QueueFullError, RequestState


@torch.no_grad()
def _copy_pages(dst_caches: KVCacheList, src_caches: KVCacheList, dst_index: torch.Tensor, src_index: torch.Tensor) -> None:
    """Copy `src` pages onto `dst` pages in every layer, in place. Every per-layer array
    is page-major (pages at dim 0), so a quantized pool's scale rows move with their
    codes and the transferred (codes, scale) pairs decode identically on the destination;
    the copy is of raw bytes (fp8 codes as uint8 views)."""
    for dst, src in zip(dst_caches, src_caches):
        for name in dst:
            as_bytes(dst[name]).index_copy_(0, dst_index, as_bytes(src[name]).index_select(0, src_index))


class KVHandoff:
    """Device-to-device page transfer between two paged pools (the disaggregation seam).

    One `index_select` / `index_copy_` pair per array of a layer over the request's pages,
    on the current stream. Tracks a rolling handoff-latency gauge: the transfer's host
    wall time up to a device sync, so it times the copy, not its enqueue.
    """

    def __init__(self, fault_injector=None, replica_id: int = 0) -> None:
        self.transfers = 0
        self.last_latency_s = 0.0
        self._latency_sum = 0.0
        # chaos seam (serving/cluster/faults.py): `EngineReplica` wires its injector
        # here so a planned `handoff` fault fires at an exact transfer index; the off
        # path is one None check, and a raise fires BEFORE any page copy — the
        # destination pages stay unwritten, the replica's step raise is what the
        # health monitor then judges
        self.fault_injector = fault_injector
        self.replica_id = replica_id

    @property
    def mean_latency_s(self) -> float:
        return self._latency_sum / self.transfers if self.transfers else 0.0

    def transfer(
        self,
        src_pool: PagedKVCachePool,
        src_pages: list[int],
        dst_pool: PagedKVCachePool,
        dst_pages: list[int],
    ) -> None:
        if self.fault_injector is not None:
            self.fault_injector.on_transfer(self.replica_id)
        if src_pool.page_size != dst_pool.page_size:
            raise ValueError(
                f"KV handoff needs equal page sizes, got {src_pool.page_size} -> "
                f"{dst_pool.page_size}"
            )
        if src_pool.kv_dtype != dst_pool.kv_dtype:
            raise ValueError(
                f"KV handoff needs equal kv_dtype, got {src_pool.kv_dtype!r} -> "
                f"{dst_pool.kv_dtype!r} (quantized page bytes only decode with their "
                "own format's scales)"
            )
        assert len(src_pages) == len(dst_pages), (src_pages, dst_pages)
        assert len(dst_pages) <= dst_pool.max_pages_per_slot, "handoff exceeds the destination slot's pages"
        device = dst_pool.caches[0]["k"].device
        t0 = time.perf_counter()
        _copy_pages(
            dst_pool.caches,
            src_pool.caches,
            torch.as_tensor(dst_pages, dtype=torch.long, device=device),
            torch.as_tensor(src_pages, dtype=torch.long, device=src_pool.caches[0]["k"].device),
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.record_latency(time.perf_counter() - t0)

    def record_latency(self, seconds: float) -> None:
        self.transfers += 1
        self.last_latency_s = seconds
        self._latency_sum += seconds
        get_telemetry().count("cluster_kv_handoffs")
        get_telemetry().gauge("cluster/handoff_latency_ms", round(seconds * 1e3, 3))


class DisaggregatedEngine:
    """One prefill engine + N decode workers behind the ServingEngine driver interface.

    ``submit`` enqueues on the prefill side; each ``step`` advances prefill, moves
    finished prefills (FCFS — if the head fits no worker, nothing skips ahead of it)
    onto the decode worker with the lowest load, then steps every decode worker.
    Deadlines keep working across the boundary: both sides share one clock and the
    request's original ``submit_t``.
    """

    def __init__(
        self,
        prefill_engine: ServingEngine,
        decode_engines: list[ServingEngine],
        handoff: KVHandoff | None = None,
    ) -> None:
        if not prefill_engine.prefill_only:
            raise ValueError("prefill_engine must be constructed with prefill_only=True")
        if not decode_engines:
            raise ValueError("need at least one decode engine")
        for engine in decode_engines:
            if not engine.paged or engine.prefill_only:
                raise ValueError("decode engines must be paged, non-prefill_only")
            if engine.pool.page_size != prefill_engine.pool.page_size:
                raise ValueError("prefill and decode pools must share a page size")
            if engine.pool.kv_dtype != prefill_engine.pool.kv_dtype:
                raise ValueError("prefill and decode pools must share a kv_dtype")
        self.prefill = prefill_engine
        self.workers = decode_engines
        self.handoff = KVHandoff() if handoff is None else handoff

    # ------------------------------------------------------------- driver interface

    def submit(self, *args: Any, **kwargs: Any) -> RequestState:
        return self.prefill.submit(*args, **kwargs)

    @property
    def queue_depth(self) -> int:
        return self.prefill.scheduler.queue_depth

    @property
    def occupancy(self) -> float:
        return sum(w.pool.occupancy for w in self.workers) / len(self.workers)

    def prefix_match_len(self, prompt_ids: list[int]) -> int:
        # affinity means "prefill is cheap here": the prefill engine owns the index
        return self.prefill.prefix_match_len(prompt_ids)

    def has_work(self) -> bool:
        return (
            self.prefill.has_work()
            or self.prefill.pending_handoffs > 0
            or any(w.has_work() for w in self.workers)
        )

    def step(self) -> bool:
        self.prefill.step()
        self._place_handoffs()
        for worker in self.workers:
            if worker.has_work():
                worker.step()
        return self.has_work()

    def drain(self) -> None:
        while self.step():
            pass
        self.emit_serving_record()

    def emit_serving_record(self) -> None:
        self.prefill.emit_serving_record()
        for worker in self.workers:
            worker.emit_serving_record()

    # -------------------------------------------------------------- crash migration

    def inflight_request_ids(self) -> list[int]:
        ids = set(self.prefill.inflight_request_ids())
        for worker in self.workers:
            ids.update(worker.inflight_request_ids())
        return sorted(ids)

    def release_inflight(self) -> list[RequestState]:
        """Strip every unfinished request out of BOTH sides. A request caught mid-
        handoff (adopted by a worker but its page transfer unfinished) appears in both
        engines' slot tables — it is released once. All sides share the prefill
        scheduler's seq space, so the merged (tier, seq) order is fleet-FCFS."""
        released = self.prefill.release_inflight()
        seen = {state.request.request_id for state in released}
        for worker in self.workers:
            for state in worker.release_inflight():
                if state.request.request_id not in seen:
                    seen.add(state.request.request_id)
                    released.append(state)
        released.sort(key=lambda s: (s.tier, s.seq))
        return released

    def adopt_inflight(self, state: RequestState) -> None:
        """Adopt a request migrated from another replica. Fresh requests (no tokens
        yet) re-enter through the prefill side like any arrival; mid-generation ones
        go straight to a decode worker — decode workers are full paged engines, so the
        recompute resume chunk-prefills the committed prefix there and decode
        continues in place, skipping a pointless re-handoff."""
        if not state.tokens:
            self.prefill.adopt_inflight(state)
            return
        last_error: QueueFullError | None = None
        for worker in sorted(self.workers, key=lambda w: (w.pool.occupancy, id(w))):
            try:
                worker.adopt_inflight(state)
                return
            except QueueFullError as error:
                last_error = error
        assert last_error is not None
        raise last_error

    def swap_params(self, params) -> None:
        """Install new weights on the prefill engine and every decode worker (rolling
        update while parked by `Router.drain_replica`)."""
        self.prefill.swap_params(params)
        for worker in self.workers:
            worker.swap_params(params)

    # ------------------------------------------------------------------- internals

    def _place_handoffs(self) -> None:
        from ..scheduler import RequestStatus

        ready = self.prefill.take_ready_handoffs()
        for index, state in enumerate(ready):
            if self.prefill.scheduler.expired(state):
                # deadline lapsed while parked: cancel on the prefill side (frees pages)
                self.prefill._finish(state, RequestStatus.cancelled)
                continue
            src_slot = state.slot  # adopt_prefilled repoints state.slot at the decode slot
            first_token, generator_state, length, src_pages = self.prefill.handoff_payload(state)
            placed = False
            for worker in sorted(self.workers, key=lambda w: (w.pool.occupancy, id(w))):
                dst_pages = worker.adopt_prefilled(
                    state, first_token=first_token, generator_state=generator_state, length=length
                )
                if dst_pages is not None:
                    self.handoff.transfer(self.prefill.pool, src_pages, worker.pool, dst_pages)
                    self.prefill.release_handoff(state, src_slot)
                    trace = state.trace
                    if trace is not None:
                        # the request's trace rode the RequestState across the seam;
                        # the handoff span (opened when the prefill parked) closes once
                        # the pages land on the adopting worker — ONE tree, two workers
                        span = trace.open.pop("handoff", None)
                        if span is not None:
                            trace.end(
                                span,
                                t1=self.prefill.scheduler.clock(),
                                dst_replica=worker.replica_id,
                                pages=len(src_pages),
                                transfer_ms=round(self.handoff.last_latency_s * 1e3, 3),
                            )
                    placed = True
                    break
            if placed:
                continue
            # head doesn't fit anywhere: park everything back, preserving FCFS order
            for waiter in reversed(ready[index:]):
                self.prefill.park_handoff(waiter)
            return


__all__ = ["DisaggregatedEngine", "KVHandoff"]
