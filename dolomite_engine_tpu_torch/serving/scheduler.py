"""Request queue + continuous-batching scheduler (Orca-style iteration-level scheduling).

(Copy of `dolomite_engine_tpu/serving/scheduler.py`, with sampling from the port and a
request's random stream named by an integer seed. Its generator's state after the last
draw whose tokens were delivered rides on the `RequestState` (``rng_state``), which is what
a surviving replica continues a migrated sampled stream from; the JAX package re-derives
its carry from the request key and ``rng_steps`` instead.)

Requests enter a bounded waiting queue (`submit`) ordered by **priority tier, then
submission order**: tier 0 is the most important; within a tier the queue is FCFS by a
monotone sequence number assigned once at submit and kept across preemption re-enqueues,
so a preempted request resumes at its FCFS position instead of skipping ahead of
earlier same-tier arrivals (and a re-enqueued low-tier request can never block a
higher-tier head). At every engine step boundary the scheduler hands the engine the next
admissible requests (`pop_next`/`admissible`), the engine runs each through a
length-bucketed prefill, and the slot joins the shared decode step.

Tiers can carry **SLO targets** (`TierSLO`): a TTFT target orders the chunked-prefill
budget (least headroom first) and an ITL target feeds per-tier telemetry. Deadlines stay
wall-clock: a request that exceeds its budget is rejected while waiting or cancelled
mid-decode, freeing its slot for the queue.

This module is pure host-side bookkeeping. Shapes and device programs are the engine's
problem; the scheduler only decides *which* request occupies *which* slot *when*.
"""

from __future__ import annotations

import enum
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ..ops.sampling import encode_sampling_params


class QueueFullError(RuntimeError):
    """Raised by submit when the waiting queue is at its bound (admission control —
    callers shed load or retry; the engine never buffers unboundedly)."""


class RequestStatus(str, enum.Enum):
    waiting = "waiting"
    running = "running"
    completed = "completed"
    cancelled = "cancelled"  # deadline exceeded (waiting or mid-decode)

    def __str__(self) -> str:  # plain value in logs/records
        return self.value


@dataclass
class SamplingParams:
    """Per-request sampling settings (the per-slot vectorized decode consumes the dense
    encoding; `None` means the processor is off, matching `ops/sampling.sample_token`)."""

    do_sample: bool = False
    temperature: float | None = None
    top_k: int | None = None
    top_p: float | None = None

    def encoded(self) -> tuple[bool, float, int, float]:
        return encode_sampling_params(self.do_sample, self.temperature, self.top_k, self.top_p)


@dataclass
class TierSLO:
    """Per-tier latency targets (docs/SERVING.md "Scheduling under contention").

    ``ttft_target_s`` orders the chunked-prefill budget (least headroom first) and is
    the per-tier p99 the overload bench asserts against; ``itl_target_s`` is recorded
    next to the measured per-tier inter-token latency in serving telemetry. ``None``
    means "no target" — the tier competes on priority alone.
    """

    ttft_target_s: float | None = None
    itl_target_s: float | None = None


@dataclass
class Request:
    """One generation request: prompt tokens in, streamed tokens out."""

    prompt_ids: list[int]
    max_new_tokens: int
    sampling: SamplingParams = field(default_factory=SamplingParams)
    eos_token_id: int | None = None
    seed: int | None = None  # seeds the request's sampling generator; engine derives one when None
    deadline_s: float | None = None  # wall-clock budget from submit time
    on_token: Callable[[int], None] | None = None  # streaming callback, one call per token
    on_finish: Callable[["RequestState"], None] | None = None
    request_id: int = -1  # assigned at submit
    # priority tier: 0 is the most important; admission and the prefill budget are
    # ordered tier-then-FCFS, and preemption only ever evicts a strictly lower tier
    priority: int = 0
    # multi-turn session key: finished requests pin their prefix pages under this id
    # (exempt from LRU eviction until the session's TTL lapses) and routers keep
    # replica affinity for it (serving/prefix_cache.py, serving/cluster/router.py)
    session_id: str | None = None


@dataclass
class RequestState:
    """Lifecycle record the engine fills in as the request moves through the system."""

    request: Request
    status: RequestStatus = RequestStatus.waiting
    tokens: list[int] = field(default_factory=list)
    slot: int | None = None
    submit_t: float = 0.0
    first_token_t: float | None = None
    finish_t: float | None = None
    seq: int = -1  # FCFS position within the tier, assigned once at submit
    preemptions: int = 0  # times this request was evicted mid-flight and re-enqueued
    resume: Any = None  # engine-private preemption context (swap payload, generator state)
    # draws consumed for this request's sample stream (1 at the sampling prefill chunk, +1
    # per decode / verify step it took part in): the JAX package's counter, kept for the
    # records; the port continues a migrated stream from `rng_state`
    rng_steps: int = 0
    # the sampling generator's state (host bytes: a CUDA generator keeps its seed and
    # offset on the host) after the last draw whose tokens were delivered; None for a
    # greedy request or before its first token. `ServingEngine.adopt_inflight` continues a
    # migrated request's stream from it, with nothing read from the replica that died
    rng_state: Any = None
    # times this request was migrated to another replica after a crash or a drain (the
    # `reroute` trace span carries the per-hop detail)
    reroutes: int = 0
    # the per-request trace (utils/tracing.RequestTrace) when tracing is on; None is the
    # free default: every instrumentation site is one `is not None` check. The state
    # carries the trace across every seam (router -> engine, preemption re-enqueue, the
    # disaggregated prefill -> decode handoff), so a request's lifecycle is one tree
    trace: Any = None

    @property
    def tier(self) -> int:
        return self.request.priority

    @property
    def preempted(self) -> bool:
        return self.preemptions > 0

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def num_generated(self) -> int:
        return len(self.tokens)

    @property
    def done(self) -> bool:
        return self.status in (RequestStatus.completed, RequestStatus.cancelled)


class Scheduler:
    """Bounded tier-then-FCFS admission over a slot pool.

    The engine drives it: `submit` enqueues (or raises `QueueFullError`), `pop_next`
    hands out the highest-tier FCFS head, `push_front` returns a popped/preempted
    request to its *seq-ordered* position within its own tier, `admissible` batches
    pops for the dense pool, and `queue_depth` feeds telemetry.
    """

    def __init__(
        self,
        max_waiting: int = 128,
        clock: Callable[[], float] = time.monotonic,
        prefill_chunk_tokens: int = 512,
        tier_slos: dict[int, TierSLO] | None = None,
    ):
        assert max_waiting > 0
        if prefill_chunk_tokens <= 0 or prefill_chunk_tokens % 8 != 0:
            raise ValueError(
                f"prefill_chunk_tokens must be a positive multiple of 8, got "
                f"{prefill_chunk_tokens}"
            )
        self.max_waiting = max_waiting
        # per-engine-step prefill token budget (chunked prefill): long prompts are
        # computed `prefill_chunk_tokens` at a time, interleaved with decode steps, so a
        # long arrival cannot stall the inter-token latency of running requests
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.clock = clock
        self.tier_slos: dict[int, TierSLO] = dict(tier_slos or {})
        # tier -> seq-ordered waiting deque; tiers are scanned in ascending order so
        # tier 0 always pops first, and a re-enqueued request never crosses tiers
        self._tiers: dict[int, deque[RequestState]] = {}
        self._ids = itertools.count()
        self._seq = itertools.count()

    @property
    def waiting(self) -> list[RequestState]:
        """Waiting requests in pop order (tier ascending, then seq) — a read-only view;
        mutate through submit/pop_next/push_front."""
        return [state for tier in sorted(self._tiers) for state in self._tiers[tier]]

    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._tiers.values())

    def queue_depth_by_tier(self) -> dict[int, int]:
        """Non-empty tiers -> waiting count (the per-tier queue-depth gauges)."""
        return {tier: len(q) for tier, q in sorted(self._tiers.items()) if q}

    def slo(self, tier: int) -> TierSLO:
        return self.tier_slos.get(tier, _NO_SLO)

    def ttft_headroom(self, state: RequestState, now: float | None = None) -> float | None:
        """Seconds left before `state` misses its tier's TTFT target (negative =
        already missed; None = the tier has no target). Within a tier every request
        shares one target, so FCFS order IS headroom order; across tiers the engine
        uses this to order the chunked-prefill budget."""
        target = self.slo(state.tier).ttft_target_s
        if target is None:
            return None
        return target - ((self.clock() if now is None else now) - state.submit_t)

    def prefill_budget(self, decode_tokens: int) -> int:
        """Prefill token budget for THIS step, with decode's token compute counted
        against the shared per-step budget. Plain decode bills 1 token per active slot;
        speculative decoding bills the whole verify window (K+1 tokens per slot) — the
        verify step really does compute K+1 positions, so a step that verifies a lot
        prefills less and the inter-token latency of running requests stays bounded as
        speculation scales up. Floored at one 8-token lane so arrivals always make
        progress even when decode alone exceeds `prefill_chunk_tokens`."""
        return max(8, self.prefill_chunk_tokens - max(0, int(decode_tokens)))

    def submit(self, request: Request) -> RequestState:
        if self.queue_depth >= self.max_waiting:
            raise QueueFullError(
                f"waiting queue is full ({self.max_waiting}); retry after the pool drains"
            )
        if request.priority < 0:
            raise ValueError(f"priority must be >= 0 (0 is the top tier), got {request.priority}")
        request.request_id = next(self._ids)
        state = RequestState(request=request, submit_t=self.clock(), seq=next(self._seq))
        self._tiers.setdefault(request.priority, deque()).append(state)
        return state

    def adopt(self, state: RequestState) -> None:
        """Enqueue a request state migrated from ANOTHER scheduler (cross-replica
        re-routing after a crash or drain). The state keeps its original ``seq`` —
        its FCFS age — so migrated work re-enters at roughly its arrival position
        instead of queueing behind newer local arrivals; ``request_id`` is kept too
        (it names the request in traces and telemetry fleet-wide). Bounded exactly
        like `submit`: the router's retry budget handles a full destination."""
        if self.queue_depth >= self.max_waiting:
            raise QueueFullError(
                f"waiting queue is full ({self.max_waiting}); retry after the pool drains"
            )
        self.push_front(state)

    def expired(self, state: RequestState) -> bool:
        deadline = state.request.deadline_s
        return deadline is not None and (self.clock() - state.submit_t) > deadline

    def pop_next(self) -> RequestState | None:
        """Pop the highest-tier FCFS head (deadline checks are the caller's job — the
        paged engine needs to weigh page availability before committing, see
        `push_front`)."""
        for tier in sorted(self._tiers):
            queue = self._tiers[tier]
            if queue:
                return queue.popleft()
        return None

    def peek_next(self) -> RequestState | None:
        """The request `pop_next` would return, without removing it."""
        for tier in sorted(self._tiers):
            queue = self._tiers[tier]
            if queue:
                return queue[0]
        return None

    def push_front(self, state: RequestState) -> None:
        """Return a popped request to its tier's queue at its stable FCFS position
        (ordered by the seq assigned at submit). Covers both the paged engine's "not
        enough pages yet" rollback and preemption re-enqueue: a re-enqueued request
        keeps its original arrival order — it neither skips ahead of earlier same-tier
        arrivals nor blocks a higher tier (its queue is per-tier)."""
        queue = self._tiers.setdefault(state.request.priority, deque())
        for index, other in enumerate(queue):
            if other.seq > state.seq:
                queue.insert(index, state)
                return
        queue.append(state)

    def admissible(self, free_slots: int) -> tuple[list[RequestState], list[RequestState]]:
        """Pop up to `free_slots` requests tier-then-FCFS. Returns (admit, expired):
        requests whose deadline lapsed while waiting are popped too — cancelled, not
        admitted — so a stale head never blocks the queue."""
        admit: list[RequestState] = []
        dead: list[RequestState] = []
        while len(admit) < free_slots:
            state = self.pop_next()
            if state is None:
                break
            (dead if self.expired(state) else admit).append(state)
        return admit, dead


_NO_SLO = TierSLO()
