"""Continuous-batching serving engine over the paged or the dense KV pool.

Counterpart of `dolomite_engine_tpu/serving/engine.py`. The default, ``paged=True``:

- the KV cache is a **paged pool** (`kv_cache.PagedKVCachePool`): fixed-size pages
  shared across slots, per-slot page tables, page 0 as the trash page;
- **prefix caching** (`prefix_cache.PrefixCache`): resident page-aligned prompt prefixes
  are attached read-only; a partially matching tail page is copied (COW) and only the
  miss suffix is computed;
- **chunked prefill**: prompts are computed ``prefill_chunk_tokens`` at a time,
  interleaved with decode steps; the final chunk samples the first token, and its host
  fetch ends the request's TTFT;
- **decode** is one forward over the whole ``[num_slots]`` batch with per-slot frontiers,
  page-table rows and sampling params; idle and mid-prefill rows get a zeroed table row
  and length 0, so their writes land in the trash page.
- a **quantized pool** (``kv_dtype="int8"|"fp8"``) rides the same per-layer dicts: each
  step's dict carries the layer's ``k_scale`` / ``v_scale`` pools beside its pages;
- **speculative decoding** (``speculate_ngram=True``, or ``draft_model=``): a drafter
  (`speculation.py`) proposes up to K tokens per slot and one verify forward scores the
  ``[num_slots, K+1]`` window at each row's frontier (the paged decode kernel at W = K+1);
  `ops/sampling.speculative_accept` commits the accepted drafts and a bonus token. The
  frontier advances only past committed K/V, so rejected tails stay masked until the
  next window overwrites them. Greedy outputs are those of plain decode;
- **preemption** (``preemption="swap"|"recompute"``) evicts a strictly lower tier when a
  higher-tier request cannot admit, and the lowest priority when an oversubscribed pool
  (``oversubscribe_ratio`` > 1) runs physically dry: swap parks the victim's pages in
  host memory (`kv_cache.HostSwapPool`), recompute registers them in the prefix cache
  and re-prefills what was evicted. A resumed request continues where it stopped, its
  generator's state restored, so its tokens are those of an unpreempted run.

``paged=False`` keeps the JAX engine's A/B baseline, the **dense slot pool**
(`kv_cache.SlotKVCachePool`, ``[num_slots, max_len]`` rows per layer): a request's whole
prompt is one prefill forward, right-padded to its bucket (a multiple of
``prefill_bucket_multiple``, at most ``max_len``), into a fresh ``[1, bucket]`` cache at
the python-int index 0 (the attention layer's prefill fast path), copied into the slot;
its first token is sampled at the prompt's last position and its host fetch ends the
TTFT. Decode is one forward over every slot with per-row positions, write offsets and
frontiers; an idle slot has length 0. Prefix caching and the chunked-prefill budget do
not apply to it, as in the JAX engine.

Attention, RMSNorm and rope inside the forward run the port's CUDA kernels on the GPU
(`ops/kernels/`). PyTorch runs eagerly, so there is no compiled program to count (the JAX
engine's ``decode_compiles``, ``verify_compiles``, ``draft_compiles`` and
``chunk_compiles`` have no counterpart); greedy outputs match the JAX engine token for
token (tests/test_torch_serving.py, tests/test_torch_speculation.py,
tests/test_torch_preemption.py). Sampled requests draw from a per-slot `torch.Generator`
seeded from the request, so their streams differ from the JAX engine's by design.

The fleet rides on the same engine (`serving/cluster/`): ``prefill_only`` parks finished
prefills for a KV page handoff to a decode engine (`take_ready_handoffs`,
`handoff_payload`, `adopt_prefilled`, `release_handoff`); `release_inflight` /
`adopt_inflight` migrate a dead replica's requests, a sampled one continuing from the
generator state its `RequestState` carries (``rng_state``); `swap_params` gives one
replica new weights without touching a module other engines share. The JAX engine's
telemetry counters, observations and ``serving`` records are written at the same sites,
and ``trace_requests`` opens the same spans under the same names. A span that ends with
device work ends after the host fetch (or sync) that ends that work, so it times the
card, not the enqueue. With tracing off, no telemetry installed and no monitor or
recorder, the engine makes no extra launch, sync or record.

Options of the JAX engine that this port does not carry yet raise NotImplementedError
naming the ROADMAP.md item that will port them. A model whose caches are not all ``{k, v}``
K/V caches (the DeltaNet hybrid's recurrent ones) raises ValueError, since the pools hold
nothing else; the JAX engine fails on them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..ops.sampling import sample_tokens_vectorized, speculative_accept
from ..utils.telemetry import QuantileSketch, get_telemetry, kernel_paths
from ..utils.tracing import RequestTrace
from .kv_cache import TRASH_PAGE, HostSwapPool, PagedKVCachePool, SlotKVCachePool
from .prefix_cache import PrefixCache, PrefixMatch
from .speculation import DraftModelDrafter, NgramDrafter
from .scheduler import (
    QueueFullError,
    Request,
    RequestState,
    RequestStatus,
    SamplingParams,
    Scheduler,
    TierSLO,
)

_DEFAULT = object()  # "use the engine default" sentinel for per-request eos overrides

# constructor options of the JAX engine not ported yet -> (inert value, ROADMAP.md item)
_NOT_PORTED = {
    "mesh": (None, "Distribution"),
    "sharding_rules": (None, "Distribution"),
    "signature_records": (False, "Serving fleet and observability"),
}


@dataclass
class EngineStats:
    """Cumulative host-side accounting (the JAX engine's `EngineStats`).

    `prefill_seconds`/`decode_seconds` are wall time of the device work including the
    host fetch that ends it; `prefill_tokens` counts prompt tokens actually computed
    (prefix-cache hits show up in `prefix_hit_tokens` instead); `decode_tokens` counts
    tokens emitted by decode steps; `prefill_chunks` counts prefill forwards (a paged
    chunk, or a dense pool's whole prompt: each one model forward, like each decode
    step). The first token of each request is sampled inside prefill and shows up in
    `ttft_s`, not in either rate. With speculation a decode step is a verify step and
    `decode_tokens` counts the accepted drafts and bonus tokens it emitted."""

    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    decode_steps: int = 0
    prefill_chunks: int = 0
    ttft_s: QuantileSketch = field(default_factory=QuantileSketch)
    admitted: int = 0
    completed: int = 0
    rejected: int = 0
    cancelled: int = 0
    prefix_hit_tokens: int = 0
    prefix_miss_tokens: int = 0
    peak_active: int = 0
    draft_tokens_proposed: int = 0
    draft_tokens_accepted: int = 0
    # slot evictions (swap or drop-and-recompute) and page moves through the host pool
    preemptions: int = 0
    pages_swapped_out: int = 0
    pages_swapped_in: int = 0
    session_hits: int = 0
    ttft_s_by_tier: dict[int, QuantileSketch] = field(default_factory=dict)
    itl_s_by_tier: dict[int, QuantileSketch] = field(default_factory=dict)
    admitted_by_tier: dict[int, int] = field(default_factory=dict)
    completed_by_tier: dict[int, int] = field(default_factory=dict)
    preempted_by_tier: dict[int, int] = field(default_factory=dict)

    def prefill_tok_s(self) -> float | None:
        if self.prefill_seconds <= 0:
            return None
        return self.prefill_tokens / self.prefill_seconds

    def decode_tok_s(self) -> float | None:
        if self.decode_seconds <= 0:
            return None
        return self.decode_tokens / self.decode_seconds

    def mean_ttft_s(self) -> float | None:
        return self.ttft_s.mean()

    def prefix_hit_rate(self) -> float | None:
        total = self.prefix_hit_tokens + self.prefix_miss_tokens
        if total == 0:
            return None
        return self.prefix_hit_tokens / total

    def accept_rate(self) -> float | None:
        """Share of proposed draft tokens the target accepted (speculation only)."""
        if self.draft_tokens_proposed == 0:
            return None
        return self.draft_tokens_accepted / self.draft_tokens_proposed

    def accepted_tokens_per_step(self) -> float | None:
        """Mean accepted draft tokens per verify step; a step emits this + 1 tokens a
        slot (the bonus token)."""
        if self.decode_steps == 0:
            return None
        return self.draft_tokens_accepted / self.decode_steps

    def ttft_p99_s(self, tier: int) -> float | None:
        sketch = self.ttft_s_by_tier.get(tier)
        return None if sketch is None else sketch.quantile(0.99)

    def itl_mean_s(self, tier: int) -> float | None:
        sketch = self.itl_s_by_tier.get(tier)
        return None if sketch is None else sketch.mean()


@dataclass
class _ResumeState:
    """The decode context captured at preemption, what it takes to continue the request
    token for token: ``next_token`` is the last emitted token, not yet in the cache, that
    the next step feeds; ``generator_state`` the slot's generator state (None for a greedy
    request; the JAX engine re-derives its rng carry instead); ``resident`` how many
    positions were in the pool. ``swapped``: the pages are parked in the host swap pool
    (restore is a byte copy); otherwise ``(prompt + tokens)[:resident]`` is recomputed
    through the prefix cache and chunked prefill."""

    next_token: int
    generator_state: torch.Tensor | None
    resident: int
    swapped: bool


@dataclass
class _PrefillTask:
    """A slot whose prefix is still being computed (chunked prefill in flight):
    ``prefill_ids`` is the prompt of a fresh request, or ``(prompt + generated)
    [:resident]`` of a drop-and-recompute resume, whose final chunk restores the decode
    context instead of sampling a first token."""

    state: RequestState
    pos: int  # next position to compute (prefix-cache hits start it past 0)
    prefill_ids: list[int]
    resume: _ResumeState | None = None


def _load_weights(model: Any, params: Any, device: torch.device) -> None:
    """Fill `model` from `params`: None (it holds its weights) or the JAX package's params
    tree (numpy, `load_jax_params`)."""
    if params is None:
        return
    from ..models.gpt_dolomite import load_jax_params

    load_jax_params(model, params, device=device)


def _jax_params_state_dict(model: Any, params: Any, device: torch.device) -> dict[str, torch.Tensor]:
    """The JAX package's params tree (numpy) as a state dict of `model`'s names, loaded into
    a copy of the model (its buffers too), so the model itself keeps its weights."""
    import copy

    from ..models.gpt_dolomite import load_jax_params

    shadow = copy.deepcopy(model)
    load_jax_params(shadow, params, device=device)
    return dict(shadow.state_dict())


class ServingEngine:
    """Drive a causal LM of the port (`models/`) as a continuously batched token service
    on the paged KV pool, or with ``paged=False`` on the dense slot pool.

    Args:
        model: any of the port's causal LMs (`GPTDolomiteForCausalLM`,
            `MoEDolomiteForCausalLM`, ...: `models.get_model_class`).
        params: None when the model already holds its weights, or the JAX package's
            unrolled params tree as numpy arrays (loaded with `load_jax_params`).
        num_slots: decode batch width == max concurrent requests.
        max_len: per-slot cache length; every request needs
            ``len(prompt) + max_new_tokens <= max_len``.
        prefill_bucket_multiple: prefill chunks (a dense pool's whole prompts) are
            right-padded to the next multiple.
        max_waiting: waiting-queue bound (`submit` raises QueueFullError beyond it).
        eos_token_id / pad_token_id: engine defaults (per-request eos override on submit).
        cache_dtype: page dtype (default the model dtype).
        seed: seeds the per-request generators of requests submitted without a seed.
        paged: the paged pool (default) or the dense slot pool; the paged-only options
            below (``page_size`` to ``prefix_caching``) do nothing for a dense pool, and
            ``kv_dtype`` and preemption raise ValueError with it.
        page_size: tokens per KV page (positive multiple of 8).
        num_pages: physical pages in the pool (page 0 is the trash page); the default
            matches a dense pool's capacity.
        kv_dtype: page storage (`kv_cache.KV_DTYPES`): None (``cache_dtype``, else the
            model dtype), ``"bf16"``, or the quantized ``"int8"`` / ``"fp8"`` (codes with
            per-(page, kv head) fp32 scale pools).
        prefill_chunk_tokens: per-step prefill token budget (positive multiple of 8).
        prefix_caching: share resident page-aligned prefixes across requests.
        preemption: what happens to a lower-tier slot when a higher-tier request cannot
            admit, or when an oversubscribed pool runs physically dry: ``"off"`` (never
            evict), ``"swap"`` (park the victim's pages in host memory and restore them
            byte-identical) or ``"recompute"`` (register its pages in the prefix cache,
            release them and rebuild the slot through chunked prefill). Paged only.
        oversubscribe_ratio: admission may promise up to ``ratio * allocatable`` pages
            (>= 1.0); above 1.0 it needs preemption to reclaim the shortfall.
        session_ttl_s / tier_slos: multi-turn pinning and per-tier TTFT ordering, as in
            the JAX engine.
        speculate_ngram: n-gram / prompt-lookup self-drafting of up to `draft_k` tokens a
            slot (host code, no extra model).
        draft_model / draft_params: a smaller model of the same vocabulary that drafts
            `draft_k` greedy tokens a slot, and its weights as `params` takes them. A
            model of the port holds its weights, so the JAX engine's "draft_model requires
            draft_params" has no counterpart. Exclusive with `speculate_ngram`.
        draft_k: draft tokens a verify step scores per slot (K >= 1; the window is K+1).
        record_interval: write a ``serving`` telemetry record every N decode steps (0: only
            at `drain`).
        replica_id: stamped on every ``serving`` record and trace span: which replica of a
            router fleet (`serving/cluster/router.py`) it is. None: standalone.
        prefill_only: run as a disaggregation prefill worker (paged only): requests are
            admitted and chunk-prefilled, the first token streams out, and the finished
            prefill parks for `take_ready_handoffs` instead of decoding; a decode engine
            adopts its K/V pages through `serving/cluster/disagg.KVHandoff`.
        trace_requests: every submitted request carries a span tree (`utils/tracing.py`)
            and emits one ``trace`` record at its finish. Off by default, and then no trace
            object exists and nothing extra is written.
        slo_monitor: a `utils/diagnostics.ServingSLOMonitor` fed once a step.
        flight_recorder: a `utils/diagnostics.FlightRecorder` that gets one entry a step and
            is dumped when a step raises.
        device: where the model and pool live; the GPU unless ``"cpu"`` is asked for.

    Engines built over one model share its weights (a second replica adds only its pool);
    `swap_params` gives this engine weights of its own without touching the others.
    """

    def __init__(
        self,
        model: Any,
        params: Any = None,
        *,
        num_slots: int,
        max_len: int,
        prefill_bucket_multiple: int = 64,
        max_waiting: int = 128,
        eos_token_id: int | None = None,
        pad_token_id: int = 0,
        cache_dtype: torch.dtype | None = None,
        seed: int = 0,
        clock=time.monotonic,
        paged: bool = True,
        page_size: int = 16,
        num_pages: int | None = None,
        kv_dtype: str | None = None,
        prefill_chunk_tokens: int = 512,
        prefix_caching: bool = True,
        preemption: str = "off",
        oversubscribe_ratio: float = 1.0,
        session_ttl_s: float = 300.0,
        tier_slos: dict[int, TierSLO] | None = None,
        speculate_ngram: bool = False,
        draft_model: Any = None,
        draft_params: Any = None,
        draft_k: int = 4,
        record_interval: int = 0,
        replica_id: int | None = None,
        prefill_only: bool = False,
        trace_requests: bool = False,
        slo_monitor: Any = None,
        flight_recorder: Any = None,
        device: str | torch.device = "cuda",
        **not_ported: Any,
    ) -> None:
        self.device = resolve_device(device)
        cache_keys = sorted({key for cache in model.init_kv_caches(1, 1) if "k" not in cache for key in cache})
        if cache_keys:
            raise ValueError(
                f"{model.config.model_type} does not serve through ServingEngine: it keeps caches "
                f"{cache_keys} where the engine's paged and dense pools hold only {{k, v}} K/V caches "
                "(the JAX engine fails on such recurrent caches); decode it with "
                "generation_utils.generate_tokens (ModelWrapper.generate)"
            )
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"ServingEngine got an unexpected keyword argument {name!r}")
            inert, item = _NOT_PORTED[name]
            if value != inert:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet: ROADMAP.md Queue A, '{item}'"
                )
        if prefill_only and not paged:
            raise ValueError("prefill_only (disaggregation) requires the paged KV pool")
        if kv_dtype is not None and not paged:
            raise ValueError("kv_dtype (quantized / low-bit KV) requires the paged KV pool")
        if prefill_only and (speculate_ngram or draft_model is not None):
            raise ValueError("prefill_only workers do not decode, so cannot speculate")
        if preemption not in ("off", "swap", "recompute"):
            raise ValueError(
                f"preemption must be 'off', 'swap', or 'recompute', got {preemption!r}"
            )
        if preemption != "off" and not paged:
            raise ValueError("preemption requires the paged KV pool")
        if preemption != "off" and prefill_only:
            raise ValueError(
                "prefill_only workers park finished prefills for handoff and never "
                "contend on decode pages; run them with preemption='off'"
            )
        if oversubscribe_ratio < 1.0:
            raise ValueError(
                f"oversubscribe_ratio must be >= 1.0, got {oversubscribe_ratio}"
            )
        if oversubscribe_ratio > 1.0 and preemption == "off":
            raise ValueError(
                "oversubscribe_ratio > 1.0 reserves pages that are not physically "
                "backed; that is only safe with preemption enabled ('swap' or "
                "'recompute')"
            )
        if session_ttl_s <= 0:
            raise ValueError(f"session_ttl_s must be positive, got {session_ttl_s}")
        if prefill_bucket_multiple <= 0 or prefill_bucket_multiple % 8 != 0:
            raise ValueError(
                f"prefill_bucket_multiple must be a positive multiple of 8, got "
                f"{prefill_bucket_multiple}"
            )
        if speculate_ngram and draft_model is not None:
            raise ValueError(
                "speculate_ngram and draft_model are mutually exclusive draft sources"
            )
        if (speculate_ngram or draft_model is not None) and draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        n_positions = getattr(model.config, "n_positions", None)
        if n_positions is not None and max_len > n_positions:
            raise ValueError(f"max_len={max_len} exceeds model n_positions={n_positions}")

        _load_weights(model, params, self.device)
        # `.to` of a module already on the device returns it: engines over one model share it
        self.model = model.to(self.device).eval()
        # weights of this engine's own (`swap_params`), applied over the shared module
        self._params: dict[str, torch.Tensor] | None = None
        self.record_interval = record_interval
        self.replica_id = replica_id
        self.prefill_only = prefill_only
        self.trace_requests = trace_requests
        # the observability hooks: each is one `is None` check when off
        self.slo_monitor = slo_monitor
        self.flight_recorder = flight_recorder
        # which path the chunked prefill's attention takes, stamped on prefill_chunk spans
        self._prefill_backend = "cuda" if self.device.type == "cuda" else "plain"
        # admission-attempt scratch (valid while tracing the head's admission): the pop's
        # time and the victims evicted on the head's behalf in this attempt
        self._admit_t0: float | None = None
        self._admit_victims = 0
        # prefill_only: finished prefills parked here (slot and pages resident) until a
        # decode engine adopts their K/V (serving/cluster/disagg.py)
        self._ready_handoffs: list[RequestState] = []
        self._step_count = 0  # decode / verify steps, the records' step clock
        self._last_record_step = 0
        self.default_eos = eos_token_id
        self.pad_token_id = pad_token_id
        self.prefill_bucket_multiple = prefill_bucket_multiple
        self.session_ttl_s = session_ttl_s
        self.paged = paged
        self.preemption = preemption
        if paged:
            self.pool: Any = PagedKVCachePool(
                model, num_slots, max_len, page_size, num_pages, cache_dtype, kv_dtype=kv_dtype,
                oversubscribe_ratio=oversubscribe_ratio,
            )
            self.prefix = PrefixCache(page_size) if prefix_caching else None
            self._swap = HostSwapPool(self.pool) if preemption == "swap" else None
        else:
            self.pool = SlotKVCachePool(model, num_slots, max_len, cache_dtype)
            self.prefix = None
            self._swap = None
        self.scheduler = Scheduler(
            max_waiting=max_waiting, clock=clock, prefill_chunk_tokens=prefill_chunk_tokens,
            tier_slos=tier_slos,
        )
        self.stats = EngineStats()
        self._seeds = torch.Generator().manual_seed(seed)

        num = self.pool.num_slots
        # dense per-slot state, host-resident (mutated at admission/finish, shipped to the
        # decode forward each step)
        self._tokens = np.zeros(num, np.int64)
        self._generators: list[torch.Generator | None] = [None] * num
        self._do_sample = np.zeros(num, bool)
        self._temperature = np.ones(num, np.float32)
        self._top_k = np.zeros(num, np.int32)
        self._top_p = np.ones(num, np.float32)
        self._slot_states: dict[int, RequestState] = {}
        # chunked prefill in flight: per-slot progress
        self._prefill_tasks: dict[int, _PrefillTask] = {}
        self._prefill_order: list[int] = []

        # speculative decoding: a drafter, and the verify step in place of decode
        self.speculating = bool(speculate_ngram or draft_model is not None)
        self.draft_k = draft_k
        self._ngram = NgramDrafter(draft_k) if speculate_ngram else None
        self._draft = None
        if draft_model is not None:
            _load_weights(draft_model, draft_params, self.device)
            self._draft = DraftModelDrafter(
                draft_model.to(self.device).eval(), num_slots=num, max_len=max_len, draft_k=draft_k,
                pad_token_id=pad_token_id, prefill_bucket_multiple=prefill_bucket_multiple,
                cache_dtype=cache_dtype,
            )

    # ------------------------------------------------------------------ submission

    def submit(
        self,
        prompt_ids: list[int],
        max_new_tokens: int,
        sampling: SamplingParams | None = None,
        eos_token_id: int | None = _DEFAULT,
        deadline_s: float | None = None,
        on_token=None,
        on_finish=None,
        seed: int | None = None,
        priority: int = 0,
        session_id: str | None = None,
        trace: RequestTrace | None = None,
    ) -> RequestState:
        """Enqueue a request (tier-then-FCFS; ``priority`` 0 is the top tier). `seed`
        seeds the request's sampling generator (drawn from the engine's when None);
        `trace` continues a trace a router opened. Raises QueueFullError at the queue
        bound and ValueError when the request cannot fit a slot."""
        prompt_ids = list(map(int, prompt_ids))
        if not prompt_ids:
            raise ValueError("empty prompt")
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be positive, got {max_new_tokens}")
        if priority < 0:
            raise ValueError(f"priority must be >= 0 (0 is the top tier), got {priority}")
        if len(prompt_ids) + max_new_tokens > self.pool.max_len:
            raise ValueError(
                f"request needs {len(prompt_ids)} prompt + {max_new_tokens} new tokens "
                f"> max_len={self.pool.max_len}"
            )
        if self.paged:
            worst_pages = -(-(len(prompt_ids) + max_new_tokens) // self.pool.page_size)
            if worst_pages > self.pool.num_pages - 1:
                raise ValueError(
                    f"request needs {worst_pages} page(s) worst-case but the pool has "
                    f"{self.pool.num_pages - 1} allocatable page(s)"
                )
        if seed is None:
            seed = int(torch.randint(2**62, (1,), generator=self._seeds))
        request = Request(
            prompt_ids=prompt_ids,
            max_new_tokens=int(max_new_tokens),
            sampling=sampling or SamplingParams(),
            eos_token_id=self.default_eos if eos_token_id is _DEFAULT else eos_token_id,
            seed=int(seed),
            deadline_s=deadline_s,
            on_token=on_token,
            on_finish=on_finish,
            priority=int(priority),
            session_id=session_id,
        )
        try:
            state = self.scheduler.submit(request)
        except (QueueFullError, ValueError):
            self.stats.rejected += 1
            get_telemetry().count("serving_requests_rejected")
            raise
        if trace is None and self.trace_requests:
            trace = RequestTrace(request_id=request.request_id, clock=self.scheduler.clock)
        if trace is not None:
            state.trace = trace
            trace.request_id = request.request_id
            root = trace.ensure_root(
                t0=state.submit_t,
                tier=request.priority,
                prompt_tokens=len(prompt_ids),
                max_new_tokens=request.max_new_tokens,
                replica_id=self.replica_id,
            )
            trace.open["queue_wait"] = trace.begin(
                "queue_wait", parent=root, t0=state.submit_t, tier=request.priority, segment=0
            )
        return state

    # ------------------------------------------------------------------ engine loop

    def has_work(self) -> bool:
        """Whether stepping can make progress. Parked handoffs (prefill_only) are not:
        a decode engine has to adopt them, so a prefill worker holding only parked slots
        is idle."""
        if self.scheduler.queue_depth > 0:
            return True
        if not self._ready_handoffs:
            return bool(self._slot_states)
        parked = {state.slot for state in self._ready_handoffs}
        return any(slot not in parked for slot in self._slot_states)

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration: reap deadline-expired slots, admit waiting requests
        into free slots (a dense pool prefills them whole; with preemption on, lower
        tiers are evicted for a blocked head), advance chunked prefills up to the budget
        (paged), run one decode or verify step over the slot batch. Returns whether any
        work remains.

        The observability hooks ride on the end of the step: its wall time goes to the
        registry's step-time sketch (in memory, no record), the flight recorder gets one
        entry (and a dump if the step raised), and the SLO monitor observes the engine."""
        t0 = time.perf_counter()
        try:
            self._step_once()
        except Exception as error:
            if self.flight_recorder is not None:
                from ..utils.diagnostics import crash_reason

                self.flight_recorder.record(
                    self._step_count,
                    replica_id=self.replica_id,
                    queue_depth=self.scheduler.queue_depth,
                    slots_active=self.pool.num_active,
                    error=repr(error),
                )
                self.flight_recorder.dump(crash_reason(error), error=error)
            raise
        get_telemetry().observe("serving/step_s", time.perf_counter() - t0)
        if self.flight_recorder is not None:
            self.flight_recorder.record(
                self._step_count,
                replica_id=self.replica_id,
                queue_depth=self.scheduler.queue_depth,
                slots_active=self.pool.num_active,
                completed=self.stats.completed,
                preemptions=self.stats.preemptions or None,
            )
        if self.slo_monitor is not None:
            self.slo_monitor.observe_engine(self)
        if self.record_interval and self._step_count - self._last_record_step >= self.record_interval:
            self.emit_serving_record()
        return self.has_work()

    def _step_once(self) -> None:
        self._cancel_expired_running()
        if self.paged:
            self._admit_paged()
            if self.prefill_only:
                # no decode competes for the budget; parked handoff slots never decode
                self._run_prefill_chunks(self.scheduler.prefill_chunk_tokens)
                self.stats.peak_active = max(self.stats.peak_active, self.pool.num_active)
                return
            # decode's computed tokens count against the step's prefill budget: a plain
            # decode 1 a decoding slot, a verify step K+1 (it scores the whole window)
            decoding = sum(1 for s in self._slot_states if s not in self._prefill_tasks)
            per_slot = self.draft_k + 1 if self.speculating else 1
            self._run_prefill_chunks(self.scheduler.prefill_budget(per_slot * decoding))
            if any(slot not in self._prefill_tasks for slot in self._slot_states):
                if self.speculating:
                    self._verify_once_paged()
                else:
                    self._decode_once_paged()
        else:
            self._admit()
            if self._slot_states:
                if self.speculating:
                    self._verify_once_dense()
                else:
                    self._decode_once()
        self.stats.peak_active = max(self.stats.peak_active, self.pool.num_active)

    def drain(self) -> None:
        """Run until every submitted request finished; write a final ``serving`` record."""
        while self.step():
            pass
        self.emit_serving_record()

    def _forward(self, *args: Any, **kwargs: Any):
        """The model's forward, over this engine's own weights after `swap_params`."""
        if self._params is None:
            return self.model(*args, **kwargs)
        return torch.func.functional_call(self.model, self._params, args, kwargs)

    # ------------------------------------------------------------------ dense pool

    def _admit(self) -> None:
        """Admit tier-then-FCFS into every free slot row; a request whose deadline lapsed
        while it waited is cancelled instead."""
        admit, dead = self.scheduler.admissible(self.pool.num_free)
        for state in dead:
            self._finish(state, RequestStatus.cancelled)
        for state in admit:
            self._prefill_into_slot(state)

    def _prefill_into_slot(self, state: RequestState) -> None:
        """The whole prompt in one forward, right-padded to its bucket, into a fresh
        ``[1, bucket]`` cache copied into the slot; samples the first token."""
        request = state.request
        slot = self.pool.allocate()
        prompt_len = len(request.prompt_ids)
        multiple = self.prefill_bucket_multiple
        bucket = min(-(-prompt_len // multiple) * multiple, self.pool.max_len)
        ids = np.full((1, bucket), self.pad_token_id, np.int64)
        ids[0, :prompt_len] = request.prompt_ids
        mask = np.zeros((1, bucket), np.int32)
        mask[0, :prompt_len] = 1
        self._set_sampling(slot, request)
        tr = state.trace
        if tr is not None:
            self._admit_t0 = None
            self._admit_victims = 0
            t_adm = self._trace_admitted(state)
            tr.open["prefill"] = tr.begin(
                "prefill", parent=tr.root, t0=t_adm, slot=slot, tokens=prompt_len, resume=False
            )

        device = self.device
        t0 = time.perf_counter()
        # right-padded: token i sits at cache position i, so the slot's frontier is its length
        out = self._forward(
            torch.as_tensor(ids, device=device),
            position_ids=torch.arange(bucket, device=device)[None, :],
            attention_mask=torch.as_tensor(mask, device=device),
            kv_caches=self.model.init_kv_caches(1, bucket, self.pool.caches[0]["k"].dtype),
            cache_index=0,  # a python int: the prefill fast path
        )
        token = sample_tokens_vectorized(
            out.logits[:, prompt_len - 1],
            [self._generators[slot]],
            [bool(self._do_sample[slot])],
            *self._sampling_tensors([slot]),
        )
        self.pool.write_prefill(slot, out.kv_caches, prompt_len)
        first_token = int(token[0])  # host fetch: ends the TTFT clock
        self.stats.prefill_seconds += time.perf_counter() - t0
        self.stats.prefill_tokens += prompt_len
        self.stats.prefill_chunks += 1
        self._count_admission(state, session_hit=False)
        get_telemetry().count("serving_prefill_tokens", prompt_len)

        state.slot = slot
        state.status = RequestStatus.running
        self._slot_states[slot] = state
        if self.speculating:
            self._spec_start(slot, request.prompt_ids)
        self._record_first_token(state, first_token)

    def _decode_once(self) -> None:
        """One forward over every slot row: each writes its token at its own frontier."""
        active = list(self._slot_states)
        device = self.device
        t0 = time.perf_counter()
        lengths = torch.as_tensor(self.pool.lengths, device=device)
        out = self._forward(
            torch.as_tensor(self._tokens, device=device)[:, None],
            position_ids=lengths[:, None],
            kv_caches=self.pool.caches,
            cache_index=lengths,
        )
        next_tokens = sample_tokens_vectorized(
            out.logits[:, -1], self._generators, self._rows_sampling(active), *self._sampling_tensors(slice(None))
        )
        tokens = next_tokens.cpu().numpy()  # host fetch: the streaming sync point
        self._step_count += 1
        self.stats.decode_steps += 1
        self.stats.decode_seconds += time.perf_counter() - t0
        self._emit_decoded(active, tokens)

    # ------------------------------------------------------------------ admission

    def _admit_paged(self) -> None:
        """Admit tier-then-FCFS while slot rows and (possibly oversubscribed) pages are
        available. Worst-case pages (minus prefix-cache hits) are reserved up front;
        prefix-cache-only pages are evicted LRU to make room. When the head cannot fit and
        preemption is on, strictly lower-tier running slots are evicted, one at a time,
        until it does; a blocked head waits at its tier's head and never blocks a higher
        tier."""
        if self.prefix is not None:
            self.prefix.expire_sessions(self.scheduler.clock())
        while True:
            state = self.scheduler.pop_next()
            if state is None:
                return
            if self.scheduler.expired(state):
                self._finish(state, RequestStatus.cancelled)
                continue
            # tracing: the admission span covers pop -> installed, the victim eviction
            # loop below included; a blocked attempt records nothing (its queue span stays open)
            self._admit_t0 = self.scheduler.clock() if state.trace is not None else None
            self._admit_victims = 0
            if self._try_admit(state):
                continue
            admitted = False
            while self.preemption != "off":
                victim = self._pick_victim(below_tier=state.request.priority)
                if victim is None:
                    break
                self._preempt(victim)
                self._admit_victims += 1
                if self._try_admit(state):
                    admitted = True
                    break
            if not admitted:
                self.scheduler.push_front(state)
                return

    def _try_admit(self, state: RequestState) -> bool:
        """One admission attempt: claim a slot, reserve pages, set up the prefill task (or
        restore a swapped-out request). Rolls back and returns False when slot rows or
        pages are short; the caller decides between waiting and preempting."""
        if self.pool.num_free == 0:
            return False
        if state.resume is not None and state.resume.swapped:
            return self._try_restore_swapped(state)
        request = state.request
        resume = state.resume
        # a drop-and-recompute resume re-prefills the emitted prefix (its token budget and
        # worst-case pages are the request's: the sequence is the same)
        prefill_ids = (
            (request.prompt_ids + state.tokens)[: resume.resident] if resume is not None else request.prompt_ids
        )
        page_size = self.pool.page_size
        worst_pages = -(-(len(request.prompt_ids) + request.max_new_tokens) // page_size)
        if self.prefix is not None:
            match = self.prefix.match(prefill_ids)
        else:
            match = PrefixMatch(nodes=[], cow=None, cow_len=0, resume_pos=0)
        # attach the hit pages FIRST (refcount 2: index + slot) and pin the COW donor, so
        # the eviction pass below can never reclaim the pages about to be used
        slot = self.pool.allocate()
        for i, node in enumerate(match.nodes):
            self.pool.attach_shared(slot, i, node.page)
        if match.cow is not None:
            self.pool.incref(match.cow.page)

        needed = worst_pages - len(match.nodes)
        shortfall = needed - self.pool.available_pages
        reclaimed = 0
        if shortfall > 0 and self.prefix is not None:
            reclaimed = self.prefix.evict(shortfall, self.pool)
        if needed > self.pool.available_pages:
            if match.cow is not None:
                self.pool.decref(match.cow.page)
            self.pool.free(slot)
            return False

        self.pool.reserve(slot, needed)
        if match.cow is not None:
            # copy-on-write at page granularity: the partially matching tail page is
            # copied into a private page; the miss suffix is recomputed over it. The page
            # may be reclaimed only from requests ranked after this one (see
            # `_reclaim_physical`); failing that, the admission waits
            dst = self._alloc_page_reclaiming(slot, len(match.nodes), after=(request.priority, state.seq))
            if dst is None:
                self.pool.decref(match.cow.page)
                self.pool.free(slot)
                return False
            self.pool.copy_page(match.cow.page, dst)
            self.pool.decref(match.cow.page)

        state.slot = slot
        state.status = RequestStatus.running
        self._slot_states[slot] = state
        self._set_sampling(slot, request)
        self._prefill_tasks[slot] = _PrefillTask(
            state=state, pos=match.resume_pos, prefill_ids=prefill_ids, resume=resume
        )
        self._prefill_order.append(slot)

        hit = match.resume_pos
        self.stats.prefix_hit_tokens += hit
        self.stats.prefix_miss_tokens += len(prefill_ids) - hit
        if hit:
            get_telemetry().count("serving_prefix_hit_tokens", hit)
        get_telemetry().count("serving_prefix_miss_tokens", len(prefill_ids) - hit)
        if resume is None:
            self._count_admission(state, session_hit=hit > 0)
        tr = state.trace
        if tr is not None:
            now = self._trace_admitted(
                state,
                prefix_hit_tokens=hit,
                pages_reserved=needed,
                pages_reclaimed=reclaimed,
                resume=resume is not None,
            )
            tr.open["prefill"] = tr.begin(
                "prefill",
                parent=tr.phase_parent or tr.root,
                t0=now,
                slot=slot,
                tokens=len(prefill_ids) - hit,
                resume=resume is not None,
            )
        return True

    def _try_restore_swapped(self, state: RequestState) -> bool:
        """Re-admit a swap-preempted request: its pages come back from the host pool onto
        fresh private pages, the decode context is reinstalled, and the request continues
        where it stopped, with no prefill and no resampling."""
        request = state.request
        resume = state.resume
        page_size = self.pool.page_size
        used = -(-resume.resident // page_size)
        worst_pages = -(-(len(request.prompt_ids) + request.max_new_tokens) // page_size)
        if worst_pages > self.pool.available_pages:
            shortfall = worst_pages - self.pool.available_pages
            if self.prefix is None or not self.prefix.evict(shortfall, self.pool):
                return False
            if worst_pages > self.pool.available_pages:
                return False
        # the `used` restored pages must exist physically now (the rest of the reservation
        # is mapped later, with reclamation at allocation)
        if self.pool.physical_free < used:
            if self.prefix is not None:
                self.prefix.evict(used - self.pool.physical_free, self.pool)
            if self.pool.physical_free < used:
                return False
        slot = self.pool.allocate()
        self.pool.reserve(slot, worst_pages)
        pages = [self.pool.alloc_page(slot, i) for i in range(used)]
        moved = self._swap.swap_in(request.request_id, pages)
        self.pool.lengths[slot] = resume.resident

        state.slot = slot
        state.status = RequestStatus.running
        state.resume = None
        self._slot_states[slot] = state
        self._set_sampling(slot, request, resume.generator_state)
        self._tokens[slot] = resume.next_token
        if self.speculating:
            self._spec_start(slot, request.prompt_ids + state.tokens)
        self.stats.pages_swapped_in += moved
        get_telemetry().count("serving_pages_swapped_in", moved)
        tr = state.trace
        if tr is not None:
            now = self._trace_admitted(state, pages_swapped_in=moved, pages_reserved=worst_pages, resume=True)
            park = tr.open.pop("preempt_park", None)
            if park is not None:
                tr.end(park, t1=now, pages_swapped_in=moved)
            tr.phase_parent = None
            self._trace_begin_decode(state, now)
        return True

    def _set_sampling(self, slot: int, request: Request, generator_state: torch.Tensor | None = None) -> None:
        """The slot's sampling parameters, and when it samples a generator seeded from the
        request (or, resuming, set to the state it had at preemption)."""
        do_sample, temperature, top_k, top_p = request.sampling.encoded()
        self._do_sample[slot] = do_sample
        self._temperature[slot] = temperature
        self._top_k[slot] = top_k
        self._top_p[slot] = top_p
        generator = None
        if do_sample:
            generator = torch.Generator(device=self.device).manual_seed(request.seed)
            if generator_state is not None:
                generator.set_state(generator_state)
        self._generators[slot] = generator

    def _count_admission(self, state: RequestState, session_hit: bool) -> None:
        """First-admission accounting (resumes do not count again)."""
        request = state.request
        tier = request.priority
        self.stats.admitted += 1
        self.stats.admitted_by_tier[tier] = self.stats.admitted_by_tier.get(tier, 0) + 1
        get_telemetry().count("serving_requests_admitted")
        if request.session_id is not None and self.prefix is not None:
            live = self.prefix.touch_session(
                request.session_id, self.scheduler.clock(), self.session_ttl_s
            )
            if live and session_hit:
                self.stats.session_hits += 1
                get_telemetry().count("serving_session_hits")

    # ------------------------------------------------------------------ tracing

    def _trace_admitted(self, state: RequestState, **attrs) -> float:
        """Close the open queue segment and record the admission span (pop -> now, the
        victim-eviction loop included). Returns the admission's end, where the caller
        starts the next phase: contiguous phases make the critical-path TTFT sum close
        (`utils/tracing.critical_path`)."""
        tr = state.trace
        now = self.scheduler.clock()
        t_pop = self._admit_t0 if self._admit_t0 is not None else now
        queue = tr.open.pop("queue_wait", None)
        if queue is not None:
            tr.end(queue, t1=t_pop)
        admission = tr.begin(
            "admission",
            parent=tr.phase_parent or tr.root,
            t0=t_pop,
            tier=state.request.priority,
            victims_evicted=self._admit_victims,
            **attrs,
        )
        tr.end(admission, t1=now)
        return now

    def _trace_begin_decode(self, state: RequestState, t0: float) -> None:
        """Open a decode span for one residency; the steps aggregate their tokens and
        counts into its attributes (mean ITL = duration / tokens)."""
        tr = state.trace
        tr.open["decode"] = tr.begin(
            "decode",
            parent=tr.root,
            t0=t0,
            slot=state.slot,
            segment=state.preemptions,
            replica_id=self.replica_id,
            tokens=0,
            steps=0,
        )

    # ------------------------------------------------------------------ preemption

    def _pick_victim(
        self, below_tier: int | None = None, exclude: set[int] | None = None, after: tuple[int, int] | None = None
    ) -> RequestState | None:
        """The next slot to evict: the lowest priority (highest tier number) first, the
        latest arrival within a tier (the least sunk service). `below_tier` keeps to tiers
        strictly lower than the beneficiary's; `exclude` protects slots mid-allocation;
        `after` keeps to requests ranked after that (priority, seq)."""
        candidates = [
            state
            for slot, state in self._slot_states.items()
            if slot not in (exclude or ())
            and (below_tier is None or state.request.priority > below_tier)
            and (after is None or (state.request.priority, state.seq) > after)
        ]
        if not candidates:
            return None
        return max(candidates, key=lambda state: (state.request.priority, state.seq))

    def _preempt(self, state: RequestState) -> None:
        """Evict a running slot and re-enqueue its request at its FCFS position. Swap
        parks the pages in host memory (a byte-identical restore); recompute registers
        them in the prefix cache (usually a free re-attach on resume) and releases them. A
        slot still mid-prefill restarts its prefill: no decode context exists yet."""
        slot = state.slot
        assert slot is not None and self._slot_states.get(slot) is state
        t_evict = self.scheduler.clock() if state.trace is not None else None
        task = self._prefill_tasks.pop(slot, None)
        if slot in self._prefill_order:
            self._prefill_order.remove(slot)
        if self.speculating:
            self._spec_stop(slot)
        if task is not None:
            # keep what the chunks computed by indexing the full pages below the progress
            # frontier; the prefill restarts (cheaply, from those hits)
            if self.prefix is not None and task.pos >= self.pool.page_size:
                full = (task.pos // self.pool.page_size) * self.pool.page_size
                self.prefix.register(
                    task.prefill_ids[:full], [int(p) for p in self.pool.page_table[slot]], self.pool
                )
            state.resume = task.resume  # a preempted resume stays a resume
        else:
            resident = int(self.pool.lengths[slot])
            if self.preemption == "swap":
                used = -(-resident // self.pool.page_size)
                pages = [int(p) for p in self.pool.page_table[slot, :used]]
                moved = self._swap.swap_out(state.request.request_id, pages)
                self.stats.pages_swapped_out += moved
                get_telemetry().count("serving_pages_swapped_out", moved)
                swapped = True
            else:
                if self.prefix is not None:
                    self._register_prefix(state, slot)
                swapped = False
            generator = self._generators[slot]
            state.resume = _ResumeState(
                next_token=int(self._tokens[slot]),
                generator_state=None if generator is None else generator.get_state(),
                resident=resident,
                swapped=swapped,
            )
        self.pool.free(slot)
        self._generators[slot] = None
        del self._slot_states[slot]
        state.slot = None
        state.status = RequestStatus.waiting
        state.preemptions += 1
        tier = state.request.priority
        self.stats.preemptions += 1
        self.stats.preempted_by_tier[tier] = self.stats.preempted_by_tier.get(tier, 0) + 1
        get_telemetry().count("serving_preemptions")
        tr = state.trace
        if tr is not None:
            # close the interrupted residency, open the park span and nest the re-enqueue's
            # queue segment under it; the resume's admission and prefill spans parent under
            # the park too (tr.phase_parent) until it ends
            for name in ("prefill", "decode"):
                span = tr.open.pop(name, None)
                if span is not None:
                    tr.end(span, t1=t_evict, preempted=True)
            resume = state.resume
            resident = task.pos if task is not None else (resume.resident if resume is not None else 0)
            park = tr.begin(
                "preempt_park",
                parent=tr.root,
                t0=t_evict,
                mode=self.preemption,
                mid_prefill=task is not None,
                resident=resident,
            )
            if resume is not None and resume.swapped:
                pages_out = -(-resume.resident // self.pool.page_size)
                park.attrs["pages_swapped_out"] = pages_out
                park.attrs["swap_bytes"] = int(round(pages_out * self.pool.page_bytes))
            tr.open["preempt_park"] = park
            tr.phase_parent = park
            tr.open["queue_wait"] = tr.begin(
                "queue_wait", parent=park, t0=self.scheduler.clock(), tier=tier, segment=state.preemptions
            )
        self.scheduler.push_front(state)

    def _alloc_page_reclaiming(self, slot: int, index: int, after: tuple[int, int] | None = None) -> int | None:
        """`alloc_page` that survives an oversubscribed pool running physically dry:
        reclaim until a page is free, then map it. With `after` (an admission's rank),
        None when the page cannot be reclaimed from requests ranked after it."""
        if self.pool.physical_free == 0 and not self._reclaim_physical(1, protect=slot, after=after):
            return None
        return self.pool.alloc_page(slot, index)

    def _reclaim_physical(self, need: int, protect: int | None, after: tuple[int, int] | None = None) -> bool:
        """Free at least `need` physical pages: evict unpinned prefix-cache leaves,
        preempt the lowest-priority victim (whose recompute-registered pages become
        evictable in turn), and only as a last resort evict session-pinned pages. The
        `protect` slot is never preempted, so the loop ends.

        An admission's copy-on-write page passes its rank as `after` and may preempt only
        requests ranked after it, and gets False when that does not free the pages. The
        JAX engine lets it preempt any request; two recompute resumes that each need such
        a page then preempt each other inside one admission pass without end (ROADMAP.md
        Queue C). Where the JAX engine ends, the victims are the same."""
        while self.pool.physical_free < need:
            if self.prefix is not None:
                self.prefix.evict(need - self.pool.physical_free, self.pool)
                if self.pool.physical_free >= need:
                    return True
            victim = None
            if self.preemption != "off":
                victim = self._pick_victim(exclude={protect} if protect is not None else None, after=after)
            if victim is not None:
                self._preempt(victim)
                continue
            if self.prefix is not None and self.prefix.evict(
                need - self.pool.physical_free, self.pool, include_pinned=True
            ):
                continue
            if after is not None:
                return False
            raise RuntimeError(
                f"cannot reclaim {need} KV page(s): no evictable prefix pages and no "
                f"preemptable slots (preemption={self.preemption!r})"
            )
        return True

    # ------------------------------------------------------------------ device steps

    def _sampling_tensors(self, rows: slice | list[int]):
        device = self.device
        return (
            torch.as_tensor(self._temperature[rows], device=device),
            torch.as_tensor(self._top_k[rows], device=device),
            torch.as_tensor(self._top_p[rows], device=device),
        )

    def _rows_sampling(self, rows: list[int]) -> np.ndarray:
        """Per-slot sampling flags with every row outside `rows` (idle, mid-prefill) greedy."""
        do_sample = np.zeros_like(self._do_sample)
        do_sample[rows] = self._do_sample[rows]
        return do_sample

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill_priority_key(self, slot: int, now: float):
        """Chunked-prefill budget order: tier, then TTFT-SLO headroom, then FCFS."""
        state = self._prefill_tasks[slot].state
        headroom = self.scheduler.ttft_headroom(state, now)
        return (
            state.request.priority,
            float("inf") if headroom is None else headroom,
            state.seq,
        )

    def _run_prefill_chunks(self, budget: int) -> None:
        """Advance in-flight prefills in tier-then-SLO-headroom-then-FCFS order, spending
        at most `budget` real prefix tokens this step."""
        page_size = self.pool.page_size
        view_len = self.pool.max_pages_per_slot * page_size
        device = self.device
        telemetry = get_telemetry()
        while budget > 0 and self._prefill_order:
            now = self.scheduler.clock()
            slot = min(self._prefill_order, key=lambda s: self._prefill_priority_key(s, now))
            task = self._prefill_tasks[slot]
            state = task.state
            prefill_ids = task.prefill_ids
            prefill_len = len(prefill_ids)
            take = min(prefill_len - task.pos, budget)
            final = task.pos + take == prefill_len
            # a resume's final chunk only recomputes K/V: the decode context is restored
            samples = final and task.resume is None
            multiple = self.prefill_bucket_multiple
            width = -(-take // multiple) * multiple

            # map fresh pages under the chunk's real positions before the device write
            # (reclaiming first if an oversubscribed pool ran physically dry)
            pages_mapped = 0
            for index in range(task.pos // page_size, (task.pos + take - 1) // page_size + 1):
                if self.pool.page_table[slot, index] == TRASH_PAGE:
                    self._alloc_page_reclaiming(slot, index)
                    pages_mapped += 1
            if self._slot_states.get(slot) is not state:
                continue  # reclamation preempted this very task; pick again
            tr = state.trace
            chunk_span = None
            if tr is not None:
                chunk_span = tr.begin(
                    "prefill_chunk",
                    parent=tr.open.get("prefill"),
                    t0=self.scheduler.clock(),
                    tokens=take,
                    width=width,
                    pages_written=pages_mapped,
                    backend=self._prefill_backend,
                    final=final,
                )

            ids = np.full((1, width), self.pad_token_id, np.int64)
            ids[0, :take] = prefill_ids[task.pos : task.pos + take]
            mask = np.zeros((1, view_len), np.int32)
            mask[0, : task.pos + take] = 1  # resident prefix + this chunk's real tokens

            t0 = time.perf_counter()
            table_row = torch.as_tensor(self.pool.page_table[slot : slot + 1], device=device)
            kv = [{**c, "page_table": table_row} for c in self.pool.caches]
            position_ids = torch.arange(task.pos, task.pos + width, device=device)[None, :]
            out = self._forward(
                torch.as_tensor(ids, device=device),
                position_ids=position_ids,
                attention_mask=torch.as_tensor(mask, device=device),
                kv_caches=kv,
                cache_index=torch.tensor(task.pos, dtype=torch.int32, device=device),
            )
            if samples:
                token = sample_tokens_vectorized(
                    out.logits[:, take - 1],
                    [self._generators[slot]],
                    [bool(self._do_sample[slot])],
                    *self._sampling_tensors([slot]),
                )
                first_token = int(token[0])  # host fetch: ends the TTFT clock
            else:
                self._sync()
            self.stats.prefill_seconds += time.perf_counter() - t0
            self.stats.prefill_tokens += take
            self.stats.prefill_chunks += 1
            telemetry.count("serving_prefill_tokens", take)
            task.pos += take
            budget -= take
            if chunk_span is not None:
                tr.end(chunk_span)  # after the host fetch or sync that ended the chunk

            if not final:
                continue
            self.pool.lengths[slot] = prefill_len
            self._prefill_order.remove(slot)
            del self._prefill_tasks[slot]
            if task.resume is not None:
                # recompute-resume complete: reinstall the captured context (the next
                # token, the generator's state) and continue token for token
                self._tokens[slot] = task.resume.next_token
                if task.resume.generator_state is not None:
                    self._generators[slot].set_state(task.resume.generator_state)
                state.resume = None
                if self.speculating:
                    self._spec_start(slot, state.request.prompt_ids + state.tokens)
                if tr is not None:
                    # the recompute resume is complete: the park span ends and decode
                    # opens again as a new top-level residency
                    now = self.scheduler.clock()
                    prefill_span = tr.open.pop("prefill", None)
                    if prefill_span is not None:
                        tr.end(prefill_span, t1=now)
                    park = tr.open.pop("preempt_park", None)
                    if park is not None:
                        tr.end(park, t1=now)
                    tr.phase_parent = None
                    self._trace_begin_decode(state, now)
                continue
            if self.speculating:
                self._spec_start(slot, prefill_ids)
            self._record_first_token(state, first_token)
            if self.prefill_only and not state.done:
                # park for handoff: the slot and its pages stay resident until a decode
                # engine adopts the K/V and `release_handoff` frees them
                self._ready_handoffs.append(state)
                if tr is not None:
                    tr.open["handoff"] = tr.begin(
                        "handoff", parent=tr.root, t0=state.first_token_t, src_replica=self.replica_id
                    )

    def _record_first_token(self, state: RequestState, token: int) -> None:
        """End the request's TTFT clock and stream its first token from its slot. A
        prefill phase ends exactly at the first token, so the critical-path sum closes
        against the recorded TTFT; a request preempted mid-prefill re-prefilled under its
        park span, which ends here too."""
        state.first_token_t = self.scheduler.clock()
        if state.ttft_s is not None:
            self.stats.ttft_s.append(state.ttft_s)
            tier = state.request.priority
            self.stats.ttft_s_by_tier.setdefault(tier, QuantileSketch()).append(state.ttft_s)
            get_telemetry().observe("serving/ttft_s", state.ttft_s)
        slot = state.slot
        self._tokens[slot] = token
        state.rng_steps = 1  # the sampling prefill drew once from the request's stream
        self._note_draw(state, slot)
        tr = state.trace
        if tr is not None:
            prefill_span = tr.open.pop("prefill", None)
            if prefill_span is not None:
                tr.end(prefill_span, t1=state.first_token_t)
            park = tr.open.pop("preempt_park", None)
            if park is not None:
                tr.end(park, t1=state.first_token_t)
            tr.phase_parent = None
            if state.ttft_s is not None:
                tr.root.attrs["ttft_s"] = round(state.ttft_s, 6)
            if not self.prefill_only:
                self._trace_begin_decode(state, state.first_token_t)
        self._deliver(state, token)

    def _note_draw(self, state: RequestState, slot: int) -> None:
        """Keep the slot's generator state on the request after a draw whose tokens are
        being delivered: a migrated request continues its stream from it. A host copy of
        a few bytes for a CUDA generator (its seed and offset); greedy rows have none."""
        generator = self._generators[slot]
        if generator is not None:
            state.rng_state = generator.get_state()

    def _map_decode_pages(self, window: int) -> list[int]:
        """Map the pages under each decoding row's next `window` positions (capped at the
        request's worst case, what admission reserved: a verify window's overhang past it
        writes to the trash page, and those drafts could never be committed). Under
        oversubscription this can preempt a lower-priority decoding slot, so membership is
        read again after. Returns the decoding slots."""
        page_size = self.pool.page_size
        for slot in [s for s in self._slot_states if s not in self._prefill_tasks]:
            state = self._slot_states.get(slot)
            if state is None or slot in self._prefill_tasks:
                continue  # preempted by reclamation
            position = int(self.pool.lengths[slot])
            total = len(state.request.prompt_ids) + state.request.max_new_tokens
            last = min(position + window - 1, total - 1)
            for index in range(position // page_size, last // page_size + 1):
                if self.pool.page_table[slot, index] == TRASH_PAGE:
                    self._alloc_page_reclaiming(slot, index)
        return [s for s in self._slot_states if s not in self._prefill_tasks]

    def _step_views(self, decoding: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """The step's page table and frontiers on the device: idle and mid-prefill rows
        are zeroed, so their garbage writes land in the trash page."""
        table = np.zeros_like(self.pool.page_table)
        lengths = np.zeros(self.pool.num_slots, np.int32)
        for slot in decoding:
            table[slot] = self.pool.page_table[slot]
            lengths[slot] = int(self.pool.lengths[slot])
        return torch.as_tensor(table, device=self.device), torch.as_tensor(lengths, device=self.device)

    def _decode_once_paged(self) -> None:
        decoding = self._map_decode_pages(1)
        if not decoding:
            return
        device = self.device
        t0 = time.perf_counter()
        table, lengths = self._step_views(decoding)
        kv = [{**c, "page_table": table} for c in self.pool.caches]
        out = self._forward(
            torch.as_tensor(self._tokens, device=device)[:, None],
            position_ids=lengths[:, None],
            kv_caches=kv,
            cache_index=lengths,
        )
        next_tokens = sample_tokens_vectorized(
            out.logits[:, -1], self._generators, self._rows_sampling(decoding), *self._sampling_tensors(slice(None))
        )
        tokens = next_tokens.cpu().numpy()  # host fetch: the streaming sync point
        self._step_count += 1
        self.stats.decode_steps += 1
        self.stats.decode_seconds += time.perf_counter() - t0
        self._emit_decoded(decoding, tokens)

    # ------------------------------------------------------------------ speculation

    def _spec_start(self, slot: int, prompt_ids: list[int]) -> None:
        if self._ngram is not None:
            self._ngram.start(slot, prompt_ids)
        if self._draft is not None:
            self._draft.start(slot, prompt_ids)

    def _spec_stop(self, slot: int) -> None:
        if self._ngram is not None:
            self._ngram.stop(slot)
        if self._draft is not None:
            self._draft.stop(slot)

    def _collect_drafts(self, decoding: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Up to K draft tokens per decoding slot: (drafts [num_slots, K], counts
        [num_slots]). A slot with 0 drafts (no n-gram match, idle, mid-prefill) decodes
        plainly inside the verify step."""
        k = self.draft_k
        num = self.pool.num_slots
        drafts = np.zeros((num, k), np.int64)
        counts = np.zeros(num, np.int64)
        if self._draft is not None:
            # one ingest of the tokens committed since the drafter last saw each slot
            # (<= K+1: accepted + bonus), then K greedy draft tokens
            windows = np.full((num, k + 1), self.pad_token_id, np.int64)
            ingest = np.zeros(num, np.int64)
            for slot in decoding:
                state = self._slot_states[slot]
                fresh = (state.request.prompt_ids + state.tokens)[int(self._draft.seen[slot]) :]
                assert len(fresh) <= k + 1, (len(fresh), k)
                windows[slot, : len(fresh)] = fresh
                ingest[slot] = len(fresh)
            proposed = self._draft.propose(windows, ingest)
            for slot in decoding:
                drafts[slot] = proposed[slot]
                counts[slot] = k
        elif self._ngram is not None:
            for slot in decoding:
                proposal = self._ngram.propose(slot)
                drafts[slot, : len(proposal)] = proposal
                counts[slot] = len(proposal)
        return drafts, counts

    def _verify(self, decoding: list[int], kv_caches, lengths: torch.Tensor) -> None:
        """One verify step: the ``[num_slots, K+1]`` window (the fed token and the drafts)
        at each row's own frontier in one forward, the acceptance, one host fetch."""
        k = self.draft_k
        device = self.device
        drafts, num_drafts = self._collect_drafts(decoding)
        w0 = self.scheduler.clock()
        t0 = time.perf_counter()
        # one copy to the device: the window (the fed token, the drafts) and the draft counts
        packed = torch.as_tensor(np.concatenate([self._tokens[:, None], drafts, num_drafts[:, None]], axis=1), device=device)
        positions = lengths[:, None] + torch.arange(k + 1, device=device)[None, :]
        out = self._forward(packed[:, : k + 1], position_ids=positions, kv_caches=kv_caches, cache_index=lengths)
        accepted, bonus = speculative_accept(
            out.logits,
            packed[:, 1 : k + 1],
            packed[:, k + 1],
            self._generators,
            self._rows_sampling(decoding),
            *self._sampling_tensors(slice(None)),
        )
        accepted, bonus = torch.stack([accepted, bonus]).cpu().numpy()  # host fetch: the streaming sync point
        self._step_count += 1
        self.stats.decode_steps += 1
        self.stats.decode_seconds += time.perf_counter() - t0
        self._emit_verified(decoding, drafts, num_drafts, accepted, bonus, w0, self.scheduler.clock())

    def _verify_once_paged(self) -> None:
        decoding = self._map_decode_pages(self.draft_k + 1)
        if not decoding:
            return
        table, lengths = self._step_views(decoding)
        self._verify(decoding, [{**c, "page_table": table} for c in self.pool.caches], lengths)

    def _verify_once_dense(self) -> None:
        lengths = torch.as_tensor(self.pool.lengths, device=self.device)
        self._verify(list(self._slot_states), self.pool.caches, lengths)

    def _emit_verified(
        self,
        decoding: list[int],
        drafts: np.ndarray,
        num_drafts: np.ndarray,
        accepted: np.ndarray,
        bonus: np.ndarray,
        window_t0: float | None = None,
        window_t1: float | None = None,
    ) -> None:
        """Commit a verify step per slot: the accepted drafts in order, then the bonus
        token, with EOS and the token budget applied mid-window (tokens after a finishing
        token are discarded, so the stream is plain decode's). The frontier advances past
        the fed token and the accepted drafts delivered; the bonus token's K/V is written
        by the next step, and rejected tails stay masked behind the frontier."""
        emitted_total = proposed_total = accepted_total = 0
        for slot in decoding:
            state = self._slot_states.get(slot)
            if state is None:
                continue
            proposals = int(num_drafts[slot])
            acc = min(int(accepted[slot]), proposals)
            proposed_total += proposals
            accepted_total += acc
            plan = [int(drafts[slot, i]) for i in range(acc)] + [int(bonus[slot])]
            eos = state.request.eos_token_id
            budget = state.request.max_new_tokens - state.num_generated
            emit: list[int] = []
            for token in plan:
                emit.append(token)
                if (eos is not None and token == eos) or len(emit) >= budget:
                    break
            self.pool.lengths[slot] += 1 + min(len(emit), acc)
            self._tokens[slot] = emit[-1]
            state.rng_steps += 1  # one verify step, one draw of the slot's stream
            self._note_draw(state, slot)
            emitted_total += len(emit)
            tr = state.trace
            if tr is not None:
                span = tr.open.get("decode")
                if span is not None:
                    span.attrs["tokens"] += len(emit)
                    span.attrs["steps"] += 1
                    if proposals and window_t0 is not None:
                        window = tr.begin("verify_window", parent=span, t0=window_t0, proposed=proposals, accepted=acc)
                        tr.end(window, t1=window_t1)
            for token in emit:
                self._deliver(state, token)
                if state.done:
                    break
        self.stats.decode_tokens += emitted_total
        self.stats.draft_tokens_proposed += proposed_total
        self.stats.draft_tokens_accepted += accepted_total
        telemetry = get_telemetry()
        if emitted_total:
            telemetry.count("serving_decode_tokens", emitted_total)
        if proposed_total:
            telemetry.count("serving_draft_tokens_proposed", proposed_total)
        if accepted_total:
            telemetry.count("serving_draft_tokens_accepted", accepted_total)

    # ------------------------------------------------------------------ delivery

    def _emit_decoded(self, active: list[int], tokens: np.ndarray) -> None:
        emitted = 0
        for slot in active:
            state = self._slot_states.get(slot)
            if state is None:
                continue
            # the token fed this step is now in the cache; the slot's frontier advances
            self.pool.lengths[slot] += 1
            token = int(tokens[slot])
            self._tokens[slot] = token
            state.rng_steps += 1  # this step drew once from the slot's stream
            self._note_draw(state, slot)
            emitted += 1
            if state.trace is not None:
                span = state.trace.open.get("decode")
                if span is not None:  # the step's token joins the residency's ITL span
                    span.attrs["tokens"] += 1
                    span.attrs["steps"] += 1
            self._deliver(state, token)
        self.stats.decode_tokens += emitted
        if emitted:
            get_telemetry().count("serving_decode_tokens", emitted)

    def _deliver(self, state: RequestState, token: int) -> None:
        """Stream one token and apply the termination rules (EOS counts as emitted)."""
        state.tokens.append(token)
        if self._ngram is not None and state.slot is not None:
            self._ngram.extend(state.slot, token)  # emitted tokens feed later lookups
        if state.request.on_token is not None:
            state.request.on_token(token)
        eos = state.request.eos_token_id
        if (eos is not None and token == eos) or (
            state.num_generated >= state.request.max_new_tokens
        ):
            self._finish(state, RequestStatus.completed)

    def _cancel_expired_running(self) -> None:
        for state in [s for s in self._slot_states.values() if self.scheduler.expired(s)]:
            self._finish(state, RequestStatus.cancelled)

    def _finish(self, state: RequestState, status: RequestStatus) -> None:
        state.status = status
        state.finish_t = self.scheduler.clock()
        if self._swap is not None:
            self._swap.drop(state.request.request_id)  # finished while swapped out
        if self._ready_handoffs:
            self._ready_handoffs = [s for s in self._ready_handoffs if s is not state]
        if state.slot is not None:
            slot = state.slot
            self._prefill_tasks.pop(slot, None)
            if slot in self._prefill_order:
                self._prefill_order.remove(slot)
            if self.prefix is not None:
                self._register_prefix(state, slot)
            if self.speculating:
                self._spec_stop(slot)
            self.pool.free(slot)
            self._generators[slot] = None
            del self._slot_states[slot]
        tier = state.request.priority
        telemetry = get_telemetry()
        if status == RequestStatus.completed:
            self.stats.completed += 1
            self.stats.completed_by_tier[tier] = self.stats.completed_by_tier.get(tier, 0) + 1
            telemetry.count("serving_requests_completed")
        else:
            self.stats.cancelled += 1
            telemetry.count("serving_requests_cancelled")
        if state.first_token_t is not None and state.num_generated > 1:
            itl = (state.finish_t - state.first_token_t) / (state.num_generated - 1)
            self.stats.itl_s_by_tier.setdefault(tier, QuantileSketch()).append(itl)
            telemetry.observe("serving/itl_s", itl)
        tr = state.trace
        if tr is not None:
            # close the phase the request ended in, then the root, and write the whole tree
            # as one trace record (the finishing engine writes it: for a disaggregated
            # request the decode worker, so both workers' spans land in one record)
            for name in ("queue_wait", "prefill", "decode", "handoff", "preempt_park"):
                span = tr.open.pop(name, None)
                if span is not None:
                    tr.end(span, t1=state.finish_t)
            tr.end(
                tr.root,
                t1=state.finish_t,
                status=str(status),
                generated_tokens=state.num_generated,
                preemptions=state.preemptions,
            )
            telemetry.emit_record(
                "trace",
                step=self._step_count,
                trace_id=tr.trace_id,
                request_id=state.request.request_id,
                spans=tr.span_records(),
            )
        if state.request.on_finish is not None:
            state.request.on_finish(state)

    def _register_prefix(self, state: RequestState, slot: int) -> None:
        """Index the slot's full pages before they are released (generated tokens too, so
        a follow-up whose prompt embeds this reply hits); a session pins the chain."""
        written = int(self.pool.lengths[slot])
        if written <= 0:
            return  # cancelled mid-prefill: nothing committed
        prompt = state.request.prompt_ids
        resident = (prompt + state.tokens[: written - len(prompt)])[:written]
        self.prefix.register(resident, [int(p) for p in self.pool.page_table[slot]], self.pool)
        if state.request.session_id is not None:
            self.prefix.pin_session(
                state.request.session_id, resident, self.scheduler.clock(), self.session_ttl_s
            )

    # ------------------------------------------------------ disaggregation (cluster/)

    def prefix_match_len(self, prompt_ids: list[int]) -> int:
        """Resident-prefix tokens this engine could reuse for `prompt_ids`: the router's
        affinity probe. No side effect (no LRU promotion); 0 without prefix caching."""
        return 0 if self.prefix is None else self.prefix.probe_len(prompt_ids)

    @property
    def pending_handoffs(self) -> int:
        """Finished prefills parked for adoption (prefill_only; else 0)."""
        return len(self._ready_handoffs)

    def take_ready_handoffs(self) -> list[RequestState]:
        """Pop every parked finished prefill (FCFS). The caller takes each one's
        `handoff_payload`, transfers its pages and calls `release_handoff`, or parks it
        again with `park_handoff` when no decode engine has room."""
        ready, self._ready_handoffs = self._ready_handoffs, []
        return ready

    def park_handoff(self, state: RequestState) -> None:
        """Return a handoff no decode engine could take to the front of the parked queue."""
        self._ready_handoffs.insert(0, state)

    def handoff_payload(self, state: RequestState) -> tuple[int, torch.Tensor | None, int, list[int]]:
        """The host-side handoff bundle of a parked prefill: (first token, the slot's
        generator state after the first draw, or None for a greedy request, resident
        length, physical source pages in chain order). The pages stay alive, their K/V
        unchanged, until `release_handoff`."""
        slot = state.slot
        assert slot is not None, "handoff payload for a request without a slot"
        length = int(self.pool.lengths[slot])
        used = -(-length // self.pool.page_size)
        pages = [int(p) for p in self.pool.page_table[slot, :used]]
        assert TRASH_PAGE not in pages, "handoff of an unmapped prefix page"
        generator = self._generators[slot]
        return int(self._tokens[slot]), None if generator is None else generator.get_state(), length, pages

    def release_handoff(self, state: RequestState, slot: int) -> None:
        """Free a handed-off request's source `slot` without finishing the request: its
        prefix pages are indexed here first (a later arrival with the same prompt skips
        prefill on this engine, which is what prefix affinity to a prefill worker buys),
        then the slot and its reservation return to the pool. The slot is passed because
        `adopt_prefilled` has already pointed ``state.slot`` at the decode slot."""
        assert self._slot_states.get(slot) is state, "release of a slot the state does not hold"
        if self.prefix is not None:
            self._register_prefix(state, slot)
        self.pool.free(slot)
        self._generators[slot] = None
        del self._slot_states[slot]

    def adopt_prefilled(
        self, state: RequestState, *, first_token: int, generator_state: torch.Tensor | None, length: int
    ) -> list[int] | None:
        """Admit a request whose prefill ran on another engine (the decode side of
        disaggregation): reserve its remaining worst-case pages, map fresh private pages
        for the transferred prefix and install the decode state as a local final prefill
        chunk would, so decode continues token for token as on one engine (the sampling
        generator continues from `generator_state`). Returns the destination pages (chain
        order) for the handoff to fill, or None when this engine lacks a slot or pages
        (the caller keeps FCFS by parking it again)."""
        assert self.paged and not self.prefill_only
        request = state.request
        page_size = self.pool.page_size
        used = -(-length // page_size)
        worst = -(-(length + request.max_new_tokens) // page_size)
        if self.pool.num_free == 0:
            return None
        shortfall = worst - self.pool.available_pages
        if shortfall > 0 and self.prefix is not None:
            self.prefix.evict(shortfall, self.pool)
        if worst > self.pool.available_pages or self.pool.physical_free < used:
            return None
        slot = self.pool.allocate()
        self.pool.reserve(slot, worst)
        pages = [self.pool.alloc_page(slot, i) for i in range(used)]
        self.pool.lengths[slot] = length

        state.slot = slot
        state.status = RequestStatus.running
        self._slot_states[slot] = state
        self._tokens[slot] = first_token
        self._set_sampling(slot, request, generator_state)
        if self.speculating:
            # the drafter's history holds what the prefill side already emitted
            self._spec_start(slot, request.prompt_ids + state.tokens)
        self.stats.admitted += 1
        get_telemetry().count("serving_requests_admitted")
        if state.trace is not None:
            # decode goes on here; the handoff span, opened on the prefill side, is closed
            # by the disaggregation driver once the pages have landed
            self._trace_begin_decode(state, self.scheduler.clock())
        return pages

    # -------------------------------------------------- crash migration (cluster/)

    def inflight_request_ids(self) -> list[int]:
        """Ids of the requests this engine still owes tokens to (waiting and running),
        sorted: the router's drain-timeout diagnostics and wait accounting."""
        ids = {state.request.request_id for state in self.scheduler.waiting}
        ids.update(state.request.request_id for state in self._slot_states.values())
        return sorted(ids)

    def release_inflight(self) -> list[RequestState]:
        """Strip every unfinished request out of this engine and return them in (tier,
        FCFS) order for adoption elsewhere (`Router._recover_dead` / `drain_replica`).

        Host bookkeeping only: the engine may have just failed mid-step, so its device
        state (pages, per-slot rows) is taken as corrupt: nothing is read from it and no
        prefix is registered. Each state comes back a slot-less ``waiting`` request;
        `adopt_inflight` rebuilds its resume context from its token log and
        ``rng_state`` alone."""
        released = list(self.scheduler.waiting)
        while self.scheduler.pop_next() is not None:
            pass
        running = sorted(self._slot_states.items(), key=lambda item: (item[1].tier, item[1].seq))
        for slot, state in running:
            self._prefill_tasks.pop(slot, None)
            if slot in self._prefill_order:
                self._prefill_order.remove(slot)
            if self.speculating:
                self._spec_stop(slot)
            self.pool.free(slot)
            self._generators[slot] = None
            released.append(state)
        self._slot_states.clear()
        self._ready_handoffs = []
        for state in released:
            if self._swap is not None:
                self._swap.drop(state.request.request_id)
            state.slot = None
            state.status = RequestStatus.waiting
            state.resume = None  # rebuilt from the token log at adoption
        released.sort(key=lambda state: (state.tier, state.seq))
        return released

    def adopt_inflight(self, state: RequestState) -> None:
        """Admit a request released from another replica (`release_inflight`), mid-
        generation or not. One that already emitted tokens comes in through the
        drop-and-recompute resume: the next token fed is its last emitted one, the resident
        prefix is ``(prompt + tokens)[:-1]``, and its sampling generator continues from
        ``state.rng_state``, so chunked prefill recomputes the committed prefix (prefix
        hits welcome) and decode continues token for token as if nothing had failed.
        Raises QueueFullError when this engine's queue is at its bound (the router then
        tries its next candidate)."""
        if state.tokens and not self.paged:
            raise ValueError("adopting a mid-generation request requires a paged engine")
        if state.tokens:
            state.resume = _ResumeState(
                next_token=int(state.tokens[-1]),
                generator_state=state.rng_state,
                resident=len(state.request.prompt_ids) + len(state.tokens) - 1,
                swapped=False,
            )
        else:
            state.resume = None
        self.scheduler.adopt(state)

    @torch.no_grad()
    def swap_params(self, params: Any) -> None:
        """Install new weights on this engine alone (a rolling update while the router
        has it parked): `params` is a state dict of the model's names (tensors; a module's
        `state_dict()`) or the JAX package's params tree (numpy). The forwards then run the
        shared module over these weights (`torch.func.functional_call`), so other engines
        built over the same model keep theirs. A state dict's tensors are used as given
        when they are on this engine's device in the model's dtypes, else copied there.
        The prefix index is dropped (its pages hold K/V of the old weights; the JAX engine
        keeps it); a request still running goes on over the K/V it has."""
        if not hasattr(params, "items") or not all(isinstance(v, torch.Tensor) for v in params.values()):
            params = _jax_params_state_dict(self.model, params, self.device)
        current = dict(self.model.state_dict(keep_vars=True))
        missing = sorted(set(current) - set(params))
        unknown = sorted(set(params) - set(current))
        if unknown:
            raise ValueError(f"swap_params got names the model does not have: {unknown[:5]}")
        own, converted = {}, {}  # one copy per source tensor keeps tied weights tied
        for name, tensor in params.items():
            like = current[name]
            if tensor.shape != like.shape:
                raise ValueError(f"swap_params: {name} has shape {tuple(tensor.shape)}, the model {tuple(like.shape)}")
            if id(tensor) not in converted:
                converted[id(tensor)] = tensor.detach().to(device=like.device, dtype=like.dtype)
            own[name] = converted[id(tensor)]
        for name in missing:  # tied weights and buffers the state dict left out
            own[name] = current[name].detach()
        self._params = own
        if self.prefix is not None:
            # resident prefixes hold K/V of the old weights: never reuse them under the new
            self.prefix.clear(self.pool)

    # ------------------------------------------------------------------ telemetry

    def emit_serving_record(self) -> None:
        """Write one ``serving`` telemetry record: the queue, slot and page state now, and
        the cumulative rates and counters (a no-op sink when no telemetry is installed)."""
        telemetry = get_telemetry()
        stats = self.stats
        self._last_record_step = self._step_count
        telemetry.gauge("serving/queue_depth", self.scheduler.queue_depth)
        telemetry.gauge("serving/slot_occupancy", self.pool.occupancy)
        kv_bytes = round(self.pool.kv_bytes_per_token, 2)
        telemetry.gauge("serving/kv_bytes_per_token", kv_bytes)
        pages_in_use = fragmentation = None
        if self.paged:
            pages_in_use = self.pool.pages_in_use
            fragmentation = round(self.pool.page_fragmentation, 4)
            telemetry.gauge("serving/pages_in_use", pages_in_use)
            telemetry.gauge("serving/page_fragmentation", fragmentation)
        accept_rate = accepted_per_step = None
        if self.speculating:
            rate = stats.accept_rate()
            accept_rate = 0.0 if rate is None else round(rate, 4)
            per_step = stats.accepted_tokens_per_step()
            accepted_per_step = 0.0 if per_step is None else round(per_step, 3)
            telemetry.gauge("serving/accept_rate", accept_rate)
            telemetry.gauge("serving/accepted_tokens_per_step", accepted_per_step)
        # one entry per tier that has seen traffic or is waiting, the measured latencies
        # beside their SLO targets
        depth_by_tier = self.scheduler.queue_depth_by_tier()
        tiers: dict[str, dict] = {}
        for tier in sorted(
            set(depth_by_tier) | set(stats.admitted_by_tier) | set(stats.ttft_s_by_tier) | set(self.scheduler.tier_slos)
        ):
            slo = self.scheduler.slo(tier)
            p99 = stats.ttft_p99_s(tier)
            itl = stats.itl_mean_s(tier)
            tiers[str(tier)] = {
                "queue_depth": depth_by_tier.get(tier, 0),
                "admitted": stats.admitted_by_tier.get(tier, 0),
                "completed": stats.completed_by_tier.get(tier, 0),
                "preempted": stats.preempted_by_tier.get(tier, 0),
                "ttft_p99_ms": None if p99 is None else round(p99 * 1e3, 3),
                "ttft_target_ms": None if slo.ttft_target_s is None else round(slo.ttft_target_s * 1e3, 3),
                "itl_mean_ms": None if itl is None else round(itl * 1e3, 3),
                "itl_target_ms": None if slo.itl_target_s is None else round(slo.itl_target_s * 1e3, 3),
            }
            telemetry.gauge(f"serving/priority_queue_depth/tier{tier}", depth_by_tier.get(tier, 0))
            if p99 is not None:
                telemetry.gauge(f"serving/ttft_p99_ms/tier{tier}", round(p99 * 1e3, 3))
        ttft = stats.mean_ttft_s()
        prefill_rate = stats.prefill_tok_s()
        decode_rate = stats.decode_tok_s()
        telemetry.emit_record(
            "serving",
            step=self._step_count,
            replica_id=self.replica_id,
            queue_depth=self.scheduler.queue_depth,
            slots_active=self.pool.num_active,
            num_slots=self.pool.num_slots,
            pages_in_use=pages_in_use,
            pages_total=self.pool.num_pages - 1 if self.paged else None,
            page_fragmentation=fragmentation,
            kv_dtype=getattr(self.pool, "kv_dtype", None),
            kv_bytes_per_token=kv_bytes,
            ttft_ms=None if ttft is None else round(ttft * 1e3, 3),
            prefill_tok_s=None if prefill_rate is None else round(prefill_rate, 1),
            decode_tok_s=None if decode_rate is None else round(decode_rate, 1),
            accept_rate=accept_rate,
            accepted_tokens_per_step=accepted_per_step,
            preemptions=stats.preemptions,
            pages_swapped_out=stats.pages_swapped_out,
            pages_swapped_in=stats.pages_swapped_in,
            session_hits=stats.session_hits,
            sessions_live=0 if self.prefix is None else self.prefix.sessions_live,
            tiers=tiers,
            kernels=kernel_paths(self.device),
            counters={
                "admitted": stats.admitted,
                "completed": stats.completed,
                "rejected": stats.rejected,
                "cancelled": stats.cancelled,
                "prefill_tokens": stats.prefill_tokens,
                "decode_tokens": stats.decode_tokens,
                "decode_steps": stats.decode_steps,
                "prefix_hit_tokens": stats.prefix_hit_tokens,
                "prefix_miss_tokens": stats.prefix_miss_tokens,
                "draft_tokens_proposed": stats.draft_tokens_proposed,
                "draft_tokens_accepted": stats.draft_tokens_accepted,
            },
        )


def serve_batch(engine: ServingEngine, request_specs: list[dict]) -> list[RequestState]:
    """Offline driver: feed every spec (keyword arguments of `ServingEngine.submit`)
    through the engine with queue backpressure and drain. Results come back in
    submission order."""
    states: list[RequestState] = []
    i = 0
    while i < len(request_specs):
        try:
            states.append(engine.submit(**request_specs[i]))
            i += 1
        except QueueFullError:
            engine.step()  # make room: decode progresses, slots free, queue drains
    engine.drain()
    return states
