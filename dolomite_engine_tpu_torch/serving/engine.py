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
seeded from the request, so their streams differ from the JAX engine's by design. The
tracing spans and telemetry counters of the JAX engine wait for ROADMAP.md Queue A,
'Serving fleet and observability'.

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
from ..utils import QuantileSketch
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
    "prefill_only": (False, "Serving fleet and observability"),
    "trace_requests": (False, "Serving fleet and observability"),
    "signature_records": (False, "Serving fleet and observability"),
    "slo_monitor": (None, "Serving fleet and observability"),
    "flight_recorder": (None, "Serving fleet and observability"),
    "record_interval": (0, "Serving fleet and observability"),
    "replica_id": (None, "Serving fleet and observability"),
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
        device: where the model and pool live; the GPU unless ``"cpu"`` is asked for.
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
        if kv_dtype is not None and not paged:
            raise ValueError("kv_dtype (quantized / low-bit KV) requires the paged KV pool")
        if preemption not in ("off", "swap", "recompute"):
            raise ValueError(
                f"preemption must be 'off', 'swap', or 'recompute', got {preemption!r}"
            )
        if preemption != "off" and not paged:
            raise ValueError("preemption requires the paged KV pool")
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
        self.model = model.to(self.device).eval()
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
    ) -> RequestState:
        """Enqueue a request (tier-then-FCFS; ``priority`` 0 is the top tier). `seed`
        seeds the request's sampling generator (drawn from the engine's when None).
        Raises QueueFullError at the queue bound and ValueError when the request cannot
        fit a slot."""
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
            return self.scheduler.submit(request)
        except (QueueFullError, ValueError):
            self.stats.rejected += 1
            raise

    # ------------------------------------------------------------------ engine loop

    def has_work(self) -> bool:
        return self.scheduler.queue_depth > 0 or bool(self._slot_states)

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration: reap deadline-expired slots, admit waiting requests
        into free slots (a dense pool prefills them whole; with preemption on, lower
        tiers are evicted for a blocked head), advance chunked prefills up to the budget
        (paged), run one decode or verify step over the slot batch. Returns whether any
        work remains."""
        self._cancel_expired_running()
        if self.paged:
            self._admit_paged()
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
        return self.has_work()

    def drain(self) -> None:
        """Run until every submitted request finished."""
        while self.step():
            pass

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

        device = self.device
        t0 = time.perf_counter()
        # right-padded: token i sits at cache position i, so the slot's frontier is its length
        out = self.model(
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
        out = self.model(
            torch.as_tensor(self._tokens, device=device)[:, None],
            position_ids=lengths[:, None],
            kv_caches=self.pool.caches,
            cache_index=lengths,
        )
        next_tokens = sample_tokens_vectorized(
            out.logits[:, -1], self._generators, self._rows_sampling(active), *self._sampling_tensors(slice(None))
        )
        tokens = next_tokens.cpu().numpy()  # host fetch: the streaming sync point
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
            if self._try_admit(state):
                continue
            admitted = False
            while self.preemption != "off":
                victim = self._pick_victim(below_tier=state.request.priority)
                if victim is None:
                    break
                self._preempt(victim)
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
        if shortfall > 0 and self.prefix is not None:
            self.prefix.evict(shortfall, self.pool)
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
        if resume is None:
            self._count_admission(state, session_hit=hit > 0)
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
        if request.session_id is not None and self.prefix is not None:
            live = self.prefix.touch_session(
                request.session_id, self.scheduler.clock(), self.session_ttl_s
            )
            if live and session_hit:
                self.stats.session_hits += 1

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
                self.stats.pages_swapped_out += self._swap.swap_out(state.request.request_id, pages)
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
            for index in range(task.pos // page_size, (task.pos + take - 1) // page_size + 1):
                if self.pool.page_table[slot, index] == TRASH_PAGE:
                    self._alloc_page_reclaiming(slot, index)
            if self._slot_states.get(slot) is not state:
                continue  # reclamation preempted this very task; pick again

            ids = np.full((1, width), self.pad_token_id, np.int64)
            ids[0, :take] = prefill_ids[task.pos : task.pos + take]
            mask = np.zeros((1, view_len), np.int32)
            mask[0, : task.pos + take] = 1  # resident prefix + this chunk's real tokens

            t0 = time.perf_counter()
            table_row = torch.as_tensor(self.pool.page_table[slot : slot + 1], device=device)
            kv = [{**c, "page_table": table_row} for c in self.pool.caches]
            position_ids = torch.arange(task.pos, task.pos + width, device=device)[None, :]
            out = self.model(
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
            task.pos += take
            budget -= take

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
                continue
            if self.speculating:
                self._spec_start(slot, prefill_ids)
            self._record_first_token(state, first_token)

    def _record_first_token(self, state: RequestState, token: int) -> None:
        """End the request's TTFT clock and stream its first token from its slot."""
        state.first_token_t = self.scheduler.clock()
        if state.ttft_s is not None:
            self.stats.ttft_s.append(state.ttft_s)
            tier = state.request.priority
            self.stats.ttft_s_by_tier.setdefault(tier, QuantileSketch()).append(state.ttft_s)
        self._tokens[state.slot] = token
        self._deliver(state, token)

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
        out = self.model(
            torch.as_tensor(self._tokens, device=device)[:, None],
            position_ids=lengths[:, None],
            kv_caches=kv,
            cache_index=lengths,
        )
        next_tokens = sample_tokens_vectorized(
            out.logits[:, -1], self._generators, self._rows_sampling(decoding), *self._sampling_tensors(slice(None))
        )
        tokens = next_tokens.cpu().numpy()  # host fetch: the streaming sync point
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
        t0 = time.perf_counter()
        # one copy to the device: the window (the fed token, the drafts) and the draft counts
        packed = torch.as_tensor(np.concatenate([self._tokens[:, None], drafts, num_drafts[:, None]], axis=1), device=device)
        positions = lengths[:, None] + torch.arange(k + 1, device=device)[None, :]
        out = self.model(packed[:, : k + 1], position_ids=positions, kv_caches=kv_caches, cache_index=lengths)
        accepted, bonus = speculative_accept(
            out.logits,
            packed[:, 1 : k + 1],
            packed[:, k + 1],
            self._generators,
            self._rows_sampling(decoding),
            *self._sampling_tensors(slice(None)),
        )
        accepted, bonus = torch.stack([accepted, bonus]).cpu().numpy()  # host fetch: the streaming sync point
        self.stats.decode_steps += 1
        self.stats.decode_seconds += time.perf_counter() - t0
        self._emit_verified(decoding, drafts, num_drafts, accepted, bonus)

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
        self, decoding: list[int], drafts: np.ndarray, num_drafts: np.ndarray, accepted: np.ndarray, bonus: np.ndarray
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
            emitted_total += len(emit)
            for token in emit:
                self._deliver(state, token)
                if state.done:
                    break
        self.stats.decode_tokens += emitted_total
        self.stats.draft_tokens_proposed += proposed_total
        self.stats.draft_tokens_accepted += accepted_total

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
            emitted += 1
            self._deliver(state, token)
        self.stats.decode_tokens += emitted

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
        if status == RequestStatus.completed:
            self.stats.completed += 1
            self.stats.completed_by_tier[tier] = self.stats.completed_by_tier.get(tier, 0) + 1
        else:
            self.stats.cancelled += 1
        if state.first_token_t is not None and state.num_generated > 1:
            itl = (state.finish_t - state.first_token_t) / (state.num_generated - 1)
            self.stats.itl_s_by_tier.setdefault(tier, QuantileSketch()).append(itl)
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
