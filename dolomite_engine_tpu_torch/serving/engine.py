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
  step's dict carries the layer's ``k_scale`` / ``v_scale`` pools beside its pages.

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
(`ops/kernels/`). PyTorch runs eagerly, so there is no compiled program to count; greedy
outputs match the JAX engine token for token (tests/test_torch_serving.py). Sampled
requests draw from a per-slot `torch.Generator` seeded from the request, so their
streams differ from the JAX engine's by design.

Options of the JAX engine that this port does not carry yet raise NotImplementedError
naming the ROADMAP.md item that will port them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..ops.sampling import sample_tokens_vectorized
from ..utils import QuantileSketch
from .kv_cache import TRASH_PAGE, PagedKVCachePool, SlotKVCachePool
from .prefix_cache import PrefixCache, PrefixMatch
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
    "speculate_ngram": (False, "Speculative decoding"),
    "draft_model": (None, "Speculative decoding"),
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
    `ttft_s`, not in either rate."""

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
    session_hits: int = 0
    ttft_s_by_tier: dict[int, QuantileSketch] = field(default_factory=dict)
    itl_s_by_tier: dict[int, QuantileSketch] = field(default_factory=dict)
    admitted_by_tier: dict[int, int] = field(default_factory=dict)
    completed_by_tier: dict[int, int] = field(default_factory=dict)

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

    def ttft_p99_s(self, tier: int) -> float | None:
        sketch = self.ttft_s_by_tier.get(tier)
        return None if sketch is None else sketch.quantile(0.99)

    def itl_mean_s(self, tier: int) -> float | None:
        sketch = self.itl_s_by_tier.get(tier)
        return None if sketch is None else sketch.mean()


@dataclass
class _PrefillTask:
    """A slot whose prompt is still being computed (chunked prefill in flight)."""

    state: RequestState
    pos: int  # next prompt position to compute (prefix-cache hits start it past 0)
    prefill_ids: list[int]


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
        session_ttl_s / tier_slos: multi-turn pinning and per-tier TTFT ordering, as in
            the JAX engine.
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
        device: str | torch.device = "cuda",
        **not_ported: Any,
    ) -> None:
        self.device = resolve_device(device)
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
        if preemption != "off" and not paged:
            raise ValueError("preemption requires the paged KV pool")
        if preemption != "off" or oversubscribe_ratio != 1.0:
            raise NotImplementedError(
                "preemption and oversubscription are not ported yet: ROADMAP.md Queue A, "
                "'Preemption and oversubscription'"
            )
        if session_ttl_s <= 0:
            raise ValueError(f"session_ttl_s must be positive, got {session_ttl_s}")
        if prefill_bucket_multiple <= 0 or prefill_bucket_multiple % 8 != 0:
            raise ValueError(
                f"prefill_bucket_multiple must be a positive multiple of 8, got "
                f"{prefill_bucket_multiple}"
            )
        n_positions = getattr(model.config, "n_positions", None)
        if n_positions is not None and max_len > n_positions:
            raise ValueError(f"max_len={max_len} exceeds model n_positions={n_positions}")

        if params is not None:
            from ..models.gpt_dolomite import load_jax_params

            load_jax_params(model, params, device=self.device)
        self.model = model.to(self.device).eval()
        self.default_eos = eos_token_id
        self.pad_token_id = pad_token_id
        self.prefill_bucket_multiple = prefill_bucket_multiple
        self.session_ttl_s = session_ttl_s
        self.paged = paged
        if paged:
            self.pool: Any = PagedKVCachePool(
                model, num_slots, max_len, page_size, num_pages, cache_dtype, kv_dtype=kv_dtype
            )
            self.prefix = PrefixCache(page_size) if prefix_caching else None
        else:
            self.pool = SlotKVCachePool(model, num_slots, max_len, cache_dtype)
            self.prefix = None
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
        into free slots (a dense pool prefills them whole), advance chunked prefills up to
        the budget (paged), run one decode step over the slot batch. Returns whether any
        work remains."""
        self._cancel_expired_running()
        if self.paged:
            self._admit_paged()
            decoding = sum(1 for s in self._slot_states if s not in self._prefill_tasks)
            self._run_prefill_chunks(self.scheduler.prefill_budget(decoding))
            if any(slot not in self._prefill_tasks for slot in self._slot_states):
                self._decode_once_paged()
        else:
            self._admit()
            if self._slot_states:
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
        do_sample = np.zeros_like(self._do_sample)  # idle rows stay greedy
        do_sample[active] = self._do_sample[active]
        next_tokens = sample_tokens_vectorized(
            out.logits[:, -1], self._generators, do_sample, *self._sampling_tensors(slice(None))
        )
        tokens = next_tokens.cpu().numpy()  # host fetch: the streaming sync point
        self.stats.decode_steps += 1
        self.stats.decode_seconds += time.perf_counter() - t0
        self._emit_decoded(active, tokens)

    # ------------------------------------------------------------------ admission

    def _admit_paged(self) -> None:
        """Admit tier-then-FCFS while slot rows AND pages are available. Worst-case pages
        (minus prefix-cache hits) are reserved up front; prefix-cache-only pages are
        evicted LRU to make room. A blocked head waits at its tier's head."""
        if self.prefix is not None:
            self.prefix.expire_sessions(self.scheduler.clock())
        while True:
            state = self.scheduler.pop_next()
            if state is None:
                return
            if self.scheduler.expired(state):
                self._finish(state, RequestStatus.cancelled)
                continue
            if not self._try_admit(state):
                self.scheduler.push_front(state)
                return

    def _try_admit(self, state: RequestState) -> bool:
        """One admission attempt: claim a slot, reserve pages, set up the prefill task.
        Rolls back and returns False when slot rows or pages are short."""
        if self.pool.num_free == 0:
            return False
        request = state.request
        prefill_ids = request.prompt_ids
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
            # copied into a private page; the miss suffix is recomputed over it
            dst = self.pool.alloc_page(slot, len(match.nodes))
            self.pool.copy_page(match.cow.page, dst)
            self.pool.decref(match.cow.page)

        state.slot = slot
        state.status = RequestStatus.running
        self._slot_states[slot] = state
        self._set_sampling(slot, request)
        self._prefill_tasks[slot] = _PrefillTask(
            state=state, pos=match.resume_pos, prefill_ids=prefill_ids
        )
        self._prefill_order.append(slot)

        hit = match.resume_pos
        self.stats.prefix_hit_tokens += hit
        self.stats.prefix_miss_tokens += len(prefill_ids) - hit
        self._count_admission(state, session_hit=hit > 0)
        return True

    def _set_sampling(self, slot: int, request: Request) -> None:
        """The slot's sampling parameters, and a generator seeded from the request when it
        samples."""
        do_sample, temperature, top_k, top_p = request.sampling.encoded()
        self._do_sample[slot] = do_sample
        self._temperature[slot] = temperature
        self._top_k[slot] = top_k
        self._top_p[slot] = top_p
        self._generators[slot] = (
            torch.Generator(device=self.device).manual_seed(request.seed) if do_sample else None
        )

    def _count_admission(self, state: RequestState, session_hit: bool) -> None:
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

    # ------------------------------------------------------------------ device steps

    def _sampling_tensors(self, rows: slice | list[int]):
        device = self.device
        return (
            torch.as_tensor(self._temperature[rows], device=device),
            torch.as_tensor(self._top_k[rows], device=device),
            torch.as_tensor(self._top_p[rows], device=device),
        )

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
        at most `budget` real prompt tokens this step."""
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
            multiple = self.prefill_bucket_multiple
            width = -(-take // multiple) * multiple

            # map fresh pages under the chunk's real positions before the device write
            for index in range(task.pos // page_size, (task.pos + take - 1) // page_size + 1):
                if self.pool.page_table[slot, index] == TRASH_PAGE:
                    self.pool.alloc_page(slot, index)

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
            if final:
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

    def _decode_once_paged(self) -> None:
        decoding = [s for s in self._slot_states if s not in self._prefill_tasks]
        page_size = self.pool.page_size
        # map the page under each decoding row's write position first
        for slot in decoding:
            index = int(self.pool.lengths[slot]) // page_size
            if self.pool.page_table[slot, index] == TRASH_PAGE:
                self.pool.alloc_page(slot, index)
        # per-step table/length views: idle and mid-prefill rows are zeroed so their
        # garbage write lands in the trash page instead of live pages
        table = np.zeros_like(self.pool.page_table)
        lengths = np.zeros(self.pool.num_slots, np.int32)
        for slot in decoding:
            table[slot] = self.pool.page_table[slot]
            lengths[slot] = int(self.pool.lengths[slot])

        device = self.device
        t0 = time.perf_counter()
        table_t = torch.as_tensor(table, device=device)
        lengths_t = torch.as_tensor(lengths, device=device)
        kv = [{**c, "page_table": table_t} for c in self.pool.caches]
        out = self.model(
            torch.as_tensor(self._tokens, device=device)[:, None],
            position_ids=lengths_t[:, None],
            kv_caches=kv,
            cache_index=lengths_t,
        )
        do_sample = np.zeros_like(self._do_sample)  # idle and mid-prefill rows stay greedy
        do_sample[decoding] = self._do_sample[decoding]
        next_tokens = sample_tokens_vectorized(
            out.logits[:, -1],
            self._generators,
            do_sample,
            *self._sampling_tensors(slice(None)),
        )
        tokens = next_tokens.cpu().numpy()  # host fetch: the streaming sync point
        self.stats.decode_steps += 1
        self.stats.decode_seconds += time.perf_counter() - t0
        self._emit_decoded(decoding, tokens)

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
        if state.slot is not None:
            slot = state.slot
            self._prefill_tasks.pop(slot, None)
            if slot in self._prefill_order:
                self._prefill_order.remove(slot)
            if self.prefix is not None:
                self._register_prefix(state, slot)
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
