"""KV cache pools for continuous batching: dense slot rows or a shared paged pool.

`SlotKVCachePool` (the JAX package's ``paged=False`` baseline) holds one preallocated
``[num_slots, max_len, kv_heads, head_dim]`` cache per layer: device memory scales with
the worst-case length of every slot.

`PagedKVCachePool` (the default; `dolomite_engine_tpu/serving/kv_cache.PagedKVCachePool`'s
counterpart): a fixed set of fixed-size pages (``[num_pages, page_size, kv_heads,
head_dim]`` per layer, on the model's device) shared across slots, per-slot page tables
(``[num_slots, max_pages]`` int32, host-side), refcounts for prefix sharing and
worst-case page reservations at admission. **Page 0 is the trash page** — never allocated, the write target of idle
decode rows and prefill pad tails, so garbage writes never touch live data. The device
pages are updated in place by the model's scatter (the JAX pool is rebuilt functionally
each step); the allocation state lives on the host.

``kv_dtype`` picks the pages' storage: ``"bf16"``, or the quantized ``"int8"`` /
``"fp8"`` (codes plus per-(page, kv head) fp32 scale pools, ``k_scale`` / ``v_scale`` in
each layer's dict; encode and decode in `ops/kv_quant.py`).

``oversubscribe_ratio`` > 1 lets admission promise more pages than exist (the engine's
preemption makes the shortfall safe), and `HostSwapPool` parks a preempted slot's pages in
host memory (``preemption="swap"``).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..ops.kv_quant import KV_QUANT_DTYPES, as_bytes

# per-layer {"k": pages, "v": pages} (+ {"k_scale", "v_scale"} for a quantized pool)
KVCacheList = list[dict[str, torch.Tensor]]

TRASH_PAGE = 0  # page-table sentinel: unmapped logical page / garbage-write target

# `kv_dtype` spellings: a plain storage dtype, or a quantized format (codes + scale pools).
# bf16 halves page bytes against fp32; int8 / fp8 halve them again
KV_DTYPES: dict[str, torch.dtype] = {
    "bf16": torch.bfloat16,
    **{name: storage for name, (storage, _) in KV_QUANT_DTYPES.items()},
}
QUANTIZED_KV_DTYPES = tuple(KV_QUANT_DTYPES)


def _kv_bytes_per_token(caches: KVCacheList, page_size: int | None = None) -> float:
    """Resident K/V bytes per cached token across all layers (both layouts store token
    rows as ``[.., H, D]``); a quantized pool adds its per-page scale rows amortised over
    `page_size` tokens."""
    total = 0.0
    for cache in caches:
        heads, head_dim = cache["k"].shape[2:]
        for name in ("k", "v"):
            total += heads * head_dim * cache[name].element_size()
            scale = cache.get(f"{name}_scale")
            if scale is not None and page_size:
                total += heads * scale.element_size() / page_size
    return total


class SlotKVCachePool:
    """A fixed pool of `num_slots` dense cache rows of `max_len` tokens each, on the
    model's device; allocation state lives on the host. The engine's decode forward
    writes the rows in place."""

    def __init__(
        self, model: Any, num_slots: int, max_len: int, dtype: torch.dtype | None = None, mesh: Any = None
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "a KV pool sharded over a device mesh is not ported yet: ROADMAP.md Queue A, 'Distribution'"
            )
        if num_slots <= 0 or max_len <= 0:
            raise ValueError(f"num_slots and max_len must be positive, got {num_slots}, {max_len}")
        self.num_slots = num_slots
        self.max_len = max_len
        self.caches: KVCacheList = model.init_kv_caches(num_slots, max_len, dtype)
        # pop() from the tail: slot 0 is handed out first
        self._free: list[int] = list(reversed(range(num_slots)))
        self._in_use: set[int] = set()
        # valid cache entries per slot (prompt + generated-and-written tokens); 0 for a
        # free slot, so an idle decode row masks down to its own garbage token
        self.lengths = np.zeros(num_slots, np.int32)

    @property
    def kv_bytes_per_token(self) -> float:
        """Resident K/V bytes per cached token (all layers): device-memory sizing."""
        return _kv_bytes_per_token(self.caches)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return len(self._in_use)

    @property
    def occupancy(self) -> float:
        return len(self._in_use) / self.num_slots

    def allocate(self) -> int | None:
        """Claim a free slot (lowest index first), or None when the pool is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        """Reclaim a slot. Its K/V rows stay stale (masked by length 0) until the next
        occupant's prefill overwrites them."""
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        self._in_use.remove(slot)
        self._free.append(slot)
        self.lengths[slot] = 0

    @torch.no_grad()
    def write_prefill(self, slot: int, prefill_caches: KVCacheList, length: int) -> None:
        """Copy a batch-1 prefill cache (``[1, bucket, H, D]`` per layer) into `slot` at
        positions ``[0, bucket)`` in place, and set the slot's length to the REAL prompt
        length. The pad tail ``[length, bucket)`` lands in the pool too, outside the
        validity frontier; decode overwrites it one token at a time."""
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        if not 0 < length <= self.max_len:
            raise ValueError(f"prefill length {length} is outside (0, {self.max_len}]")
        insert_slot(self.caches, prefill_caches, slot)
        self.lengths[slot] = length


def insert_slot(pool_caches: KVCacheList, prefill_caches: KVCacheList, slot: int) -> None:
    """Copy a batch-1 prefill cache (``[1, bucket, H, D]`` per layer) into row `slot` of
    dense caches at positions ``[0, bucket)``, in place."""
    for pool, new in zip(pool_caches, prefill_caches):
        bucket = new["k"].shape[1]
        pool["k"][slot, :bucket] = new["k"][0]
        pool["v"][slot, :bucket] = new["v"][0]


class PagedKVCachePool:
    """Shared page pool + per-slot page tables, with refcounts and admission reservations.

    Host-side invariants the engine and prefix cache rely on:

    - page 0 (:data:`TRASH_PAGE`) is never allocated; a page-table entry of 0 means "not
      mapped" and any device write through it lands in trash;
    - a page is writable by a slot only while that slot holds its sole reference; shared
      pages are read-only and the engine copies a partial tail page before writing (COW);
    - ``len(free pages) >= total reserved`` at ``oversubscribe_ratio`` 1.0: admission
      reserves the worst-case page count up front (`reserve`), every later `alloc_page`
      for that slot consumes the reservation, so a mid-decode allocation can never fail.
      Above 1.0 admission may promise up to ``ratio * allocatable`` pages; the engine then
      reclaims (prefix eviction, preemption) before it maps a page when `physical_free`
      is 0.
    """

    def __init__(
        self,
        model: Any,
        num_slots: int,
        max_len: int,
        page_size: int,
        num_pages: int | None = None,
        dtype: torch.dtype | None = None,
        kv_dtype: str | None = None,
        oversubscribe_ratio: float = 1.0,
    ) -> None:
        if num_slots <= 0 or max_len <= 0:
            raise ValueError(f"num_slots and max_len must be positive, got {num_slots}, {max_len}")
        if page_size <= 0 or page_size % 8 != 0:
            raise ValueError(f"page_size must be a positive multiple of 8, got {page_size}")
        if oversubscribe_ratio < 1.0:
            raise ValueError(f"oversubscribe_ratio must be >= 1.0, got {oversubscribe_ratio}")
        if kv_dtype is not None and kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {sorted(KV_DTYPES)} (or None for the model / cache "
                f"dtype), got {kv_dtype!r}"
            )
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype in QUANTIZED_KV_DTYPES
        # reservations beyond the physical pool are safe only when the engine can preempt
        # to reclaim (validated there); 1.0 keeps every reservation physically backed
        self.oversubscribe_ratio = oversubscribe_ratio
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        self.max_pages_per_slot = -(-max_len // page_size)
        if num_pages is None:
            # dense-parity capacity by default (plus the trash page)
            num_pages = 1 + num_slots * self.max_pages_per_slot
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is the trash page), got {num_pages}")
        self.num_pages = num_pages

        # pages, not slot rows: init_kv_caches with "batch" = pages, "length" = page_size.
        # A quantized pool's scale pools start at 1.0: the zeroed codes decode to 0
        self.caches: KVCacheList = model.init_kv_caches(
            num_pages, page_size, KV_DTYPES[kv_dtype] if kv_dtype else dtype
        )
        if self.quantized:
            for cache in self.caches:
                heads = cache["k"].shape[2]
                for name in ("k_scale", "v_scale"):
                    cache[name] = torch.ones((num_pages, heads), dtype=torch.float32, device=cache["k"].device)
        self.page_table = np.zeros((num_slots, self.max_pages_per_slot), np.int32)
        self.lengths = np.zeros(num_slots, np.int32)
        self.refcounts = np.zeros(num_pages, np.int32)

        self._free_slots: list[int] = list(reversed(range(num_slots)))
        self._slots_in_use: set[int] = set()
        self._free_pages: list[int] = list(reversed(range(1, num_pages)))  # page 0 = trash
        self._slot_reserved = np.zeros(num_slots, np.int32)
        self._total_reserved = 0

    # ------------------------------------------------------------------ slot API (engine)

    @property
    def num_free(self) -> int:
        return len(self._free_slots)

    @property
    def num_active(self) -> int:
        return len(self._slots_in_use)

    @property
    def occupancy(self) -> float:
        return len(self._slots_in_use) / self.num_slots

    def allocate(self) -> int | None:
        """Claim a free slot row (lowest index first), or None when all rows are taken."""
        if not self._free_slots:
            return None
        slot = self._free_slots.pop()
        self._slots_in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        """Release a slot: decref every mapped page, clear the table row, return the
        unused reservation. Freed pages keep their stale K/V, masked by the frontier."""
        if slot not in self._slots_in_use:
            raise ValueError(f"slot {slot} is not allocated")
        for i in range(self.max_pages_per_slot):
            page = int(self.page_table[slot, i])
            if page != TRASH_PAGE:
                self.decref(page)
            self.page_table[slot, i] = TRASH_PAGE
        self._slots_in_use.remove(slot)
        self._free_slots.append(slot)
        self.lengths[slot] = 0
        self._total_reserved -= int(self._slot_reserved[slot])
        self._slot_reserved[slot] = 0

    # ------------------------------------------------------------------ page accounting

    @property
    def kv_bytes_per_token(self) -> float:
        """Resident K/V bytes per cached token (all layers), with a quantized pool's scale
        rows amortised over the page: what device-memory sizing budgets by."""
        return _kv_bytes_per_token(self.caches, self.page_size)

    @property
    def page_bytes(self) -> float:
        """Resident bytes of one page across all layers, scale rows included."""
        return self.kv_bytes_per_token * self.page_size

    @property
    def pages_in_use(self) -> int:
        """Physical pages currently referenced (by slots and/or the prefix index)."""
        return (self.num_pages - 1) - len(self._free_pages)

    @property
    def physical_free(self) -> int:
        """Pages on the free list: what `alloc_page` can hand out now. Under
        oversubscription it can be less than the outstanding reservations."""
        return len(self._free_pages)

    @property
    def available_pages(self) -> int:
        """Pages admission may still promise: the (possibly oversubscribed) capacity minus
        pages referenced and outstanding reservations; at ratio 1.0, free minus reserved."""
        virtual = int(self.oversubscribe_ratio * (self.num_pages - 1))
        return virtual - self.pages_in_use - self._total_reserved

    @property
    def page_fragmentation(self) -> float:
        """Share of the allocated pages' capacity not holding valid tokens (each slot's
        partial tail page); approximate mid-prefill, where a slot's length is committed
        only at the last chunk."""
        in_use = self.pages_in_use
        if in_use == 0:
            return 0.0
        wasted = 0
        for slot in self._slots_in_use:
            length = int(self.lengths[slot])
            if length > 0 and length % self.page_size:
                wasted += self.page_size - length % self.page_size
        return wasted / (in_use * self.page_size)

    def reserve(self, slot: int, pages: int) -> None:
        """Promise `pages` future allocations to `slot`."""
        if pages < 0 or pages > self.available_pages:
            raise ValueError(
                f"cannot reserve {pages} page(s): only {self.available_pages} available"
            )
        self._slot_reserved[slot] += pages
        self._total_reserved += pages

    def alloc_page(self, slot: int, index: int) -> int:
        """Map a fresh private page (refcount 1) at logical page `index` of `slot`,
        consuming one unit of the slot's reservation. Infallible at ratio 1.0; an
        oversubscribed engine reclaims before calling when `physical_free` is 0."""
        assert self.page_table[slot, index] == TRASH_PAGE, (slot, index)
        assert self._slot_reserved[slot] > 0, f"slot {slot} has no reserved pages left"
        if not self._free_pages:
            raise RuntimeError(
                "page pool physically exhausted under oversubscription: the engine must "
                "reclaim (prefix-evict or preempt) before mapping a page"
            )
        page = self._free_pages.pop()
        self.refcounts[page] = 1
        self.page_table[slot, index] = page
        self._slot_reserved[slot] -= 1
        self._total_reserved -= 1
        return page

    def attach_shared(self, slot: int, index: int, page: int) -> None:
        """Map an existing page (a prefix-cache hit) read-only into `slot` at `index`."""
        assert self.page_table[slot, index] == TRASH_PAGE, (slot, index)
        assert page != TRASH_PAGE and self.refcounts[page] > 0, page
        self.refcounts[page] += 1
        self.page_table[slot, index] = page

    def incref(self, page: int) -> None:
        assert page != TRASH_PAGE and self.refcounts[page] > 0, page
        self.refcounts[page] += 1

    def decref(self, page: int) -> None:
        assert page != TRASH_PAGE, "decref on the trash page"
        if self.refcounts[page] <= 0:
            raise ValueError(f"page {page} double-freed (refcount {self.refcounts[page]})")
        self.refcounts[page] -= 1
        if self.refcounts[page] == 0:
            self._free_pages.append(page)

    # ------------------------------------------------------------------ device ops

    @torch.no_grad()
    def copy_page(self, src: int, dst: int) -> None:
        """Device-copy page `src` onto page `dst` in every layer (the COW step for a
        partially shared tail page). Every per-layer array is page-major, so a quantized
        pool's scale rows move with their codes."""
        for cache in self.caches:
            for array in cache.values():
                raw = as_bytes(array)
                raw[dst].copy_(raw[src])


class HostSwapPool:
    """Host-memory parking lot for preempted slots' pages (``preemption="swap"``).

    Swap-out copies a victim's physical pages of every layer (`ops/attention.
    gather_kv_pages`, a quantized pool's scale rows with them) to host memory before the
    engine frees the device pages; swap-in writes them onto freshly allocated pages
    (`scatter_kv_pages`). Both run on the current stream: swap-out's copy to pageable
    host memory returns once the bytes are on the host, so a later forward cannot
    overwrite a freed page before it was read, and swap-in's copies are ordered before
    the slot's next forward. A raw copy, so the restored pages and scales are identical
    to what went out and a swapped request continues token for token.
    """

    def __init__(self, pool: PagedKVCachePool) -> None:
        self.pool = pool
        # request_id -> (per-layer host copies [pages, ...], page count)
        self._parked: dict[int, tuple[list[dict[str, torch.Tensor]], int]] = {}
        self.bytes_out = self.bytes_in = 0
        self.seconds_out = self.seconds_in = 0.0

    @torch.no_grad()
    def swap_out(self, request_id: int, pages: list[int]) -> int:
        """Copy `pages` (chain order) to the host under `request_id`; the caller frees the
        device pages afterwards. Returns the page count."""
        from ..ops.attention import gather_kv_pages

        t0 = time.perf_counter()
        index = torch.as_tensor(pages, dtype=torch.long, device=self.pool.caches[0]["k"].device)
        payload = [{name: array.cpu() for name, array in chunk.items()} for chunk in gather_kv_pages(self.pool.caches, index)]
        self._parked[request_id] = (payload, len(pages))
        self.seconds_out += time.perf_counter() - t0
        self.bytes_out += sum(array.nbytes for chunk in payload for array in chunk.values())
        return len(pages)

    @torch.no_grad()
    def swap_in(self, request_id: int, dst_pages: list[int]) -> int:
        """Write the parked payload onto `dst_pages` (freshly allocated, chain order) and
        drop the host copy. Returns the page count."""
        from ..ops.attention import scatter_kv_pages

        payload, used = self._parked.pop(request_id)
        assert len(dst_pages) == used, (dst_pages, used)
        t0 = time.perf_counter()
        device = self.pool.caches[0]["k"].device
        index = torch.as_tensor(dst_pages, dtype=torch.long, device=device)
        scatter_kv_pages(
            self.pool.caches, [{name: array.to(device) for name, array in chunk.items()} for chunk in payload], index
        )
        self.seconds_in += time.perf_counter() - t0
        self.bytes_in += sum(array.nbytes for chunk in payload for array in chunk.values())
        return used

    def drop(self, request_id: int) -> None:
        """Discard a parked payload (the request finished or was cancelled while out)."""
        self._parked.pop(request_id, None)
