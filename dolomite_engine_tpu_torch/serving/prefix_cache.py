"""Host-side prefix index over page-aligned prompt prefixes (RadixAttention-style).

(Copy of `dolomite_engine_tpu/serving/prefix_cache.py`: pure host bookkeeping.)

Shared system prompts and chat templates dominate real traffic, so the K/V a prefill
computes is usually mostly *re*-computation. This index maps page-aligned token prefixes
to resident pages of a :class:`~dolomite_engine_tpu_torch.serving.kv_cache.PagedKVCachePool` so
an admitted request whose prefix is resident skips that prefill entirely (SGLang, Zheng
et al. 2024 — here a token-keyed radix tree over fixed-size pages).

Correctness hinges on *chain* identity, not page content: the K/V inside page *m* depend
on every token before it (attention is causal), so a node is keyed by its whole history —
two prompts that share page-*m* tokens but differ earlier never alias. Pages are shared at
full-page granularity, read-only (`attach_shared` increfs); the one mutation pattern is
copy-on-write of a *partially* matching tail page: the donor page is device-copied into a
fresh private page and the non-matching suffix is recomputed over the copy.

The index holds its own reference on every registered page, keeping it resident after the
owning request finishes. When admission runs short of pages, `evict` releases
least-recently-used **leaf** entries (children are keyed under their parents, so evicting
an interior node would orphan reachable state); pages still shared with live slots are
never reclaimed.

**Sessions** (multi-turn retention): a conversation's chain can be *pinned* under a
session id (`pin_session`) — pinned nodes are exempt from LRU eviction while the session
is live, so a follow-up turn hits even under heavy unrelated traffic. Sessions expire on
a TTL (`expire_sessions`, clock provided by the caller) or refresh on `touch_session`;
``evict(..., include_pinned=True)`` is the engine's last-resort escape hatch so a pinned
chain can never wedge page reclamation outright.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field


@dataclass
class PrefixNode:
    """One full page of tokens at a fixed chain position, mapped to a physical page."""

    tokens: tuple[int, ...]
    page: int
    parent: "PrefixNode | None" = None
    children: dict[tuple[int, ...], "PrefixNode"] = field(default_factory=dict)
    last_used: int = 0
    depth: int = 0  # page index within the chain (absolute positions [depth*P, (depth+1)*P))
    pinned: int = 0  # live sessions holding this node (exempt from LRU while > 0)


@dataclass
class _Session:
    """One live conversation: the pinned chain of its latest turn + its expiry clock."""

    nodes: list[PrefixNode]
    expires_at: float


@dataclass
class PrefixMatch:
    """Outcome of matching a prompt against the index.

    ``nodes`` are full-page hits (shareable read-only, in chain order); ``cow`` is an
    optional partially-matching next page — ``cow_len`` of its leading tokens equal the
    prompt's continuation, so copying it saves recomputing those. ``resume_pos`` is the
    first prompt position prefill still has to compute; it is always ``< len(prompt)``
    because the last prompt token must be recomputed to produce first-token logits."""

    nodes: list[PrefixNode]
    cow: PrefixNode | None
    cow_len: int
    resume_pos: int

    @property
    def hit_tokens(self) -> int:
        return self.resume_pos


class PrefixCache:
    """Token-keyed page index with LRU leaf eviction and session pinning. Pure host
    bookkeeping; session expiry runs on a caller-supplied clock value."""

    def __init__(self, page_size: int) -> None:
        self.page_size = page_size
        self.root = PrefixNode(tokens=(), page=-1, depth=-1)
        self._num_entries = 0
        self._clock = itertools.count(1)
        self._sessions: dict[str, _Session] = {}

    def __len__(self) -> int:
        return self._num_entries

    # ------------------------------------------------------------------ lookup

    def match(self, prompt_ids: list[int]) -> PrefixMatch:
        """Longest resident chain for `prompt_ids`, capped so at least one prompt token
        is left to recompute (its logits seed the first sampled token)."""
        page = self.page_size
        prompt_len = len(prompt_ids)
        now = next(self._clock)

        nodes: list[PrefixNode] = []
        pos = 0
        cur = self.root
        while pos + page <= prompt_len:
            child = cur.children.get(tuple(prompt_ids[pos : pos + page]))
            if child is None:
                break
            child.last_used = now
            nodes.append(child)
            cur = child
            pos += page

        cow: PrefixNode | None = None
        cow_len = 0
        if pos == prompt_len and nodes:
            # every full page hit and the prompt is page-aligned: the last page cannot be
            # shared read-only (decode would write position prompt_len into it and the
            # last token still needs recomputing) — demote it to a COW copy instead
            cow = nodes.pop()
            pos -= page
            cow_len = page
        elif pos < prompt_len:
            remainder = prompt_ids[pos:prompt_len]
            for tokens, child in cur.children.items():
                matched = _common_prefix_len(tokens, remainder)
                if matched > cow_len:
                    cow, cow_len = child, matched
            if cow is not None:
                cow.last_used = now

        resume = min(pos + cow_len, prompt_len - 1)
        return PrefixMatch(nodes=nodes, cow=cow, cow_len=cow_len, resume_pos=resume)

    def probe_len(self, prompt_ids: list[int]) -> int:
        """Resident-prefix length for `prompt_ids` WITHOUT touching LRU clocks — the
        router's affinity probe (serving/cluster/router.py) must not promote entries it
        is merely considering, or probing N replicas would wreck every replica's LRU
        order. Full-page hits only (the COW tail saves a copy, not a prefill skip)."""
        page = self.page_size
        pos = 0
        cur = self.root
        while pos + page <= len(prompt_ids):
            child = cur.children.get(tuple(prompt_ids[pos : pos + page]))
            if child is None:
                break
            cur = child
            pos += page
        return pos

    # ------------------------------------------------------------------ insertion

    def register(self, token_ids: list[int], page_ids: list[int], pool) -> int:
        """Index the full pages of a finished sequence (`token_ids` are the tokens whose
        K/V are resident — prompt plus written generated tokens; `page_ids` the slot's
        page table entries, chain order). Already-indexed chain positions are kept (the
        resident page holds identical K/V — same tokens, same positions, deterministic
        model); new nodes take one index reference on their page. Returns #new entries."""
        page = self.page_size
        added = 0
        now = next(self._clock)
        cur = self.root
        for i in range(len(token_ids) // page):
            tokens = tuple(token_ids[i * page : (i + 1) * page])
            child = cur.children.get(tokens)
            if child is None:
                child = PrefixNode(
                    tokens=tokens, page=page_ids[i], parent=cur, depth=i, last_used=now
                )
                pool.incref(page_ids[i])
                cur.children[tokens] = child
                self._num_entries += 1
                added += 1
            else:
                child.last_used = now
            cur = child
        return added

    # ------------------------------------------------------------------ sessions

    def pin_session(self, session_id: str, token_ids: list[int], now: float, ttl_s: float) -> int:
        """Pin the registered chain for `token_ids` under `session_id` until ``now +
        ttl_s``: the chain's nodes become exempt from LRU eviction while the session is
        live. Re-pinning the same session (the next turn of the conversation) replaces
        the pinned chain — pins never stack across turns. Returns #nodes pinned."""
        chain: list[PrefixNode] = []
        cur = self.root
        page = self.page_size
        for i in range(len(token_ids) // page):
            child = cur.children.get(tuple(token_ids[i * page : (i + 1) * page]))
            if child is None:
                break
            chain.append(child)
            cur = child
        previous = self._sessions.pop(session_id, None)
        if previous is not None:
            for node in previous.nodes:
                node.pinned -= 1
        for node in chain:
            node.pinned += 1
        self._sessions[session_id] = _Session(nodes=chain, expires_at=now + ttl_s)
        return len(chain)

    def touch_session(self, session_id: str, now: float, ttl_s: float) -> bool:
        """Refresh a live session's TTL. Returns whether the session was live (an
        expired or unknown id returns False and stays unpinned — the caller treats the
        request as a fresh conversation and re-pins on finish)."""
        session = self._sessions.get(session_id)
        if session is None:
            return False
        if session.expires_at < now:
            self._expire(session_id)
            return False
        session.expires_at = now + ttl_s
        return True

    def expire_sessions(self, now: float) -> int:
        """Unpin every session whose TTL lapsed; their pages return to plain LRU order.
        Returns the number of sessions expired."""
        lapsed = [sid for sid, s in self._sessions.items() if s.expires_at < now]
        for sid in lapsed:
            self._expire(sid)
        return len(lapsed)

    @property
    def sessions_live(self) -> int:
        return len(self._sessions)

    def _expire(self, session_id: str) -> None:
        session = self._sessions.pop(session_id)
        for node in session.nodes:
            node.pinned -= 1

    # ------------------------------------------------------------------ eviction

    def evict(self, pages_needed: int, pool, include_pinned: bool = False) -> int:
        """Release index references until `pages_needed` pages came free (or nothing more
        is evictable). Only LRU *leaves* whose page the index alone still references are
        candidates; freeing a leaf can expose its parent, so sweep until a pass frees
        nothing. Session-pinned nodes are skipped unless ``include_pinned`` — the
        engine's last resort when every unpinned page is spoken for, so a pinned chain
        degrades to recompute instead of wedging allocation. Returns pages freed."""
        freed = 0
        while freed < pages_needed:
            candidates = [
                node
                for node in self._iter_nodes()
                if not node.children
                and pool.refcounts[node.page] == 1
                and (include_pinned or node.pinned == 0)
            ]
            if not candidates:
                break
            victim = min(candidates, key=lambda node: node.last_used)
            self._remove(victim, pool)
            freed += 1
        return freed

    def clear(self, pool) -> int:
        """Drop every entry and session, releasing the index's page references (pages a
        running slot also holds stay with it): what `ServingEngine.swap_params` does, since
        K/V computed under the old weights must not be reused under the new. Returns the
        entries dropped."""
        dropped = 0
        for node in list(self._iter_nodes()):
            pool.decref(node.page)
            dropped += 1
        self.root = PrefixNode(tokens=(), page=-1, depth=-1)
        self._num_entries = 0
        self._sessions = {}
        return dropped

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _remove(self, node: PrefixNode, pool) -> None:
        assert not node.children, "evicting an interior node would orphan its children"
        del node.parent.children[node.tokens]
        pool.decref(node.page)
        self._num_entries -= 1


def _common_prefix_len(a: tuple[int, ...], b: list[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n
