"""Draft-token sources for speculative decoding in the serving engine.

Counterpart of `dolomite_engine_tpu/serving/speculation.py`. A drafter proposes up to K
continuation tokens per slot; the engine's verify step scores all of them in one forward
of the target over the ``[num_slots, K+1]`` window and `ops/sampling.speculative_accept`
commits the longest target-consistent prefix plus one bonus token. Both drafters propose
deterministic tokens (a point-mass q), so greedy outputs stay those of plain decode and
sampled outputs follow the target distribution:

- `NgramDrafter`: prompt lookup. The slot's recent suffix is matched against its own
  prompt and generation, and the tokens that followed the earlier occurrence are
  proposed. Host code only; a slot with no match proposes nothing and decodes plainly
  inside the same verify step.
- `DraftModelDrafter`: a smaller model of the same vocabulary drafts K greedy tokens per
  slot against its own dense KV rows, kept in step with the target's committed tokens:
  each engine step one forward ingests the tokens committed since the last step (up to
  K+1, per-row counts), then K-1 single-token forwards draft (the JAX package's `scan`
  is a Python loop here). Positions past a row's committed frontier hold stale data the
  masks hide, overwritten by the next ingest.

Both are indexed by the engine's slot ids and driven from the host.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .kv_cache import insert_slot


class NgramDrafter:
    """Prompt-lookup drafting: propose the continuation of the most recent earlier
    occurrence of the slot's current suffix in its own history.

    Suffix lengths `ngram_max` down to `ngram_min` are tried, longest first; a match must
    end before the current suffix (which trivially matches itself). Proposals hold at most
    `draft_k` tokens and may be shorter, or empty, near the history's head."""

    def __init__(self, draft_k: int, ngram_max: int = 3, ngram_min: int = 1) -> None:
        assert draft_k >= 1, draft_k
        assert 1 <= ngram_min <= ngram_max, (ngram_min, ngram_max)
        self.draft_k = draft_k
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self._history: dict[int, list[int]] = {}

    def start(self, slot: int, prompt_ids: list[int]) -> None:
        self._history[slot] = list(prompt_ids)

    def extend(self, slot: int, token: int) -> None:
        history = self._history.get(slot)
        if history is not None:
            history.append(token)

    def stop(self, slot: int) -> None:
        self._history.pop(slot, None)

    def propose(self, slot: int) -> list[int]:
        history = self._history.get(slot)
        if not history:
            return []
        tokens = np.asarray(history, np.int64)
        for n in range(self.ngram_max, self.ngram_min - 1, -1):
            if len(tokens) <= n:
                continue
            suffix = tokens[-n:]
            # windows h[i:i+n] for i < len-n (the suffix's own occurrence excluded)
            windows = np.lib.stride_tricks.sliding_window_view(tokens[:-1], n)
            matches = np.nonzero((windows == suffix).all(axis=1))[0]
            if matches.size == 0:
                continue
            starts = matches + n
            # prefer the latest occurrence with a full K-token continuation: in a periodic
            # history the latest match ends at the tail and would cut the proposal short
            full = starts[starts <= len(tokens) - self.draft_k]
            start = int(full[-1]) if full.size else int(starts[-1])
            return [int(t) for t in tokens[start : start + self.draft_k]]
        return []


class DraftModelDrafter:
    """A small greedy draft model shadowing the target's committed token stream.

    It owns per-slot dense KV rows for the draft model (``model.init_kv_caches``, the
    draft's own layers and heads, ``max_len + draft_k`` long: the draft steps write up to
    K-1 positions past the last committed token) and `seen`, how many committed tokens
    (prompt and delivered) of each slot its cache holds. The JAX drafter runs its ingest
    and draft steps as one compiled program; here they are eager forwards, so there is no
    compile count to report."""

    def __init__(
        self,
        model: Any,
        *,
        num_slots: int,
        max_len: int,
        draft_k: int,
        pad_token_id: int = 0,
        prefill_bucket_multiple: int = 64,
        cache_dtype: torch.dtype | None = None,
    ) -> None:
        assert draft_k >= 1, draft_k
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.draft_k = draft_k
        self.pad_token_id = pad_token_id
        self.prefill_bucket_multiple = prefill_bucket_multiple
        self.max_len = max_len + draft_k
        self.caches = model.init_kv_caches(num_slots, self.max_len, cache_dtype)
        self.seen = np.zeros(num_slots, np.int64)  # committed tokens resident per slot

    @torch.no_grad()
    def start(self, slot: int, prompt_ids: list[int]) -> None:
        """Prefill the draft model over the slot's prompt: one whole-prompt forward,
        right-padded to its bucket, at the python-int index 0 (the attention layer's
        prefill fast path, the padding mask as its key mask), copied into the slot's
        rows."""
        prompt_len = len(prompt_ids)
        multiple = self.prefill_bucket_multiple
        bucket = min(-(-prompt_len // multiple) * multiple, self.max_len)
        ids = np.full((1, bucket), self.pad_token_id, np.int64)
        ids[0, :prompt_len] = prompt_ids
        mask = np.zeros((1, bucket), np.int32)
        mask[0, :prompt_len] = 1
        device = self.device
        out = self.model(
            torch.as_tensor(ids, device=device),
            position_ids=torch.arange(bucket, device=device)[None, :],
            attention_mask=torch.as_tensor(mask, device=device),
            kv_caches=self.model.init_kv_caches(1, bucket, self.caches[0]["k"].dtype),
            cache_index=0,
        )
        insert_slot(self.caches, out.kv_caches, slot)
        self.seen[slot] = prompt_len

    def stop(self, slot: int) -> None:
        """Release a slot: its stale K/V stays (masked) until the next start."""
        self.seen[slot] = 0

    @torch.no_grad()
    def propose(self, windows: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Ingest each row's `counts` newly committed tokens (``windows`` [num_slots,
        K+1], right-padded) at its `seen` frontier, then draft K greedy tokens. Rows with
        count 0 (idle, mid-prefill) write masked garbage whose drafts the caller ignores.
        Advances `seen` by `counts`. Returns the drafts [num_slots, K] (host, one fetch)."""
        device = self.device
        k = self.draft_k
        seen = torch.as_tensor(self.seen, device=device)
        fresh = torch.as_tensor(counts, dtype=torch.long, device=device)
        out = self.model(
            torch.as_tensor(windows, dtype=torch.long, device=device),
            position_ids=seen[:, None] + torch.arange(k + 1, device=device)[None, :],
            kv_caches=self.caches,
            cache_index=seen,
        )
        # the logits at each row's last real ingested token condition on its whole
        # committed history: the draft's distribution for the first proposal
        rows = torch.arange(self.num_slots, device=device)
        token = out.logits[rows, (fresh - 1).clamp(min=0)].argmax(dim=-1)
        drafts = [token]
        for i in range(k - 1):
            position = seen + fresh + i  # the fed draft token's own cache position
            out = self.model(
                token[:, None], position_ids=position[:, None], kv_caches=self.caches, cache_index=position
            )
            token = out.logits[:, -1].argmax(dim=-1)
            drafts.append(token)
        self.seen += np.asarray(counts, np.int64)
        return torch.stack(drafts, dim=1).cpu().numpy()
