"""Attention ops: masks, eager attention, the training dispatch, paged scatter/gather.

Counterpart of `dolomite_engine_tpu/ops/attention.py` for the paged serving path and the
dense training path. All shapes are batch-first: q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D].
Packed (padding-free) batches carry segment ids [B, S] (0 = padding, 1.. = documents).
Paged pools are ``[num_pages, page_size, Hkv, D]`` with page 0 as the trash page; a
quantized pool holds int8 / fp8 codes with ``[num_pages, Hkv]`` fp32 scale pools.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..enums import AttentionImplementation
from .kv_quant import as_bytes, dequantize_values, kv_qmax, quantize_pages_plain

NEG_INF = float(torch.finfo(torch.float32).min)


def make_attention_mask(
    batch_size: int,
    query_length: int,
    key_length: int,
    causal: bool = True,
    attention_mask: torch.Tensor | None = None,
    query_offset: torch.Tensor | int = 0,
    device: torch.device | None = None,
    segment_ids_q: torch.Tensor | None = None,
    segment_ids_kv: torch.Tensor | None = None,
) -> torch.Tensor | None:
    """Boolean [B, 1, Sq, Skv] mask (True = attend), or None when fully visible.

    ``query_offset`` may be a per-row [B] tensor: every row continues at its own cache
    position, so query i of row b sees keys up to ``query_offset[b] + i``. Segment ids
    keep each query inside its own document, and keys of segment 0 (padding) are never
    visible."""
    if attention_mask is not None:
        device = attention_mask.device
    elif isinstance(query_offset, torch.Tensor):
        device = query_offset.device
    elif segment_ids_q is not None or segment_ids_kv is not None:
        device = (segment_ids_q if segment_ids_q is not None else segment_ids_kv).device
    mask = None
    if causal:
        q_idx = torch.arange(query_length, device=device)
        k_pos = torch.arange(key_length, device=device)
        if isinstance(query_offset, torch.Tensor) and query_offset.ndim == 1:
            q_pos = q_idx[None, :, None] + query_offset.to(device)[:, None, None]
            mask = (k_pos[None, None, :] <= q_pos)[:, None]  # [B, 1, Sq, Skv]
        else:
            q_pos = q_idx[:, None] + query_offset
            mask = (k_pos[None, :] <= q_pos)[None, None]
    if attention_mask is not None:
        pad = attention_mask.bool()[:, None, None, :]  # [B, 1, 1, Skv]
        mask = pad if mask is None else mask & pad
    if segment_ids_q is not None or segment_ids_kv is not None:
        if segment_ids_kv is None:
            segment_ids_kv = segment_ids_q
        if segment_ids_q is None:
            segment_ids_q = segment_ids_kv
        seg = segment_ids_q[:, None, :, None] == segment_ids_kv[:, None, None, :]
        seg = seg & (segment_ids_kv != 0)[:, None, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def _repeat_kv(k: torch.Tensor, num_query_heads: int) -> torch.Tensor:
    num_kv = k.shape[2]
    if num_kv == num_query_heads:
        return k
    return k.repeat_interleave(num_query_heads // num_kv, dim=2)


def eager_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,
    softmax_scale: float,
    softmax_in_fp32: bool = True,
    dropout: float = 0.0,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Explicit QK^T -> softmax -> V: scores scaled by `softmax_scale`, plus the additive
    `bias` (alibi: ``[B, H, 1, Skv]``) in the scores' dtype, masked with the float32-min
    constant, softmax upcast to fp32, probabilities cast back to the input dtype (and
    dropped out at rate `dropout`) before the PV product. Returns [B, Sq, Hq, D]."""
    input_dtype = q.dtype
    k = _repeat_kv(k, q.shape[2])
    v = _repeat_kv(v, q.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * softmax_scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    if mask is not None:
        # a cast, not a checked fill: in bf16 the float32 minimum rounds to -inf, exactly
        # as the JAX package's weakly typed constant does
        scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device).to(scores.dtype))
    if softmax_in_fp32:
        scores = scores.float()
    probs = torch.softmax(scores, dim=-1).to(input_dtype)
    if dropout > 0.0:
        probs = F.dropout(probs, dropout)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def sdpa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,
    softmax_scale: float,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """The JAX package's `sdpa_attention` (`jax.nn.dot_product_attention`, its XLA form):
    fp32 scores of the inputs' products, scaled, plus the additive `bias` in fp32,
    masked with ``-0.7 * float32 max``, an fp32 softmax, probabilities cast to the
    keys' dtype for the PV product. A query with no visible key (a pad query under a
    padding mask rewritten to segment ids) gets a uniform, finite row, where
    `eager_attention` in bf16 fills with -inf and gives NaN. Returns [B, Sq, Hq, D]."""
    k = _repeat_kv(k, q.shape[2])
    v = _repeat_kv(v, q.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * softmax_scale
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = torch.where(mask, scores, -0.7 * torch.finfo(torch.float32).max)
    probs = torch.softmax(scores, dim=-1).to(k.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    softmax_scale: float | None = None,
    attention_mask: torch.Tensor | None = None,
    softmax_in_fp32: bool = True,
    query_offset: torch.Tensor | int = 0,
    implementation: AttentionImplementation | str = AttentionImplementation.sdpa,
    segment_ids: torch.Tensor | None = None,
    dropout: float = 0.0,
    alibi_bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dispatch one attention call; returns [B, Sq, Hq, D].

    The JAX package's conditions, with "the tensors are on a CUDA device" in place of
    "the backend is a TPU": ``flash_attention_2`` without dropout or a mask, with
    q_len == kv_len and the length a multiple of 128, runs a flash kernel; a causal
    key-padding mask is first rewritten to segment ids (pad = 0, real = 1). A causal call
    without a bias takes the causal / segment-id form (where JAX takes splash); an
    `alibi_bias` added to the scaled scores (alibi's key row ``[B, Hq, 1, Skv]``, or T5's
    relative bias ``[1 or B, Hq, Sq, Skv]``, which varies along the queries and may require
    grad) or ``causal=False`` takes the additive-bias / non-causal form (where JAX takes
    jax's flash kernel).
    Every other call is masked attention with the bias: `eager_attention` for the
    ``eager`` implementation or with dropout, else `sdpa_attention`, as in JAX."""
    from .kernels.flash_attention import flash_attention

    implementation = AttentionImplementation(implementation)
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    if (
        implementation == AttentionImplementation.flash_attention_2
        and attention_mask is not None
        and attention_mask.ndim == 2  # key-side [B, S] padding mask
        and segment_ids is None
        and causal
        and q.shape[1] == k.shape[1]
        and isinstance(query_offset, int)
        and query_offset == 0
    ):
        # pad queries attend only among themselves (segment 0); their outputs are never read
        segment_ids = attention_mask.to(torch.int32)
        attention_mask = None

    use_flash = (
        implementation == AttentionImplementation.flash_attention_2
        and q.device.type == "cuda"
        and dropout == 0.0
        and attention_mask is None
        and q.shape[1] == k.shape[1]
        and q.shape[1] % 128 == 0
    )
    if use_flash:
        bias = alibi_bias
        if bias is not None and bias.shape[2] == 1:  # alibi: one key row per (batch, head)
            bias = bias[:, :, 0, :].expand(q.shape[0], q.shape[2], k.shape[1])
        return flash_attention(q, k, v, segment_ids, softmax_scale, bias, causal)

    if segment_ids is not None and q.shape[1] != k.shape[1]:
        raise NotImplementedError("packed segment attention with KV cache is not supported")
    mask = make_attention_mask(
        q.shape[0],
        q.shape[1],
        k.shape[1],
        causal=causal,
        attention_mask=attention_mask,
        query_offset=query_offset,
        device=q.device,
        segment_ids_q=segment_ids,
    )
    if implementation == AttentionImplementation.eager or dropout > 0.0:
        return eager_attention(
            q, k, v, mask, softmax_scale, softmax_in_fp32=softmax_in_fp32, dropout=dropout,
            bias=alibi_bias,
        )
    return sdpa_attention(q, k, v, mask, softmax_scale, bias=alibi_bias)


def write_positions(
    cache_index: torch.Tensor | int,
    key_mask: torch.Tensor | None,
    view_len: int,
    batch: int,
    seq: int,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(positions, write_valid)`` ``[B, S]`` of a paged write window: row b writes at
    ``cache_index[b] + s`` for a [B] index (a decode or verify step, each row at its own
    frontier) or at ``start + s`` for a scalar one (a prefill chunk). Positions past the
    view (`view_len`) are clamped to 0 and invalid, as are those the key-side mask
    ``[B, view_len]`` marks 0 (a chunk's pad tail): the JAX package's
    `_update_paged_kv_cache` rules, which `csrc/paged_write.cuh` repeats."""
    steps = torch.arange(seq, dtype=torch.int32, device=device)
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        positions = cache_index.to(device=device, dtype=torch.int32)[:, None] + steps[None, :]
    else:
        start = torch.as_tensor(cache_index, dtype=torch.int32, device=device)
        positions = (start + steps)[None, :].expand(batch, seq)
    in_range = positions < view_len
    positions = torch.where(in_range, positions, torch.zeros_like(positions))
    write_valid = in_range
    if key_mask is not None:
        write_valid = write_valid & torch.gather(key_mask.bool(), 1, positions.long())
    return positions, write_valid


def paged_scatter_kv(
    pages: torch.Tensor,
    new: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
    write_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scatter new K (or V) tokens ``[B, S, H, D]`` into the pool IN PLACE and return it.

    ``page_table`` [B, max_pages] maps each row's logical pages to physical ones;
    ``positions`` [B, S] are the absolute token positions being written. Writes through
    a 0 table entry (an idle row) or with ``write_valid == False`` (a chunk's right-pad
    tail) land at flat index 0 of the trash page, whose content is never attended; which
    of several colliding writes wins there does not matter. The JAX package returns a
    new pool; updating in place keeps one copy of the pool on the device."""
    num_pages, page_size = pages.shape[:2]
    batch, seq = positions.shape
    positions = positions.long()
    page_ids = torch.gather(page_table.long(), 1, positions // page_size)  # [B, S]
    flat_index = page_ids * page_size + positions % page_size
    if write_valid is not None:
        flat_index = torch.where(write_valid, flat_index, torch.zeros_like(flat_index))
    flat_pages = pages.view((num_pages * page_size,) + tuple(pages.shape[2:]))
    flat_pages[flat_index.reshape(-1)] = new.reshape((batch * seq,) + tuple(new.shape[2:])).to(
        pages.dtype
    )
    return pages


def gather_kv_pages(caches: list[dict[str, torch.Tensor]], page_index: torch.Tensor) -> list[dict[str, torch.Tensor]]:
    """Copies of whole physical pages of a paged pool: ``page_index`` [W] physical page
    ids, every per-layer array page-major, so a quantized pool's per-(page, head) scale
    rows come out with their codes (fp8 codes as their bytes, `as_bytes`). The swap-out
    half of preemption: the result goes to host memory and the device pages are freed.
    The JAX package's `gather_kv_pages`, which computes it outside any kernel, as here."""
    return [{name: as_bytes(array).index_select(0, page_index) for name, array in cache.items()} for cache in caches]


def scatter_kv_pages(
    caches: list[dict[str, torch.Tensor]], payload: list[dict[str, torch.Tensor]], page_index: torch.Tensor
) -> None:
    """The swap-in half: write `payload` (a `gather_kv_pages` result, on the pool's
    device) onto the physical pages ``page_index`` [W] of every layer, IN PLACE. A raw
    copy, so page bytes and scale rows come back exactly as they went out."""
    for cache, chunk in zip(caches, payload):
        for name, array in cache.items():
            as_bytes(array).index_copy_(0, page_index, chunk[name])


def paged_gather_kv(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Gather each row's pages into a contiguous ``[B, max_pages * page_size, H, D]`` view.

    Positions past a row's frontier read whatever the mapped page holds (stale K/V,
    trash) — finite values the attention mask turns into exactly-zero probability."""
    num_pages, page_size = pages.shape[:2]
    batch, max_pages = page_table.shape
    flat_pages = pages.reshape((num_pages * page_size,) + tuple(pages.shape[2:]))
    index = (
        page_table.long()[:, :, None] * page_size
        + torch.arange(page_size, device=page_table.device)
    ).reshape(batch, max_pages * page_size)
    return flat_pages[index]


def paged_scatter_kv_quantized(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    page_table: torch.Tensor,
    cache_index: torch.Tensor | int,
    key_mask: torch.Tensor | None = None,
) -> None:
    """Quantize a layer's new K and V ``[B, S, Hkv, D]`` into their quantized pools, IN
    PLACE, at the write window of `cache_index` and `key_mask` (`write_positions`).

    For CUDA tensors one launch of the fused scatter-quantize kernel
    (`ops/kernels/kv_quant.paged_scatter_kv_quantized_kernel`) does both; for CPU tensors
    `paged_write_kv_quantized_plain` computes the positions and runs
    `paged_scatter_kv_quantized_plain` for K and then V. Pages 1.. and their scales end
    byte-identical either way."""
    if key.device.type == "cpu":
        paged_write_kv_quantized_plain(
            k_pages, v_pages, k_scales, v_scales, key, value, page_table, cache_index, key_mask
        )
        return
    from .kernels.kv_quant import paged_scatter_kv_quantized_kernel

    paged_scatter_kv_quantized_kernel(
        k_pages, v_pages, k_scales, v_scales, key, value, page_table, cache_index, key_mask
    )


def paged_write_kv_quantized_plain(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    page_table: torch.Tensor,
    cache_index: torch.Tensor | int,
    key_mask: torch.Tensor | None = None,
) -> None:
    """The plain version of `paged_scatter_kv_quantized`, on any device: the window's
    positions, then the plain quantizing scatter of K and of V."""
    batch, seq = key.shape[:2]
    view_len = page_table.shape[1] * k_pages.shape[1]
    positions, write_valid = write_positions(cache_index, key_mask, view_len, batch, seq, key.device)
    for pages, scales, new in ((k_pages, k_scales, key), (v_pages, v_scales, value)):
        paged_scatter_kv_quantized_plain(pages, scales, new, page_table, positions, write_valid)


def paged_scatter_kv_quantized_plain(
    pages: torch.Tensor,
    scales: torch.Tensor,
    new: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
    write_valid: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize-on-scatter into a quantized pool, IN PLACE; returns ``(pages, scales)``.

    ``pages`` holds codes ``[num_pages, page_size, H, D]`` with per-(page, head) fp32
    ``scales`` ``[num_pages, H]``. Each row's write window ``positions`` (contiguous:
    ``cache_index + arange(S)``) touches at most ``span = (S - 1) // page_size + 2``
    logical pages; those are gathered, dequantized, the valid new tokens inserted, and
    every page re-encoded (`ops/kv_quant.quantize_pages_plain`) with a fresh absmax over its
    valid rows: the committed prefix plus this call's writes, never stale rows past the
    frontier. Only pages that received a write go back; the window's other pages (the
    look-ahead pad of the bound, unmapped pages) are redirected to the trash page 0, so a
    mapped page is only rewritten by the row that owns it. The steps and the bytes are
    those of the JAX package's function, which returns new arrays instead."""
    num_pages, page_size, heads, head_dim = pages.shape
    batch, seq = positions.shape
    max_pages = page_table.shape[1]
    device = pages.device
    span = (seq - 1) // page_size + 2
    window_len = span * page_size
    positions = positions.long()
    base = positions[:, 0] // page_size  # [B]: positions[:, 0] is the row's frontier
    logical = base[:, None] + torch.arange(span, device=device)[None, :]
    in_table = logical < max_pages
    phys = torch.where(
        in_table, torch.gather(page_table.long(), 1, logical.clamp(0, max_pages - 1)), 0
    )  # [B, span]

    # dequantize the touched window into rows [0, window_len); the extra last row takes
    # the invalid writes (dropped below)
    window = torch.empty((batch, window_len + 1, heads, head_dim), dtype=torch.float32, device=device)
    codes = as_bytes(pages)[phys].view(pages.dtype)  # [B, span, page_size, H, D]
    window[:, :window_len] = dequantize_values(
        codes, scales[phys][:, :, None, :, None], torch.float32
    ).reshape(batch, window_len, heads, head_dim)
    local = torch.where(write_valid, positions - base[:, None] * page_size, window_len)
    rows = torch.arange(batch, device=device)[:, None].expand(batch, seq)
    window[rows, local] = new.float()
    written = torch.zeros((batch, window_len + 1), dtype=torch.bool, device=device)
    written[rows, local] = True
    window, written = window[:, :window_len], written[:, :window_len]
    grid = base[:, None] * page_size + torch.arange(window_len, device=device)[None, :]
    valid = (grid < positions[:, :1]) | written  # committed prefix + this call's writes

    new_codes, new_scales = quantize_pages_plain(
        window.reshape(batch * span, page_size, heads, head_dim),
        valid.reshape(batch * span, page_size),
        kv_qmax(pages.dtype),
        pages.dtype,
    )
    page_written = written.reshape(batch, span, page_size).any(-1)
    dst = torch.where(page_written & in_table, phys, 0).reshape(-1)
    as_bytes(pages)[dst] = as_bytes(new_codes)
    scales[dst] = new_scales
    return pages, scales


def paged_gather_kv_dequant(
    pages: torch.Tensor, scales: torch.Tensor, page_table: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """Dequantizing `paged_gather_kv`: each row's quantized pages as a contiguous ``[B,
    max_pages * page_size, H, D]`` view in ``dtype``, each page times its per-head scale.
    Positions past a row's frontier decode stale but finite values the mask zeroes."""
    page_size = pages.shape[1]
    batch, max_pages = page_table.shape
    codes = paged_gather_kv(as_bytes(pages), page_table).view(pages.dtype)
    codes = codes.reshape((batch, max_pages, page_size) + tuple(pages.shape[2:]))
    page_scales = scales[page_table.long()][:, :, None, :, None]  # [B, max_pages, 1, H, 1]
    return dequantize_values(codes, page_scales, dtype).reshape(
        (batch, max_pages * page_size) + tuple(pages.shape[2:])
    )
