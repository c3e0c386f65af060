"""Per-page KV quantization: int8 / fp8 page codes with per-(page, kv-head) fp32 scales.

Counterpart of `dolomite_engine_tpu/ops/kv_quant.py`. A quantized paged pool
(`serving/kv_cache.PagedKVCachePool(kv_dtype="int8"|"fp8")`) stores its pages as codes
with a ``[num_pages, Hkv]`` fp32 scale pool per K and V. Every scatter re-encodes the
pages it writes (`ops/attention.paged_scatter_kv_quantized`, one fused kernel launch for a
layer's K and V on the card): dequantize the window, insert the new tokens, take a fresh
absmax over the page's valid rows per kv head, encode.
While a page's scale stays the same the round trip ``(code * s) / s`` gives the stored
code back, so committed tokens do not drift under repeated decode writes.

:func:`quantize_pages` is the encode on its own: the hand-written kernel
(`ops/kernels/kv_quant.py`) for CUDA tensors, :func:`quantize_pages_plain` for CPU
tensors. The two write the same bytes, so the pool's state never depends on which ran;
the fused scatter-quantize kernel encodes with the same device function.
"""

from __future__ import annotations

import torch

# kv_dtype name -> (storage dtype, symmetric clip magnitude). int8 keeps [-127, 127];
# fp8 e4m3fn saturates at +-448 and has no inf, so values are clipped before the cast
KV_QUANT_DTYPES: dict[str, tuple[torch.dtype, float]] = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}


def kv_qmax(dtype: torch.dtype) -> float:
    """Clip magnitude for a quantized page dtype (see :data:`KV_QUANT_DTYPES`)."""
    for storage, qmax in KV_QUANT_DTYPES.values():
        if dtype == storage:
            return qmax
    raise ValueError(f"{dtype} is not a quantized KV page dtype")


def is_quantized(dtype: torch.dtype) -> bool:
    return any(dtype == storage for storage, _ in KV_QUANT_DTYPES.values())


def as_bytes(tensor: torch.Tensor) -> torch.Tensor:
    """A one-byte tensor (page codes) viewed as uint8, others as they are. Gathers,
    scatters and copies of fp8 tensors are not implemented on every device; of bytes they
    are, and bytes are what the pool holds."""
    return tensor.view(torch.uint8) if tensor.element_size() == 1 else tensor


def quantize_pages(
    values: torch.Tensor, valid: torch.Tensor, qmax: float, out_dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode fp32 pages ``[N, page_size, H, D]`` to ``out_dtype`` codes with
    per-(page, head) scales ``[N, H]``.

    ``valid`` ``[N, page_size]`` marks the rows that hold real K/V; the absmax that sets
    each scale covers valid rows only, so stale rows past a page's frontier never inflate
    it. Invalid rows are still encoded (clipped into range): the attention frontier masks
    them. Launches the kernel for CUDA tensors and takes the plain version for CPU ones."""
    if values.device.type == "cpu":
        return quantize_pages_plain(values, valid, qmax, out_dtype)
    from .kernels.kv_quant import quantize_pages_kernel

    return quantize_pages_kernel(values, valid, qmax, out_dtype)


def quantize_pages_plain(
    values: torch.Tensor, valid: torch.Tensor, qmax: float, out_dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain encoding (`quantize_pages_xla` of the JAX package): the byte-level
    contract the kernel must meet."""
    masked = torch.where(valid[:, :, None, None], values, torch.zeros((), dtype=values.dtype, device=values.device))
    amax = masked.abs().amax(dim=(1, 3))  # [N, H]
    # a reciprocal-multiply with the constant rounded once to fp32, as the JAX package
    # spells it (`amax / qmax` may lower to either a divide or a multiply)
    inv_qmax = torch.tensor(1.0 / qmax, dtype=torch.float32, device=values.device)
    scales = torch.where(amax > 0, amax * inv_qmax, torch.ones_like(amax))
    scaled = values / scales[:, None, :, None]
    if not out_dtype.is_floating_point:
        scaled = torch.round(scaled)  # half to even, as jnp.round
    codes = torch.clamp(scaled, -qmax, qmax).to(out_dtype)
    return codes, scales


def dequantize_values(codes: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Decode stored codes with broadcast-ready ``scales`` back to ``dtype``."""
    return (codes.float() * scales).to(dtype)
