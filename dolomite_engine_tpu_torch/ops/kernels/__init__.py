"""Hand-written Hopper kernels of the port, one module per TPU kernel they replace.

Each module holds the CUDA kernel's wrapper (it launches the kernel for a CUDA tensor or
raises), the kernel's plain PyTorch version (taken only for a CPU tensor) and a
`KernelSpec` whose ``launches`` counts the wrapper's kernel launches (and ``forms`` each
form's, where a kernel has several: rope_qkv's flat and paged forms, kv_quant's encode and
fused scatter).
"""

from . import (
    flash_attention,
    fused_ce,
    kv_quant,
    moe,
    paged_attention,
    prefill_attention,
    rmsnorm,
    rope_qkv,
)

# every kernel entry point: the serving path's (the quantized pool's kv_quant last), then
# the training path's, then MoE's, then the additive-bias / non-causal flash form
KERNELS = (
    rmsnorm.KERNEL,
    rope_qkv.KERNEL,
    paged_attention.KERNEL,
    prefill_attention.KERNEL,
    kv_quant.KERNEL,
    flash_attention.FWD_KERNEL,
    flash_attention.BWD_KERNEL,
    fused_ce.KERNEL,
    moe.KERNEL,
    moe.TGMM_KERNEL,
    flash_attention.BIAS_FWD_KERNEL,
    flash_attention.BIAS_BWD_KERNEL,
)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.reset()
