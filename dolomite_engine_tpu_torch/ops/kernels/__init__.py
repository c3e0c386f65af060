"""Hand-written Hopper kernels of the port, one module per TPU kernel they replace.

Each module holds the CUDA kernel's wrapper (it launches the kernel for a CUDA tensor or
raises), the kernel's plain PyTorch version (taken only for a CPU tensor) and a
`KernelSpec` whose ``launches`` counts the wrapper's kernel launches.
"""

from . import paged_attention, prefill_attention, rmsnorm, rope_qkv

# every kernel on the serving path, in the order the forward reaches them
KERNELS = (rmsnorm.KERNEL, rope_qkv.KERNEL, paged_attention.KERNEL, prefill_attention.KERNEL)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
