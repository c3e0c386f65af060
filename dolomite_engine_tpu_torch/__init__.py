"""dolomite_engine_tpu_torch: the PyTorch + CUDA port of dolomite_engine_tpu for NVIDIA
Hopper GPUs.

The JAX package stays the reference; this package mirrors its layout (`models/`, `ops/`,
`serving/`) and replaces each TPU (Pallas) kernel on a ported path with a CUDA kernel
written for ``sm_90a`` (``csrc/``, built at first use). Entry points run on the GPU unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch version runs.
"""

from .device import resolve_device
