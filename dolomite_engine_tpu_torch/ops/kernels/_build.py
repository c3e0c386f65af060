"""Build and load the port's hand-written CUDA kernels.

All kernels live in ``dolomite_engine_tpu_torch/csrc/`` as CUDA C++ with a plain C
interface. At first use they are compiled for Hopper (``sm_90a``) by ``nvcc`` — one
process per source, all started together, then one link — into a single shared library
under ``dolomite_engine_tpu_torch/build/<hash of the sources and flags>/``, and loaded
with ``ctypes``. Nothing here runs at import time, so the CPU tests import every kernel
module without a compiler or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
LIBRARY_NAME = "libdolomite_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argtypes; every function returns its launch's cudaError_t as an int
_SIGNATURES = {
    "dolo_rmsnorm": (_P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    "dolo_rope_qkv": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "dolo_paged_decode": (_P,) * 11 + (_I,) * 7 + (_F, _I, _I, _P),
    "dolo_paged_decode_plan": (_I,) * 4 + (_P,),
    "dolo_paged_prefill": (_P,) * 8 + (_I,) * 7 + (_F, _I, _I, _P),
    "dolo_paged_prefill_smem_bytes": (_I,) * 4,
    "dolo_flash_fwd": (_P,) * 7 + (_I,) * 9 + (_F, _I, _P),
    "dolo_flash_bwd": (_P,) * 12 + (_I,) * 9 + (_F, _I, _P),
    "dolo_fused_ce": (_P,) * 6 + (_I,) * 3 + (_F, _I, _I, _P),
    "dolo_fused_ce_scratch_floats": (_I, _I),
    "dolo_gmm": (_P,) * 5 + (_I,) * 7 + (_P,),
    "dolo_tgmm": (_P,) * 5 + (_I,) * 6 + (_P,),
    "dolo_grouped_gemm_route": (_I, _I, _I, _P, _P, _P),
    "dolo_kv_quant": (_P,) * 4 + (_I,) * 4 + (_F, _F, _I, _P),
}

# type codes of csrc/common.cuh: the element types, then the quantized KV page types
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
ELEMENT_DTYPES = (torch.float32, torch.bfloat16)

# shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232448


@dataclass
class KernelSpec:
    """What `chip_smoke.py` reports for one kernel; `launches` counts wrapper launches."""

    name: str
    source: str  # path in the repository
    replaces: str  # file:line of the TPU (Pallas) kernel call it replaces
    launches: int = 0


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for candidate in candidates:
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit on PATH")


def build_library(out_dir: Path) -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link one shared library into
    `out_dir`. The ptxas report (registers, shared memory, spills) is kept beside it."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir, prefix="tmp-"))
    try:
        units = [p for p in _sources() if p.suffix == ".cu"]
        procs = [
            (
                unit,
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(unit), "-o", str(work / (unit.stem + ".o"))],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                ),
            )
            for unit in units
        ]
        logs = []
        failed = []
        for unit, proc in procs:
            output, _ = proc.communicate()
            logs.append(f"== {unit.name}\n{output}")
            if proc.returncode != 0:
                failed.append(unit.name)
        (out_dir / "ptxas.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_lib = work / LIBRARY_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp_lib)]
            + [str(work / (u.stem + ".o")) for u in units],
            capture_output=True,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        lib_path = out_dir / LIBRARY_NAME
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent builder sees all or nothing
        return lib_path
    finally:
        shutil.rmtree(work, ignore_errors=True)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use if the sources changed since the last build."""
    out_dir = BUILD_DIR / _digest()
    lib_path = out_dir / LIBRARY_NAME
    if not lib_path.exists():
        build_library(out_dir)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def current_stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(tensor: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if tensor is None else tensor.data_ptr())


def check_cuda_tensor(
    tensor: torch.Tensor, name: str, device: torch.device, dtypes=ELEMENT_DTYPES
) -> None:
    """Raise on what a kernel does not take: another device, dtype, or a strided view."""
    if tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")
    if tensor.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {tensor.dtype}, expected one of {dtypes}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
