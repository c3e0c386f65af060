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
from dataclasses import dataclass, field
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
    "dolo_rope_qkv": (_P,) * 4 + (_I,) * 11 + (_P,),
    "dolo_rope_qkv_paged": (_P,) * 9 + (_I,) * 19 + (_P,),
    "dolo_paged_decode": (_P,) * 11 + (_I,) * 7 + (_F, _I, _I, _P),
    "dolo_paged_decode_plan": (_I,) * 4 + (_P,),
    "dolo_paged_prefill": (_P,) * 8 + (_I,) * 7 + (_F, _I, _I, _P),
    "dolo_paged_prefill_smem_bytes": (_I,) * 4,
    "dolo_flash_fwd": (_P,) * 8 + (_I,) * 11 + (_F, _I, _P),
    "dolo_flash_bwd": (_P,) * 15 + (_I,) * 11 + (_F, _I, _P),
    "dolo_fused_ce": (_P,) * 6 + (_I,) * 3 + (_F, _I, _I, _P),
    "dolo_fused_ce_scratch_floats": (_I, _I, _I),
    "dolo_gmm": (_P,) * 5 + (_I,) * 7 + (_P,),
    "dolo_tgmm": (_P,) * 5 + (_I,) * 6 + (_P,),
    "dolo_grouped_gemm_route": (_I, _I, _I, _P, _P, _P),
    "dolo_kv_quant": (_P,) * 4 + (_I,) * 4 + (_F, _F, _I, _P),
    "dolo_kv_quant_scatter": (_P,) * 9 + (_I,) * 13 + (_F, _F, _I, _I, _P),
}

# type codes of csrc/common.cuh: the element types, then the quantized KV page types
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
ELEMENT_DTYPES = (torch.float32, torch.bfloat16)

# shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232448


@dataclass
class KernelSpec:
    """What `chip_smoke.py` reports for one kernel; `launches` counts wrapper launches,
    and `forms` the launches of each form where one kernel has several entry points."""

    name: str
    source: str  # path in the repository
    replaces: str  # file:line of the TPU (Pallas) kernel call it replaces
    launches: int = 0
    forms: dict[str, int] = field(default_factory=dict)

    def launched(self, form: str) -> None:
        """Count one launch of the kernel's `form`."""
        self.launches += 1
        self.forms[form] = self.forms.get(form, 0) + 1

    def reset(self) -> None:
        self.launches = 0
        self.forms.clear()


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


INDEX_DTYPES = {torch.int32: 1, torch.int64: 2}  # csrc/paged_write.cuh index kinds
MASK_DTYPES = {torch.int32: 1, torch.bool: 2, torch.uint8: 2, torch.int64: 3}  # and mask kinds


def window_args(cache_index, key_mask, batch: int, view_len: int, device: torch.device) -> tuple:
    """The C arguments of a paged write window (``csrc/paged_write.cuh``): the start's
    kind, tensor and stride, the scalar start, the mask's kind, tensor and row stride.
    `cache_index` is a [B] or 0-d int32 / int64 tensor on `device`, or an int; `key_mask`
    None or a [>= B, >= view_len] key-side mask of ints or bools (nonzero = valid)."""
    if isinstance(cache_index, int):
        kind, index, stride, start = 0, None, 0, cache_index
    else:
        if cache_index.device != device or cache_index.dtype not in INDEX_DTYPES:
            raise ValueError(
                f"the cache index must be an int32 / int64 tensor on {device}, got "
                f"{cache_index.dtype} on {cache_index.device}"
            )
        if cache_index.ndim == 1 and cache_index.shape[0] == batch:
            stride = cache_index.stride(0)
        elif cache_index.ndim == 0:
            stride = 0
        else:
            raise ValueError(f"the cache index must be [{batch}] or 0-d, got {tuple(cache_index.shape)}")
        kind, index, start = INDEX_DTYPES[cache_index.dtype], cache_index, 0
    if key_mask is None:
        return kind, index, stride, start, 0, None, 0
    if (
        key_mask.device != device
        or key_mask.dtype not in MASK_DTYPES
        or key_mask.ndim != 2
        or key_mask.shape[0] < batch
        or key_mask.shape[1] < view_len
        or key_mask.stride(1) != 1
    ):
        raise ValueError(
            f"the key mask must be an integer / bool [>= {batch}, >= {view_len}] tensor on {device} "
            f"with unit column stride, got {key_mask.dtype} {tuple(key_mask.shape)} on {key_mask.device}"
        )
    return kind, index, stride, start, MASK_DTYPES[key_mask.dtype], key_mask, key_mask.stride(0)
