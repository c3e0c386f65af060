"""ctypes bridge to the native index helpers + vectorized numpy fallbacks.

Counterpart of `dolomite_engine_tpu/data/megatron/native/__init__.py`, with the same
`helpers.cpp` (a copy) and the same numpy paths. The shared library is built with
`g++ -O3 -shared` at first use into the gitignored ``dolomite_engine_tpu_torch/build/``
(never next to the source), keyed by a hash of the source, and loaded with ctypes. Where
no compiler is available the numpy paths run; `tests/test_torch_megatron.py` holds the
two against each other.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ....utils import log_rank_0

_SOURCE = Path(__file__).resolve().with_name("helpers.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
_LIB: ctypes.CDLL | None = None
_COMPILE_FAILED = False


def _so_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"megatron_helpers-{digest}.so"


def compile_helpers() -> bool:
    """Compile helpers.cpp into the build directory (idempotent). Returns True when the
    library is usable. The build writes a temporary file and renames it, so concurrent
    builders never leave a torn library."""
    global _COMPILE_FAILED
    so_path = _so_path()
    if so_path.exists():
        return True
    if _COMPILE_FAILED:
        return False
    tmp_path = None
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(suffix=".so", dir=_BUILD_DIR, delete=False) as tmp:
            tmp_path = tmp.name
        subprocess.run(
            ["g++", "-O3", "-Wall", "-shared", "-std=c++17", "-fPIC", str(_SOURCE), "-o", tmp_path],
            check=True,
            capture_output=True,
        )
        os.replace(tmp_path, so_path)
        log_rank_0(logging.INFO, f"compiled megatron native helpers into {so_path}")
        return True
    except (subprocess.CalledProcessError, OSError) as e:
        if tmp_path is not None and os.path.exists(tmp_path):
            os.unlink(tmp_path)
        _COMPILE_FAILED = True
        log_rank_0(logging.WARNING, f"native helpers compile failed ({e}); using numpy fallback")
        return False


def _get_lib() -> ctypes.CDLL | None:
    global _LIB
    if _LIB is not None:
        return _LIB
    if not compile_helpers():
        return None
    lib = ctypes.CDLL(str(_so_path()))

    lib.build_blending_indices.argtypes = [
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int32,
        ctypes.c_int64,
    ]
    lib.build_blending_indices.restype = None
    for name, doc_t in (("build_sample_idx_int32", ctypes.c_int32), ("build_sample_idx_int64", ctypes.c_int64)):
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.POINTER(doc_t),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(doc_t),
            ctypes.c_int32,
            ctypes.c_int64,
        ]
        fn.restype = None

    _LIB = lib
    return lib


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------- blending indices
def build_blending_indices(
    weights: list[float] | np.ndarray, size: int, use_native: bool | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy max-error weighted blending (reference helpers.cpp:17-71).

    Returns (dataset_index int16 [size], dataset_sample_index int64 [size]).
    """
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    dataset_index = np.zeros(size, dtype=np.int16)
    dataset_sample_index = np.zeros(size, dtype=np.int64)

    lib = _get_lib() if use_native in (None, True) else None
    if lib is not None:
        lib.build_blending_indices(
            _ptr(dataset_index, ctypes.c_int16),
            _ptr(dataset_sample_index, ctypes.c_int64),
            _ptr(weights, ctypes.c_double),
            len(weights),
            size,
        )
        return dataset_index, dataset_sample_index

    # numpy fallback (inherently sequential; loop in python)
    current = np.zeros(len(weights), dtype=np.int64)
    for i in range(size):
        errors = weights * max(float(i), 1.0) - current
        d = int(np.argmax(errors))
        dataset_index[i] = d
        dataset_sample_index[i] = current[d]
        current[d] += 1
    return dataset_index, dataset_sample_index


# ---------------------------------------------------------------------------- sample index
def build_sample_idx(
    sizes: np.ndarray,
    doc_idx: np.ndarray,
    sequence_length: int,
    num_epochs: int,
    tokens_per_epoch: int,
    use_native: bool | None = None,
) -> np.ndarray:
    """Token-window -> (doc, offset) sample index (reference helpers.cpp:72-226).

    Sample i covers tokens [i*seq_len, (i+1)*seq_len] (inclusive; one-token overlap) of the
    stream formed by concatenating documents in doc_idx order.
    """
    assert sizes.dtype == np.int32
    num_samples = (num_epochs * tokens_per_epoch - 1) // sequence_length

    lib = _get_lib() if use_native in (None, True) else None
    if lib is not None:
        doc_idx = np.ascontiguousarray(doc_idx)
        sizes = np.ascontiguousarray(sizes)
        if doc_idx.dtype == np.int32:
            sample_idx = np.zeros((num_samples + 1, 2), dtype=np.int32)
            lib.build_sample_idx_int32(
                _ptr(sample_idx, ctypes.c_int32),
                _ptr(sizes, ctypes.c_int32),
                _ptr(doc_idx, ctypes.c_int32),
                sequence_length,
                num_samples,
            )
        elif doc_idx.dtype == np.int64:
            sample_idx = np.zeros((num_samples + 1, 2), dtype=np.int64)
            lib.build_sample_idx_int64(
                _ptr(sample_idx, ctypes.c_int64),
                _ptr(sizes, ctypes.c_int32),
                _ptr(doc_idx, ctypes.c_int64),
                sequence_length,
                num_samples,
            )
        else:
            raise ValueError(f"unexpected doc_idx dtype {doc_idx.dtype}")
        return sample_idx

    return _build_sample_idx_numpy(sizes, doc_idx, sequence_length, num_samples)


def _build_sample_idx_numpy(
    sizes: np.ndarray, doc_idx: np.ndarray, sequence_length: int, num_samples: int
) -> np.ndarray:
    """Vectorized equivalent: sample i starts at stream position i*seq_len; map positions to
    (document, offset) with a searchsorted over the cumulative document lengths."""
    doc_lengths = sizes[doc_idx].astype(np.int64)
    cumulative = np.concatenate([[0], np.cumsum(doc_lengths)])

    positions = np.arange(num_samples + 1, dtype=np.int64) * sequence_length
    doc_index = np.searchsorted(cumulative, positions, side="right") - 1
    offsets = positions - cumulative[doc_index]

    out_dtype = doc_idx.dtype if doc_idx.dtype in (np.int32, np.int64) else np.int64
    sample_idx = np.empty((num_samples + 1, 2), dtype=out_dtype)
    sample_idx[:, 0] = doc_index
    sample_idx[:, 1] = offsets
    return sample_idx


def normalize(weights) -> list[float]:
    w = np.array(weights, dtype=np.float64)
    return (w / w.sum()).tolist()
