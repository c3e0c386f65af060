"""Memory-mapped token dataset: the Megatron ``.bin``/``.idx`` on-disk format (a copy of
`dolomite_engine_tpu/data/megatron/indexed_dataset.py`).

Parity: reference `data/megatron/indexed_dataset.py` (632 LoC) — same byte-exact on-disk
layout (``MMIDIDX`` header, version, dtype code, sequence lengths int32, byte pointers int64,
document indices int64, optional per-sequence modes int8) so existing corpora tokenized for the
GPU engine load unchanged. The implementation is framework-free numpy (no torch Dataset base);
pointer building is vectorized instead of the reference's Python loop.

Layout of the ``.idx`` file::

    9s  b"MMIDIDX\\x00\\x00"        header
    <Q  1                           version
    <B  dtype code                  (see DTYPES)
    <Q  sequence_count
    <Q  document_count
    int32[sequence_count]           sequence lengths (in tokens)
    int64[sequence_count]           byte offset of each sequence in the .bin
    int64[document_count]           sequence indices marking document ends (first entry 0)
    int8[sequence_count]            modes (only when multimodal)

The ``.bin`` file is the raw concatenation of token arrays.
"""

from __future__ import annotations

import os
import shutil
import struct

import numpy as np

_INDEX_HEADER = b"MMIDIDX\x00\x00"

# code <-> numpy dtype (reference DType enum, codes are part of the on-disk format)
DTYPES: dict[int, type] = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float64,
    7: np.float32,
    8: np.uint16,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


def dtype_code(dtype) -> int:
    return _DTYPE_CODES[np.dtype(dtype)]


def optimal_dtype(vocab_size: int | None) -> type:
    """Smallest token dtype for a vocabulary (reference DType.optimal_dtype)."""
    if vocab_size is not None and vocab_size < 65500:
        return np.uint16
    return np.int32


def get_idx_path(path_prefix: str) -> str:
    return path_prefix + ".idx"


def get_bin_path(path_prefix: str) -> str:
    return path_prefix + ".bin"


class _Index:
    """Parsed view of an ``.idx`` file (kept mmap-backed; zero-copy reads)."""

    def __init__(self, idx_path: str, multimodal: bool = False) -> None:
        with open(idx_path, "rb") as stream:
            header = stream.read(9)
            if header != _INDEX_HEADER:
                raise ValueError(f"bad index header in {idx_path}")
            (version,) = struct.unpack("<Q", stream.read(8))
            if version != 1:
                raise ValueError(f"unsupported index version {version} in {idx_path}")
            (code,) = struct.unpack("<B", stream.read(1))
            self.dtype = DTYPES[code]
            self.dtype_size = np.dtype(self.dtype).itemsize
            (self.sequence_count,) = struct.unpack("<Q", stream.read(8))
            (self.document_count,) = struct.unpack("<Q", stream.read(8))
            offset = stream.tell()

        self._mmap = np.memmap(idx_path, mode="r", order="C")
        buffer = memoryview(self._mmap)
        self.sequence_lengths = np.frombuffer(
            buffer, dtype=np.int32, count=self.sequence_count, offset=offset
        )
        offset += self.sequence_lengths.nbytes
        self.sequence_pointers = np.frombuffer(
            buffer, dtype=np.int64, count=self.sequence_count, offset=offset
        )
        offset += self.sequence_pointers.nbytes
        self.document_indices = np.frombuffer(
            buffer, dtype=np.int64, count=self.document_count, offset=offset
        )
        offset += self.document_indices.nbytes

        self.sequence_modes = None
        if multimodal:
            self.sequence_modes = np.frombuffer(
                buffer, dtype=np.int8, count=self.sequence_count, offset=offset
            )

        assert self.sequence_lengths.shape[0] == self.sequence_count
        assert self.document_indices[-1] == self.sequence_count

    def __len__(self) -> int:
        return self.sequence_count


class MMapIndexedDataset:
    """Reader over a ``.bin``/``.idx`` pair; items are numpy token arrays."""

    def __init__(self, path_prefix: str, multimodal: bool = False) -> None:
        self.path_prefix = path_prefix
        self.multimodal = multimodal
        self.index = _Index(get_idx_path(path_prefix), multimodal)
        self._bin_mmap = np.memmap(get_bin_path(path_prefix), mode="r", order="C")
        self._bin = memoryview(self._bin_mmap)

    # pickling support so datasets can cross process boundaries (loader workers)
    def __getstate__(self) -> tuple[str, bool]:
        return self.path_prefix, self.multimodal

    def __setstate__(self, state: tuple[str, bool]) -> None:
        self.__init__(*state)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int):
        return self.get(idx)

    def get(self, idx: int, offset: int = 0, length: int | None = None) -> np.ndarray:
        """Tokens of sequence `idx`, optionally a [offset, offset+length) window."""
        pointer = int(self.index.sequence_pointers[idx])
        seq_length = int(self.index.sequence_lengths[idx])
        if length is None:
            length = seq_length - offset
        pointer += offset * self.index.dtype_size
        sequence = np.frombuffer(self._bin, dtype=self.index.dtype, count=length, offset=pointer)
        if self.index.sequence_modes is not None:
            return sequence, self.index.sequence_modes[idx]
        return sequence

    @property
    def sequence_lengths(self) -> np.ndarray:
        return self.index.sequence_lengths

    @property
    def document_indices(self) -> np.ndarray:
        return self.index.document_indices

    @property
    def sequence_modes(self) -> np.ndarray | None:
        return self.index.sequence_modes

    @staticmethod
    def exists(path_prefix: str) -> bool:
        return os.path.exists(get_idx_path(path_prefix)) and os.path.exists(
            get_bin_path(path_prefix)
        )


class MMapIndexedDatasetBuilder:
    """Writer producing the same ``.bin``/``.idx`` pair (reference builder, torch-free)."""

    def __init__(self, bin_path: str, dtype=np.int32, multimodal: bool = False) -> None:
        self._data_file = open(bin_path, "wb")
        self.dtype = dtype
        self.multimodal = multimodal
        self._sequence_lengths: list[int] = []
        self._document_indices: list[int] = [0]
        self._sequence_modes: list[int] | None = [] if multimodal else None

    def add_item(self, tokens, mode: int = 0) -> None:
        array = np.asarray(tokens, dtype=self.dtype)
        self._data_file.write(array.tobytes(order="C"))
        self._sequence_lengths.append(array.size)
        if self.multimodal:
            self._sequence_modes.append(mode)

    def end_document(self) -> None:
        self._document_indices.append(len(self._sequence_lengths))

    def add_document(self, tokens, lengths: list[int], modes: list[int] | None = None) -> None:
        array = np.asarray(tokens, dtype=self.dtype)
        self._data_file.write(array.tobytes(order="C"))
        self._sequence_lengths.extend(lengths)
        self._document_indices.append(len(self._sequence_lengths))
        if self.multimodal:
            self._sequence_modes.extend(modes if modes is not None else [0] * len(lengths))

    def add_index(self, path_prefix: str) -> None:
        """Concatenate a whole existing dataset (used by shard merging)."""
        index = _Index(get_idx_path(path_prefix), self.multimodal)
        assert index.dtype == self.dtype, "dtype mismatch when merging indexed datasets"

        offset = len(self._sequence_lengths)
        self._sequence_lengths.extend(index.sequence_lengths.tolist())
        self._document_indices.extend((offset + index.document_indices[1:]).tolist())
        if self.multimodal:
            self._sequence_modes.extend(index.sequence_modes.tolist())

        with open(get_bin_path(path_prefix), "rb") as f:
            shutil.copyfileobj(f, self._data_file)

    def finalize(self, idx_path: str) -> None:
        self._data_file.close()
        with open(idx_path, "wb") as f:
            f.write(_INDEX_HEADER)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", dtype_code(self.dtype)))
            f.write(struct.pack("<Q", len(self._sequence_lengths)))
            f.write(struct.pack("<Q", len(self._document_indices)))

            lengths = np.asarray(self._sequence_lengths, dtype=np.int32)
            f.write(lengths.tobytes(order="C"))

            # byte pointer of each sequence: exclusive cumsum of lengths * itemsize
            pointers = np.zeros(len(lengths), dtype=np.int64)
            if len(lengths) > 1:
                np.cumsum(
                    lengths[:-1].astype(np.int64) * np.dtype(self.dtype).itemsize,
                    out=pointers[1:],
                )
            f.write(pointers.tobytes(order="C"))

            f.write(np.asarray(self._document_indices, dtype=np.int64).tobytes(order="C"))
            if self.multimodal:
                f.write(np.asarray(self._sequence_modes, dtype=np.int8).tobytes(order="C"))
