"""IDX (MNIST) file format reader and writer, numpy only.

The port's own copy of ``mpi_tensorflow_tpu/data/idx.py``: images come
out as ``float32 (N, 28, 28, 1)`` in ``[-0.5, 0.5]`` via ``(pixel -
127.5) / 255``, labels as ``int64 (N,)``, the buffers the reference MPI
script scatters.  IDX is big-endian: magic ``\\x00\\x00<dtype><ndim>``,
``ndim`` uint32 dims, then the raw array; a ``.gz`` path is gzipped.
"""

from __future__ import annotations

import gzip
import struct
from typing import BinaryIO

import numpy as np

# dtype byte -> numpy dtype (big-endian where multi-byte)
_IDX_DTYPES = {
    0x08: np.dtype(np.uint8),
    0x09: np.dtype(np.int8),
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}
_DTYPE_TO_CODE = {
    np.dtype(np.uint8): 0x08,
    np.dtype(np.int8): 0x09,
    np.dtype(np.int16): 0x0B,
    np.dtype(np.int32): 0x0C,
    np.dtype(np.float32): 0x0D,
    np.dtype(np.float64): 0x0E,
}
PIXEL_DEPTH = 255.0


def _open(path: str, mode: str) -> BinaryIO:
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_idx(path: str, max_items: int | None = None) -> np.ndarray:
    """An (optionally gzipped) IDX file as a numpy array; ``max_items``
    truncates the leading dimension without reading the rest."""
    with _open(path, "rb") as f:
        magic = f.read(4)
        if len(magic) != 4 or magic[0] != 0 or magic[1] != 0:
            raise ValueError(f"{path}: not an IDX file (bad magic {magic!r})")
        dtype_code, ndim = magic[2], magic[3]
        if dtype_code not in _IDX_DTYPES:
            raise ValueError(f"{path}: unknown IDX dtype 0x{dtype_code:02x}")
        dtype = _IDX_DTYPES[dtype_code]
        dims = list(struct.unpack(f">{ndim}I", f.read(4 * ndim)))
        if max_items is not None and dims:
            dims[0] = min(dims[0], max_items)
        count = int(np.prod(dims)) if dims else 1
        buf = f.read(count * dtype.itemsize)
        if len(buf) != count * dtype.itemsize:
            raise ValueError(f"{path}: truncated IDX payload")
        return np.frombuffer(buf, dtype=dtype).reshape(dims)


def write_idx(path: str, array: np.ndarray) -> None:
    """Write ``array`` as an (optionally gzipped) IDX file."""
    dtype = np.dtype(array.dtype)
    if dtype not in _DTYPE_TO_CODE:
        raise ValueError(f"cannot encode dtype {dtype} as IDX")
    with _open(path, "wb") as f:
        f.write(bytes([0, 0, _DTYPE_TO_CODE[dtype], array.ndim]))
        f.write(struct.pack(f">{array.ndim}I", *array.shape))
        f.write(np.ascontiguousarray(
            array, dtype=dtype.newbyteorder(">")).tobytes())


def extract_images(path: str, num_images: int | None = None) -> np.ndarray:
    """IDX image file -> ``float32 (N, H, W, 1)`` in ``[-0.5, 0.5]``."""
    raw = read_idx(path, max_items=num_images)
    if raw.ndim != 3:
        raise ValueError(f"{path}: expected 3-D image IDX, got {raw.ndim}-D")
    data = (raw.astype(np.float32) - PIXEL_DEPTH / 2.0) / PIXEL_DEPTH
    return data[..., np.newaxis]


def extract_labels(path: str, num_labels: int | None = None) -> np.ndarray:
    """IDX label file -> ``int64 (N,)``."""
    raw = read_idx(path, max_items=num_labels)
    if raw.ndim != 1:
        raise ValueError(f"{path}: expected 1-D label IDX, got {raw.ndim}-D")
    return raw.astype(np.int64)


def error_rate(predictions: np.ndarray, labels: np.ndarray) -> float:
    """Classification error percent of softmax predictions: ``100 - 100
    * correct / total``."""
    correct = np.sum(np.argmax(predictions, axis=1) == labels)
    return 100.0 - 100.0 * float(correct) / predictions.shape[0]
