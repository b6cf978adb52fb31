"""Contiguous equal sharding of the data splits, in numpy.

The port's own copy of the host-side arithmetic of
``mpi_tensorflow_tpu/data/sharding.py``: sizes truncated to a multiple
of the shard count, shard ``i`` owning rows ``[i*n/k, (i+1)*n/k)`` (what
``MPI.Scatter`` of a contiguous buffer gives each rank), and the
reference's sequential wraparound batching ``offset = (step*B) % (N -
B)``.  ``host_shard`` is one rank's slice over the ``torch.distributed``
data axis (``parallel.mesh``).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np


def truncate_to_multiple(n: int, k: int) -> int:
    """``n//k*k`` — the reference's size truncation."""
    return n // k * k


def shard_bounds(n: int, num_shards: int, index: int) -> tuple[int, int]:
    """[start, stop) rows of contiguous equal shard ``index`` of ``n``
    rows (rows past ``n//num_shards*num_shards`` are dropped)."""
    if not 0 <= index < num_shards:
        raise ValueError(f"shard index {index} out of range [0, {num_shards})")
    per = n // num_shards
    return index * per, (index + 1) * per


def shard_array(x: np.ndarray, num_shards: int, index: int) -> np.ndarray:
    """The rows of ``x`` that shard ``index`` owns."""
    start, stop = shard_bounds(x.shape[0], num_shards, index)
    return x[start:stop]


def shard_arrays(arrays: Iterable[np.ndarray], num_shards: int, index: int):
    return tuple(shard_array(a, num_shards, index) for a in arrays)


def host_shard(x: np.ndarray, process_index: int | None = None,
               process_count: int | None = None) -> np.ndarray:
    """This rank's contiguous slice of ``x``: shard ``process_index``
    (default: this process's rank) of ``process_count`` (default: the
    world size) — the ``MPI.Scatter`` equivalent, with no root."""
    from mpi_tensorflow_torch.parallel import mesh

    if process_index is None:
        process_index = mesh.process_index()
    if process_count is None:
        process_count = mesh.process_count()
    return shard_array(x, process_count, process_index)


def batch_offset(step: int, batch_size: int, n: int) -> int:
    """First row of ``step``'s batch in a shard of ``n`` rows: the
    reference's wraparound ``(step*B) % (N - B)``."""
    return (step * batch_size) % (n - batch_size)


def steps_per_run(num_examples: int, batch_size: int, epochs: int) -> int:
    """``epochs * local_train_size // batch_size``."""
    return epochs * num_examples // batch_size
