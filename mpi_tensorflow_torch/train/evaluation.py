"""Batched evaluation on the host, and its split over the ``data`` axis.

The port's own copy of ``mpi_tensorflow_tpu/train/evaluation.py``:

- ``eval_sharded``: the reference's ``eval_in_batches`` — full batches
  in sequence, the tail by re-running the last full window and keeping
  its overlap (every call one shape), raising when the data is smaller
  than one batch — with each rank predicting its ``batch / world`` rows
  of every window, the tail window included, then one gather: the rows
  the JAX package's ``P("data")`` eval gives each shard
  (``step.py:264-283``).  Under avg50 the ranks' replicas differ, so
  which replica predicts a row is part of the result;
- ``eval_sharded_fused``: the same rows and result from one call over
  this rank's rows of every window stacked (K, b, ...), the counterpart
  of the reference's ``eval_in_batches_fused`` (one dispatch; one graph
  replay on the card, ``train.step.make_multi_eval_step``);
- ``shard_error_rates``: the error % of each shard's contiguous slice
  of the test set, the reference's per-rank trace; ``error_rate`` (from
  ``data.idx``) gives the global one.
"""

from __future__ import annotations

import numpy as np

from mpi_tensorflow_torch.data.idx import error_rate
from mpi_tensorflow_torch.parallel import collectives


def eval_windows(size: int, batch_size: int) -> list:
    """``[(begin, start), ...]``: the window ``[start, start +
    batch_size)`` whose predictions from row ``begin`` on land at
    ``begin``; the tail re-runs the last full window (``start < begin``).
    """
    if size < batch_size:
        raise ValueError(
            "batch size for evals larger than dataset: %d" % size)
    return [(begin, min(begin, size - batch_size))
            for begin in range(0, size, batch_size)]


def eval_sharded(predict_fn, data, batch_size: int, rank: int,
                 world: int) -> np.ndarray:
    """``predict_fn(batch) -> probs`` over ``data`` in windows of
    ``batch_size`` rows (the tail by the overlapped final window), split
    over the ranks: rank ``rank`` of ``world`` predicts rows ``[r*b,
    (r+1)*b)`` of every window (b = ``batch_size / world``) with its own
    ``predict_fn``, and one ``host_allgather`` assembles the windows on
    every rank."""
    if batch_size % world:
        raise ValueError(f"eval batch {batch_size} is not {world} equal "
                         f"shards")
    windows = eval_windows(data.shape[0], batch_size)
    b = batch_size // world
    local = np.stack([np.asarray(predict_fn(
        data[s + rank * b:s + (rank + 1) * b])) for _, s in windows])
    return _assemble(local, windows, data.shape[0], batch_size, world)


def rank_windows(data, batch_size: int, rank: int, world: int):
    """(K, batch_size / world, ...): rank ``rank``'s rows of every eval
    window of ``data`` (``eval_sharded``'s), stacked."""
    if batch_size % world:
        raise ValueError(f"eval batch {batch_size} is not {world} equal "
                         f"shards")
    b = batch_size // world
    return np.stack([data[s + rank * b:s + (rank + 1) * b]
                     for _, s in eval_windows(data.shape[0], batch_size)])


def eval_sharded_fused(predict_multi_fn, windows, size: int,
                       batch_size: int, world: int) -> np.ndarray:
    """``eval_sharded``'s result over ``size`` rows from ONE call of
    ``predict_multi_fn(windows) -> (K, b, C)``, ``windows`` being this
    rank's ``rank_windows`` of the data (as the caller keeps them: on
    the card, uploaded once)."""
    local = np.asarray(predict_multi_fn(windows))
    return _assemble(local, eval_windows(size, batch_size), size,
                     batch_size, world)


def _assemble(local, windows, size: int, batch_size: int,
              world: int) -> np.ndarray:
    """Every rank's (K, b, C) predictions gathered into (size, C)."""
    every = collectives.host_allgather(local) if world > 1 else local[None]
    # (world, K, b, C) -> (K, world * b, C): window k's rows in rank order
    preds = every.transpose(1, 0, 2, 3).reshape(len(windows), batch_size,
                                                -1)
    out = np.empty((size, preds.shape[-1]), dtype=np.float32)
    for (begin, start), p in zip(windows, preds):
        rows = p[begin - start:]
        out[begin:begin + rows.shape[0]] = rows
    return out


def shard_error_rates(predictions: np.ndarray, labels: np.ndarray,
                      num_shards: int) -> list[float]:
    """Per-shard error % over contiguous equal slices."""
    n = predictions.shape[0] // num_shards * num_shards
    per = n // num_shards
    return [error_rate(predictions[i * per:(i + 1) * per],
                       labels[i * per:(i + 1) * per])
            for i in range(num_shards)]
