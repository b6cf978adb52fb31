"""Batched evaluation, numpy only.

The port's own copy of ``mpi_tensorflow_tpu/train/evaluation.py``:

- ``eval_in_batches``: full batches in sequence, the tail by re-running
  the last full window and keeping its overlap (every call one shape);
  raises when the data is smaller than one batch;
- ``shard_error_rates``: the error % of each shard's contiguous slice
  of the test set, the reference's per-rank trace; ``error_rate`` (from
  ``data.idx``) gives the global one.
"""

from __future__ import annotations

import numpy as np

from mpi_tensorflow_torch.data.idx import error_rate


def eval_in_batches(predict_fn, data, batch_size: int) -> np.ndarray:
    """``predict_fn(batch) -> probs`` over ``data`` in fixed-size
    batches, the tail by the overlapped final window."""
    size = data.shape[0]
    if size < batch_size:
        raise ValueError(
            "batch size for evals larger than dataset: %d" % size)
    out = None
    for begin in range(0, size, batch_size):
        end = begin + batch_size
        if end <= size:
            preds = np.asarray(predict_fn(data[begin:end]))
        else:
            preds = np.asarray(predict_fn(data[-batch_size:]))[begin - size:]
        if out is None:
            out = np.empty((size, preds.shape[-1]), dtype=np.float32)
        out[begin:begin + preds.shape[0]] = preds
    return out


def shard_error_rates(predictions: np.ndarray, labels: np.ndarray,
                      num_shards: int) -> list[float]:
    """Per-shard error % over contiguous equal slices."""
    n = predictions.shape[0] // num_shards * num_shards
    per = n // num_shards
    return [error_rate(predictions[i * per:(i + 1) * per],
                       labels[i * per:(i + 1) * per])
            for i in range(num_shards)]
