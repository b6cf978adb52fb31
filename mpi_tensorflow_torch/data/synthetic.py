"""Deterministic synthetic masked-LM data (numpy only).

The port's own copy of ``mlm_batches`` from
``mpi_tensorflow_tpu/data/synthetic.py``: the same draws in the same
order from ``numpy.random.default_rng(seed)``, so one seed gives the
same bytes in both packages.
"""

from __future__ import annotations

import numpy as np


def mlm_batches(num_examples: int, *, seq_len: int, vocab_size: int,
                mask_token: int = 4, mask_rate: float = 0.15,
                seed: int = 0):
    """Synthetic masked-LM data: piecewise-constant runs of 8 tokens with
    2 % noise, so a masked token is recoverable from its neighbours.

    Returns ``(tokens, targets, mask)``: ``tokens`` int32 (N, S) input
    ids with the mask token substituted, ``targets`` int32 (N, S)
    original ids, ``mask`` bool (N, S) True where the loss applies.
    """
    rng = np.random.default_rng(seed)
    run = 8
    n_runs = (seq_len + run - 1) // run
    run_tokens = rng.integers(5, vocab_size,
                              size=(num_examples, n_runs))
    clean = np.repeat(run_tokens, run, axis=1)[:, :seq_len]
    noise = rng.random((num_examples, seq_len)) < 0.02
    clean = np.where(noise,
                     rng.integers(5, vocab_size, size=clean.shape), clean)
    mask = rng.random((num_examples, seq_len)) < mask_rate
    tokens = np.where(mask, mask_token, clean)
    return (tokens.astype(np.int32), clean.astype(np.int32), mask)
