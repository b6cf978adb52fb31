"""Deterministic synthetic data (numpy only): images for the ResNet
datasets, masked-LM sequences and the encoder-decoder's reversal pairs.

The port's own copy of ``image_classification``, ``mlm_batches`` and
``seq2seq_batches`` from ``mpi_tensorflow_tpu/data/synthetic.py``: the
same draws in the same order from ``numpy.random.default_rng(seed)``, so
one seed gives the same bytes in both packages.
"""

from __future__ import annotations

import numpy as np

from mpi_tensorflow_torch.data.mnist import Splits


def image_classification(train_n: int, test_n: int, *, size: int,
                         channels: int, num_classes: int,
                         seed: int = 0) -> Splits:
    """Class-separable NHWC float32 images in ``[-0.5, 0.5]`` (noise of
    sd 0.15 plus a low-frequency pattern per class) with int64 labels;
    the first ``train_n // 12`` train rows (at least one) are the
    validation split."""
    rng = np.random.default_rng(seed)

    def make(n):
        labels = rng.integers(0, num_classes, size=n).astype(np.int64)
        x = rng.normal(0.0, 0.15, size=(n, size, size, channels))
        freqs = 1 + (np.arange(num_classes) % 4)
        phases = 2 * np.pi * np.arange(num_classes) / num_classes
        t = np.linspace(0, 2 * np.pi, size)
        for c in range(num_classes):
            mask = labels == c
            pattern = 0.25 * np.outer(np.sin(freqs[c] * t + phases[c]),
                                      np.cos(freqs[c] * t))
            x[mask] += pattern[None, :, :, None]
        return np.clip(x, -0.5, 0.5).astype(np.float32), labels

    tr_x, tr_y = make(train_n)
    ts_x, ts_y = make(test_n)
    val_n = max(train_n // 12, 1)
    return Splits(train_data=tr_x[val_n:], train_labels=tr_y[val_n:],
                  test_data=ts_x, test_labels=ts_y,
                  val_data=tr_x[:val_n], val_labels=tr_y[:val_n])


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


def seq2seq_batches(num_examples: int, *, src_len: int, tgt_len: int,
                    vocab_size: int, bos_token: int = 0, seed: int = 0):
    """Synthetic pairs for the encoder-decoder family: the target is the
    REVERSED source, BOS first, cut to ``tgt_len`` (position t of the
    target copies position S - t of the source, which only the
    cross-attention can reach).  Returns ``(src, tgt)`` int32 (N,
    src_len) and (N, tgt_len)."""
    if tgt_len > src_len + 1:
        raise ValueError(
            f"tgt_len {tgt_len} > src_len + 1 ({src_len + 1}): the "
            f"reversed source cannot fill the target")
    rng = np.random.default_rng(seed)
    src = rng.integers(5, vocab_size, size=(num_examples, src_len))
    tgt = np.concatenate(
        [np.full((num_examples, 1), bos_token), src[:, ::-1][:, :tgt_len - 1]],
        axis=1)
    return src.astype(np.int32), tgt.astype(np.int32)
