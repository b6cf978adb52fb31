"""CIFAR-10 for ResNet-20 (BASELINE config 3).

The port's own copy of ``mpi_tensorflow_tpu/data/cifar.py``:

- ``_parse_bin``: one file of the binary distribution, records of one
  label byte and 3072 pixel bytes stored CHW-planar, to NHWC float32
  normalised like MNIST, ``(p - 127.5) / 255``, and int64 labels;
- ``load_splits``: the five ``data_batch_*.bin`` files concatenated
  (the first ``train_n`` rows), ``test_batch.bin`` (the first
  ``test_n``), and the first ``len(train) // 12`` train rows (at least
  one) as the validation split, when ``data_dir`` holds
  ``cifar-10-batches-bin``; otherwise the synthetic set of the same
  shapes (``data.synthetic.image_classification``: 32x32x3, 10 classes,
  50 000 / 10 000 rows by default).

There is no network fetch: the reference downloads the binary
distribution when the directory is absent, and the port reads it only
from ``data_dir`` (the fetch waits for ROADMAP Queue 1 item 15, as
MNIST's does).
"""

from __future__ import annotations

import os

import numpy as np

from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.data.mnist import Splits

BIN_DIR = "cifar-10-batches-bin"
_REC = 3073  # 1 label byte + 3072 pixel bytes


def _parse_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), dtype=np.uint8)
    raw = raw.reshape(-1, _REC)
    labels = raw[:, 0].astype(np.int64)
    imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    imgs = (imgs.astype(np.float32) - 127.5) / 255.0
    return imgs, labels


def load_splits(data_dir: str = "./data", train_n: int | None = None,
                test_n: int | None = None) -> Splits:
    bin_dir = os.path.join(data_dir, BIN_DIR)
    if not os.path.isdir(bin_dir):
        return synthetic.image_classification(
            train_n or 50000, test_n or 10000, size=32, channels=3,
            num_classes=10)
    tr = [_parse_bin(os.path.join(bin_dir, f"data_batch_{i}.bin"))
          for i in range(1, 6)]
    tr_x = np.concatenate([x for x, _ in tr])[:train_n]
    tr_y = np.concatenate([y for _, y in tr])[:train_n]
    ts_x, ts_y = _parse_bin(os.path.join(bin_dir, "test_batch.bin"))
    ts_x, ts_y = ts_x[:test_n], ts_y[:test_n]
    val_n = max(tr_x.shape[0] // 12, 1)
    return Splits(train_data=tr_x[val_n:], train_labels=tr_y[val_n:],
                  test_data=ts_x, test_labels=ts_y,
                  val_data=tr_x[:val_n], val_labels=tr_y[:val_n])
