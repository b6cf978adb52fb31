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
  50 000 / 10 000 rows by default);
- when ``cifar-10-batches-bin`` is absent and ``data_dir`` holds the
  binary distribution's archive, ``cifar-10-binary.tar.gz``, it is
  extracted first (``tarfile``'s ``extractall``, as the reference does
  after its download) and parsed.  The archive goes into a directory of
  this call's own in ``data_dir``, whose ``cifar-10-batches-bin`` is
  then renamed into place: every rank of a ``torchrun`` job calls this
  at once, and none may read a file a peer is still writing.  The first
  rename wins; a later one finds the directory there and drops its own
  copy.  An archive that does not open, or does not hold the binary
  files, raises: real data was pointed at, so the synthetic set is never
  served in its place.

There is no network fetch: the reference downloads the archive when
neither is present, and the port reads it only from ``data_dir``.
"""

from __future__ import annotations

import os
import shutil
import tarfile
import tempfile

import numpy as np

from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.data.mnist import Splits

BIN_DIR = "cifar-10-batches-bin"
ARCHIVE = "cifar-10-binary.tar.gz"
_REC = 3073  # 1 label byte + 3072 pixel bytes


def _parse_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), dtype=np.uint8)
    raw = raw.reshape(-1, _REC)
    labels = raw[:, 0].astype(np.int64)
    imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    imgs = (imgs.astype(np.float32) - 127.5) / 255.0
    return imgs, labels


def _extract(tgz: str, data_dir: str, bin_dir: str) -> None:
    """``tgz``'s ``BIN_DIR`` into ``bin_dir``, whole or not at all."""
    tmp = tempfile.mkdtemp(prefix=".cifar-extract.", dir=data_dir)
    try:
        try:
            with tarfile.open(tgz) as tf:
                tf.extractall(tmp, filter="data")
        except (tarfile.TarError, OSError, EOFError) as e:
            raise RuntimeError(
                f"{tgz} could not be extracted ({type(e).__name__}: {e}); "
                f"refusing to train on synthetic data in its place") from e
        if not os.path.isdir(os.path.join(tmp, BIN_DIR)):
            raise RuntimeError(f"{tgz} holds no {BIN_DIR}/ directory")
        try:
            os.rename(os.path.join(tmp, BIN_DIR), bin_dir)
        except OSError:
            if not os.path.isdir(bin_dir):
                raise                   # else a peer's rename came first
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_splits(data_dir: str = "./data", train_n: int | None = None,
                test_n: int | None = None) -> Splits:
    bin_dir = os.path.join(data_dir, BIN_DIR)
    tgz = os.path.join(data_dir, ARCHIVE)
    if not os.path.isdir(bin_dir) and os.path.exists(tgz):
        _extract(tgz, data_dir, bin_dir)
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
