"""MNIST: the four IDX files, the synthetic set, and the reference's split.

The port's counterpart of ``mpi_tensorflow_tpu/data/mnist.py``:

- ``ensure_data`` uses the four IDX files when ``data_dir`` holds them
  and otherwise writes the synthetic set there.  There is no network
  fetch: real MNIST is read only from files already in ``data_dir``
  (the fetch waits for ROADMAP Queue 1 item 15).  Under
  ``torch.distributed`` rank 0 alone checks or writes the files, and
  every rank reads them after a barrier (``data_dir`` is one directory
  for all ranks: one host, or a shared filesystem);
- ``_write_synthetic`` writes the same bytes as the reference's for the
  same sizes (one ``numpy.random.default_rng(0)``, the same draws in the
  same order): class-dependent bright 8x8 patches a model can fit;
- ``load_splits`` splits as the reference's rank 0 does, with
  ``num_shards`` as the MPI world size in the truncations: validation
  is the first ``5000//k*k`` training rows, train rows ``[5000//k*k,
  55000//k*k)``, test the first ``10000//k*k`` test rows (scaled to
  ``train_n`` / ``test_n`` for small sets).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from mpi_tensorflow_torch.data import idx, sharding
from mpi_tensorflow_torch.parallel import collectives, mesh

FILES = {
    "train_images": "train-images-idx3-ubyte.gz",
    "train_labels": "train-labels-idx1-ubyte.gz",
    "test_images": "t10k-images-idx3-ubyte.gz",
    "test_labels": "t10k-labels-idx1-ubyte.gz",
}
_TRAIN_N, _TEST_N, _VAL_N = 60000, 10000, 5000


@dataclasses.dataclass
class Splits:
    """The six arrays the reference scatters, before sharding."""
    train_data: np.ndarray
    train_labels: np.ndarray
    test_data: np.ndarray
    test_labels: np.ndarray
    val_data: np.ndarray
    val_labels: np.ndarray

    def shard(self, num_shards: int, index: int) -> "Splits":
        """Contiguous equal shard ``index`` of every split."""
        return Splits(*sharding.shard_arrays(dataclasses.astuple(self),
                                             num_shards, index))


def ensure_data(data_dir: str = "./data", verbose: bool = True) -> dict:
    """The paths of the four MNIST files in ``data_dir``: the files
    there when all four are present, else a synthetic set written there.
    A directory holding some of the four but not all raises, rather than
    mixing real and synthetic files.  Rank 0 alone checks and writes;
    the other ranks wait for it, so N ranks never write one directory at
    once."""
    paths = {k: os.path.join(data_dir, f) for k, f in FILES.items()}
    failed = None
    if mesh.process_index() == 0:
        try:
            _ensure_here(data_dir, paths, verbose)
        except OSError as e:
            failed = e
    collectives.barrier()
    if failed is not None:
        raise failed
    missing = [p for p in paths.values() if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"rank {mesh.process_index()}: {missing} "
                                f"absent after rank 0 prepared {data_dir}")
    return paths


def _ensure_here(data_dir: str, paths: dict, verbose: bool) -> None:
    os.makedirs(data_dir, exist_ok=True)
    present = [k for k, p in paths.items() if os.path.exists(p)]
    if len(present) == len(FILES):
        return
    if present:
        missing = sorted(set(FILES) - set(present))
        raise FileNotFoundError(
            f"{data_dir} holds {sorted(present)} but not {missing}; put all "
            f"four MNIST files there, or none for the synthetic set")
    if verbose:
        print(f"[data] no MNIST files in {data_dir}; writing the synthetic "
              f"set", flush=True)
    _write_synthetic(data_dir)


def _write_synthetic(data_dir: str, train_n: int = _TRAIN_N,
                     test_n: int = _TEST_N) -> None:
    """Deterministic fake MNIST: one bright 8x8 patch whose position
    encodes the class, the real set's dtypes and shapes."""
    rng = np.random.default_rng(0)
    for n, img_name, lbl_name in (
        (train_n, FILES["train_images"], FILES["train_labels"]),
        (test_n, FILES["test_images"], FILES["test_labels"]),
    ):
        labels = rng.integers(0, 10, size=n).astype(np.uint8)
        images = np.zeros((n, 28, 28), dtype=np.uint8)
        ys, xs = np.unravel_index(np.arange(10) * 7 % 20, (5, 4))
        for c in range(10):
            mask = labels == c
            patch = rng.integers(128, 255, size=(int(mask.sum()), 8, 8))
            y, x = int(ys[c]) * 4, int(xs[c]) * 5
            images[mask, y:y + 8, x:x + 8] = patch
        idx.write_idx(os.path.join(data_dir, img_name), images)
        idx.write_idx(os.path.join(data_dir, lbl_name), labels)


def load_splits(data_dir: str = "./data", num_shards: int = 1,
                train_n: int | None = None, test_n: int | None = None
                ) -> Splits:
    """Load and split as the reference's rank 0 does; ``train_n`` /
    ``test_n`` take small subsets."""
    paths = {k: os.path.join(data_dir, f) for k, f in FILES.items()}
    k = num_shards
    avail_train = train_n if train_n is not None else _TRAIN_N
    avail_test = test_n if test_n is not None else _TEST_N
    val_total = sharding.truncate_to_multiple(
        avail_train * _VAL_N // _TRAIN_N, k)
    tr_total = sharding.truncate_to_multiple(avail_train * 55000 // _TRAIN_N,
                                             k)
    ts_total = sharding.truncate_to_multiple(avail_test, k)

    tr_data = idx.extract_images(paths["train_images"], avail_train)
    tr_labels = idx.extract_labels(paths["train_labels"], avail_train)
    ts_data = idx.extract_images(paths["test_images"], ts_total)
    ts_labels = idx.extract_labels(paths["test_labels"], ts_total)
    return Splits(
        train_data=tr_data[val_total:tr_total],
        train_labels=tr_labels[val_total:tr_total],
        test_data=ts_data,
        test_labels=ts_labels,
        val_data=tr_data[:val_total],
        val_labels=tr_labels[:val_total],
    )
