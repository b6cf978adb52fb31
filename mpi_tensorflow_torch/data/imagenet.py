"""ImageNet-shaped data for ResNet-50 (BASELINE config 4).

The port's own copy of ``mpi_tensorflow_tpu/data/imagenet.py``:

- ``data_dir/imagenet_npy`` (``.npy`` shards: ``{train,val}_{images,
  labels}.npy``, NHWC float32, written by ``data.imagenet_jpeg.ingest``
  or by the user): the images mapped from disk, the first ``len(train)
  // 12`` train rows (at least one) as the validation split, ``val_*``
  as the test split.  Shards that an ingest wrote (they carry its
  ``ingest_meta.json``) at another resolution than the run's are
  refused, not served;
- a class-per-directory image tree in ``data_dir`` (or its ``train/``)
  and no shards: rank 0 (``parallel.mesh.process_index()``) decodes it
  once into ``imagenet_npy`` (``imagenet_jpeg.ingest``), which appears
  by an atomic rename; the other ranks wait for it.  A failed ingest
  leaves ``imagenet_npy.failed`` with its error, and a waiting rank
  raises on it at once if it appears during the wait, or after
  ``MARKER_GRACE_S`` if it was there before (a previous run's marker,
  which rank 0 removes as it starts), polling every ``POLL_S`` up to
  ``DEADLINE_S``.  A tree without Pillow raises: the port never trains
  on synthetic data when pointed at real images;
- otherwise the synthetic set (``data.synthetic.image_classification``,
  224x224x3, 1000 classes, 2048 / 512 rows by default).
"""

from __future__ import annotations

import os
import time

import numpy as np

from mpi_tensorflow_torch.data import imagenet_jpeg, synthetic
from mpi_tensorflow_torch.data.mnist import Splits
from mpi_tensorflow_torch.parallel import mesh as meshlib

IMAGE_SIZE = 224
NUM_CLASSES = 1000
NPY_DIR = "imagenet_npy"
# a waiting rank's poll of rank 0's ingest (the reference's values)
POLL_S = 5.0
MARKER_GRACE_S = 60.0
DEADLINE_S = 8 * 3600.0


def _ingest_or_wait(data_dir: str, np_dir: str, image_size: int) -> None:
    """Rank 0 ingests the tree into ``np_dir``; the others wait for it
    (module note)."""
    if not imagenet_jpeg.available():
        raise RuntimeError(
            f"{data_dir} holds a class-per-directory image tree but Pillow "
            f"(PIL) is not installed — install it or pre-convert to "
            f"{np_dir} (.npy shards)")
    fail_marker = f"{np_dir}.failed"
    if meshlib.process_index() == 0:
        if os.path.exists(fail_marker):
            os.unlink(fail_marker)      # a previous run's: retrying now
        print(f"[imagenet] decoding JPEG tree under {data_dir} -> {np_dir} "
              f"(one-time)", flush=True)
        try:
            imagenet_jpeg.ingest(data_dir, np_dir, image_size=image_size)
        except BaseException as e:
            # the waiting ranks fail at once instead of at the deadline
            try:
                with open(fail_marker, "w") as f:
                    f.write(f"{type(e).__name__}: {e}\n")
            except OSError:
                pass
            raise
        if os.path.exists(fail_marker):
            os.unlink(fail_marker)
        return
    wait_start = time.time()
    marker_seen_absent = not os.path.exists(fail_marker)
    while not os.path.isdir(np_dir):
        # a marker that appears during the wait is this run's; one there
        # from the start counts only after the grace (rank 0 unlinks a
        # stale one when it starts).  The unlink races every read here:
        # a vanished marker means keep waiting
        try:
            fresh = marker_seen_absent or \
                time.time() - wait_start > MARKER_GRACE_S
            if fresh and os.path.exists(fail_marker):
                with open(fail_marker) as f:
                    reason = f.read().strip()
                raise RuntimeError(f"process 0's JPEG ingest failed: "
                                   f"{reason}")
        except OSError:
            pass
        if not os.path.exists(fail_marker):
            marker_seen_absent = True
        if time.time() - wait_start > DEADLINE_S:
            raise RuntimeError(f"timed out waiting for process 0's JPEG "
                               f"ingest commit at {np_dir}")
        time.sleep(POLL_S)


def load_splits(data_dir: str = "./data", train_n: int = 2048,
                test_n: int = 512, image_size: int = IMAGE_SIZE) -> Splits:
    np_dir = os.path.join(data_dir, NPY_DIR)
    if not os.path.isdir(np_dir) and imagenet_jpeg.looks_like_tree(data_dir):
        _ingest_or_wait(data_dir, np_dir, image_size)
    if not os.path.isdir(np_dir):
        return synthetic.image_classification(
            train_n, test_n, size=image_size, channels=3,
            num_classes=NUM_CLASSES)
    tr_x = np.load(os.path.join(np_dir, "train_images.npy"), mmap_mode="r")
    if tr_x.shape[1] != image_size and os.path.exists(
            os.path.join(np_dir, "ingest_meta.json")):
        raise ValueError(
            f"{np_dir} holds {tr_x.shape[1]}px auto-ingested shards but "
            f"this run wants {image_size}px — delete the dir to re-ingest "
            f"at the new size (serving the wrong resolution silently "
            f"would train a different model)")
    tr_y = np.load(os.path.join(np_dir, "train_labels.npy"))
    ts_x = np.load(os.path.join(np_dir, "val_images.npy"), mmap_mode="r")
    ts_y = np.load(os.path.join(np_dir, "val_labels.npy"))
    val_n = max(tr_x.shape[0] // 12, 1)
    return Splits(train_data=tr_x[val_n:], train_labels=tr_y[val_n:],
                  test_data=ts_x, test_labels=ts_y,
                  val_data=tr_x[:val_n], val_labels=tr_y[:val_n])
