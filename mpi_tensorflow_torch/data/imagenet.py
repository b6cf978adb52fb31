"""ImageNet-shaped data for ResNet-50 (BASELINE config 4).

The port's own copy of ``mpi_tensorflow_tpu/data/imagenet.py``:

- ``data_dir/imagenet_npy`` (user-provided, pre-processed ``.npy``
  shards: ``{train,val}_{images,labels}.npy``, NHWC float32): the
  images mapped from disk, the first ``len(train) // 12`` train rows
  (at least one) as the validation split, ``val_*`` as the test split.
  Shards that the reference's JPEG ingest wrote (they carry its
  ``ingest_meta.json``) at another resolution than the run's are
  refused, not served;
- a class-per-directory image tree in ``data_dir`` (or its ``train/``)
  raises: decoding it is the reference's ``imagenet_jpeg`` ingest,
  ROADMAP Queue 1 item 15.  It never falls back to synthetic data when
  it was pointed at real images;
- otherwise the synthetic set (``data.synthetic.image_classification``,
  224x224x3, 1000 classes, 2048 / 512 rows by default).
"""

from __future__ import annotations

import os

import numpy as np

from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.data.mnist import Splits

IMAGE_SIZE = 224
NUM_CLASSES = 1000
NPY_DIR = "imagenet_npy"
_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _image_class_dirs(base: str) -> list:
    """Subdirectories of ``base`` that hold at least one image (the
    reference's ``imagenet_jpeg._image_class_dirs``)."""
    if not os.path.isdir(base):
        return []
    out = []
    for d in sorted(os.listdir(base)):
        cdir = os.path.join(base, d)
        if not os.path.isdir(cdir) or d.startswith((".", NPY_DIR)):
            continue
        if any(f.lower().endswith(_IMAGE_EXTS) for f in os.listdir(cdir)):
            out.append(d)
    return out


def looks_like_tree(root: str) -> bool:
    """Whether ``root`` (or ``root/train``) is a class-per-directory
    image tree: at least two image-bearing class directories (the
    reference's ``imagenet_jpeg.looks_like_tree``)."""
    return (len(_image_class_dirs(os.path.join(root, "train"))) >= 2
            or len(_image_class_dirs(root)) >= 2)


def load_splits(data_dir: str = "./data", train_n: int = 2048,
                test_n: int = 512, image_size: int = IMAGE_SIZE) -> Splits:
    np_dir = os.path.join(data_dir, NPY_DIR)
    if not os.path.isdir(np_dir) and looks_like_tree(data_dir):
        raise NotImplementedError(
            f"{data_dir} holds a class-per-directory image tree; decoding "
            f"it into {np_dir} is not ported yet: ROADMAP Queue 1 item 15 "
            f"(pre-convert it to .npy shards there; the port never "
            f"trains on synthetic data when pointed at real images)")
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
