"""Real-image (JPEG) ingest of an ImageNet-layout directory tree.

The port's own copy of ``mpi_tensorflow_tpu/data/imagenet_jpeg.py``
(no code is shared between the packages).  It decodes

    root/train/<class_name>/*.JPEG
    root/val/<class_name>/*.JPEG        (val/ optional: a share of train
                                         is carved when absent)

once into the ``.npy`` shard layout ``data/imagenet.py`` serves
(``imagenet_npy/{train,val}_{images,labels}.npy``): every epoch then
reads memory-mapped shards, with no decode in the step.

- ``scan_tree``: class-per-directory listing, label ids by sorted
  directory name (only directories holding an image count); the val
  split is labelled through the train split's map, and a val class the
  train split lacks raises;
- ``decode_image``: the standard evaluation transform: shorter side to
  ``resize_to`` (bilinear), centre crop of ``image_size``, float32 in
  [0, 1] normalised by the ImageNet mean and std;
- ``_decoded``: decoded images in path order, through a pool of
  spawned processes when there are many (the reference forks them);
- ``ingest``: a seeded permutation of each split before it is written
  (``_shuffled``), the every-k-th val carve when there is no val split,
  ``ingest_meta.json``, and an atomic ``rename`` of a ``.tmp.<pid>``
  directory as the commit.

Pillow is imported where an image is decoded (``_pil``), so the module
imports without it; ``available()`` says whether it is there.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _pil():
    try:
        from PIL import Image

        return Image
    except ImportError as e:                 # pragma: no cover
        raise RuntimeError(
            "JPEG ingestion needs Pillow (PIL); install it or "
            "pre-convert to the imagenet_npy .npy shard format") from e


def available() -> bool:
    try:
        import PIL  # noqa: F401

        return True
    except ImportError:                      # pragma: no cover
        return False


def _image_class_dirs(base: str) -> list:
    """Subdirectories of ``base`` that contain at least one image."""
    out = []
    if not os.path.isdir(base):
        return out
    for d in sorted(os.listdir(base)):
        cdir = os.path.join(base, d)
        if not os.path.isdir(cdir) or d.startswith((".", "imagenet_npy")):
            continue
        if any(f.lower().endswith(_EXTS) for f in os.listdir(cdir)):
            out.append(d)
    return out


def looks_like_tree(root: str) -> bool:
    """Whether ``root`` (or ``root/train``) is a class-per-directory
    image tree — the auto-ingest trigger in data/imagenet.load_splits.
    Requires at least TWO image-bearing class directories: a single
    stray image-holding subdir (a figures/ folder in a shared ./data)
    must not trigger an hours-long bogus ingest."""
    return (len(_image_class_dirs(os.path.join(root, "train"))) >= 2
            or len(_image_class_dirs(root)) >= 2)


def scan_tree(split_dir: str,
              class_to_id: Optional[dict] = None,
              classes: Optional[list] = None) -> tuple[list, list]:
    """Class-per-directory scan: returns (paths, labels) with label ids
    assigned by SORTED class-directory name — deterministic across
    hosts, the property per-host sharding relies on.  Only directories
    that actually CONTAIN an image count as classes (an empty or
    non-image dir must not consume a label id), and the ingest output /
    hidden / tmp dirs never do.

    ``class_to_id``: an existing name -> id map (the TRAIN split''s) —
    the val split must label with the train map, never its own sort
    order (a class-set mismatch between splits would silently misalign
    every val label); unknown val classes fail loudly."""
    if classes is None:
        classes = _image_class_dirs(split_dir)
    if class_to_id is None:
        class_to_id = {c: i for i, c in enumerate(classes)}
    paths, labels = [], []
    for cname in classes:
        if cname not in class_to_id:
            raise ValueError(
                f"class directory {cname!r} in {split_dir} does not "
                f"exist in the training split — the label maps would "
                f"silently diverge")
        li = class_to_id[cname]
        cdir = os.path.join(split_dir, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(_EXTS):
                paths.append(os.path.join(cdir, fname))
                labels.append(li)
    return paths, labels


def decode_image(path: str, image_size: int, resize_to: Optional[int] = None
                 ) -> np.ndarray:
    """One image -> (image_size, image_size, 3) float32, normalized."""
    Image = _pil()
    resize_to = resize_to or max(image_size, int(image_size * 256 / 224))
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = resize_to / min(w, h)
        im = im.resize((max(1, round(w * scale)), max(1, round(h * scale))),
                       Image.BILINEAR)
        w, h = im.size
        left, top = (w - image_size) // 2, (h - image_size) // 2
        im = im.crop((left, top, left + image_size, top + image_size))
        x = np.asarray(im, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def _decoded(paths: list, image_size: int, workers: int):
    """Decoded images in path order — a process pool when it pays (the
    one-time full-ImageNet conversion is hours single-threaded on a
    many-core host), serial otherwise/on pool failure.  The workers are
    spawned, not forked: the trainer's process holds threads (torch's,
    the prefetcher's), and a forked child may inherit a held lock."""
    import functools
    import multiprocessing

    if workers > 1 and len(paths) >= 64:
        ex = None
        try:
            from concurrent.futures import ProcessPoolExecutor

            ex = ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn"))
        except OSError:                      # pragma: no cover
            ex = None                        # no sem/fork: serial below
        if ex is not None:
            # decode errors propagate from here — they must NOT be
            # caught and retried serially (a mid-stream restart would
            # write duplicate images at shifted memmap rows)
            with ex:
                yield from ex.map(
                    functools.partial(decode_image, image_size=image_size),
                    paths, chunksize=32)
            return
    for p in paths:
        yield decode_image(p, image_size)


def _ingest_split(paths: list, labels: list, out_dir: str, prefix: str,
                  image_size: int, log_every: int = 500,
                  workers: int | None = None) -> None:
    n = len(paths)
    workers = workers if workers is not None else (os.cpu_count() or 1)
    imgs = np.lib.format.open_memmap(
        os.path.join(out_dir, f"{prefix}_images.npy"), mode="w+",
        dtype=np.float32, shape=(n, image_size, image_size, 3))
    for i, x in enumerate(_decoded(paths, image_size, workers)):
        imgs[i] = x
        if log_every and (i + 1) % log_every == 0:
            print(f"[imagenet_jpeg] {prefix}: {i + 1}/{n} decoded",
                  flush=True)
    imgs.flush()
    del imgs
    np.save(os.path.join(out_dir, f"{prefix}_labels.npy"),
            np.asarray(labels, np.int64))


def _shuffled(paths: list, labels: list, seed: int) -> tuple[list, list]:
    """Seeded global permutation of (paths, labels), applied BEFORE the
    shards are written: scan_tree emits strictly class-sorted order, and
    a class-sorted train shard would make every per-device block and the
    head-of-shard val carve (data/imagenet.py load_splits) single-class.
    Seeded so every host that ingests the same tree writes the same
    shard order (the per-host sharding determinism contract)."""
    perm = np.random.default_rng(seed).permutation(len(paths))
    return [paths[i] for i in perm], [labels[i] for i in perm]


def ingest(root: str, out_dir: Optional[str] = None,
           image_size: int = 224, val_fraction: float = 0.04,
           shuffle_seed: int = 0) -> str:
    """Decode a class-per-directory JPEG tree into the mmap `.npy` shard
    layout ``data/imagenet.load_splits`` serves.  Returns ``out_dir``.

    ``root`` may contain ``train/``+``val/`` split subdirectories, or be
    a flat class-per-directory tree (then every ``1/val_fraction``-th
    image, round-robin per class order, becomes the val split — a
    deterministic carve, no RNG).

    Shard order: a seeded global permutation is applied to every split
    before writing (``shuffle_seed``), so per-device blocks and the val
    carve in data/imagenet.py are class-balanced instead of inheriting
    scan_tree's class-sorted order.
    """
    out_dir = out_dir or os.path.join(root, "imagenet_npy")
    train_dir = os.path.join(root, "train")
    val_dir = os.path.join(root, "val")
    def carve(paths, labels):
        """Deterministic every-k-th val carve — images leave the train
        split (never copied: the val shard serves as TEST data and must
        not overlap training)."""
        k = max(2, int(round(1.0 / max(val_fraction, 1e-6))))
        tr = [(p, l) for i, (p, l) in enumerate(zip(paths, labels))
              if i % k]
        va = [(p, l) for i, (p, l) in enumerate(zip(paths, labels))
              if not i % k]
        return ([p for p, _ in tr], [l for _, l in tr],
                [p for p, _ in va], [l for _, l in va])

    if os.path.isdir(train_dir):
        # ONE label map, owned by the train split; val labels through it
        # (one listing pass: scan_tree reuses the class list)
        train_classes = _image_class_dirs(train_dir)
        cmap = {c: i for i, c in enumerate(train_classes)}
        tr_p, tr_l = _shuffled(*scan_tree(train_dir, cmap,
                                          classes=train_classes),
                               seed=shuffle_seed)
        va_p, va_l = [], []
        if os.path.isdir(val_dir):
            va_p, va_l = _shuffled(*scan_tree(val_dir, cmap),
                                   seed=shuffle_seed + 1)
        if not va_p:
            # no val/, or a val/ without class-per-directory structure
            # (the standard ImageNet val tarball extracts FLAT, with
            # labels in a separate devkit file we cannot infer):
            # committing a zero-row val shard would permanently serve an
            # empty test split — carve from train instead, loudly
            print(f"[imagenet_jpeg] no class-per-directory val split "
                  f"under {root}: carving a deterministic "
                  f"{val_fraction:.0%} of train as val", flush=True)
            tr_p, tr_l, va_p, va_l = carve(tr_p, tr_l)
    else:
        paths, labels = _shuffled(*scan_tree(root), seed=shuffle_seed)
        tr_p, tr_l, va_p, va_l = carve(paths, labels)
    if not tr_p:
        raise ValueError(f"no images found under {root!r} "
                         f"(expected class-per-directory *.jpeg)")
    gb = (len(tr_p) + len(va_p)) * image_size * image_size * 3 * 4 / 1e9
    print(f"[imagenet_jpeg] decoding {len(tr_p)}+{len(va_p)} images -> "
          f"~{gb:.1f} GB of float32 .npy shards under {out_dir}",
          flush=True)
    # ATOMIC commit: decode into a tmp dir and rename into place —
    # out_dir's existence is load_splits' done-marker, so a crashed or
    # interrupted ingest must leave nothing behind (a half-written shard
    # dir would permanently shadow both re-ingest and the synthetic
    # fallback)
    tmp = f"{out_dir}.tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    try:
        _ingest_split(tr_p, tr_l, tmp, "train", image_size)
        _ingest_split(va_p, va_l, tmp, "val", image_size)
        import json

        with open(os.path.join(tmp, "ingest_meta.json"), "w") as f:
            # provenance marker: load_splits enforces resolution ONLY on
            # shards OUR ingest produced — user-provided pre-processed
            # shards are their own source of truth at any size
            json.dump({"image_size": image_size,
                       "train_n": len(tr_p), "val_n": len(va_p)}, f)
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not os.path.isdir(out_dir):
                # NOT the concurrent-writer race: nothing committed the
                # destination, so this ingest genuinely failed to land —
                # swallowing it would silently fall through to synthetic
                # data (load_splits treats the dir as the done-marker)
                raise
            # a concurrent writer committed first: theirs is complete
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return out_dir
