"""The port's image data path against the JAX reference, on the CPU:
window prefetch, the ImageNet JPEG ingest and the CIFAR-10 archive.

- **Prefetch**: ``ThreadPrefetcher``'s windows byte-identical to
  ``assemble_window`` for every window of a schedule (the tail window
  included) and to the reference's ``ThreadPrefetcher``; a worker that
  fails raises in ``next()`` instead of hanging; ``close()`` returns
  within a second mid-schedule; ``native`` raises naming ROADMAP item
  15c.  The trace lines of ``train.loop.train`` under ``prefetch``
  ``thread`` equal those under ``off`` and the reference loop's (the
  CNN from the reference's own initial parameters, dropout 0; the
  reference steps one step a dispatch, whose trace is its windowed
  loop's, ``test_torch_cnn.py``: its scanned window compiled with XLA's
  optimisations off takes minutes on one core), as do the metrics'
  tags, steps and test errors.
- **Ingest**: on tiny JPEG trees written with Pillow (3 classes x 6
  images of odd sizes, ``image_size`` 16; with and without ``train/`` +
  ``val/``) the shard bytes, label maps, val carve, shuffled order and
  ``ingest_meta.json`` equal the reference's ``ingest``; 64 images
  through the decode pool (``workers=2``) give the reference's bytes;
  ``load_splits`` ingests a tree once and serves the reference's
  splits; a waiting rank raises promptly once rank 0's failure marker
  appears, and a marker from before its wait only after the grace (both
  shortened through the module constants).
- **CIFAR-10**: ``load_splits`` on a directory holding only
  ``cifar-10-binary.tar.gz`` extracts it and gives the reference's
  splits byte for byte; a corrupt archive raises in both packages.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import tarfile
import threading
import time

import jax
import numpy as np
import pytest
import torch

from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.data import cifar as jax_cifar
from mpi_tensorflow_tpu.data import imagenet as jax_imagenet
from mpi_tensorflow_tpu.data import imagenet_jpeg as jax_jpeg
from mpi_tensorflow_tpu.data import mnist as jax_mnist
from mpi_tensorflow_tpu.data import prefetch as jax_prefetch
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import loop as jax_loop
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_tpu.train import step as jax_step
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import cifar, imagenet, imagenet_jpeg, mnist
from mpi_tensorflow_torch.data import prefetch
from mpi_tensorflow_torch.models import convert
from mpi_tensorflow_torch.train import loop

PIL = pytest.importorskip("PIL")


# ------------------------------------------------------------ prefetch

def _split_arrays(shards=2, local_n=37, feat=(5, 3), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(shards, local_n) + feat).astype(np.float32),
            rng.integers(0, 10, size=(shards, local_n)).astype(np.int64))


def test_thread_windows_equal_inline_and_reference():
    """Every window of a schedule whose last window is short (the tail),
    from the port's thread, the inline gather and the reference's
    thread: the same bytes."""
    tr_d, tr_l = _split_arrays()
    starts, widths = loop.window_schedule(23, 10, 6)
    assert widths[-1] < 6                       # a tail window
    got = prefetch.make_prefetcher(tr_d, tr_l, starts, widths, 6, 4,
                                   force="thread")
    want = jax_prefetch.ThreadPrefetcher(tr_d, tr_l, starts, widths, 6, 4)
    try:
        for t0, w in zip(starts, widths):
            bs, ls, gw = got.next()
            rb, rl, rw = want.next()
            ib, il = prefetch.assemble_window(tr_d, tr_l, t0, w, 6, 4)
            assert gw == rw == w
            for a, b in ((bs, ib), (bs, rb), (ls, il), (ls, rl)):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert got.next() is None and want.next() is None
    finally:
        got.close()
        want.close()


def test_failing_worker_raises_and_close_is_prompt(monkeypatch):
    tr_d, tr_l = _split_arrays()
    starts, widths = loop.window_schedule(60, 5, 3)

    def boom(*a):
        raise OSError("disk gone")

    monkeypatch.setattr(prefetch, "assemble_window", boom)
    pf = prefetch.ThreadPrefetcher(tr_d, tr_l, starts, widths, 3, 4)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="prefetch worker failed") as e:
        pf.next()
    assert isinstance(e.value.__cause__, OSError)
    assert time.perf_counter() - t0 < 3.0
    pf.close()
    # a slow gather: close() mid-schedule returns within a second
    monkeypatch.undo()
    gather = prefetch.assemble_window

    def slow(*a):
        time.sleep(0.02)
        return gather(*a)

    monkeypatch.setattr(prefetch, "assemble_window", slow)
    pf = prefetch.ThreadPrefetcher(tr_d, tr_l, starts, widths, 3, 4)
    assert pf.next()[2] == widths[0]
    t0 = time.perf_counter()
    pf.close()
    assert time.perf_counter() - t0 < 1.0 and not pf._thread.is_alive()


def test_native_prefetch_raises_naming_its_item():
    tr_d, tr_l = _split_arrays()
    with pytest.raises(RuntimeError, match="item 15c"):
        prefetch.make_prefetcher(tr_d, tr_l, [0], [1], 1, 4, force="native")
    with pytest.raises(NotImplementedError, match="item 15c"):
        Config(prefetch="native")


LOOP = dict(epochs=1, batch_size=8, log_every=5, dropout_rate=0.0,
            fused_steps=5, base_lr=0.002)


@pytest.fixture(scope="module")
def cnn_runs(mnist_dir, tmp_path_factory):
    """The reference loop (one step a dispatch) and the port's under
    ``thread`` and ``off`` (windows of 6), from the reference's initial
    CNN parameters, on 400 / 64 rows of the synthetic MNIST, each
    writing its metrics."""
    root = tmp_path_factory.mktemp("cnn_runs")
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        model = jax_loop.build_model(JaxConfig(**LOOP))
        init = jax.tree.map(np.asarray,
                            jax.jit(model.init)(jax.random.key(1)))
        mesh = jax_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_step, "init_state", lambda m, rng: jax_step.
                       TrainState(init, jax_opt.momentum_init(init), {}))
            with contextlib.redirect_stdout(io.StringIO()) as out:
                ref = jax_loop.train(
                    JaxConfig(**{**LOOP, "fused_steps": 1},
                              metrics_dir=str(root / "ref")),
                    splits=jax_mnist.load_splits(mnist_dir, train_n=400,
                                                 test_n=64),
                    mesh=mesh)
    finally:
        jax.config.update("jax_disable_most_optimizations", saved)
    runs = {"reference": (ref, out.getvalue())}
    for mode in ("thread", "off"):
        cfg = Config(**LOOP, prefetch=mode, metrics_dir=str(root / mode))
        m = loop.build_model(cfg)
        with torch.no_grad():
            for k, v in convert.cnn_params_from_jax(init).items():
                getattr(m, k).copy_(v)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            res = loop.train(cfg, model=m, splits=mnist.load_splits(
                mnist_dir, train_n=400, test_n=64), device="cpu")
        runs[mode] = (res, out.getvalue())
    return runs, root


def _trace(text):
    return [ln for ln in text.splitlines() if not ln.startswith("[timing]")]


def _metrics(path):
    return [json.loads(ln) for ln in open(os.path.join(path,
                                                       "metrics.jsonl"))]


def test_trace_under_thread_equals_off_and_reference(cnn_runs):
    runs, _ = cnn_runs
    want = _trace(runs["reference"][1])
    assert len(want) == 9                       # 8 trace points + header
    assert _trace(runs["thread"][1]) == _trace(runs["off"][1]) == want
    assert runs["thread"][0].history == runs["off"][0].history
    assert runs["thread"][0].num_steps == runs["reference"][0].num_steps


def test_loop_metrics_match_reference(cnn_runs):
    """``eval/test_error_pct`` at every trace point with the reference's
    values, then ``perf/images_per_sec`` at ``num_steps``."""
    _, root = cnn_runs
    want = _metrics(root / "ref")
    for mode in ("thread", "off"):
        got = _metrics(root / mode)
        assert [(m["tag"], m["step"]) for m in got] == [
            (m["tag"], m["step"]) for m in want]
        assert [m["value"] for m in got if m["tag"].startswith("eval")] == \
            [m["value"] for m in want if m["tag"].startswith("eval")]
        assert got[-1]["tag"] == "perf/images_per_sec" \
            and got[-1]["value"] > 0


# -------------------------------------------------------------- ingest

def _write_tree(root, split_dirs: bool, classes=("cat", "dog", "emu"),
                per_class=6):
    """3 classes x 6 JPEGs of odd sizes (and with ``split_dirs`` a val/
    of two classes, one image each)."""
    from PIL import Image

    rng = np.random.default_rng(3)
    base = os.path.join(root, "train") if split_dirs else str(root)
    for ci, c in enumerate(classes):
        os.makedirs(os.path.join(base, c), exist_ok=True)
        for i in range(per_class):
            px = rng.integers(0, 256, size=(13 + 5 * i, 17 + 3 * ci, 3),
                              dtype=np.uint8)
            Image.fromarray(px).save(os.path.join(base, c, f"i{i}.jpeg"),
                                     quality=90)
    if split_dirs:
        for c in classes[1:]:
            os.makedirs(os.path.join(root, "val", c))
            px = rng.integers(0, 256, size=(21, 19, 3), dtype=np.uint8)
            Image.fromarray(px).save(os.path.join(root, "val", c, "v.jpeg"))
    return str(root)


def _dir_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("split_dirs", [False, True])
def test_ingest_matches_reference(tmp_path, split_dirs):
    root = _write_tree(tmp_path / "tree", split_dirs)
    base = os.path.join(root, "train") if split_dirs else root
    # label maps and listing order
    assert imagenet_jpeg.scan_tree(base) == jax_jpeg.scan_tree(base)
    assert imagenet_jpeg._image_class_dirs(base) == \
        jax_jpeg._image_class_dirs(base) == ["cat", "dog", "emu"]
    paths, labels = jax_jpeg.scan_tree(base)
    assert imagenet_jpeg._shuffled(paths, labels, 5) == \
        jax_jpeg._shuffled(paths, labels, 5)
    got = imagenet_jpeg.ingest(root, str(tmp_path / "port"), image_size=16,
                               val_fraction=0.25)
    want = jax_jpeg.ingest(root, str(tmp_path / "ref"), image_size=16,
                           val_fraction=0.25)
    g, w = _dir_bytes(got), _dir_bytes(want)
    assert sorted(g) == ["ingest_meta.json", "train_images.npy",
                         "train_labels.npy", "val_images.npy",
                         "val_labels.npy"]
    assert g == w
    meta = json.loads(g["ingest_meta.json"])
    # the val carve: every 4th of 18 (flat), or val/'s two images
    assert meta == {"image_size": 16, "train_n": 18 if split_dirs else 13,
                    "val_n": 2 if split_dirs else 5}
    assert imagenet_jpeg.looks_like_tree(root)


def test_decode_pool_keeps_path_order(tmp_path):
    """64 images through a process pool of 2 workers: the reference's
    shard bytes, in path order."""
    root = _write_tree(tmp_path / "tree", False, per_class=22)
    paths, labels = jax_jpeg.scan_tree(root)
    assert len(paths) >= 64
    for mod, out in ((imagenet_jpeg, "port"), (jax_jpeg, "ref")):
        os.makedirs(tmp_path / out)
        mod._ingest_split(paths, labels, str(tmp_path / out), "train", 16,
                          log_every=0, workers=2)
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "ref")


def test_load_splits_ingests_a_tree_once(tmp_path):
    """Rank 0 (no process group) ingests the tree and serves the
    reference's splits; the shards are reused on the next call."""
    _write_tree(tmp_path / "port", True)
    _write_tree(tmp_path / "ref", True)
    with contextlib.redirect_stdout(io.StringIO()):
        got = imagenet.load_splits(str(tmp_path / "port"), image_size=16)
        want = jax_imagenet.load_splits(str(tmp_path / "ref"), image_size=16)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.shape == b.shape and np.array_equal(a, b), f.name
    assert os.path.isdir(tmp_path / "port" / "imagenet_npy")
    assert not os.path.exists(tmp_path / "port" / "imagenet_npy.failed")
    again = imagenet.load_splits(str(tmp_path / "port"), image_size=16)
    assert np.array_equal(again.train_data, got.train_data)


def test_waiting_rank_and_the_failure_marker(tmp_path, monkeypatch):
    """A rank other than 0 waits for rank 0's commit: a marker that
    appears during the wait raises at the next poll; one there before
    the wait counts only after the grace."""
    root = _write_tree(tmp_path / "tree", False)
    monkeypatch.setattr(imagenet.meshlib, "process_index", lambda: 1)
    monkeypatch.setattr(imagenet, "POLL_S", 0.02)
    marker = os.path.join(root, "imagenet_npy.failed")
    timer = threading.Timer(0.2, lambda: open(marker, "w").write(
        "OSError: disk full\n"))
    timer.start()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="disk full"):
        imagenet.load_splits(root, image_size=16)
    took = time.perf_counter() - t0
    timer.join()
    assert 0.15 < took < 2.0
    # the marker is now there before the wait: the grace applies
    monkeypatch.setattr(imagenet, "MARKER_GRACE_S", 0.3)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="disk full"):
        imagenet.load_splits(root, image_size=16)
    assert 0.3 <= time.perf_counter() - t0 < 2.0
    assert not os.path.exists(os.path.join(root, "imagenet_npy"))
    # a tree without Pillow raises on rank 0 too
    monkeypatch.setattr(imagenet.meshlib, "process_index", lambda: 0)
    monkeypatch.setattr(imagenet_jpeg, "available", lambda: False)
    with pytest.raises(RuntimeError, match="Pillow"):
        imagenet.load_splits(root, image_size=16)


# ------------------------------------------------------------- CIFAR-10

def _write_cifar_archive(d, rows=7):
    """A ``cifar-10-binary.tar.gz`` of six small binary files."""
    rng = np.random.default_rng(2)
    src = os.path.join(d, "src", cifar.BIN_DIR)
    os.makedirs(src)
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    for n in names:
        rec = rng.integers(0, 256, size=(rows, 3073), dtype=np.uint8)
        rec[:, 0] %= 10
        rec.tofile(os.path.join(src, n))
    for out in ("port", "ref"):
        os.makedirs(os.path.join(d, out))
        with tarfile.open(os.path.join(d, out, cifar.ARCHIVE), "w:gz") as tf:
            tf.add(src, arcname=cifar.BIN_DIR)
    return os.path.join(d, "port"), os.path.join(d, "ref")


def test_cifar_archive_is_extracted_not_replaced(tmp_path):
    port_dir, ref_dir = _write_cifar_archive(str(tmp_path))
    got = cifar.load_splits(port_dir)
    want = jax_cifar.load_splits(ref_dir)      # the archive: no download
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
    assert got.train_data.shape == (35 - 2, 32, 32, 3)
    assert os.path.isdir(os.path.join(port_dir, cifar.BIN_DIR))
    # a corrupt archive raises in both packages: no synthetic set
    for d, load in ((tmp_path / "bad_port", cifar.load_splits),
                    (tmp_path / "bad_ref", jax_cifar.load_splits)):
        os.makedirs(d)
        (d / cifar.ARCHIVE).write_bytes(b"not a tarball")
        with pytest.raises((RuntimeError, tarfile.TarError)):
            load(str(d))
    shutil.rmtree(tmp_path / "src", ignore_errors=True)


def test_concurrent_loads_extract_the_archive_whole(tmp_path, monkeypatch):
    """Two ``load_splits`` on one ``data_dir`` at once, as the ranks of a
    torchrun job call it, the second starting while the first is half
    way through the archive: both give the reference's splits, and no
    extraction directory is left behind."""
    port_dir, ref_dir = _write_cifar_archive(str(tmp_path))
    want = jax_cifar.load_splits(ref_dir)
    started = threading.Event()

    def slow_extractall(self, path=".", members=None, *, filter=None,
                        **kw):
        for m in self.getmembers():
            self.extract(m, path, filter=filter)
            started.set()
            time.sleep(0.05)

    monkeypatch.setattr(tarfile.TarFile, "extractall", slow_extractall)
    got, errors = [], []

    def load(wait):
        if wait:
            started.wait(10)
        try:
            got.append(cifar.load_splits(port_dir))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=load, args=(w,)) for w in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert not errors and len(got) == 2
    for splits in got:
        for f in dataclasses.fields(splits):
            a, b = getattr(splits, f.name), getattr(want, f.name)
            assert a.tobytes() == b.tobytes(), f.name
    assert sorted(os.listdir(port_dir)) == sorted([cifar.ARCHIVE,
                                                   cifar.BIN_DIR])
