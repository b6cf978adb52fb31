"""Checkpoints in the reference's on-disk formats.

Counterpart of ``mpi_tensorflow_tpu/train/checkpoint.py``, byte for
byte in structure, so a checkpoint either package writes restores in the
other.  A state is saved as its list of leaves in the reference's order
and layout (``train.state_io`` maps the port's train states to it); each
leaf is given as a ``Part``: its whole shape and on-disk dtype, the
regions it is split into over the ranks, the one this rank holds and its
data, and whether this rank writes it.  A bare tensor or array is a
whole leaf that rank 0 writes.

- ``save`` / ``restore``: ``<path>.npz`` holding ``leaf_00000``,
  ``leaf_00001``, ... (whole leaves), then the sidecar ``<path>.json``,
  ``{num_leaves, step, extra}``, written last: it is the commit marker;
- ``save_sharded`` / ``restore_sharded``: ``<path>.sharded/``, one
  ``l{i:05d}_s{j:04d}.npy`` per region j of leaf i (regions in order of
  their start), then ``meta.json`` (``num_leaves``; per leaf ``shape``,
  numpy ``dtype.str`` and ``shards`` of ``{start, stop, file}``;
  ``step``; ``extra``), written last by rank 0 after a barrier of every
  rank: the commit marker.  Each rank writes only the regions it holds
  and a replicated leaf is written once, by rank 0.  A restore reads
  each region a rank holds out of the files that overlap it through
  ``np.load(mmap_mode="r")``, so a state saved at one world size
  restores at another (fsdp and zero1 included) without a whole copy
  of a sharded leaf on any rank;
- ``AsyncSaver``: the sharded form, the one the loops save.  The host
  copy of this rank's regions is taken in ``save()`` (the loop may
  change the tensors in place right after) and the files are written on
  a worker thread.  ``save()`` first waits for
  the write before it, so one host copy is alive at a time.  Across
  ranks the commit (the ranks agreeing that every write succeeded, the
  barrier, ``meta.json``) runs on the main thread, inside the next
  ``save()`` or ``wait()``: a collective on the worker thread would race
  the train step's own collectives.  Until then the step is written but
  not committed, and a crash resumes from the step before;
- ``latest_step`` (the highest committed step: an ``.npz`` with its
  ``.json``, a ``.sharded/`` with its ``meta.json``), ``restore_latest``
  (the sharded form first) and ``step_path``.

``restore`` and ``restore_sharded`` take a template (the current state's
parts) and return ``(arrays, meta)``: for each leaf the region this
rank holds, as a numpy array of the template's dtype.  Leaf counts and
shapes must match, or they raise: a wrong model or configuration fails
instead of being reinterpreted.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import queue
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from mpi_tensorflow_torch.parallel import collectives
from mpi_tensorflow_torch.parallel import mesh as meshlib


@dataclasses.dataclass
class Part:
    """One leaf of a state as this rank holds it."""
    shape: tuple            # the whole leaf's shape
    dtype: np.dtype         # its dtype on disk (and after a restore)
    regions: list           # every region, ``(start, stop)`` tuples, in
                            # order of their start
    held: int               # the index of the region this rank holds
    data: Any               # that region: a tensor or an array
    writes: bool            # whether this rank writes the region


def whole(x, writes: Optional[bool] = None) -> Part:
    """A leaf held whole by every rank; rank 0 writes it (``writes``
    defaults to that)."""
    shape = tuple(x.shape)
    return Part(shape, _np_dtype(x),
                [((0,) * len(shape), shape)], 0, x,
                meshlib.process_index() == 0 if writes is None else writes)


def split(x, shape, dim: int, rank: int, world: int) -> Part:
    """A leaf of ``shape`` split into ``world`` equal slices along
    ``dim``, of which this rank holds and writes slice ``rank``
    (``x``)."""
    shape = tuple(shape)
    n = shape[dim] // world
    regions = []
    for j in range(world):
        start, stop = [0] * len(shape), list(shape)
        start[dim], stop[dim] = j * n, (j + 1) * n
        regions.append((tuple(start), tuple(stop)))
    return Part(shape, _np_dtype(x), regions, rank, x, True)


def tiled(x, shape, splits, writes: bool) -> Part:
    """A leaf of ``shape`` cut into a grid: ``splits`` lists ``(dim,
    count, index)``, dimension ``dim`` cut into ``count`` equal slices
    of which this rank holds slice ``index`` (``x``); the regions run
    over the grid row-major in dimension order (in order of their
    start).  ``writes``: whether this rank writes its region (one rank
    of those holding it)."""
    shape = tuple(shape)
    splits = sorted(splits)
    regions = []
    for combo in itertools.product(*(range(c) for _, c, _ in splits)):
        start, stop = [0] * len(shape), list(shape)
        for (d, c, _), j in zip(splits, combo):
            n = shape[d] // c
            start[d], stop[d] = j * n, (j + 1) * n
        regions.append((tuple(start), tuple(stop)))
    held = int(np.ravel_multi_index([i for _, _, i in splits],
                                    [c for _, c, _ in splits])) \
        if splits else 0
    return Part(shape, _np_dtype(x), regions, held, x, writes)


def _np_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty(0, dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def _part(x) -> Part:
    return x if isinstance(x, Part) else whole(x)


def _host(x, dtype) -> np.ndarray:
    """A host copy of ``x`` in ``dtype`` (never a view of a tensor the
    loop goes on changing)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu").numpy()
    return np.array(x, dtype=dtype, copy=True, order="C")


# ---------------------------------------------------------------- npz

def save(path: str, parts: Sequence, *, step: Optional[int] = None,
         extra: Optional[dict] = None) -> None:
    """``<path>.npz`` (+ ``.json``) of whole leaves; across ranks call
    it on rank 0 alone."""
    arrays = {}
    for i, p in enumerate(map(_part, parts)):
        if len(p.regions) != 1:
            raise ValueError(f"leaf {i} is split over {len(p.regions)} "
                             f"ranks; the npz format holds whole leaves "
                             f"(use save_sharded)")
        arrays[f"leaf_{i:05d}"] = _host(p.data, p.dtype)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    # the sidecar is the commit marker, written last: latest_step skips
    # a bare .npz
    tmpj = path + ".json.tmp"
    with open(tmpj, "w") as f:
        json.dump({"num_leaves": len(parts), "step": step,
                   "extra": extra or {}}, f)
    os.replace(tmpj, path + ".json")


def _held(p: Part) -> tuple:
    return tuple(slice(a, b) for a, b in zip(*p.regions[p.held]))


def _check(num_leaves: int, shapes, template: list) -> None:
    if len(template) != num_leaves:
        raise ValueError(f"checkpoint has {num_leaves} leaves, template "
                         f"has {len(template)} — model/config mismatch")
    for got, p in zip(shapes, template):
        if tuple(got) != p.shape:
            raise ValueError(f"leaf shape mismatch: checkpoint "
                             f"{tuple(got)} vs template {p.shape}")


def restore(path: str, template: Sequence) -> tuple[list, dict]:
    """``(arrays, meta)`` from ``<path>.npz``: each template leaf's held
    region."""
    template = [_part(p) for p in template]
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as z:
        leaves = [z[f"leaf_{i:05d}"] for i in range(meta["num_leaves"])]
    _check(len(leaves), [x.shape for x in leaves], template)
    return [np.array(x[_held(p)], dtype=p.dtype, copy=True)
            for x, p in zip(leaves, template)], meta


# ------------------------------------------------------------ sharded

def snapshot_sharded(parts: Sequence) -> tuple[list, dict]:
    """``(jobs, meta)``: the ``(file name, host array)`` pairs this rank
    writes, and the metadata of every leaf (the same on every rank)."""
    jobs, leaf_meta = [], []
    for i, p in enumerate(map(_part, parts)):
        shards = []
        for j, (start, stop) in enumerate(p.regions):
            fname = f"l{i:05d}_s{j:04d}.npy"
            shards.append({"start": list(start), "stop": list(stop),
                           "file": fname})
            if p.writes and j == p.held:
                jobs.append((fname, _host(p.data, p.dtype).reshape(
                    [b - a for a, b in zip(start, stop)])))
        leaf_meta.append({"shape": list(p.shape), "dtype": p.dtype.str,
                          "shards": shards})
    return jobs, {"num_leaves": len(parts), "leaves": leaf_meta}


def _write_shard_files(d: str, jobs: list) -> None:
    os.makedirs(d, exist_ok=True)
    for fname, arr in jobs:
        tmpf = os.path.join(d, fname + ".tmp")
        with open(tmpf, "wb") as f:
            np.save(f, arr)
        os.replace(tmpf, os.path.join(d, fname))


def _barrier_and_commit(d: str, meta: dict) -> None:
    """Every rank's files written (a barrier across the ranks), then
    rank 0 writes the commit marker.  A collective: main thread only,
    at the same point of the loop on every rank."""
    if meshlib.process_count() > 1:
        collectives.barrier()
    if meshlib.process_index() == 0:
        tmpm = os.path.join(d, "meta.json.tmp")
        with open(tmpm, "w") as f:
            json.dump(meta, f)
        os.replace(tmpm, os.path.join(d, "meta.json"))


def save_sharded(path: str, parts: Sequence, *, step: Optional[int] = None,
                 extra: Optional[dict] = None) -> None:
    """``<path>.sharded/``: every rank calls it and writes its own
    regions; rank 0 commits."""
    files, meta = snapshot_sharded(parts)
    meta.update(step=step, extra=extra or {})
    _write_shard_files(path + ".sharded", files)
    _barrier_and_commit(path + ".sharded", meta)


def restore_sharded(path: str, template: Sequence) -> tuple[list, dict]:
    """``(arrays, meta)`` from ``<path>.sharded/``: each template leaf's
    held region, read from the region files that overlap it."""
    template = [_part(p) for p in template]
    d = path + ".sharded"
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    _check(meta["num_leaves"], [lm["shape"] for lm in meta["leaves"]],
           template)
    out = []
    for lm, p in zip(meta["leaves"], template):
        want = p.regions[p.held]
        dst = np.empty([b - a for a, b in zip(*want)], p.dtype)
        for s in lm["shards"]:
            inter = [(max(lo, a), min(hi, b)) for lo, hi, a, b in zip(
                *want, s["start"], s["stop"])]
            if any(lo >= hi for lo, hi in inter):
                continue
            src = np.load(os.path.join(d, s["file"]), mmap_mode="r")
            dst[tuple(slice(lo - r, hi - r) for (lo, hi), r in zip(
                inter, want[0]))] = src[tuple(
                    slice(lo - a, hi - a) for (lo, hi), a in zip(
                        inter, s["start"]))]
        out.append(dst)
    return out, meta


# -------------------------------------------------------------- async

def _all_ranks_ok(local_ok: bool) -> bool:
    """A flag agreed over the ranks (all must hold it); main thread
    only."""
    if meshlib.process_count() == 1:
        return local_ok
    flag = torch.tensor([1 if local_ok else 0], dtype=torch.int32)
    collectives.allreduce_sum(flag)
    return int(flag) == meshlib.process_count()


class AsyncSaver:
    """Checkpoint writes on a worker thread (module note).  Errors of a
    write raise in the next ``save()`` or ``wait()``."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._exc: Optional[BaseException] = None
        self._pending_commit: Optional[tuple] = None   # (dir, meta)
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def _work(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                d, files, meta = job
                _write_shard_files(d, files)
                if meta is not None:          # one rank: commit here too
                    _barrier_and_commit(d, meta)
            except BaseException as e:
                self._exc = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._exc is not None:
            e, self._exc = self._exc, None
            raise RuntimeError("async checkpoint write failed") from e

    def _drain(self):
        """The write in flight joined, then (across ranks) the deferred
        commit, all ranks or none: a rank whose write failed must not
        leave its peers waiting in the barrier."""
        self._q.join()
        pending, self._pending_commit = self._pending_commit, None
        if pending is not None:
            local_ok = self._exc is None
            if _all_ranks_ok(local_ok):
                _barrier_and_commit(*pending)
            elif local_ok:
                raise RuntimeError(
                    "sharded checkpoint write failed on a peer rank; step "
                    "not committed")
        self._check()

    def save(self, path: str, parts: Sequence, *,
             step: Optional[int] = None,
             extra: Optional[dict] = None) -> None:
        """Queue ``<path>.sharded/`` (the form the loops save)."""
        self._drain()
        files, meta = snapshot_sharded(parts)
        meta.update(step=step, extra=extra or {})
        d = path + ".sharded"
        if meshlib.process_count() > 1:
            self._q.put((d, files, None))
            self._pending_commit = (d, meta)
        else:
            self._q.put((d, files, meta))

    def wait(self) -> None:
        """Every queued write on disk and committed."""
        self._drain()

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10.0)


# ------------------------------------------------------------- lookup

PREFIX = "ckpt"                  # ckpt_<step>.npz / .sharded, as the reference


def latest_step(directory: str) -> Optional[int]:
    """The highest committed step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if not name.startswith(PREFIX + "_"):
            continue
        if name.endswith(".npz"):
            if not os.path.exists(
                    os.path.join(directory, name[:-4] + ".json")):
                continue                 # a bare .npz: not committed
            stem = name[len(PREFIX) + 1:-4]
        elif name.endswith(".sharded") and os.path.exists(
                os.path.join(directory, name, "meta.json")):
            stem = name[len(PREFIX) + 1:-8]
        else:
            continue
        try:
            steps.append(int(stem))
        except ValueError:
            continue
    return max(steps) if steps else None


def restore_latest(directory: str, template: Sequence,
                   step: int) -> tuple[list, dict]:
    """Step ``step`` from whichever format holds it (sharded first)."""
    base = step_path(directory, step)
    if os.path.exists(base + ".sharded/meta.json"):
        return restore_sharded(base, template)
    return restore(base, template)


def step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"{PREFIX}_{step}")
