"""Window assembly for the windowed train loop, inline or on a thread.

Counterpart of ``mpi_tensorflow_tpu/data/prefetch.py``.  A window is
``(K, global_b, ...)`` batches and ``(K, global_b)`` labels: step
``t0 + j`` of each of the ``n_shards`` shards takes rows ``[off, off +
batch)`` of its own shard (``off`` the reference's wraparound offset),
and the shards' rows are concatenated in shard order.

- ``assemble_window``: one window, inline (``prefetch="off"``), and the
  golden gather the prefetcher performs;
- ``ThreadPrefetcher``: a Python thread that assembles the windows of a
  schedule ahead into a bounded queue (two deep), so the host gathers
  the next window while the card runs the current one.  A worker that
  dies raises in ``next()`` instead of blocking, and ``close()`` stops
  it within one queue timeout, so a preemption exit never waits for the
  rest of the schedule;
- ``make_prefetcher``: the thread (``force`` None, ``"auto"`` or
  ``"thread"``).  The reference's ``auto`` takes its C++ worker
  (``native/prefetcher.cpp``) when the library loads; the port has no
  counterpart yet, so ``auto`` takes the thread and ``force="native"``
  raises (ROADMAP Queue 1 item 15c).

The schedule (start step and width of each window) is the caller's
(``train.loop.window_schedule``).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from mpi_tensorflow_torch.data.sharding import batch_offset

DEPTH = 2        # windows assembled ahead, as the reference's queue


def assemble_window(tr_d, tr_l, t0: int, w: int, window_k: int,
                    batch: int):
    """The inline assembly of one window: ``tr_d`` (n_shards, local_n,
    ...feat), ``tr_l`` (n_shards, local_n); rows ``w..window_k-1`` stay
    zero."""
    n_shards, local_n = tr_l.shape
    global_b = n_shards * batch
    bs = np.zeros((window_k, global_b) + tr_d.shape[2:], tr_d.dtype)
    ls = np.zeros((window_k, global_b), tr_l.dtype)
    for j in range(w):
        off = batch_offset(t0 + j, batch, local_n)
        bs[j] = tr_d[:, off:off + batch].reshape(global_b, *tr_d.shape[2:])
        ls[j] = tr_l[:, off:off + batch].reshape(global_b)
    return bs, ls


class ThreadPrefetcher:
    """The windows of ``(starts, widths)`` assembled ahead on a thread
    into a queue of ``DEPTH``; ``next()`` returns ``(batches, labels,
    width)`` in schedule order, then None."""

    def __init__(self, tr_d, tr_l, starts, widths, window_k: int,
                 batch: int):
        self._q: queue.Queue = queue.Queue(maxsize=DEPTH)
        self._n = len(starts)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None

        def work():
            try:
                for t0, w in zip(starts, widths):
                    if self._stop.is_set():
                        return
                    item = assemble_window(tr_d, tr_l, int(t0), int(w),
                                           window_k, batch) + (int(w),)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:       # surfaced by next()
                self._exc = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="window-prefetch")
        self._thread.start()

    def _failed(self) -> RuntimeError:
        return RuntimeError("prefetch worker failed")

    def next(self):
        """The next window, or None when the schedule is done.  Raises
        when the worker died instead of waiting for it."""
        if self._n == 0:
            return None
        while True:
            try:
                item = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if self._exc is not None:
                    raise self._failed() from self._exc
                if not self._thread.is_alive():
                    # the worker may have put its last window and ended
                    # between the timeout and the check
                    try:
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        if self._exc is not None:
                            raise self._failed() from self._exc
                        raise RuntimeError(
                            "prefetch worker died without producing a "
                            "window") from None
        self._n -= 1
        return item

    def close(self) -> None:
        """Stop the worker: it notices within one 0.1 s put timeout."""
        self._stop.set()
        self._thread.join(timeout=5.0)


def make_prefetcher(tr_d, tr_l, starts, widths, window_k: int, batch: int,
                    force: Optional[str] = None):
    """The background assembler of a schedule: the thread for ``force``
    None, ``"auto"`` or ``"thread"``; ``"native"`` raises."""
    if force == "native":
        raise RuntimeError(
            "the native window prefetcher (the C++ worker) is not ported "
            "yet: ROADMAP Queue 1 item 15c")
    if force not in (None, "auto", "thread"):
        raise ValueError(f"unknown prefetcher {force!r}")
    return ThreadPrefetcher(tr_d, tr_l, starts, widths, window_k, batch)
