"""Window assembly for the windowed train loop.

Counterpart of ``assemble_window`` in
``mpi_tensorflow_tpu/data/prefetch.py``.  A window is ``(K, global_b,
...)`` batches and ``(K, global_b)`` labels: step ``t0 + j`` of each of
the ``n_shards`` shards takes rows ``[off, off + batch)`` of its own
shard (``off`` the reference's wraparound offset), and the shards'
rows are concatenated in shard order.  The loop assembles each window
inline, just before it uploads it.  The reference's background
assembly (a Python thread or its C++ worker in ``native/``) has no
counterpart yet: ``prefetch="native"`` raises in ``Config`` (ROADMAP
Queue 1 item 15), and the other values have no effect.
"""

from __future__ import annotations

import numpy as np

from mpi_tensorflow_torch.data.sharding import batch_offset


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
