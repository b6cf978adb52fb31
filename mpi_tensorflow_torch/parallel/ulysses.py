"""Ulysses (all-to-all) sequence parallelism: the second attention over a
``seq`` axis.

Counterpart of ``mpi_tensorflow_tpu/parallel/ulysses.py``.  Where ring
attention (``parallel/ring.py``) moves K/V round the ring, Ulysses
re-shards twice with ``collectives.all_to_all``: heads are exchanged
for sequence, so each rank holds the WHOLE sequence of ``H / n`` heads,
runs an ordinary attention on it (``inner``: the flash kernels on the
card at long S, ``models/bert.py``), and the output goes back to the
sequence layout.  Two all-to-alls of the activations per call, whatever
the length; it needs ``H % n == 0``.
"""

from __future__ import annotations

from typing import Callable, Optional

from mpi_tensorflow_torch.parallel import collectives
from mpi_tensorflow_torch.parallel.ring import dense_attention


def ulysses_attention(q, k, v, axis, *, causal: bool = False,
                      scale: Optional[float] = None,
                      inner: Optional[Callable] = None):
    """All-to-all sequence-parallel attention over ``axis``
    (``mesh.group("seq")``).  q, k, v: (B, H, S_local, D), this rank's
    block of the sequence; ``H`` must divide by the axis size.
    ``inner(q, k, v, causal=, scale=)`` is the attention on the whole
    sequence (default ``dense_attention``)."""
    n = axis.size
    H = q.shape[1]
    if H % n != 0:
        raise ValueError(
            f"ulysses needs num_heads ({H}) divisible by the "
            f"{'/'.join(axis.names) or 'seq'} axis size ({n}); use ring "
            f"attention otherwise")
    attn = inner if inner is not None else dense_attention
    if n == 1:
        return attn(q, k, v, causal=causal, scale=scale)
    # split heads, gather the sequence: (B, H/n, S, D), blocks in order
    qh, kh, vh = (collectives.all_to_all(x, axis, 1, 2) for x in (q, k, v))
    o = attn(qh, kh, vh, causal=causal, scale=scale)
    return collectives.all_to_all(o, axis, 2, 1)
