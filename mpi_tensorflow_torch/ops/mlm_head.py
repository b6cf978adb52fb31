"""Masked-position packing for the MLM head.

Counterpart of ``mpi_tensorflow_tpu/ops/mlm_head.py``'s
``gather_masked_rows``.  The chunked ``tied_softmax_ce`` is not on the
default path (``ce_impl="auto"`` with masked packing takes the dense CE)
and is not ported yet (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import torch


def gather_masked_rows(h, labels, mask, capacity: int):
    """Pack each row's masked positions, first-come, into a fixed-width
    buffer, so the head transform and vocab decoder run on ``capacity``
    positions per row instead of S.  Positions beyond ``capacity`` get
    weight 0.

    h: (B, S, E), labels/mask: (B, S).  Returns ``(packed_h (B, P, E),
    packed_labels (B, P), weights (B, P) float32)``, P = ``capacity``;
    unfilled slots read position 0 with weight 0.
    """
    B, S, E = h.shape
    dev = h.device
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1     # nth masked
    keep = mask & (pos < capacity)
    slot = torch.where(keep, pos, capacity).to(torch.int64)  # overflow col
    cols = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    idx = torch.zeros((B, capacity + 1), dtype=torch.int32, device=dev) \
        .scatter(1, slot, cols)[:, :capacity]                # source col
    w = torch.zeros((B, capacity + 1), dtype=torch.bool, device=dev) \
        .scatter(1, slot, keep)[:, :capacity]
    idx64 = idx.to(torch.int64)
    packed = torch.gather(h, 1, idx64[..., None].expand(B, capacity, E))
    plabels = torch.gather(labels, 1, idx64)
    return packed, plabels, w.to(torch.float32)
