"""The MLM head's helpers: masked-position packing and the chunked tied
cross-entropy.

Counterpart of ``mpi_tensorflow_tpu/ops/mlm_head.py``:

- ``gather_masked_rows`` packs each row's masked positions before the
  head (the MLM family's default);
- ``tied_softmax_ce`` is the cross-entropy of ``t @ emb.T + out_b``
  without a (B, S, V) logits tensor, in the forward or the backward: the
  reference's ``lax.scan`` over vocabulary tiles with an online (max,
  sum) in float32, each tile under ``jax.checkpoint``.  Here the
  log-partition is a ``torch.autograd.Function`` whose backward
  recomputes each tile's logits, so at most one (B, S, chunk) float32
  tile is live.  The reference scans in XLA, not in a Pallas kernel, so
  the tile products stay ``torch.matmul`` (cuBLAS on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG_BIG = -1e30   # bias of the padded vocabulary rows: exp() gives 0


def _tiles(emb, out_b, chunk: int, dtype):
    """``(emb (nc, chunk, E) in dtype, bias (nc, chunk) float32)``: the
    vocabulary padded to whole tiles, the pad rows zero with bias
    -1e30, as the reference pads them."""
    V, E = emb.shape
    nc = -(-V // chunk)
    vp = nc * chunk
    emb_c = F.pad(emb.to(dtype), (0, 0, 0, vp - V)).reshape(nc, chunk, E)
    bias_c = F.pad(out_b.to(torch.float32), (0, vp - V),
                   value=_NEG_BIG).reshape(nc, chunk)
    return emb_c, bias_c


class _LogZ(torch.autograd.Function):
    """``logsumexp(t @ emb.T + out_b, -1)`` (B, S) float32 over vocabulary
    tiles; the backward recomputes each tile's logits."""

    @staticmethod
    def forward(ctx, t, emb, out_b, chunk, dtype):
        emb_c, bias_c = _tiles(emb, out_b, chunk, dtype)
        B, S, _ = t.shape
        m = torch.full((B, S), float("-inf"), dtype=torch.float32,
                       device=t.device)
        s = torch.zeros((B, S), dtype=torch.float32, device=t.device)
        td = t.to(dtype)
        for ec, bc in zip(emb_c, bias_c):
            # one (B, S, chunk) tile: the product in the compute dtype,
            # the bookkeeping in float32
            lg = (td @ ec.t()).to(torch.float32) + bc
            m_new = torch.maximum(m, lg.amax(-1))
            s = s * torch.exp(m - m_new) \
                + torch.exp(lg - m_new[..., None]).sum(-1)
            m = m_new
        logz = m + torch.log(s)
        ctx.save_for_backward(t, emb, out_b, logz)
        ctx.chunk, ctx.dtype = chunk, dtype
        return logz

    @staticmethod
    def backward(ctx, g):
        t, emb, out_b, logz = ctx.saved_tensors
        chunk, dtype = ctx.chunk, ctx.dtype
        V, E = emb.shape
        emb_c, bias_c = _tiles(emb, out_b, chunk, dtype)
        td = t.to(dtype)
        flat = td.reshape(-1, E)
        dt = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        demb = torch.zeros((emb_c.shape[0] * chunk, E), dtype=torch.float32,
                           device=t.device)
        db = torch.zeros(emb_c.shape[0] * chunk, dtype=torch.float32,
                         device=t.device)
        for i, (ec, bc) in enumerate(zip(emb_c, bias_c)):
            lg = (td @ ec.t()).to(torch.float32) + bc
            # d logz / d logits = softmax; times the incoming gradient
            p = torch.exp(lg - logz[..., None]) * g[..., None]
            pd = p.to(dtype)
            dt += (pd @ ec).to(torch.float32)
            rows = slice(i * chunk, (i + 1) * chunk)
            demb[rows] = (pd.reshape(-1, chunk).t() @ flat).to(torch.float32)
            db[rows] = p.sum((0, 1))
        return (dt.to(t.dtype), demb[:V].to(emb.dtype),
                db[:V].to(out_b.dtype), None, None)


def tied_softmax_ce(t, emb, out_b, labels, *, chunk: int = 2048,
                    dtype=None):
    """Per-position cross-entropy of ``logits = t @ emb.T + out_b``.

    t:      (B, S, E) head hidden states (the compute dtype)
    emb:    (V, E)    tied decoder matrix (the token embedding)
    out_b:  (V,)      output bias
    labels: (B, S)    int gold ids
    Returns (B, S) float32 ``logsumexp(logits) - logits[labels]``; the
    gold logit comes from the gathered label rows.  ``chunk`` is the
    vocabulary tile; ``dtype`` the products' (default ``t``'s)."""
    dtype = dtype or t.dtype
    logz = _LogZ.apply(t, emb, out_b, int(chunk), dtype)
    labels = labels.long()
    gold = (t.to(dtype) * emb[labels].to(dtype)).sum(-1).to(torch.float32) \
        + out_b[labels].to(torch.float32)
    return logz - gold


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
