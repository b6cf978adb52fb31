"""The MLM head's helpers: masked-position packing and the chunked tied
cross-entropy.

Counterpart of ``mpi_tensorflow_tpu/ops/mlm_head.py``:

- ``gather_masked_rows`` packs each row's masked positions before the
  head (the MLM family's default); ``rows_part`` gives one rank of a
  ``seq`` axis its equal part of the packed rows;
- ``tied_softmax_ce`` is the cross-entropy of ``t @ emb.T + out_b``
  without a (B, S, V) logits tensor, in the forward or the backward: the
  reference's ``lax.scan`` over vocabulary tiles with an online (max,
  sum) in float32, each tile under ``jax.checkpoint``.  Here the
  log-partition is a ``torch.autograd.Function`` whose backward
  recomputes each tile's logits, so at most one (B, S, chunk) float32
  tile is live.  The reference scans in XLA, not in a Pallas kernel, so
  the tile products stay ``torch.matmul`` (cuBLAS on the card);
- ``vocab_parallel_ce`` is the same cross-entropy over a vocabulary
  sharded on a ``model`` axis (the reference's GSPMD places these
  collectives from the sharding): each rank's logits (dense, or its
  log-partition by tiles) over its rows, the max and the sum of
  exponentials taken over the axis, the gold logit from the rank that
  owns it; ``vocab_parallel_argmax`` is the argmax over such logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mpi_tensorflow_torch.parallel import collectives

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


def vocab_parallel_ce(t, emb, out_b, labels, axis, *, chunk=None,
                      dtype=None):
    """``tied_softmax_ce`` with ``emb`` (V/M, E) and ``out_b`` (V/M,) this
    rank's rows of a vocabulary sharded over ``axis`` (rank i holds rows
    ``[i V/M, (i+1) V/M)``); every rank returns the whole (B, S) CE.
    ``chunk``: this rank's log-partition by tiles (``_LogZ``), else from
    its dense (B, S, V/M) logits.  ``t`` is held whole by every rank:
    its gradient is summed over the axis (``copy_to``)."""
    dtype = dtype or t.dtype
    f32 = torch.float32
    t = collectives.copy_to(t, axis)
    rows = emb.shape[0]
    local = labels.long() - axis.index * rows
    mine = (local >= 0) & (local < rows)
    idx = local.clamp(0, rows - 1)
    if chunk is None:
        logits = (t.to(dtype) @ emb.to(dtype).t()).to(f32) + out_b
        part = logits.detach().amax(-1)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
    else:
        part = _LogZ.apply(t, emb, out_b, int(chunk), dtype)
        logits = part[..., None]
        gold = (t.to(dtype) * emb[idx].to(dtype)).sum(-1).to(f32) \
            + out_b[idx].to(f32)
        part = part.detach()
    m = collectives.allreduce_max(part.clone(), axis)
    # all-reduce forward, identity backward: each rank's share of the
    # softmax's and the gold logit's gradient stays its own
    sumexp = collectives.reduce_from(
        torch.exp(logits - m[..., None]).sum(-1), axis)
    gold = collectives.reduce_from(gold * mine, axis)
    return m + torch.log(sumexp) - gold


def vocab_parallel_argmax(logits, axis):
    """The argmax (int64) over a vocabulary sharded over ``axis``:
    ``logits`` (..., V/M) are this rank's slice, rank i's columns ``[i
    V/M, (i+1) V/M)``.  Among ties, within a rank or across ranks, the
    lowest global index, as ``argmax`` takes them.  A collective: every
    rank of the axis calls it and gets the same ids."""
    ids = logits.argmax(-1)
    best = torch.gather(logits, -1, ids[..., None])[..., 0]
    ids = ids + axis.index * logits.shape[-1]
    vals = collectives.allgather(best.contiguous(), axis=axis)
    idxs = collectives.allgather(ids.contiguous(), axis=axis)
    top = vals.amax(0)
    return torch.where(vals == top, idxs,
                       torch.full_like(idxs, 2 ** 62)).amin(0)


def rows_part(x, index: int, n: int):
    """Part ``index`` of ``n`` of the rows of packed ``x`` (B, P, ...):
    the B x P rows flattened, zero-padded to a multiple of n, split
    evenly; returned as (1, ceil(B P / n), ...)."""
    flat = x.reshape(-1, *x.shape[2:])
    per = -(-flat.shape[0] // n)
    pad = per * n - flat.shape[0]
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, *flat.shape[1:]))])
    return flat[index * per:(index + 1) * per][None]
