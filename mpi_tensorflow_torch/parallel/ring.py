"""Dense attention, and ring attention over a ``seq`` axis.

Counterpart of ``mpi_tensorflow_tpu/parallel/ring.py``:

- ``dense_attention``: the attention ``BertMlm`` runs below
  ``flash_min_seq`` without a sequence axis;
- ``ring_attention``: each rank of the ``seq`` axis holds a contiguous
  block of the sequence's queries, keys and values; the K/V blocks go
  round the ring by ``collectives.ppermute_shift`` (n - 1 hops, each the
  gradient's way back in the backward), and each rank folds every block
  into its queries' streaming (online) softmax, the causal mask at the
  blocks' global positions.  Above ``_CHUNK_ABOVE`` local positions a
  hop streams its K/V block in ``block_k``-wide chunks through the same
  update, each chunk recomputed in the backward (``_Chunk``, the
  reference's ``jax.checkpoint`` of the chunk), so a hop holds
  (S_local, block_k) scores, not (S_local, S_local).

The reference keeps the hop's update in XLA, not in its Pallas kernel
(``ring.py:19-33``), so the update here is torch ops: no hand kernel
lies on the ring.  The running maximum is not differentiated through
(the result does not depend on it).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mpi_tensorflow_torch.parallel import collectives

NEG_INF = float("-inf")
# chunk the hop's K/V block above this local length (the reference's)
_CHUNK_ABOVE = 1024
_DEFAULT_BLOCK_K = 512


def dense_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Plain softmax attention over q, k, v (B, H, S, D): scores and the
    softmax in float32 (the reference's ``preferred_element_type``), the
    probabilities rounded to v's dtype before P.V, output in v's
    dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    f32 = torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), k.to(f32)) * scale
    if causal:
        pos = torch.arange(q.shape[2], device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _online_update(q, kb, vb, o, m, l, qpos, kpos, scale: float,
                   causal: bool):
    """One online-softmax accumulator update of queries ``q`` against
    the K/V block ``kb``/``vb``; ``qpos``/``kpos`` are their global
    positions (for the causal mask).  ``o`` (B, H, Sq, D), ``m`` and
    ``l`` (B, H, Sq) float32."""
    f32 = torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), kb.to(f32)) * scale
    if causal:
        s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
    m_new = torch.maximum(m, s.detach().amax(-1))
    # rows masked so far keep m == -inf: normalise against 0 there
    m_use = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                        m_new)
    p = torch.exp(s - m_use[..., None])
    corr = torch.where(torch.isneginf(m), torch.zeros_like(m),
                       torch.exp(m - m_use))
    l = l * corr + p.sum(-1)
    o = o * corr[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(vb.dtype).to(f32), vb.to(f32))
    return o, m_new, l


class _Chunk(torch.autograd.Function):
    """``_online_update`` of one chunk, its scores recomputed in the
    backward instead of saved (the running maximum carries no
    gradient)."""

    @staticmethod
    def forward(ctx, q, kc, vc, o, m, l, qpos, kpos, scale, causal):
        ctx.save_for_backward(q, kc, vc, o, m, l, qpos, kpos)
        ctx.scale, ctx.causal = scale, causal
        o, m, l = _online_update(q, kc, vc, o, m, l, qpos, kpos, scale,
                                 causal)
        ctx.mark_non_differentiable(m)
        return o, m, l

    @staticmethod
    def backward(ctx, go, _, gl):
        q, kc, vc, o, m, l, qpos, kpos = ctx.saved_tensors
        xs = [x.detach().requires_grad_() for x in (q, kc, vc, o, l)]
        with torch.enable_grad():
            o2, _, l2 = _online_update(*xs[:4], m, xs[4], qpos, kpos,
                                       ctx.scale, ctx.causal)
            dq, dk, dv, do, dl = torch.autograd.grad(
                (o2, l2), xs, (go if go is not None else torch.zeros_like(o2),
                               gl if gl is not None else torch.zeros_like(l2)))
        return dq, dk, dv, do, None, dl, None, None, None, None


def ring_attention(q, k, v, axis, *, causal: bool = False,
                   scale: Optional[float] = None,
                   block_k: Optional[int] = None):
    """Blockwise ring attention over ``axis`` (``mesh.group("seq")``):
    q, k, v (B, H, S_local, D) are this rank's contiguous block of the
    sequence (rank i holds positions ``[i * S_local, (i + 1) *
    S_local)``).  Equal to ``dense_attention`` on the gathered sequence.
    ``block_k``: the chunk of a hop (default: none up to ``_CHUNK_ABOVE``
    local positions, above it the largest divisor of S_local up to 512
    when that is at least 128)."""
    n, my = axis.size, axis.index
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    bq, s_local = q.shape[2], k.shape[2]
    if block_k is None and s_local > _CHUNK_ABOVE:
        cand = math.gcd(s_local, _DEFAULT_BLOCK_K)
        block_k = cand if cand >= 128 else None
    if block_k is not None and (block_k <= 0 or s_local % block_k):
        raise ValueError(
            f"block_k {block_k} must divide the local K length {s_local}")
    dev = q.device
    B, H = q.shape[:2]
    f32 = torch.float32
    o = torch.zeros((B, H, bq, v.shape[-1]), dtype=f32, device=dev)
    m = torch.full((B, H, bq), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, H, bq), dtype=f32, device=dev)
    qpos = my * bq + torch.arange(bq, device=dev)
    kb, vb = k, v
    for i in range(n):
        blk = (my - i) % n                     # whose block kb is
        base = blk * s_local
        if block_k is None:
            kpos = base + torch.arange(s_local, device=dev)
            o, m, l = _online_update(q, kb, vb, o, m, l, qpos, kpos, scale,
                                     causal)
        else:
            for c in range(s_local // block_k):
                kc = kb[:, :, c * block_k:(c + 1) * block_k]
                vc = vb[:, :, c * block_k:(c + 1) * block_k]
                kpos = base + c * block_k + torch.arange(block_k,
                                                         device=dev)
                o, m, l = _Chunk.apply(q, kc, vc, o, m, l, qpos, kpos,
                                       scale, causal)
        if i + 1 < n:
            kb = collectives.ppermute_shift(kb, axis)
            vb = collectives.ppermute_shift(vb, axis)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l[..., None]).to(q.dtype)
