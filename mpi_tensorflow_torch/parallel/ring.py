"""Attention without a sequence mesh.

Counterpart of ``mpi_tensorflow_tpu/parallel/ring.py``'s
``dense_attention`` only: the attention ``BertMlm`` runs below
``flash_min_seq``.  Ring attention over a ``seq`` axis waits for the
parallelism slices (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

from typing import Optional

import torch


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
