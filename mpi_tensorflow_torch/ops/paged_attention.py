"""Paged KV-cache ops: block-table scatter/gather and attention dispatch.

Counterpart of ``mpi_tensorflow_tpu/ops/paged_attention.py`` for the
pool held in the model's compute dtype (``kv_dtype="fp32"``); the int8
and int4 pools are ROADMAP Queue 2 items 4(b) and 4(c).

The pool of one layer is ``(num_blocks, H, block_size, D)``, head-major
so one block is ``(H, block_size, D)``.  A sequence owns an ordered list
of pool blocks (its block table); block ``j`` holds absolute positions
``[j*block_size, (j+1)*block_size)``.  Block 0 is the NULL block: never
allocated, it absorbs the writes of masked-out lanes.

``attend`` is the dispatch seam behind ``--serve-kernel``:

- ``"cuda"``   — the hand-written CUDA kernel reading pool blocks in
  place with an fp32 online softmax (``ops/paged_attention_kernel``;
  the counterpart of the reference's ``"pallas"``);
- ``"gather"`` — this module's gather + dense masked softmax (the
  counterpart of the reference's ``"xla"``).

There is no silent fallback between the two: ``resolve_kernel`` maps
``"auto"`` by the tensors' device alone, runs no probe and catches
nothing, and a CUDA tensor handed to the kernel either launches it or
raises.  The control arm is an explicit ``--serve-kernel gather``.
"""

from __future__ import annotations

import torch

NULL_BLOCK = 0

KERNELS = ("auto", "gather", "cuda")


def masked_softmax_attention(q, k, v, vis, dt, scale=None):
    """The fp32 masked-softmax attention shared by the contiguous cache
    path (``models/gpt.forward_with_cache``) and the paged gather path.

    q: (B, H, S, D); k, v: (B, H, L, D); vis: bool broadcastable to
    (B, H, S, L), True where the key lane is visible; dt: dtype of the
    probability @ V product.  The score product runs in the compute
    dtype and is cast to float32 BEFORE the scale (as the reference's
    einsum + astype); masked lanes score float32 min, so their weight
    underflows to exactly 0."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bhsd,bhld->bhsl", q, k).to(torch.float32)
    s = torch.where(vis, s * scale, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(dt)
    return torch.einsum("bhsl,bhld->bhsd", p, v)


def write_kv(pool, kv, block_table, positions, valid) -> None:
    """Scatter per-token K or V vectors into ``pool`` IN PLACE.

    pool: (num_blocks, H, block_size, D); kv: (B, H, S, D);
    block_table: (B, NB) int32; positions: (B, S) absolute positions;
    valid: (B, S) bool — False lanes write into the null block.

    The reference returns a new pool (a functional ``.at[].set``) and
    relies on buffer donation on the TPU to update it in place; here the
    update is an in-place ``index_put_``, which needs neither.  Lanes of
    distinct sequences never collide (the allocator hands each block to
    one sequence); invalid lanes may all land on the same slot of block
    0, and which of them wins does not matter — block 0 is never read
    unmasked."""
    bs = pool.shape[2]
    nb = block_table.shape[1]
    H = pool.shape[1]
    blk_idx = torch.clamp(positions // bs, 0, nb - 1).to(torch.int64)
    blk = torch.gather(block_table.to(torch.int64), 1, blk_idx)   # (B, S)
    blk = torch.where(valid, blk, NULL_BLOCK)
    off = (positions % bs).to(torch.int64)
    heads = torch.arange(H, device=pool.device)
    vals = kv.permute(0, 2, 1, 3)                                 # (B, S, H, D)
    # (B, S, 1) x (H,) x (B, S, 1) index -> (B, S, H) rows of D values
    pool.index_put_((blk[..., None], heads, off[..., None]),
                    vals.to(pool.dtype))


def gather_kv(pool, block_table):
    """Reassemble the contiguous (B, H, NB*block_size, D) view; entry
    ``l`` holds absolute position ``l``."""
    g = pool[block_table.to(torch.int64)]           # (B, NB, H, bs, D)
    B, NB, H, bs, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, H, NB * bs, D)


def paged_attention(q, ck, cv, q_positions, dt):
    """Masked causal attention over a gathered view: a key lane is
    visible to a query iff its position <= the query's, per row."""
    L = ck.shape[2]
    col = torch.arange(L, device=q.device)
    vis = col[None, None, :] <= q_positions[:, :, None]          # (B, S, L)
    return masked_softmax_attention(q, ck, cv, vis[:, None], dt)


def attend(q, k_pool, v_pool, block_table, lengths, dt, *,
           kernel: str = "gather"):
    """Attention of ``q`` (B, H, S, D) at positions ``[lengths[b],
    lengths[b] + S)`` over the paged cache; the queries' own K/V must
    already be in the pools (``write_kv`` runs first).  ``kernel`` is a
    RESOLVED choice, ``"gather"`` or ``"cuda"`` (see
    ``resolve_kernel``).  Rows may sit at different phases (one real
    decode lane beside a prefill chunk): visibility is per row."""
    if kernel == "cuda":
        from mpi_tensorflow_torch.ops import paged_attention_kernel as pk

        fused = (pk.paged_decode_attention if q.shape[2] == 1
                 else pk.paged_prefill_attention)
        # the projection einsum may hand q over as a strided view; the
        # kernel reads dense (B, H, S, D)
        return fused(q.contiguous(), k_pool, v_pool, block_table, lengths)
    if kernel != "gather":
        raise ValueError(
            f"unresolved paged-attention kernel {kernel!r}: callers "
            f"resolve 'auto' with resolve_kernel first")
    S = q.shape[2]
    pos = lengths[:, None] + torch.arange(S, dtype=torch.int32,
                                          device=q.device)
    ck = gather_kv(k_pool, block_table)
    cv = gather_kv(v_pool, block_table)
    return paged_attention(q, ck, cv, pos, dt)


def resolve_kernel(choice: str, device: torch.device) -> str:
    """``--serve-kernel`` -> the lowering ``attend`` runs.

    ``"gather"`` and ``"cuda"`` pass through; ``"auto"`` is ``"cuda"``
    for a CUDA device and ``"gather"`` on the CPU.  No compile probe, no
    environment switch and no exception handler: a kernel that does not
    build or launch fails the run instead of quietly serving through
    the other path."""
    if choice not in KERNELS:
        raise ValueError(f"serve kernel must be auto|gather|cuda, "
                         f"got {choice!r}")
    if choice != "auto":
        return choice
    return "cuda" if torch.device(device).type == "cuda" else "gather"
