"""Paged KV-cache ops: block-table scatter/gather and attention dispatch.

Counterpart of ``mpi_tensorflow_tpu/ops/paged_attention.py``: the pool
held in the model's compute dtype (``kv_dtype="fp32"``), and the
quantized pools of ``--serve-kv-dtype int8|int4`` — int8 codes with one
float32 scale per (block, head, slot) row, or int4 codes packed two per
byte with one float32 scale per group of ``g`` channels.  Quantization
has the reference's maths and rounding (``torch.round`` is
round-half-even, like ``jnp.round``), so the pools are byte-identical to
the JAX package's.

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
    vals = kv.permute(0, 2, 1, 3)                          # (B, S, H, D)
    # (B, S, 1) x (H,) x (B, S, 1) index -> (B, S, H) rows of D values
    pool.index_put_(_write_index(pool, block_table, positions, valid),
                    vals.to(pool.dtype))


def _write_index(pool, block_table, positions, valid):
    """The (block, head, slot) index ``write_kv`` and the quantized
    writes scatter through: ``(B, S, 1)`` blocks (invalid lanes -> the
    null block), ``(H,)`` heads, ``(B, S, 1)`` slots."""
    bs = pool.shape[2]
    nb = block_table.shape[1]
    blk_idx = torch.clamp(positions // bs, 0, nb - 1).to(torch.int64)
    blk = torch.gather(block_table.to(torch.int64), 1, blk_idx)   # (B, S)
    blk = torch.where(valid, blk, NULL_BLOCK)
    off = (positions % bs).to(torch.int64)
    heads = torch.arange(pool.shape[1], device=pool.device)
    return blk[..., None], heads, off[..., None]


def quantize_kv(kv):
    """Symmetric absmax int8 quantization, one scale per (B, H, S) row:
    ``scale = max|row| / 127`` (0.0 for an all-zero row), codes
    ``clip(round(x / scale), -127, 127)`` with round-half-even.  A row's
    codes depend on its own values only, so chunked prefill, decode and
    an eviction replay write the same bytes.  Returns ``(codes (B, H, S,
    D) int8, scales (B, H, S) float32)``."""
    x = kv.to(torch.float32)
    scale = x.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0.0, scale, 1.0)[..., None]
    codes = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return codes, scale


def write_kv_quant(pool, pool_scale, kv, block_table, positions,
                   valid) -> None:
    """``write_kv`` for the int8 pool, IN PLACE: quantize the rows
    (``quantize_kv``) and scatter codes into ``pool`` (num_blocks, H,
    bs, D) int8 and scales into ``pool_scale`` (num_blocks, H, bs)
    float32 through the same block/slot index."""
    idx = _write_index(pool, block_table, positions, valid)
    codes, scale = quantize_kv(kv)
    pool.index_put_(idx, codes.permute(0, 2, 1, 3))      # (B, S, H, D)
    pool_scale.index_put_(idx, scale.permute(0, 2, 1))   # (B, S, H)


def dequantize_kv(codes, scale, dt):
    """int8 -> ``dt``: ``(codes * scale)`` in float32, rounded to ``dt``
    (scale broadcast over the trailing D axis) — the kernel's in-register
    step too."""
    return (codes.to(torch.float32) * scale[..., None]).to(dt)


def pack_int4(codes):
    """(..., D) int codes in [-8, 7] -> (..., D/2) uint8, split-half:
    byte ``i`` holds code ``i`` in its low nibble and code ``i + D/2``
    in its high nibble."""
    D = codes.shape[-1]
    lo = codes[..., :D // 2] & 0xF
    hi = codes[..., D // 2:] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed):
    """Invert ``pack_int4``: (..., D/2) uint8 -> (..., D) int32 codes;
    nibbles above 7 sign-extend to negatives."""
    c = packed.to(torch.int32)
    codes = torch.cat([c & 0xF, (c >> 4) & 0xF], dim=-1)
    return torch.where(codes > 7, codes - 16, codes)


def quantize_kv_int4(kv, group: int):
    """Symmetric absmax int4 quantization with one scale per group of
    ``g = min(group, D)`` channels (``g`` must divide D): ``scale =
    max|group| / 7``, codes ``clip(round(x / scale), -7, 7)`` packed by
    ``pack_int4``.  Returns ``(packed (B, H, S, D/2) uint8, scales (B,
    H, S, D/g) float32)``; like ``quantize_kv``, write-granularity
    independent."""
    x = kv.to(torch.float32)
    D = x.shape[-1]
    g = min(group, D)
    xg = x.reshape(x.shape[:-1] + (D // g, g))
    scale = xg.abs().amax(dim=-1) / 7.0                   # (B, H, S, G)
    safe = torch.where(scale > 0.0, scale, 1.0)[..., None]
    codes = torch.clamp(torch.round(xg / safe), -7, 7).to(torch.int32)
    return pack_int4(codes.reshape(x.shape)), scale


def dequantize_kv_int4(packed, scale, dt):
    """int4 -> ``dt``: unpack, multiply each of the G groups by its
    float32 scale, round to ``dt``.  packed (..., D/2) uint8, scale
    (..., G)."""
    codes = unpack_int4(packed)
    D, G = codes.shape[-1], scale.shape[-1]
    x = codes.reshape(codes.shape[:-1] + (G, D // G)).to(torch.float32)
    return (x * scale[..., None]).reshape(codes.shape).to(dt)


def write_kv_quant_int4(pool, pool_scale, kv, block_table, positions,
                        valid) -> None:
    """``write_kv`` for the int4 pool, IN PLACE: packed codes into
    ``pool`` (num_blocks, H, bs, D/2) uint8 and group scales into
    ``pool_scale`` (num_blocks, H, bs, G) float32.  The group size comes
    from the pool geometry (``g = D // G``)."""
    idx = _write_index(pool, block_table, positions, valid)
    D = pool.shape[-1] * 2
    packed, scale = quantize_kv_int4(kv, D // pool_scale.shape[-1])
    pool.index_put_(idx, packed.permute(0, 2, 1, 3))     # (B, S, H, D/2)
    pool_scale.index_put_(idx, scale.permute(0, 2, 1, 3))  # (B, S, H, G)


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


def paged_attention_self_residual(q, ck, cv, q_positions, dt, k_new,
                                  v_new, scale=None):
    """``paged_attention`` with the KIVI fp-residual SELF lane: each
    query's own column (``col == q_position``) scores ``q . k_new`` and
    weighs ``v_new`` — the step's K/V before quantization — instead of
    the dequantized pool row.  The override replaces the score before
    scale and mask; the softmax denominator keeps the lane.  As the
    reference's gather path, the lane's weight is rounded to ``dt``
    before it multiplies ``v_new`` (the kernel keeps it in float32).

    ck, cv: the DEQUANTIZED gathered view; k_new, v_new: (B, H, S, D)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    L = ck.shape[2]
    col = torch.arange(L, device=q.device)
    vis = col[None, None, :] <= q_positions[:, :, None]          # (B, S, L)
    self_m = (col[None, None, :] == q_positions[:, :, None])[:, None]
    f32 = torch.float32
    s = torch.einsum("bhsd,bhld->bhsl", q, ck).to(f32)
    s_self = torch.einsum("bhsd,bhsd->bhs", q, k_new).to(f32)
    s = torch.where(self_m, s_self[..., None], s)
    s = torch.where(vis[:, None], s * scale, torch.finfo(f32).min)
    p = torch.softmax(s, dim=-1)
    p_self = torch.where(self_m, p, 0.0).sum(-1)                 # (B, H, S)
    p_main = torch.where(self_m, 0.0, p).to(dt)
    return (torch.einsum("bhsl,bhld->bhsd", p_main, cv)
            + p_self[..., None].to(dt) * v_new.to(dt))


def _gather_kv_dequant(pool, pool_scale, block_table, dt):
    """``gather_kv`` over a quantized pool: gather codes and scales
    through the table, dequantize (int8 row scales or int4 group scales,
    told apart by the scale rank), reassemble (B, H, L, D)."""
    idx = block_table.to(torch.int64)
    g, gs = pool[idx], pool_scale[idx]           # (B, NB, H, bs, .)
    g = (dequantize_kv_int4(g, gs, dt) if pool_scale.ndim == 4
         else dequantize_kv(g, gs, dt))
    B, NB, H, bs, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, H, NB * bs, D)


def check_quant_args(k_scale, v_scale, k_new, v_new) -> None:
    """The reference's rules for the quantized operands: scales both or
    neither, residual both or neither, and a residual only beside int4
    (4-d group) scales."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("quantized pools need both k_scale and v_scale")
    if (k_new is None) != (v_new is None):
        raise ValueError("fp residual needs both k_new and v_new")
    if k_new is not None and (k_scale is None or k_scale.ndim != 4):
        raise ValueError(
            "fp-residual k_new/v_new only apply to int4 (group-scaled) "
            "pools")


def attend(q, k_pool, v_pool, block_table, lengths, dt, *,
           kernel: str = "gather", k_scale=None, v_scale=None,
           k_new=None, v_new=None):
    """Attention of ``q`` (B, H, S, D) at positions ``[lengths[b],
    lengths[b] + S)`` over the paged cache; the queries' own K/V must
    already be in the pools (``write_kv`` runs first).  ``kernel`` is a
    RESOLVED choice, ``"gather"`` or ``"cuda"`` (see
    ``resolve_kernel``).  Rows may sit at different phases (one real
    decode lane beside a prefill chunk): visibility is per row.

    ``k_scale``/``v_scale``: float32 scales of quantized pools — 3-d
    (num_blocks, H, bs) row scales mean int8 codes, 4-d (num_blocks, H,
    bs, G) group scales mean int4 packed codes.  ``k_new``/``v_new``:
    (B, H, S, D) K/V of the query tokens, the int4 residual self lane.
    Both lowerings dequantize inside the consume path: no float pool is
    ever built."""
    check_quant_args(k_scale, v_scale, k_new, v_new)
    if kernel == "cuda":
        from mpi_tensorflow_torch.ops import paged_attention_kernel as pk

        fused = (pk.paged_decode_attention if q.shape[2] == 1
                 else pk.paged_prefill_attention)
        # the projection einsum may hand q (and the residual K/V) over as
        # strided views; the kernel reads dense (B, H, S, D)
        if k_new is not None:
            k_new, v_new = k_new.contiguous(), v_new.contiguous()
        return fused(q.contiguous(), k_pool, v_pool, block_table, lengths,
                     k_scale=k_scale, v_scale=v_scale, k_new=k_new,
                     v_new=v_new)
    if kernel != "gather":
        raise ValueError(
            f"unresolved paged-attention kernel {kernel!r}: callers "
            f"resolve 'auto' with resolve_kernel first")
    S = q.shape[2]
    pos = lengths[:, None] + torch.arange(S, dtype=torch.int32,
                                          device=q.device)
    if k_scale is not None:
        ck = _gather_kv_dequant(k_pool, k_scale, block_table, q.dtype)
        cv = _gather_kv_dequant(v_pool, v_scale, block_table, q.dtype)
    else:
        ck = gather_kv(k_pool, block_table)
        cv = gather_kv(v_pool, block_table)
    if k_new is not None:
        return paged_attention_self_residual(q, ck, cv, pos, dt, k_new,
                                             v_new)
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
