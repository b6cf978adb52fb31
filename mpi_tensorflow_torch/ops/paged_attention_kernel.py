"""Paged attention read in place from the pool — the CUDA kernel's
wrapper and its plain PyTorch twin.

Counterpart of ``mpi_tensorflow_tpu/ops/paged_attention_kernel.py``
(the Pallas ``_paged_kernel``) in its three pool modes, chosen as there
by the scales' rank:

- ``fp32``: the pools in q's dtype (no scales);
- ``int8``: int8 code pools with (N, H, bs) float32 row scales;
- ``int4``: uint8 pools of packed nibbles (N, H, bs, D/2) with (N, H,
  bs, G) float32 group scales, optionally with the KIVI residual lane
  (``k_new``/``v_new``, the step's own K/V in q's dtype).

Three things live here:

- ``paged_attention_kernel`` — the wrapper.  On a CUDA tensor it
  launches the hand-written kernel of ``csrc/paged_attention.cu`` (built
  by ``ops/_build.py`` at first use) or raises; on a CPU tensor it runs
  the plain version.  ``paged_decode_attention`` (S = 1) and
  ``paged_prefill_attention`` (S = chunk) name the phase, as in the
  reference.
- ``paged_attention_reference`` — the plain version: the same blockwise
  float32 online softmax, written as a loop over each row's live
  blocks, dequantizing each block to q's dtype as the kernel does.  The
  CPU tests hold it against the Pallas kernel run with
  ``interpret=True``; ``chip_smoke.py`` holds the CUDA kernel against
  it on the card.
- ``paged_attention_kernel.launches`` — the number of kernel launches
  (every mode), raised by one at each launch and nowhere else (under a
  lock: the replica router's threads launch it concurrently), so a run
  can show that its main path went through the kernel.

Contract (the reference's): q (B, H, S, D) queries at absolute positions
``[lengths[b], lengths[b] + S)``, whose K/V are already in the pools;
block_table (B, NB) int32 with null-block (0) padding past a row's
allocation; lengths (B,) int32.  A key at position ``col`` is visible
iff ``col <= lengths[b] + s``; only the first ``nlive = clamp(ceil((len
+ S) / bs), 1, NB)`` blocks of a row are read.  Bucket-slack rows
(all-null table, length 0) give garbage the engine discards.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from mpi_tensorflow_torch.ops.paged_attention import (check_quant_args,
                                                      dequantize_kv,
                                                      dequantize_kv_int4)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# kernel limits (csrc/paged_attention.cu: a thread holds at most 4 of a
# tile's <= 8 x 128 (query, dim) pairs; shared memory holds at least one
# bs x D block of K and of V, <= 144 KB at float32, D = 128, bs = 128)
MAX_HEAD_DIM = 128
MAX_BLOCK_SIZE = 128
#: pool modes, numbered as the C entry point takes them
MODES = {"fp32": 0, "int8": 1, "int4": 2}


def _nlive(length: int, S: int, bs: int, NB: int) -> int:
    """Live block count of a row: lanes up to ``length + S`` hold real
    cache entries, everything past them is null-block padding."""
    return min(max(-(-(length + S) // bs), 1), NB)


def pool_mode(k_scale) -> str:
    """The pool mode the scales name: none -> ``fp32``, 3-d row scales
    -> ``int8``, 4-d group scales -> ``int4`` (the reference's rule)."""
    if k_scale is None:
        return "fp32"
    return "int4" if k_scale.ndim == 4 else "int8"


def paged_attention_reference(q, k_pool, v_pool, block_table, lengths, *,
                              scale=None, k_scale=None, v_scale=None,
                              k_new=None, v_new=None):
    """The kernel's plain PyTorch version: per row, an online softmax
    over its live blocks with float32 statistics, scores accumulated in
    float32, probabilities rounded to q's dtype before the P @ V product
    (summed in float32), output ``acc / (l or 1)`` in q's dtype.
    Quantized blocks are dequantized to q's dtype first.  With the
    residual lane, each query's own column scores the float32 ``q .
    k_new`` (replacing the pool score before scale and mask), keeps its
    weight in ``l``, and adds ``p * v_new`` in float32, unrounded — as
    the Pallas kernel does.  Runs on any device; one host read each of
    ``lengths`` and ``block_table``."""
    B, H, S, D = q.shape
    bs = k_pool.shape[2]
    NB = block_table.shape[1]
    scale = D ** -0.5 if scale is None else scale
    mode = pool_mode(k_scale)
    f32 = torch.float32
    neg = torch.finfo(f32).min
    out = torch.empty_like(q)
    lens = lengths.tolist()
    table = block_table.tolist()

    def block(pool, pool_scale, blk):
        if mode == "int8":
            return dequantize_kv(pool[blk], pool_scale[blk], q.dtype)
        if mode == "int4":
            return dequantize_kv_int4(pool[blk], pool_scale[blk], q.dtype)
        return pool[blk]

    for b in range(B):
        qb = q[b].to(f32)                                   # (H, S, D)
        m = torch.full((H, S, 1), neg, dtype=f32, device=q.device)
        l = torch.zeros((H, S, 1), dtype=f32, device=q.device)
        acc = torch.zeros((H, S, D), dtype=f32, device=q.device)
        qpos = lens[b] + torch.arange(S, device=q.device)[:, None]  # (S, 1)
        if k_new is not None:
            s_self = (qb * k_new[b].to(f32)).sum(-1)[..., None]  # (H, S, 1)
        for j in range(_nlive(lens[b], S, bs, NB)):
            blk = table[b][j]
            k = block(k_pool, k_scale, blk).to(f32)         # (H, bs, D)
            v = block(v_pool, v_scale, blk)
            s = qb @ k.transpose(1, 2)                      # (H, S, bs)
            col = j * bs + torch.arange(bs, device=q.device)[None, :]
            if k_new is not None:
                self_m = col == qpos                        # (S, bs)
                s = torch.where(self_m, s_self, s)
            s = torch.where(col <= qpos, s * scale, neg)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            if k_new is not None:
                p_self = torch.where(self_m, p, 0.0).sum(-1, keepdim=True)
                p = torch.where(self_m, 0.0, p)
                acc = (acc * corr + p.to(q.dtype).to(f32) @ v.to(f32)
                       + p_self * v_new[b].to(f32))
            else:
                acc = acc * corr + p.to(q.dtype).to(f32) @ v.to(f32)
            m = m_new
        out[b] = (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
    return out


def _check(q, k_pool, v_pool, block_table, lengths, k_scale, v_scale,
           k_new, v_new) -> str:
    """Raise on anything the kernel does not take; return the mode."""
    check_quant_args(k_scale, v_scale, k_new, v_new)
    mode = pool_mode(k_scale)
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    pool_dtype = {"fp32": q.dtype, "int8": torch.int8,
                  "int4": torch.uint8}[mode]
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise ValueError(f"{mode} pools must have dtype {pool_dtype}, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"block_table and lengths must be int32, got "
                         f"{block_table.dtype}/{lengths.dtype}")
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("block_table", block_table), ("lengths", lengths)]
    named += [(n, t) for n, t in (("k_scale", k_scale), ("v_scale", v_scale),
                                  ("k_new", k_new), ("v_new", v_new))
              if t is not None]
    devs = {t.device for _, t in named}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")
    if q.ndim != 4 or k_pool.ndim != 4 or block_table.ndim != 2 \
            or lengths.ndim != 1:
        raise ValueError("expected q (B,H,S,D), pools (N,H,bs,D), "
                         "block_table (B,NB), lengths (B,)")
    B, H, S, D = q.shape
    N, bs = k_pool.shape[0], k_pool.shape[2]
    row = D // 2 if mode == "int4" else D
    if k_pool.shape != v_pool.shape or k_pool.shape[1] != H \
            or k_pool.shape[3] != row or (mode == "int4" and D % 2) \
            or block_table.shape[0] != B \
            or lengths.shape[0] != B or min(B, H, S, D) < 1 \
            or block_table.shape[1] < 1:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(block_table.shape)}, lengths {tuple(lengths.shape)}")
    if mode != "fp32":
        G = k_scale.shape[-1] if mode == "int4" else None
        want = (N, H, bs) if mode == "int8" else (N, H, bs, G)
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or tuple(k_scale.shape) != want \
                or tuple(v_scale.shape) != want \
                or (mode == "int4" and (G < 1 or D % G)):
            raise ValueError(
                f"{mode} scales must be float32 {want} with G dividing "
                f"D={D}, got {k_scale.dtype} {tuple(k_scale.shape)} / "
                f"{v_scale.dtype} {tuple(v_scale.shape)}")
    if k_new is not None:
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if t.dtype != q.dtype or t.shape != q.shape:
                raise ValueError(f"{name} must match q's {q.dtype} "
                                 f"{tuple(q.shape)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
    if D > MAX_HEAD_DIM or bs > MAX_BLOCK_SIZE:
        raise ValueError(f"kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"block_size <= {MAX_BLOCK_SIZE}, got D={D}, "
                         f"bs={bs}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return mode


@functools.cache
def _entry():
    """The C entry point ``paged_attention_fwd`` of the built library
    (built at first use), with its argument types declared once."""
    from mpi_tensorflow_torch.ops import _build

    fn = _build.load("paged_attention").paged_attention_fwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def paged_attention_kernel(q, k_pool, v_pool, block_table, lengths, *,
                           scale=None, k_scale=None, v_scale=None,
                           k_new=None, v_new=None):
    """Paged attention over pool blocks read in place — no gathered view.

    CPU tensors run ``paged_attention_reference``; CUDA tensors launch
    the CUDA kernel on the current stream (output from ``torch.empty``,
    no synchronisation) and raise if the launch is refused.  Returns
    (B, H, S, D) in q's dtype."""
    mode = _check(q, k_pool, v_pool, block_table, lengths, k_scale,
                  v_scale, k_new, v_new)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, block_table, lengths, scale=scale,
            k_scale=k_scale, v_scale=v_scale, k_new=k_new, v_new=v_new)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for {q.device}")
    fn = _entry()
    B, H, S, D = q.shape
    G = k_scale.shape[-1] if mode == "int4" else 1
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], MODES[mode], q.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
                 _ptr(v_scale), _ptr(k_new), _ptr(v_new),
                 block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 B, H, S, D, k_pool.shape[2], block_table.shape[1], G,
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError_t {err}")
    with _COUNT_LOCK:
        paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
_COUNT_LOCK = threading.Lock()


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths,
                           **kw):
    """Single-token decode (S must be 1) — the serving hot path.
    Keywords as ``paged_attention_kernel``."""
    if q.shape[2] != 1:
        raise ValueError(f"decode takes one query token per row, got "
                         f"S={q.shape[2]} (use paged_prefill_attention)")
    return paged_attention_kernel(q, k_pool, v_pool, block_table, lengths,
                                  **kw)


def paged_prefill_attention(q, k_pool, v_pool, block_table, lengths,
                            **kw):
    """Chunked prefill: S queries per row at positions [lengths[b],
    lengths[b] + S), causal within the chunk and over the cache.
    Keywords as ``paged_attention_kernel``."""
    return paged_attention_kernel(q, k_pool, v_pool, block_table, lengths,
                                  **kw)
