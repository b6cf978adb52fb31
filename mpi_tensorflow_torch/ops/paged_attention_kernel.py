"""Paged attention read in place from the pool — the CUDA kernel's
wrapper and its plain PyTorch twin.

Counterpart of ``mpi_tensorflow_tpu/ops/paged_attention_kernel.py``
(the Pallas ``_paged_kernel``, mode ``"fp32"``).  Three things live
here:

- ``paged_attention_kernel`` — the wrapper.  On a CUDA tensor it
  launches the hand-written kernel of ``csrc/paged_attention.cu`` (built
  by ``ops/_build.py`` at first use) or raises; on a CPU tensor it runs
  the plain version.  ``paged_decode_attention`` (S = 1) and
  ``paged_prefill_attention`` (S = chunk) name the phase, as in the
  reference.
- ``paged_attention_reference`` — the plain version: the same blockwise
  float32 online softmax, written as a loop over each row's live
  blocks.  The CPU tests hold it against the Pallas kernel run with
  ``interpret=True``; ``chip_smoke.py`` holds the CUDA kernel against
  it on the card.
- ``paged_attention_kernel.launches`` — the number of kernel launches,
  raised by one at each launch and nowhere else, so a run can show that
  its main path went through the kernel.

Contract (the reference's): q (B, H, S, D) queries at absolute positions
``[lengths[b], lengths[b] + S)``, whose K/V are already in the pools;
pools (num_blocks, H, block_size, D) in q's dtype; block_table (B, NB)
int32 with null-block (0) padding past a row's allocation; lengths (B,)
int32.  A key at position ``col`` is visible iff ``col <= lengths[b] +
s``; only the first ``nlive = clamp(ceil((len + S) / bs), 1, NB)``
blocks of a row are read.  Bucket-slack rows (all-null table, length 0)
give garbage the engine discards.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# kernel limits (csrc/paged_attention.cu: registers hold <= 128 lanes of
# D; shared memory holds a bs x D block of K and of V, <= 148 KB here)
MAX_HEAD_DIM = 128
MAX_BLOCK_SIZE = 128


def _nlive(length: int, S: int, bs: int, NB: int) -> int:
    """Live block count of a row: lanes up to ``length + S`` hold real
    cache entries, everything past them is null-block padding."""
    return min(max(-(-(length + S) // bs), 1), NB)


def paged_attention_reference(q, k_pool, v_pool, block_table, lengths, *,
                              scale=None):
    """The kernel's plain PyTorch version: per row, an online softmax
    over its live blocks with float32 statistics, scores accumulated in
    float32, probabilities rounded to the pool's dtype before the
    P @ V product (summed in float32), output ``acc / (l or 1)`` in q's
    dtype.  Runs on any device; one host read each of ``lengths`` and
    ``block_table``."""
    B, H, S, D = q.shape
    bs = k_pool.shape[2]
    NB = block_table.shape[1]
    scale = D ** -0.5 if scale is None else scale
    f32 = torch.float32
    neg = torch.finfo(f32).min
    out = torch.empty_like(q)
    lens = lengths.tolist()
    table = block_table.tolist()
    for b in range(B):
        qb = q[b].to(f32)                                   # (H, S, D)
        m = torch.full((H, S, 1), neg, dtype=f32, device=q.device)
        l = torch.zeros((H, S, 1), dtype=f32, device=q.device)
        acc = torch.zeros((H, S, D), dtype=f32, device=q.device)
        qpos = lens[b] + torch.arange(S, device=q.device)[:, None]  # (S, 1)
        for j in range(_nlive(lens[b], S, bs, NB)):
            blk = table[b][j]
            k = k_pool[blk].to(f32)                         # (H, bs, D)
            v = v_pool[blk]
            s = qb @ k.transpose(1, 2)                      # (H, S, bs)
            col = j * bs + torch.arange(bs, device=q.device)[None, :]
            s = torch.where(col <= qpos, s * scale, neg)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(v.dtype).to(f32) @ v.to(f32)
            m = m_new
        out[b] = (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
    return out


def _check(q, k_pool, v_pool, block_table, lengths):
    """Raise on anything the kernel does not take."""
    if k_pool.dtype in (torch.int8, torch.uint8) \
            or v_pool.dtype in (torch.int8, torch.uint8):
        raise NotImplementedError(
            "quantized KV pools (int8 row scales, int4 group scales) are "
            "not ported yet: ROADMAP Queue 2 item 4(b)/(c)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"pools must share q's dtype {q.dtype}, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"block_table and lengths must be int32, got "
                         f"{block_table.dtype}/{lengths.dtype}")
    devs = {t.device for t in (q, k_pool, v_pool, block_table, lengths)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")
    if q.ndim != 4 or k_pool.ndim != 4 or block_table.ndim != 2 \
            or lengths.ndim != 1:
        raise ValueError("expected q (B,H,S,D), pools (N,H,bs,D), "
                         "block_table (B,NB), lengths (B,)")
    B, H, S, D = q.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[1] != H \
            or k_pool.shape[3] != D or block_table.shape[0] != B \
            or lengths.shape[0] != B or min(B, H, S, D) < 1 \
            or block_table.shape[1] < 1:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(block_table.shape)}, lengths {tuple(lengths.shape)}")
    if D > MAX_HEAD_DIM or k_pool.shape[2] > MAX_BLOCK_SIZE:
        raise ValueError(f"kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"block_size <= {MAX_BLOCK_SIZE}, got D={D}, "
                         f"bs={k_pool.shape[2]}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _entry():
    """The C entry point ``paged_attention_fwd`` of the built library
    (built at first use), with its argument types declared once."""
    from mpi_tensorflow_torch.ops import _build

    fn = _build.load("paged_attention").paged_attention_fwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def paged_attention_kernel(q, k_pool, v_pool, block_table, lengths, *,
                           scale=None):
    """Paged attention over pool blocks read in place — no gathered view.

    CPU tensors run ``paged_attention_reference``; CUDA tensors launch
    the CUDA kernel on the current stream (output from ``torch.empty``,
    no synchronisation) and raise if the launch is refused.  Returns
    (B, H, S, D) in q's dtype."""
    _check(q, k_pool, v_pool, block_table, lengths)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_table,
                                         lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for {q.device}")
    fn = _entry()
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                 v_pool.data_ptr(), block_table.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, H, S, D,
                 k_pool.shape[2], block_table.shape[1], float(scale),
                 stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError_t {err}")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths, *,
                           scale=None):
    """Single-token decode (S must be 1) — the serving hot path."""
    if q.shape[2] != 1:
        raise ValueError(f"decode takes one query token per row, got "
                         f"S={q.shape[2]} (use paged_prefill_attention)")
    return paged_attention_kernel(q, k_pool, v_pool, block_table, lengths,
                                  scale=scale)


def paged_prefill_attention(q, k_pool, v_pool, block_table, lengths, *,
                            scale=None):
    """Chunked prefill: S queries per row at positions [lengths[b],
    lengths[b] + S), causal within the chunk and over the cache."""
    return paged_attention_kernel(q, k_pool, v_pool, block_table, lengths,
                                  scale=scale)
