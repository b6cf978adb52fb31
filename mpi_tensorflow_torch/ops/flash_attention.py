"""Flash attention — the CUDA kernels' wrappers, their plain PyTorch
versions, and the autograd function the model calls.

Counterpart of ``mpi_tensorflow_tpu/ops/flash_attention.py`` (the Pallas
``_flash_fwd_kernel``, ``_flash_dq_kernel`` and ``_flash_dkdv_kernel``
behind the ``custom_vjp`` ``flash_attention``).  Here:

- ``flash_attention(q, k, v, causal=False, scale=None)`` — exact
  attention over q, k, v (B, H, S, D) as a ``torch.autograd.Function``:
  the forward saves ``(q, k, v, out, lse)``; the backward computes
  ``delta = rowsum(dO * O)`` in float32 (outside the kernels, as the
  reference leaves it to XLA) and runs the dq and dk/dv kernels.
- ``flash_fwd``, ``flash_dq``, ``flash_dkdv`` — one wrapper per kernel of
  ``csrc/flash_attention.cu`` (built by ``ops/_build.py`` at first use).
  On a CUDA tensor each launches its kernel on the current stream or
  raises; on a CPU tensor it runs the plain version.  Each has a
  ``launches`` count, raised by one at a launch and nowhere else.  Under
  a CUDA graph capture the launch is recorded on the capture stream
  (``_launch`` takes the current stream): ``train/graphs.py`` puts the
  count back after a capture, which launches nothing, and raises it by
  the launches the graph holds at each replay.
- ``flash_forward_reference``, ``flash_backward_reference`` — the plain
  versions, with the kernels' rounding points: scores, softmax
  statistics and ``ds`` in float32, ``p`` rounded to v's (dO's) dtype
  before P.V (dV).  The CPU tests hold them against the Pallas kernels
  run with ``interpret=True``; ``chip_smoke.py`` holds the kernels
  against them on the card.

The kernels take float32 and bfloat16, head_dim <= 128 and any S >= 1
(bounds-checked, not padded).  ``lse`` is (B, H, S) float32 — the
reference's lane-broadcast copies of it are a TPU layout artifact.
There is no probe and no switch: the reference's ``kernel_supported``
quietly fell back to XLA; a failure here raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128      # csrc/flash_attention.cu: kMaxD
MAX_BATCH_HEADS = 65535  # B*H is the grid's y dimension
NEG_BIG = -1e30         # the reference's masked score


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _scores(q, k, scale, causal):
    """float32 scores ``scale * q k^T`` (B, H, S, S) and the visibility
    mask (None when every key is visible)."""
    f32 = torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), k.to(f32)) * scale
    if not causal:
        return s, None
    S = q.shape[2]
    pos = torch.arange(S, device=q.device)
    return s, pos[None, :] <= pos[:, None]


def flash_forward_reference(q, k, v, *, causal=False, scale=None):
    """Plain forward: ``(out, lse)``, out in q's dtype, lse (B, H, S)
    float32.  The softmax is taken over the whole row at once; the
    kernel's online softmax gives the same sums in another order."""
    f32 = torch.float32
    s, vis = _scores(q, k, _scale(q, scale), causal)
    if vis is not None:
        s = torch.where(vis, s, NEG_BIG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    acc = p.to(v.dtype).to(f32) @ v.to(f32)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_backward_reference(q, k, v, do, lse, delta, *, causal=False,
                             scale=None):
    """Plain backward: ``(dq, dk, dv)`` from the saved ``lse`` and
    ``delta = rowsum(dO * O)`` (both (B, H, S) float32)."""
    f32 = torch.float32
    scale = _scale(q, scale)
    s, vis = _scores(q, k, scale, causal)
    p = torch.exp(s - lse[..., None])
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(f32), v.to(f32))
    ds = p * (dp - delta[..., None]) * scale
    dq = ds @ k.to(f32)
    dk = ds.transpose(-1, -2) @ q.to(f32)
    dv = p.to(do.dtype).to(f32).transpose(-1, -2) @ do.to(f32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(*tensors, stats=()):
    """Raise on anything the kernels do not take: ``tensors`` are
    (B, H, S, D) of one dtype, ``stats`` (B, H, S) float32."""
    q = tensors[0]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.ndim != 4:
        raise ValueError(f"expected (B, H, S, D), got {tuple(q.shape)}")
    B, H, S, D = q.shape
    if min(B, H, S, D) < 1 or D > MAX_HEAD_DIM or B * H > MAX_BATCH_HEADS:
        raise ValueError(f"kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"B*H <= {MAX_BATCH_HEADS}, got {tuple(q.shape)}")
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"operands must share q's shape and dtype "
                             f"{tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in stats:
        if t.shape != (B, H, S) or t.dtype != torch.float32:
            raise ValueError(f"lse/delta must be (B, H, S) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    devs = {t.device for t in (*tensors, *stats)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")
    if not all(t.is_contiguous() for t in (*tensors, *stats)):
        raise ValueError("flash attention operands must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention kernel for {q.device}")


@functools.cache
def _entries():
    """The C entry points of the built library (built at first use),
    with their argument types declared once."""
    from mpi_tensorflow_torch.ops import _build

    lib = _build.load("flash_attention")
    tail = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
    fns = {"fwd": (lib.flash_fwd, 5), "dq": (lib.flash_dq, 7),
           "dkdv": (lib.flash_dkdv, 8)}
    for fn, npointers in fns.values():
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * npointers + tail
        fn.restype = ctypes.c_int
    return {name: fn for name, (fn, _) in fns.items()}


def _launch(name, q, pointers, scale, causal):
    B, H, S, D = q.shape
    fn = _entries()[name]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], *[t.data_ptr() for t in pointers],
                 B * H, S, D, scale, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_{name} kernel launch failed: "
                           f"cudaError_t {err}")


def flash_fwd(q, k, v, *, causal=False, scale=None):
    """Forward kernel: ``(out, lse)`` for contiguous q, k, v."""
    _check(q, k, v)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal=causal, scale=scale)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("fwd", q, (q, k, v, out, lse), scale, causal)
    flash_fwd.launches += 1
    return out, lse


def flash_dq(q, k, v, do, lse, delta, *, causal=False, scale=None):
    """dq kernel, streamed over the key tiles."""
    _check(q, k, v, do, stats=(lse, delta))
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, do, lse, delta,
                                        causal=causal, scale=scale)[0]
    dq = torch.empty_like(q)
    _launch("dq", q, (q, k, v, do, lse, delta, dq), scale, causal)
    flash_dq.launches += 1
    return dq


def flash_dkdv(q, k, v, do, lse, delta, *, causal=False, scale=None):
    """dk/dv kernel, streamed over the query tiles: ``(dk, dv)``."""
    _check(q, k, v, do, stats=(lse, delta))
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, do, lse, delta,
                                        causal=causal, scale=scale)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("dkdv", q, (q, k, v, do, lse, delta, dk, dv), scale, causal)
    flash_dkdv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkdv.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.to(torch.float32) * out.to(torch.float32)).sum(-1)
        kw = {"causal": ctx.causal, "scale": ctx.scale}
        dq = flash_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_dkdv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """Exact attention over q, k, v (B, H, S, D), differentiable, through
    the flash kernels (their plain versions for CPU tensors).  Returns
    (B, H, S, D) in q's dtype."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal),
                                 _scale(q, scale))
