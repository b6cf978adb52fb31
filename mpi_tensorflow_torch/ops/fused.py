"""Row LayerNorm and online logsumexp — the CUDA kernels' wrappers, their
plain PyTorch versions, and the autograd functions around them.

Counterpart of ``mpi_tensorflow_tpu/ops/fused.py`` (the Pallas
``_ln_kernel`` behind the ``custom_vjp`` ``layer_norm``, and
``_lse_kernel`` behind ``online_logsumexp`` and the ``custom_vjp``
``softmax_cross_entropy``).  As in the JAX package, no model path calls
these: its models keep the compiler's fused LayerNorm and logsumexp, and
the port's keep PyTorch's.  Here:

- ``layer_norm_forward(x, scale, bias, eps)`` and ``online_logsumexp(x)``
  — one wrapper per kernel of ``csrc/fused.cu`` (built by
  ``ops/_build.py`` at first use).  On a CUDA tensor each launches its
  kernel on the current stream or raises; on a CPU tensor it runs the
  plain version.  Each has a ``launches`` count, raised by one at a
  launch and nowhere else.
- ``layer_norm_route(x, scale, bias)`` — which of the LayerNorm's two
  kernels a launch on these operands takes (the C entry point decides by
  shape and alignment alone): ``"rows"``, one warp per row with the row
  in registers, or ``"block"``, one CTA per row, the general path.
- ``layer_norm_reference``, ``logsumexp_reference`` — the plain versions:
  float32 statistics (population variance of the centred row), the
  LayerNorm written back in x's dtype, the logsumexp as float32.
- ``layer_norm(x, scale, bias, eps=1e-12)`` — a ``torch.autograd.Function``
  whose forward is the kernel and whose backward is the closed form, by
  autograd through the plain version (the reference's ``_ln_bwd``).
- ``softmax_cross_entropy(logits, labels)`` — per-position ``lse - gold``
  with the logsumexp kernel; its backward is ``(softmax - onehot) * g``
  in plain tensor ops, as the reference left it to XLA.

Both kernels take float32 and bfloat16 rows of any length and any number
of leading dimensions (bounds-checked, not padded).
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_reference(x, scale, bias, eps: float = 1e-12):
    """The LayerNorm kernel's plain version over the last axis: float32
    mean and population variance of the centred row, ``xc * rsqrt(var +
    eps) * scale + bias``, returned in x's dtype."""
    f32 = torch.float32
    x32 = x.to(f32)
    xc = x32 - x32.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * scale.to(f32) + bias.to(f32)
    return y.to(x.dtype)


def logsumexp_reference(x):
    """The logsumexp kernel's plain version over the last axis, float32:
    ``m + log(sum(exp(x - m)))`` with ``m`` the row max (0 where the max
    is infinite, so an all ``-inf`` row gives ``-inf``)."""
    x32 = x.to(torch.float32)
    m = x32.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    return (torch.log(torch.exp(x32 - m).sum(-1, keepdim=True)) + m)[..., 0]


def _check(x, *vectors):
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError(f"x needs a non-empty last axis, got "
                         f"{tuple(x.shape)}")
    for v in vectors:
        if v.shape != x.shape[-1:]:
            raise ValueError(f"scale and bias must be ({x.shape[-1]},), got "
                             f"{tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"all operands must share one device, got "
                             f"{x.device} and {v.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused kernel for {x.device}")


@functools.cache
def _entries():
    """The C entry points of the built library (built at first use),
    with their argument types declared once."""
    from mpi_tensorflow_torch.ops import _build

    lib = _build.load("fused")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.layer_norm_fwd.argtypes = [i32, ptr, ptr, ptr, ptr, i32, i32,
                                   ctypes.c_float, ptr]
    lib.layer_norm_rows_vecs.argtypes = [i32, ptr, ptr, ptr, ptr, i32]
    lib.logsumexp_fwd.argtypes = [i32, ptr, ptr, i32, i32, ptr]
    for fn in (lib.layer_norm_fwd, lib.layer_norm_rows_vecs,
               lib.logsumexp_fwd):
        fn.restype = ctypes.c_int
    return lib


def _run(name, x, args):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(_entries(), name)(_DTYPE_CODES[x.dtype], *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def layer_norm_forward(x, scale, bias, eps: float = 1e-12):
    """LayerNorm kernel over the last axis of a contiguous ``x`` (any
    leading dims); ``scale`` and ``bias`` (F,) are taken as float32.
    Returns x's shape and dtype."""
    _check(x, scale, bias)
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    F = x.shape[-1]
    out = torch.empty_like(x)
    N = x.numel() // F
    if N == 0:
        return out
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    _run("layer_norm_fwd", x, (x.data_ptr(), scale.data_ptr(),
                               bias.data_ptr(), out.data_ptr(), N, F,
                               float(eps)))
    layer_norm_forward.launches += 1
    return out


def layer_norm_route(x, scale, bias) -> str:
    """The kernel ``layer_norm_forward(x, scale, bias)`` launches:
    ``"rows"`` (one warp per row; F a multiple of 16 bytes of x's dtype,
    at most 2048 bf16 or 1024 float32 values, x, scale, bias and the
    output 16-byte aligned) or ``"block"`` (every other call); ``"plain"``
    for a CPU tensor."""
    _check(x, scale, bias)
    if x.device.type == "cpu":
        return "plain"
    # the operands as layer_norm_forward passes them: float32 scale and
    # bias, and a fresh output
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    vecs = _entries().layer_norm_rows_vecs(
        _DTYPE_CODES[x.dtype], x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), x.shape[-1])
    return "rows" if vecs else "block"


def online_logsumexp(x):
    """logsumexp kernel over the last axis of a contiguous ``x`` (any
    leading dims), one read of each element.  Returns ``x.shape[:-1]``
    float32."""
    _check(x)
    if x.device.type == "cpu":
        return logsumexp_reference(x)
    V = x.shape[-1]
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    N = out.numel()
    if N == 0:
        return out
    _run("logsumexp_fwd", x, (x.data_ptr(), out.data_ptr(), N, V))
    online_logsumexp.launches += 1
    return out


layer_norm_forward.launches = 0
online_logsumexp.launches = 0


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return layer_norm_forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            y = layer_norm_reference(*xs, ctx.eps)
            grads = torch.autograd.grad(y, xs, g)
        return (*grads, None)


def layer_norm(x, scale, bias, eps: float = 1e-12):
    """Single-pass LayerNorm over the last axis, differentiable: the
    kernel forward (its plain version for CPU tensors), the closed-form
    backward."""
    return _LayerNorm.apply(x.contiguous(), scale, bias, float(eps))


class _SoftmaxCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        lse = online_logsumexp(logits)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - gold.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        p = torch.exp(logits.to(torch.float32) - lse[..., None])
        onehot = torch.nn.functional.one_hot(
            labels.long(), logits.shape[-1]).to(torch.float32)
        return ((p - onehot) * g[..., None]).to(logits.dtype), None


def softmax_cross_entropy(logits, labels):
    """Per-position sparse softmax cross-entropy ``lse - gold`` (float32,
    ``labels.shape``): ``logits`` (..., V) float, ``labels`` (...) int.
    The softmax is built only in the backward."""
    return _SoftmaxCrossEntropy.apply(logits.contiguous(), labels)
