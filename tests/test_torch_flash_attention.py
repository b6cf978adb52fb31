"""The port's flash attention against the reference's Pallas kernels.

The reference's ``flash_attention`` (forward ``_flash_fwd_kernel``,
backward ``_flash_dq_kernel`` + ``_flash_dkdv_kernel``) runs in
interpret mode on the CPU, with 32-wide blocks at S = 64 and 64-wide
ones at S = 100, so both walk a 2 x 2 grid of blocks, the second padded
and masked at S = 100.  On the port's side the same
numpy inputs go through the plain versions (``flash_forward_reference``,
``flash_backward_reference``) and through the ``torch.autograd.Function``
on CPU tensors, which the kernel wrappers route to those plain versions.

``test_split_ds_emulation_keeps_the_rounding_points`` emulates the bf16
backward kernels' arithmetic (ds split into bf16 hi + lo for the tensor
cores) on the same cases and holds it against the plain version and the
Pallas kernels.

Tolerances (absolute): float32 outputs and lse 2e-5, gradients 2e-4 —
the same sums taken blockwise on one side and whole-row on the other;
bfloat16 3e-2 — both sides round p to bf16 before P.V and dV, but
relative to a running max on the reference's side (online softmax) and
to the row max on the plain side, and round every output to bf16
(2^-8 relative at magnitudes ~1-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tensorflow_tpu.ops import flash_attention as jax_fa
from mpi_tensorflow_torch.ops import flash_attention as fa

B, H, D = 1, 2, 16
BLOCK = {64: 32, 100: 64}
CASES = [(S, causal, dtype) for S in (64, 100) for causal in (False, True)
         for dtype in ("float32", "bfloat16")]
IDS = [f"S{S}-{'causal' if c else 'full'}-{d}" for S, c, d in CASES]
TOL = {"float32": (2e-5, 2e-4), "bfloat16": (3e-2, 3e-2)}


# XLA's optimisation passes only slow the compile of the interpreted
# kernels here; the arithmetic is the same without them
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _inputs(S, causal):
    rng = np.random.default_rng(S + 7 * causal)
    return [rng.normal(size=(B, H, S, D)).astype(np.float32)
            for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's out, lse and (dq, dk, dv) of every case, as
    float32 numpy arrays: the ``custom_vjp``'s own forward and backward
    rules, all cases under one compile (a compile per case costs twice
    as long)."""
    args = [jnp.asarray(a).astype(jnp.dtype(dtype))
            for S, causal, dtype in CASES for a in _inputs(S, causal)]

    def run(*flat):
        res = []
        for i, (S, causal, _) in enumerate(CASES):
            q, k, v, g = flat[4 * i:4 * i + 4]
            blk = BLOCK[S]
            out, saved = jax_fa._fwd(q, k, v, causal, None, blk, blk, True)
            grads = jax_fa._bwd(causal, None, blk, blk, True, saved, g)
            res.append((out, saved[4][:, :, :S], grads))
        return res

    res = jax.jit(run).lower(*args).compile(FAST_COMPILE)(*args)
    as_np = lambda a: np.asarray(a.astype(jnp.float32))
    return {case: (as_np(o), as_np(l), [as_np(a) for a in g])
            for case, (o, l, g) in zip(CASES, res)}


def _case(S, causal, dtype):
    """numpy inputs (q, k, v, cotangent) and the reference's results."""
    return (_inputs(S, causal), *_reference()[(S, causal, dtype)])


def _torch(x, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in x]


def _close(got, want, atol, what):
    got = got.to(torch.float32).numpy()
    assert np.all(np.isfinite(got)), what
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("S,causal,dtype", CASES, ids=IDS)
def test_forward_reference_matches_pallas(S, causal, dtype):
    x, out, lse, _ = _case(S, causal, dtype)
    q, k, v, _ = _torch(x, dtype)
    got, got_lse = fa.flash_forward_reference(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got_lse.dtype == torch.float32
    assert got_lse.shape == (B, H, S)
    _close(got, out, TOL[dtype][0], "out")
    _close(got_lse, lse, TOL["float32"][0], "lse")


@pytest.mark.parametrize("S,causal,dtype", CASES, ids=IDS)
def test_backward_reference_matches_pallas(S, causal, dtype):
    x, _, _, grads = _case(S, causal, dtype)
    q, k, v, g = _torch(x, dtype)
    out, lse = fa.flash_forward_reference(q, k, v, causal=causal)
    delta = (g.float() * out.float()).sum(-1)
    got = fa.flash_backward_reference(q, k, v, g, lse, delta, causal=causal)
    for name, a, want in zip(("dq", "dk", "dv"), got, grads):
        assert a.dtype == q.dtype
        _close(a, want, TOL[dtype][1], name)


@pytest.mark.parametrize("S,causal,dtype", CASES, ids=IDS)
def test_autograd_function_matches_pallas(S, causal, dtype):
    """``flash_attention`` on CPU tensors: the wrappers' plain path,
    forward and backward, with the launch counts untouched."""
    x, out, _, grads = _case(S, causal, dtype)
    q, k, v, g = _torch(x, dtype)
    for t in (q, k, v):
        t.requires_grad_(True)
    before = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkdv.launches)
    o = fa.flash_attention(q, k, v, causal)
    _close(o.detach(), out, TOL[dtype][0], "out")
    got = torch.autograd.grad(o, (q, k, v), g)
    for name, a, want in zip(("dq", "dk", "dv"), got, grads):
        _close(a, want, TOL[dtype][1], name)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkdv.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 1, 8, 192)
        fa.flash_fwd(z, z, z)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 8, 2, 16).transpose(1, 2)
        fa.flash_fwd(t, t, t)
    with pytest.raises(ValueError, match="lse/delta"):
        fa.flash_dq(q, q, q, q, torch.zeros(1, 1, 8, dtype=torch.float64),
                    torch.zeros(1, 1, 8))


BF16_CASES = [c for c in CASES if c[2] == "bfloat16"]


def _split_ds_backward(q, k, v, do, lse, delta, causal):
    """The bfloat16 backward kernels' arithmetic (``flash_dq_kernel_tc``,
    ``flash_dkdv_kernel_tc``), emulated: bf16 operands, float32 scores,
    p, dp and ds, p rounded to bf16 for dV, and ds split into bf16 hi =
    bf16(ds) and lo = bf16(ds - hi), each half a product of bf16
    operands summed in float32, as the tensor cores sum them."""
    f32, bf16 = torch.float32, torch.bfloat16
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), k.to(f32)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        S = q.shape[2]
        pos = torch.arange(S)
        p = torch.where(pos[None, :] <= pos[:, None], p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(f32), v.to(f32))
    ds = p * (dp - delta[..., None]) * scale
    hi = ds.to(bf16).to(f32)
    lo = (ds - hi).to(bf16).to(f32)
    kf, qf = k.to(f32), q.to(f32)
    dq = hi @ kf + lo @ kf
    dk = hi.transpose(-1, -2) @ qf + lo.transpose(-1, -2) @ qf
    dv = p.to(bf16).to(f32).transpose(-1, -2) @ do.to(f32)
    return dq.to(bf16), dk.to(bf16), dv.to(bf16)


@pytest.mark.parametrize("S,causal,dtype", BF16_CASES,
                         ids=[i for i, c in zip(IDS, CASES)
                              if c[2] == "bfloat16"])
def test_split_ds_emulation_keeps_the_rounding_points(S, causal, dtype):
    """The split keeps ds float32 to ~2^-16: against the plain version
    (ds unrounded) each output differs by at most one bf16 ulp of its
    magnitude (the final rounding may fall either side) plus 1e-5; against
    the Pallas kernels, within the file's bfloat16 tolerance."""
    x, _, _, grads = _case(S, causal, dtype)
    q, k, v, g = _torch(x, dtype)
    out, lse = fa.flash_forward_reference(q, k, v, causal=causal)
    delta = (g.float() * out.float()).sum(-1)
    got = _split_ds_backward(q, k, v, g, lse, delta, causal)
    plain = fa.flash_backward_reference(q, k, v, g, lse, delta,
                                        causal=causal)
    for name, a, want, pallas in zip(("dq", "dk", "dv"), got, plain, grads):
        a, want = a.float(), want.float()
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs())) - 7)
        excess = (a - want).abs() - (ulp + 1e-5)
        assert float(excess.max()) <= 0, (
            f"{name}: {int((excess > 0).sum())} elements past one bf16 ulp")
        _close(a, pallas, TOL[dtype][1], name)
