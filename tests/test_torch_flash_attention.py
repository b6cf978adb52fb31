"""The port's flash attention against the reference's Pallas kernels.

The reference's ``flash_attention`` (forward ``_flash_fwd_kernel``,
backward ``_flash_dq_kernel`` + ``_flash_dkdv_kernel``) runs in
interpret mode on the CPU, with 32-wide blocks at S = 64 and 64-wide
ones at S = 100, so both walk a 2 x 2 grid of blocks, the second padded
and masked at S = 100.  On the port's side the same
numpy inputs go through the plain versions (``flash_forward_reference``,
``flash_backward_reference``) and through the ``torch.autograd.Function``
on CPU tensors, which the kernel wrappers route to those plain versions.

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
