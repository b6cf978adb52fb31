"""The port's paged-attention ops against the JAX reference, on the CPU.

- the kernel wrapper on CPU tensors (its plain PyTorch version) against
  the Pallas kernel run with ``interpret=True`` — a decode case and an
  S=8 prefill case, each with a bucket-slack row and poisoned lanes
  (null block and everything past each row's length hold 1e30, so any
  masking drift explodes instead of shifting by epsilon);
- ``attend(kernel="gather")`` against ``attend(kernel="xla")``;
- ``write_kv`` pools byte-identical to the reference's;
- the dispatch and validation rules (no silent fallback).  The quantized
  modes have their own file, ``test_torch_kv_quant.py``.

Inputs come from ``numpy.random.default_rng`` and enter both frameworks
as the same arrays.  Tolerances: float32 1e-5 absolute (the two sides
sum the same products in different orders); bfloat16 1e-2 absolute plus
1e-2 relative (one bf16 rounding of the output, 2^-8 relative, plus
probabilities rounded to bf16 at slightly different float32 values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tensorflow_tpu.ops import paged_attention as jax_ops
from mpi_tensorflow_tpu.ops import paged_attention_kernel as jax_pk
from mpi_tensorflow_torch.ops import paged_attention as ops
from mpi_tensorflow_torch.ops import paged_attention_kernel as pk

POISON = 1e30


def _case(rng, B, NB, bs, S, H=2, D=8, poison=POISON):
    """Rows cycle through a full table, a ragged partial table with a
    null-block tail, and — as the last row when B > 2 — a bucket-slack
    row (all-null table, length 0).  Returns numpy arrays and the dead
    (slack) rows, whose output is garbage on both sides."""
    nblocks = 1 + B * NB
    k_pool = rng.normal(size=(nblocks, H, bs, D)).astype(np.float32)
    v_pool = rng.normal(size=(nblocks, H, bs, D)).astype(np.float32)
    bt = np.zeros((B, NB), np.int32)
    lengths = np.zeros((B,), np.int32)
    dead = []
    nxt = 1
    for b in range(B):
        if b == B - 1 and B > 2:
            dead.append(b)
            continue
        if b % 2 == 1:
            lengths[b] = int(rng.integers(0, max(1, (NB - 1) * bs - S + 1)))
        else:
            lengths[b] = NB * bs - S
        nb_live = max(1, -(-(lengths[b] + S) // bs))
        bt[b, :nb_live] = range(nxt, nxt + nb_live)
        nxt += nb_live
    k_pool[0] = v_pool[0] = poison
    for b in range(B):
        for j in range(NB):
            if bt[b, j] == 0:
                continue
            for o in range(bs):
                if j * bs + o >= lengths[b] + S:
                    k_pool[bt[b, j], :, o] = poison
                    v_pool[bt[b, j], :, o] = poison
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    return (q, k_pool, v_pool, bt, lengths), dead


def _torch(arrs, dtype=torch.float32):
    q, kp, vp, bt, lens = arrs
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
            torch.from_numpy(vp).to(dtype), torch.from_numpy(bt),
            torch.from_numpy(lens))


def _jax(arrs, dtype=jnp.float32):
    q, kp, vp, bt, lens = arrs
    return (jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
            jnp.asarray(vp, dtype), jnp.asarray(bt), jnp.asarray(lens))


def _live(x, dead):
    x = np.array(x, dtype=np.float32)
    x[list(dead)] = 0.0
    return x


CASES = {"decode": dict(B=4, NB=3, bs=4, S=1),
         "prefill_s8": dict(B=3, NB=4, bs=4, S=8)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_wrapper_matches_pallas_interpret(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    arrs, dead = _case(rng, **CASES[name])
    want = jax_pk.paged_attention_kernel(*_jax(arrs), interpret=True)
    before = pk.paged_attention_kernel.launches
    got = pk.paged_attention_kernel(*_torch(arrs))
    assert pk.paged_attention_kernel.launches == before, \
        "a CPU tensor must run the plain version, not count a launch"
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(_live(got, dead), _live(want, dead),
                               rtol=0, atol=1e-5)
    assert np.all(np.isfinite(_live(got, dead)))


def test_kernel_wrapper_bf16_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    arrs, dead = _case(rng, **CASES["decode"])
    want = jax_pk.paged_attention_kernel(*_jax(arrs, jnp.bfloat16),
                                         interpret=True)
    got = pk.paged_attention_kernel(*_torch(arrs, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _live(got.float(), dead), _live(np.asarray(want, np.float32), dead),
        rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_attend_matches_xla_path(name):
    rng = np.random.default_rng(10 + sorted(CASES).index(name))
    arrs, dead = _case(rng, **CASES[name])
    want = jax_ops.attend(*_jax(arrs), jnp.float32, kernel="xla")
    t = _torch(arrs)
    got = ops.attend(*t, torch.float32, kernel="gather")
    np.testing.assert_allclose(_live(got, dead), _live(want, dead),
                               rtol=0, atol=1e-5)
    # the two port lowerings agree on the live rows too
    np.testing.assert_allclose(
        _live(ops.attend(*t, torch.float32, kernel="cuda"), dead),
        _live(got, dead), rtol=0, atol=1e-5)


def test_write_kv_pools_match_reference_exactly():
    """Row 0 writes 4 valid lanes across a block boundary; row 1 is a
    bucket-slack row whose lanes all go to the null block at distinct
    offsets — so every pool byte, block 0 included, must agree."""
    rng = np.random.default_rng(3)
    nblocks, H, bs, D, S = 5, 2, 4, 8, 4
    pool = rng.normal(size=(nblocks, H, bs, D)).astype(np.float32)
    kv = rng.normal(size=(2, H, S, D)).astype(np.float32)
    bt = np.array([[3, 1, 4], [0, 0, 0]], np.int32)
    positions = np.array([[5, 6, 7, 8], [0, 1, 2, 3]], np.int32)
    valid = np.array([[True] * 4, [False] * 4])
    want = jax_ops.write_kv(jnp.asarray(pool), jnp.asarray(kv),
                            jnp.asarray(bt), jnp.asarray(positions),
                            jnp.asarray(valid))
    got = torch.from_numpy(pool.copy())
    ops.write_kv(got, torch.from_numpy(kv), torch.from_numpy(bt),
                 torch.from_numpy(positions), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), pool)


def test_gather_kv_matches_reference_exactly():
    rng = np.random.default_rng(4)
    pool = rng.normal(size=(6, 2, 4, 8)).astype(np.float32)
    bt = np.array([[2, 5, 0], [1, 3, 4]], np.int32)
    want = jax_ops.gather_kv(jnp.asarray(pool), jnp.asarray(bt))
    got = ops.gather_kv(torch.from_numpy(pool), torch.from_numpy(bt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resolve_kernel_never_falls_back():
    cpu = torch.device("cpu")
    assert ops.resolve_kernel("auto", cpu) == "gather"
    assert ops.resolve_kernel("auto", torch.device("cuda")) == "cuda"
    assert ops.resolve_kernel("cuda", cpu) == "cuda"
    assert ops.resolve_kernel("gather", torch.device("cuda")) == "gather"
    for bad in ("pallas", "xla", "triton"):
        with pytest.raises(ValueError, match="auto|gather|cuda"):
            ops.resolve_kernel(bad, cpu)
    t = _torch(_case(np.random.default_rng(0), **CASES["decode"])[0])
    with pytest.raises(ValueError, match="unresolved"):
        ops.attend(*t, torch.float32, kernel="auto")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, kp, vp, bt, lens = _torch(
        _case(np.random.default_rng(1), **CASES["decode"])[0])
    # quantized pools: scales both or neither, the residual lane only
    # beside int4 group scales, codes of the mode's dtype
    k8, scale8 = kp.to(torch.int8), torch.ones(kp.shape[:3])
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        pk.paged_attention_kernel(q, k8, k8, bt, lens, k_scale=scale8)
    with pytest.raises(ValueError, match="int4"):
        pk.paged_attention_kernel(q, k8, k8, bt, lens, k_scale=scale8,
                                  v_scale=scale8, k_new=q, v_new=q)
    with pytest.raises(ValueError, match="dtype"):
        pk.paged_attention_kernel(q, kp, vp, bt, lens, k_scale=scale8,
                                  v_scale=scale8)
    with pytest.raises(ValueError, match="int32"):
        pk.paged_attention_kernel(q, kp, vp, bt.long(), lens)
    with pytest.raises(ValueError, match="dtype"):
        pk.paged_attention_kernel(q, kp.to(torch.bfloat16), vp, bt, lens)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pk.paged_attention_kernel(q.half(), kp.half(), vp.half(), bt, lens)
    with pytest.raises(ValueError, match="contiguous"):
        pk.paged_attention_kernel(torch.cat([q, q], -1)[..., :q.shape[-1]],
                                  kp, vp, bt, lens)
    with pytest.raises(ValueError, match="shape"):
        pk.paged_attention_kernel(q, kp, vp, bt[:2], lens)
    with pytest.raises(ValueError, match="one query token"):
        pk.paged_decode_attention(q.repeat(1, 1, 2, 1), kp, vp, bt, lens)
