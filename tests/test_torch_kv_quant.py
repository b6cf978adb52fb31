"""The port's quantized KV pools against the JAX reference, on the CPU.

- ``quantize_kv``, ``quantize_kv_int4``, ``pack_int4``, ``unpack_int4``,
  the dequantizations and the in-place ``write_kv_quant`` /
  ``write_kv_quant_int4`` give byte-identical codes, scales and pools,
  zero rows and half-way values (round-half-even) included;
- the kernel wrapper on CPU tensors (its plain version) against the
  Pallas kernel run with ``interpret=True`` in modes int8, int4 and
  int4 with the residual lane, in decode and in an S = 8 prefill, with a
  bucket-slack row and the null block's and dead lanes' scales poisoned
  to 1e30 (a masking slip explodes instead of shifting by epsilon) —
  every case under one compile;
- ``attend(kernel="gather")`` on quantized pools against the
  reference's ``attend(kernel="xla")``;
- a plain emulation of the CUDA kernel's block-parallel schedule (every
  live block scored at once, the running max as a prefix max over the
  block maxima, p rounded against its block's running max, column
  groups merged in order) in modes fp32, int8 and int4 + residual: its
  rounded probabilities equal the sequential walk's bit for bit, and
  its output agrees with the Pallas kernel (interpreted) and the plain
  version;
- ``init_pools`` leaves and geometry checks, ``kv_quant_block`` and the
  harness's ``kv_quant_report`` byte formulas.

Inputs come from ``numpy.random.default_rng`` and enter both frameworks
as the same arrays.  Tolerances: float32 1e-5 absolute (the same
products summed in other orders); bfloat16 1e-2 absolute plus 1e-2
relative (one bf16 rounding of the output and of each probability, at
slightly different float32 values on the two sides).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_tpu.ops import paged_attention as jax_ops
from mpi_tensorflow_tpu.ops import paged_attention_kernel as jax_pk
from mpi_tensorflow_tpu.serving import paged_cache as jax_cache
from mpi_tensorflow_tpu.utils import metrics_writer as jax_metrics
from mpi_tensorflow_torch.models import bert
from mpi_tensorflow_torch.ops import paged_attention as ops
from mpi_tensorflow_torch.ops import paged_attention_kernel as pk
from mpi_tensorflow_torch.serving import harness, paged_cache
from mpi_tensorflow_torch.utils import metrics_writer

POISON = 1e30
GROUP = 4                                # two int4 scale groups at D = 8
TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-2, 1e-2)}
# XLA's optimisation passes only slow the compile of the interpreted
# kernels here; the arithmetic is the same without them
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _same_bytes(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _rows(rng, shape):
    """Rows of mixed magnitudes, an all-zero row, and a row of exact
    half-way values (amax 127 / 7 makes the scale 1, so x / scale hits
    k + 0.5 and round-half-even decides)."""
    x = rng.normal(size=shape).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] *= 1e-4
    x[0, 1, 0] *= 1e4
    D = shape[-1]
    half = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 4.5], np.float32)
    x[1, 0, 0] = np.resize(half, D)
    x[1, 0, 0, 0] = 127.0                # int8 row scale 1
    x[1, 1, 0] = np.resize(half, D)
    x[1, 1, 0, ::GROUP] = 7.0            # every int4 group scale 1
    return x


# ------------------------------------------------- (a) byte identity

def test_quantize_kv_bytes_match_reference():
    x = _rows(np.random.default_rng(0), (2, 2, 3, 8))
    codes, scale = ops.quantize_kv(torch.from_numpy(x))
    w_codes, w_scale = jax_ops.quantize_kv(jnp.asarray(x))
    _same_bytes(codes, w_codes)
    _same_bytes(scale, w_scale)
    assert float(scale[0, 0, 0]) == 0.0 and not codes[0, 0, 0].any()
    # round-half-even: 1.5 -> 2, 2.5 -> 2, -0.5 -> 0, -2.5 -> -2
    assert codes[1, 0, 0, 1:6].tolist() == [2, 2, 0, -2, -2]


@pytest.mark.parametrize("group", [GROUP, 32])   # 32 clamps to D = 8
def test_quantize_kv_int4_bytes_match_reference(group):
    x = _rows(np.random.default_rng(1), (2, 2, 3, 8))
    packed, scale = ops.quantize_kv_int4(torch.from_numpy(x), group)
    w_packed, w_scale = jax_ops.quantize_kv_int4(jnp.asarray(x), group)
    _same_bytes(packed, w_packed)
    _same_bytes(scale, w_scale)
    assert scale.shape == (2, 2, 3, 8 // min(group, 8))


def test_pack_unpack_int4_match_reference():
    codes = np.random.default_rng(2).integers(-8, 8, size=(3, 2, 4, 8))
    codes[0, 0, 0] = np.arange(-8, 8)[:8]
    codes[0, 0, 1] = np.arange(-8, 8)[8:]
    packed = ops.pack_int4(torch.from_numpy(codes).to(torch.int32))
    want = jax_ops.pack_int4(jnp.asarray(codes, jnp.int32))
    _same_bytes(packed, want)
    unpacked = ops.unpack_int4(packed)
    _same_bytes(unpacked, jax_ops.unpack_int4(want))
    np.testing.assert_array_equal(unpacked.numpy(), codes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches_reference(dtype):
    x = _rows(np.random.default_rng(3), (2, 2, 3, 8))
    c8, s8 = jax_ops.quantize_kv(jnp.asarray(x))
    c4, s4 = jax_ops.quantize_kv_int4(jnp.asarray(x), GROUP)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    got8 = ops.dequantize_kv(torch.from_numpy(np.array(c8)),
                             torch.from_numpy(np.array(s8)), tdt)
    got4 = ops.dequantize_kv_int4(torch.from_numpy(np.array(c4)),
                                  torch.from_numpy(np.array(s4)), tdt)
    for got, want in ((got8, jax_ops.dequantize_kv(c8, s8, jdt)),
                      (got4, jax_ops.dequantize_kv_int4(c4, s4, jdt))):
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_write_kv_quant_pools_match_reference(mode):
    """Row 0 writes 4 valid lanes across a block boundary; row 1 is a
    bucket-slack row whose lanes all go to the null block at distinct
    slots — so every pool and scale byte, block 0 included, must
    agree."""
    rng = np.random.default_rng(4)
    nblocks, H, bs, D, S = 5, 2, 4, 8, 4
    kv = _rows(rng, (2, H, S, D))
    bt = np.array([[3, 1, 4], [0, 0, 0]], np.int32)
    positions = np.array([[5, 6, 7, 8], [0, 1, 2, 3]], np.int32)
    valid = np.array([[True] * 4, [False] * 4])
    if mode == "int8":
        pool = rng.integers(-127, 128, (nblocks, H, bs, D)).astype(np.int8)
        pscale = rng.random((nblocks, H, bs)).astype(np.float32)
        write, jwrite = ops.write_kv_quant, jax_ops.write_kv_quant
    else:
        pool = rng.integers(0, 256, (nblocks, H, bs, D // 2)).astype(np.uint8)
        pscale = rng.random((nblocks, H, bs, D // GROUP)).astype(np.float32)
        write, jwrite = ops.write_kv_quant_int4, jax_ops.write_kv_quant_int4
    w_pool, w_scale = jwrite(jnp.asarray(pool), jnp.asarray(pscale),
                             jnp.asarray(kv), jnp.asarray(bt),
                             jnp.asarray(positions), jnp.asarray(valid))
    got, got_scale = torch.from_numpy(pool.copy()), torch.from_numpy(
        pscale.copy())
    assert write(got, got_scale, torch.from_numpy(kv), torch.from_numpy(bt),
                 torch.from_numpy(positions), torch.from_numpy(valid)) is None
    _same_bytes(got, w_pool)
    _same_bytes(got_scale, w_scale)
    assert not np.array_equal(got.numpy(), pool)


# --------------------------------- (b) kernel wrapper vs Pallas kernel

def _quant_case(seed, B, NB, bs, S, mode, H=2, D=8):
    """Quantized pools (codes from the reference's quantizers) whose null
    block and dead lanes (positions >= length + S) carry scale 1e30;
    rows as ``_case``: full, ragged with a null tail, and a bucket-slack
    last row when B > 2.  Returns the operands as numpy arrays and the
    slack rows."""
    rng = np.random.default_rng(seed)
    nblocks = 1 + B * NB
    kp, vp = (rng.normal(size=(nblocks, H, bs, D)).astype(np.float32)
              for _ in range(2))
    bt = np.zeros((B, NB), np.int32)
    lens = np.zeros((B,), np.int32)
    dead, nxt = [], 1
    for b in range(B):
        if b == B - 1 and B > 2:
            dead.append(b)
            continue
        lens[b] = (int(rng.integers(0, max(1, (NB - 1) * bs - S + 1)))
                   if b % 2 else NB * bs - S)
        n = max(1, -(-(int(lens[b]) + S) // bs))
        bt[b, :n] = range(nxt, nxt + n)
        nxt += n
    quant = (functools.partial(jax_ops.quantize_kv_int4, group=GROUP)
             if mode != "int8" else jax_ops.quantize_kv)
    (kc, ks), (vc, vs) = (
        (np.array(c), np.array(s)) for c, s in
        (quant(jnp.asarray(kp)), quant(jnp.asarray(vp))))
    for s in (ks, vs):
        s[0] = POISON
        for b in range(B):
            for j in range(NB):
                if bt[b, j]:
                    s[bt[b, j], :, max(0, int(lens[b]) + S - j * bs):] = POISON
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    new = ([rng.normal(size=(B, H, S, D)).astype(np.float32)
            for _ in range(2)] if mode == "int4_res" else [None, None])
    return (q, kc, vc, bt, lens, ks, vs, *new), dead


# every mode in decode and in the S = 8 prefill in float32, and in
# decode in bfloat16
CASES = [(mode, shape, "float32") for mode in ("int8", "int4", "int4_res")
         for shape in ("decode", "prefill_s8")]
CASES += [(mode, "decode", "bfloat16")
          for mode in ("int8", "int4", "int4_res")]
IDS = ["-".join(c) for c in CASES]
SHAPES = {"decode": dict(B=4, NB=3, bs=4, S=1),
          "prefill_s8": dict(B=3, NB=4, bs=4, S=8)}


def _operands(arrs, dtype, to):
    """(q, pools, table, lengths) positionally; scales and the residual
    lane by keyword.  q and the residual lane take ``dtype``."""
    q, kc, vc, bt, lens, ks, vs, kn, vn = arrs
    fl = lambda a: None if a is None else to(a, dtype)
    raw = lambda a: to(a, None)
    return ((fl(q), raw(kc), raw(vc), raw(bt), raw(lens)),
            dict(k_scale=raw(ks), v_scale=raw(vs), k_new=fl(kn),
                 v_new=fl(vn)))


def _to_jax(a, dtype):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a,
                                                            jnp.dtype(dtype))


def _to_torch(a, dtype):
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(getattr(torch, dtype))


def _case(i):
    mode, shape, _ = CASES[i]
    return _quant_case(i, **SHAPES[shape], mode=mode)


@functools.lru_cache(maxsize=None)
def _reference():
    """Per case, the Pallas kernel's output (interpreted) and the xla
    lowering's ``attend`` output, all under one compile, as float32
    numpy arrays."""
    flat = [_operands(_case(i)[0], dtype, _to_jax)
            for i, (_, _, dtype) in enumerate(CASES)]

    def run(flat):
        return [(jax_pk.paged_attention_kernel(*pos, interpret=True, **kw),
                 jax_ops.attend(*pos, pos[0].dtype, kernel="xla", **kw))
                for pos, kw in flat]

    res = jax.jit(run).lower(flat).compile(FAST_COMPILE)(flat)
    return [tuple(np.asarray(r.astype(jnp.float32)) for r in pair)
            for pair in res]


def _live(x, dead):
    x = np.array(x, dtype=np.float32)
    x[list(dead)] = 0.0
    return x


def _assert_close(got, want, dead, dtype):
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    g = _live(got.float(), dead)
    assert np.all(np.isfinite(g))
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(g, _live(want, dead), rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode,shape,dtype", CASES, ids=IDS)
def test_kernel_wrapper_quant_matches_pallas_interpret(mode, shape, dtype):
    i = CASES.index((mode, shape, dtype))
    arrs, dead = _case(i)
    pos, kw = _operands(arrs, dtype, _to_torch)
    before = pk.paged_attention_kernel.launches
    got = pk.paged_attention_kernel(*pos, **kw)
    assert pk.paged_attention_kernel.launches == before, \
        "a CPU tensor must run the plain version, not count a launch"
    _assert_close(got, _reference()[i][0], dead, dtype)


# ---------------------------------------------- (c) gather vs xla

@pytest.mark.parametrize("mode,shape,dtype", CASES, ids=IDS)
def test_gather_attend_quant_matches_xla_path(mode, shape, dtype):
    i = CASES.index((mode, shape, dtype))
    arrs, dead = _case(i)
    pos, kw = _operands(arrs, dtype, _to_torch)
    got = ops.attend(*pos, getattr(torch, dtype), kernel="gather", **kw)
    _assert_close(got, _reference()[i][1], dead, dtype)


@pytest.mark.parametrize("bad", ["one_scale", "one_residual",
                                 "residual_on_int8"])
def test_attend_refuses_what_the_reference_refuses(bad):
    mode = "int8" if bad == "residual_on_int8" else "int4_res"
    arrs, _ = _quant_case(0, **SHAPES["decode"], mode=mode)
    pos, kw = _operands(arrs, "float32", _to_torch)
    if bad == "one_scale":
        kw["v_scale"] = None
    elif bad == "one_residual":
        kw["v_new"] = None
    else:
        kw["k_new"] = kw["v_new"] = pos[0]
    for kernel in ("gather", "cuda"):
        with pytest.raises(ValueError, match="both|int4"):
            ops.attend(*pos, torch.float32, kernel=kernel, **kw)


# ------------------------- (e) the CUDA kernel's block-parallel schedule

def _block(pool, scale, blk, dtype):
    """Pool block ``blk`` as the kernel reads it: in q's dtype, quantized
    blocks dequantized (code x scale rounded to q's dtype)."""
    if scale is None:
        return pool[blk]
    if scale.ndim == 4:
        return ops.dequantize_kv_int4(pool[blk], scale[blk], dtype)
    return ops.dequantize_kv(pool[blk], scale[blk], dtype)


def _block_scores(q, k_pool, k_scale, k_new, block_table, b, j, qpos):
    """Masked float32 scores (H, S, bs) of row b's live block j, one
    block at a time, as both schedules take them."""
    f32 = torch.float32
    bs = k_pool.shape[2]
    qb = q[b].to(f32)
    k = _block(k_pool, k_scale, int(block_table[b, j]), q.dtype).to(f32)
    s = qb @ k.transpose(1, 2)
    col = j * bs + torch.arange(bs)[None, :]
    if k_new is not None:
        s_self = (qb * k_new[b].to(f32)).sum(-1)[..., None]
        s = torch.where(col == qpos, s_self, s)
    neg = torch.finfo(f32).min
    return torch.where(col <= qpos, s * q.shape[-1] ** -0.5, neg), col


def _sequential_p(q, k_pool, v_pool, block_table, lengths, *,
                  k_scale=None, k_new=None, **_):
    """The rounded probabilities of the sequential walk (the Pallas
    kernel's and the plain version's): per live block j, p = exp(s -
    m_j) in q's dtype, m_j the running max after block j."""
    B, H, S, _ = q.shape
    bs, NB = k_pool.shape[2], block_table.shape[1]
    out = {}
    for b in range(B):
        qpos = int(lengths[b]) + torch.arange(S)[:, None]
        m = torch.full((H, S, 1), torch.finfo(torch.float32).min)
        for j in range(pk._nlive(int(lengths[b]), S, bs, NB)):
            s, _ = _block_scores(q, k_pool, k_scale, k_new, block_table,
                                 b, j, qpos)
            m = torch.maximum(m, s.amax(-1, keepdim=True))
            out[b, j] = torch.exp(s - m).to(q.dtype)
    return out


def _block_parallel(q, k_pool, v_pool, block_table, lengths, *,
                    k_scale=None, v_scale=None, k_new=None, v_new=None,
                    round_blocks=2, splits=3):
    """A plain emulation of ``csrc/paged_attention.cu``'s schedule: the
    live blocks in rounds of ``round_blocks``; per round every block's
    scores, the blocks' maxima and their prefix max m_j (seeded by the
    earlier rounds'), p = exp(s - m_j) rounded to q's dtype in block j
    and weighted by exp(m_j - m_last) in float32, the weights summed
    against V in ``splits`` column groups (column c in group c %
    splits), each group's partial rescaled by exp(m_prev - m_last) and
    the groups merged in order.  Returns the output and the rounded p
    per (row, block)."""
    B, H, S, D = q.shape
    bs, NB = k_pool.shape[2], block_table.shape[1]
    f32 = torch.float32
    neg = torch.finfo(f32).min
    out = torch.empty_like(q)
    ps = {}
    for b in range(B):
        qpos = int(lengths[b]) + torch.arange(S)[:, None]
        nlive = pk._nlive(int(lengths[b]), S, bs, NB)
        m_run = torch.full((H, S, 1), neg)
        l = torch.zeros((H, S, 1))
        acc = torch.zeros((splits, H, S, D))
        for j0 in range(0, nlive, round_blocks):
            js = range(j0, min(j0 + round_blocks, nlive))
            blocks = [_block_scores(q, k_pool, k_scale, k_new, block_table,
                                    b, j, qpos) for j in js]
            bm = torch.cat([s.amax(-1, keepdim=True) for s, _ in blocks], -1)
            m_j = torch.cummax(torch.cat([m_run, bm], -1), -1).values[..., 1:]
            m_last = m_j[..., -1:]
            f = torch.exp(m_j - m_last)
            g = torch.exp(m_run - m_last)
            psum = torch.zeros((H, S, 1))
            pself = torch.zeros((H, S, 1))
            ws, vs = [], []
            for i, (j, (s, col)) in enumerate(zip(js, blocks)):
                p = torch.where(col <= qpos, torch.exp(s - m_j[..., i:i + 1]),
                                0.0)
                ps[b, j] = p.to(q.dtype)
                fi = f[..., i:i + 1]
                psum = psum + (p * fi).sum(-1, keepdim=True)
                if k_new is not None:
                    self_m = col == qpos
                    pself = pself + torch.where(self_m, p * fi, 0.0).sum(
                        -1, keepdim=True)
                    p = torch.where(self_m, 0.0, p)
                ws.append(p.to(q.dtype).to(f32) * fi)
                vs.append(_block(v_pool, v_scale, int(block_table[b, j]),
                                 q.dtype).to(f32))
            l = l * g + psum
            w, v = torch.cat(ws, -1), torch.cat(vs, -2)
            group = torch.arange(w.shape[-1]) % splits
            for sp in range(splits):
                acc[sp] = acc[sp] * g + w[..., group == sp] @ v[:, group == sp]
            if v_new is not None:
                acc[0] = acc[0] + pself * v_new[b].to(f32)
            m_run = m_last
        total = acc[0]
        for sp in range(1, splits):
            total = total + acc[sp]
        out[b] = (total / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
    return out, ps


# lengths per row: decode rows with 3 live blocks (a live length that is
# not a multiple of bs), one live block, 4 live blocks and a bucket-slack
# last row; prefill (S = 8) rows whose first queries see none of the
# tile's later blocks, a first chunk (length 0), and 5 live blocks.
SCHEDULE_SHAPES = {"decode": dict(B=4, NB=4, bs=4, S=1, lens=(9, 2, 14, 0)),
                   "prefill_s8": dict(B=3, NB=5, bs=4, S=8, lens=(3, 0, 10))}
SCHEDULE_CASES = [(mode, shape) for mode in ("fp32", "int8", "int4_res")
                  for shape in SCHEDULE_SHAPES]


def _schedule_case(i):
    """Pools with poisoned null block and dead lanes (values, or scales,
    of 1e30) for case ``i`` of ``SCHEDULE_CASES``, as numpy arrays in
    ``_operands``' order, and the bucket-slack rows."""
    mode, shape = SCHEDULE_CASES[i]
    sh = SCHEDULE_SHAPES[shape]
    B, NB, bs, S = sh["B"], sh["NB"], sh["bs"], sh["S"]
    H, D = 2, 8
    rng = np.random.default_rng(100 + i)
    lens = np.array(sh["lens"], np.int32)
    dead = [B - 1] if shape == "decode" else []
    bt = np.zeros((B, NB), np.int32)
    nxt = 1
    for b in range(B):
        if b in dead:
            continue
        n = -(-(int(lens[b]) + S) // bs)
        bt[b, :n] = range(nxt, nxt + n)
        nxt += n
    kp, vp = (rng.normal(size=(nxt, H, bs, D)).astype(np.float32)
              for _ in range(2))
    live = np.ones((nxt, bs), bool)
    live[0] = False
    for b in range(B):
        for j in range(NB):
            if bt[b, j]:
                live[bt[b, j], max(0, int(lens[b]) + S - j * bs):] = False
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    if mode == "fp32":
        for pool in (kp, vp):
            pool[~live[:, None, :, None].repeat(H, 1).repeat(D, 3)] = POISON
        return (q, kp, vp, bt, lens, None, None, None, None), dead
    quant = (functools.partial(jax_ops.quantize_kv_int4, group=GROUP)
             if mode != "int8" else jax_ops.quantize_kv)
    (kc, ks), (vc, vs) = ((np.array(c), np.array(s)) for c, s in
                          (quant(jnp.asarray(kp)), quant(jnp.asarray(vp))))
    for sc in (ks, vs):
        dead_rows = ~live[:, None, :].repeat(H, 1)
        sc[dead_rows] = POISON
    new = ([rng.normal(size=(B, H, S, D)).astype(np.float32)
            for _ in range(2)] if mode == "int4_res" else [None, None])
    return (q, kc, vc, bt, lens, ks, vs, *new), dead


def _schedule_operands(arrs, to):
    """``_operands`` for the schedule cases: an fp pool takes q's
    bfloat16 and no scales."""
    q, kc, vc, bt, lens, ks, vs, kn, vn = arrs
    fl = lambda a: None if a is None else to(a, "bfloat16")
    raw = lambda a: None if a is None else to(a, None)
    pool = fl if ks is None else raw
    return ((fl(q), pool(kc), pool(vc), raw(bt), raw(lens)),
            dict(k_scale=raw(ks), v_scale=raw(vs), k_new=fl(kn),
                 v_new=fl(vn)))


@functools.lru_cache(maxsize=None)
def _schedule_reference():
    """The Pallas kernel's output (interpreted) for every schedule case,
    under one compile, as float32 numpy arrays."""
    flat = [_schedule_operands(_schedule_case(i)[0], _to_jax)
            for i in range(len(SCHEDULE_CASES))]

    def run(flat):
        return [jax_pk.paged_attention_kernel(*pos, interpret=True, **kw)
                for pos, kw in flat]

    res = jax.jit(run).lower(flat).compile(FAST_COMPILE)(flat)
    return [np.asarray(r.astype(jnp.float32)) for r in res]


@pytest.mark.parametrize("mode,shape", SCHEDULE_CASES,
                         ids=["-".join(c) for c in SCHEDULE_CASES])
def test_block_parallel_schedule_keeps_the_rounding_point(mode, shape):
    """The kernel's schedule, emulated in bfloat16: every rounded p
    equals the sequential walk's bit for bit (the prefix max over block
    maxima is the running max), and the output agrees with the Pallas
    kernel and the plain version within the bfloat16 tolerance.  The
    int4 prefill case puts each early query's own (residual) column in a
    block before the tile's last; rounds of 2 blocks and 3 column groups
    make rounds and groups uneven."""
    i = SCHEDULE_CASES.index((mode, shape))
    arrs, dead = _schedule_case(i)
    pos, kw = _schedule_operands(arrs, _to_torch)
    got, p_par = _block_parallel(*pos, **kw)
    p_seq = _sequential_p(*pos, **kw)
    assert sorted(p_par) == sorted(p_seq)
    for key in p_seq:
        assert p_par[key].dtype == torch.bfloat16
        assert torch.equal(p_par[key].view(torch.int16),
                           p_seq[key].view(torch.int16)), key
    if shape == "prefill_s8":
        # the first query of row 0 (position 3) sees none of blocks 1, 2
        assert not p_seq[0, 1][:, 0].float().any()
        assert not p_seq[0, 2][:, 0].float().any()
    _assert_close(got, _schedule_reference()[i], dead, "bfloat16")
    plain = pk.paged_attention_reference(*pos, **kw)
    _assert_close(got, np.asarray(plain.float()), dead, "bfloat16")
    assert np.all(np.isfinite(_live(got.float(), dead)))


# ------------------------------------------- (f) pools and accounting

@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "int4"])
def test_init_pools_leaves_match_reference(kv_dtype):
    got = paged_cache.init_pools(bert.BERT_TINY, 8, 4, torch.device("cpu"),
                                 kv_dtype, kv_group=8)
    want = jax_cache.init_pools(jax_bert.BERT_TINY, 8, 4, kv_dtype,
                                kv_group=8)
    assert len(got) == len(want) == bert.BERT_TINY.layers
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].shape == w[key].shape, key
            assert str(g[key].dtype)[6:] == str(w[key].dtype), key
            assert not g[key].any()


@pytest.mark.parametrize("hidden,group,match", [(28, 32, "head_dim"),
                                                (64, 3, "group")])
def test_init_pools_rejects_bad_geometry(hidden, group, match):
    cfg = dataclasses.replace(bert.BERT_TINY, hidden=hidden)
    jcfg = dataclasses.replace(jax_bert.BERT_TINY, hidden=hidden)
    with pytest.raises(ValueError, match=match):
        paged_cache.init_pools(cfg, 8, 4, torch.device("cpu"), "int4",
                               kv_group=group)
    with pytest.raises(ValueError, match=match):
        jax_cache.init_pools(jcfg, 8, 4, "int4", kv_group=group)
    with pytest.raises(ValueError, match="fp32|int8|int4"):
        paged_cache.init_pools(cfg, 8, 4, torch.device("cpu"), "fp8")


@pytest.mark.parametrize("kw", [
    {},
    dict(kv_dtype="int8", matched_tokens=7, compared_tokens=9,
         block_bytes_ref=393216, block_bytes=208896, num_blocks=257,
         peak_live_blocks_ref=40, peak_live_blocks=41,
         bytes_per_decode_token_ref=1234.5678, bytes_per_decode_token=7.005),
    dict(kv_dtype="int4", matched_tokens=3, compared_tokens=3,
         block_bytes_ref=10, block_bytes=3, num_blocks=5),
])
def test_kv_quant_block_matches_reference(kw):
    got = metrics_writer.kv_quant_block(**kw)
    want = jax_metrics.kv_quant_block(**kw)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("kv_dtype,group,multiplier", [
    ("int8", 32, 1.8824), ("int4", 32, 3.2), ("int4", 16, 2.6667)])
def test_kv_quant_report_byte_formulas(kv_dtype, group, multiplier):
    """BERT_BASE in bf16: a K+V row is 256 bytes in the compute dtype,
    2 x (64 + 4) under int8 and 2 x (32 + 4 x 64 / g) under int4 — the
    reference bench's formulas; tokens compare position by position."""
    cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.bfloat16)
    serve = types.SimpleNamespace(kv_dtype=kv_dtype, kv_group=group,
                                  block_size=16, num_blocks=65)
    engine = types.SimpleNamespace(model=types.SimpleNamespace(cfg=cfg),
                                   serve=serve)
    trace = types.SimpleNamespace(prompts=[[1] * 8, [2] * 10],
                                  outputs=[2, 3])
    ref = {"outputs": {0: [5, 6], 1: [7, 8, 9]}, "peak_live_blocks": 2}
    quant = {"outputs": {0: [5, 6], 1: [7, 0]}, "peak_live_blocks": 2}
    got = harness.kv_quant_report(ref, quant, engine, trace)
    assert got["capacity_multiplier"] == multiplier
    assert (got["matched_tokens"], got["compared_tokens"]) == (3, 5)
    assert got["kv_dtype"] == kv_dtype and got["peak_live_blocks_delta"] == 0
    mean_ctx = np.mean([9, 10, 11, 12, 13])
    assert got["bytes_per_decode_token_ref"] == round(
        12 * 2 * 12 * 64 * 2 * mean_ctx, 2)
