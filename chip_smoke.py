#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``mpi_tensorflow_torch`` (never JAX, never ``mpi_tensorflow_tpu``)
on the card and fails, with a nonzero exit, on the first phase that
fails:

1. card and build — prints the card's name and power limit
   (``nvidia-smi``), builds every CUDA kernel of the port from the
   sources in the checkout and prints the seconds it took;
2. kernel against its plain version — ``paged_attention_kernel`` against
   ``paged_attention_reference`` at the serving shapes (H=12, D=64,
   bs=16, every S in 1, 2, 4, ..., 64, B in {1, 8}, NB up to 32, plus
   BERT_TINY's H=4, D=16; float32 and bfloat16; ragged rows, a
   bucket-slack row, poisoned null-block and dead lanes), then times it
   at the decode shape beside the plain version,
   ``F.scaled_dot_product_attention`` on a pre-gathered view (the
   yardstick only: the port never calls it) and its memory bound;
3. full-width serving — a seeded Poisson trace (24 requests at 4 rps,
   prompts <= 32, outputs <= 128 tokens, seed 0) through
   ``PagedDecodeEngine`` at ``BERT_BASE`` geometry in bfloat16 with
   ``kernel="cuda"``; the kernel's launch count must equal layers x
   forward dispatches;
4. cross-check — a short trace in float32 at 2 layers (full width)
   served with ``kernel="cuda"`` and with ``kernel="gather"``: the greedy
   tokens must be identical to each other and to ``CausalLm.generate``;
5. flash kernels against their plain versions — ``flash_fwd`` (out and
   lse), ``flash_dq`` and ``flash_dkdv`` against
   ``flash_forward_reference`` / ``flash_backward_reference`` at every S
   in 1, 17, 64, 128, 255, 512, 1000, (B, H) in {(1, 1), (2, 3)}, D in
   {16, 64}, float32 and bfloat16, causal and not; then the
   ``flash_attention`` autograd function's gradients against autograd
   through ``dense_attention`` at S = 256 in float32;
6. flash at the training shape (B=4, H=12, S=4096, D=64, bf16, causal
   and not): each kernel against its plain version on the same inputs
   (the errors join the kernel's ``max_abs_err``), then its device time
   beside its plain version's,
   ``F.scaled_dot_product_attention``'s forward and backward on the same
   tensors (the yardstick only: the port never calls it) and its bound;
7. full-width training — ``train_mlm`` at ``BERT_BASE`` widths in
   bfloat16, S = 4096, batch 4, dropout 0.1, 8 steps with a held-out
   eval at steps 4 and 7: the loss must be finite, the forward kernel
   launched 12 x (train steps + eval forwards) times and dq, dk/dv 12 x
   train steps;
8. cross-check — float32, 2 layers at full width, S = 512, B = 2,
   dropout 0, three train steps with ``attention="flash"`` and with
   ``"dense"``: loss, gradients and parameters must agree.

Prints one ``kernels`` JSON line, then the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.  Without a card it
prints no result and exits 1.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): memory bandwidth, and the
# operation rate per dtype — bf16 on the tensor cores, float32 outside
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

H, D, BS = 12, 64, 16                    # BERT_BASE heads, head dim, block
POISON = 1e30
# kernel vs plain version: float32 sums in another order (~1e-6 seen);
# bfloat16 adds one rounding of the output (2^-8 relative) and of each
# probability before P.V, so allow 1e-2 absolute + 1e-2 relative
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 1e-2)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1

def build() -> None:
    from mpi_tensorflow_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {sorted(_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "smem")):
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 2

def paged_case(rng, B: int, NB: int, S: int, dtype, dev, H=H, D=D):
    """Rows cycle through a full table and a ragged partial table with a
    null-block tail; row 1 starts at length 0 (a first prefill chunk);
    with B > 2 the last row is bucket slack (all-null table, length 0).
    The null block and every lane past a row's length + S hold 1e30, so
    a masking error shows as a huge error, not a small one."""
    nblocks = 1 + B * NB
    kp = rng.normal(size=(nblocks, H, BS, D)).astype(np.float32)
    vp = rng.normal(size=(nblocks, H, BS, D)).astype(np.float32)
    bt = np.zeros((B, NB), np.int32)
    lens = np.zeros((B,), np.int32)
    live_rows = []
    nxt = 1
    for b in range(B):
        if b == B - 1 and B > 2:
            continue
        if b == 1:
            lens[b] = 0
        elif b % 2 == 1:
            lens[b] = int(rng.integers(0, (NB - 1) * BS - S + 1))
        else:
            lens[b] = NB * BS - S
        n = max(1, -(-(int(lens[b]) + S) // BS))
        bt[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
        live_rows.append(b)
    kp[0] = vp[0] = POISON
    for b in live_rows:
        for j in range(NB):
            if bt[b, j]:
                first_dead = max(0, int(lens[b]) + S - j * BS)
                kp[bt[b, j], :, first_dead:] = POISON
                vp[bt[b, j], :, first_dead:] = POISON
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)

    def put(a, dt=None):
        t = torch.from_numpy(a).to(dev)
        return t.to(dt) if dt is not None else t

    return ((put(q, dtype), put(kp, dtype), put(vp, dtype), put(bt),
             put(lens)), live_rows)


def check_kernel(dev) -> dict:
    """Kernel vs plain version at every serving shape (BERT_BASE heads,
    and BERT_TINY's H=4, D=16 at a few S); returns the max absolute
    error per dtype."""
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk

    rng = np.random.default_rng(0)
    shapes = [(S, B, NB, H, D) for S in (1, 2, 4, 8, 16, 32, 64)
              for B, NB in ((1, 16), (8, 32))]
    shapes += [(S, 8, 8, 4, 16) for S in (1, 8, 64)]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        worst[dtype] = 0.0
        for S, B, NB, h, d in shapes:
            args, live = paged_case(rng, B, NB, S, dtype, dev, h, d)
            got = pk.paged_attention_kernel(*args)
            torch.cuda.synchronize(dev)
            want = pk.paged_attention_reference(*args)
            g = got[live].float()
            w = want[live].float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"non-finite kernel output: {dtype} "
                                     f"S={S} B={B} H={h} D={d}")
            err = (g - w).abs()
            worst[dtype] = max(worst[dtype], float(err.max()))
            if bool((err > atol + rtol * w.abs()).any()):
                raise AssertionError(
                    f"kernel disagrees with its plain version: {dtype} "
                    f"S={S} B={B} NB={NB} H={h} D={d} "
                    f"max|err|={float(err.max())} "
                    f"(tolerance {atol} + {rtol}*|want|)")
        log(f"[kernel] {str(dtype)[6:]}: max|kernel - plain| = "
            f"{worst[dtype]:.3e} over {len(shapes)} shapes: S=1..64, "
            f"B in (1, 8), H={H} D={D}, and H=4 D=16 "
            f"(tolerance {atol} abs + {rtol} rel)")
    return worst


def bound(nbytes: int, ops: float, dtype) -> tuple:
    """The least time the card could take: bytes over the memory rate or
    operations over the dtype's peak, whichever is longer."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def wall_ms(fn, inputs, reps: int) -> float:
    """Mean time per call of ``fn(*x)``, back to back, over ``reps``
    passes through ``inputs`` (CUDA events around the whole loop, after
    a warm pass): device time, or the host's launch time where that is
    longer."""
    for x in inputs:
        fn(*x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for x in inputs:
            fn(*x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(inputs))


def device_ms(fn, inputs, reps: int, kernels_per_call=None) -> float:
    """Mean device time per call of ``fn(*x)``: the durations of the
    kernels it launched, from ``torch.profiler``, over ``reps`` passes
    through ``inputs`` (after a pass the profiler records and discards,
    ``profiled_kernels``).  Rotating through input sets larger than the
    50 MB L2 finds every set's data cold, as the model finds each
    layer's.  ``kernels_per_call``: the number of kernels one call
    launches, checked against the kernels recorded.  A recording that
    holds no device time or the wrong number of kernels is taken again,
    up to three times in all (an H100 run once recorded no kernel at
    all for a pass whose launches had run)."""
    from mpi_tensorflow_torch.utils.profiling import profiled_kernels

    def one_pass():
        for x in inputs:
            fn(*x)

    def measured():
        for _ in range(reps):
            one_pass()

    one_pass()
    torch.cuda.synchronize()
    calls = reps * len(inputs)
    for attempt in range(3):
        kernels = profiled_kernels(one_pass, measured)
        us = sum(e.time_range.end - e.time_range.start for e in kernels)
        if us > 0 and (kernels_per_call is None
                       or len(kernels) == kernels_per_call * calls):
            return us / 1e3 / calls
        log(f"[profiler] recording {attempt + 1} of 3 held {len(kernels)} "
            f"kernels ({us} us) for {calls} calls; recording again")
    raise AssertionError(f"the profiler recorded {len(kernels)} kernels, "
                         f"{us} us, for {calls} calls of {kernels_per_call}")


def time_decode(dev) -> dict:
    """The decode shape of the serving run: B=8 rows of 160 live tokens
    (10 blocks), a 16-wide table bucket, bfloat16 pools."""
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk
    from mpi_tensorflow_torch.ops.paged_attention import gather_kv

    B, S, NB, live = 8, 1, 16, 160
    dt = torch.bfloat16
    nblocks = 1 + B * NB
    g = torch.Generator(device=dev).manual_seed(0)
    sets, lib_sets = [], []
    for _ in range(12):                  # 12 x 6.3 MB of pools > L2
        q = torch.randn((B, H, S, D), generator=g, device=dev).to(dt)
        kp = torch.randn((nblocks, H, BS, D), generator=g,
                         device=dev).to(dt)
        vp = torch.randn((nblocks, H, BS, D), generator=g,
                         device=dev).to(dt)
        bt = torch.zeros((B, NB), dtype=torch.int32, device=dev)
        nlive = live // BS
        bt[:, :nlive] = 1 + torch.randperm(
            B * NB, generator=g, device=dev)[:B * nlive].view(B, nlive).to(
                torch.int32)
        lens = torch.full((B,), live - S, dtype=torch.int32, device=dev)
        sets.append((q, kp, vp, bt, lens))
        # the library call reads a pre-gathered (B, H, 160, D) view
        lib_sets.append((q, gather_kv(kp, bt[:, :nlive]),
                         gather_kv(vp, bt[:, :nlive])))
    kern = pk.paged_attention_kernel
    before = kern.launches
    ms = device_ms(kern, sets, reps=20, kernels_per_call=1)
    call_ms = wall_ms(kern, sets, reps=20)
    kern.launches = before                # timing is not the main path
    # the plain version is a Python loop of small launches: its time is
    # the wall time of a call
    plain_ms = wall_ms(pk.paged_attention_reference, sets[:2], reps=2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_ms(sdpa, lib_sets, reps=20)
    library_call_ms = wall_ms(sdpa, lib_sets, reps=20)
    esize = torch.finfo(dt).bits // 8
    nbytes = (2 * B * H * S * D * esize            # q in, out
              + 2 * B * H * live * D * esize       # live K and V
              + B * NB * 4 + B * 4)                # table, lengths
    ops = 4 * B * H * S * live * D                 # QK^T and P.V
    bound_ms, bound_by = bound(nbytes, ops, dt)
    log(f"[kernel] decode B={B} S={S} H={H} D={D} live={live} bf16: "
        f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms per call "
        f"back to back), plain {plain_ms:.4f} ms per call, sdpa on the "
        f"gathered view {library_ms:.4f} ms on the device "
        f"({library_call_ms:.4f} ms per call), bound {bound_ms:.5f} ms "
        f"({bound_by}: {nbytes} B, {ops} ops)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "call_ms": call_ms, "library_call_ms": library_call_ms}


# ---------------------------------------------------------------- phase 3

def serve_full_width(dev) -> int:
    """BERT_BASE, bf16, the CUDA kernel, the bench's default trace.
    Returns the kernel's launches in the measured run."""
    from mpi_tensorflow_torch.ops import paged_attention_kernel as pk
    from mpi_tensorflow_torch.serving.harness import build_serving

    engine, trace = build_serving(precision="bf16", kernel="cuda",
                                  device=dev)
    cfg = engine.model.cfg
    engine.run(trace.requests())                    # warmup replay
    engine.reset()
    pk.paged_attention_kernel.launches = 0
    res = engine.run(trace.requests())
    torch.cuda.synchronize(dev)
    launches = pk.paged_attention_kernel.launches
    want = cfg.layers * res["forward_dispatches"]
    if launches != want or launches == 0:
        raise AssertionError(f"kernel launches {launches} != layers x "
                             f"forward dispatches = {want}")
    bad = {i: s for i, s in res["statuses"].items() if s != "ok"}
    if bad or len(res["outputs"]) != len(trace.prompts):
        raise AssertionError(f"requests not served: {bad}")
    for i, toks in res["outputs"].items():
        if len(toks) != int(trace.outputs[i]) or \
                not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {i}: bad output {toks[:8]}...")
    log("[serve] " + json.dumps({
        "layers": cfg.layers, "hidden": cfg.hidden, "heads": cfg.heads,
        "vocab": cfg.vocab_size, "precision": "bf16",
        "kernel": res["kernel"], "requests": len(trace.prompts),
        "tokens": res["tokens"], "elapsed_s": res["elapsed_s"],
        "tokens_per_sec": res["tokens_per_sec"],
        "p50_token_latency_ms": res["p50_token_latency_ms"],
        "p99_token_latency_ms": res["p99_token_latency_ms"],
        "forward_dispatches": res["forward_dispatches"],
        "dispatch_shapes": len(res["dispatch_shapes"]),
        "launches": launches, "device": res["device"]}))
    return launches


# ---------------------------------------------------------------- phase 4

def cross_check(dev) -> None:
    """fp32, 2 layers at full width: cuda and gather serve identical
    greedy tokens, and both equal the contiguous-cache ``generate``."""
    from mpi_tensorflow_torch.serving.harness import build_serving

    outs = {}
    for kernel in ("cuda", "gather"):
        engine, trace = build_serving(
            num_requests=6, rate_rps=1000.0, prompt_max=32, output_max=16,
            precision="fp32", layers=2, kernel=kernel, device=dev)
        res = engine.run(trace.requests())
        assert res["kernel"] == kernel
        outs[kernel] = res["outputs"]
    if outs["cuda"] != outs["gather"]:
        raise AssertionError(f"cuda and gather tokens differ: "
                             f"{outs['cuda']} vs {outs['gather']}")
    model = engine.model
    for i, prompt in enumerate(trace.prompts):
        p = torch.tensor(np.asarray(prompt)[None], dtype=torch.int64,
                         device=dev)
        ref = model.generate(p, int(trace.outputs[i]))[0, len(prompt):]
        if ref.tolist() != outs["cuda"][i]:
            raise AssertionError(f"request {i}: engine tokens differ from "
                                 f"generate: {outs['cuda'][i]} vs "
                                 f"{ref.tolist()}")
    log(f"[cross-check] fp32, 2 layers, {len(trace.prompts)} requests: "
        f"cuda == gather == generate "
        f"({sum(len(v) for v in outs['cuda'].values())} tokens)")


# ---------------------------------------------------------------- phase 5

FLASH = ("flash_fwd", "flash_dq", "flash_dkdv")
FLASH_REPLACES = {
    "flash_fwd": "mpi_tensorflow_tpu/ops/flash_attention.py:109",
    "flash_dq": "mpi_tensorflow_tpu/ops/flash_attention.py:246",
    "flash_dkdv": "mpi_tensorflow_tpu/ops/flash_attention.py:278",
}


def flash_counts() -> dict:
    from mpi_tensorflow_torch.ops import flash_attention as fa

    return {name: getattr(fa, name).launches for name in FLASH}


def set_flash_counts(counts: dict) -> None:
    from mpi_tensorflow_torch.ops import flash_attention as fa

    for name in FLASH:
        getattr(fa, name).launches = counts[name]


def check_close(got, want, atol, rtol, what) -> float:
    g, w = got.detach().float(), want.detach().float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"non-finite kernel output: {what}")
    err = (g - w).abs()
    if bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(
            f"kernel disagrees with its plain version: {what} "
            f"max|err|={float(err.max())} (tolerance {atol} + "
            f"{rtol}*|want|)")
    return float(err.max())


def check_flash(dev) -> dict:
    """Each flash kernel against its plain version on the same inputs;
    returns the max absolute error per kernel and dtype.  lse is held to
    the float32 tolerance in both dtypes (it is float32 either way)."""
    from mpi_tensorflow_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    dtypes = (torch.float32, torch.bfloat16)
    worst = {(k, dt): 0.0 for k in FLASH for dt in dtypes}
    cases = list(itertools.product(dtypes, (1, 17, 64, 128, 255, 512, 1000),
                                   ((1, 1), (2, 3)), (16, 64),
                                   (False, True)))
    for dtype, S, (B, Hh), Dd, causal in cases:
        atol, rtol = TOL[dtype]
        what = f"{str(dtype)[6:]} S={S} B={B} H={Hh} D={Dd} causal={causal}"
        q, k, v, do = (torch.randn((B, Hh, S, Dd), generator=g,
                                   device=dev).to(dtype) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize(dev)
        r_out, r_lse = fa.flash_forward_reference(q, k, v, causal=causal)
        delta = (do.float() * r_out.float()).sum(-1)
        dq = fa.flash_dq(q, k, v, do, r_lse, delta, causal=causal)
        dk, dv = fa.flash_dkdv(q, k, v, do, r_lse, delta, causal=causal)
        torch.cuda.synchronize(dev)
        r_dq, r_dk, r_dv = fa.flash_backward_reference(
            q, k, v, do, r_lse, delta, causal=causal)
        errs = {
            "flash_fwd": (check_close(out, r_out, atol, rtol,
                                      "flash_fwd out " + what),
                          check_close(lse, r_lse, *TOL[torch.float32],
                                      "flash_fwd lse " + what)),
            "flash_dq": (check_close(dq, r_dq, atol, rtol,
                                     "flash_dq " + what),),
            "flash_dkdv": (check_close(dk, r_dk, atol, rtol,
                                       "flash_dkdv dk " + what),
                           check_close(dv, r_dv, atol, rtol,
                                       "flash_dkdv dv " + what))}
        for name, e in errs.items():
            worst[name, dtype] = max(worst[name, dtype], *e)
    n = len(cases)
    for dtype in (torch.float32, torch.bfloat16):
        log(f"[flash] {str(dtype)[6:]}: max|kernel - plain| fwd "
            f"{worst['flash_fwd', dtype]:.3e}, dq "
            f"{worst['flash_dq', dtype]:.3e}, dkdv "
            f"{worst['flash_dkdv', dtype]:.3e} over {n // 2} cases "
            f"(tolerance {TOL[dtype][0]} abs + {TOL[dtype][1]} rel; lse "
            f"{TOL[torch.float32][0]} abs)")
    return worst


def check_flash_grads(dev) -> None:
    """``flash_attention``'s autograd gradients against autograd through
    ``dense_attention`` (float32, S = 256, B = 2, H = 3, D = 64)."""
    from mpi_tensorflow_torch.ops.flash_attention import flash_attention
    from mpi_tensorflow_torch.parallel.ring import dense_attention

    g = torch.Generator(device=dev).manual_seed(1)
    for causal in (False, True):
        x = [torch.randn((2, 3, 256, 64), generator=g, device=dev)
             for _ in range(4)]
        grads = []
        for fn in (flash_attention, dense_attention):
            q, k, v = (t.clone().requires_grad_(True) for t in x[:3])
            out = (fn(q, k, v, causal) if fn is flash_attention
                   else fn(q, k, v, causal=causal))
            grads.append((out, *torch.autograd.grad(out, (q, k, v), x[3])))
        errs = [check_close(a, b, 1e-4, 0.0, f"flash_attention {name} "
                            f"vs dense autograd, causal={causal}")
                for name, a, b in zip(("out", "dq", "dk", "dv"), *grads)]
        log(f"[flash] autograd vs dense_attention, fp32 S=256 "
            f"causal={causal}: max|err| out/dq/dk/dv "
            f"{' '.join(f'{e:.3e}' for e in errs)} (tolerance 1e-4)")


# ---------------------------------------------------------------- phase 6

def check_flash_at(inputs, causal: bool) -> dict:
    """The kernels against their plain versions on one input set of the
    training shape (``time_flash``'s first): ``out`` and ``lse`` come
    from ``flash_fwd``, the backward kernels read the plain lse and
    delta.  Returns the max absolute error per kernel."""
    from mpi_tensorflow_torch.ops import flash_attention as fa

    q, k, v, do, out, lse, _ = inputs
    atol, rtol = TOL[q.dtype]
    B, Hh, S, Dd = q.shape
    what = f"{str(q.dtype)[6:]} S={S} B={B} H={Hh} D={Dd} causal={causal}"
    r_out, r_lse = fa.flash_forward_reference(q, k, v, causal=causal)
    delta = (do.float() * r_out.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, do, r_lse, delta, causal=causal)
    dk, dv = fa.flash_dkdv(q, k, v, do, r_lse, delta, causal=causal)
    torch.cuda.synchronize(q.device)
    r_dq, r_dk, r_dv = fa.flash_backward_reference(
        q, k, v, do, r_lse, delta, causal=causal)
    tol, tol32 = (atol, rtol), TOL[torch.float32]
    pairs = {"flash_fwd": (("out", out, r_out, tol),
                           ("lse", lse, r_lse, tol32)),
             "flash_dq": (("dq", dq, r_dq, tol),),
             "flash_dkdv": (("dk", dk, r_dk, tol), ("dv", dv, r_dv, tol))}
    errs, notes = {}, []
    for name, parts in pairs.items():
        errs[name] = max(check_close(got, want, *t, f"{name} {part} {what}")
                         for part, got, want, t in parts)
        # how many elements differ at all, and the size of what is held
        notes += [f"{part} {int((got != want).sum())} of {got.numel()} "
                  f"differ, max|plain| {float(want.float().abs().max()):.3g}"
                  for part, got, want, _ in parts]
    log(f"[flash] {what}: " + "; ".join(notes))
    return errs


def time_flash(dev) -> dict:
    """Each flash kernel at the training shape (B=4, H=12, S=4096, D=64,
    bf16), causal and not: held against its plain version on the first
    input set (``check_flash_at``), then device ms over 3 rotating input
    sets (100 MB each, past the 50 MB L2) and ms per call back to back
    (CUDA events), the plain version's wall ms, SDPA's forward and
    backward device ms, and the bound.  Returns {kernel: {causal:
    numbers}}."""
    from mpi_tensorflow_torch.ops import flash_attention as fa

    B, Hh, S, Dd = 4, 12, 4096, 64
    dt = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(2)
    saved = flash_counts()
    res = {k: {} for k in FLASH}
    for causal in (False, True):
        sets = []
        for _ in range(3):
            q, k, v, do = (torch.randn((B, Hh, S, Dd), generator=g,
                                       device=dev).to(dt) for _ in range(4))
            out, lse = fa.flash_fwd(q, k, v, causal=causal)
            delta = (do.float() * out.float()).sum(-1)
            sets.append((q, k, v, do, out, lse, delta))
        errs = check_flash_at(sets[0], causal)
        calls = {
            "flash_fwd": (lambda q, k, v, do, out, lse, delta:
                          fa.flash_fwd(q, k, v, causal=causal)),
            "flash_dq": (lambda q, k, v, do, out, lse, delta:
                         fa.flash_dq(q, k, v, do, lse, delta,
                                     causal=causal)),
            "flash_dkdv": (lambda q, k, v, do, out, lse, delta:
                           fa.flash_dkdv(q, k, v, do, lse, delta,
                                         causal=causal)),
        }
        # the plain backward computes dq, dk and dv in one call: its time
        # stands beside both backward kernels
        plain_fwd = wall_ms(lambda q, k, v, *_: fa.flash_forward_reference(
            q, k, v, causal=causal), sets[:1], reps=1)
        plain_bwd = wall_ms(
            lambda q, k, v, do, out, lse, delta: fa.flash_backward_reference(
                q, k, v, do, lse, delta, causal=causal), sets[:1], reps=1)
        plain = {"flash_fwd": plain_fwd, "flash_dq": plain_bwd,
                 "flash_dkdv": plain_bwd}
        # the yardstick: SDPA's forward, and its backward from a saved
        # forward (one call computes dq, dk and dv together)
        lib_fwd = device_ms(lambda q, k, v, *_: sdpa(q, k, v,
                                                     is_causal=causal),
                            sets, reps=2)
        graphs = []
        for q_, k_, v_, do_, *_ in sets:
            xs = [t.detach().clone().requires_grad_(True)
                  for t in (q_, k_, v_)]
            graphs.append((sdpa(*xs, is_causal=causal), xs, do_))
        lib_bwd = device_ms(lambda o, xs, do_: torch.autograd.grad(
            o, xs, do_, retain_graph=True), graphs, reps=2)
        del graphs
        esize = 2
        bhsd, bhs = B * Hh * S * Dd * esize, B * Hh * S * 4
        io = {"flash_fwd": 4 * bhsd + bhs,            # q k v in, out, lse
              "flash_dq": 5 * bhsd + 2 * bhs,         # q k v dO in, dq
              "flash_dkdv": 6 * bhsd + 2 * bhs}       # ... dk, dv out
        mults = {"flash_fwd": 4, "flash_dq": 6, "flash_dkdv": 8}
        for name in FLASH:
            ops = mults[name] * B * Hh * S * S * Dd / (2 if causal else 1)
            bound_ms, bound_by = bound(io[name], ops, dt)
            res[name][causal] = {
                "ms": device_ms(calls[name], sets, reps=2,
                                kernels_per_call=1),
                "call_ms": wall_ms(calls[name], sets, reps=2),
                "plain_ms": plain[name],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_fwd if name == "flash_fwd" else None,
                "library_bwd_ms": lib_bwd,
                "max_abs_err_train_shape": errs[name]}
            r = res[name][causal]
            log(f"[flash] {name} B={B} H={Hh} S={S} D={Dd} bf16 "
                f"causal={causal}: max|kernel - plain| {errs[name]:.3e} "
                f"(tolerance {TOL[dt][0]} abs + {TOL[dt][1]} rel; lse "
                f"{TOL[torch.float32][0]} abs); "
                f"kernel {r['ms']:.4f} ms on the device "
                f"({r['call_ms']:.4f} ms per call back to back), plain "
                f"{r['plain_ms']:.3f} ms per call, bound "
                f"{bound_ms:.4f} ms ({bound_by}: {io[name]} B, {ops:.4g} "
                f"ops); sdpa forward {lib_fwd:.4f} ms, sdpa backward "
                f"(dq, dk, dv together) {lib_bwd:.4f} ms on the device")
        del sets
    set_flash_counts(saved)              # timing is not the main path
    return res


# ---------------------------------------------------------------- phase 7

TRAIN_SEQ, TRAIN_BATCH, TRAIN_N, TEST_N, LOG_EVERY = 4096, 4, 32, 8, 4


def train_full_width(dev) -> dict:
    """BERT_BASE widths, bf16, S=4096, batch 4, dropout 0.1, through
    ``train_mlm``.  Returns the flash launches of the run."""
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.train import mlm_loop
    from mpi_tensorflow_torch.utils import flops

    cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.bfloat16,
                              max_positions=TRAIN_SEQ)
    config = Config(model="bert_base", dataset="mlm_synthetic", epochs=1,
                    batch_size=TRAIN_BATCH, log_every=LOG_EVERY,
                    precision="bf16")
    torch.cuda.reset_peak_memory_stats(dev)
    set_flash_counts({k: 0 for k in FLASH})
    res = mlm_loop.train_mlm(config, cfg, seq_len=TRAIN_SEQ,
                             train_n=TRAIN_N, test_n=TEST_N, device=dev)
    torch.cuda.synchronize(dev)
    launches = flash_counts()
    steps = res.num_steps
    eval_forwards = len(res.history) * -(-min(TEST_N, 4 * TRAIN_BATCH)
                                         // TRAIN_BATCH)
    want = {"flash_fwd": cfg.layers * (steps + eval_forwards),
            "flash_dq": cfg.layers * steps,
            "flash_dkdv": cfg.layers * steps}
    if launches != want:
        raise AssertionError(f"flash launches {launches} != {want} (12 "
                             f"layers x {steps} steps, {eval_forwards} "
                             f"eval forwards)")
    if not np.isfinite(res.final_loss):
        raise AssertionError(f"non-finite training loss {res.final_loss}")
    if [t for t, _ in res.history] != [4, 7]:
        raise AssertionError(f"unexpected history {res.history}")
    model_flops = flops.transformer_train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    log("[train] " + json.dumps({
        "layers": cfg.layers, "hidden": cfg.hidden, "heads": cfg.heads,
        "vocab": cfg.vocab_size, "precision": "bf16", "seq_len": TRAIN_SEQ,
        "batch": TRAIN_BATCH, "dropout": cfg.dropout, "steps": steps,
        "history": res.history, "final_loss": res.final_loss,
        "step_ms": res.step_time_seconds * 1e3,
        "tokens_per_sec": res.tokens_per_sec,
        "model_flops_per_step": model_flops,
        "mfu_bf16": flops.mfu(model_flops, res.step_time_seconds, "bf16"),
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": launches}))
    return launches


# ---------------------------------------------------------------- phase 8

def cross_check_train(dev) -> None:
    """float32, 2 layers at full width, S=512, B=2, dropout 0: the loss
    and gradients at the start, and the losses and parameters of three
    train steps, with ``attention="flash"`` against ``"dense"``."""
    from mpi_tensorflow_torch.data import synthetic
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.train import gspmd, optimizer

    cfg = dataclasses.replace(bert.BERT_BASE, layers=2, dropout=0.0)
    tokens, targets, mask = synthetic.mlm_batches(
        6, seq_len=512, vocab_size=cfg.vocab_size, seed=5)
    put = lambda a: torch.from_numpy(a).to(dev)
    batches = [({"tokens": put(tokens[i:i + 2]), "mask": put(mask[i:i + 2])},
                put(targets[i:i + 2])) for i in (0, 2, 4)]
    saved = flash_counts()
    runs = {}
    for attention in ("flash", "dense"):
        model = bert.BertMlm.from_seed(cfg, 0, attention).to(dev)
        loss = model.loss(*batches[0], train=True)
        loss.backward()
        grads = [p.grad.clone() for p in model.parameters()]
        model.zero_grad(set_to_none=True)
        tx = optimizer.transformer_tx(1e-4, 3)
        state = gspmd.init_state(model, tx)
        step = gspmd.make_train_step(tx)
        losses = [float(step(state, *b)[1]["loss"]) for b in batches]
        runs[attention] = (float(loss), grads, losses,
                           [p.detach() for p in model.parameters()],
                           [n for n, _ in model.named_parameters()])
    set_flash_counts(saved)
    (l_f, g_f, ls_f, p_f, names), (l_d, g_d, ls_d, p_d, _) = (
        runs["flash"], runs["dense"])
    if abs(l_f - l_d) > 1e-4 or max(abs(a - b)
                                    for a, b in zip(ls_f, ls_d)) > 1e-4:
        raise AssertionError(f"flash vs dense losses differ: {l_f} "
                             f"{ls_f} vs {l_d} {ls_d} (tolerance 1e-4)")
    g_err = max(float((a - b).abs().max()) for a, b in zip(g_f, g_d))
    if g_err > 1e-4:
        raise AssertionError(f"flash vs dense gradients differ by {g_err} "
                             f"(tolerance 1e-4)")
    # bk's gradient is zero in exact arithmetic (the softmax ignores a
    # per-query constant): adamw normalises each side's float noise, so
    # bk is held to the steps' reach, 3 x lr; every other leaf to 1e-5
    p_err, bk_err = 0.0, 0.0
    for name, a, b in zip(names, p_f, p_d):
        e = float((a - b).abs().max())
        if name.endswith(".bk"):
            bk_err = max(bk_err, e)
        else:
            p_err = max(p_err, e)
    if p_err > 1e-5 or bk_err > 3e-4:
        raise AssertionError(f"flash vs dense parameters differ by {p_err} "
                             f"(bk {bk_err}) after 3 steps")
    log(f"[train cross-check] fp32, 2 layers, S=512, B=2: loss "
        f"{l_f:.6f} vs {l_d:.6f}, step losses max|diff| "
        f"{max(abs(a - b) for a, b in zip(ls_f, ls_d)):.3e}, gradients "
        f"max|diff| {g_err:.3e} (tolerance 1e-4), parameters after 3 "
        f"steps max|diff| {p_err:.3e} (tolerance 1e-5; bk {bk_err:.3e}, "
        f"tolerance 3e-4)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda reports no card; nothing was run",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    from mpi_tensorflow_torch.utils.device import resolve_device

    resolve_device(dev)                  # TF32 off for float32 products
    build()
    worst = check_kernel(dev)
    timing = time_decode(dev)
    launches = serve_full_width(dev)
    cross_check(dev)
    flash_worst = check_flash(dev)
    check_flash_grads(dev)
    flash_timing = time_flash(dev)
    flash_launches = train_full_width(dev)
    cross_check_train(dev)
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "mpi_tensorflow_torch/ops/csrc/paged_attention.cu",
        "replaces": "mpi_tensorflow_tpu/ops/paged_attention_kernel.py:90",
        "launches": launches,
        "max_abs_err": max(worst.values()),
        "max_abs_err_fp32": worst[torch.float32],
        "max_abs_err_bf16": worst[torch.bfloat16],
        **timing,
    }]
    for name in FLASH:
        t = flash_timing[name]
        flash_worst[name, torch.bfloat16] = max(
            flash_worst[name, torch.bfloat16],
            *(t[c]["max_abs_err_train_shape"] for c in (False, True)))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mpi_tensorflow_torch/ops/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": flash_launches[name],
            "max_abs_err": max(flash_worst[name, torch.float32],
                               flash_worst[name, torch.bfloat16]),
            "max_abs_err_fp32": flash_worst[name, torch.float32],
            "max_abs_err_bf16": flash_worst[name, torch.bfloat16],
            **t[False],                  # the main path is not causal
            "causal": t[True]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
