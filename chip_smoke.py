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
   tokens must be identical to each other and to ``CausalLm.generate``.

Prints one ``kernels`` JSON line, then the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``.  Without a card it
prints no result and exits 1.
"""

from __future__ import annotations

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
            if "registers" in line or "spill" in line or "smem" in line:
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


def device_ms(fn, inputs, reps: int) -> float:
    """Mean device time per call of ``fn(*x)``: the durations of the
    kernels it launched, from ``torch.profiler``, over ``reps`` passes
    through ``inputs``.  Rotating through input sets larger than the
    50 MB L2 finds every set's pool cold, as the engine finds each
    layer's pool."""
    from torch.profiler import ProfilerActivity, profile

    for x in inputs:
        fn(*x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for x in inputs:
                fn(*x)
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return us / 1e3 / (reps * len(inputs))


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
    ms = device_ms(kern, sets, reps=20)
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
    bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                   ops / PEAK_OPS_PER_S[dt]) * 1e3
    bound_by = ("bytes" if nbytes / PEAK_BYTES_PER_S
                >= ops / PEAK_OPS_PER_S[dt] else "operations")
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
    print(json.dumps({"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "mpi_tensorflow_torch/ops/csrc/paged_attention.cu",
        "replaces": "mpi_tensorflow_tpu/ops/paged_attention_kernel.py:90",
        "launches": launches,
        "max_abs_err": max(worst.values()),
        "max_abs_err_fp32": worst[torch.float32],
        "max_abs_err_bf16": worst[torch.bfloat16],
        **timing,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
