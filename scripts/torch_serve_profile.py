#!/usr/bin/env python3
"""Where the port's serving time goes, on one NVIDIA card.

    python3 scripts/torch_serve_profile.py [--kv-dtype fp32,int8,int4]

Serves the bench's default Poisson trace (24 requests at 4 rps, prompts
<= 32, outputs <= 128, seed 0) through ``mpi_tensorflow_torch``'s
``PagedDecodeEngine`` at ``BERT_BASE`` geometry in bfloat16.  The arms:
the CUDA paged-attention kernel over the pool in the compute dtype, the
gather path over it (the control arm), and the CUDA kernel over an int8
and an int4 pool (one arm per quantized ``--kv-dtype`` named).  After
one warmup replay each, the arms replay in turns, forward then backward
(A B C D D C B A), printing one JSON line per timed replay.  Then each
arm replays once more under ``torch.profiler``, serving the trace's
first ``PROFILE_REQUESTS`` requests, and prints the device time by
kernel category (the paged kernel's share among them), the top kernels,
the kernels launched per forward dispatch and the device's idle share of
the window (1 - union of kernel intervals / window).  Profiled replays
are slower than the timed ones; only their shares and counts are read.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpi_tensorflow_torch.serving.harness import build_serving  # noqa: E402
from mpi_tensorflow_torch.utils.profiling import (  # noqa: E402
    cuda_kernels, device_summary)

# the profiled replay serves the trace's first requests only: the
# profiler's post-processing of a full replay (~1M events) takes minutes
PROFILE_REQUESTS = 8


def replay(engine, trace) -> dict:
    engine.reset()
    res = engine.run(trace.requests())
    torch.cuda.synchronize()
    return res


def profile(engine, trace) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    engine.reset()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = engine.run(trace.requests()[:PROFILE_REQUESTS])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    summary = device_summary(cuda_kernels(prof))
    return {
        "kernel_events": summary["kernel_events"],
        "kernels_per_forward_dispatch":
            summary["kernel_events"] / max(1, res["forward_dispatches"]),
        "host_wall_ms": wall_us / 1e3,
        **{k: v for k, v in summary.items() if k != "kernel_events"},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kv-dtype", default="fp32,int8,int4",
                    help="comma-separated pool formats: fp32 gives the "
                         "cuda and gather arms, int8/int4 a cuda arm each")
    kv_dtypes = ap.parse_args(argv).kv_dtype.split(",")
    if not set(kv_dtypes) <= {"fp32", "int8", "int4"}:
        ap.error(f"--kv-dtype takes fp32, int8, int4; got {kv_dtypes}")
    if not torch.cuda.is_available():
        print("torch_serve_profile: no card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    names = [(k, dt) for dt in kv_dtypes
             for k in (("cuda", "gather") if dt == "fp32" else ("cuda",))]
    arms = {}
    for kernel, kv_dtype in names:
        engine, trace = build_serving(precision="bf16", kernel=kernel,
                                      kv_dtype=kv_dtype, device="cuda")
        engine.run(trace.requests())     # warmup (kernel build, caches)
        arms[kernel, kv_dtype] = (engine, trace)
    for kernel, kv_dtype in names + names[::-1]:
        res = replay(*arms[kernel, kv_dtype])
        print(json.dumps({
            "arm": kernel, "kv_dtype": kv_dtype, "card": card,
            "tokens_per_sec": res["tokens_per_sec"],
            "p50_token_latency_ms": res["p50_token_latency_ms"],
            "p99_token_latency_ms": res["p99_token_latency_ms"],
            "tokens": res["tokens"], "elapsed_s": res["elapsed_s"],
            "forward_dispatches": res["forward_dispatches"],
            "wall_ms_per_forward_dispatch":
                res["elapsed_s"] * 1e3 / res["forward_dispatches"]}),
            flush=True)
    for kernel, kv_dtype in names:
        print(json.dumps({"profile": kernel, "kv_dtype": kv_dtype,
                          **profile(*arms[kernel, kv_dtype])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
