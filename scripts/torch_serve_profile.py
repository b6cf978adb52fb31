#!/usr/bin/env python3
"""Where the port's serving time goes, on one NVIDIA card.

    python3 scripts/torch_serve_profile.py

Serves the bench's default Poisson trace (24 requests at 4 rps, prompts
<= 32, outputs <= 128, seed 0) through ``mpi_tensorflow_torch``'s
``PagedDecodeEngine`` at ``BERT_BASE`` geometry in bfloat16, with the
CUDA paged-attention kernel and with the gather path (the control arm),
in turns (cuda, gather, gather, cuda) after one warmup replay each, and
prints one JSON line per timed replay.  Then it replays once more per
arm under ``torch.profiler``, serving the trace's first
``PROFILE_REQUESTS`` requests, and prints the device time by kernel
category, the top kernels, the kernels launched per forward dispatch and
the device's idle share of the window (1 - union of kernel intervals /
window).  Profiled replays are slower than the timed ones; only their
shares and counts are read.
"""

from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serve_profile: no card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    arms = {}
    for kernel in ("cuda", "gather"):
        engine, trace = build_serving(precision="bf16", kernel=kernel,
                                      device="cuda")
        engine.run(trace.requests())     # warmup (kernel build, caches)
        arms[kernel] = (engine, trace)
    for kernel in ("cuda", "gather", "gather", "cuda"):
        res = replay(*arms[kernel])
        print(json.dumps({
            "arm": kernel, "card": card,
            "tokens_per_sec": res["tokens_per_sec"],
            "p50_token_latency_ms": res["p50_token_latency_ms"],
            "p99_token_latency_ms": res["p99_token_latency_ms"],
            "tokens": res["tokens"], "elapsed_s": res["elapsed_s"],
            "forward_dispatches": res["forward_dispatches"],
            "wall_ms_per_forward_dispatch":
                res["elapsed_s"] * 1e3 / res["forward_dispatches"]}),
            flush=True)
    for kernel in ("cuda", "gather"):
        print(json.dumps({"profile": kernel, **profile(*arms[kernel])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
