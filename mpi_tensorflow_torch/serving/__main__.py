"""``python -m mpi_tensorflow_torch.serving`` — serve one seeded trace.

The port's counterpart of the timed engine arm of the reference's
``bench.py --mode serving``, with the reference's flags where they
apply.  One untimed warmup replay, then the timed replay; prints ONE
JSON line: throughput, per-token latency percentiles, the resolved
kernel, the pool's ``kv_dtype``, the CUDA kernel's launches in the timed
replay, and the device.
Runs on the card unless ``--device cpu``.

    python -m mpi_tensorflow_torch.serving                     # BERT_BASE
    python -m mpi_tensorflow_torch.serving --serve-tiny --device cpu \\
        --requests 2 --prompt-len 8 --new-tokens 4 --arrival-rate 1000 \\
        --serve-kv-dtype int4
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from mpi_tensorflow_torch.ops import paged_attention_kernel as pk
from mpi_tensorflow_torch.serving.harness import build_serving


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mpi_tensorflow_torch.serving",
        description="Continuous-batching serving over the paged KV cache "
                    "(one warmup replay, one timed replay, one JSON line).")
    ap.add_argument("--requests", type=int, default=24,
                    help="requests in the Poisson trace")
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="mean arrivals per second")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="longest prompt (lengths uniform in [8, max])")
    ap.add_argument("--new-tokens", type=int, default=128,
                    help="longest output (budgets uniform in [8, max])")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="decode slots (default: serve_max_slots = 8)")
    ap.add_argument("--precision", choices=["fp32", "bf16"], default="fp32",
                    help="compute dtype (of the pool too, under "
                         "--serve-kv-dtype fp32)")
    ap.add_argument("--serve-tiny", action="store_true",
                    help="BERT_TINY geometry instead of BERT_BASE")
    ap.add_argument("--serve-kernel", choices=["auto", "gather", "cuda"],
                    default=None,
                    help="paged-attention lowering (auto: the CUDA kernel "
                         "on the card, the gather path on the CPU)")
    ap.add_argument("--serve-block-size", type=int, default=None,
                    help="cache entries per pool block (default 16)")
    ap.add_argument("--serve-pool-blocks", type=int, default=None,
                    help="pool blocks (default: every slot at full length)")
    ap.add_argument("--serve-kv-dtype", choices=["fp32", "int8", "int4"],
                    default=None,
                    help="pool storage: fp32 keeps the compute dtype; "
                         "int8 stores row-scaled codes; int4 packs two "
                         "codes per byte with group scales and serves "
                         "each token's own K/V at full precision "
                         "(default fp32)")
    ap.add_argument("--serve-kv-group", type=int, default=None,
                    help="int4 scale-group size along head_dim (clamped "
                         "to head_dim, must divide it; default 32)")
    ap.add_argument("--seed", type=int, default=0, help="trace seed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card fails")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    engine, trace = build_serving(
        num_requests=args.requests, rate_rps=args.arrival_rate,
        prompt_max=args.prompt_len, output_max=args.new_tokens,
        max_slots=args.batch_size, precision=args.precision,
        tiny=args.serve_tiny, kernel=args.serve_kernel,
        block_size=args.serve_block_size,
        pool_blocks=args.serve_pool_blocks, seed=args.seed,
        kv_dtype=args.serve_kv_dtype, kv_group=args.serve_kv_group,
        device=args.device)
    engine.run(trace.requests())          # warmup (lazy builds, caches)
    engine.reset()
    pk.paged_attention_kernel.launches = 0
    res = engine.run(trace.requests())
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    launches = pk.paged_attention_kernel.launches
    cfg = engine.model.cfg
    print(json.dumps({
        "tokens_per_sec": res["tokens_per_sec"],
        "p50_token_latency_ms": res["p50_token_latency_ms"],
        "p99_token_latency_ms": res["p99_token_latency_ms"],
        "kernel": res["kernel"],
        "kv_dtype": res["kv_dtype"],
        "launches": launches,
        "device": res["device"],
        "tokens": res["tokens"],
        "elapsed_s": res["elapsed_s"],
        "forward_dispatches": res["forward_dispatches"],
        "requests": args.requests,
        "ok_requests": sum(s == "ok" for s in res["statuses"].values()),
        "layers": cfg.layers, "hidden": cfg.hidden,
        "precision": args.precision,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
