"""``python -m mpi_tensorflow_torch.serving`` — serve one seeded trace.

The port's counterpart of the timed engine arm of the reference's
``bench.py --mode serving``, with the reference's flags where they
apply.  One untimed warmup replay, then the timed replay; prints ONE
JSON line: throughput, per-token latency percentiles, the resolved
kernel, the pool's ``kv_dtype``, the CUDA kernel's launches in the timed
replay, the device, ``dispatches_per_token`` and the ``prefix``,
``speculation`` and ``tier`` blocks.  With ``--serve-prefix-gen on`` the
trace gains the reference bench's seeded follow-up turn (a discovery
replay learns each answer first).  Runs on the card unless ``--device
cpu``.

    python -m mpi_tensorflow_torch.serving                     # BERT_BASE
    python -m mpi_tensorflow_torch.serving --serve-tiny --device cpu \\
        --requests 2 --prompt-len 8 --new-tokens 4 --arrival-rate 1000 \\
        --serve-kv-dtype int4
    python -m mpi_tensorflow_torch.serving --serve-prefix-cache on \\
        --serve-prefix-tokens 64 --serve-kv-tier host
    python -m mpi_tensorflow_torch.serving --serve-mixed-batch on \\
        --serve-prefill-budget 32
    python -m mpi_tensorflow_torch.serving --serve-speculative ngram \\
        --serve-draft-k 4 --serve-draft-auto on
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from mpi_tensorflow_torch.ops import paged_attention_kernel as pk
from mpi_tensorflow_torch.serving.harness import (build_serving,
                                                  two_turn_requests)


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
    ap.add_argument("--serve-prefix-cache", choices=["off", "on"],
                    default=None,
                    help="radix prefix cache: on maps cached full prompt "
                         "blocks into new requests (copy-on-write, LRU "
                         "trie eviction; default off)")
    ap.add_argument("--serve-prefix-tokens", type=int, default=0,
                    help="prepend one shared N-token system prompt to "
                         "every request (default 0)")
    ap.add_argument("--serve-prefix-gen", choices=["off", "on"],
                    default=None,
                    help="prefix cache v2: on also caches generated "
                         "blocks and copies partial tail blocks, and the "
                         "trace gains one follow-up turn (needs the "
                         "prefix cache)")
    ap.add_argument("--serve-kv-tier", choices=["off", "host"],
                    default=None,
                    help="host: demote evicted trie blocks to host memory "
                         "and promote them back on a match (needs the "
                         "prefix cache)")
    ap.add_argument("--serve-mixed-batch", choices=["off", "on"],
                    default=None,
                    help="on: decode rows and budget-capped prefill "
                         "chunks of several requests in one forward a "
                         "step (default off)")
    ap.add_argument("--serve-prefill-budget", type=int, default=None,
                    help="mixed batching: prefill tokens a step may fuse "
                         "(default 64)")
    ap.add_argument("--serve-speculative",
                    choices=["off", "ngram", "draft-model"], default=None,
                    help="speculative decoding: draft tokens, verify them "
                         "in one forward; greedy tokens stay those of off "
                         "(serves a rope-position model)")
    ap.add_argument("--serve-draft-k", type=int, default=None,
                    help="tokens drafted a verify forward (default 4)")
    ap.add_argument("--serve-draft-auto", choices=["off", "on"],
                    default=None,
                    help="on: tune the draft window by the accepted "
                         "length, within [1, draft k]")
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
        prefix_cache=args.serve_prefix_cache,
        prefix_tokens=args.serve_prefix_tokens,
        prefix_gen=args.serve_prefix_gen, kv_tier=args.serve_kv_tier,
        mixed_batch=args.serve_mixed_batch,
        prefill_budget=args.serve_prefill_budget,
        speculative=args.serve_speculative, draft_k=args.serve_draft_k,
        draft_auto=args.serve_draft_auto, device=args.device)
    if engine.serve.prefix_gen == "on":
        turns = two_turn_requests(engine, trace)
        requests = lambda: [dataclasses.replace(r) for r in turns]
    else:
        requests = trace.requests
    engine.run(requests())                # warmup (lazy builds, caches)
    engine.reset()
    pk.paged_attention_kernel.launches = 0
    res = engine.run(requests())
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
        "dispatches_per_token": res["dispatches_per_token"],
        "prefix": res["prefix"],
        "speculation": res["speculation"],
        "tier": res["tier"],
        "requests": len(res["statuses"]),
        "ok_requests": sum(s == "ok" for s in res["statuses"].values()),
        "layers": cfg.layers, "hidden": cfg.hidden,
        "precision": args.precision,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
