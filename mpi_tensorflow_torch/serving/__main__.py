"""``python -m mpi_tensorflow_torch.serving`` — serve one seeded trace.

The port's counterpart of the reference's ``bench.py --mode serving``,
with its flags (``serving/harness.add_serving_args``): the timed engine
arm after an untimed warmup replay, the static-batch arm, and the
fleet, prefix-route, journaled, tensor-parallel and A/B arms the flags
ask for
(``harness.measure_serving``, which ``python -m
mpi_tensorflow_torch.bench --mode serving`` runs too).  Prints ONE JSON
line: throughput, per-token latency percentiles, the resolved kernel,
the pool's ``kv_dtype``, the CUDA kernel's launches in the timed run,
``dispatches_per_token``, the ``prefix``, ``speculation``, ``tier``,
``goodput``, ``autoscale`` and ``faults`` blocks, and those of the arms
that ran (``replicas``, ``prefix_route``, ``breakdown``, ``trace``,
``kernel_ab``, ``kv_quant``, ``spec_ab``, ``mixed_ab``, the journaled
modes' ``outputs`` and ``statuses``), ``static_batch_tokens_per_sec``
and ``speedup_vs_static``.  Runs on the card unless ``--device cpu``.

    python -m mpi_tensorflow_torch.serving                     # BERT_BASE
    python -m mpi_tensorflow_torch.serving --serve-tiny --device cpu \\
        --requests 2 --prompt-len 8 --new-tokens 4 --arrival-rate 1000 \\
        --serve-kv-dtype int4
    python -m mpi_tensorflow_torch.serving --serve-prefix-cache on \\
        --serve-prefix-tokens 64 --serve-kv-tier host
    python -m mpi_tensorflow_torch.serving --serve-replicas 2 \\
        --serve-fault-replica 0 --serve-fault-step 3
    python -m mpi_tensorflow_torch.serving --serve-journal /tmp/j.jsonl
    python -m mpi_tensorflow_torch.serving --serve-trace on \\
        --serve-trace-out /tmp/trace.json
    python -m mpi_tensorflow_torch.serving --serve-kernel-ab
    python -m mpi_tensorflow_torch.serving --serve-kv-ab \\
        [--serve-kv-dtype int4]
    python -m mpi_tensorflow_torch.serving --serve-speculative ngram \\
        --serve-spec-ab
    python -m mpi_tensorflow_torch.serving --serve-mixed-batch on \\
        --serve-mixed-ab
    torchrun --nproc_per_node 2 -m mpi_tensorflow_torch.serving \\
        --serve-tp 2 [--serve-replicas 2] [--serve-journal /tmp/j.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys

from mpi_tensorflow_torch.serving import harness


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mpi_tensorflow_torch.serving",
        description="Continuous-batching serving over the paged KV cache "
                    "(one warmup replay, one timed replay, one JSON line).")
    harness.add_serving_args(ap)
    args = ap.parse_args(argv)
    harness.check_serving_args(ap, args)
    return args


def main(argv=None) -> int:
    det = harness.measure_serving(parse_args(argv))
    if det["rank"] == 0:
        print(json.dumps(det), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
