"""The serving runs: ``python -m mpi_tensorflow_torch.serving``, ``python
-m mpi_tensorflow_torch.bench --mode serving`` and ``chip_smoke.py``.

The port's counterpart of the reference's ``bench.py --mode serving``
(``measure_serving``).  Both entry points parse the same flags
(``add_serving_args``, checked by ``check_serving_args``) and run
``measure_serving``, which returns one dict: the engine arm's flat
numbers and the reference bench's detail keys for this slice's blocks.

``build_serving`` builds the engine and the trace: the same model
geometry (``CausalLm`` at ``BERT_BASE``, or ``BERT_TINY``), the same
seeded Poisson trace (``loadgen``, vocabulary of the model), and the
same sizing rules — ``max_seq_len`` is the power of two at or above the
longest request, and the default pool holds every slot at full length
(no eviction churn).  Weights are random, drawn from seed 0.
``kv_quant_report`` is the reference bench's ``--serve-kv-ab`` block:
a quantized run held against the compute-dtype run of the same trace.

The features take the reference bench's sizing: ``prefix_tokens``
prepends one shared system prompt to every request; ``prefix_gen`` adds
one seeded follow-up turn to the trace (``two_turn_requests``) and sizes
``max_seq_len`` for it; ``speculative`` serves a rope-position model (an
untrained model with learned positions emits an aperiodic stream, the
degenerate case for any drafter).

The admission policy is the reference's ``--serve-*`` fault flags:
``--serve-deadline-ms`` (a TTL stamped on each request at submit:
``deadline_exceeded``), ``--serve-queue-depth`` (a full waiting queue
sheds the newest submit: ``shed``), ``--serve-max-evictions``
(``evicted_too_often``), ``--serve-drain-ms`` (after SIGTERM, in-flight
work finishes within the budget, the rest ends ``drained``) and
``--serve-failover-backoff-ms`` (the router's probe backoff); the
detail's ``status_counts`` and ``drain`` say what each did.

``measure_serving``'s arms, as the reference bench runs them:

- the engine arm: an untimed warmup replay, then the timed replay under
  a ``PreemptionGuard`` (SIGTERM drains) with a ``ScaleAdvisor``; the
  ``goodput`` block joins the trace's SLOs with the run
  (``loadgen.per_request_rows``), and with tracing on the ``breakdown``
  and ``trace`` blocks (and the Chrome trace at ``--serve-trace-out``);
- ``--serve-replicas N``: the fleet arm after it, the same trace
  through ``N`` replicas behind ``serving/router.ReplicaRouter`` (a
  warmup replay, then the timed one with the ``FaultPlan`` of
  ``--serve-fault-*``): ``replicas`` with ``speedup_vs_single_replica``;
- ``--serve-prefix-route on``: a 2-replica fleet with the prefix hint on
  and off (``prefix_route``);
- ``--serve-journal P``: no warmup, one journaled run through
  ``recovery.run_with_replay`` (with ``--serve-replicas N``: the router
  over per-replica journals ``P.r<i>``); a run killed and relaunched on
  the same journal resumes, token-identical to an unfaulted one;
- the static-batch arm after the timed one (not under a journal):
  ``generate`` on arrival-order groups of ``max_slots`` requests, each
  left-padded (repeating its first token) to the power of two at or
  above its longest prompt and decoded to its longest output budget
  through a cache of that prompt + budget; one untimed pass over every
  group, then the timed one: ``static_batch_tokens_per_sec`` (the
  trace's requested tokens over its time) and ``speedup_vs_static``;
- the A/B arms, one comparison a run (``check_serving_args`` holds the
  reference's exclusions), each replaying the same trace through an
  engine that differs in one setting, after its own untimed warmup:
  ``--serve-kernel-ab`` the other lowering (``cuda`` against
  ``gather``; ``kernel_ab``), ``--serve-kv-ab`` the quantized pool
  against the compute dtype's (``kv_quant``), ``--serve-spec-ab``
  speculation off (``spec_ab``), ``--serve-mixed-ab`` mixed batching
  off (``mixed_ab``);
- ``--serve-tp T`` under ``torchrun --nproc_per_node T``: every arm on
  each rank (``serving/tp``), rank 0 reporting; a fleet (replicas, the
  prefix route) runs in lock step on rank 0's clock, and a journal is
  rank 0's file, mirrored on the other ranks (``recovery.ReplayJournal``).

The reference's ``ab_zero_recompile`` (and ``compile_counts``) has no
counterpart: eager PyTorch compiles nothing, so those keys are
``null``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.models import bert
from mpi_tensorflow_torch.models.gpt import CausalLm
from mpi_tensorflow_torch.ops import paged_attention_kernel as pk
from mpi_tensorflow_torch.parallel import mesh as meshlib
from mpi_tensorflow_torch.serving import autoscale, loadgen, recovery
from mpi_tensorflow_torch.serving import tp as tp_lib
from mpi_tensorflow_torch.serving import tracing as tracing_lib
from mpi_tensorflow_torch.serving.engine import (PagedDecodeEngine,
                                                 ServeConfig, pow2_ceil)
from mpi_tensorflow_torch.serving.paged_cache import blocks_for
from mpi_tensorflow_torch.serving.router import (FaultPlan, ReplicaFault,
                                                 ReplicaRouter)
from mpi_tensorflow_torch.train.preemption import PreemptionGuard
from mpi_tensorflow_torch.utils import metrics_writer
from mpi_tensorflow_torch.utils.metrics_writer import kv_quant_block

#: the A/B flags: each replays the trace through its own control arm
AB_FLAGS = ("serve_kernel_ab", "serve_kv_ab", "serve_spec_ab",
            "serve_mixed_ab")


def build_serving(*, num_requests: int = 24, rate_rps: float = 4.0,
                  prompt_max: int = 32, output_max: int = 128,
                  max_slots: Optional[int] = None,
                  precision: str = "fp32", tiny: bool = False,
                  kernel: Optional[str] = None,
                  block_size: Optional[int] = None,
                  pool_blocks: Optional[int] = None,
                  layers: Optional[int] = None, seed: int = 0,
                  kv_dtype: Optional[str] = None,
                  kv_group: Optional[int] = None,
                  prefix_cache: Optional[str] = None,
                  prefix_tokens: int = 0,
                  prefix_gen: Optional[str] = None,
                  kv_tier: Optional[str] = None,
                  mixed_batch: Optional[str] = None,
                  prefill_budget: Optional[int] = None,
                  speculative: Optional[str] = None,
                  draft_k: Optional[int] = None,
                  draft_auto: Optional[str] = None,
                  prefix_route: Optional[str] = None,
                  workload: Optional[str] = None,
                  slo_ms: Optional[float] = None, tp: Optional[int] = None,
                  trace_mode: Optional[str] = None,
                  trace_out: Optional[str] = None,
                  deadline_ms: Optional[float] = None,
                  queue_depth: Optional[int] = None,
                  max_evictions: Optional[int] = None,
                  drain_ms: Optional[float] = None,
                  failover_backoff_ms: Optional[float] = None,
                  device="cuda"):
    """-> ``(engine, trace)``.  Unset knobs resolve through ``Config``'s
    ``serve_*`` defaults; ``layers`` cuts the model's depth (widths stay
    the preset's).  Under ``tp > 1`` this process is one rank of the
    world, and the engine keeps its shard of the model.  The admission
    policy (``deadline_ms``, ``queue_depth``, ``max_evictions``,
    ``drain_ms``, ``failover_backoff_ms``) goes through ``Config`` to the
    engine's ``ServeConfig``."""
    policy = {k: v for k, v in (
        ("serve_deadline_ms", deadline_ms),
        ("serve_queue_depth", queue_depth),
        ("serve_max_evictions", max_evictions),
        ("serve_drain_ms", drain_ms),
        ("serve_failover_backoff_ms", failover_backoff_ms)) if v is not None}
    cfg = Config(precision=precision, **policy)
    max_slots = max_slots if max_slots is not None else cfg.serve_max_slots
    block_size = (block_size if block_size is not None
                  else cfg.serve_block_size)
    base = bert.BERT_TINY if tiny else bert.BERT_BASE
    bcfg = dataclasses.replace(base, dtype=cfg.compute_dtype,
                               layers=layers or base.layers)
    if (speculative or cfg.serve_speculative) != "off":
        bcfg = dataclasses.replace(bcfg, pos_kind="rope")
    gen = (prefix_gen or cfg.serve_prefix_gen) == "on"
    trace = loadgen.build_trace(loadgen.WorkloadSpec(
        workload=workload or cfg.serve_workload,
        num_requests=num_requests, rate_rps=rate_rps,
        prompt_max=prompt_max, output_max=output_max,
        vocab_size=bcfg.vocab_size, prefix_tokens=prefix_tokens,
        slo_ms=slo_ms if slo_ms is not None else cfg.serve_slo_ms,
        seed=seed, followup_turns=1 if gen else 0))
    max_len = max(len(p) + o for p, o in zip(trace.prompts, trace.outputs))
    if gen:
        # a follow-up turn is the prior prompt + its answer + a suffix
        # of at most min(8, prompt_max) tokens, then its own budget
        max_len = max(max_len,
                      max(len(p) + 2 * o for p, o in zip(trace.prompts,
                                                         trace.outputs))
                      + min(8, prompt_max))
    max_seq_len = pow2_ceil(max_len)
    if pool_blocks is None:
        pool_blocks = max_slots * blocks_for(max_seq_len, block_size) + 1
    serve = ServeConfig.from_config(
        cfg, num_blocks=pool_blocks, block_size=block_size,
        max_slots=max_slots, max_seq_len=max_seq_len, kernel=kernel,
        kv_dtype=kv_dtype, kv_group=kv_group, prefix_cache=prefix_cache,
        prefix_gen=prefix_gen, kv_tier=kv_tier, mixed_batch=mixed_batch,
        prefill_budget=prefill_budget, speculative=speculative,
        draft_k=draft_k, draft_auto=draft_auto, prefix_route=prefix_route,
        tp=tp, trace=trace_mode, trace_out=trace_out)
    engine = PagedDecodeEngine(CausalLm.from_seed(bcfg, seed=0), serve,
                               device=device)
    return engine, trace


def two_turn_requests(engine, trace) -> list:
    """The reference bench's multi-turn trace (``--serve-prefix-gen``):
    one discovery run of ``trace`` learns each request's answer (the
    engine is reset before and after it), then turn 1 followed by the
    seeded follow-up turn, whose prompts are the prior prompt + answer +
    a unique suffix, arriving after turn 1's last arrival.  ``trace``
    must carry one follow-up turn (``build_serving`` with prefix_gen)."""
    engine.reset()
    answers = engine.run(trace.requests())["outputs"]
    engine.reset()
    first = trace.requests()
    return first + trace.followup_requests(
        1, trace.requests(), answers, id_base=len(first),
        arrival_base=float(trace.arrivals[-1]))


def kv_quant_report(ref: dict, quant: dict, engine, trace) -> dict:
    """``metrics_writer.kv_quant_block`` for ``quant`` (a run of
    ``engine``, whose pool is int8 or int4) against ``ref`` (the
    compute-dtype run of the same trace and weights), with the reference
    bench's byte formulas (``bench.py`` ``--serve-kv-ab``): a block
    holds K and V rows of ``head_dim`` compute-dtype values, or of
    ``head_dim + 4`` bytes (int8: codes + one float32 scale), or of
    ``head_dim / 2 + 4 * head_dim / g`` bytes (int4); a decode token
    reads every live context row of every layer once."""
    cfg, serve = engine.model.cfg, engine.serve
    matched = compared = 0
    for rid, ref_out in ref["outputs"].items():
        q_out = quant["outputs"].get(rid, [])
        compared += max(len(ref_out), len(q_out))
        matched += sum(a == b for a, b in zip(ref_out, q_out))
    itemsize = cfg.dtype.itemsize
    rows = cfg.heads * serve.block_size
    if serve.kv_dtype == "int4":
        q_row = cfg.head_dim // 2 + 4 * (cfg.head_dim
                                         // min(serve.kv_group, cfg.head_dim))
    else:
        q_row = cfg.head_dim + 4
    mean_ctx = float(np.mean([len(p) + t + 1 for p, o in
                              zip(trace.prompts, trace.outputs)
                              for t in range(o)]))
    per_token = cfg.layers * 2 * cfg.heads * mean_ctx
    return kv_quant_block(
        kv_dtype=serve.kv_dtype, matched_tokens=matched,
        compared_tokens=compared,
        block_bytes_ref=2 * rows * cfg.head_dim * itemsize * cfg.layers,
        block_bytes=2 * rows * q_row * cfg.layers,
        num_blocks=serve.num_blocks,
        peak_live_blocks_ref=ref["peak_live_blocks"],
        peak_live_blocks=quant["peak_live_blocks"],
        bytes_per_decode_token_ref=per_token * cfg.head_dim * itemsize,
        bytes_per_decode_token=per_token * q_row)


# ------------------------------------------------------------ the flags

def add_serving_args(ap) -> None:
    """The serving flags of both entry points (the reference bench's
    names and meanings)."""
    ap.add_argument("--requests", type=int, default=24,
                    help="requests in the trace")
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
    ap.add_argument("--serve-prefix-route", choices=["off", "on"],
                    default=None,
                    help="on: add a 2-replica arm placing each request on "
                         "the replica whose trie holds its first block, "
                         "against the same fleet without the hint (needs "
                         "the prefix cache)")
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
    ap.add_argument("--serve-replicas", type=int, default=None,
                    help="N > 1: add the fleet arm, the trace through N "
                         "engine replicas behind the router (default 1)")
    ap.add_argument("--serve-tp", type=int, default=None,
                    help="tensor-parallel ranks; run under torchrun "
                         "--nproc_per_node T (default 1)")
    ap.add_argument("--serve-trace", choices=["off", "on"], default=None,
                    help="on: request spans and step records, the "
                         "breakdown and trace blocks (default off)")
    ap.add_argument("--serve-trace-out", default=None,
                    help="write the Chrome trace-event JSON here (needs "
                         "--serve-trace on)")
    ap.add_argument("--serve-journal", default=None,
                    help="journaled serve mode: replay journal path "
                         "(with --serve-replicas N: one journal a replica, "
                         "PATH.r<i>); a relaunch resumes from it")
    ap.add_argument("--serve-fault-replica", type=int, default=None,
                    help="inject a fault into this replica of the fleet")
    ap.add_argument("--serve-fault-step", type=int, default=None,
                    help="at this tick of the replica (1-based)")
    ap.add_argument("--serve-fault-kind", choices=["transient", "permanent"],
                    default="transient",
                    help="transient: ejected, probed back; permanent: "
                         "dead")
    ap.add_argument("--serve-workload", choices=list(loadgen.WORKLOADS),
                    default=None,
                    help="trace shape (default poisson)")
    ap.add_argument("--serve-slo-ms", type=float, default=None,
                    help="per-request latency budget: stamped as each "
                         "request's deadline, read by the goodput block")
    ap.add_argument("--serve-kernel-ab", action="store_true",
                    help="add the same trace through the other lowering "
                         "(cuda against gather), timed after its own "
                         "warmup: the kernel_ab block")
    ap.add_argument("--serve-kv-ab", action="store_true",
                    help="add the same trace through the quantized pool "
                         "(the run's --serve-kv-dtype, else int8) and the "
                         "compute dtype's: the kv_quant block")
    ap.add_argument("--serve-spec-ab", action="store_true",
                    help="add a timed speculation-off arm: spec_ab with "
                         "the wall-clock speedup")
    ap.add_argument("--serve-mixed-ab", action="store_true",
                    help="add a timed mixed-batching-off arm: mixed_ab "
                         "with dispatches per token and TTFT per arm")
    d = Config()
    ap.add_argument("--serve-deadline-ms", type=float,
                    default=d.serve_deadline_ms,
                    help="default per-request TTL from arrival: work not "
                         "complete by then fails with deadline_exceeded "
                         "(default: no deadline)")
    ap.add_argument("--serve-queue-depth", type=int,
                    default=d.serve_queue_depth,
                    help="bound on the waiting queue: a full queue sheds "
                         "the newest submit (status shed; default: "
                         "unbounded)")
    ap.add_argument("--serve-max-evictions", type=int,
                    default=d.serve_max_evictions,
                    help="a request preempted more than this many times "
                         "fails with evicted_too_often (default: "
                         "unbounded)")
    ap.add_argument("--serve-drain-ms", type=float,
                    default=d.serve_drain_ms,
                    help="graceful-drain budget after SIGTERM: in-flight "
                         "sequences finish inside it, the rest end "
                         "drained (default: finish all in-flight work)")
    ap.add_argument("--serve-failover-backoff-ms", type=float,
                    default=d.serve_failover_backoff_ms,
                    help="replica circuit breaker: probe backoff after a "
                         "transient replica fault, doubled a consecutive "
                         "fault (default 50)")
    ap.add_argument("--seed", type=int, default=0, help="trace seed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the rank's own card under "
                         "torchrun) or cpu; cuda without a card fails")


def _one_variable(what: str) -> str:
    return (f"{what} adds its own control arm; combining it with another "
            f"would change two variables in one comparison: pick one")


def check_serving_args(ap, args) -> None:
    """The reference bench's checks of these flags (``ap.error``): its
    command line's and ``measure_serving``'s, among them the A/B arms'
    exclusions (one comparison, one variable; no A/B under a journal,
    with replicas, or with the prefix cache's own control arm)."""
    replicas = args.serve_replicas or 1
    spec = args.serve_speculative not in (None, "off")
    abs_on = [f for f in AB_FLAGS if getattr(args, f)]
    if len(abs_on) > 1:
        ap.error(f"{', '.join('--' + f.replace('_', '-') for f in abs_on)}"
                 f" each replay the trace through their own control arm; "
                 f"one comparison, one variable: pick one")
    for flag in abs_on:
        name = "--" + flag.replace("_", "-")
        if args.serve_journal:
            ap.error(f"{name} is a measurement (two timed arms); the "
                     f"journaled serve mode is not: pick one")
        if replicas > 1:
            ap.error(_one_variable("--serve-replicas (aggregate vs single "
                                   "engine)") + f" ({name})")
        if args.serve_prefix_cache == "on" and flag != "serve_spec_ab":
            ap.error(_one_variable("--serve-prefix-cache on (the cache-off "
                                   "arm)") + f" ({name})")
    if spec and (args.serve_kernel_ab or args.serve_kv_ab):
        ap.error(_one_variable("--serve-speculative (the off arm)"))
    if args.serve_spec_ab and not spec:
        ap.error("--serve-spec-ab compares speculative decoding against "
                 "its off arm; pick a drafter with --serve-speculative "
                 "ngram|draft-model")
    if args.serve_mixed_ab and args.serve_mixed_batch != "on":
        ap.error("--serve-mixed-ab compares mixed batching against its off "
                 "arm; turn the fused path on with --serve-mixed-batch on")
    tp = args.serve_tp or 1
    if meshlib.launched() and int(os.environ["WORLD_SIZE"]) != tp:
        ap.error(f"a launch of {os.environ['WORLD_SIZE']} processes serves "
                 f"one tensor-parallel engine, a rank a process: it needs "
                 f"--serve-tp {os.environ['WORLD_SIZE']}, got "
                 f"{args.serve_tp}")
    if args.serve_prefix_tokens < 0:
        ap.error(f"--serve-prefix-tokens must be >= 0, got "
                 f"{args.serve_prefix_tokens}")
    if args.serve_prefix_gen == "on" and args.serve_prefix_cache != "on":
        ap.error("--serve-prefix-gen on extends the radix prefix cache; "
                 "it needs --serve-prefix-cache on")
    if args.serve_prefix_route == "on" \
            and args.serve_prefix_cache != "on":
        ap.error("--serve-prefix-route on routes by cached prefixes; it "
                 "needs --serve-prefix-cache on")
    if args.serve_prefix_route == "on" and replicas > 1:
        ap.error("--serve-prefix-route on adds its own 2-replica "
                 "hint-on-vs-off routing arm; combining it with "
                 "--serve-replicas would run two fleets in one bench — "
                 "pick one")
    if args.serve_draft_k is not None and args.serve_draft_k < 1:
        ap.error(f"--serve-draft-k must be >= 1, got {args.serve_draft_k}")
    if args.serve_tp is not None and args.serve_tp < 1:
        ap.error(f"--serve-tp must be >= 1, got {args.serve_tp}")
    if args.serve_replicas is not None and args.serve_replicas < 1:
        ap.error(f"--serve-replicas must be >= 1, got "
                 f"{args.serve_replicas}")
    if args.serve_kv_group is not None and args.serve_kv_group < 1:
        ap.error(f"--serve-kv-group must be >= 1, got "
                 f"{args.serve_kv_group}")
    if args.serve_kv_tier == "host" and args.serve_prefix_cache != "on":
        ap.error("--serve-kv-tier host demotes and re-admits blocks "
                 "through the radix prefix cache's eviction/match "
                 "hooks; turn it on with --serve-prefix-cache on")
    if args.serve_trace_out is not None and args.serve_trace != "on":
        ap.error("--serve-trace-out writes the Chrome trace the tracer "
                 "collects; it needs --serve-trace on")
    if args.serve_slo_ms is not None and not args.serve_slo_ms > 0:
        ap.error(f"--serve-slo-ms must be > 0, got {args.serve_slo_ms}")
    if (args.serve_deadline_ms is not None
            and args.serve_deadline_ms <= 0) \
            or (args.serve_queue_depth is not None
                and args.serve_queue_depth < 1) \
            or (args.serve_max_evictions is not None
                and args.serve_max_evictions < 1) \
            or (args.serve_drain_ms is not None
                and args.serve_drain_ms < 0) \
            or args.serve_failover_backoff_ms <= 0:
        ap.error(f"bad --serve-* fault policy: deadline-ms "
                 f"{args.serve_deadline_ms} (> 0), queue-depth "
                 f"{args.serve_queue_depth} (>= 1), max-evictions "
                 f"{args.serve_max_evictions} (>= 1), drain-ms "
                 f"{args.serve_drain_ms} (>= 0), failover-backoff-ms "
                 f"{args.serve_failover_backoff_ms} (> 0)")
    if (args.serve_fault_replica is None) != (args.serve_fault_step
                                              is None):
        ap.error("--serve-fault-replica and --serve-fault-step name "
                 "one injected fault together — set both or neither")
    if args.serve_fault_replica is not None:
        if replicas < 2:
            ap.error("--serve-fault-* need --serve-replicas >= 2 so a "
                     "survivor can take the migrated work")
        if not 0 <= args.serve_fault_replica < replicas:
            ap.error(f"--serve-fault-replica {args.serve_fault_replica} "
                     f"outside the fleet [0, {replicas})")
        if args.serve_fault_step < 1:
            ap.error(f"--serve-fault-step must be >= 1, got "
                     f"{args.serve_fault_step}")
    if args.serve_draft_auto == "on" \
            and args.serve_speculative in (None, "off"):
        ap.error("--serve-draft-auto on tunes the speculative draft "
                 "window; pick a drafter with --serve-speculative "
                 "ngram|draft-model")
    if args.serve_prefill_budget is not None \
            and args.serve_prefill_budget < 1:
        ap.error(f"--serve-prefill-budget must be >= 1, got "
                 f"{args.serve_prefill_budget}")
    if args.serve_mixed_batch == "on" \
            and args.serve_speculative not in (None, "off"):
        ap.error("--serve-mixed-batch on and --serve-speculative each "
                 "replace the decode dispatch with their own fused "
                 "forward; they do not compose — pick one")


# ------------------------------------------------------------ the arms

def fleet_of(engine, n: int, **serve) -> list:
    """``n`` new engines on ``engine``'s model (shared, read-only; under
    tensor parallelism each keeps this rank's shard of it), with its
    serving configuration and ``serve``'s changes to it."""
    cfg = dataclasses.replace(engine.serve, **serve)
    return [PagedDecodeEngine(engine.source_model, cfg, device=engine.device)
            for _ in range(n)]


def counted(run):
    """``(run(), paged-kernel launches during it)``: the count from 0,
    the card synchronised after (a replica's launches are queued on its
    own stream)."""
    pk.paged_attention_kernel.launches = 0
    res = run()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return res, pk.paged_attention_kernel.launches


def trace_detail(res: dict, trace_out: Optional[str]) -> dict:
    """The ``breakdown`` and ``trace`` blocks of a traced run (and the
    Chrome trace at ``trace_out``); empty with tracing off."""
    if "trace" not in res:
        return {}
    tb = res["trace"]
    chrome = (tracing_lib.write_chrome_trace(trace_out, tb["replicas"])
              if trace_out is not None else None)
    return {
        "breakdown": metrics_writer.breakdown_block(
            tb, stamped_first_s=res.get("request_first_token_s")),
        "trace": {"enabled": True, "spans": len(tb["spans"]),
                  "steps": tb["steps"], "steps_dropped": tb["steps_dropped"],
                  "chrome_trace": chrome},
    }


def fleet_block(rr: dict, single: Optional[dict], fault) -> dict:
    """The reference bench's ``replicas`` block of a fleet run ``rr``
    beside the single engine's timed run ``single``."""
    block = {
        "n": len(rr["replicas"]),
        "autoscale": rr["autoscale"],
        "fleet_faults": rr["fleet_faults"],
        "health": rr["health"],
        "serve_fault": fault,
        "parallel": rr["parallel"],
        "per_replica": rr["replicas"],
        "aggregate_tokens_per_sec": rr["tokens_per_sec"],
        "sticky_sessions": rr["sticky_sessions"],
        "p50_token_latency_ms": rr["p50_token_latency_ms"],
        "p99_token_latency_ms": rr["p99_token_latency_ms"],
        "status_counts": dict(Counter(rr["statuses"].values())),
    }
    if single is not None:
        block["speedup_vs_single_replica"] = (
            round(rr["tokens_per_sec"] / single["tokens_per_sec"], 3)
            if single["tokens_per_sec"] > 0 else None)
        block["token_identical_vs_single"] = \
            rr["outputs"] == single["outputs"]
    return block


def route_block(engine, requests, single: dict) -> dict:
    """The reference bench's ``prefix_route`` block: the trace through 2
    replicas with the prefix hint on (after a warmup replay), then the
    same replicas, reset, without it."""
    fleet = fleet_of(engine, 2)
    r_on = ReplicaRouter(fleet, prefix_route=True)
    r_on.run(requests())
    r_on.reset()
    ron = r_on.run(requests())
    r_off = ReplicaRouter(fleet, prefix_route=False)
    r_off.reset()
    roff = r_off.run(requests())
    return {
        "n": 2,
        "router_prefix_hits": ron["prefix"]["router_prefix_hits"],
        "prefix_on": ron["prefix"],
        "prefix_off": roff["prefix"],
        "hit_rate": {"route_on": ron["prefix"]["hit_rate"],
                     "route_off": roff["prefix"]["hit_rate"]},
        "hit_rate_gain": round(ron["prefix"]["hit_rate"]
                               - roff["prefix"]["hit_rate"], 4),
        "tokens_per_sec": {"route_on": ron["tokens_per_sec"],
                           "route_off": roff["tokens_per_sec"]},
        "token_identical_vs_off": ron["outputs"] == roff["outputs"],
        "token_identical_vs_single": ron["outputs"] == single["outputs"],
    }


def control_arm(engine, requests, **serve) -> tuple:
    """The trace through a new engine that differs from ``engine`` by
    ``serve``'s settings: an untimed warmup replay, then the timed one.
    Returns ``(the timed run's result, its paged-kernel launches,
    the engine)``."""
    other = fleet_of(engine, 1, **serve)[0]
    other.run(requests())
    other.reset()
    res, launches = counted(lambda: other.run(requests()))
    return res, launches, other


def static_batches(trace, max_slots: int) -> list:
    """The static arm's groups: ``[(row indices, padded prompts (rows,
    pmax) int64, nmax, cache length), ...]`` over the trace in arrival
    order, ``max_slots`` requests a group; each prompt left-padded by
    repeating its first token to ``pmax = pow2_ceil`` of the group's
    longest, the group decoded to its longest budget ``nmax``, through
    a cache of ``pmax + nmax`` (which may pass ``max_seq_len``: static
    batching pays for its padding)."""
    prompts, outputs = trace.prompts, trace.outputs
    out = []
    for i in range(0, len(prompts), max_slots):
        grp = list(range(i, min(i + max_slots, len(prompts))))
        pmax = pow2_ceil(max(len(prompts[j]) for j in grp))
        nmax = max(outputs[j] for j in grp)
        toks = np.array([[prompts[j][0]] * (pmax - len(prompts[j]))
                         + list(prompts[j]) for j in grp], dtype=np.int64)
        out.append((grp, toks, nmax, pmax + nmax))
    return out


def static_block(engine, trace) -> dict:
    """The static-batch baseline (module note): ``generate`` on each
    group (on this rank's shard under tensor parallelism), one untimed
    pass, then the timed one.  The rows' continuations past a pad are
    not the requests' own: the arm measures static batching's compute
    shape (the group's longest prompt and budget), not its tokens.
    Tokens counted are the trace's requested ones."""
    model, dev = engine.model, engine.device
    groups = static_batches(trace, engine.serve.max_slots)
    feeds = [(torch.from_numpy(t).to(dev), n, L) for _, t, n, L in groups]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one_pass():
        for t, n, L in feeds:
            model.generate(t, n, cache_len=L, reduce=engine._reduce)
        sync()

    one_pass()                       # untimed: the allocator's first use
    t0 = time.perf_counter()
    one_pass()
    sec = time.perf_counter() - t0
    useful = int(sum(trace.outputs))
    return {
        "groups": [[len(g), int(t.shape[1]), int(n), int(L)]
                   for g, t, n, L in groups],
        "useful_tokens": useful,
        "elapsed_s": sec,
        "tokens_per_sec": useful / sec if sec > 0 else 0.0,
    }


def kernel_ab_block(engine, requests, res: dict, launches: int) -> dict:
    """``--serve-kernel-ab``: the trace through the other lowering.  The
    reference's ``pallas_speedup_vs_xla`` is ``cuda_speedup_vs_gather``
    here (its Pallas kernel is the CUDA kernel, its XLA path the gather
    path)."""
    other = "gather" if engine.kernel == "cuda" else "cuda"
    res2, launches2, eng2 = control_arm(engine, requests, kernel=other)
    arms = {engine.kernel: res, eng2.kernel: res2}
    tps = {k: r["tokens_per_sec"] for k, r in arms.items()}
    return {
        "kernels": sorted(arms),
        "tokens_per_sec": tps,
        "cuda_speedup_vs_gather": (
            round(tps["cuda"] / tps["gather"], 3)
            if set(tps) == {"cuda", "gather"} and tps["gather"] > 0
            else None),
        # eager PyTorch compiles nothing: no recompile to count
        "ab_zero_recompile": None,
        "launches": {engine.kernel: launches, eng2.kernel: launches2},
        "forward_dispatches": {k: r["forward_dispatches"]
                               for k, r in arms.items()},
        "token_identical": res2["outputs"] == res["outputs"],
    }


def kv_ab_block(engine, trace, requests, res: dict, launches: int) -> dict:
    """``--serve-kv-ab``: the trace under the quantized rung (the run's
    ``kv_dtype`` when below the compute dtype, else int8) and under the
    compute dtype, the timed run one of the two; the canonical
    ``kv_quant`` block with each arm's tokens/s."""
    serve = engine.serve
    quant_dt = serve.kv_dtype if serve.kv_dtype != "fp32" else "int8"
    other_dt = "fp32" if serve.kv_dtype != "fp32" else quant_dt
    res2, launches2, eng2 = control_arm(engine, requests, kv_dtype=other_dt)
    if serve.kv_dtype == "fp32":
        ref, l_ref, quant, l_q, q_eng = res, launches, res2, launches2, eng2
    else:
        ref, l_ref, quant, l_q, q_eng = res2, launches2, res, launches, engine
    return {
        **kv_quant_report(ref, quant, q_eng, trace),
        "tokens_per_sec": {"fp32": ref["tokens_per_sec"],
                           quant_dt: quant["tokens_per_sec"]},
        "ab_zero_recompile": None,
        "launches": {"fp32": l_ref, quant_dt: l_q},
        "forward_dispatches": {"fp32": ref["forward_dispatches"],
                               quant_dt: quant["forward_dispatches"]},
    }


def spec_ab_block(engine, requests, res: dict, launches: int) -> tuple:
    """``--serve-spec-ab``: a timed speculation-off arm of the same
    (rope) model and trace.  Returns ``(the speculation block with
    token_identical_vs_off, the spec_ab block)``."""
    off, launches_off, _ = control_arm(engine, requests, speculative="off")
    arms = {"speculative": res["tokens_per_sec"],
            "off": off["tokens_per_sec"]}
    return ({**res["speculation"],
             "token_identical_vs_off": off["outputs"] == res["outputs"]}, {
        "arms": arms,
        "spec_speedup_vs_off": (round(arms["speculative"] / arms["off"], 3)
                                if arms["off"] > 0 else None),
        "ab_zero_recompile": None,
        "launches": {"speculative": launches, "off": launches_off},
        "forward_dispatches": {"speculative": res["forward_dispatches"],
                               "off": off["forward_dispatches"]},
        "dispatches_per_token": {"speculative": res["dispatches_per_token"],
                                 "off": off["dispatches_per_token"]},
    })


def mixed_ab_block(engine, trace, requests, res: dict,
                   launches: int) -> dict:
    """``--serve-mixed-ab``: a timed mixed-off arm; dispatches per token
    and TTFT (from the goodput block's stamps) per arm."""
    off, launches_off, _ = control_arm(engine, requests, mixed_batch="off")
    gp = {name: metrics_writer.goodput_block(
        loadgen.per_request_rows(trace, r), elapsed_s=r["elapsed_s"])
        for name, r in (("mixed", res), ("off", off))}
    return {
        "prefill_budget": engine.serve.prefill_budget,
        "tokens_per_sec": {"mixed": res["tokens_per_sec"],
                           "off": off["tokens_per_sec"]},
        "dispatches_per_token": {"mixed": res["dispatches_per_token"],
                                 "off": off["dispatches_per_token"]},
        "dispatch_reduction": (
            round(1.0 - res["dispatches_per_token"]
                  / off["dispatches_per_token"], 4)
            if off["dispatches_per_token"] > 0 else None),
        "ttft_p50_ms": {k: g["ttft_p50_ms"] for k, g in gp.items()},
        "ttft_p99_ms": {k: g["ttft_p99_ms"] for k, g in gp.items()},
        "token_identical_vs_off": off["outputs"] == res["outputs"],
        "ab_zero_recompile": None,
        "launches": {"mixed": launches, "off": launches_off},
        "forward_dispatches": {"mixed": res["forward_dispatches"],
                               "off": off["forward_dispatches"]},
    }


def admission_policy(args) -> dict:
    """``build_serving``'s admission arguments from the parsed flags."""
    return {"deadline_ms": args.serve_deadline_ms,
            "queue_depth": args.serve_queue_depth,
            "max_evictions": args.serve_max_evictions,
            "drain_ms": args.serve_drain_ms,
            "failover_backoff_ms": args.serve_failover_backoff_ms}


def measure_serving(args) -> dict:
    """Run the arms the flags ask for (module note) and return one dict:
    the timed (or journaled, or fleet) run's numbers and the reference
    bench's detail keys.  A world is joined only when ``--serve-tp T``
    asks for one under torchrun (``check_serving_args`` holds T to the
    launch's size): this process is then one rank of it, every rank
    serves, and each returns the same dict but for ``rank``."""
    tp = args.serve_tp or 1
    replicas = args.serve_replicas or 1
    ranked = args.serve_tp is not None and meshlib.launched()
    dev = meshlib.rank_device(args.device) if ranked else args.device
    joined = ranked and meshlib.initialize_distributed(dev)
    try:
        return _measure(args, dev, tp, replicas)
    finally:
        if joined:
            meshlib.shutdown()


def _measure(args, dev, tp: int, replicas: int) -> dict:
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
        draft_auto=args.serve_draft_auto,
        prefix_route=args.serve_prefix_route,
        workload=args.serve_workload, slo_ms=args.serve_slo_ms, tp=tp,
        trace_mode=args.serve_trace, trace_out=args.serve_trace_out,
        **admission_policy(args), device=dev)
    serve = engine.serve
    cfg = engine.model.cfg
    fault = (None if args.serve_fault_replica is None else {
        "replica": args.serve_fault_replica, "step": args.serve_fault_step,
        "kind": args.serve_fault_kind})
    plan = (None if fault is None else FaultPlan([ReplicaFault(
        fault["replica"], fault["step"], kind=fault["kind"])]))
    if serve.prefix_gen == "on":
        turns = two_turn_requests(engine, trace)
        requests = lambda: [dataclasses.replace(r) for r in turns]
    else:
        requests = trace.requests
    det = {
        "model": "gpt_tiny" if args.serve_tiny else "gpt_base",
        "kernel": engine.kernel,
        "kernel_requested": serve.kernel,
        "kv_dtype": serve.kv_dtype,
        "serve_kv_group": serve.kv_group,
        "serve_kv_tier": serve.kv_tier,
        "serve_prefix_cache": serve.prefix_cache,
        "serve_prefix_tokens": args.serve_prefix_tokens,
        "serve_prefix_gen": serve.prefix_gen,
        "serve_prefix_route": serve.prefix_route,
        "serve_speculative": serve.speculative,
        "serve_draft_k": serve.draft_k,
        "serve_draft_auto": serve.draft_auto,
        "serve_mixed_batch": serve.mixed_batch,
        "serve_prefill_budget": serve.prefill_budget,
        "serve_tp": serve.tp,
        "serve_replicas": replicas,
        "serve_workload": args.serve_workload or "poisson",
        "serve_slo_ms": args.serve_slo_ms,
        "serve_trace": serve.trace,
        "serve_fault": fault,
        "num_requests": args.requests, "rate_rps": args.arrival_rate,
        "max_slots": serve.max_slots, "pool_blocks": serve.num_blocks,
        "block_size": serve.block_size, "prompt_max": args.prompt_len,
        "output_max": args.new_tokens, "max_seq_len": serve.max_seq_len,
        "deadline_ms": serve.deadline_ms, "queue_depth": serve.queue_depth,
        "max_evictions": serve.max_evictions, "drain_ms": serve.drain_ms,
        "failover_backoff_ms": serve.failover_backoff_ms,
        "tiny": args.serve_tiny, "precision": args.precision,
        "layers": cfg.layers, "hidden": cfg.hidden,
        "device": str(engine.device),
        "rank": tp_lib.world()[0],
        "journal": args.serve_journal,
    }
    if args.serve_journal is not None:
        return _journaled(args, engine, requests, replicas, plan, det)

    engine.run(requests())                # warmup (lazy builds, caches)
    engine.reset()
    with PreemptionGuard.installed() as guard:
        # the advisor rides the timed run only
        res, launches = counted(lambda: engine.run(
            requests(), guard=guard, advisor=autoscale.ScaleAdvisor()))
    replicas_detail = route_detail = None
    if replicas > 1:
        router = ReplicaRouter(fleet_of(engine, replicas))
        router.run(requests())
        router.reset()
        # the fault plan fires in the timed replay only
        rr, fleet_launches = counted(lambda: router.run(
            requests(), fault_plan=plan,
            advisor=autoscale.ScaleAdvisor(replicas=replicas)))
        replicas_detail = {**fleet_block(rr, res, fault),
                           "launches": fleet_launches,
                           "forward_dispatches": rr["forward_dispatches"]}
    if serve.prefix_route == "on":
        route_detail = route_block(engine, requests, res)
    speculation = res["speculation"]
    kernel_ab = kv = spec_ab = mixed_ab = None
    if args.serve_kernel_ab:
        kernel_ab = kernel_ab_block(engine, requests, res, launches)
    if args.serve_kv_ab:
        kv = kv_ab_block(engine, trace, requests, res, launches)
    if args.serve_spec_ab:
        speculation, spec_ab = spec_ab_block(engine, requests, res,
                                             launches)
    if args.serve_mixed_ab:
        mixed_ab = mixed_ab_block(engine, trace, requests, res, launches)
    static = static_block(engine, trace)
    det.update({
        "tokens_per_sec": res["tokens_per_sec"],
        "p50_token_latency_ms": res["p50_token_latency_ms"],
        "p99_token_latency_ms": res["p99_token_latency_ms"],
        "launches": launches,
        "tokens": res["tokens"],
        "elapsed_s": res["elapsed_s"],
        "evictions": res["evictions"],
        "forward_dispatches": res["forward_dispatches"],
        "dispatches_per_token": res["dispatches_per_token"],
        "peak_blocks_in_use": res["peak_blocks_in_use"],
        "peak_live_blocks": res["peak_live_blocks"],
        "prefix": res["prefix"],
        "speculation": speculation,
        "tier": res["tier"],
        "faults": res["faults"],
        "drain": res["drain"],
        "kernel_ab": kernel_ab,
        "kv_quant": kv,
        "spec_ab": spec_ab,
        "mixed_ab": mixed_ab,
        "static_batch": static,
        "static_batch_tokens_per_sec": static["tokens_per_sec"],
        "speedup_vs_static": (res["tokens_per_sec"]
                              / static["tokens_per_sec"]
                              if static["tokens_per_sec"] > 0 else None),
        "requests": len(res["statuses"]),
        "ok_requests": sum(s == "ok" for s in res["statuses"].values()),
        "status_counts": dict(Counter(res["statuses"].values())),
        "goodput": metrics_writer.goodput_block(
            loadgen.per_request_rows(trace, res),
            elapsed_s=res["elapsed_s"]),
        "autoscale": res["autoscale"],
        "replicas": replicas_detail,
        "prefix_route": route_detail,
    })
    det.update(trace_detail(res, serve.trace_out))
    return det


def _journaled(args, engine, requests, replicas: int, plan, det) -> dict:
    """The fault-tolerant serve modes: one journaled run, no warmup
    (a warmup would journal the trace twice)."""
    if replicas > 1:
        journals = [recovery.ReplayJournal(f"{args.serve_journal}.r{i}")
                    for i in range(replicas)]
        todo, pre = recovery.fleet_replay_requests(
            journals, requests(), eos_id=engine.serve.eos_id)
        router = ReplicaRouter(fleet_of(engine, replicas))
        with PreemptionGuard.installed() as guard:
            res, launches = counted(lambda: router.run(
                todo, guard=guard, journals=journals, replay_pre=pre,
                fault_plan=plan))
        for j in journals:
            j.close()
        det.update({
            "fleet_faults": res["fleet_faults"],
            "health": res["health"],
            "replicas": fleet_block(res, None, det["serve_fault"]),
        })
    else:
        model, serve, dev = (engine.source_model, engine.serve,
                             engine.device)
        built = [engine]

        def make_engine():
            # the first attempt serves the engine built above; a rebuild
            # after a transient fault gets fresh pools
            return (built.pop() if built
                    else PagedDecodeEngine(model, serve, device=dev))

        with PreemptionGuard.installed() as guard:
            res, launches = counted(lambda: recovery.run_with_replay(
                make_engine, requests(), journal_path=args.serve_journal,
                guard=guard))
        det.update({
            "replays": res["replays"],
            "delivered_tokens": res["delivered_tokens"],
            "prefix": res.get("prefix"),
            "speculation": res.get("speculation"),
            "peak_blocks_in_use": res.get("peak_blocks_in_use"),
            "peak_live_blocks": res.get("peak_live_blocks"),
            "evictions": res["evictions"],
        })
    det.update({
        "tokens_per_sec": res["tokens_per_sec"],
        "p50_token_latency_ms": res["p50_token_latency_ms"],
        "p99_token_latency_ms": res["p99_token_latency_ms"],
        "launches": launches,
        "tokens": res["tokens"],
        "elapsed_s": res["elapsed_s"],
        "forward_dispatches": res["forward_dispatches"],
        "outputs": res["outputs"],
        "statuses": res["statuses"],
        "requests": len(res["statuses"]),
        "ok_requests": sum(s == "ok" for s in res["statuses"].values()),
        "status_counts": dict(Counter(res["statuses"].values())),
        "faults": res["faults"],
        "drain": res["drain"],
        # a replayed run's clock holds earlier attempts' work: attained
        # latencies would be skewed, so these blocks are the timed arm's
        "goodput": None,
        "autoscale": None,
        # a journaled run has no static arm (it would serve the trace
        # twice), as the reference's has none
        "static_batch_tokens_per_sec": None,
        "speedup_vs_static": None,
    })
    det.update(trace_detail(res, engine.serve.trace_out))
    return det


def bench_line(det: dict) -> dict:
    """The reference bench's metric line around ``det``, whose detail
    names the pool's dtype and the throughput as the reference's does."""
    wl = det["serve_workload"]
    detail = dict(det)
    detail["serve_kv_dtype"] = detail.pop("kv_dtype")
    detail["serving_tokens_per_sec"] = detail.pop("tokens_per_sec")
    out = {
        "metric": f"GPT-{'tiny' if det['tiny'] else 'base'} "
                  f"continuous-batching serving throughput (paged KV "
                  f"cache, {'Poisson' if wl == 'poisson' else wl} trace)",
        "value": round(det["tokens_per_sec"], 1),
        "unit": "tokens/sec",
        "vs_baseline": None,
        "kernel": det["kernel"],
        "detail": detail,
    }
    reps = det.get("replicas")
    if reps is not None and "speedup_vs_single_replica" in reps:
        out["replica_speedup"] = reps["speedup_vs_single_replica"]
    gp = det.get("goodput")
    if gp and gp.get("enabled"):
        out["goodput_tokens_per_sec"] = gp.get("goodput_tokens_per_sec")
        out["slo_attainment"] = gp.get("slo_attainment")
    if gp:
        out["ttft_p50_ms"] = gp.get("ttft_p50_ms")
        out["ttft_p99_ms"] = gp.get("ttft_p99_ms")
    bd = det.get("breakdown")
    if bd and bd.get("enabled"):
        out["queue_ms_p99"] = bd.get("queue_ms_p99")
        out["prefill_ms_p99"] = bd.get("prefill_ms_p99")
        out["decode_ms_p99"] = bd.get("decode_ms_p99")
    return out
