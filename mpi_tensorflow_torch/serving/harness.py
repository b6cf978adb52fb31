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
- ``--serve-tp T`` under ``torchrun --nproc_per_node T``: the engine arm
  on each rank (``serving/tp``), rank 0 reporting.

Not ported yet (ROADMAP Queue 1 item 6b, refused): the static-batch arm,
``--serve-kernel-ab``, ``--serve-kv-ab``, ``--serve-spec-ab`` and
``--serve-mixed-ab``.
"""

from __future__ import annotations

import dataclasses
import os
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

#: the reference bench's arms this slice does not port (ROADMAP item 6b)
DEFERRED_FLAGS = ("serve_kernel_ab", "serve_kv_ab", "serve_spec_ab",
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
                  trace_out: Optional[str] = None, device="cuda"):
    """-> ``(engine, trace)``.  Unset knobs resolve through ``Config``'s
    ``serve_*`` defaults; ``layers`` cuts the model's depth (widths stay
    the preset's).  Under ``tp > 1`` this process is one rank of the
    world, and the engine keeps its shard of the model."""
    cfg = Config(precision=precision)
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
    for flag in DEFERRED_FLAGS:
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help="not ported yet (ROADMAP Queue 1 item 6b)")
    ap.add_argument("--seed", type=int, default=0, help="trace seed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the rank's own card under "
                         "torchrun) or cpu; cuda without a card fails")


def check_serving_args(ap, args) -> None:
    """The reference bench's checks of these flags (``ap.error``), and
    the refusals of what is not ported yet."""
    for flag in DEFERRED_FLAGS:
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet: ROADMAP "
                f"Queue 1 item 6b")
    replicas = args.serve_replicas or 1
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
    if tp > 1 and (replicas > 1 or args.serve_journal
                   or args.serve_prefix_route == "on"
                   or args.serve_prefix_gen == "on"):
        raise NotImplementedError(
            "--serve-tp > 1 serves the engine arm alone; with "
            "--serve-replicas, --serve-journal, --serve-prefix-route or "
            "--serve-prefix-gen it is not ported yet: ROADMAP Queue 1 "
            "item 6b")


# ------------------------------------------------------------ the arms

def fleet_of(engine, n: int, **serve) -> list:
    """``n`` new engines on ``engine``'s model (shared, read-only), with
    its serving configuration and ``serve``'s changes to it."""
    cfg = dataclasses.replace(engine.serve, **serve)
    return [PagedDecodeEngine(engine.model, cfg, device=engine.device)
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
        device=dev)
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
        "speculation": res["speculation"],
        "tier": res["tier"],
        "faults": res["faults"],
        "drain": res["drain"],
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
        model, serve, dev = engine.model, engine.serve, engine.device
        built = [engine]

        def make_engine():
            # the first attempt serves the engine built above; a rebuild
            # after a transient fault gets fresh pools
            return (built.pop() if built
                    else PagedDecodeEngine(model, serve, device=dev))

        journal = recovery.ReplayJournal(args.serve_journal)
        with PreemptionGuard.installed() as guard:
            res, launches = counted(lambda: recovery.run_with_replay(
                make_engine, requests(), journal=journal, guard=guard))
        journal.close()
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
