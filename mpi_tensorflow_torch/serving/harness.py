"""Build the serving run the entry point and ``chip_smoke.py`` time.

The port's counterpart of the engine arm of the reference's
``bench.py --mode serving`` (``measure_serving``): the same model
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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.models import bert
from mpi_tensorflow_torch.models.gpt import CausalLm
from mpi_tensorflow_torch.serving import loadgen
from mpi_tensorflow_torch.serving.engine import (PagedDecodeEngine,
                                                 ServeConfig, pow2_ceil)
from mpi_tensorflow_torch.serving.paged_cache import blocks_for
from mpi_tensorflow_torch.utils.metrics_writer import kv_quant_block


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
                  draft_auto: Optional[str] = None, device="cuda"):
    """-> ``(engine, trace)``.  Unset knobs resolve through ``Config``'s
    ``serve_*`` defaults; ``layers`` cuts the model's depth (widths stay
    the preset's)."""
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
        num_requests=num_requests, rate_rps=rate_rps,
        prompt_max=prompt_max, output_max=output_max,
        vocab_size=bcfg.vocab_size, prefix_tokens=prefix_tokens,
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
        draft_k=draft_k, draft_auto=draft_auto)
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
