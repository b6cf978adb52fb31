"""The metrics sink of the trainers, and the accounting blocks
``PagedDecodeEngine.run`` returns.

Counterpart of ``mpi_tensorflow_tpu/utils/metrics_writer.py``:

- ``MetricsWriter``: scalars to ``<dir>/metrics.jsonl``, one ``{"step",
  "tag", "value", "time"}`` line per scalar, NaN and Inf written as
  ``null`` (strict JSON readers stop at the first bare NaN), and to a
  TensorBoard event file beside it when ``tensorboardX`` imports (the
  JSONL stream is the contract; the event file is optional).  A writer
  with no directory, or made disabled, does nothing;
- ``for_process``: the writer of a rank, active on rank 0 only (the
  loops pass scalars already reduced over the ranks), so call sites need
  no rank guard.  The loops write the reference's tags:
  ``eval/test_error_pct`` at each trace point and ``perf/images_per_sec``
  at the end (``train.loop``); ``eval/heldout_error_pct`` and
  ``train/loss`` at each trace point and ``perf/tokens_per_sec`` at the
  end (``train.mlm_loop``);
- the serving blocks: ``faults_block``, ``fleet_faults_block``,
  ``prefix_block``, ``speculation_block``, ``tier_block``,
  ``kv_quant_block``, ``goodput_block`` and ``breakdown_block``, with
  the reference's keys, value types and rounding, so results of the two
  packages compare key for key.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsWriter:
    """Scalar sink; does nothing when ``log_dir`` is empty or
    ``enabled`` is False."""

    def __init__(self, log_dir: Optional[str], *, enabled: bool = True):
        self._enabled = bool(log_dir) and enabled
        self._tb = None
        self._jsonl = None
        if not self._enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                           buffering=1)
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            self._tb = None             # the JSONL stream alone

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self._enabled:
            return
        v = float(value)
        jv = v if v == v and abs(v) != float("inf") else None
        self._jsonl.write(json.dumps(
            {"step": int(step), "tag": tag, "value": jv,
             "time": round(time.time(), 3)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, v, int(step))

    def close(self) -> None:
        """Flush and close; later scalars are dropped."""
        self._enabled = False
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def for_process(log_dir: Optional[str], process_index: int) -> MetricsWriter:
    """The writer of rank ``process_index``: active on rank 0 only."""
    return MetricsWriter(log_dir, enabled=process_index == 0)


#: canonical serving fault-tolerance counters — THE shape of the
#: ``faults`` block
SERVING_FAULT_KEYS = ("rejected", "shed", "deadline_exceeded",
                      "evicted_too_often", "drained", "evictions",
                      "replays")


def faults_block(counters) -> dict:
    """Scheduler counters -> the ``faults`` block: every key present (0
    when the counter never fired), values plain ints."""
    return {k: int(counters.get(k, 0)) for k in SERVING_FAULT_KEYS}


#: the ``fleet_faults`` block of the replica router: failovers handled,
#: live or queued requests re-homed to survivors, prompt + prefix tokens
#: re-ingested to rebuild them, circuit-breaker ejections and
#: readmissions, and the session map's re-homed and evicted entries
FLEET_FAULT_KEYS = ("failovers", "migrated_requests", "replay_tokens",
                    "ejections", "readmissions", "sticky_rehomed",
                    "sticky_evicted")


def fleet_faults_block(counters) -> dict:
    """Router counters -> the ``fleet_faults`` block: every key
    present, values plain ints."""
    return {k: int(counters.get(k, 0)) for k in FLEET_FAULT_KEYS}


def prefix_block(counters, *, enabled: bool, trie_blocks: int = 0,
                 router_prefix_hits: int = 0) -> dict:
    """Scheduler counters -> the ``prefix`` (radix prefix cache) block.

    ``hit_rate`` counts FULL-BLOCK sharing only; partial tail-block rows
    ride separately as ``partial_copy_tokens``, and
    ``prefill_tokens_saved`` is every prompt position served out of the
    cache (full blocks + partial rows) instead of recomputed.
    ``router_prefix_hits``: fleet placements the router's prefix hint
    decided (0 for one engine)."""
    hit = int(counters.get("prefix_hit_tokens", 0))
    total = int(counters.get("prefix_prompt_tokens", 0))
    partial = int(counters.get("prefix_partial_copy_tokens", 0))
    return {
        "enabled": bool(enabled),
        "hit_tokens": hit,
        "prompt_tokens": total,
        "hit_rate": round(hit / total, 4) if total else 0.0,
        "shared_blocks": int(counters.get("prefix_shared_blocks", 0)),
        "cow_copies": int(counters.get("prefix_cow_copies", 0)),
        "trie_evictions": int(counters.get("prefix_trie_evictions", 0)),
        "trie_blocks": int(trie_blocks),
        "hit_admissions": int(counters.get("prefix_hit_admissions", 0)),
        "gen_inserted_blocks":
            int(counters.get("prefix_gen_inserted_blocks", 0)),
        "partial_copy_tokens": partial,
        "prefill_tokens_saved": hit + partial,
        "router_prefix_hits": int(router_prefix_hits),
    }


def speculation_block(counters, *, enabled: bool, mode: str = "off",
                      draft_k: int = 0, draft_auto: str = "off") -> dict:
    """Scheduler counters -> the ``speculation`` block.

    ``effective_k`` is the draft window the policy offered, averaged
    over verify rows (``draft_k`` with ``draft_auto`` off);
    ``steps_saved`` is tokens emitted through the verify path minus
    verify forwards run: the decode passes speculation avoided."""
    drafted = int(counters.get("spec_drafted", 0))
    accepted = int(counters.get("spec_accepted", 0))
    forwards = int(counters.get("spec_verify_forwards", 0))
    emitted = int(counters.get("spec_emitted", 0))
    k_sum = int(counters.get("spec_k_sum", 0))
    k_steps = int(counters.get("spec_k_steps", 0))
    return {
        "enabled": bool(enabled),
        "mode": mode,
        "draft_k": int(draft_k),
        "draft_auto": draft_auto,
        "effective_k": (round(k_sum / k_steps, 2) if k_steps
                        else int(draft_k)),
        "draft_tokens": drafted,
        "accepted_tokens": accepted,
        "accept_rate": round(accepted / drafted, 4) if drafted else 0.0,
        "verify_forwards": forwards,
        "emitted_tokens": emitted,
        "mean_accepted_len": (round(accepted / forwards, 4)
                              if forwards else 0.0),
        "steps_saved": emitted - forwards,
    }


def tier_block(*, enabled: bool = False, mode: str = "off",
               demotions: int = 0, promotions: int = 0,
               host_blocks: int = 0, host_blocks_peak: int = 0,
               promote_ms_total: float = 0.0,
               block_size: int = 0) -> dict:
    """Host-tier counters -> the ``tier`` block (all zero with tiering
    off).  ``prefill_tokens_saved_tier`` =
    promotions x block_size, the prefill the re-admissions avoided."""
    return {
        "enabled": bool(enabled),
        "mode": mode,
        "demotions": int(demotions),
        "promotions": int(promotions),
        "host_blocks": int(host_blocks),
        "host_blocks_peak": int(host_blocks_peak),
        "promote_latency_ms_total": round(float(promote_ms_total), 3),
        "promote_latency_ms_mean": (
            round(float(promote_ms_total) / promotions, 3)
            if promotions else 0.0),
        "prefill_tokens_saved_tier": int(promotions * block_size),
    }


def kv_quant_block(*, kv_dtype: str = "fp32", matched_tokens: int = 0,
                   compared_tokens: int = 0, block_bytes_ref: int = 0,
                   block_bytes: int = 0, num_blocks: int = 0,
                   peak_live_blocks_ref: int = 0,
                   peak_live_blocks: int = 0,
                   bytes_per_decode_token_ref: float = 0.0,
                   bytes_per_decode_token: float = 0.0) -> dict:
    """The ``kv_quant`` block of a quantized-pool A/B: ``*_ref`` is the
    compute-dtype arm.  ``token_match_rate`` is positionwise greedy
    agreement over the trace; ``capacity_multiplier`` and
    ``effective_capacity_blocks`` say how many blocks the same memory
    holds at the quantized bytes per block (codes + scales);
    ``bytes_per_decode_token`` is the K/V a decode token reads."""
    return {
        "enabled": True,
        "kv_dtype": kv_dtype,
        "matched_tokens": int(matched_tokens),
        "compared_tokens": int(compared_tokens),
        "token_match_rate": (round(matched_tokens / compared_tokens, 4)
                             if compared_tokens else 0.0),
        "block_bytes_ref": int(block_bytes_ref),
        "block_bytes": int(block_bytes),
        "capacity_multiplier": (round(block_bytes_ref / block_bytes, 4)
                                if block_bytes else 0.0),
        "effective_capacity_blocks": (
            int(num_blocks * block_bytes_ref // block_bytes)
            if block_bytes else 0),
        "num_blocks": int(num_blocks),
        "peak_live_blocks_ref": int(peak_live_blocks_ref),
        "peak_live_blocks": int(peak_live_blocks),
        "peak_live_blocks_delta": int(peak_live_blocks
                                      - peak_live_blocks_ref),
        "bytes_per_decode_token_ref": round(
            float(bytes_per_decode_token_ref), 2),
        "bytes_per_decode_token": round(float(bytes_per_decode_token), 2),
    }


def _percentile(vals, q: float) -> float:
    """Linear-interpolation percentile over a small sample (no numpy:
    this module stays importable by zero-dependency consumers)."""
    if not vals:
        return 0.0
    s = sorted(vals)
    k = (len(s) - 1) * q
    f = int(k)
    c = min(f + 1, len(s) - 1)
    return s[f] + (s[c] - s[f]) * (k - f)


def goodput_block(rows, *, elapsed_s: float, enabled=None) -> dict:
    """Aggregate per-request rows (serving/loadgen.per_request_rows:
    ``tenant`` / ``status`` / ``tokens`` / ``attained_ms`` / ``slo_ms``
    each) into the canonical ``goodput`` block, with a per-tenant
    breakdown keyed by tenant class.

    A row MEETS its SLO when it finished ``ok`` within ``slo_ms``
    (None = no budget, so every ``ok`` completion counts — goodput
    degenerates to raw delivered throughput).  Attained-latency
    percentiles cover completed requests only: an unfinished request
    has no whole-request latency, and its miss is already counted by
    ``slo_attainment``.  ``ttft_p50_ms``/``ttft_p99_ms`` cover every
    row carrying a ``ttft_ms`` stamp (any request that streamed at
    least one token) — time-to-first-token is the queueing + prefill
    latency mixed batching targets, visible even for requests that
    later failed their deadline."""
    rows = list(rows)
    if enabled is None:
        enabled = any(r.get("slo_ms") is not None for r in rows)

    def agg(sub: list) -> dict:
        ok = [r for r in sub if r.get("status") == "ok"]
        met = [r for r in ok
               if r.get("slo_ms") is None
               or (r.get("attained_ms") is not None
                   and r["attained_ms"] <= r["slo_ms"])]
        att = [r["attained_ms"] for r in ok
               if r.get("attained_ms") is not None]
        ttft = [r["ttft_ms"] for r in sub
                if r.get("ttft_ms") is not None]
        toks = sum(int(r.get("tokens", 0)) for r in met)
        return {
            "requests": len(sub),
            "ok_requests": len(ok),
            "slo_met_requests": len(met),
            "slo_attainment": (round(len(met) / len(sub), 4)
                               if sub else 0.0),
            "goodput_tokens_per_sec": (round(toks / elapsed_s, 2)
                                       if elapsed_s > 0 else 0.0),
            "goodput_requests_per_sec": (round(len(met) / elapsed_s, 4)
                                         if elapsed_s > 0 else 0.0),
            "p50_attained_ms": round(_percentile(att, 0.5), 2),
            "p99_attained_ms": round(_percentile(att, 0.99), 2),
            "ttft_p50_ms": round(_percentile(ttft, 0.5), 2),
            "ttft_p99_ms": round(_percentile(ttft, 0.99), 2),
        }

    tenants = sorted({r.get("tenant", "default") for r in rows})
    block = agg(rows)
    block["enabled"] = bool(enabled)
    block["per_tenant"] = {
        t: agg([r for r in rows if r.get("tenant", "default") == t])
        for t in tenants}
    return block


#: canonical phase-attribution keys — THE shape of the ``breakdown``
#: block bench detail carries with --serve-trace on (serving/tracing
#: spans).  queue/prefill/decode percentiles are recomputed FROM SPANS
#: (not from the engine's scalar stamps); the two ``*_max_delta_ms``
#: keys are the cross-checks that pin the span clock to the stamped
#: clock: phase times sum to the attained whole-request latency, and
#: span TTFT equals the stamped first-token time.
BREAKDOWN_KEYS = ("enabled", "requests", "queue_ms_p50", "queue_ms_p99",
                  "prefill_ms_p50", "prefill_ms_p99", "decode_ms_p50",
                  "decode_ms_p99", "ttft_ms_p50", "ttft_ms_p99",
                  "phase_sum_vs_attained_max_delta_ms",
                  "ttft_vs_stamp_max_delta_ms", "steps", "steps_dropped")


def breakdown_block(trace, *, enabled=None, stamped_first_s=None) -> dict:
    """Aggregate a serving ``trace`` result block (engine/router
    ``res["trace"]``: fleet-merged spans + step-ring accounting) into
    the canonical ``breakdown`` block — per-phase latency percentiles
    over requests that finished ``ok``, with the span-vs-stamp
    consistency deltas.

    ``stamped_first_s`` is the run's ``request_first_token_s`` map;
    when given, ``ttft_vs_stamp_max_delta_ms`` reports the worst
    disagreement between a span's first-token stamp and the loop's —
    the loop stamps both from the same post-step clock read, so this
    should be ~0 and a drift means an instrumentation bug.  Keys are
    always exactly ``BREAKDOWN_KEYS`` (zeros when disabled/empty)."""
    if enabled is None:
        enabled = bool(trace) and bool(trace.get("enabled"))
    out = {k: 0.0 for k in BREAKDOWN_KEYS}
    out["enabled"] = bool(enabled)
    out["requests"] = 0
    out["steps"] = 0
    out["steps_dropped"] = 0
    if not enabled or not trace:
        return out
    spans = trace.get("spans", {})
    ok = [d for d in spans.values() if d.get("status") == "ok"]
    queue = [d["queue_s"] * 1e3 for d in ok]
    prefill = [d["prefill_s"] * 1e3 for d in ok]
    decode = [d["decode_s"] * 1e3 for d in ok]
    ttft = [(d["first_token"] - d["arrive"]) * 1e3 for d in ok
            if d.get("first_token") is not None]
    phase_delta = [abs((d["queue_s"] + d["prefill_s"] + d["decode_s"])
                       - (d["terminal"] - d["arrive"])) * 1e3
                   for d in ok if d.get("terminal") is not None
                   # a migrated span's attained latency includes the
                   # inter-incarnation replay gap its phase clocks
                   # deliberately exclude — the sum contract holds per
                   # incarnation, so check single-incarnation spans
                   if d.get("incarnations", 1) == 1 and not d["replays"]]
    stamp_delta = [abs(d["first_token"] - stamped_first_s[d["rid"]]) * 1e3
                   for d in ok
                   if stamped_first_s is not None
                   and d.get("first_token") is not None
                   and d["rid"] in stamped_first_s]
    out.update({
        "requests": len(ok),
        "queue_ms_p50": round(_percentile(queue, 0.5), 3),
        "queue_ms_p99": round(_percentile(queue, 0.99), 3),
        "prefill_ms_p50": round(_percentile(prefill, 0.5), 3),
        "prefill_ms_p99": round(_percentile(prefill, 0.99), 3),
        "decode_ms_p50": round(_percentile(decode, 0.5), 3),
        "decode_ms_p99": round(_percentile(decode, 0.99), 3),
        "ttft_ms_p50": round(_percentile(ttft, 0.5), 3),
        "ttft_ms_p99": round(_percentile(ttft, 0.99), 3),
        "phase_sum_vs_attained_max_delta_ms": round(
            max(phase_delta), 3) if phase_delta else 0.0,
        "ttft_vs_stamp_max_delta_ms": round(
            max(stamp_delta), 3) if stamp_delta else 0.0,
        "steps": int(trace.get("steps", 0)),
        "steps_dropped": int(trace.get("steps_dropped", 0)),
    })
    return out
