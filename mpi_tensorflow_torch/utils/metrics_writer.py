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
- the serving blocks: ``faults_block`` and ``kv_quant_block`` in full,
  and ``prefix_block``, ``speculation_block`` and ``tier_block`` in the
  disabled form the port's engine produces (their features are ROADMAP
  Queue 1 items).  Same keys and value types as the reference, so
  results of the two engines compare key for key.
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


def prefix_block() -> dict:
    """The ``prefix`` (radix prefix cache) block with the cache off."""
    return {
        "enabled": False, "hit_tokens": 0, "prompt_tokens": 0,
        "hit_rate": 0.0, "shared_blocks": 0, "cow_copies": 0,
        "trie_evictions": 0, "trie_blocks": 0, "hit_admissions": 0,
        "gen_inserted_blocks": 0, "partial_copy_tokens": 0,
        "prefill_tokens_saved": 0, "router_prefix_hits": 0,
    }


def speculation_block(draft_k: int = 4) -> dict:
    """The ``speculation`` block with speculative decoding off."""
    return {
        "enabled": False, "mode": "off", "draft_k": int(draft_k),
        "draft_auto": "off", "effective_k": int(draft_k),
        "draft_tokens": 0, "accepted_tokens": 0, "accept_rate": 0.0,
        "verify_forwards": 0, "emitted_tokens": 0,
        "mean_accepted_len": 0.0, "steps_saved": 0,
    }


def tier_block() -> dict:
    """The ``tier`` (host-RAM block tier) block with tiering off."""
    return {
        "enabled": False, "mode": "off", "demotions": 0, "promotions": 0,
        "host_blocks": 0, "host_blocks_peak": 0,
        "promote_latency_ms_total": 0.0, "promote_latency_ms_mean": 0.0,
        "prefill_tokens_saved_tier": 0,
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
