"""Continuous-batching decode engine over the paged KV cache.

Counterpart of ``mpi_tensorflow_tpu/serving/engine.py``.  Drives
``models/gpt.CausalLm.forward_paged`` with iteration-level scheduling:
every step admits what fits, advances ONE prefill chunk of the oldest
mid-prefill sequence, and decodes ONE token for every live sequence.

Dispatches run at the reference's small fixed set of bucketed shapes —
decode at (slot bucket, table-width bucket), prefill at (1, chunk
bucket) with the full table width, all powers of two — and the engine
records the same ``dispatch_shapes`` and ``forward_dispatches``, so the
two engines can be compared shape for shape.  PyTorch runs eagerly:
there is no jit and so no compile count yet (a CUDA-graph capture count
takes its place in a later slice).  The pools are updated in place by
``ops/paged_attention.write_kv``, which replaces the reference's pool
donation.  The host waits on the device once per decode dispatch (the
next tokens) and once per admission (the token a prompt's final chunk
emits).

Served here: the pool in the compute dtype or quantized (``kv_dtype``
int8, or int4 with ``kv_group`` and the fp-residual self lane), greedy
decoding, the fault policy (deadlines, bounded queue, eviction cap,
graceful drain).  The prefix cache, speculation, mixed batching, host
tier, tensor parallelism and tracing are later slices: ``ServeConfig``
raises for them, naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from mpi_tensorflow_torch.ops import paged_attention as paged_ops
from mpi_tensorflow_torch.serving import paged_cache, scheduler as sched_lib
from mpi_tensorflow_torch.utils import metrics_writer
from mpi_tensorflow_torch.utils.device import device_name, resolve_device


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-pool geometry + fault-tolerance policy — the reference's
    fields and validation.  ``kernel`` is ``auto|gather|cuda`` (the
    reference's ``auto|xla|pallas``)."""
    num_blocks: int = 128         # pool blocks, block 0 reserved as null
    block_size: int = 16          # cache entries per block
    max_slots: int = 8            # concurrent sequences (decode batch cap)
    max_seq_len: int = 512        # per-sequence prompt+output cap
    prefill_chunk: int = 64       # max prompt tokens per prefill dispatch
    eos_id: Optional[int] = None  # emit-EOS slot recycling (None: budget
                                  # exhaustion only)
    kernel: str = "auto"          # paged-attention lowering, resolved once
                                  # at engine construction
    prefix_cache: str = "off"
    prefix_gen: str = "off"
    prefix_route: str = "off"
    speculative: str = "off"
    draft_k: int = 4
    draft_auto: str = "off"
    mixed_batch: str = "off"
    prefill_budget: int = 64
    kv_dtype: str = "fp32"        # pool storage: "fp32" (the compute
                                  # dtype) | "int8" | "int4"
    kv_group: int = 32            # int4 scale-group size along head_dim
    kv_tier: str = "off"
    tp: int = 1
    # --- fault-tolerance policy (None = feature off / unbounded) ---
    deadline_ms: Optional[float] = None   # default per-request TTL
    queue_depth: Optional[int] = None     # bound on the waiting queue
    max_evictions: Optional[int] = None   # preemption-livelock guard
    drain_ms: Optional[float] = None      # graceful-drain budget
    failover_backoff_ms: float = 50.0     # replica circuit breaker
    trace: str = "off"
    trace_out: Optional[str] = None

    @classmethod
    def from_config(cls, config, **overrides):
        """Build from a run Config's ``serve_*`` knobs (config.py);
        overrides that are None keep the config's value."""
        base = dict(num_blocks=config.serve_pool_blocks,
                    block_size=config.serve_block_size,
                    max_slots=config.serve_max_slots,
                    max_seq_len=config.serve_max_seq_len,
                    kernel=config.serve_kernel,
                    kv_dtype=config.serve_kv_dtype,
                    kv_group=config.serve_kv_group,
                    deadline_ms=config.serve_deadline_ms,
                    queue_depth=config.serve_queue_depth,
                    max_evictions=config.serve_max_evictions,
                    drain_ms=config.serve_drain_ms,
                    failover_backoff_ms=config.serve_failover_backoff_ms)
        base.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**base)

    @property
    def max_blocks_per_seq(self) -> int:
        return paged_cache.blocks_for(self.max_seq_len, self.block_size)

    def __post_init__(self):
        if self.block_size < 1 or self.num_blocks < 2 \
                or self.prefill_chunk < 1 or self.max_slots < 1 \
                or self.max_seq_len < 1:
            raise ValueError(f"bad pool geometry: {self}")
        if self.kernel not in paged_ops.KERNELS:
            raise ValueError(f"serve kernel must be auto|gather|cuda, "
                             f"got {self.kernel!r}")
        for name, allowed in (
                ("prefix_cache", ("off", "on")),
                ("prefix_gen", ("off", "on")),
                ("prefix_route", ("off", "on")),
                ("speculative", ("off", "ngram", "draft-model")),
                ("draft_auto", ("off", "on")),
                ("mixed_batch", ("off", "on")),
                ("kv_dtype", ("fp32", "int8", "int4")),
                ("kv_tier", ("off", "host")),
                ("trace", ("off", "on"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"serve {name} must be "
                                 f"{'|'.join(allowed)}, "
                                 f"got {getattr(self, name)!r}")
        if self.prefix_gen == "on" and self.prefix_cache == "off":
            raise ValueError("serve prefix_gen extends the radix prefix "
                             "cache; turn the cache on or drop it")
        if self.prefix_route == "on" and self.prefix_cache == "off":
            raise ValueError("serve prefix_route needs prefix_cache on")
        if self.draft_k < 1:
            raise ValueError(f"serve draft_k must be >= 1, "
                             f"got {self.draft_k}")
        if self.draft_auto == "on" and self.speculative == "off":
            raise ValueError("serve draft_auto tunes the speculative draft "
                             "window; pick a drafter or drop it")
        if self.prefill_budget < 1:
            raise ValueError(f"serve prefill_budget must be >= 1, "
                             f"got {self.prefill_budget}")
        if self.mixed_batch == "on" and self.speculative != "off":
            raise ValueError("serve mixed_batch and speculative do not "
                             "compose — pick one")
        if self.kv_group < 1:
            raise ValueError(f"serve kv_group must be >= 1, "
                             f"got {self.kv_group}")
        if self.kv_tier == "host" and self.prefix_cache == "off":
            raise ValueError("serve kv_tier needs prefix_cache on")
        if self.tp < 1:
            raise ValueError(f"serve tp must be >= 1, got {self.tp}")
        if (self.deadline_ms is not None and self.deadline_ms <= 0) \
                or (self.queue_depth is not None and self.queue_depth < 1) \
                or (self.max_evictions is not None
                    and self.max_evictions < 1) \
                or (self.drain_ms is not None and self.drain_ms < 0) \
                or self.failover_backoff_ms <= 0:
            raise ValueError(f"bad fault-tolerance policy: {self}")
        if self.trace_out is not None and self.trace != "on":
            raise ValueError("serve trace_out needs trace on")
        if self.num_blocks - 1 < self.max_blocks_per_seq:
            # a lone max-length sequence must fit, or the scheduler can
            # deadlock with nothing left to evict
            raise ValueError(
                f"pool of {self.num_blocks - 1} usable blocks cannot hold "
                f"one max_seq_len={self.max_seq_len} sequence "
                f"({self.max_blocks_per_seq} blocks of {self.block_size})")
        # valid values this slice does not serve yet
        for name, off, item in (
                ("prefix_cache", "off", "Queue 1 item 2 (prefix cache)"),
                ("kv_tier", "off", "Queue 1 item 2 (prefix cache)"),
                ("mixed_batch", "off", "Queue 1 item 3 (mixed batching)"),
                ("speculative", "off", "Queue 1 item 4 (speculation)"),
                ("prefix_route", "off", "Queue 1 item 6 (fleet)"),
                ("tp", 1, "Queue 1 item 6 (tensor parallelism)"),
                ("trace", "off", "Queue 1 item 6 (tracing)")):
            if getattr(self, name) != off:
                raise ValueError(
                    f"serve {name}={getattr(self, name)!r} is not ported "
                    f"yet: ROADMAP {item}")


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= ``n`` — THE bucketing rule of the
    dispatch shapes; trace sizing reuses it."""
    b = 1
    while b < n:
        b *= 2
    return b


def _bucket(n: int, cap: int) -> int:
    """Round ``n`` up to a power of two, capped at ``cap``."""
    return min(pow2_ceil(n), cap)


class PagedDecodeEngine:
    """Greedy continuous-batching decode over a paged KV cache.

    ``model`` (a ``models.gpt.CausalLm``) is moved to ``device``, which
    is ``cuda`` unless the caller asks for the CPU; ``cuda`` without a
    card raises.  ``run(requests)`` returns ``{request id: generated
    token list}`` plus latency/throughput stats and the fault blocks."""

    def __init__(self, model, serve: ServeConfig, *, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.serve = serve
        cap = serve.max_blocks_per_seq * serve.block_size
        if model.cfg.pos_kind == "learned" \
                and cap > model.cfg.max_positions:
            raise ValueError(
                f"max_seq_len {serve.max_seq_len} (table capacity {cap}) "
                f"exceeds max_positions {model.cfg.max_positions}")
        # resolved ONCE: the run serves through exactly one lowering
        self.kernel = paged_ops.resolve_kernel(serve.kernel, self.device)
        self.tracer = None             # tracing is a later slice
        self.reset()

    def reset(self) -> None:
        """Fresh pools and scheduler (a trace replay starts clean)."""
        cfg = self.model.cfg
        self.pools = paged_cache.init_pools(
            cfg, self.serve.num_blocks, self.serve.block_size, self.device,
            self.serve.kv_dtype, self.serve.kv_group)
        self.allocator = paged_cache.BlockAllocator(self.serve.num_blocks)
        self.sched = sched_lib.Scheduler(
            self.allocator, self.serve.max_slots, self.serve.block_size,
            self.serve.max_blocks_per_seq,
            queue_depth=self.serve.queue_depth,
            max_evictions=self.serve.max_evictions)
        # pool-occupancy high-water marks: raw = every referenced block;
        # live = distinct blocks mapped by live sequences
        self.peak_blocks_in_use = 0
        self.peak_live_blocks = 0
        self._progressed = False        # did the last step() do any work
        self._last_token: dict = {}     # slot -> next token to feed
        # admitted (slot, Sequence) pairs awaiting prefill: the sequence
        # identity guards against a slot evicted and re-admitted while
        # queued — a stale entry must not prefill the NEW occupant
        self._prefill_queue: List[tuple] = []
        self.dispatch_shapes: set = set()
        self.forward_dispatches = 0     # model forwards this run

    # ---------------- device steps ----------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _decode_impl(self, tokens, lengths, tables):
        """(B,) tokens at per-row positions ``lengths`` -> (B,) greedy
        next tokens on the device.  Bucket-slack rows carry all-null
        tables; their writes land in the null block and their output is
        discarded on the host."""
        live = (tables[:, 0] != paged_ops.NULL_BLOCK)[:, None]
        logits = self.model.forward_paged(
            tokens[:, None], self.pools, tables, lengths, live,
            kernel=self.kernel)
        return torch.argmax(logits[:, -1], dim=-1)

    def _prefill_impl(self, tokens, length: int, n_real: int, tables):
        """One (1, chunk) prefill dispatch: writes the chunk's KV into the
        row's blocks and returns the greedy token after the LAST REAL
        lane (meaningful on the final chunk only), on the device."""
        S = tokens.shape[1]
        valid = torch.arange(S, device=self.device)[None] < n_real
        lengths = torch.tensor([length], dtype=torch.int32,
                               device=self.device)
        logits = self.model.forward_paged(tokens, self.pools, tables,
                                          lengths, valid,
                                          kernel=self.kernel)
        return torch.argmax(logits[0, max(n_real - 1, 0)], dim=-1)

    # ---------------- host-side step assembly ----------------

    def _track_occupancy(self) -> None:
        """Advance the pool-occupancy high-water marks."""
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.allocator.num_used)
        live = {b for s in self.sched.slots if s is not None
                for b in s.block_ids}
        self.peak_live_blocks = max(self.peak_live_blocks, len(live))

    def _table_row(self, seq, width: int) -> np.ndarray:
        row = np.zeros((width,), np.int32)
        ids = seq.block_ids[:width]
        row[:len(ids)] = ids
        return row

    def _advance_prefill(self) -> List[Tuple[int, int]]:
        """Advance the oldest mid-prefill sequence by ONE chunk.  Returns
        the ``(request id, token)`` the final chunk emits, if any."""
        while self._prefill_queue:
            slot, seq = self._prefill_queue[0]
            if self.sched.slots[slot] is not seq:
                # evicted while queued — drop the stale entry
                self._prefill_queue.pop(0)
                continue
            break
        else:
            return []
        prompt = seq.request.prompt
        self._progressed = True          # a chunk enters the pool
        chunk = prompt[seq.prefilled:seq.prefilled + self.serve.prefill_chunk]
        sb = _bucket(len(chunk), self.serve.prefill_chunk)
        toks = np.zeros((1, sb), np.int32)
        toks[0, :len(chunk)] = chunk
        tables = self._table_row(seq, self.serve.max_blocks_per_seq)[None]
        self.dispatch_shapes.add(("prefill", sb))
        self.forward_dispatches += 1
        nxt = self._prefill_impl(self._to_device(toks), seq.prefilled,
                                 len(chunk), self._to_device(tables))
        seq.prefilled += len(chunk)
        if seq.prefilled < len(prompt):
            return []
        self._prefill_queue.pop(0)
        # the prompt's last position yields the first output token, so
        # the slot enters the decode pool one token ahead
        tok = int(nxt)                   # one host sync per admission
        self._last_token[slot] = tok
        self.sched.record_token(slot, tok, self.serve.eos_id)
        return [(seq.request.id, tok)]

    @torch.no_grad()
    def step(self) -> List[Tuple[int, int]]:
        """One engine iteration: admit, advance one prefill chunk, decode
        every live slot once.  Returns the ``(request id, token)`` pairs
        emitted."""
        self._progressed = False
        admitted = self.sched.admit()
        self._track_occupancy()
        if admitted:
            self._progressed = True
        self._prefill_queue.extend(
            (slot, self.sched.slots[slot]) for slot in admitted)
        emitted = self._advance_prefill()

        live = []
        for slot in self.sched.live_slots():
            seq = self.sched.slots[slot]
            if seq is None or seq.prefilled < len(seq.request.prompt):
                continue            # mid-prefill: not in the decode pool
            if not self.sched.ensure_block(slot):
                # pool exhausted with nothing left to evict: fail THIS
                # request alone; every other stream keeps serving
                self.sched.fail_live(slot, "rejected")
                continue
            live.append(slot)
        # eviction inside ensure_block may have retired a later slot
        live = [s for s in live if self.sched.slots[s] is not None]
        self._track_occupancy()
        if not live:
            return emitted
        self._progressed = True

        Bb = _bucket(len(live), self.serve.max_slots)
        nb = max(len(self.sched.slots[s].block_ids) for s in live)
        NBb = _bucket(nb, self.serve.max_blocks_per_seq)
        tokens = np.zeros((Bb,), np.int32)
        lengths = np.zeros((Bb,), np.int32)
        tables = np.zeros((Bb, NBb), np.int32)
        for j, slot in enumerate(live):
            seq = self.sched.slots[slot]
            tokens[j] = self._last_token[slot]
            # the pending token writes at position length-1
            lengths[j] = seq.length - 1
            tables[j] = self._table_row(seq, NBb)
        self.dispatch_shapes.add(("decode", Bb, NBb))
        self.forward_dispatches += 1
        nxt = self._decode_impl(self._to_device(tokens),
                                self._to_device(lengths),
                                self._to_device(tables))
        nxt = nxt.cpu().numpy()          # the one host sync per decode
        for j, slot in enumerate(live):
            tok = int(nxt[j])
            self._last_token[slot] = tok
            emitted.append((self.sched.slots[slot].request.id, tok))
            self.sched.record_token(slot, tok, self.serve.eos_id)
        return emitted

    # ---------------- request loop ----------------

    def run(self, requests: List[sched_lib.Request],
            time_fn=time.perf_counter, *, guard=None) -> dict:
        """Serve ``requests`` (replayed against their ``arrival`` stamps)
        to completion or graceful drain.  A token's latency is the wall
        time since the previous token of the SAME sequence (first token:
        since arrival, queueing included).  ``guard`` (anything with a
        ``should_stop`` flag) wires a stop request into a graceful drain:
        admission stops, un-admitted work is ``shed``, in-flight work
        finishes within ``serve.drain_ms`` and is otherwise ``drained``.
        """
        from mpi_tensorflow_torch.serving.iteration import (DrainTracker,
                                                            EngineLoop)

        serve = self.serve
        loop = EngineLoop(self)
        drain = DrainTracker(serve.drain_ms)
        pending = sorted(requests, key=lambda r: r.arrival)
        t0 = time_fn()
        while pending or not self.sched.all_done():
            now = time_fn() - t0
            if guard is not None and guard.should_stop \
                    and not drain.draining:
                drain.start(now, len(self.sched.finished))
                drain.shed = len(pending)
                for req in pending:
                    self.sched.fail_request(req, "shed")
                pending = []
                drain.shed += self.sched.shed_waiting()
            if drain.expired(now):
                self.sched.abort_live("drained")
                break
            while pending and pending[0].arrival <= now:
                loop.submit(pending.pop(0))
            emitted = loop.iterate(now, time_fn, t0)
            now = time_fn() - t0
            if not emitted and not self._progressed:
                # idle gap before the next arrival: sleep instead of
                # spinning a host core
                delay = 1e-3
                if pending:
                    delay = min(delay, max(0.0, pending[0].arrival - now))
                if delay > 0:
                    time.sleep(delay)
        elapsed = time_fn() - t0
        # pool-leak invariant: every terminal request released its blocks
        self.sched.check_quiescent()
        outputs = {s.request.id: list(s.generated)
                   for s in self.sched.finished}
        total = sum(len(v) for v in outputs.values())
        flat = loop.latencies()
        lat = np.asarray(flat) if flat else np.zeros(1)
        return {
            "outputs": outputs,
            "statuses": dict(self.sched.statuses),
            "faults": metrics_writer.faults_block(self.sched.counters),
            "drain": drain.result(len(self.sched.finished),
                                  self.sched.counters["drained"]),
            "kernel": self.kernel,
            "kv_dtype": serve.kv_dtype,
            "device": device_name(self.device),
            "prefix": metrics_writer.prefix_block(),
            "speculation": metrics_writer.speculation_block(serve.draft_k),
            "tier": metrics_writer.tier_block(),
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "peak_live_blocks": self.peak_live_blocks,
            "tokens": total,
            "elapsed_s": elapsed,
            "tokens_per_sec": total / elapsed if elapsed > 0 else 0.0,
            "p50_token_latency_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_token_latency_ms": float(np.percentile(lat, 99)) * 1e3,
            "evictions": self.sched.evictions,
            "dispatch_shapes": sorted(self.dispatch_shapes),
            "forward_dispatches": self.forward_dispatches,
            "dispatches_per_token": self.forward_dispatches / max(1, total),
            "request_finish_s": dict(loop.last_emit),
            "request_first_token_s": dict(loop.first_emit),
        }

    def load_signals(self) -> dict:
        """Instantaneous load signals: waiting-queue depth, live-slot
        fraction, pool occupancy (block 0 is the null block), shed
        fraction, and the admitted-but-unprefilled backlog in prefill
        chunks."""
        live = len(self.sched.live_slots())
        waiting = len(self.sched.waiting)
        seen = max(1, waiting + live + len(self.sched.statuses))
        return {
            "queue_depth": waiting,
            "live_fraction": live / self.serve.max_slots,
            "occupancy": (self.allocator.num_used
                          / max(1, self.serve.num_blocks - 1)),
            "shed_rate": self.sched.counters["shed"] / seen,
            "prefill_backlog": (self.sched.prefill_backlog_tokens
                                / max(1, self.serve.prefill_chunk)),
        }
