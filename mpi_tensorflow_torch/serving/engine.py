"""Continuous-batching decode engine over the paged KV cache.

Counterpart of ``mpi_tensorflow_tpu/serving/engine.py``.  Drives
``models/gpt.CausalLm.forward_paged`` with iteration-level scheduling:
every step admits what fits, advances ONE prefill chunk of the oldest
mid-prefill sequence, and decodes ONE token for every live sequence.

Dispatches run at the reference's small fixed set of bucketed shapes —
decode at (slot bucket, table-width bucket), prefill at (1, chunk
bucket) with the full table width, verify at (slot bucket, table
bucket) x ``draft_k + 1`` lanes, mixed at (slot bucket, chunk bucket,
table bucket), all buckets powers of two — and the engine records the
same ``dispatch_shapes`` and ``forward_dispatches``, so the two engines
can be compared shape for shape.  PyTorch runs eagerly: there is no jit,
so nothing is compiled ahead and the reference's pre-warm dispatches
(into the null block, outside ``dispatch_shapes``) have no counterpart;
a CUDA-graph capture count is later work.  The pools are updated in
place by ``ops/paged_attention.write_kv`` and by the block copies below,
which replaces the reference's pool donation.  The host waits on the
device once per decode, verify or mixed dispatch (the next tokens) and
once per admission (the token a prompt's final chunk emits).

Served here: the pool in the compute dtype or quantized (``kv_dtype``
int8, or int4 with ``kv_group`` and the fp-residual self lane), greedy
decoding, the fault policy (deadlines, bounded queue, eviction cap,
graceful drain), and the reference's features:

- ``prefix_cache``: admission maps a prompt's cached full blocks
  (``serving/prefix_cache``) into the new sequence; a write into a
  shared block first copies it (copy-on-write, ``_ensure_private``);
  ``prefix_gen`` adds generated blocks to the trie and the partial
  tail-block copy; ``kv_tier="host"`` demotes evicted trie blocks to a
  ``HostBlockStore`` and promotes them back on a later match;
- ``mixed_batch``: decode rows and budget-capped prefill chunks of
  several sequences in ONE forward a step (``_step_mixed``);
- ``speculative``: a drafter (``serving/speculative``) proposes up to
  ``draft_k`` tokens a row, one ``draft_k + 1``-lane forward verifies
  them, the rejected tail's blocks roll back (``_step_verify``);
  ``draft_auto`` tunes the window by an EWMA of the accepted length.

Every feature keeps greedy outputs token-identical to the feature off.

The fleet and observability hooks:

- ``run(..., journal=)``: each token is journaled at its emission,
  before the scheduler's terminal hook can fire (the durable order is
  tok-then-end), and the terminal hook chains the journal's end record
  (``serving/recovery``);
- ``trace="on"``: a ``serving/tracing.EngineTracer`` is built at each
  reset; ``step`` stamps each forward's dispatch and token fetch
  (``time.monotonic`` deltas, no synchronisation of its own: the fetch
  the engine already does carries the device's wait);
- ``run(..., advisor=)``: a ``serving/autoscale.ScaleAdvisor`` observes
  every iteration (the tracer's step record when tracing is on);
- ``tp``: in a ``torch.distributed`` world of exactly ``tp`` ranks
  (``serving/tp``) this process is one rank: it holds ``H / tp`` heads
  and the matching MLP slice, sums the two row-parallel products of each
  layer over the ranks, and takes rank 0's clock and stop flag once an
  iteration (``tp = 1`` in a world of one runs the same path);
- ``stream``: a ``torch.cuda.Stream`` the engine runs on (the replica
  router gives each replica one, ``use_stream``), so a replica's token
  fetch waits for its own work only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from mpi_tensorflow_torch.ops import paged_attention as paged_ops
from mpi_tensorflow_torch.serving import paged_cache
from mpi_tensorflow_torch.serving import prefix_cache as prefix_lib
from mpi_tensorflow_torch.serving import scheduler as sched_lib
from mpi_tensorflow_torch.serving import speculative as spec_lib
from mpi_tensorflow_torch.serving import tp as tp_lib
from mpi_tensorflow_torch.serving import tracing
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
                    prefix_cache=config.serve_prefix_cache,
                    prefix_gen=config.serve_prefix_gen,
                    prefix_route=config.serve_prefix_route,
                    speculative=config.serve_speculative,
                    draft_k=config.serve_draft_k,
                    draft_auto=config.serve_draft_auto,
                    mixed_batch=config.serve_mixed_batch,
                    prefill_budget=config.serve_prefill_budget,
                    kv_dtype=config.serve_kv_dtype,
                    kv_group=config.serve_kv_group,
                    kv_tier=config.serve_kv_tier,
                    tp=config.serve_tp,
                    deadline_ms=config.serve_deadline_ms,
                    queue_depth=config.serve_queue_depth,
                    max_evictions=config.serve_max_evictions,
                    drain_ms=config.serve_drain_ms,
                    failover_backoff_ms=config.serve_failover_backoff_ms,
                    trace=config.serve_trace,
                    trace_out=config.serve_trace_out)
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
    card raises.  ``draft_model`` is the drafter's ``CausalLm`` under
    ``speculative="draft-model"`` (None: ``speculative.
    default_draft_model``).  Under ``tp > 1`` ``model`` is the whole
    model, and the engine keeps this rank's shard of it.
    ``run(requests)`` returns ``{request id: generated token list}`` plus
    latency/throughput stats, the fault blocks and the prefix,
    speculation and tier blocks (and ``trace`` with tracing on)."""

    def __init__(self, model, serve: ServeConfig, *, device="cuda",
                 draft_model=None):
        self.device = resolve_device(device)
        tp_lib.check_geometry(model.cfg, serve.tp)
        collective = tp_lib.collective(serve.tp)
        self.rank = tp_lib.world()[0] if collective else 0
        # the whole model as given: another engine of the same model
        # (an A/B arm, a replica) starts from it
        self.source_model = model
        if serve.tp > 1:
            model = tp_lib.shard_model(model, self.rank, serve.tp)
        self.model = model.to(self.device)
        # the row-parallel sum over the ranks (None outside a world of
        # exactly ``tp``: one process serves alone)
        self._reduce = tp_lib.all_reduce if collective else None
        self.serve = serve
        self.stream = None              # a side stream: use_stream
        cap = serve.max_blocks_per_seq * serve.block_size
        if model.cfg.pos_kind == "learned" \
                and cap > model.cfg.max_positions:
            raise ValueError(
                f"max_seq_len {serve.max_seq_len} (table capacity {cap}) "
                f"exceeds max_positions {model.cfg.max_positions}")
        # resolved ONCE: the run serves through exactly one lowering
        self.kernel = paged_ops.resolve_kernel(serve.kernel, self.device)
        # built once, like the reference's (its pool resets with ours)
        self.drafter = spec_lib.make_drafter(
            serve.speculative, serve, self.model, device=self.device,
            draft_model=draft_model)
        # draft_auto's EWMA of the accepted length per verify row drives
        # the EFFECTIVE window; it starts at the full window and, as in
        # the reference, survives reset(): it can change how much is
        # drafted, never the tokens
        self._accept_ewma = float(serve.draft_k)
        self._draft_k_eff = serve.draft_k
        self.reset()

    def use_stream(self, stream) -> None:
        """Run on ``stream`` from now on (a replica's own CUDA stream):
        the pools are rebuilt on it, so the caching allocator keeps them
        in that stream's pool."""
        self.stream = stream
        self.reset()

    def on_stream(self):
        """The context the engine's device work runs in: its own stream
        (ordered after the work the caller's stream has queued), or
        nothing to do without one."""
        if self.stream is None:
            return contextlib.nullcontext()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self.stream)

    def reset(self) -> None:
        """Fresh pools, trie, host tier, draft pool, scheduler and tracer
        (a trace replay starts clean)."""
        with self.on_stream():
            self._reset()

    def _reset(self) -> None:
        if self.stream is not None:
            # nothing queued may still read the pools freed below
            self.stream.synchronize()
        cfg = self.model.cfg
        self.pools = paged_cache.init_pools(
            cfg, self.serve.num_blocks, self.serve.block_size, self.device,
            self.serve.kv_dtype, self.serve.kv_group,
            heads=cfg.heads // self.serve.tp)
        self.allocator = paged_cache.BlockAllocator(self.serve.num_blocks)
        # the trie indexes pool content, so it resets with the pools
        self.prefix_cache = (
            prefix_lib.PrefixCache(self.allocator, self.serve.block_size)
            if self.serve.prefix_cache == "on" else None)
        # the host tier's bytes index device content that just went
        self.tier = (paged_cache.HostBlockStore()
                     if self.serve.kv_tier == "host" else None)
        if self.tier is not None:
            self.prefix_cache.tier = self.tier
            self.prefix_cache.demote_fetch = self._demote_fetch
            self.prefix_cache.promote_put = self._promote_put
        if self.drafter is not None:
            self.drafter.reset()
        self.sched = sched_lib.Scheduler(
            self.allocator, self.serve.max_slots, self.serve.block_size,
            self.serve.max_blocks_per_seq,
            queue_depth=self.serve.queue_depth,
            max_evictions=self.serve.max_evictions,
            prefix_cache=self.prefix_cache,
            prefix_gen=self.serve.prefix_gen == "on",
            on_terminal=self._on_terminal)
        # pool-occupancy high-water marks: raw = every referenced block
        # (trie-held blocks included); live = distinct blocks mapped by
        # live sequences (two sequences on one block count it once)
        self.peak_blocks_in_use = 0
        self.peak_live_blocks = 0
        # tracing resets with the engine (a rebuilt engine is a fresh
        # incarnation); off, or a rank other than 0: no tracer at all
        self.tracer = (tracing.EngineTracer()
                       if self.serve.trace == "on" and self.rank == 0
                       else None)
        self._journal = None            # set by run(); a token is
                                        # journaled BEFORE record_token,
                                        # so the durable order is
                                        # tok-then-end
        self._progressed = False        # did the last step() do any work
        self._last_token: dict = {}     # slot -> next token to feed
        # admitted (slot, Sequence) pairs awaiting prefill: the sequence
        # identity guards against a slot evicted and re-admitted while
        # queued — a stale entry must not prefill the NEW occupant
        self._prefill_queue: List[tuple] = []
        self.dispatch_shapes: set = set()
        # model forwards this run (prefill + decode + verify + mixed;
        # the block copies move cache rows, not tokens)
        self.forward_dispatches = 0

    def _on_terminal(self, req, status: str) -> None:
        """The scheduler's per-request exit hook: release the drafter's
        state for the request, then the journal's end record and the
        tracer's terminal (queued: no loop clock is in scope here)."""
        if self.drafter is not None:
            self.drafter.release(req.id)
        if self._journal is not None:
            self._journal.record_end(req, status)
        if self.tracer is not None:
            self.tracer.on_terminal(req, status)

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
            kernel=self.kernel, reduce=self._reduce)
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
                                          kernel=self.kernel,
                                          reduce=self._reduce)
        return torch.argmax(logits[0, max(n_real - 1, 0)], dim=-1)

    def _lanes_impl(self, tokens, lengths, n_valid, tables):
        """The verify and the mixed dispatch (the reference's
        ``_verify_impl`` and ``_mixed_impl``, one function here): row
        ``b`` feeds ``n_valid[b]`` real lanes at positions ``lengths[b]
        + lane`` through ONE forward, and the greedy argmax of EVERY
        lane comes back, (B, S) on the device.  A decode row is the
        one-lane case; a verify row is the pending token plus its draft;
        a mixed prefill row is a chunk of its prompt.  Padding lanes
        (past ``n_valid`` or in bucket-slack rows) write into the null
        block and their argmax is discarded on the host."""
        S = tokens.shape[1]
        live = tables[:, 0] != paged_ops.NULL_BLOCK
        valid = ((torch.arange(S, device=self.device)[None]
                  < n_valid[:, None]) & live[:, None])
        logits = self.model.forward_paged(tokens, self.pools, tables,
                                          lengths, valid,
                                          kernel=self.kernel,
                                          reduce=self._reduce)
        return torch.argmax(logits, dim=-1)

    def _cow_impl(self, src: int, dst: int) -> None:
        """Copy one pool block, every layer and leaf (codes and, in a
        quantized pool, the scale siblings on the same block axis), in
        place: the device half of copy-on-write."""
        for p in self.pools:
            for leaf in p.values():
                leaf[dst].copy_(leaf[src])

    def _demote_fetch(self, block: int) -> list:
        """Copy pool block ``block`` to the host, per-layer dicts of CPU
        tensors: the prefix cache calls this just before eviction
        releases the device block.  A copy, never a view: the block is
        recycled right after."""
        return [{key: leaf[block].to("cpu", copy=True)
                 for key, leaf in p.items()} for p in self.pools]

    def _promote_put(self, leaves: list, block: int) -> None:
        """Land demoted host bytes in freshly allocated device block
        ``block``, during the admission walk, before the sequence's
        first dispatch reads it.  ``tier.promote_ms_total`` measures the
        LANDED copies: on the card the stream is drained before the
        clock starts and synchronised before it stops."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for p, host in zip(self.pools, leaves):
            for key, leaf in p.items():
                leaf[block].copy_(host[key])
        if cuda:
            torch.cuda.synchronize(self.device)
        self.tier.promote_ms_total += (time.perf_counter() - t0) * 1e3

    # ---------------- host-side step assembly ----------------

    def _ensure_private(self, slot: int, start: int, end: int) -> bool:
        """Copy-on-write guard: before a dispatch writes cache positions
        ``[start, end)`` of ``slot``, every backing block another reader
        holds (allocator refcount > 1: other sequences or the trie) is
        replaced by a private copy — allocate (evicting under pressure),
        copy on the device, release the shared reference, repoint the
        table.  The structural trigger is a fully cached prompt whose
        length is an exact block multiple; decode, verify and mixed rows
        run the same guard.  Returns False when the pool cannot supply a
        copy target: the caller fails this one request."""
        if self.prefix_cache is None or start >= end:
            return True
        seq = self.sched.slots[slot]
        bs = self.serve.block_size
        for j in range(start // bs, (end - 1) // bs + 1):
            if j >= len(seq.block_ids):
                continue            # growth handled by ensure_block
            src = seq.block_ids[j]
            if self.allocator.refcount(src) <= 1:
                continue            # exclusive: in-place write is safe
            dst = self.sched.alloc_for(slot)
            if dst is None:
                return False
            self._cow_impl(src, dst)
            self.allocator.release([src])
            seq.block_ids[j] = dst
            self.sched.counters["prefix_cow_copies"] += 1
        return True

    def _apply_partial_copies(self) -> None:
        """Land every pending partial tail-block copy (prefix v2):
        admission matched ``partial_rows`` leading tokens of a slot's
        tail block against cached block ``partial_src`` and charged them
        as prefilled, so the rows must be in place before the first
        prefill chunk reads past them.  Runs right after admit(), so no
        eviction intervenes; the scheduler then drops the source pin."""
        for seq in self.sched.slots:
            if seq is None or seq.partial_src is None:
                continue
            paged_cache.partial_copy_block(self.pools, seq.partial_src,
                                           seq.partial_dst,
                                           seq.partial_rows)
            self.sched._release_partial(seq)

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

    def _finish_prefill(self, slot: int, seq, tok: int) -> tuple:
        """A prompt's final chunk landed: register its full blocks in the
        trie BEFORE record_token can finish the request and release them
        (the trie's own reference keeps a cached block alive past its
        donor), then record the first output token."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(seq.request.prompt, seq.block_ids)
        self._last_token[slot] = tok
        self._journal_tokens(seq.request.id, [tok])
        self.sched.record_token(slot, tok, self.serve.eos_id)
        return (seq.request.id, tok)

    def _journal_tokens(self, rid: int, toks) -> None:
        """Journal emitted tokens BEFORE the scheduler records them (its
        terminal hook writes the end record): tok-then-end."""
        if self._journal is not None:
            for tok in toks:
                self._journal.record_token(rid, tok)

    def _fetch(self, out: torch.Tensor, t_dispatch: float):
        """The tokens of one forward on the host: the engine's one wait
        for the device a dispatch.  With tracing on, the issue time up
        to here is the step's dispatch time and the fetch its consume
        time (which includes the device's wait)."""
        tr = self.tracer
        if tr is None:
            return out.cpu().numpy()
        t1 = time.monotonic()
        tr.dispatch_s += t1 - t_dispatch
        host = out.cpu().numpy()
        tr.consume_s += time.monotonic() - t1
        return host

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
        if not self._ensure_private(slot, seq.prefilled,
                                    seq.prefilled + len(chunk)):
            # no pool room for a private copy of a shared block this
            # chunk writes into: fail this one request, keep serving
            self._prefill_queue.pop(0)
            self.sched.fail_live(slot, "rejected")
            return []
        sb = _bucket(len(chunk), self.serve.prefill_chunk)
        toks = np.zeros((1, sb), np.int32)
        toks[0, :len(chunk)] = chunk
        tables = self._table_row(seq, self.serve.max_blocks_per_seq)[None]
        self.dispatch_shapes.add(("prefill", sb))
        self.forward_dispatches += 1
        t0 = time.monotonic()
        nxt = self._prefill_impl(self._to_device(toks), seq.prefilled,
                                 len(chunk), self._to_device(tables))
        seq.prefilled += len(chunk)
        if seq.prefilled < len(prompt):
            if self.tracer is not None:
                self.tracer.dispatch_s += time.monotonic() - t0
            return []
        self._prefill_queue.pop(0)
        # the prompt's last position yields the first output token, so
        # the slot enters the decode pool one token ahead (one sync)
        return [self._finish_prefill(slot, seq, int(self._fetch(nxt, t0)))]

    def _decode_ready(self, slot: int):
        """A fully prefilled live slot that can take its next write (a
        block for position ``length - 1`` that no one else reads), or
        None; a slot that cannot grow fails alone."""
        seq = self.sched.slots[slot]
        if seq is None or seq.prefilled < len(seq.request.prompt):
            return None             # mid-prefill: not in the decode pool
        if not self.sched.ensure_block(slot) \
                or not self._ensure_private(slot, seq.length - 1,
                                            seq.length):
            # pool exhausted with nothing left to evict: fail THIS
            # request alone; every other stream keeps serving
            self.sched.fail_live(slot, "rejected")
            return None
        return seq

    @torch.no_grad()
    def step(self) -> List[Tuple[int, int]]:
        """One engine iteration: admit, land partial copies, then either
        the fused mixed step, or one prefill chunk followed by the
        verify step (speculation) or one decode token for every live
        slot.  Returns the ``(request id, token)`` pairs emitted."""
        with self.on_stream():
            return self._step()

    def _step(self) -> List[Tuple[int, int]]:
        self._progressed = False
        admitted = self.sched.admit()
        self._track_occupancy()
        if admitted:
            self._progressed = True
        self._prefill_queue.extend(
            (slot, self.sched.slots[slot]) for slot in admitted)
        self._apply_partial_copies()
        if self.serve.mixed_batch == "on":
            return self._step_mixed()
        emitted = self._advance_prefill()
        if self.drafter is not None:
            return self._step_verify(emitted)

        live = [s for s in self.sched.live_slots()
                if self._decode_ready(s) is not None]
        # eviction inside ensure_block / CoW may have retired a later slot
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
        t0 = time.monotonic()
        nxt = self._decode_impl(self._to_device(tokens),
                                self._to_device(lengths),
                                self._to_device(tables))
        nxt = self._fetch(nxt, t0)       # the one host sync per decode
        for j, slot in enumerate(live):
            tok = int(nxt[j])
            self._last_token[slot] = tok
            rid = self.sched.slots[slot].request.id
            emitted.append((rid, tok))
            self._journal_tokens(rid, [tok])
            self.sched.record_token(slot, tok, self.serve.eos_id)
        return emitted

    def _dispatch_lanes(self, rows, width: int):
        """Assemble and run one verify or mixed dispatch over ``rows``,
        each ``(slot, seq, lane tokens, start position)``, at ``width``
        lanes a row: returns the (B, width) greedy tokens on the host and
        the table bucket."""
        serve = self.serve
        Bb = _bucket(len(rows), serve.max_slots)
        nb = max(len(r[1].block_ids) for r in rows)
        NBb = _bucket(nb, serve.max_blocks_per_seq)
        tokens = np.zeros((Bb, width), np.int32)
        lengths = np.zeros((Bb,), np.int32)
        n_valid = np.zeros((Bb,), np.int32)
        tables = np.zeros((Bb, NBb), np.int32)
        for j, (_slot, seq, lanes, start) in enumerate(rows):
            tokens[j, :len(lanes)] = lanes
            n_valid[j] = len(lanes)
            lengths[j] = start
            tables[j] = self._table_row(seq, NBb)
        self.forward_dispatches += 1
        t0 = time.monotonic()
        out = self._lanes_impl(self._to_device(tokens),
                               self._to_device(lengths),
                               self._to_device(n_valid),
                               self._to_device(tables))
        return self._fetch(out, t0), Bb, NBb   # the one sync a dispatch

    def _step_mixed(self) -> List[Tuple[int, int]]:
        """The fused replacement for the prefill-then-decode phases
        (``mixed_batch="on"``): the decode row of every live prefilled
        slot PLUS budget-capped prefill chunks of every mid-prefill
        sequence the step's token budget reaches, in ONE forward.

        Packing: decode rows first (one pending token each), then the
        prefill queue in FIFO order, each sequence contributing
        ``min(prefill_chunk, remaining prompt, remaining budget)``
        tokens.  Per row the unfused invariants hold: the stale-slot
        guard, ensure_block + CoW over the row's write range, and trie
        insertion at full prefill before record_token."""
        serve = self.serve
        emitted: List[Tuple[int, int]] = []
        rows = []                       # (slot, seq, lanes, start)
        prefill = set()                 # ids of the prefill rows' seqs
        for slot in self.sched.live_slots():
            seq = self._decode_ready(slot)
            if seq is not None:
                rows.append((slot, seq, [self._last_token[slot]],
                             seq.length - 1))
        budget = serve.prefill_budget
        for slot, seq in list(self._prefill_queue):
            if budget <= 0:
                break
            if self.sched.slots[slot] is not seq:
                self._drop_queued(seq)
                continue
            prompt = seq.request.prompt
            take = min(serve.prefill_chunk,
                       len(prompt) - seq.prefilled, budget)
            chunk = prompt[seq.prefilled:seq.prefilled + take]
            if not self._ensure_private(slot, seq.prefilled,
                                        seq.prefilled + len(chunk)):
                self._drop_queued(seq)
                self.sched.fail_live(slot, "rejected")
                continue
            budget -= len(chunk)
            rows.append((slot, seq, list(chunk), seq.prefilled))
            prefill.add(id(seq))
        # eviction inside ensure_block / CoW may have retired ANY earlier
        # row's slot: keep rows whose slot still holds the same sequence
        rows = [r for r in rows if self.sched.slots[r[0]] is r[1]]
        self._track_occupancy()
        if not rows:
            return emitted
        self._progressed = True

        Sb = _bucket(max(len(r[2]) for r in rows), serve.prefill_chunk)
        out, Bb, NBb = self._dispatch_lanes(rows, Sb)
        self.dispatch_shapes.add(("mixed", Bb, Sb, NBb))
        for j, (slot, seq, lanes, _start) in enumerate(rows):
            # lane n_valid-1 is what the unfused dispatch consumes
            tok = int(out[j, len(lanes) - 1])
            if id(seq) in prefill:
                seq.prefilled += len(lanes)
                if seq.prefilled < len(seq.request.prompt):
                    continue        # still mid-prefill: no token emitted
                self._drop_queued(seq)
                emitted.append(self._finish_prefill(slot, seq, tok))
                continue
            self._last_token[slot] = tok
            emitted.append((seq.request.id, tok))
            self._journal_tokens(seq.request.id, [tok])
            self.sched.record_token(slot, tok, serve.eos_id)
        return emitted

    def _drop_queued(self, seq) -> None:
        self._prefill_queue = [e for e in self._prefill_queue
                               if e[1] is not seq]

    def _step_verify(self, emitted: List[Tuple[int, int]]) \
            -> List[Tuple[int, int]]:
        """The speculative replacement for the decode phase: draft up to
        the window per live slot, verify every slot's window in ONE
        batched forward, accept the longest argmax-matching draft prefix
        plus the model's own token at the first mismatch, then roll back
        the blocks the rejected tail was parked in.  A slot whose
        drafter proposes nothing rides the same dispatch with one lane,
        an exact one-token decode step."""
        serve = self.serve
        cap = serve.max_blocks_per_seq * serve.block_size
        # the step's window: the configured k, or the EWMA-tuned one
        # (floor 1); the dispatch width stays draft_k + 1 either way
        k_cap = (self._draft_k_eff if serve.draft_auto == "on"
                 else serve.draft_k)
        rows = []
        full_window: dict = {}
        for slot in self.sched.live_slots():
            seq = self.sched.slots[slot]
            if seq is None or seq.prefilled < len(seq.request.prompt):
                continue            # mid-prefill: not in the decode pool
            if not self.sched.ensure_block(slot):
                self.sched.fail_live(slot, "rejected")
                continue
            # bounded so a full accept busts neither the request's
            # budget nor the table capacity
            remaining = seq.request.max_new_tokens - len(seq.generated)
            k = min(k_cap, remaining - 1, cap - seq.length)
            # a row truncated by budget, capacity or pool pressure says
            # nothing about the drafter: the EWMA skips it
            window_full = k >= k_cap
            draft: List[int] = []
            if k > 0:
                ctx = list(seq.request.prompt) + seq.generated
                draft = list(self.drafter.draft(
                    seq.request.id, ctx, k))[:k]
            if draft:
                # cover the window's writes [length-1, length+|d|) with
                # free blocks only: speculation never preempts
                covered = self.sched.extend_for(slot,
                                                seq.length + len(draft))
                if covered - seq.length < len(draft):
                    window_full = False
                draft = draft[:max(0, covered - seq.length)]
            full_window[slot] = window_full
            if not self._ensure_private(slot, seq.length - 1,
                                        seq.length + len(draft)):
                self.sched.fail_live(slot, "rejected")
                continue
            rows.append((slot, seq, [self._last_token[slot]] + draft,
                         seq.length - 1))
        # eviction inside ensure_block / CoW may have retired a later slot
        rows = [r for r in rows if self.sched.slots[r[0]] is not None]
        self._track_occupancy()
        if not rows:
            return emitted
        self._progressed = True

        out, Bb, NBb = self._dispatch_lanes(rows, serve.draft_k + 1)
        self.dispatch_shapes.add(("verify", Bb, NBb))
        counters = self.sched.counters
        for j, (slot, seq, lanes, _start) in enumerate(rows):
            draft = lanes[1:]
            n_acc = 0
            while n_acc < len(draft) and int(out[j, n_acc]) == draft[n_acc]:
                n_acc += 1
            emit = draft[:n_acc] + [int(out[j, n_acc])]
            if serve.eos_id is not None and serve.eos_id in emit:
                emit = emit[:emit.index(serve.eos_id) + 1]
            counters["spec_drafted"] += len(draft)
            counters["spec_accepted"] += min(n_acc, len(emit))
            counters["spec_verify_forwards"] += 1
            counters["spec_emitted"] += len(emit)
            counters["spec_k_sum"] += k_cap
            counters["spec_k_steps"] += 1
            if serve.draft_auto == "on" and draft \
                    and full_window.get(slot, False):
                a = 0.2
                self._accept_ewma = ((1 - a) * self._accept_ewma
                                     + a * n_acc)
            self._last_token[slot] = emit[-1]
            rid = seq.request.id
            emitted.extend((rid, tok) for tok in emit)
            self._journal_tokens(rid, emit)
            self.sched.record_tokens(slot, emit, serve.eos_id)
            if self.sched.slots[slot] is seq:
                # the rejected tail's KV sits in blocks past the accepted
                # length: release them
                self.sched.rollback_blocks(slot, seq.length)
        if serve.draft_auto == "on":
            # one past the recent mean accepted length, in [1, draft_k];
            # round, not ceil, so a near-zero EWMA reaches the floor
            self._draft_k_eff = max(1, min(
                serve.draft_k, int(round(self._accept_ewma)) + 1))
        return emitted

    # ---------------- request loop ----------------

    def run(self, requests: List[sched_lib.Request],
            time_fn=time.perf_counter, *, guard=None, journal=None,
            advisor=None) -> dict:
        """Serve ``requests`` (replayed against their ``arrival`` stamps)
        to completion or graceful drain.  A token's latency is the wall
        time since the previous token of the SAME sequence (first token:
        since arrival, queueing included).  ``guard`` (anything with a
        ``should_stop`` flag) wires a stop request into a graceful drain:
        admission stops, un-admitted work is ``shed``, in-flight work
        finishes within ``serve.drain_ms`` and is otherwise ``drained``.
        ``journal`` (``serving/recovery.ReplayJournal``) records each
        request's prompt and delivered tokens for a replay.  ``advisor``
        (``serving/autoscale.ScaleAdvisor``) observes every iteration;
        its report is the ``autoscale`` block (None without one).  In a
        tensor-parallel world rank 0's clock and stop flag decide for
        every rank; each rank records into its ``journal``, a file on
        rank 0 and its mirror in memory on the others
        (``recovery.ReplayJournal``), so every rank replays alike.
        """
        from mpi_tensorflow_torch.serving.iteration import (DrainTracker,
                                                            EngineLoop)

        serve = self.serve
        loop = EngineLoop(self, journal)
        drain = DrainTracker(serve.drain_ms)
        pending = sorted(requests, key=lambda r: r.arrival)
        t0 = time_fn()
        while pending or not self.sched.all_done():
            now = time_fn() - t0
            stop = guard is not None and guard.should_stop
            if self._reduce is not None:
                now, stop = tp_lib.agree(now, stop)
            if stop and not drain.draining:
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
            if advisor is not None:
                if self.tracer is not None \
                        and self.tracer.last_step is not None:
                    # the advisor reads the step record the trace holds
                    advisor.observe_step(self.tracer.last_step)
                else:
                    advisor.observe(now, **self.load_signals())
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
        if self.drafter is not None:
            self.drafter.check_quiescent()
        outputs = {s.request.id: list(s.generated)
                   for s in self.sched.finished}
        total = sum(len(v) for v in outputs.values())
        flat = loop.latencies()
        lat = np.asarray(flat) if flat else np.zeros(1)
        res = {
            "outputs": outputs,
            "statuses": dict(self.sched.statuses),
            "faults": metrics_writer.faults_block(self.sched.counters),
            "drain": drain.result(len(self.sched.finished),
                                  self.sched.counters["drained"]),
            "kernel": self.kernel,
            "kv_dtype": serve.kv_dtype,
            "device": device_name(self.device),
            "prefix": self.prefix_block(),
            "speculation": self.speculation_block(),
            "tier": self.tier_block(),
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
            "autoscale": (advisor.report() if advisor is not None
                          else None),
        }
        if self.tracer is not None:
            # the key exists only with tracing on
            h = self.tracer.harvest(elapsed)
            res["trace"] = {
                "enabled": True,
                "replicas": [{"pid": 0, "label": "engine", **h}],
                "spans": h["spans"],
                "steps": len(h["steps"]),
                "steps_dropped": h["steps_dropped"],
            }
        return res

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

    def prefix_block(self) -> dict:
        """The run's ``prefix`` block (``metrics_writer.prefix_block``)."""
        return metrics_writer.prefix_block(
            self.sched.counters, enabled=self.prefix_cache is not None,
            trie_blocks=(self.prefix_cache.num_blocks
                         if self.prefix_cache is not None else 0))

    def speculation_block(self) -> dict:
        """The run's ``speculation`` block."""
        return metrics_writer.speculation_block(
            self.sched.counters, enabled=self.drafter is not None,
            mode=self.serve.speculative, draft_k=self.serve.draft_k,
            draft_auto=self.serve.draft_auto)

    def tier_block(self) -> dict:
        """The run's ``tier`` block (all zero with tiering off)."""
        if self.tier is None:
            return metrics_writer.tier_block()
        s = self.tier.stats()
        return metrics_writer.tier_block(
            enabled=True, mode=self.serve.kv_tier,
            demotions=s["demotions"], promotions=s["promotions"],
            host_blocks=s["host_blocks"],
            host_blocks_peak=s["host_blocks_peak"],
            promote_ms_total=s["promote_ms_total"],
            block_size=self.serve.block_size)
