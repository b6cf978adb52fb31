"""Speculative decoding drafters: propose k tokens, verify in ONE forward.

Counterpart of ``mpi_tensorflow_tpu/serving/speculative.py``.  A cheap
DRAFTER proposes up to ``k`` tokens; the engine runs the pending token
plus the draft through one ``draft_k + 1``-wide forward of the target
model (``PagedDecodeEngine._step_verify``), accepts the longest prefix
that matches the target's greedy argmax chain and emits the target's own
token at the first mismatch.  Every emitted token is an argmax of the
target over exactly the context one-token decoding would have used, so
the greedy stream is the same with speculation on or off; the drafter
decides only how many tokens a verify forward yields.

- ``NgramDrafter``: self-draft from the sequence's own prompt and
  output, host code only; its drafts are the reference's, token for
  token.
- ``DraftModelDrafter``: a small ``CausalLm`` running ahead of the
  target through its OWN paged pool and ``forward_paged``, with the
  paged-attention lowering the engine resolved (the CUDA kernel on the
  card).  The reference needs its bucketed shapes for jit; eager
  PyTorch keeps the same pow2 chunk buckets so both feed the same
  lanes.

Both are host-side policy objects: the engine asks ``draft(rid, ctx,
k)``, reports ``release(rid)`` when a request terminates and
``reset()`` when its pools are rebuilt, and audits ``check_quiescent()``
at the end of a run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from mpi_tensorflow_torch.serving.paged_cache import (BlockAllocator,
                                                      blocks_for, init_pools)


class Drafter:
    """The drafter protocol (default: a stateless no-op lifecycle).

    ``draft(rid, ctx, k)`` returns UP TO ``k`` proposed continuation
    tokens for request ``rid`` whose verified context (prompt + accepted
    tokens, the pending one included) is ``ctx``.  Proposals are hints:
    the engine verifies each one through the target model."""

    def draft(self, rid: int, ctx: List[int], k: int) -> List[int]:
        raise NotImplementedError

    def release(self, rid: int) -> None:
        """Request ``rid`` left the engine (any terminal status)."""

    def reset(self) -> None:
        """The engine rebuilt its pools."""

    def check_quiescent(self) -> None:
        """End-of-run leak audit (pairs with Scheduler.check_quiescent)."""


#: the n-gram windows the self-drafter tries, longest first
MAX_NGRAM = 4
MIN_NGRAM = 1


class NgramDrafter(Drafter):
    """Suffix-match self-draft: propose the continuation that followed
    the context's final n-gram the LAST time it occurred in the
    sequence's own prompt + generated stream.  For n from ``MAX_NGRAM``
    down to ``MIN_NGRAM``, the most recent occurrence with a full
    ``k``-token continuation wins; else the longest partial one."""

    def draft(self, rid: int, ctx: List[int], k: int) -> List[int]:
        L = len(ctx)
        if k < 1 or L < MIN_NGRAM + 1:
            return []
        for n in range(min(MAX_NGRAM, L - 1), MIN_NGRAM - 1, -1):
            suffix = ctx[L - n:]
            best: List[int] = []
            for i in range(L - n - 1, -1, -1):
                if ctx[i:i + n] != suffix:
                    continue
                cont = ctx[i + n:i + n + k]
                if len(cont) == k:
                    return cont          # most recent FULL window
                if len(cont) > len(best):
                    best = cont
            if best:
                return best
        return []


@dataclasses.dataclass
class _DraftState:
    """One request's footprint in the draft pool: its block table and
    how many VERIFIED context tokens have KV in it (drafted tokens'
    entries are speculative and get overwritten by the next sync)."""
    blocks: List[int] = dataclasses.field(default_factory=list)
    cached: int = 0
    last_used: int = 0


class DraftModelDrafter(Drafter):
    """Small-model drafter over its own paged KV pool.

    Per call it syncs the unseen verified context through pow2-bucketed
    chunk feeds (the engine's prefill discipline, a full-width table),
    then extends ``k`` tokens one greedy feed at a time.  A request's
    context never changes under greedy decoding, so cached draft KV
    stays valid across calls and across target-engine evictions.  Under
    pool pressure other requests' draft state is dropped LRU-first (it
    is a pure cache) and ``k`` shrinks to the coverage left.

    ``model`` (a ``models.gpt.CausalLm``) must already sit on
    ``device``; ``kernel`` is a resolved lowering (``gather`` or
    ``cuda``).  ``feeds`` counts the draft model's forwards: each
    launches the paged kernel once per draft layer under ``cuda``."""

    def __init__(self, model, *, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int, device, chunk: int,
                 kernel: str, kv_dtype: str, kv_group: int):
        self.model = model
        self.device = torch.device(device)
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.chunk = chunk
        self.kernel = kernel
        # the draft pool takes the fleet's kv_dtype: drafts are verified
        # by the target, so its rounding can change only which tokens
        # get drafted, never what is emitted
        self.kv_dtype = kv_dtype
        self.kv_group = kv_group
        self.feeds = 0
        self._clock = 0
        self.reset()

    def reset(self) -> None:
        self.pools = init_pools(self.model.cfg, self.num_blocks,
                                self.block_size, self.device,
                                self.kv_dtype, self.kv_group)
        self.allocator = BlockAllocator(self.num_blocks)
        self._state: Dict[int, _DraftState] = {}

    # ---------------- the feed ----------------

    @torch.no_grad()
    def _feed(self, toks, length: int, tables, *, bucket: int) -> int:
        """One (1, bucket) forward through the draft model: writes the
        real lanes' KV (padding lanes go to the null block) and returns
        the greedy token after the last real lane."""
        n_real = len(toks)
        buf = np.zeros((1, bucket), np.int64)
        buf[0, :n_real] = toks
        dev = self.device
        valid = torch.arange(bucket, device=dev)[None] < n_real
        logits = self.model.forward_paged(
            torch.from_numpy(buf).to(dev), self.pools, tables,
            torch.tensor([length], dtype=torch.int32, device=dev), valid,
            kernel=self.kernel)
        self.feeds += 1
        return int(torch.argmax(logits[0, max(n_real - 1, 0)], dim=-1))

    # ---------------- pool management ----------------

    def _evict_lru(self, protect: int) -> bool:
        """Drop the least-recently-used OTHER request's draft state."""
        victims = [(st.last_used, rid) for rid, st in self._state.items()
                   if rid != protect and st.blocks]
        if not victims:
            return False
        _, rid = min(victims)
        self.release(rid)
        return True

    def release(self, rid: int) -> None:
        st = self._state.pop(rid, None)
        if st is not None and st.blocks:
            self.allocator.release(st.blocks)

    def check_quiescent(self) -> None:
        if self.allocator.num_used != 0:
            raise AssertionError(
                f"draft pool leak: {self.allocator.num_used} blocks still "
                f"referenced after every request terminated")
        self.allocator.check()

    # ---------------- the draft call ----------------

    def draft(self, rid: int, ctx: List[int], k: int) -> List[int]:
        st = self._state.setdefault(rid, _DraftState())
        self._clock += 1
        st.last_used = self._clock
        if st.cached >= len(ctx):
            # the target restarted this request (eviction replay): the
            # regenerated stream is the same, so the cached prefix stays
            # valid; re-feed the tail to recover the logits cursor
            st.cached = len(ctx) - 1
        # never draft past the table capacity the pool can address
        k = min(k, self.max_blocks_per_seq * self.block_size - len(ctx))
        if k < 1:
            return []
        need = blocks_for(len(ctx) + k, self.block_size)
        while len(st.blocks) < need:
            # an LRU eviction frees at least one block (draft blocks are
            # never shared), so one retry suffices
            if not self.allocator.can_alloc(1) and not self._evict_lru(rid):
                break
            st.blocks.extend(self.allocator.alloc(1))
        k = min(k, len(st.blocks) * self.block_size - len(ctx))
        if k < 1:
            return []
        tables = np.zeros((1, self.max_blocks_per_seq), np.int32)
        tables[0, :len(st.blocks)] = st.blocks
        tables = torch.from_numpy(tables).to(self.device)
        # sync the unseen verified context through chunk buckets
        last = None
        pos = st.cached
        while pos < len(ctx):
            part = ctx[pos:pos + self.chunk]
            b = 1
            while b < len(part):
                b *= 2
            last = self._feed(part, pos, tables, bucket=b)
            pos += len(part)
        st.cached = len(ctx)
        # autoregressive extension: each drafted token is fed back at
        # the next position (its KV is speculative: ``cached`` stays at
        # len(ctx), so the next sync overwrites it)
        out = [last]
        for i in range(k - 1):
            out.append(self._feed([out[-1]], len(ctx) + i, tables,
                                  bucket=1))
        return out


def default_draft_model(target_cfg):
    """The stand-in drafter when none is given: ``BERT_TINY`` geometry
    on the target's vocabulary and dtype, rope positions (so the draft
    capacity meets no learned-position bound the target does not have),
    random weights from ``torch.Generator`` seed 7.  The reference draws
    its weights from ``jax.random.key(7)``, which the port cannot
    reproduce: the parity tests inject the draft parameters instead."""
    from mpi_tensorflow_torch.models import bert as bert_lib
    from mpi_tensorflow_torch.models.gpt import CausalLm

    cfg = dataclasses.replace(
        bert_lib.BERT_TINY, vocab_size=target_cfg.vocab_size,
        dtype=target_cfg.dtype, pos_kind="rope", ce_positions="all",
        dropout=0.0)
    return CausalLm.from_seed(cfg, seed=7)


def make_drafter(mode: str, serve, target_model, *, device,
                 draft_model=None):
    """The drafter ``serve.speculative`` names (None for ``off``).

    ``draft-model`` drafts with ``draft_model`` when given (a
    ``CausalLm``; the tests pass the target itself for the all-accept
    path, or a small model with the reference's parameters), else with
    ``default_draft_model``.  Its lowering is ``serve.kernel`` resolved
    on ``device``, as the engine's."""
    if mode == "off":
        return None
    if mode == "ngram":
        return NgramDrafter()
    if mode != "draft-model":
        raise ValueError(
            f"speculative mode must be off|ngram|draft-model, got {mode!r}")
    from mpi_tensorflow_torch.ops import paged_attention as paged_ops

    if draft_model is None:
        draft_model = default_draft_model(target_model.cfg)
    return DraftModelDrafter(
        draft_model.to(device),
        num_blocks=serve.num_blocks, block_size=serve.block_size,
        max_blocks_per_seq=serve.max_blocks_per_seq, device=device,
        chunk=min(16, serve.prefill_chunk),
        kernel=paged_ops.resolve_kernel(serve.kernel, device),
        kv_dtype=serve.kv_dtype, kv_group=serve.kv_group)
