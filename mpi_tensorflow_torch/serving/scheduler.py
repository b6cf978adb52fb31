"""Continuous-batching scheduler: request queue + decode-slot state.

Counterpart of ``mpi_tensorflow_tpu/serving/scheduler.py``, ported whole:
the same admission, eviction, fault policy and terminal statuses, so the
port and the reference make identical decisions on the same requests.
The radix prefix cache is not ported yet (ROADMAP Queue 1): its
branches stay behind ``prefix_cache is not None`` and the engine passes
None.

Orca-style iteration-level scheduling (Yu et al., OSDI 2022): the unit
of work is ONE decode step over whatever sequences are live, not one
request batch end-to-end.  A sequence joins as soon as a slot AND the
blocks for its prompt are free (admit-on-free-blocks), and its slot is
recycled the step it finishes (EOS or token budget) — a long request no
longer holds a whole batch hostage, and finished rows stop burning device
cycles on masked steps.

Failure handling is structured, never an engine crash: every request
leaves the system with exactly one terminal status —

- ``ok``                 finished (EOS or token budget);
- ``rejected``           infeasible at submit (can never fit the pool /
                         malformed), or — defensively — a live sequence
                         the pool can no longer grow with nothing left
                         to evict;
- ``shed``               dropped by load shedding: the bounded waiting
                         queue was full (reject-newest, ``queue_full``),
                         or admission stopped for a drain;
- ``deadline_exceeded``  its deadline passed before completion;
- ``evicted_too_often``  preempted more than ``max_evictions`` times
                         (livelock guard: requeue-at-head forever is a
                         starvation engine, not progress);
- ``drained``            in flight when a graceful drain's budget
                         expired (the engine cut it off incomplete).

All state here is host-side Python; the engine turns the live slot set
into bucketed device dispatches.  Pure-Python on purpose: the
admit/evict invariant tests run without a device.
"""

from __future__ import annotations

import dataclasses
from collections import Counter, deque
from typing import Callable, Dict, List, Optional

from mpi_tensorflow_torch.serving.paged_cache import (BlockAllocator,
                                                      blocks_for)

#: every terminal status a request can leave the scheduler with
TERMINAL_STATUSES = ("ok", "rejected", "shed", "deadline_exceeded",
                     "evicted_too_often", "drained")


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival`` is in seconds on the caller's
    clock; the engine admits a request only once the clock passes it
    (the serving entry point replays Poisson traces through this).
    ``deadline`` is an absolute stamp on the same clock: a request not
    COMPLETE by then fails with ``deadline_exceeded`` instead of
    occupying a slot (None = no deadline)."""
    id: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0
    deadline: Optional[float] = None
    replayed: bool = False        # crash-recovery resubmission: it
                                  # passed admission control once and
                                  # carries delivered tokens, so load
                                  # shedding must not drop it (the
                                  # feasibility check still applies)
    session: Optional[object] = None  # conversation/session key for the
                                  # replica router (serving/router):
                                  # requests sharing a session stick to
                                  # one replica, where their prefix
                                  # blocks and drafter state live.
                                  # None = no affinity (each request
                                  # places independently by load)


@dataclasses.dataclass(frozen=True)
class RejectedRequest:
    """Structured admission refusal — the submit() result that replaces
    the engine-killing exception.  ``reason`` is the machine-readable
    cause (``infeasible`` | ``bad_request`` | ``queue_full``); ``status``
    is the terminal status recorded for the request."""
    request: Request
    reason: str
    status: str

    def __bool__(self) -> bool:          # `if sched.submit(req):` reads
        return True                      # as "was it rejected"


@dataclasses.dataclass
class Sequence:
    """A live (admitted) sequence: its pool blocks + progress.

    ``prefix_cached`` prompt tokens were served by the radix prefix
    cache at admission: their blocks are SHARED physical blocks mapped
    straight into ``block_ids`` and ``prefilled`` starts there, so the
    prefill dispatches only ever compute the unique suffix."""
    request: Request
    block_ids: List[int]
    prefilled: int = 0            # prompt tokens already through prefill
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    prefix_cached: int = 0        # prompt tokens served by cache hits
    # Partial tail-block sharing (prefix v2): admission matched
    # ``partial_rows`` leading tokens of this sequence's tail block
    # against cached block ``partial_src`` (pinned: one share ref held
    # until the engine's partial-copy dispatch lands or the sequence
    # leaves the slot) to be copied into its private ``partial_dst``.
    # ``prefilled`` already counts those rows — the engine MUST apply
    # the copy before the first prefill chunk touches the slot.
    partial_src: Optional[int] = None
    partial_dst: int = 0
    partial_rows: int = 0

    @property
    def length(self) -> int:
        """Prompt tokens prefilled + tokens generated.  The LAST
        generated token is pending — emitted but not yet written to the
        cache (the next decode step writes it at position length-1 as it
        reads it), so the cache holds ``length - 1`` entries between
        steps."""
        return self.prefilled + len(self.generated)


class Scheduler:
    """Slots + queue + the block-accounting policy.

    ``max_slots`` bounds concurrent sequences (the decode batch
    dimension); ``max_blocks_per_seq`` bounds one sequence's table (the
    gathered attention capacity).  Admission requires a free slot AND
    enough free blocks for the whole prompt plus one decode block — a
    sequence that prefills must be able to emit at least one token.

    Under pool pressure (a decode step needs a new block and none is
    free) the YOUNGEST sequence is evicted back to the queue head —
    restart-from-scratch preemption, blocks freed, FIFO fairness for the
    oldest.  Invariants (pinned by tests): a block belongs to at most
    one live sequence; evicted/finished/failed sequences return every
    block; free+used always partitions the pool.

    Robustness knobs (all optional; None keeps the unguarded behavior):

    - ``queue_depth``     bounds ``waiting``; a submit that finds it full
                          is load-shed (reject-newest, ``queue_full``) —
                          backpressure instead of unbounded buildup.
    - ``max_evictions``   a request may be evicted-and-requeued at most
                          this many times; the next eviction fails it
                          with ``evicted_too_often``.
    - ``starvation_steps``  aging guard: when the HEAD of the queue (the
                          oldest request, including evicted requeues)
                          has been block-starved for this many admit
                          calls, sequences YOUNGER than it are preempted
                          to free blocks for it — a hot arrival stream
                          cannot park old work forever.
    - ``on_terminal(request, status)``  fired exactly once per request
                          as it leaves the system (journal hook).
    - ``prefix_cache``    radix prefix cache (serving/prefix_cache);
                          admission maps cached full prompt blocks into
                          the new sequence's table (shared, refcounted)
                          and charges it only for the unique suffix.
                          Under pool pressure, unreferenced cached
                          blocks are LRU-evicted BEFORE any live
                          sequence is preempted.  None = sharing off —
                          byte-for-byte today's behavior.
    - ``prefix_gen``      prefix sharing v2 (--serve-prefix-gen): a
                          finishing sequence inserts its full blocks
                          spanning prompt + generated output into the
                          trie (before its own release, so the blocks
                          survive by the trie's share ref), and
                          admission extends a mid-block miss with a
                          partial tail-block copy.  Off = the trie
                          holds full PROMPT blocks only, byte-for-byte
                          the v1 behavior.
    """

    def __init__(self, allocator: BlockAllocator, max_slots: int,
                 block_size: int, max_blocks_per_seq: int, *,
                 queue_depth: Optional[int] = None,
                 max_evictions: Optional[int] = None,
                 starvation_steps: Optional[int] = 64,
                 on_terminal: Optional[Callable[[Request, str],
                                                None]] = None,
                 prefix_cache: Optional[object] = None,
                 prefix_gen: bool = False):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.allocator = allocator
        self.max_slots = max_slots
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.queue_depth = queue_depth
        self.max_evictions = max_evictions
        self.starvation_steps = starvation_steps
        self.on_terminal = on_terminal
        self.prefix_cache = prefix_cache
        self.prefix_gen = prefix_gen
        self.waiting: deque = deque()
        self.slots: List[Optional[Sequence]] = [None] * max_slots
        self.finished: List[Sequence] = []
        self.failed: List[Request] = []
        self.statuses: Dict[int, str] = {}     # request id -> terminal
        self.counters: Counter = Counter()     # faults_block feeds off this
        self.evictions = 0
        self.evicted_ids: List[int] = []   # request ids, drained by the
                                           # engine's latency accounting
        self.evict_counts: Counter = Counter()  # per-request preemptions
        self._head_blocked = 0             # admit calls the queue head has
                                           # been starved of blocks
        self._head_blocked_id = None       # ...and WHICH head: credit must
                                           # not transfer to a successor

    # ---------------- terminal bookkeeping ----------------

    def _terminal(self, req: Request, status: str) -> None:
        """Record a request's one terminal status (+ journal hook)."""
        self.statuses[req.id] = status
        if status != "ok":
            self.counters[status] += 1
            self.failed.append(req)
        if self.on_terminal is not None:
            self.on_terminal(req, status)

    # ---------------- queue / admission ----------------

    def submit(self, req: Request,
               front: bool = False) -> Optional[RejectedRequest]:
        """Feasibility-checked admission to the waiting queue.  Returns
        None on accept, a structured ``RejectedRequest`` otherwise — an
        infeasible or malformed request terminates with a status; it
        never raises into (and never crashes) the engine.

        ``front`` queues ahead of already-waiting work: a request
        migrated off a failed replica (or replayed after a crash)
        already waited its turn once — arriving behind this replica's
        newer arrivals would double-charge it the queueing delay."""
        if not req.prompt or req.max_new_tokens < 1:
            return self._reject(req, "bad_request", "rejected")
        total = len(req.prompt) + req.max_new_tokens
        cap = self.max_blocks_per_seq * self.block_size
        pool_cap = (self.allocator.num_blocks - 1) * self.block_size
        if total > cap or total > pool_cap:
            # can NEVER fit, even with every other sequence evicted —
            # admitting it would guarantee a mid-stream dead end
            return self._reject(req, "infeasible", "rejected")
        if self.queue_depth is not None and not req.replayed \
                and len(self.waiting) >= self.queue_depth:
            # bounded queue: reject-newest load shedding (the oldest
            # waiting work keeps its place; backpressure lands on the
            # arrival stream, where the client can retry elsewhere).
            # Replayed requests are exempt: shedding recovered work
            # would orphan its already-delivered prefix
            return self._reject(req, "queue_full", "shed")
        if front:
            self.waiting.appendleft(req)
        else:
            self.waiting.append(req)
        return None

    def _reject(self, req: Request, reason: str,
                status: str) -> RejectedRequest:
        self._terminal(req, status)
        return RejectedRequest(req, reason, status)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def admit(self) -> List[int]:
        """Admit queued requests while a slot and blocks are free.
        Returns the slot indices admitted this call (they need prefill).
        FIFO head-of-line: if the oldest request does not fit, nothing
        behind it jumps the queue — admission order stays arrival order
        (the latency numbers the entry point reports depend on it).

        Aging guard: a head blocked on blocks for ``starvation_steps``
        consecutive admit calls preempts sequences YOUNGER than itself
        to free the blocks it needs — requeued (evicted) old work makes
        progress even under a hot stream of later arrivals.

        Prefix sharing: the head's prompt is first walked through the
        radix cache — every cached full block is mapped (shared) into
        the new table and the admission is charged only for the unique
        suffix, so a hot system prompt costs its blocks ONCE across the
        whole pool.  The matched blocks are pinned (one reference) for
        the duration of the attempt, so the trie eviction that reclaim
        may trigger can never free them out from under the admit.

        Hit-aware admission: ONLY when the head is block-starved (the
        aging guard included could not unblock it), the rest of the
        queue is scanned for the closest request whose cached prefix
        makes it fit in the blocks actually free — its cached blocks
        cost nothing and only its unique suffix takes free blocks, so
        the pool does useful work instead of idling.  The suffix DOES
        delay the head, which is why the bypass runs only while the
        aging guard is armed (``starvation_steps`` not None): the
        guard bounds how long the head can be bypassed before younger
        live work is preempted for it.  With no pressure, admission
        order stays strict FIFO (pinned by tests)."""
        admitted = []
        while self.waiting:
            slot = self.free_slot()
            if slot is None:
                break
            req = self.waiting[0]
            cached_ids: List[int] = []
            cached_tokens = 0
            if self.prefix_cache is not None:
                cached_ids, cached_tokens = \
                    self.prefix_cache.match_and_share(req.prompt)
            need = blocks_for(len(req.prompt) + 1, self.block_size) \
                - len(cached_ids)
            if not self._reclaim(need):
                if cached_ids:
                    # un-pin this attempt's matched blocks; the trie
                    # keeps them and the next attempt re-matches
                    self.allocator.release(cached_ids)
                if self._head_blocked_id != req.id:
                    # a different head (the old one admitted/expired):
                    # starvation credit starts over
                    self._head_blocked_id = req.id
                    self._head_blocked = 0
                self._head_blocked += 1
                if self.starvation_steps is not None \
                        and self._head_blocked > self.starvation_steps \
                        and self._evict_youngest(
                            protect=None, younger_than=req.arrival,
                            requeue_pos=1):
                    # victim requeues BEHIND the aged head (position 1):
                    # appendleft would put younger work back in front of
                    # the very request the guard exists to unblock
                    continue
                if self._admit_hit_aware(slot):
                    # a cached-prefix request from behind the starved
                    # head fit in the FREE blocks: keep admitting (the
                    # head's starvation credit above keeps aging — the
                    # bypass must not reset it)
                    admitted.append(slot)
                    continue
                break
            self._head_blocked = 0
            self.waiting.popleft()
            self._admit_to(slot, req, cached_ids, cached_tokens, need)
            admitted.append(slot)
        return admitted

    def _admit_to(self, slot: int, req: Request, cached_ids: List[int],
                  cached_tokens: int, need: int) -> None:
        """Install ``req`` into ``slot`` with its matched prefix blocks
        plus ``need`` fresh ones — the one admission tail shared by the
        FIFO path and the hit-aware bypass."""
        if self.prefix_cache is not None:
            self.counters["prefix_prompt_tokens"] += len(req.prompt)
            self.counters["prefix_hit_tokens"] += cached_tokens
            self.counters["prefix_shared_blocks"] += len(cached_ids)
        partial = None
        if (self.prefix_gen and self.prefix_cache is not None
                and cached_tokens == len(cached_ids) * self.block_size):
            # the full-block walk ended on a real miss (an uncapped
            # match — a capped one means the whole prompt is cached and
            # the tail recompute is the match_and_share rule, not a
            # miss): try to serve the tail block's leading rows from
            # the best-matching cached sibling.  ``need >= 1`` is
            # guaranteed here (the uncached suffix is non-empty), so
            # the first fresh block below IS the copy destination.
            partial = self.prefix_cache.match_partial(
                req.prompt, len(cached_ids))
        blocks = cached_ids + self.allocator.alloc(need)
        seq = Sequence(req, blocks, prefilled=cached_tokens,
                       prefix_cached=cached_tokens)
        if partial is not None:
            src, rows = partial
            seq.partial_src = src
            seq.partial_dst = blocks[len(cached_ids)]
            seq.partial_rows = rows
            seq.prefilled = seq.prefix_cached = cached_tokens + rows
            self.counters["prefix_partial_copy_tokens"] += rows
        self.slots[slot] = seq

    def _admit_hit_aware(self, slot: int) -> bool:
        """The block-starved bypass: admit the closest queued request
        whose cached prefix lets it fit in the blocks FREE RIGHT NOW
        (``can_alloc``, not ``_reclaim`` — the bypass must neither
        evict live work nor shrink the trie on behalf of younger
        arrivals, and a candidate with no hits at all has no claim to
        jump FIFO).  Disabled when the aging guard is off: the
        jumper's unique suffix consumes free blocks the head is
        waiting on, and without ``starvation_steps`` bounding the
        head's wait that would be an unbounded-bypass liveness hole.
        The scan is WINDOWED (closest 16 queued requests): admit() runs
        every engine step, and each candidate costs a radix-trie walk
        plus share/release refcount churn — an O(whole-queue) rescan
        per step under sustained pressure would make admission itself
        the hot path.  Returns whether a request was admitted."""
        if self.prefix_cache is None or self.starvation_steps is None:
            return False
        for qi in range(1, min(len(self.waiting), 17)):
            req = self.waiting[qi]
            cached_ids, cached_tokens = \
                self.prefix_cache.match_and_share(req.prompt)
            if not cached_ids:
                continue
            need = blocks_for(len(req.prompt) + 1, self.block_size) \
                - len(cached_ids)
            if self.allocator.can_alloc(need):
                del self.waiting[qi]
                self.counters["prefix_hit_admissions"] += 1
                self._admit_to(slot, req, cached_ids, cached_tokens,
                               need)
                return True
            self.allocator.release(cached_ids)
        return False

    # ---------------- per-step bookkeeping ----------------

    def _release_partial(self, seq: Sequence) -> None:
        """Drop the partial-copy source pin (if any) — called by the
        engine once its copy dispatch lands, and by every path that
        removes the sequence from its slot first (eviction, failure,
        finish) so the pin can never outlive the sequence."""
        if seq.partial_src is not None:
            self.allocator.release([seq.partial_src])
            seq.partial_src = None
            seq.partial_rows = 0

    def live_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.prefilled > 0]

    def occupied_view(self) -> List[tuple]:
        """Observation snapshot for the tracing layer: ``(request id,
        prefilled, generated)`` for every occupied slot — including
        admitted-but-unprefilled sequences ``live_slots`` skips, which
        is exactly the admission transition the tracer stamps.  Plain
        ints, no sequence references escape."""
        return [(s.request.id, s.prefilled, len(s.generated))
                for s in self.slots if s is not None]

    @property
    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens of admitted sequences not yet prefilled — the
        head-of-line work queue depth misses: these sequences hold
        slots (and pool blocks) but emit nothing until their prefill
        lands, so load signals counting only the waiting queue
        under-report pressure exactly when prompts are long.  The
        autoscale load signal folds this in (engine.load_signals /
        ScaleAdvisor), and mixed batching drains it under the per-step
        token budget."""
        return sum(len(s.request.prompt) - s.prefilled
                   for s in self.slots
                   if s is not None
                   and s.prefilled < len(s.request.prompt))

    def _reclaim(self, n: int) -> bool:
        """``can_alloc`` with prefix-cache backpressure: under pool
        pressure, LRU-evict unreferenced cached blocks from the trie
        before reporting failure — sharing must never starve admission
        or decode growth.  Sequence eviction stays the CALLER'S
        fallback (and is re-followed by a reclaim: a preempted victim's
        release can leave blocks pinned only by the trie)."""
        if self.allocator.can_alloc(n):
            return True
        if self.prefix_cache is not None:
            freed = self.prefix_cache.evict(n - self.allocator.num_free)
            if freed:
                self.counters["prefix_trie_evictions"] += freed
        return self.allocator.can_alloc(n)

    def alloc_for(self, slot: int) -> Optional[int]:
        """One fresh exclusive block for ``slot`` (table growth or a
        copy-on-write target), evicting trie entries then younger
        sequences under pressure.  None = pool exhausted with nothing
        left to evict — the caller fails this one request."""
        while not self._reclaim(1):
            if not self._evict_youngest(protect=slot):
                return None
        return self.allocator.alloc(1)[0]

    def ensure_block(self, slot: int) -> bool:
        """Make sure the slot's table covers cache position ``length-1``
        (where this step writes the pending token, growing the cache to
        ``length`` entries).  Returns False when the pool is exhausted
        AND eviction could not free a block for this slot."""
        seq = self.slots[slot]
        need = blocks_for(seq.length, self.block_size)
        while len(seq.block_ids) < need:
            b = self.alloc_for(slot)
            if b is None:
                return False
            seq.block_ids.append(b)
        return True

    def extend_for(self, slot: int, total_tokens: int) -> int:
        """Opportunistically grow the slot's table to cover
        ``total_tokens`` cache entries (a speculative draft window
        writes up to k tokens past the pending one) WITHOUT preemption
        or trie eviction: speculation is a bandwidth optimization, and
        letting it evict live sequences or cached prefixes would trade
        real work for guessed work.  Takes only free blocks; returns
        the entries the table now covers — the caller shrinks its draft
        to fit."""
        seq = self.slots[slot]
        want = min(blocks_for(total_tokens, self.block_size),
                   self.max_blocks_per_seq)
        extra = want - len(seq.block_ids)
        if extra > 0 and self.allocator.can_alloc(extra):
            seq.block_ids.extend(self.allocator.alloc(extra))
        return len(seq.block_ids) * self.block_size

    def rollback_blocks(self, slot: int, keep_tokens: int) -> int:
        """Release the slot's trailing blocks beyond what
        ``keep_tokens`` cache entries need — the draft-rollback path: a
        verify step that rejected draft tokens returns the blocks that
        existed only to hold their (phantom) KV writes, so the pool
        never retains entries no accepted token owns.  Safe with prefix
        sharing: trailing blocks past the live length are exclusive by
        construction (admission-mapped shared blocks all precede it),
        and the refcounted release would protect a sharer anyway.
        Returns the number of blocks released."""
        seq = self.slots[slot]
        keep = max(blocks_for(keep_tokens, self.block_size), 1)
        if len(seq.block_ids) <= keep:
            return 0
        victims = seq.block_ids[keep:]
        del seq.block_ids[keep:]
        self.allocator.release(victims)
        return len(victims)

    def _evict_youngest(self, protect: Optional[int],
                        younger_than: Optional[float] = None,
                        requeue_pos: int = 0) -> bool:
        """Preempt the youngest live sequence (restart-from-scratch):
        free its blocks, requeue its request at ``requeue_pos`` in the
        queue (0 = the head, so it re-admits before anything that
        arrived after it).  ``younger_than`` restricts candidates to
        arrivals strictly after that stamp (the aging guard must never
        preempt work older than the request it serves).  A victim past
        its ``max_evictions`` budget is failed with ``evicted_too_often``
        instead of requeued — its blocks still free, so the caller's
        allocation can proceed either way.

        Frees route through the refcounted ``release``: evicting a
        victim that SHARES prefix blocks with live sequences (or the
        trie) only drops its references — the survivors' tables stay
        intact (regression-pinned by tests/test_serving.py)."""
        candidates = [(self.slots[i].request.arrival, i)
                      for i in range(self.max_slots)
                      if self.slots[i] is not None and i != protect
                      and (younger_than is None
                           or self.slots[i].request.arrival > younger_than)]
        if not candidates:
            return False
        _, victim = max(candidates)
        seq = self.slots[victim]
        self.allocator.release(seq.block_ids)
        self._release_partial(seq)
        self.slots[victim] = None
        self.evictions += 1
        self.counters["evictions"] += 1
        self.evicted_ids.append(seq.request.id)
        self.evict_counts[seq.request.id] += 1
        if self.max_evictions is not None \
                and self.evict_counts[seq.request.id] > self.max_evictions:
            # livelock guard: K restarts bought no completion — fail it
            # rather than let requeue-at-head churn the pool forever
            self._terminal(seq.request, "evicted_too_often")
            return True
        if requeue_pos <= 0 or not self.waiting:
            self.waiting.appendleft(seq.request)
        else:
            self.waiting.insert(requeue_pos, seq.request)
        return True

    def record_token(self, slot: int, token: int,
                     eos_id: Optional[int] = None) -> None:
        """Account one generated token; finish + recycle the slot when
        the sequence hits EOS or its budget."""
        seq = self.slots[slot]
        seq.generated.append(token)
        if (len(seq.generated) >= seq.request.max_new_tokens
                or (eos_id is not None and token == eos_id)):
            seq.done = True
            self._release_partial(seq)
            if self.prefix_gen and self.prefix_cache is not None:
                # generated-block insertion (prefix v2): adopt the full
                # blocks spanning prompt + generated BEFORE this
                # sequence's release below, so they survive by the
                # trie's own share refs (check_quiescent's
                # trie-only-refs rule).  Only the ``length - 1`` cache
                # entries actually WRITTEN are insertable — the final
                # token is pending, and under speculation positions
                # past it hold rejected phantom writes.
                stream = list(seq.request.prompt) + seq.generated
                added = self.prefix_cache.insert(
                    stream[:seq.length - 1], seq.block_ids)
                self.counters["prefix_gen_inserted_blocks"] += added
            self.allocator.release(seq.block_ids)
            seq.block_ids = []
            self.finished.append(seq)
            self.slots[slot] = None
            self._terminal(seq.request, "ok")

    def record_tokens(self, slot: int, tokens: List[int],
                      eos_id: Optional[int] = None) -> int:
        """Multi-token append — the speculative-decoding extension of
        the one-token-per-step contract: a verify step emits a VARIABLE
        number of tokens per sequence (accepted draft prefix + the
        model's own correction).  Stops the moment the sequence
        finishes (EOS or budget recycles the slot mid-list); returns
        how many tokens were recorded."""
        seq = self.slots[slot]
        n = 0
        for t in tokens:
            if self.slots[slot] is not seq:
                break
            self.record_token(slot, t, eos_id)
            n += 1
        return n

    # ---------------- failure / drain surface ----------------

    def fail_request(self, req: Request, status: str) -> None:
        """Terminate a request that is NOT in the scheduler (e.g. a
        pending arrival shed at drain start) with ``status``."""
        self._terminal(req, status)

    def fail_live(self, slot: int, status: str) -> None:
        """Terminate ONE live sequence with ``status``: free its blocks,
        recycle the slot — the other in-flight streams keep serving."""
        seq = self.slots[slot]
        self.allocator.release(seq.block_ids)
        self._release_partial(seq)
        seq.block_ids = []
        self.slots[slot] = None
        self._terminal(seq.request, status)

    def expire_deadlines(self, now: float) -> List[int]:
        """Fail every waiting or live request whose deadline has passed
        (``deadline_exceeded``); expired work must stop occupying slots
        and blocks that feasible requests could use.  Returns the
        expired request ids."""
        expired = []
        survivors = deque()
        for req in self.waiting:
            if req.deadline is not None and now >= req.deadline:
                self._terminal(req, "deadline_exceeded")
                expired.append(req.id)
            else:
                survivors.append(req)
        self.waiting = survivors
        for i, seq in enumerate(self.slots):
            if seq is not None and seq.request.deadline is not None \
                    and now >= seq.request.deadline:
                expired.append(seq.request.id)
                self.fail_live(i, "deadline_exceeded")
        return expired

    def shed_waiting(self, status: str = "shed") -> int:
        """Drop the whole waiting queue — drain-start load shedding:
        admission has stopped, and queued work is not in flight."""
        n = len(self.waiting)
        while self.waiting:
            self._terminal(self.waiting.popleft(), status)
        return n

    def abort_live(self, status: str) -> int:
        """Terminate every live sequence AND any residual waiting work
        (eviction victims requeued mid-drain) with ``status`` — the
        drain budget's hard edge."""
        n = self.shed_waiting(status)
        for i, seq in enumerate(self.slots):
            if seq is not None:
                self.fail_live(i, status)
                n += 1
        return n

    def all_done(self) -> bool:
        return not self.waiting and all(s is None for s in self.slots)

    def check_quiescent(self) -> None:
        """Pool-leak invariant at the end of a run: every terminal
        request released its blocks, the free list + refcount map
        partition the pool, and the only references left standing are
        the prefix trie's own (one per cached node)."""
        self.allocator.check()
        held = self.prefix_cache.num_blocks \
            if self.prefix_cache is not None else 0
        assert self.allocator.num_used == held, (
            f"pool leak: {self.allocator.num_used} blocks referenced at "
            f"quiescence, prefix trie accounts for {held}")
        if self.prefix_cache is not None:
            self.prefix_cache.check()
