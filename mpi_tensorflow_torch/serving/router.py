"""Data-parallel replica serving: a fault-tolerant router over N engines.

Counterpart of ``mpi_tensorflow_tpu/serving/router.py``, ported whole
but for ``compile_counts`` (eager PyTorch compiles nothing).  The engine
scales up with ``tp`` (``serving/tp``); this layer scales out: ``N``
whole engine replicas, each with its own pool, scheduler, prefix trie,
drafter and ``ReplayJournal``, behind one router that owns placement,
health and failover.

Placement, in order:

1. **Session affinity**: a request carrying ``Request.session`` sticks
   to the replica that served the session before.  The sticky map is
   LRU-bounded (``max_sticky``; sessions with live requests are never
   evicted), and a session whose replica is ejected re-homes.
2. **Health gate**: only replicas the circuit breaker calls routable
   (``healthy`` or ``probing``) take work.
3. **Prefix hint** (``prefix_route="on"``): a map from leading
   full-block token keys to the replica whose trie cached them (fed by
   ``PrefixCache.root_hook``); a sessionless request whose first block
   is cached somewhere goes there when its load is within one waiting
   request of the least-loaded replica's.  Placement only.
4. **Least load**: waiting-queue depth, then live-slot fraction, pool
   occupancy and shed rate.

Each replica runs the engine's own per-iteration body
(``serving/iteration.EngineLoop``).  When a tick raises (a device error
or a ``FaultPlan`` fault) the router classifies it with
``train/elastic.is_transient`` and migrates the replica's live and
queued requests, each journal-live one re-rooted at ``prompt +
delivered`` (``recovery.replay_one``) and replayed token-identically
on a survivor.  A transient fault ejects the replica for a capped
exponential backoff (``ServeConfig.failover_backoff_ms``, doubled a
fault, capped at 64x), after which it is rebuilt (``make_engine``, else
``engine.reset()``) and probed: readmitted after ``probe_ticks`` clean
iterations.  A permanent fault (a sticky CUDA fault, an out-of-memory
error, a deterministic bug) leaves it ``dead``; a fleet with every
replica dead re-raises the last error.  A stop request drains the whole
fleet: every request still ends with exactly one terminal status.

On the card the replicas share one device and its caching allocator,
and each replica owns a ``torch.cuda.Stream`` (``engine.use_stream``):
its steps run on it, so its token fetch waits for its own work only.
``run(parallel=True)`` steps each replica from a thread of its own;
``parallel=False`` interleaves them round-robin on the calling thread
(deterministic, for tests).  ``default_parallelism`` keeps the
reference's rule (threads when more than one core is usable); eager
PyTorch holds the GIL through each of a dispatch's launches, so the
threads may lose to the round-robin here.  Failover, probing and drain
are decisions of the main thread in both modes.

Under tensor parallelism (``serving/tp``) every rank runs the router
over its shards of the N replicas in lock step: sequentially, each
pass on rank 0's clock and stop flag (one ``tp.agree`` a pass), so a
replica is placed on, ejected, probed and failed over alike on every
rank and each rank's collectives meet their peers'.
"""


from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from collections import Counter, OrderedDict, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from mpi_tensorflow_torch.serving import recovery as rec_lib
from mpi_tensorflow_torch.serving import scheduler as sched_lib
from mpi_tensorflow_torch.serving import tp as tp_lib
from mpi_tensorflow_torch.serving import tracing
from mpi_tensorflow_torch.serving.iteration import DrainTracker, EngineLoop
from mpi_tensorflow_torch.train import elastic

#: replica circuit-breaker states
HEALTHY, EJECTED, PROBING, DEAD = "healthy", "ejected", "probing", "dead"


def default_parallelism() -> bool:
    """Whether threaded replica stepping can actually win on this host:
    only with >1 usable core.  On a single core the GIL's switch
    interval turns the thread ping-pong into pure overhead, while
    sequential round-robin matches a single engine minus dispatch
    overhead (the reference's rule, kept)."""
    try:
        return len(os.sched_getaffinity(0)) > 1
    except AttributeError:            # platforms without affinity API
        return (os.cpu_count() or 1) > 1


def _own_stream(engine) -> None:
    """Give a replica on the card a CUDA stream of its own."""
    if engine.device.type == "cuda" and engine.stream is None:
        engine.use_stream(torch.cuda.Stream(engine.device))


@dataclasses.dataclass
class ReplicaFault:
    """One scheduled injected fault: kill replica ``replica`` when its
    tick counter reaches ``at_step`` (1-based; deterministic under
    ``parallel=False``).  ``kind`` picks the classification the injected
    error carries — ``transient`` raises with an UNAVAILABLE status code
    (eject + backoff + probe), ``permanent`` with FAILED_PRECONDITION
    (dead forever) — so the fault flows through exactly the status-code-
    first ``elastic.is_transient`` path a real device error would."""
    replica: int
    at_step: int
    kind: str = "transient"

    def __post_init__(self):
        if self.kind not in ("transient", "permanent"):
            raise ValueError(f"fault kind must be transient|permanent, "
                             f"got {self.kind!r}")
        if self.at_step < 1 or self.replica < 0:
            raise ValueError(f"bad fault plan entry: {self}")


class FaultPlan:
    """The replica fault-injection seam: a list of ``ReplicaFault``
    entries checked at the TOP of every replica tick (before the inbox
    snapshot, so queued handoffs are never half-consumed).  Each entry
    fires at most once; ``fired`` records what actually went off."""

    def __init__(self, faults: List[ReplicaFault]):
        self.faults = list(faults)
        self.fired: List[ReplicaFault] = []

    def check(self, replica: int, step: int) -> None:
        for f in list(self.faults):
            if f.replica == replica and step >= f.at_step:
                self.faults.remove(f)
                self.fired.append(f)
                code = ("UNAVAILABLE" if f.kind == "transient"
                        else "FAILED_PRECONDITION")
                raise RuntimeError(
                    f"{code}: injected replica fault (FaultPlan: "
                    f"replica {replica} at tick {step}, {f.kind})")


@dataclasses.dataclass
class ReplicaHealth:
    """Circuit-breaker state of one replica."""
    state: str = HEALTHY
    faults: int = 0               # consecutive transient faults (reset
                                  # when a probe readmits the replica)
    backoff_s: float = 0.0        # current probe backoff
    retry_at: float = 0.0         # run-clock stamp when a probe may run
    probe_ticks: int = 0          # clean ticks since the probe started


class ReplicaRouter:
    """Route requests across engine replicas; survive replica failure.

    ``engines``: fully constructed ``PagedDecodeEngine`` replicas (they
    may share one model; each owns its pools, and on the card its own
    CUDA stream, given here).  ``make_engine``: optional zero-arg
    factory used to rebuild an ejected replica at probe time; without it
    the probe calls ``engine.reset()`` (fresh host and pool state).
    ``probe_ticks``: clean iterations a probing replica must complete
    before readmission.  ``max_sticky``: LRU bound on the session
    affinity map (entries for sessions with live requests are never
    evicted).  ``reset()`` resets every replica AND the health/affinity
    state — a fresh fleet for a fresh trace replay.
    """

    # lock discipline: every access to _sticky, _session_live,
    # _outstanding, fleet_counters, _drain_counts and _prefix_owner
    # from a running fleet sits inside `with self._lock`

    def __init__(self, engines: List, *, make_engine=None,
                 probe_ticks: int = 4, max_sticky: int = 1024,
                 prefix_route: Optional[bool] = None):
        if not engines:
            raise ValueError("ReplicaRouter needs >= 1 engine replica")
        if probe_ticks < 1 or max_sticky < 1:
            raise ValueError(f"bad router policy: probe_ticks "
                             f"{probe_ticks} (>= 1), max_sticky "
                             f"{max_sticky} (>= 1)")
        self.engines = list(engines)
        self.make_engine = make_engine
        self.probe_ticks = probe_ticks
        self.max_sticky = max_sticky
        # prefix-aware placement (prefix v2): None resolves through the
        # fleet's ServeConfig (--serve-prefix-route) — the explicit
        # boolean exists for bench's hint-on-vs-off A/B over one fleet
        self._prefix_route = (engines[0].serve.prefix_route == "on"
                              if prefix_route is None
                              else bool(prefix_route))
        base = engines[0].serve.failover_backoff_ms / 1e3
        self.backoff_base_s = base
        self.backoff_cap_s = base * 64
        self._lock = threading.Lock()
        self._running = False
        for eng in self.engines:
            _own_stream(eng)
        self._cold_state()

    def _cold_state(self) -> None:
        """Fresh fleet state (construction + ``reset``)."""
        n = len(self.engines)
        self._sticky: OrderedDict = OrderedDict()   # session -> replica
        self._session_live: Counter = Counter()     # session -> live reqs
        self.placements: Dict[int, int] = {}        # request id -> replica
        self._routed = [0] * n
        self.health = [ReplicaHealth() for _ in range(n)]
        self.fleet_counters: Counter = Counter()
        self._prefix_owner: Dict = {}   # leading block key -> replica
        self._last_error: Optional[BaseException] = None

    def reset(self) -> None:
        for eng in self.engines:
            eng.reset()
        self._cold_state()

    # ---------------- placement ----------------

    def routable(self) -> List[int]:
        """Replica indices the health gate admits traffic to."""
        return [i for i, h in enumerate(self.health)
                if h.state in (HEALTHY, PROBING)]

    def load_score(self, i: int, inbox_depth: int = 0) -> float:
        """One replica's load, from its scheduler's own signals.  Queue
        depth dominates (integer weight per waiting request); live-slot
        fraction, pool occupancy, and shed rate are sub-1 tie-breakers
        that push new work away from saturated or shedding replicas."""
        eng = self.engines[i]
        sched = eng.sched
        waiting = len(sched.waiting) + inbox_depth
        live = sum(1 for s in sched.slots if s is not None)
        occ = eng.allocator.num_used / max(1, eng.serve.num_blocks - 1)
        shed_rate = sched.counters.get("shed", 0) / max(1, self._routed[i])
        return (waiting
                + live / max(1, eng.serve.max_slots) * 0.5
                + occ * 0.3
                + shed_rate * 0.2)

    def route(self, req: sched_lib.Request,
              inbox_depths: Optional[List[int]] = None) -> Optional[int]:
        """Pick the replica for ``req``: sticky session first (health-
        gated — an ejected home re-homes the session), else least-loaded
        among routable replicas (ties break to the lowest index, so an
        idle fleet fills deterministically).  None = nothing routable
        right now (every replica ejected/dead; the caller holds the
        request until a probe readmits one)."""
        ok = self.routable()
        if not ok:
            return None
        key = req.session
        i = None
        if key is not None:
            # read + health-check + LRU-touch under ONE lock hold: the
            # worker-side terminal hook trims this map concurrently, so
            # a get outside the lock could name a key the trim evicts
            # before the touch
            with self._lock:
                i = self._sticky.get(key)
                if i is not None and self.health[i].state \
                        not in (HEALTHY, PROBING):
                    # stale affinity to an ejected/dead replica (it
                    # re-armed after the failover sweep): re-home now
                    self._sticky.pop(key, None)
                    self.fleet_counters["sticky_rehomed"] += 1
                    i = None
                elif i is not None:
                    self._sticky.move_to_end(key)   # LRU touch
        if i is None and self._prefix_route:
            # prefix-aware hint (prefix v2): if some replica's trie
            # caches this prompt's LEADING full block, send the request
            # there — its expected cached prefix (and everything the
            # radix walk finds below that block) beats a cold replica's
            # full prefill.  Load-bounded: the owner must score within
            # ONE waiting request of the least-loaded routable replica,
            # so the hint can shape placement but never pile work onto
            # a saturated replica; and it is health-gated by the same
            # ``ok`` set as every other placement.  Tokens never change
            # — a mis-hint only costs a cache miss.
            bs = self.engines[0].serve.block_size
            if len(req.prompt) >= bs:
                with self._lock:
                    owner = self._prefix_owner.get(tuple(req.prompt[:bs]))
                if owner is not None and owner in ok:
                    depths = inbox_depths or [0] * len(self.engines)
                    best = min(self.load_score(j, depths[j]) for j in ok)
                    if self.load_score(owner, depths[owner]) <= best + 1.0:
                        i = owner
                        with self._lock:
                            self.fleet_counters["router_prefix_hits"] += 1
                            if key is not None:
                                # hint placements seed affinity too:
                                # the session's later turns should find
                                # the prefix where this one put it
                                self._sticky[key] = i
                                self._sticky.move_to_end(key)
        if i is None:
            depths = inbox_depths or [0] * len(self.engines)
            i = min(ok, key=lambda j: (self.load_score(j, depths[j]), j))
            if key is not None:
                with self._lock:
                    self._sticky[key] = i
                    self._sticky.move_to_end(key)
        with self._lock:
            if key is not None and req.id not in self.placements:
                # first placement of this request pins its session live
                # (a MIGRATED request re-routes without re-pinning — its
                # one terminal notification un-pins exactly once)
                self._session_live[key] += 1
        self._routed[i] += 1
        self.placements[req.id] = i
        return i

    # ---------------- terminal / sticky bookkeeping ----------------

    def _note_prefix(self, i: int, key, present: bool) -> None:
        """Per-replica trie digest sink (``PrefixCache.root_hook``): a
        leading full-block token key entered (``present``) or left
        replica ``i``'s trie.  Last inserter wins on collision — a key
        cached on two replicas routes to the most recent one, which is
        also the most recently used (warmest) copy.  Runs on the
        replica's own worker thread, hence the lock."""
        with self._lock:
            if present:
                self._prefix_owner[key] = i
            elif self._prefix_owner.get(key) == i:
                # only the recorded owner's eviction clears the entry:
                # another replica's eviction must not erase a mapping
                # that still names a live copy elsewhere
                del self._prefix_owner[key]

    def _notify_terminal(self, i: int, req, status: str) -> None:
        """Chained behind each adopted engine's own terminal hook: one
        call per request fleet-wide (terminals fire exactly once)."""
        if not self._running:
            return
        with self._lock:
            self._outstanding.discard(req.id)
            if self._drain.draining:
                self._drain_counts[status] += 1
            s = req.session
            if s is not None and s in self._session_live:
                self._session_live[s] -= 1
                if self._session_live[s] <= 0:
                    del self._session_live[s]
            self._trim_sticky_locked()

    def _trim_sticky_locked(self) -> None:
        """Bound the affinity map: evict LRU sessions with no live
        requests once past ``max_sticky`` — terminal requests must not
        pin map entries forever (the map is a locality hint; an evicted
        session simply re-places by load on its next request)."""
        if len(self._sticky) <= self.max_sticky:
            return
        for k in list(self._sticky):
            if len(self._sticky) <= self.max_sticky:
                break
            if k not in self._session_live:
                del self._sticky[k]
                self.fleet_counters["sticky_evicted"] += 1

    def stats(self) -> dict:
        """Router health/affinity accounting (the fleet_faults block
        plus the sticky-map hygiene counters), plus a per-replica prefix
        trie snapshot — the fleet-level view of where cached prefixes
        live and how hard each trie is working."""
        from mpi_tensorflow_torch.utils.metrics_writer import \
            fleet_faults_block

        # trie/scheduler reads are worker-owned state: best-effort
        # snapshots (int reads are atomic under the GIL; same contract
        # as _observe_fleet), taken OUTSIDE the router lock
        tries = []
        for i, eng in enumerate(self.engines):
            pc = eng.prefix_cache
            row = {"replica": i, "enabled": pc is not None}
            if pc is not None:
                row.update(pc.stats())       # blocks/inserted/evicted
                row["hit_tokens"] = int(
                    eng.sched.counters.get("prefix_hit_tokens", 0))
                row["gen_inserted_blocks"] = int(
                    eng.sched.counters.get("prefix_gen_inserted_blocks",
                                           0))
                row["occupancy"] = round(
                    pc.num_blocks / max(1, eng.serve.num_blocks - 1), 4)
            tries.append(row)
        # one lock hold for the whole snapshot: stats() is callable
        # mid-run, and an unlocked read races the workers' updates
        with self._lock:
            return {
                "sticky_sessions": len(self._sticky),
                "sticky_live_sessions": len(self._session_live),
                "sticky_capacity": self.max_sticky,
                "sticky_rehomed":
                    int(self.fleet_counters["sticky_rehomed"]),
                "sticky_evicted":
                    int(self.fleet_counters["sticky_evicted"]),
                "prefix_route": self._prefix_route,
                "prefix_owner_keys": len(self._prefix_owner),
                "router_prefix_hits":
                    int(self.fleet_counters["router_prefix_hits"]),
                "replica_tries": tries,
                "health": [dataclasses.asdict(h) for h in self.health],
                "fleet_faults": fleet_faults_block(self.fleet_counters),
            }

    # ---------------- replica binding / failover ----------------

    def _bind(self, i: int, engine) -> None:
        """Adopt ``engine`` as replica ``i``: fresh iteration loop bound
        to the replica's journal, terminal hook chained to the router's
        bookkeeping (the engine's own hook — drafter release + journal
        record_end — still runs first, preserving tok-then-end order)."""
        self.engines[i] = engine

        def hook(req, status, _i=i, _fn=engine._on_terminal):
            _fn(req, status)
            self._notify_terminal(_i, req, status)

        engine.sched.on_terminal = hook
        if self._prefix_route and engine.prefix_cache is not None:
            # feed the router's owner map from this replica's trie
            # digest; installed here (not __init__) because reset() and
            # probe rebuilds create FRESH PrefixCache objects, and every
            # incarnation reaches traffic through _bind
            engine.prefix_cache.root_hook = (
                lambda key, present, _i=i:
                self._note_prefix(_i, key, present))
        self._loops[i] = EngineLoop(engine, self._journals[i])

    def _failover(self, i: int, exc: BaseException, now: float) -> None:
        """Replica ``i`` failed: archive its accounting, eject it
        (backoff or dead), re-home its sticky sessions, and migrate its
        live + queued requests to the router's pending list — each
        journal-live entry re-rooted at ``prompt + delivered`` so a
        surviving replica replays it token-identically through chunked
        prefill."""
        self._last_error = exc
        transient = elastic.is_transient(exc)
        h = self.health[i]
        eng = self.engines[i]
        if tp_lib.world()[0] == 0:
            print(f"[serving-router] replica {i} "
                  f"{'transient' if transient else 'PERMANENT'} fault "
                  f"({exc!r}); migrating its work", file=sys.stderr)
        # archive the dead incarnation's accounting: latency samples of
        # already-delivered tokens stay valid (the client keeps that
        # prefix — replay regenerates only what follows), and its fault
        # counters must survive the rebuild
        loop = self._loops[i]
        if loop is not None:
            self._lat_archive[i].extend(loop.latencies())
            # finish stamps of the dead incarnation: completions it
            # recorded stay valid; a migrated request's newer stamp on
            # a survivor wins at aggregation (max merge)
            for rid, t in loop.last_emit.items():
                self._finish_archive[rid] = max(
                    self._finish_archive.get(rid, t), t)
            # first-token stamps: the client already HOLDS the donor's
            # delivered prefix (replay only regenerates what follows),
            # so a request's TTFT is its EARLIEST incarnation's first
            # emit (min merge — the mirror of the finish stamps' max)
            for rid, t in loop.first_emit.items():
                self._first_archive[rid] = min(
                    self._first_archive.get(rid, t), t)
            self._tokens_archive[i] += loop.tokens
            self._peak_queue[i] = max(self._peak_queue[i],
                                      loop.peak_queue)
            self._counter_snap[i].update(eng.sched.counters)
            self._evict_snap[i] += eng.sched.evictions
            if loop.tracer is not None:
                # harvest the dead incarnation's trace: open spans are
                # closed at the failure instant and stamped "migrated",
                # so the victim's queue/prefill/decode time ACCUMULATES
                # into the fleet merge instead of resetting when the
                # replay re-roots it (replay_one resets arrival).
                # Main-router-thread state, same ownership as
                # _lat_archive — no lock needed.
                self._trace_archive[i].append(
                    loop.tracer.harvest(now, reason="migrated"))
        self._loops[i] = None
        with self._lock:
            self.fleet_counters["failovers"] += 1
            self.fleet_counters["ejections"] += 1
            stale = [k for k, v in self._sticky.items() if v == i]
            for k in stale:
                del self._sticky[k]
            self.fleet_counters["sticky_rehomed"] += len(stale)
            # prefix hints to the dead incarnation are stale too: its
            # pools are gone, so routing toward it buys nothing (the
            # hint path also health-gates, but the map should not pin
            # memory for a replica that may never return)
            for k in [k for k, v in self._prefix_owner.items() if v == i]:
                del self._prefix_owner[k]
        if transient:
            h.faults += 1
            h.backoff_s = min(self.backoff_cap_s,
                              self.backoff_base_s * 2 ** (h.faults - 1))
            h.retry_at = now + h.backoff_s
            h.state = EJECTED
        else:
            h.state = DEAD
        # migration set: requests handed over but not yet submitted
        # (inbox) ride as-is; journal-live requests re-root at
        # prompt + delivered.  Both re-enter the router's pending list
        # due immediately and re-route on the next loop pass.
        with self._inbox_locks[i]:
            moved = list(self._inboxes[i])
            self._inboxes[i].clear()
        journal = self._journals[i]
        eos = eng.serve.eos_id
        with self._lock:
            live = [rid for rid, ent in journal.entries.items()
                    if ent.status is None and rid in self._outstanding]
        replay_tokens = 0
        for rid in sorted(live):
            req = self._requests_by_id.get(rid)
            if req is None:
                continue
            rep, done = rec_lib.replay_one(journal.entries[rid], req,
                                           eos, arrival=now)
            if rep is None:
                # died between the final token and its end record: the
                # entry is complete — terminate it in place (it stays
                # in the journal as the request's output stream)
                journal.record_end(req, "ok")
                self._notify_terminal(i, req, "ok")
                continue
            # the donor's in-memory live entry is now STALE — the
            # request's authoritative stream continues wherever the
            # replay lands.  Drop it, or a readmitted donor faulting a
            # SECOND time would re-migrate a request still live on a
            # survivor (duplicate serving; worse, the duplicate's
            # record_submit would overwrite the live entry and void its
            # tokens).  In-memory only: the on-disk record stays, and a
            # full-process crash reload resolves it through the merge
            # (terminal status wins, else longest delivered).
            journal.entries.pop(rid, None)
            self._pre[rid] = done
            replay_tokens += len(rep.prompt)
            moved.append(rep)
        # surviving workers bump fleet_counters under the lock; the
        # failover path must too or the += read-modify-write races them
        with self._lock:
            self.fleet_counters["replay_tokens"] += replay_tokens
            self.fleet_counters["migrated_requests"] += len(moved)
        if moved:
            self._pending = sorted(self._pending + moved,
                                   key=lambda r: r.arrival)

    def _maybe_probe(self, now: float) -> List[int]:
        """Rebuild ejected replicas whose backoff has elapsed and mark
        them PROBING (they take traffic again; ``probe_ticks`` clean
        iterations readmit them).  Returns the replica indices revived
        this call — the parallel loop starts a fresh worker for each."""
        revived = []
        for i, h in enumerate(self.health):
            if h.state != EJECTED or now < h.retry_at:
                continue
            if self.make_engine is not None:
                eng = self.make_engine()
                _own_stream(eng)
            else:
                eng = self.engines[i]
                eng.reset()     # fresh pools and scheduler
            self._bind(i, eng)
            h.state = PROBING
            h.probe_ticks = 0
            revived.append(i)
        return revived

    # ---------------- the per-replica tick ----------------

    def _tick(self, i: int, time_fn, t0: float,
              now: Optional[float] = None) -> bool:
        """One iteration for replica ``i`` — the SHARED engine body
        (serving/iteration.EngineLoop) plus the router's handoff/drain/
        probe edges.  Returns whether any work moved.  Only replica
        ``i``'s thread (or the sequential caller) runs this —
        scheduler/pool state stays single-owner.  ``now`` (the pass's
        agreed clock under tensor parallelism) replaces the tick's own
        clock reading for its admission and deadline decisions."""
        self._ticks[i] += 1
        if self._fault_plan is not None:
            # the injection seam fires BEFORE the inbox snapshot so a
            # handoff is never half-consumed by a dying replica
            self._fault_plan.check(i, self._ticks[i])
        eng = self.engines[i]
        loop = self._loops[i]
        with self._inbox_locks[i]:
            todo = list(self._inboxes[i])
            self._inboxes[i].clear()
        draining = self._drain.draining
        if draining and not self._drain_shed_done[i]:
            # fleet drain: this replica sheds its waiting queue once;
            # in-flight sequences keep running inside the budget
            self._drain_shed_done[i] = True
            eng.sched.shed_waiting()
        if self._abort_req[i] and not self._abort_done[i]:
            # the drain budget's hard edge
            self._abort_done[i] = True
            eng.sched.abort_live("drained")
        if now is None:
            now = time_fn() - t0
        for req in todo:
            if draining:
                eng.sched.fail_request(req, "shed")
                continue
            # a migrated/replayed request re-admits AT THE FRONT (it
            # already waited its turn once) with its delivered prefix
            # staged into this replica's journal
            loop.submit(req, pre=self._pre.pop(req.id, None),
                        front=req.replayed)
        emitted = loop.iterate(now, time_fn, t0)
        h = self.health[i]
        if h.state == PROBING:
            h.probe_ticks += 1
            if h.probe_ticks >= self.probe_ticks:
                # readmitted: the fault streak is broken, so the
                # "consecutive faults" backoff restarts at base — an
                # isolated fault hours later must not pay an escalated
                # penalty (flapping replicas re-escalate fast anyway:
                # a fault during PROBING never reaches this reset)
                h.state = HEALTHY
                h.faults = 0
                h.backoff_s = 0.0
                with self._lock:
                    self.fleet_counters["readmissions"] += 1
        return bool(todo) or bool(emitted) or eng._progressed

    # ---------------- the serve loop ----------------

    def run(self, requests: List[sched_lib.Request],
            time_fn=time.perf_counter, *,
            parallel: Optional[bool] = None, guard=None,
            journals: Optional[List] = None,
            replay_pre: Optional[Dict[int, List[int]]] = None,
            fault_plan: Optional[FaultPlan] = None,
            advisor=None) -> dict:
        """Serve ``requests`` (replayed against their ``arrival``
        stamps) across the replicas to completion, failing over replica
        faults.  Latency semantics match ``engine.run`` (the SHARED
        iteration body guarantees it); the result adds per-replica
        metrics, the fleet drain outcome, and the ``fleet_faults``
        block.

        ``parallel``: None (default) auto-selects — threads when the
        host has >1 usable core (``default_parallelism``), sequential
        round-robin otherwise; True/False force a mode.  ``guard``
        wires SIGTERM to a fleet-wide graceful drain.  ``journals``:
        one ``ReplayJournal`` per replica (pre-loaded journals resume a
        crashed fleet — pair with ``recovery.fleet_replay_requests``
        and pass its ``pre`` map as ``replay_pre``); None = fresh
        memory-only journals, which is what arms in-process failover.
        ``fault_plan`` injects deterministic replica faults (tests/
        bench).  ``advisor`` (serving/autoscale.ScaleAdvisor) observes
        the FLEET-level load signals — router queue + summed replica
        queues, mean pool occupancy, fleet shed rate — once per router
        loop pass; its advisory decision log rides the result as the
        ``autoscale`` block.  Tensor-parallel replicas run in lock step
        (module note): sequentially, whatever ``parallel`` says."""
        lockstep = tp_lib.collective(self.engines[0].serve.tp)
        if lockstep:
            parallel = False
        elif parallel is None:
            parallel = default_parallelism()
        n = len(self.engines)
        if journals is not None and len(journals) != n:
            raise ValueError(f"need one journal per replica: got "
                             f"{len(journals)} for {n} replicas")
        self._journals = (list(journals) if journals is not None
                          else [rec_lib.ReplayJournal()
                                for _ in range(n)])
        self._fault_plan = fault_plan
        self._pre = dict(replay_pre or {})
        self._requests_by_id = {r.id: r for r in requests}
        self._outstanding = set(self._requests_by_id)
        self._pending = sorted(requests, key=lambda r: r.arrival)
        self._inboxes = [deque() for _ in range(n)]
        self._inbox_locks = [threading.Lock() for _ in range(n)]
        self._ticks = [0] * n
        self._loops: List[Optional[EngineLoop]] = [None] * n
        self._lat_archive: List[List[float]] = [[] for _ in range(n)]
        self._finish_archive: Dict[int, float] = {}
        self._first_archive: Dict[int, float] = {}
        self._advisor = advisor
        self._tokens_archive = [0] * n
        self._peak_queue = [0] * n
        self._counter_snap = [Counter() for _ in range(n)]
        self._evict_snap = [0] * n
        # trace harvests of dead incarnations, per replica slot — the
        # _lat_archive idiom: written only by the main router thread at
        # failover, merged with live loops' harvests at aggregation
        # (NOT under _lock; span state never crosses threads)
        self._trace_archive: List[List[dict]] = [[] for _ in range(n)]
        self._drain = DrainTracker(self.engines[0].serve.drain_ms)
        self._drain_counts: Counter = Counter()
        self._drain_shed_done = [False] * n
        self._abort_req = [False] * n
        self._abort_done = [False] * n
        for i, h in enumerate(self.health):
            if h.state == EJECTED:
                # stamps from a previous run's clock are stale; re-arm
                # the backoff from this run's zero
                h.retry_at = h.backoff_s
            if h.state in (HEALTHY, PROBING):
                self._bind(i, self.engines[i])
        self._running = True
        t0 = time_fn()
        try:
            if parallel:
                self._run_parallel(time_fn, t0, guard)
            else:
                self._run_sequential(time_fn, t0, guard, lockstep)
            elapsed = time_fn() - t0
            return self._aggregate(parallel, elapsed)
        finally:
            self._running = False
            for i, eng in enumerate(self.engines):
                if self._loops[i] is not None:
                    # un-chain the router hook: a later engine.run on
                    # this engine must not touch dead run state
                    eng.sched.on_terminal = eng._on_terminal

    def _route_due(self, now: float, all_due: bool = False) -> None:
        while self._pending and (all_due
                                 or self._pending[0].arrival <= now):
            depths = [len(b) for b in self._inboxes]
            i = self.route(self._pending[0], depths)
            if i is None:
                return              # nothing routable; hold the queue
            req = self._pending.pop(0)
            with self._inbox_locks[i]:
                self._inboxes[i].append(req)

    def _drain_edges(self, now: float, stop: bool) -> None:
        """Fleet drain state machine, run from the main loop: SIGTERM
        stops admission and pushes everything queued at the router to
        the replicas (whose draining ticks shed it — one terminal per
        request through the normal scheduler/journal path); the budget's
        hard edge arms per-replica abort."""
        if stop and not self._drain.draining:
            self._drain.start(now)
            self._route_due(now, all_due=True)
            for req in self._pending:   # nothing routable: shed direct
                self._terminal_direct(req, "shed")
            self._pending = []
        if self._drain.expired(now) and not all(self._abort_req):
            self._abort_req = [True] * len(self.engines)
            for req in self._pending:
                self._terminal_direct(req, "shed")
            self._pending = []

    def _terminal_direct(self, req, status: str) -> None:
        """Terminal for a request no routable replica can shed (every
        replica ejected/dead at drain time): record straight into
        journal 0 so the fleet status/outstanding accounting stays
        exact."""
        self._journals[0].record_end(req, status)
        self._notify_terminal(0, req, status)

    def _fleet_dead(self) -> bool:
        """True when no replica can ever serve again (all DEAD)."""
        return all(h.state == DEAD for h in self.health)

    def _observe_fleet(self, now: float) -> None:
        """Feed the ScaleAdvisor one fleet-level observation: router
        backlog plus summed replica queues, mean occupancy/live fraction
        over live replicas, fleet shed rate.  Reads of worker-owned
        scheduler state are best-effort snapshots (len() on a deque/list
        is atomic under the GIL); advice tolerates a stale tick."""
        if self._advisor is None:
            return
        qd = len(self._pending) + sum(len(b) for b in self._inboxes)
        occ, lf, live = 0.0, 0.0, 0
        shed = 0
        backlog = 0.0
        for i, eng in enumerate(self.engines):
            shed += int(eng.sched.counters.get("shed", 0))
            if self._loops[i] is None:
                continue
            live += 1
            qd += len(eng.sched.waiting)
            occ += eng.allocator.num_used / max(1, eng.serve.num_blocks - 1)
            lf += len(eng.sched.live_slots()) / eng.serve.max_slots
            # admitted-but-unprefilled work, summed fleet-wide in
            # prefill-chunk units (the same signal engine.load_signals
            # feeds a single-engine advisor)
            backlog += (eng.sched.prefill_backlog_tokens
                        / max(1, eng.serve.prefill_chunk))
        routed = sum(self._routed)
        self._advisor.observe(
            now,
            queue_depth=qd,
            occupancy=occ / live if live else 0.0,
            live_fraction=lf / live if live else 0.0,
            shed_rate=shed / max(1, routed),
            prefill_backlog=backlog)

    def _run_sequential(self, time_fn, t0, guard,
                        lockstep: bool = False) -> None:
        """The round-robin loop.  ``lockstep`` (tensor-parallel
        replicas): the pass's clock reading and stop flag are rank 0's,
        and every decision of the pass reads them."""
        while True:
            now = time_fn() - t0
            stop = guard is not None and guard.should_stop
            if lockstep:
                now, stop = tp_lib.agree(now, stop)
            self._drain_edges(now, stop)
            self._maybe_probe(now)
            self._route_due(now)
            self._observe_fleet(now)
            progressed = False
            for i in list(self.routable()):
                try:
                    progressed = self._tick(
                        i, time_fn, t0,
                        now if lockstep else None) or progressed
                except Exception as e:  # noqa: BLE001 — classified in
                    self._failover(     # _failover
                        i, e, now if lockstep else time_fn() - t0)
                    progressed = True
            with self._lock:
                done = not self._outstanding
            if done:
                return
            if not self.routable():
                if self._fleet_dead():
                    raise self._last_error
                progressed = False      # every replica in backoff: wait
            if not progressed:
                delay = 1e-3
                if self._pending and self.routable():
                    # clamp to the next arrival ONLY while someone can
                    # take it — with the whole fleet in backoff an
                    # overdue arrival would clamp the delay to zero and
                    # busy-spin the core for the entire backoff window
                    delay = min(delay, max(
                        0.0,
                        self._pending[0].arrival - (time_fn() - t0)))
                if delay > 0:
                    time.sleep(delay)

    def _run_parallel(self, time_fn, t0, guard) -> None:
        stop = threading.Event()
        failures: List[tuple] = []
        threads: Dict[int, threading.Thread] = {}

        def worker(i: int) -> None:
            try:
                while True:
                    progressed = self._tick(i, time_fn, t0)
                    if not progressed:
                        if stop.is_set():
                            with self._inbox_locks[i]:
                                empty = not self._inboxes[i]
                            if empty and self.engines[i].sched.all_done():
                                return
                        time.sleep(1e-3)
            except BaseException as e:   # noqa: BLE001 — handed to the
                with self._lock:         # router loop for failover
                    failures.append((i, e))

        def start(i: int) -> None:
            t = threading.Thread(target=worker, args=(i,),
                                 name=f"serve-replica-{i}", daemon=True)
            threads[i] = t
            t.start()

        for i in self.routable():
            start(i)
        try:
            while True:
                now = time_fn() - t0
                with self._lock:
                    fails, failures[:] = list(failures), []
                for i, e in fails:
                    t = threads.pop(i, None)
                    if t is not None:
                        t.join()        # the worker exits on fault
                    self._failover(i, e, time_fn() - t0)
                self._drain_edges(now, guard is not None
                                  and guard.should_stop)
                for i in self._maybe_probe(now):
                    start(i)
                self._route_due(now)
                self._observe_fleet(now)
                with self._lock:
                    done = not self._outstanding
                if done:
                    return
                if not self.routable() and self._fleet_dead():
                    raise self._last_error
                time.sleep(1e-3)
        finally:
            stop.set()
            for t in threads.values():
                t.join()

    # ---------------- aggregation ----------------

    def _aggregate(self, parallel: bool, elapsed: float) -> dict:
        from mpi_tensorflow_torch.utils.metrics_writer import (
            faults_block, fleet_faults_block, prefix_block)

        totals: Counter = Counter()
        per_replica = []
        flat: List[float] = []
        for i, eng in enumerate(self.engines):
            live = self._loops[i] is not None
            cnts = Counter(self._counter_snap[i])
            tokens_i = self._tokens_archive[i]
            lats = list(self._lat_archive[i])
            evictions = self._evict_snap[i]
            peak_q = self._peak_queue[i]
            if live:
                # fleet-wide pool-leak invariant: every surviving
                # replica must be quiescent, failover or not (the
                # engine-level check, asserted per replica)
                eng.sched.check_quiescent()
                if eng.drafter is not None:
                    eng.drafter.check_quiescent()
                cnts.update(eng.sched.counters)
                tokens_i += self._loops[i].tokens
                lats += self._loops[i].latencies()
                evictions += eng.sched.evictions
                peak_q = max(peak_q, self._loops[i].peak_queue)
            totals.update(cnts)
            flat += lats
            routed = self._routed[i]
            shed = int(cnts.get("shed", 0))
            per_replica.append({
                "replica": i,
                "health": self.health[i].state,
                "transient_faults": self.health[i].faults,
                "requests_routed": routed,
                "tokens": tokens_i,
                "tokens_per_sec": (tokens_i / elapsed
                                   if elapsed > 0 else 0.0),
                "queue_depth_peak": peak_q,
                "pool_occupancy_peak": round(
                    eng.peak_blocks_in_use
                    / max(1, eng.serve.num_blocks - 1), 4),
                "peak_live_blocks": eng.peak_live_blocks,
                "shed": shed,
                "shed_rate": round(shed / max(1, routed), 4),
                "evictions": evictions,
                "faults": faults_block(cnts),
            })
        # outputs/statuses come from the per-replica journals — the one
        # view that stays whole across failover (a migrated stream is
        # donor prefix + survivor suffix) and across process restarts
        outputs = rec_lib.fleet_outputs(self._journals)
        statuses = rec_lib.fleet_statuses(self._journals)
        # finish stamps: dead-incarnation archive, then live loops — a
        # migrated request's survivor stamp (strictly later) wins
        finish = dict(self._finish_archive)
        first = dict(self._first_archive)
        for lp in self._loops:
            if lp is not None:
                for rid, t in lp.last_emit.items():
                    finish[rid] = max(finish.get(rid, t), t)
                for rid, t in lp.first_emit.items():
                    first[rid] = min(first.get(rid, t), t)
        lat = np.asarray(flat) if flat else np.zeros(1)
        total = sum(len(v) for v in outputs.values())
        # workers are joined, but late probe/failover stragglers may
        # still hold references: snapshot the shared state in one hold
        with self._lock:
            fleet_counters = Counter(self.fleet_counters)
            drain_counts = Counter(self._drain_counts)
            sticky_n = len(self._sticky)
        drain = self._drain.result_counts(drain_counts)
        # fleet prefix view: scheduler counters summed over replicas
        # plus the router's own hint-hit count — the aggregate the
        # prefix-route A/B compares (per-replica detail is in stats())
        fleet_prefix = prefix_block(
            totals,
            enabled=any(e.prefix_cache is not None for e in self.engines),
            trie_blocks=sum(e.prefix_cache.num_blocks
                            for e in self.engines
                            if e.prefix_cache is not None),
            router_prefix_hits=int(
                fleet_counters["router_prefix_hits"]))
        res = {
            "parallel": parallel,
            "outputs": outputs,
            "statuses": statuses,
            "faults": faults_block(totals),
            "fleet_faults": fleet_faults_block(fleet_counters),
            "drain": drain,
            "health": [h.state for h in self.health],
            "replicas": per_replica,
            "num_replicas": len(self.engines),
            "prefix": fleet_prefix,
            "sticky_sessions": sticky_n,
            "placements": dict(self.placements),
            "tokens": total,
            "elapsed_s": elapsed,
            "tokens_per_sec": total / elapsed if elapsed > 0 else 0.0,
            "p50_token_latency_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_token_latency_ms": float(np.percentile(lat, 99)) * 1e3,
            "request_finish_s": finish,
            "request_first_token_s": first,
            # dispatch economy summed over the surviving incarnations
            # (a rebuilt replica restarts its counter — fleet numbers
            # are a floor, exact when no replica was rebuilt)
            "forward_dispatches": sum(e.forward_dispatches
                                      for e in self.engines),
            "dispatches_per_token": (
                sum(e.forward_dispatches for e in self.engines)
                / max(1, total)),
            "autoscale": (self._advisor.report()
                          if self._advisor is not None else None),
        }
        if any(eng.serve.trace == "on" for eng in self.engines):
            res["trace"] = self._trace_block(elapsed)
        return res

    def _trace_block(self, elapsed: float) -> dict:
        """Fleet trace view: per replica slot, merge the dead
        incarnations' archived harvests with the live loop's harvest
        (one Chrome-trace pid per replica), then fold every replica
        into one fleet span map.  ``merge_spans`` SUMS the phase
        accumulators, so a migrated request's queue time accumulates
        across donor and survivor incarnations — the failover span
        contract."""
        replicas = []
        all_harvests = []
        steps = dropped = 0
        for i in range(len(self.engines)):
            harvests = list(self._trace_archive[i])
            lp = self._loops[i]
            if lp is not None and lp.tracer is not None:
                harvests.append(lp.tracer.harvest(elapsed))
            if not harvests:
                continue
            step_recs = [rec for h in harvests for rec in h["steps"]]
            rep_dropped = sum(h["steps_dropped"] for h in harvests)
            replicas.append({
                "pid": i,
                "label": f"replica{i}",
                "spans": tracing.merge_spans(harvests),
                "steps": step_recs,
                "steps_dropped": rep_dropped,
            })
            all_harvests.extend(harvests)
            steps += len(step_recs)
            dropped += rep_dropped
        return {
            "enabled": True,
            "replicas": replicas,
            "spans": tracing.merge_spans(all_harvests),
            "steps": steps,
            "steps_dropped": dropped,
        }
