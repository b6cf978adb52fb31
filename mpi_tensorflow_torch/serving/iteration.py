"""The per-iteration serving body and the graceful-drain state machine.

Counterpart of ``mpi_tensorflow_tpu/serving/iteration.py``:

- ``EngineLoop.submit``  stamps the default per-request TTL, journals
  the submit (with a replayed request's delivered ``pre``) and runs
  admission, starting the latency clock only for accepted requests;
- ``EngineLoop.iterate`` sweeps deadlines, steps the engine once, and
  does the emit/eviction accounting: a token's latency is the wall time
  since the SAME sequence's previous token (first token: since arrival,
  queueing included), and an eviction voids the samples delivered so
  far (they are regenerated; only the final delivered stream counts)
  and journals the void, so a replay forgets them too;
- ``DrainTracker`` — SIGTERM stops admission, sheds queued work, lets
  in-flight sequences finish inside ``drain_ms`` and cuts the rest as
  ``drained``.

``engine.run`` and the replica router (``serving/router``) both drive
an ``EngineLoop`` per engine, so the two share one accounting.  Every
tracer stamp is a ``tracer is None`` skip with tracing off.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


class EngineLoop:
    """Per-engine iteration state + the shared per-iteration body.
    Single-owner: only the thread driving the engine may touch it."""

    def __init__(self, engine, journal=None):
        self.engine = engine
        self.journal = journal
        # the engine journals each token at emission, BEFORE the
        # scheduler's terminal hook can fire: tok-then-end
        engine._journal = journal
        self.tracer = getattr(engine, "tracer", None)
        self.token_times: Dict[int, List[float]] = {}
        self.last_emit: Dict[int, float] = {}
        # first-token emit stamp per request (TTFT = stamp - arrival);
        # an eviction clears it, like token_times
        self.first_emit: Dict[int, float] = {}
        self.tokens = 0
        self.peak_queue = 0

    def submit(self, req, *, pre: Optional[List[int]] = None,
               front: bool = False):
        """Admit ``req``: stamp the default TTL (an explicit deadline
        wins), journal the submit, run admission control.  ``pre`` is a
        replayed request's delivered prefix, staged into the journal so
        the durable stream stays whole across engines; ``front`` queues
        ahead of earlier arrivals (migrated work already waited its
        turn once).  Returns the scheduler's ``RejectedRequest``
        (terminal status recorded) or None."""
        eng = self.engine
        if eng.serve.deadline_ms is not None and req.deadline is None:
            req = dataclasses.replace(
                req, deadline=req.arrival + eng.serve.deadline_ms / 1e3)
        if self.journal is not None:
            self.journal.record_submit(req, pre=pre)
        tr = self.tracer
        if tr is not None:
            tr.on_submit(req, replay=req.replayed)
        rej = eng.sched.submit(req, front=front)
        if rej is not None:
            if tr is not None:
                tr.flush_terminals(req.arrival)
            return rej
        self.last_emit[req.id] = req.arrival
        self.token_times[req.id] = []
        self.peak_queue = max(self.peak_queue, len(eng.sched.waiting))
        return None

    def iterate(self, now: float, time_fn, t0: float) \
            -> List[Tuple[int, int]]:
        """One engine iteration: deadline sweep BEFORE the step (expired
        work must not buy another dispatch), one ``engine.step()``, then
        the emit/eviction accounting.  Returns the ``(request id,
        token)`` pairs emitted."""
        eng = self.engine
        tr = self.tracer
        if tr is not None:
            step_t0 = now
            tr.begin_step()
            _m0 = time.monotonic()
        eng.sched.expire_deadlines(now)
        if tr is not None:
            tr.sweep_s += time.monotonic() - _m0
        emitted = eng.step()
        now = time_fn() - t0
        for rid, _tok in emitted:
            if rid in self.last_emit:
                self.token_times[rid].append(now - self.last_emit[rid])
                self.last_emit[rid] = now
                self.first_emit.setdefault(rid, now)
        self.tokens += len(emitted)
        if tr is not None:
            tr.observe(eng.sched.occupied_view(),
                       {rid for rid, _tok in emitted}, now)
        # AFTER the emit accounting: an eviction discards the request's
        # samples so far — including a token emitted this very step
        for rid in eng.sched.evicted_ids:
            if self.journal is not None:
                self.journal.record_evict(rid)
            self.token_times[rid] = []
            self.last_emit[rid] = now
            self.first_emit.pop(rid, None)
            if tr is not None:
                tr.on_evict(rid, now)
        eng.sched.evicted_ids.clear()
        if tr is not None:
            tr.flush_terminals(now)
            tr.end_step(step_t0, now, len(emitted), eng.load_signals())
        return emitted

    def latencies(self) -> List[float]:
        return [x for ts in self.token_times.values() for x in ts]


class DrainTracker:
    """Graceful-drain state: ``start`` marks the stop request (admission
    stops, queued work sheds), ``expired`` is the budget's hard edge past
    which in-flight work is cut as ``drained``.  ``drain_ms`` None = no
    budget (finish everything in flight)."""

    def __init__(self, drain_ms: Optional[float]):
        self.drain_ms = drain_ms
        self.draining = False
        self.t0 = 0.0
        self.shed = 0            # queued/pending work shed at drain start
        self.fin_at_start = 0    # completions before the stop request

    def start(self, now: float, finished_now: int = 0) -> None:
        self.draining = True
        self.t0 = now
        self.fin_at_start = finished_now

    def expired(self, now: float) -> bool:
        return (self.draining and self.drain_ms is not None
                and (now - self.t0) * 1e3 > self.drain_ms)

    def result(self, finished_total: int, cut: int) -> dict:
        """The ``drain`` result block (requested / drained-to-completion
        / shed / cut / budget)."""
        return {
            "requested": self.draining,
            "drained": (finished_total - self.fin_at_start
                        if self.draining else 0),
            "shed": self.shed if self.draining else 0,
            "cut": int(cut),
            "budget_ms": self.drain_ms,
        }

    def result_counts(self, counts) -> dict:
        """The SAME canonical block, computed from per-status terminal
        counts recorded while draining — the fleet router's accounting
        (it observes terminals as hook notifications rather than one
        scheduler's finished-list delta).  Defined here, next to
        ``result``, so the block's shape lives in exactly one module."""
        return {
            "requested": self.draining,
            "drained": int(counts.get("ok", 0)) if self.draining else 0,
            "shed": int(counts.get("shed", 0)) if self.draining else 0,
            "cut": int(counts.get("drained", 0)),
            "budget_ms": self.drain_ms,
        }
