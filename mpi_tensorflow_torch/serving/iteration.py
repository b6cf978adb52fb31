"""The per-iteration serving body and the graceful-drain state machine.

Counterpart of ``mpi_tensorflow_tpu/serving/iteration.py``:

- ``EngineLoop.submit``  stamps the default per-request TTL and runs
  admission, starting the latency clock only for accepted requests;
- ``EngineLoop.iterate`` sweeps deadlines, steps the engine once, and
  does the emit/eviction accounting: a token's latency is the wall time
  since the SAME sequence's previous token (first token: since arrival,
  queueing included), and an eviction voids the samples delivered so
  far (they are regenerated; only the final delivered stream counts);
- ``DrainTracker`` — SIGTERM stops admission, sheds queued work, lets
  in-flight sequences finish inside ``drain_ms`` and cuts the rest as
  ``drained``.

The replay journal (crash recovery) is not ported yet (ROADMAP
Queue 1).  The tracer hooks stay, each guarded by ``tracer is None``:
the engine builds no tracer until the tracing slice lands.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


class EngineLoop:
    """Per-engine iteration state + the shared per-iteration body.
    Single-owner: only the thread driving the engine may touch it."""

    def __init__(self, engine):
        self.engine = engine
        self.tracer = getattr(engine, "tracer", None)
        self.token_times: Dict[int, List[float]] = {}
        self.last_emit: Dict[int, float] = {}
        # first-token emit stamp per request (TTFT = stamp - arrival);
        # an eviction clears it, like token_times
        self.first_emit: Dict[int, float] = {}
        self.tokens = 0
        self.peak_queue = 0

    def submit(self, req, *, front: bool = False):
        """Admit ``req``: stamp the default TTL (an explicit deadline
        wins), run admission control.  Returns the scheduler's
        ``RejectedRequest`` (terminal status recorded) or None."""
        eng = self.engine
        if eng.serve.deadline_ms is not None and req.deadline is None:
            req = dataclasses.replace(
                req, deadline=req.arrival + eng.serve.deadline_ms / 1e3)
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
