"""Host-side structured tracing of the serving loop.

Counterpart of ``mpi_tensorflow_tpu/serving/tracing.py``, ported whole.
It splits a request's time into queueing, prefill and decode, per
request and per step:

- ``Span``: one record a request, stamped arrive -> queued -> admitted
  -> prefill chunks -> first token -> decode -> terminal, the fault
  transitions included (eviction, deadline sweep, drain cut, failover
  migration and replay).  Phase time accumulates in ``queue_s``,
  ``prefill_s`` and ``decode_s``, so a span that bounces between phases
  still sums to its wall time: ``queue_s + prefill_s + decode_s ==
  terminal - arrive``.
- ``TraceBuffer``: a ring of ``STEP_CAPACITY`` step records (the
  deadline sweep's, the dispatches' and the token fetches' seconds, and
  ``engine.load_signals()``), dropping the oldest and counting what it
  dropped.  The same records feed ``ScaleAdvisor.observe_step``.
- ``merge_spans`` folds harvests across replicas and failover
  incarnations (phase time sums), and ``write_chrome_trace`` writes
  Chrome trace-event JSON, one pid per replica, for Perfetto or
  chrome://tracing.

Clocks: every span stamp is a ``now`` the serve loop already read; the
step phases are ``time.monotonic`` deltas.  On the card the tracer adds
no synchronisation: ``dispatch_s`` is the host's time to issue a
forward's launches, and ``consume_s`` is the token fetch the engine
already does, so it includes the device's wait for that forward to
finish.  With tracing off the engine builds no tracer, and every
instrumentation site is a ``tracer is None`` skip.

Ownership: a tracer is single-owner, like the scheduler: only the
thread driving its engine touches it.  The router archives harvests
from its own main thread.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

# Fixed ring capacity for step records.  Deliberately NOT a knob: the
# buffer exists to bound tracing memory, and a configurable bound is a
# bound someone sets to None.  At ~200 bytes/record this is ~1.6 MB.
STEP_CAPACITY = 8192

# Per-span event cap — a span's event list is the only per-request
# growth path (one entry per chunk/eviction/terminal), so bound it the
# same way the step ring is bounded.
SPAN_EVENT_CAP = 256

#: Phases a span's open clock can be attributed to.
PHASES = ("queue", "prefill", "decode")


class TraceBuffer:
    """Bounded drop-oldest ring for step records.

    ``append`` never grows past ``capacity``; once full, the oldest
    record is dropped and ``dropped`` increments — the counter is the
    contract that truncation is visible, never silent."""

    __slots__ = ("capacity", "dropped", "_buf")

    def __init__(self, capacity: int = STEP_CAPACITY):
        if capacity < 1:
            raise ValueError(f"TraceBuffer capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self.dropped = 0
        self._buf: deque = deque(maxlen=self.capacity)

    def append(self, rec: dict) -> None:
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append(rec)

    def records(self) -> List[dict]:
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self):
        return iter(self._buf)


class Span:
    """Lifecycle record for one request on one engine incarnation.

    The state machine: ``on_submit`` opens ``queue`` at arrival;
    admission closes ``queue`` and opens ``prefill``; the first
    delivered token closes ``prefill`` and opens ``decode``; a
    terminal closes whatever is open.  An eviction closes the open
    phase, VOIDS the first-token stamp (the pre-eviction first token
    is regenerated — the same rule as ``EngineLoop.first_emit``), and
    re-opens ``queue``.  Exactly one terminal transition ever lands:
    later terminal notifications for the same span are ignored."""

    __slots__ = ("rid", "arrive", "queue_s", "prefill_s", "decode_s",
                 "phase", "phase_t0", "first_token", "terminal",
                 "status", "chunks", "evictions", "replays",
                 "prefilled_seen", "events", "events_dropped")

    def __init__(self, rid: int, arrive: float):
        self.rid = rid
        self.arrive = arrive
        self.queue_s = 0.0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.phase: Optional[str] = "queue"
        self.phase_t0 = arrive
        self.first_token: Optional[float] = None
        self.terminal: Optional[float] = None
        self.status: Optional[str] = None
        self.chunks = 0
        self.evictions = 0
        self.replays = 0
        self.prefilled_seen = 0
        self.events: List[Tuple[float, str]] = []
        self.events_dropped = 0

    def event(self, t: float, name: str) -> None:
        if len(self.events) >= SPAN_EVENT_CAP:
            self.events_dropped += 1
            return
        self.events.append((t, name))

    def close_phase(self, now: float) -> None:
        """Fold the open phase's elapsed time into its accumulator."""
        if self.phase is None:
            return
        dt = max(0.0, now - self.phase_t0)
        if self.phase == "queue":
            self.queue_s += dt
        elif self.phase == "prefill":
            self.prefill_s += dt
        else:
            self.decode_s += dt
        self.phase = None

    def open_phase(self, phase: str, now: float) -> None:
        self.phase = phase
        self.phase_t0 = now

    def to_dict(self) -> dict:
        return {
            "rid": self.rid,
            "arrive": self.arrive,
            "queue_s": self.queue_s,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "first_token": self.first_token,
            "terminal": self.terminal,
            "status": self.status,
            "chunks": self.chunks,
            "evictions": self.evictions,
            "replays": self.replays,
            "incarnations": 1,
            "events": [(t, n) for t, n in self.events],
            "events_dropped": self.events_dropped,
        }


class EngineTracer:
    """Per-engine span + step recorder, driven by ``EngineLoop``.

    The tracer never reads a clock of its own on the span path — every
    stamp is a ``now`` the serve loop already computed, so span times
    and the loop's stamped latencies (``first_emit``/``token_times``)
    are the SAME values, which is what makes the breakdown-vs-stamp
    cross-check exact.  Terminal hooks fire inside ``engine.step()``
    where no loop clock is in scope, so ``on_terminal`` only QUEUES
    the transition; ``flush_terminals`` lands it with the post-step
    ``now`` — after first-token stamping, so ``terminal >=
    first_token`` always holds.

    Step-phase durations (``sweep_s``/``dispatch_s``/``consume_s``)
    are accumulated by the engine/loop via ``time.monotonic`` deltas
    between ``begin_step`` and ``end_step``."""

    def __init__(self, step_capacity: int = STEP_CAPACITY):
        self.spans: Dict[int, Span] = {}
        self.buffer = TraceBuffer(step_capacity)
        self.pending_terminals: List[Tuple[int, str]] = []
        self.last_step: Optional[dict] = None
        self.sweep_s = 0.0
        self.dispatch_s = 0.0
        self.consume_s = 0.0
        self._last_now = 0.0

    # ---- request lifecycle -------------------------------------------

    def on_submit(self, req, *, replay: bool = False) -> None:
        """Open (or re-open) the request's span at its arrival stamp.
        Called BEFORE scheduler admission so a synchronous rejection's
        terminal finds the span.  A re-submit of an id that already
        reached a terminal (a replayed incarnation landing on the same
        tracer) re-opens the span and keeps the accumulators — queue
        time ACCUMULATES across incarnations."""
        sp = self.spans.get(req.id)
        if sp is None:
            sp = Span(req.id, req.arrival)
            self.spans[req.id] = sp
        else:
            # re-incarnation on the same tracer: keep phase totals,
            # clear the terminal, restart the queue clock at the NEW
            # arrival (the gap between incarnations is dead time the
            # journal replay owns, not queueing)
            sp.close_phase(sp.terminal if sp.terminal is not None
                           else req.arrival)
            sp.terminal = None
            sp.status = None
            sp.first_token = None
            sp.prefilled_seen = 0
            sp.replays += 1
            sp.open_phase("queue", req.arrival)
        sp.event(req.arrival, "replay" if replay else "queued")

    def on_terminal(self, req, status: str) -> None:
        """Terminal hook body — clock-free by design (fires inside
        ``engine.step()``); the transition lands at the next flush."""
        self.pending_terminals.append((req.id, status))

    def flush_terminals(self, now: float) -> None:
        for rid, status in self.pending_terminals:
            sp = self.spans.get(rid)
            if sp is None or sp.status is not None:
                continue            # exactly one terminal per span
            sp.close_phase(now)
            sp.terminal = now
            sp.status = status
            sp.event(now, f"terminal:{status}")
        if self.pending_terminals:
            self.pending_terminals.clear()
        self._last_now = max(self._last_now, now)

    def observe(self, occupied: Iterable[Tuple[int, int, int]],
                emitted_ids: Iterable[int], now: float) -> None:
        """Post-step observation pass: detect admissions and prefill
        chunk advances from the scheduler's occupied slots, and
        first-token transitions from this step's emissions — all at
        the same post-step ``now`` the loop stamps latencies with."""
        for rid, prefilled, _generated in occupied:
            sp = self.spans.get(rid)
            if sp is None or sp.status is not None:
                continue
            if sp.phase == "queue":
                sp.close_phase(now)
                sp.open_phase("prefill", now)
                sp.event(now, "admitted")
            if sp.phase == "prefill" and prefilled > sp.prefilled_seen:
                sp.chunks += 1
                sp.prefilled_seen = prefilled
                sp.event(now, "prefill_chunk")
        for rid in emitted_ids:
            sp = self.spans.get(rid)
            if (sp is None or sp.status is not None
                    or sp.first_token is not None):
                continue
            if sp.phase == "queue":
                # admitted, prefilled AND emitted inside one step (a
                # terminal removed it from the slots before the
                # occupancy pass could see it)
                sp.event(now, "admitted")
            sp.close_phase(now)
            sp.first_token = now
            sp.event(now, "first_token")
            sp.open_phase("decode", now)

    def on_evict(self, rid: int, now: float) -> None:
        """Eviction voids delivered work: the first-token stamp clears
        (it will be regenerated — same rule as the latency clock) and
        the span re-queues."""
        sp = self.spans.get(rid)
        if sp is None or sp.status is not None:
            return
        sp.close_phase(now)
        sp.first_token = None
        sp.prefilled_seen = 0
        sp.evictions += 1
        sp.event(now, "evicted")
        sp.open_phase("queue", now)

    # ---- step timeline -----------------------------------------------

    def begin_step(self) -> None:
        self.sweep_s = 0.0
        self.dispatch_s = 0.0
        self.consume_s = 0.0

    def end_step(self, t0: float, now: float, emitted: int,
                 signals: dict) -> None:
        rec = {
            "t0": t0,
            "t1": now,
            "sweep_s": self.sweep_s,
            "dispatch_s": self.dispatch_s,
            "consume_s": self.consume_s,
            "emitted": int(emitted),
            "signals": signals,
        }
        self.buffer.append(rec)
        self.last_step = rec
        self._last_now = max(self._last_now, now)

    # ---- harvest ------------------------------------------------------

    def harvest(self, now: Optional[float] = None, *,
                reason: Optional[str] = None) -> dict:
        """Freeze this tracer into a mergeable dict.  Open phases are
        closed at ``now`` (default: the last stamp this tracer saw) so
        a failover harvest charges the victim's spans up to the
        failure instant; ``reason`` (e.g. ``"migrated"``) is stamped
        on every span that was still open."""
        if now is None:
            now = self._last_now
        self.flush_terminals(now)
        spans = {}
        for rid, sp in self.spans.items():
            if sp.status is None and sp.phase is not None:
                sp.close_phase(now)
                if reason is not None:
                    sp.event(now, reason)
            spans[rid] = sp.to_dict()
        return {
            "spans": spans,
            "steps": self.buffer.records(),
            "steps_dropped": self.buffer.dropped,
        }


def merge_spans(harvests: Iterable[dict]) -> Dict[int, dict]:
    """Fold span dicts across harvests (replicas and/or failover
    incarnations) by request id.  Phase accumulators SUM — this is the
    failover contract: a migrated request's queue time accumulates
    across incarnations instead of resetting at re-admission.  The
    first-token stamp min-merges (mirror of the router's
    ``_first_archive``), the terminal comes from whichever incarnation
    actually finished (latest wins), and ``arrive`` is the earliest
    incarnation's arrival so end-to-end attained latency spans the
    whole migration."""
    out: Dict[int, dict] = {}
    for h in harvests:
        for rid, d in h["spans"].items():
            m = out.get(rid)
            if m is None:
                m = dict(d)
                m["events"] = list(d["events"])
                out[rid] = m
                continue
            m["queue_s"] += d["queue_s"]
            m["prefill_s"] += d["prefill_s"]
            m["decode_s"] += d["decode_s"]
            m["arrive"] = min(m["arrive"], d["arrive"])
            firsts = [t for t in (m["first_token"], d["first_token"])
                      if t is not None]
            m["first_token"] = min(firsts) if firsts else None
            if d["status"] is not None:
                if (m["status"] is None or m["terminal"] is None
                        or (d["terminal"] is not None
                            and d["terminal"] >= m["terminal"])):
                    m["status"] = d["status"]
                    m["terminal"] = d["terminal"]
            m["chunks"] += d["chunks"]
            m["evictions"] += d["evictions"]
            m["replays"] += d["replays"]
            m["incarnations"] += d.get("incarnations", 1)
            m["events"] = sorted(m["events"] + list(d["events"]),
                                 key=lambda e: e[0])
            m["events_dropped"] += d["events_dropped"]
    return out


def _us(t: float) -> int:
    return max(0, int(round(t * 1e6)))


def write_chrome_trace(path: str, replicas: List[dict]) -> dict:
    """Write Chrome trace-event (catapult) JSON: one pid per replica,
    request spans as async ``b``/``n``/``e`` events (matched by
    ``cat``+``id``), steps as ``X`` duration events on tid 1.  Open
    the file in Perfetto (ui.perfetto.dev) or chrome://tracing.

    ``replicas`` entries are harvest dicts plus ``pid``/``label``
    (the engine emits one; the router one per replica, incarnations
    pre-merged).  Returns a small summary dict ``{path, events,
    requests, steps}`` for logging."""
    events: List[dict] = []
    n_req = n_step = 0
    for rep in replicas:
        pid = int(rep.get("pid", 0))
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "ts": 0,
                       "args": {"name": rep.get("label",
                                                f"replica{pid}")}})
        for rid in sorted(rep["spans"]):
            sp = rep["spans"][rid]
            name = f"request {sp['rid']}"
            base = {"name": name, "cat": "request", "id": int(sp["rid"]),
                    "pid": pid, "tid": 0}
            events.append({**base, "ph": "b", "ts": _us(sp["arrive"]),
                           "args": {"arrive_s": sp["arrive"]}})
            for t, ev in sp["events"]:
                events.append({**base, "ph": "n", "ts": _us(t),
                               "args": {"event": ev}})
            end = sp["terminal"]
            if end is None:
                end = (sp["arrive"] + sp["queue_s"] + sp["prefill_s"]
                       + sp["decode_s"])
            events.append({**base, "ph": "e", "ts": max(_us(end),
                                                        _us(sp["arrive"])),
                           "args": {
                               "status": sp["status"],
                               "queue_ms": sp["queue_s"] * 1e3,
                               "prefill_ms": sp["prefill_s"] * 1e3,
                               "decode_ms": sp["decode_s"] * 1e3,
                               "evictions": sp["evictions"],
                           }})
            n_req += 1
        for rec in rep.get("steps", ()):
            dur = max(1, _us(rec["t1"] - rec["t0"]))
            events.append({"name": "step", "cat": "step", "ph": "X",
                           "pid": pid, "tid": 1, "ts": _us(rec["t0"]),
                           "dur": dur,
                           "args": {
                               "sweep_us": _us(rec["sweep_s"]),
                               "dispatch_us": _us(rec["dispatch_s"]),
                               "consume_us": _us(rec["consume_s"]),
                               "emitted": rec["emitted"],
                               "signals": rec["signals"],
                           }})
            n_step += 1
    # catapult tolerates unsorted input, but monotone-per-track is the
    # schema our tests (and humans reading the raw JSON) rely on
    events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"]))
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return {"path": path, "events": len(events), "requests": n_req,
            "steps": n_step}
