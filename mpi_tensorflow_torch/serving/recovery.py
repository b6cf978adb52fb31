"""Crash recovery for serving: the replay journal and its supervisor.

Counterpart of ``mpi_tensorflow_tpu/serving/recovery.py``, ported whole.
Greedy decoding is deterministic: for fixed weights the tokens after a
prompt are a function of the prompt.  So the state a serving process
must keep durable is each request's prompt and the tokens delivered so
far.  After a crash (or a transient fault inside the process) a live
request replays as a fresh request whose prompt is ``prompt + delivered``
and whose budget is what remains: chunked prefill re-ingests the
concatenation, and its final argmax is the token the lost engine would
have emitted next.

- ``ReplayJournal``: an append-only JSONL file of submit / tok / evict /
  end records, mirrored in memory.  The records keep the reference's
  keys and order, so a journal written by either package replays in the
  other.  ``path=None`` keeps it in memory (in-process retries); with a
  path each record is durable once its line is written, and a torn last
  line of a killed writer is skipped on load (and ended before the next
  record: the reference appends to it, so that record is lost to a
  later load).  In a tensor-parallel world (``serving/tp``) the file is
  rank 0's: the other ranks mirror in memory the records rank 0 loaded
  and record what they serve there, so every rank replays alike and no
  two processes append to one file.
- ``replay_one``: re-roots one live entry (shared with the router's
  failover).
- ``merge_fleet_entries``, ``fleet_statuses``, ``fleet_outputs``,
  ``fleet_replay_requests``: the per-request view across a fleet's
  per-replica journals.
- ``run_with_replay``: runs an engine over the journal, classifies a
  failure with ``train/elastic.is_transient``, rebuilds the engine
  (fresh pools) on a transient one and replays the live requests; a
  permanent one (a sticky CUDA fault among them) raises.

The prefix trie indexes pool content, so it dies with the engine and
the replayed prefills rebuild it; nothing of it is journaled.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from collections import Counter
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from mpi_tensorflow_torch.serving import tp as tp_lib
from mpi_tensorflow_torch.serving.scheduler import Request
from mpi_tensorflow_torch.train import elastic
from mpi_tensorflow_torch.utils import metrics_writer


@dataclasses.dataclass
class JournalEntry:
    """Replay state of one request: the submitted prompt, the tokens
    delivered before this submit (``pre``, non-empty only on a replay
    submit, whose prompt embeds them), the tokens generated since, and
    the terminal status once recorded."""
    prompt: List[int]
    max_new_tokens: int
    arrival: float
    pre: List[int] = dataclasses.field(default_factory=list)
    toks: List[int] = dataclasses.field(default_factory=list)
    status: Optional[str] = None

    @property
    def delivered(self) -> List[int]:
        """The output stream as the client has seen it so far."""
        return self.pre + self.toks


class ReplayJournal:
    """Append-only request journal, optionally durable.

    One JSON object a line:
      {"kind": "submit", "id", "prompt", "n", "arrival", "pre"}
      {"kind": "tok",    "id", "t"}
      {"kind": "evict",  "id"}   # tokens since the last submit are void
      {"kind": "end",    "id", "status"}

    An existing ``path`` is loaded first (the crash-recovery entry
    point), then appended to.  In a world of several ranks every rank
    constructs its journal at the same point (one broadcast of rank 0's
    loaded records); only rank 0 opens the file."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: Dict[int, JournalEntry] = {}
        self.statuses: Dict[int, str] = {}
        # delivered-so-far per replayed id, staged by replay_requests so
        # the engine's plain record_submit(req) journals the right "pre"
        self._pending_pre: Dict[int, List[int]] = {}
        self._fh = None
        if path is None:
            return
        rank, size = tp_lib.world()
        records, torn = [], False
        if rank == 0 and os.path.exists(path):
            records, torn = self._read(path)
        if size > 1:
            box = [records]
            dist.broadcast_object_list(box, 0, device=torch.device("cpu"))
            records = box[0]
        for rec in records:
            self._apply(rec)
        if rank == 0:
            # line-buffered: a record is durable once its line completes
            self._fh = open(path, "a", buffering=1)
            if torn:
                # end the torn line, or the next record would join it
                # and be lost to the next load
                self._fh.write("\n")

    @staticmethod
    def _read(path: str) -> tuple:
        """The file's records, and whether its last line is unterminated
        (a writer killed mid-line)."""
        with open(path) as f:
            text = f.read()
        records = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue            # torn last line of a killed writer
        return records, bool(text) and not text.endswith("\n")

    def _apply(self, rec: dict) -> None:
        kind, rid = rec.get("kind"), rec.get("id")
        if kind == "submit":
            self.entries[rid] = JournalEntry(
                prompt=list(rec["prompt"]), max_new_tokens=int(rec["n"]),
                arrival=float(rec.get("arrival", 0.0)),
                pre=list(rec.get("pre", ())))
        elif kind == "tok" and rid in self.entries:
            self.entries[rid].toks.append(int(rec["t"]))
        elif kind == "evict" and rid in self.entries:
            # an evicted sequence restarts; its tokens are regenerated
            self.entries[rid].toks.clear()
        elif kind == "end":
            self.statuses[rid] = rec["status"]
            if rid in self.entries:
                self.entries[rid].status = rec["status"]

    def _write(self, rec: dict) -> None:
        self._apply(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")

    def record_submit(self, req: Request,
                      pre: Optional[List[int]] = None) -> None:
        if pre is None:
            pre = self._pending_pre.pop(req.id, [])
        self._write({"kind": "submit", "id": req.id,
                     "prompt": list(req.prompt), "n": req.max_new_tokens,
                     "arrival": req.arrival, "pre": list(pre)})

    def record_token(self, rid: int, tok: int) -> None:
        self._write({"kind": "tok", "id": rid, "t": int(tok)})

    def record_evict(self, rid: int) -> None:
        self._write({"kind": "evict", "id": rid})

    def record_end(self, req: Request, status: str) -> None:
        self._write({"kind": "end", "id": req.id, "status": status})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def replay_requests(self, requests: List[Request],
                        eos_id: Optional[int] = None) -> List[Request]:
        """The requests a replacement run serves: never-journaled ones as
        they are, live ones re-rooted at ``prompt + delivered`` with the
        remaining budget, terminated ones left out.  Deadlines are
        dropped: they were stamped on the dead process's clock."""
        out = []
        for req in requests:
            ent = self.entries.get(req.id)
            if ent is None:
                if req.id in self.statuses:
                    continue          # rejected or shed before admission
                out.append(req)
                continue
            if ent.status is not None:
                continue
            rep, done = replay_one(ent, req, eos_id)
            if rep is None:
                # crashed between the final token and its end record
                self.record_end(req, "ok")
                continue
            self._pending_pre[req.id] = done
            out.append(rep)
        return out

    def outputs(self) -> Dict[int, List[int]]:
        """Delivered streams of every ``ok`` request."""
        return {rid: ent.delivered for rid, ent in self.entries.items()
                if ent.status == "ok"}


def replay_one(ent: JournalEntry, req: Request,
               eos_id: Optional[int] = None,
               arrival: float = 0.0) -> tuple:
    """Re-root one live entry as a fresh request (the supervisor's and
    the router's failover primitive).  The prompt is ``ent.prompt`` (it
    already embeds the submit's ``pre``) plus the tokens since, so this
    holds whether ``req`` is the original or an earlier replay; ``req``
    gives only the id and the session.  Returns ``(request,
    delivered)``; the request is None when the stream is already
    complete, and the caller records the terminal ``ok``."""
    done = ent.delivered
    if eos_id is not None and eos_id in done:
        done = done[:done.index(eos_id) + 1]
    remaining = ent.max_new_tokens + len(ent.pre) - len(done)
    if remaining <= 0 or (eos_id is not None and done
                          and done[-1] == eos_id):
        return None, done
    since = done[len(ent.pre):]
    return Request(req.id, list(ent.prompt) + since, remaining,
                   arrival=arrival, replayed=True,
                   session=req.session), done


# ---------------- the fleet's journals (serving/router) ----------------

def _entry_wins(a: JournalEntry, b: JournalEntry) -> bool:
    """Whether ``a`` is the more authoritative view of one request: a
    terminal status beats a live entry, else the longer delivered
    stream (a migrated-to replica's entry extends the donor's)."""
    if (a.status is not None) != (b.status is not None):
        return a.status is not None
    return len(a.delivered) > len(b.delivered)


def merge_fleet_entries(journals) -> Dict[int, tuple]:
    """``{request id: (entry, owning journal)}`` across a fleet."""
    best: Dict[int, tuple] = {}
    for j in journals:
        for rid, ent in j.entries.items():
            cur = best.get(rid)
            if cur is None or _entry_wins(ent, cur[0]):
                best[rid] = (ent, j)
    return best


def fleet_statuses(journals) -> Dict[int, str]:
    """Terminal statuses across the fleet (each request ends once)."""
    out: Dict[int, str] = {}
    for j in journals:
        out.update(j.statuses)
    return out


def fleet_outputs(journals) -> Dict[int, List[int]]:
    """Delivered streams of every ``ok`` request across the fleet, a
    stream split by a failover coming back whole."""
    return {rid: ent.delivered
            for rid, (ent, _j) in merge_fleet_entries(journals).items()
            if ent.status == "ok"}


def fleet_replay_requests(journals, requests: List[Request],
                          eos_id: Optional[int] = None) -> tuple:
    """``(requests, {request id: delivered prefix})`` a replacement
    fleet serves: ``ReplayJournal.replay_requests`` over the merged
    view; the router stages each prefix into whichever replica's journal
    the replay lands on."""
    merged = merge_fleet_entries(journals)
    statuses = fleet_statuses(journals)
    todo: List[Request] = []
    pre: Dict[int, List[int]] = {}
    for req in requests:
        got = merged.get(req.id)
        if got is None:
            if req.id not in statuses:
                todo.append(req)
            continue
        ent, journal = got
        if ent.status is not None or req.id in statuses:
            # a terminal status anywhere in the fleet wins over a stale
            # live entry in another journal
            continue
        rep, done = replay_one(ent, req, eos_id)
        if rep is None:
            journal.record_end(req, "ok")
            continue
        todo.append(rep)
        pre[req.id] = done
    return todo, pre


def run_with_replay(make_engine: Callable[[], "object"],
                    requests: List[Request], *,
                    journal: Optional[ReplayJournal] = None,
                    journal_path: Optional[str] = None,
                    max_restarts: int = 3,
                    backoff_seconds: float = 0.0,
                    is_transient_fn: Callable[[BaseException],
                                              bool] = elastic.is_transient,
                    guard=None, time_fn=time.perf_counter) -> dict:
    """Serve ``requests`` through a journaled engine from
    ``make_engine`` (a fresh ``PagedDecodeEngine`` a call), surviving
    transient failures by rebuilding the engine and replaying the live
    requests.  Returns the last run's result with ``outputs`` and
    ``statuses`` merged across every attempt (from the journal),
    ``faults``, ``prefix`` and ``speculation`` summed over the attempts,
    ``replays`` and ``delivered_tokens``."""
    own = journal is None
    if own:
        journal = ReplayJournal(journal_path)
    try:
        return _serve_with_replay(make_engine, requests, journal,
                                  max_restarts, backoff_seconds,
                                  is_transient_fn, guard, time_fn)
    finally:
        if own:
            journal.close()


def _serve_with_replay(make_engine, requests, journal, max_restarts,
                       backoff_seconds, is_transient_fn, guard,
                       time_fn) -> dict:
    totals: Counter = Counter()
    crash_harvests: List[dict] = []
    attempt = 0
    while True:
        engine = None
        try:
            # the rebuild can meet the recovering device too
            engine = make_engine()
            todo = journal.replay_requests(requests,
                                           eos_id=engine.serve.eos_id)
            res = engine.run(todo, journal=journal, guard=guard,
                             time_fn=time_fn)
            totals.update(engine.sched.counters)
            break
        except Exception as e:     # noqa: BLE001 — classified right below
            if engine is not None:
                totals.update(engine.sched.counters)
                if getattr(engine, "tracer", None) is not None:
                    # the dying incarnation's spans, closed at its last
                    # stamp, merged below across the restarts
                    crash_harvests.append(
                        engine.tracer.harvest(reason="crashed"))
            if not is_transient_fn(e) or attempt >= max_restarts:
                raise
            attempt += 1
            print(f"[serving-recovery] transient failure ({e!r}); "
                  f"rebuilding engine, replay {attempt}/{max_restarts}",
                  file=sys.stderr)
            if backoff_seconds > 0:
                time.sleep(backoff_seconds)
    totals["replays"] += attempt
    if crash_harvests and res.get("trace") is not None:
        from mpi_tensorflow_torch.serving.tracing import merge_spans

        harvests = crash_harvests + [res["trace"]["replicas"][0]]
        spans = merge_spans(harvests)
        steps = [r for h in harvests for r in h["steps"]]
        dropped = sum(h["steps_dropped"] for h in harvests)
        res["trace"] = {
            "enabled": True,
            "replicas": [{"pid": 0, "label": "engine", "spans": spans,
                          "steps": steps, "steps_dropped": dropped}],
            "spans": spans,
            "steps": len(steps),
            "steps_dropped": dropped,
        }
    res["outputs"] = journal.outputs()
    res["statuses"] = dict(journal.statuses)
    # tokens / elapsed_s / tokens_per_sec stay the final attempt's own
    res["delivered_tokens"] = sum(len(v) for v in res["outputs"].values())
    res["faults"] = metrics_writer.faults_block(totals)
    res["replays"] = attempt
    if "prefix" in res:
        res["prefix"] = metrics_writer.prefix_block(
            totals, enabled=res["prefix"]["enabled"],
            trie_blocks=res["prefix"]["trie_blocks"])
    if "speculation" in res:
        res["speculation"] = metrics_writer.speculation_block(
            totals, enabled=res["speculation"]["enabled"],
            mode=res["speculation"]["mode"],
            draft_k=res["speculation"]["draft_k"],
            draft_auto=res["speculation"].get("draft_auto", "off"))
    return res
