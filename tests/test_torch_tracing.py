"""The port's request tracing against the JAX reference, on the CPU.

On one virtual clock (each read advances it a fixed step, and both
packages' loops read it at the same points), the engine with
``trace="on"`` gives the reference's spans (event names and times,
statuses, chunks, evictions) and step records (times, ``emitted`` and
the load signals; the ``time.monotonic`` phase seconds aside), through
a pool small enough to evict, and the fleet's trace with a transient
fault (the migrated spans merged across incarnations) is the
reference's too.  With tracing off the engine holds no tracer, the
result has no ``trace`` key and the tokens are the traced run's.  Every
finished span's phases sum to its wall time within 1e-6 s; the ring
buffer, ``merge_spans`` and ``write_chrome_trace`` (one pid per replica)
match the reference's on the same input.
"""

import json

import numpy as np
import pytest

from _torch_serving_cases import (fast_compile, jax_engine_for, np_params,
                                  port_engine_for)
from mpi_tensorflow_tpu.serving import router as jax_router
from mpi_tensorflow_tpu.serving import scheduler as jax_sched
from mpi_tensorflow_tpu.serving import tracing as jax_tracing
from mpi_tensorflow_tpu.utils import metrics_writer as jax_metrics
from mpi_tensorflow_torch.serving import recovery, router
from mpi_tensorflow_torch.serving import scheduler as sched
from mpi_tensorflow_torch.serving import tracing
from mpi_tensorflow_torch.utils import metrics_writer

# 7 usable blocks of 4 under 3 slots: the 12-token sequences evict
SERVE = dict(num_blocks=8, block_size=4, max_slots=3, max_seq_len=16,
             prefill_chunk=4, trace="on")
# the fleet on the same pool geometry (its compiles are shared)
FLEET = dict(SERVE, failover_backoff_ms=6.0)
PHASE_CLOCKS = ("sweep_s", "dispatch_s", "consume_s")


class Clock:
    def __init__(self, step: float = 2e-3):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def burst(mod, n=5, sessions=False):
    rng = np.random.default_rng(11)
    return [mod.Request(i, [int(t) for t in rng.integers(0, 1024, 6)], 6,
                        arrival=0.004 * i,
                        session=(i % 2 if sessions else None))
            for i in range(n)]


def _steps(trace):
    return [{k: v for k, v in rec.items() if k not in PHASE_CLOCKS}
            for rec in trace["replicas"][0]["steps"]]


@pytest.fixture(scope="module")
def reference():
    params = np_params(2)
    with fast_compile():
        eng = jax_engine_for(params, SERVE)
        single = eng.run(burst(jax_sched), time_fn=Clock())
        fl = [jax_engine_for(params, FLEET, donor=eng) for _ in range(2)]
        r = jax_router.ReplicaRouter(fl)
        fleet = r.run(burst(jax_sched, 6, sessions=True), time_fn=Clock(),
                      parallel=False, fault_plan=jax_router.FaultPlan(
                          [jax_router.ReplicaFault(0, 3)]))
    return params, single, fleet


def test_engine_spans_and_steps_match_reference(reference):
    params, want, _ = reference
    eng = port_engine_for(params, SERVE, "cuda")
    got = eng.run(burst(sched), time_fn=Clock())
    assert got["outputs"] == want["outputs"]
    assert got["evictions"] == want["evictions"] >= 1
    assert got["trace"]["spans"] == want["trace"]["spans"]
    assert _steps(got["trace"]) == _steps(want["trace"])
    assert got["trace"]["steps"] == want["trace"]["steps"] > 0
    names = {n for sp in got["trace"]["spans"].values()
             for _t, n in sp["events"]}
    assert {"queued", "admitted", "prefill_chunk", "first_token",
            "evicted", "terminal:ok"} <= names
    for rec in got["trace"]["replicas"][0]["steps"]:
        assert all(rec[k] >= 0 for k in PHASE_CLOCKS)
    bd = metrics_writer.breakdown_block(
        got["trace"], stamped_first_s=got["request_first_token_s"])
    assert bd == jax_metrics.breakdown_block(
        got["trace"], stamped_first_s=got["request_first_token_s"])
    assert bd["ttft_vs_stamp_max_delta_ms"] == 0.0


def test_trace_off_holds_no_tracer(reference):
    params, want, _ = reference
    eng = port_engine_for(params, dict(SERVE, trace="off"), "gather")
    assert eng.tracer is None
    got = eng.run(burst(sched), time_fn=Clock())
    assert eng.tracer is None and "trace" not in got
    assert got["outputs"] == want["outputs"]


def test_phases_sum_to_wall_time(reference):
    """On the wall clock: ``queue_s + prefill_s + decode_s == terminal -
    arrive`` for every span, within 1e-6 s."""
    params, _, _ = reference
    eng = port_engine_for(params, SERVE, "gather")
    spans = eng.run(burst(sched))["trace"]["spans"]
    assert len(spans) == 5
    for sp in spans.values():
        assert sp["status"] == "ok"
        total = sp["queue_s"] + sp["prefill_s"] + sp["decode_s"]
        assert abs(total - (sp["terminal"] - sp["arrive"])) <= 1e-6


def test_fleet_trace_matches_reference(reference, tmp_path):
    """Two traced replicas, a transient fault at replica 0: the merged
    spans (the migrated requests' across incarnations), the per-replica
    step records and the Chrome trace, one pid per replica."""
    params, _, want = reference
    r = router.ReplicaRouter([port_engine_for(params, FLEET, "gather")
                              for _ in range(2)])
    got = r.run(burst(sched, 6, sessions=True), time_fn=Clock(),
                parallel=False,
                fault_plan=router.FaultPlan([router.ReplicaFault(0, 3)]))
    assert got["outputs"] == want["outputs"]
    assert got["trace"]["spans"] == want["trace"]["spans"]
    assert [_steps({"replicas": [rep]}) for rep in got["trace"]["replicas"]] \
        == [_steps({"replicas": [rep]}) for rep in want["trace"]["replicas"]]
    assert any(sp["incarnations"] > 1 for sp in got["trace"]["spans"].values())
    path = tmp_path / "fleet.json"
    summary = tracing.write_chrome_trace(str(path),
                                         got["trace"]["replicas"])
    events = json.loads(path.read_text())["traceEvents"]
    assert {e["pid"] for e in events if e["ph"] == "M"} == {0, 1}
    assert summary["requests"] == sum(len(rep["spans"]) for rep in
                                      got["trace"]["replicas"])


def test_buffer_merge_and_chrome_export_match_reference(reference, tmp_path):
    """The same records through both rings (drop-oldest, the counter),
    the same harvests through both ``merge_spans``, the same replicas
    through both exporters: equal."""
    buf, ref = tracing.TraceBuffer(5), jax_tracing.TraceBuffer(5)
    for i in range(12):
        buf.append({"i": i})
        ref.append({"i": i})
    assert (buf.records(), buf.dropped) == (ref.records(), ref.dropped)
    assert tracing.STEP_CAPACITY == jax_tracing.STEP_CAPACITY
    assert tracing.SPAN_EVENT_CAP == jax_tracing.SPAN_EVENT_CAP
    _, single, fleet = reference
    harvests = fleet["trace"]["replicas"] + single["trace"]["replicas"]
    assert tracing.merge_spans(harvests) == jax_tracing.merge_spans(harvests)
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    got = tracing.write_chrome_trace(str(a), fleet["trace"]["replicas"])
    want = jax_tracing.write_chrome_trace(str(b),
                                          fleet["trace"]["replicas"])
    assert {k: v for k, v in got.items() if k != "path"} \
        == {k: v for k, v in want.items() if k != "path"}
    assert a.read_text() == b.read_text()


def test_replay_merges_the_crashed_incarnation(reference):
    """``run_with_replay`` with tracing on and a transient fault in the
    first engine: one span a request, the faulted requests' with two
    incarnations, the tokens the unfaulted run's."""
    params, want, _ = reference
    made = []

    def make_engine():
        eng = port_engine_for(params, SERVE, "gather")
        if not made:
            step, n = eng.step, [0]

            def faulty():
                n[0] += 1
                if n[0] == 6:
                    raise RuntimeError("UNAVAILABLE: simulated device loss")
                return step()

            eng.step = faulty
        made.append(eng)
        return eng

    res = recovery.run_with_replay(make_engine, burst(sched),
                                   time_fn=Clock())
    assert res["replays"] == 1 and len(made) == 2
    assert res["outputs"] == want["outputs"]
    spans = res["trace"]["spans"]
    assert set(spans) == set(want["outputs"])
    assert any(sp["incarnations"] == 2 for sp in spans.values())
    assert all(sp["status"] == "ok" for sp in spans.values())
