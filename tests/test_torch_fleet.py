"""The port's serving fleet against the JAX reference, on the CPU.

Host logic must match exactly, on one clock both sides read (``Clock``,
a virtual clock that advances a fixed step at every read, so the two
packages' loops, which read it at the same points, see the same times):

- ``train/elastic.is_transient`` gives the reference's verdict on every
  message of ``tests/test_fault_injection.py::TestTransientClassification``,
  and calls CUDA's sticky faults and an out-of-memory error permanent;
- the replay journal: the same run writes the same records (parsed),
  and a reference journal cut mid-run replays in the port to the
  reference's outputs;
- the replica router, sequential: the same placement (request ->
  replica), outputs, statuses, ``health`` and ``fleet_faults`` blocks
  with no fault, a transient fault and a permanent fault, and the same
  prefix-route hits;
- the autoscale advisor's decision log, from one signal stream and from
  an engine run;
- ``goodput_block`` and ``per_request_rows`` on one run's result.

Then the entry points: ``bench --mode serving`` prints its line with the
fleet's blocks, refuses what is not ported and the flags the reference
refuses, and a run
with ``--serve-journal`` killed by SIGKILL mid-run and relaunched on the
same journal serves the unfaulted run's tokens.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_serving_cases import (fast_compile, jax_engine_for, np_params,
                                  port_engine_for)
from mpi_tensorflow_tpu.serving import autoscale as jax_autoscale
from mpi_tensorflow_tpu.serving import loadgen as jax_loadgen
from mpi_tensorflow_tpu.serving import recovery as jax_recovery
from mpi_tensorflow_tpu.serving import router as jax_router
from mpi_tensorflow_tpu.serving import scheduler as jax_sched
from mpi_tensorflow_tpu.train import elastic as jax_elastic
from mpi_tensorflow_tpu.utils import metrics_writer as jax_metrics
from mpi_tensorflow_torch import bench
from mpi_tensorflow_torch.serving import autoscale, harness, loadgen
from mpi_tensorflow_torch.serving import recovery, router
from mpi_tensorflow_torch.serving import scheduler as sched
from mpi_tensorflow_torch.train import elastic
from mpi_tensorflow_torch.utils import metrics_writer

REPO = Path(__file__).resolve().parents[1]

# two replicas of 3 slots; a 6-request burst, sessions alternating, so a
# fault at a fixed tick lands mid-decode with live and queued work; a
# 6 ms backoff, so a transient fault's replica is probed back mid-run
SERVE = dict(num_blocks=40, block_size=4, max_slots=3, max_seq_len=24,
             prefill_chunk=8, failover_backoff_ms=6.0)
FAULTS = {"none": None, "transient": ("transient", 3),
          "permanent": ("permanent", 3)}
# the prefix-route fleet: prompts in 3 families sharing a first block
ROUTE_SERVE = dict(SERVE, prefix_cache="on", prefix_route="on")
# low watermarks, so a short run decides both ways
POLICY = dict(high_load=0.6, low_load=0.3, hold_ticks=2, cooldown_ticks=3)


class Clock:
    """A virtual clock: each read advances it by ``step`` seconds."""

    def __init__(self, step: float = 2e-3):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def burst(mod, sessions=True):
    rng = np.random.default_rng(42)
    return [mod.Request(i, [int(t) for t in rng.integers(0, 1024, 6)], 6,
                        session=(i % 2 if sessions else None))
            for i in range(6)]


def families(mod):
    """Three prompt families sharing a first block, arriving 30 ms apart
    on the virtual clock, so later members find their family cached."""
    rng = np.random.default_rng(7)
    heads = [[int(t) for t in rng.integers(0, 1024, 4)] for _ in range(3)]
    return [mod.Request(i, heads[i % 3]
                        + [int(t) for t in rng.integers(0, 1024, 3)], 3,
                        arrival=0.03 * i)
            for i in range(9)]


def _plan(mod, case):
    if FAULTS[case] is None:
        return None
    kind, step = FAULTS[case]
    return mod.FaultPlan([mod.ReplicaFault(0, step, kind=kind)])


def _fleet_view(r, res):
    return {"placements": res["placements"], "outputs": res["outputs"],
            "statuses": res["statuses"], "health": res["health"],
            "fleet_faults": res["fleet_faults"], "faults": res["faults"],
            "drain": res["drain"], "prefix": res["prefix"],
            "breaker": r.stats()["health"], "tokens": res["tokens"]}


def _journal_lines(path):
    """The parsed records of a journal file (a torn line skipped, as the
    journal's own load does)."""
    out = []
    for line in Path(path).read_text().splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX side of every comparison, computed once: the engines
    share their jitted steps (one compile a shape)."""
    tmp = tmp_path_factory.mktemp("ref")
    params = np_params(1)
    out = {"params": params, "tmp": tmp}
    with fast_compile():
        donor = jax_engine_for(params, SERVE)

        def eng(kw=SERVE):
            return jax_engine_for(params, kw, donor=donor)

        path = tmp / "ref.jsonl"
        j = jax_recovery.ReplayJournal(str(path))
        out["journal_run"] = donor.run(burst(jax_sched, False),
                                       time_fn=Clock(), journal=j)
        j.close()
        out["journal"] = _journal_lines(path)
        for case in FAULTS:
            r = jax_router.ReplicaRouter([eng(), eng()])
            res = r.run(burst(jax_sched), time_fn=Clock(), parallel=False,
                        fault_plan=_plan(jax_router, case))
            out[case] = _fleet_view(r, res)
        r = jax_router.ReplicaRouter([eng(ROUTE_SERVE), eng(ROUTE_SERVE)])
        out["route"] = _fleet_view(r, r.run(families(jax_sched),
                                            time_fn=Clock(),
                                            parallel=False))
        adv = jax_autoscale.ScaleAdvisor(jax_autoscale.ScalePolicy(**POLICY))
        eng().run(burst(jax_sched, False), time_fn=Clock(), advisor=adv)
        out["autoscale"] = adv.report()
    return out


# ------------------------------------------------------- fault verdicts

MESSAGES = [
    RuntimeError("UNAVAILABLE: peer rejected invalid_argument blob"),
    RuntimeError("RESOURCE_EXHAUSTED: connection pool preempted"),
    RuntimeError("ABORTED: some brand new wording nobody grepped for"),
    ConnectionResetError("whatever"), OSError("anything at all"),
    RuntimeError("device lost mid-step"), RuntimeError("shape mismatch (4,)"),
    RuntimeError("UNKNOWN: invalid_argument in peer handler"),
    RuntimeError("UNKNOWN: socket connection dropped"),
    RuntimeError("UNAVAILABLE: injected replica fault (FaultPlan: replica "
                 "0 at tick 3, transient)"),
    RuntimeError("FAILED_PRECONDITION: injected replica fault"),
    ValueError("bad shape"), RuntimeError("DEADLINE_EXCEEDED: rpc"),
]


@pytest.mark.parametrize("e", MESSAGES, ids=lambda e: str(e)[:24])
def test_is_transient_matches_reference(e):
    assert elastic.is_transient(e) == jax_elastic.is_transient(e)


@pytest.mark.parametrize("e", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure (connection "
                 "reset)"),
    RuntimeError("UNAVAILABLE: CUDA error: device-side assert triggered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
], ids=["illegal-access", "launch-failure", "device-assert", "oom"])
def test_sticky_cuda_faults_are_permanent(e):
    """A sticky fault poisons the process's CUDA context, so no rebuild
    in the process can recover: permanent, whatever else the message
    says."""
    assert not elastic.is_transient(e)


# ------------------------------------------------------------- journal

def test_journal_records_match_reference(reference, tmp_path):
    """The same burst through each engine: the same records in the same
    order (submit, tok ... then end), the same outputs."""
    path = tmp_path / "port.jsonl"
    j = recovery.ReplayJournal(str(path))
    eng = port_engine_for(reference["params"], SERVE, "cuda")
    res = eng.run(burst(sched, False), time_fn=Clock(), journal=j)
    j.close()
    assert _journal_lines(path) == reference["journal"]
    assert res["outputs"] == reference["journal_run"]["outputs"]
    loaded = recovery.ReplayJournal(str(path))
    assert loaded.outputs() == res["outputs"]
    assert set(loaded.statuses.values()) == {"ok"}


@pytest.mark.parametrize("keep", [9, 23])
def test_reference_journal_cut_mid_run_replays_in_port(reference, tmp_path,
                                                       keep):
    """The reference's journal cut after ``keep`` records (a torn line
    after them): ``run_with_replay`` in the port resumes it to the
    reference's outputs, replaying only what was live."""
    lines = [json.dumps(r) for r in reference["journal"][:keep]]
    path = tmp_path / "cut.jsonl"
    path.write_text("\n".join(lines) + '\n{"kind": "tok", "id"')
    made = []

    def make_engine():
        made.append(port_engine_for(reference["params"], SERVE, "gather"))
        return made[-1]

    res = recovery.run_with_replay(make_engine, burst(sched, False),
                                   journal_path=str(path), time_fn=Clock())
    assert res["outputs"] == reference["journal_run"]["outputs"]
    assert set(res["statuses"].values()) == {"ok"}
    assert res["replays"] == 0 and len(made) == 1
    replayed = [r for r in _journal_lines(path)[keep:]
                if r["kind"] == "submit" and r["pre"]]
    assert replayed, "no request was live at the cut"


def test_fleet_journal_helpers_match_reference(reference):
    """Two per-replica journals of one request, split by a failover:
    the merged view, statuses, outputs and replay list are the
    reference's."""
    def journals(mod):
        a, b = mod.ReplayJournal(), mod.ReplayJournal()
        req = (jax_sched if mod is jax_recovery else sched).Request
        r0, r1 = req(0, [1, 2, 3], 4), req(1, [4, 5], 3)
        a.record_submit(r0)
        a.record_token(0, 7)
        b.record_submit(req(0, [1, 2, 3, 7], 3, replayed=True), pre=[7])
        b.record_token(0, 8)
        a.record_submit(r1)
        a.record_token(1, 9)
        a.record_token(1, 9)
        a.record_token(1, 9)
        a.record_end(r1, "ok")
        return [a, b], [r0, r1, req(2, [6], 2)]

    got, reqs = journals(recovery)
    want, jreqs = journals(jax_recovery)
    assert recovery.fleet_statuses(got) == jax_recovery.fleet_statuses(want)
    assert recovery.fleet_outputs(got) == jax_recovery.fleet_outputs(want)
    todo, pre = recovery.fleet_replay_requests(got, reqs)
    jtodo, jpre = jax_recovery.fleet_replay_requests(want, jreqs)
    assert pre == jpre == {0: [7, 8]}
    assert [(r.id, r.prompt, r.max_new_tokens, r.replayed) for r in todo] \
        == [(r.id, r.prompt, r.max_new_tokens, r.replayed) for r in jtodo]


# -------------------------------------------------------------- router

@pytest.mark.parametrize("case", list(FAULTS))
def test_router_matches_reference(reference, case):
    """Sequential mode on the virtual clock: placement, tokens,
    statuses, the breaker's state and the fault blocks are the
    reference's; a transient fault migrates and the replica is probed
    back, a permanent one leaves it dead with every request served."""
    params = reference["params"]
    r = router.ReplicaRouter([port_engine_for(params, SERVE, "cuda"),
                              port_engine_for(params, SERVE, "gather")])
    res = r.run(burst(sched), time_fn=Clock(), parallel=False,
                fault_plan=_plan(router, case))
    got = _fleet_view(r, res)
    assert got == reference[case]
    assert set(res["statuses"].values()) == {"ok"}
    if case != "none":
        assert res["fleet_faults"]["failovers"] == 1
        assert res["fleet_faults"]["migrated_requests"] >= 1
    assert res["fleet_faults"]["readmissions"] == (case == "transient")
    assert res["health"][0] == {"none": "healthy", "transient": "healthy",
                                "permanent": "dead"}[case]


def test_prefix_route_hits_match_reference(reference):
    params = reference["params"]
    r = router.ReplicaRouter([port_engine_for(params, ROUTE_SERVE, "gather")
                              for _ in range(2)])
    got = _fleet_view(r, r.run(families(sched), time_fn=Clock(),
                               parallel=False))
    assert got == reference["route"]
    assert got["prefix"]["router_prefix_hits"] > 0


def test_threaded_router_serves_the_sequential_tokens(reference):
    """``parallel=True`` (a thread a replica) with a transient fault:
    the sequential run's tokens, every request ``ok``."""
    params = reference["params"]
    r = router.ReplicaRouter([port_engine_for(params, SERVE, "gather")
                              for _ in range(2)])
    res = r.run(burst(sched), parallel=True,
                fault_plan=_plan(router, "transient"))
    assert res["parallel"] is True
    assert res["outputs"] == reference["none"]["outputs"]
    assert set(res["statuses"].values()) == {"ok"}


# ----------------------------------------------------- autoscale, goodput

def test_autoscale_log_matches_reference(reference):
    rng = np.random.default_rng(9)
    port = autoscale.ScaleAdvisor(autoscale.ScalePolicy(**POLICY))
    ref = jax_autoscale.ScaleAdvisor(jax_autoscale.ScalePolicy(**POLICY))
    for t in range(200):
        sig = dict(queue_depth=float(rng.integers(0, 4)),
                   occupancy=float(rng.random()),
                   shed_rate=float(rng.random() < 0.1),
                   live_fraction=float(rng.random()),
                   prefill_backlog=float(rng.integers(0, 3)))
        assert port.observe(t * 0.01, **sig) == ref.observe(t * 0.01, **sig)
    assert port.report() == ref.report()
    assert {d["action"] for d in port.decisions} == {"up", "down"}
    eng = port_engine_for(reference["params"], SERVE, "gather")
    adv = autoscale.ScaleAdvisor(autoscale.ScalePolicy(**POLICY))
    res = eng.run(burst(sched, False), time_fn=Clock(), advisor=adv)
    assert res["autoscale"] == reference["autoscale"]
    assert res["autoscale"]["decisions"]


def test_goodput_and_rows_match_reference(reference):
    """One multi-tenant run with SLOs (a tight one misses): the rows and
    the goodput block each package computes from it are equal."""
    spec = dict(workload="multi-tenant", num_requests=8, rate_rps=200.0,
                prompt_max=10, output_max=6, vocab_size=1024, slo_ms=30.0,
                seed=3)
    trace = loadgen.build_trace(loadgen.WorkloadSpec(**spec))
    jtrace = jax_loadgen.build_trace(jax_loadgen.WorkloadSpec(**spec))
    eng = port_engine_for(reference["params"], dict(SERVE, trace="on"),
                          "gather")
    res = eng.run(trace.requests(), time_fn=Clock(6e-3))
    rows = loadgen.per_request_rows(trace, res)
    assert rows == jax_loadgen.per_request_rows(jtrace, res)
    assert all("queue_ms" in r for r in rows)
    block = metrics_writer.goodput_block(rows, elapsed_s=res["elapsed_s"])
    assert block == jax_metrics.goodput_block(rows,
                                              elapsed_s=res["elapsed_s"])
    assert block["enabled"] and set(block["per_tenant"]) == \
        {"interactive", "batch"}
    assert 0 < block["slo_attainment"] < 1
    counters = {k: i for i, k in enumerate(jax_metrics.FLEET_FAULT_KEYS)}
    assert metrics_writer.fleet_faults_block(counters) \
        == jax_metrics.fleet_faults_block(counters)


# --------------------------------------------------------- entry points

ENTRY = ["--serve-tiny", "--device", "cpu", "--requests", "4",
         "--prompt-len", "8", "--new-tokens", "8", "--arrival-rate", "1000"]


def _bench(capsys, *extra):
    assert bench.main(["--mode", "serving", *ENTRY, *extra]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_bench_serving_fleet_with_a_fault(capsys):
    line = _bench(capsys, "--serve-replicas", "2", "--serve-fault-replica",
                  "0", "--serve-fault-step", "3")
    det = line["detail"]
    reps = det["replicas"]
    assert line["unit"] == "tokens/sec" and line["value"] > 0
    assert line["replica_speedup"] == reps["speedup_vs_single_replica"]
    assert reps["fleet_faults"]["failovers"] == 1
    # transient: never dead; back to healthy once the 50 ms backoff and
    # the probe fit in the run (wall clock)
    assert reps["health"][1] == "healthy" and reps["health"][0] != "dead"
    assert reps["token_identical_vs_single"]
    assert reps["status_counts"] == {"ok": 4}
    assert reps["serve_fault"] == {"replica": 0, "step": 3,
                                   "kind": "transient"}
    for key in ("goodput", "autoscale", "faults", "status_counts", "drain"):
        assert det[key] is not None, key
    assert det["autoscale"]["ticks"] > 0 and reps["autoscale"]["ticks"] > 0


def test_bench_serving_traced_and_journaled(capsys, tmp_path):
    out = tmp_path / "trace.json"
    det = _bench(capsys, "--serve-trace", "on", "--serve-trace-out",
                 str(out))["detail"]
    assert det["breakdown"]["enabled"] and det["breakdown"]["requests"] == 4
    assert det["trace"]["chrome_trace"]["requests"] == 4
    assert json.loads(out.read_text())["traceEvents"]
    path = tmp_path / "j.jsonl"
    det = _bench(capsys, "--serve-journal", str(path))["detail"]
    assert det["status_counts"] == {"ok": 4} and det["replays"] == 0
    assert det["goodput"] is None and det["journal"] == str(path)
    again = _bench(capsys, "--serve-journal", str(path))["detail"]
    assert again["outputs"] == det["outputs"] and again["tokens"] == 0


@pytest.mark.parametrize("argv,error", [
    # the ViT is ported (ROADMAP item 14, first part): what the bench
    # refuses it now is what the reference's refuses
    (["--mode", "train", "--model", "vit", "--fused-qkv"], SystemExit),
    # item 6b is ported: what these flags are refused now is what the
    # reference refuses (a negative beam count; an A/B arm beside a
    # journal; the mixed A/B without mixed batching; an A/B arm beside
    # a fleet)
    (["--mode", "decode", "--num-beams", "-1"], SystemExit),
    (["--mode", "serving", "--serve-kv-ab", "--serve-journal", "j"],
     SystemExit),
    (["--mode", "serving", "--serve-mixed-ab"], SystemExit),
    (["--mode", "serving", "--serve-tp", "2", "--serve-replicas", "2",
      "--serve-kernel-ab"], SystemExit),
])
def test_bench_refuses_what_is_not_ported(argv, error):
    with pytest.raises(error):
        bench.main(argv)


@pytest.mark.parametrize("argv", [
    ["--serve-fault-replica", "0"],
    ["--serve-fault-replica", "0", "--serve-fault-step", "3"],
    ["--serve-trace-out", "t.json"],
    ["--serve-prefix-route", "on"],
    ["--serve-slo-ms", "0"],
])
def test_bench_checks_the_fleet_flags(argv):
    with pytest.raises(SystemExit):
        bench.main(["--mode", "serving", *ENTRY, *argv])


@pytest.mark.parametrize("world,argv", [
    ("2", []), ("2", ["--serve-tp", "1"]), ("1", ["--serve-tp", "2"])])
def test_bench_serving_holds_tp_to_the_launch(monkeypatch, world, argv):
    """Under a launcher, ``--serve-tp`` must name the launch's size: a
    launch of 2 without it would serve two unrelated engines."""
    monkeypatch.setenv("WORLD_SIZE", world)
    with pytest.raises(SystemExit):
        bench.main(["--mode", "serving", *ENTRY, *argv])


def test_bench_serving_joins_no_world_unless_tp_asks(monkeypatch, capsys):
    """A launch of one process without ``--serve-tp`` serves alone: no
    process group is joined, so the engine takes no collective path."""
    from mpi_tensorflow_torch.parallel import mesh

    joined = []
    monkeypatch.setattr(mesh, "initialize_distributed",
                        lambda *a, **kw: joined.append(a) or False)
    for k, v in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    line = _bench(capsys, "--requests", "2")
    assert joined == [] and line["detail"]["rank"] == 0
    assert line["detail"]["status_counts"] == {"ok": 2}


def _mid_request(path, toks: int = 8, room: int = 4) -> bool:
    """Whether the journal at ``path`` holds ``toks`` token records and a
    request that has emitted tokens, has not ended, and has ``room``
    tokens of its budget left: a kill sent now lands mid-request."""
    if not path.exists():
        return False
    recs = _journal_lines(path)
    budget = {r["id"]: r["n"] for r in recs if r["kind"] == "submit"}
    got = {}
    for r in recs:
        if r["kind"] == "tok":
            got[r["id"]] = got.get(r["id"], 0) + 1
        elif r["kind"] == "end":
            budget.pop(r["id"], None)
    return sum(got.values()) >= toks and any(
        0 < got.get(i, 0) <= n - room for i, n in budget.items())


def test_sigkilled_journaled_run_resumes_token_identical(tmp_path):
    """``bench --mode serving --serve-journal`` killed by SIGKILL once its
    journal holds >= 8 token records and a request is mid-decode (an
    idle gap between arrivals would leave nothing to resume), then
    relaunched on the journal: the outputs of an unfaulted run (served
    here, in this process)."""
    argv = ["--serve-tiny", "--device", "cpu", "--requests", "4",
            "--prompt-len", "8", "--new-tokens", "32", "--arrival-rate",
            "6"]
    path = tmp_path / "j.jsonl"
    cmd = [sys.executable, "-m", "mpi_tensorflow_torch.bench", "--mode",
           "serving", *argv, "--serve-journal", str(path)]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd, cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and proc.poll() is None:
            if _mid_request(path):
                break
            time.sleep(0.01)
        assert proc.poll() is None, "the run ended before the kill"
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
    killed = _journal_lines(path)
    assert len({r["id"] for r in killed if r["kind"] == "end"}) < 4
    engine, trace = harness.build_serving(
        num_requests=4, rate_rps=6.0, prompt_max=8, output_max=32,
        tiny=True, device="cpu")
    want = engine.run(trace.requests())["outputs"]
    done = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    det = json.loads(done.stdout.strip().splitlines()[-1])["detail"]
    assert {int(k): v for k, v in det["outputs"].items()} == want
    assert det["status_counts"] == {"ok": 4}
    resumed = [r for r in _journal_lines(path)[len(killed):]
               if r["kind"] == "submit"]
    assert any(r["pre"] for r in resumed), "nothing was live at the kill"
