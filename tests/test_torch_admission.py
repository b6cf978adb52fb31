"""The serving admission flags in the port against the JAX reference, on
the CPU: ``--serve-deadline-ms``, ``--serve-queue-depth``,
``--serve-max-evictions``, ``--serve-drain-ms`` and
``--serve-failover-backoff-ms``.

- Host logic, exactly: one small trace of BERT_TINY requests (seeded
  prompts of 2-7 tokens, budgets of 2-5, arrivals over 30 ms) through
  each engine (the port's on its gather path and on the paged kernel's
  plain version, the reference's on its ``xla`` lowering), both on a
  virtual clock that advances at every reading: with a queue of depth
  3, a 60 ms deadline, one eviction allowed and a pool of 7 blocks of 2
  (sequences evict one another), every request's status (``ok``,
  ``shed``, ``deadline_exceeded``, ``evicted_too_often``) and the
  ``faults`` block equal the reference's;
  with a stop at 50 ms of the clock and a 5 ms drain budget, the
  statuses (``ok``, ``shed``, ``drained``) and the ``drain`` block; and
  each ``ok`` request's greedy tokens equal the reference's.
- The flags: each bound of the reference CLI's checks (deadline > 0,
  queue depth >= 1, max evictions >= 1, drain >= 0, backoff > 0) refused
  by the port's serving entry point (``ap.error``) and by the reference's
  CLI for the same value; a value inside each bound reaches the engine's
  ``ServeConfig`` and the detail of ``python -m mpi_tensorflow_torch
  .serving``, whose statuses count the shed and expired requests.

The reference compiles with XLA's optimisation passes off.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

from _torch_serving_cases import (fast_compile, jax_engine_for, np_params,
                                  port_model)
from mpi_tensorflow_tpu import cli as jax_cli
from mpi_tensorflow_tpu.serving import scheduler as jax_sched
from mpi_tensorflow_torch.serving import __main__ as serving_main
from mpi_tensorflow_torch.serving import engine, scheduler

# a pool of 7 blocks of 2 for 3 slots: sequences of up to 12 tokens
# evict one another
POOL = dict(num_blocks=7, block_size=2, max_slots=3, max_seq_len=12,
            prefill_chunk=2)
CASES = {"admission": dict(queue_depth=3, max_evictions=1, deadline_ms=60.0),
         "drain": dict(drain_ms=5.0)}
STOP_AT = 0.05                    # the drain case's stop, clock seconds
WANT = {"admission": {"ok", "shed", "deadline_exceeded",
                      "evicted_too_often"},
        "drain": {"ok", "shed", "drained"}}


class Clock:
    """A virtual clock: each reading advances it 2 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 2e-3
        return self.t


class Stop:
    """A guard whose stop flag rises once ``clock`` reads ``at``."""

    def __init__(self, clock, at):
        self.clock, self.at = clock, at

    @property
    def should_stop(self) -> bool:
        return self.clock.t >= self.at


def _requests(mod):
    """Eight seeded requests, arrivals at 0, 10, 20 or 30 ms."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(8):
        n, m = int(rng.integers(2, 8)), int(rng.integers(2, 6))
        out.append(mod.Request(i, [int(t) for t in rng.integers(0, 1024, n)],
                               m, arrival=float(rng.integers(0, 4)) * 0.01))
    return out


def _run(eng, mod, case):
    clock = Clock()
    guard = Stop(clock, STOP_AT) if case == "drain" else None
    return eng.run(_requests(mod), time_fn=clock, guard=guard)


@pytest.fixture(scope="module")
def reference():
    """The reference engine's runs; the second shares the first's
    compiled steps (one pool geometry)."""
    params = np_params(1)
    out, donor = {}, None
    with fast_compile():
        for case, kw in CASES.items():
            donor = jax_engine_for(params, {**POOL, **kw}, donor=donor)
            out[case] = _run(donor, jax_sched, case)
    return params, out


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
@pytest.mark.parametrize("case", list(CASES))
def test_statuses_and_tokens_match_reference(reference, case, kernel):
    params, runs = reference
    want = runs[case]
    eng = engine.PagedDecodeEngine(
        port_model(params),
        engine.ServeConfig(kernel=kernel, **POOL, **CASES[case]),
        device="cpu")
    got = _run(eng, scheduler, case)
    assert set(got["statuses"].values()) == WANT[case]
    assert got["statuses"] == want["statuses"]
    assert got["faults"] == want["faults"] and got["drain"] == want["drain"]
    ok = [i for i, s in got["statuses"].items() if s == "ok"]
    assert ok and {i: got["outputs"][i] for i in ok} == \
        {i: want["outputs"][i] for i in ok}
    eng.allocator.check()
    assert eng.allocator.num_used == 0


# each flag beside a value outside the reference's bound
REFUSED = [["--serve-deadline-ms", "0"], ["--serve-deadline-ms", "-5"],
           ["--serve-queue-depth", "0"], ["--serve-max-evictions", "0"],
           ["--serve-drain-ms", "-1"], ["--serve-failover-backoff-ms", "0"]]


@pytest.mark.parametrize("argv", REFUSED, ids=lambda a: "=".join(a))
def test_bounds_refused_as_the_reference(argv, capsys):
    with pytest.raises(SystemExit):
        serving_main.parse_args(argv + ["--device", "cpu"])
    assert "bad --serve-* fault policy" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="fault policy"):
        jax_cli.main(argv)


def test_flags_reach_the_engine_and_the_line():
    argv = ["--serve-tiny", "--device", "cpu", "--requests", "6",
            "--prompt-len", "8", "--new-tokens", "8", "--arrival-rate",
            "1000", "--serve-queue-depth", "1", "--serve-deadline-ms",
            "30", "--serve-max-evictions", "2", "--serve-drain-ms", "0",
            "--serve-failover-backoff-ms", "7.5"]
    with redirect_stdout(io.StringIO()) as out:
        assert serving_main.main(argv) == 0
    det = json.loads(out.getvalue())
    assert (det["queue_depth"], det["deadline_ms"], det["max_evictions"],
            det["drain_ms"], det["failover_backoff_ms"]) == (1, 30.0, 2,
                                                              0.0, 7.5)
    counts = det["status_counts"]
    assert counts.get("shed", 0) > 0 and sum(counts.values()) == 6
    assert det["faults"]["shed"] == counts["shed"]
