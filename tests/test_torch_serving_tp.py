"""Tensor-parallel serving (``serving/tp``) against the JAX reference.

One 2-rank gloo world (``tests/_torch_tp_worker.py``, plain ``python``
processes at one thread each, results in JSON files) serves every case
with ``tp = 2`` while this process runs the references: the port's
``tp = 1`` engine and the reference's ``tp = 2`` engine on two of the
conftest's virtual CPU devices, on the same converted parameters.

- learned and rope positions, and the prefix cache with a
  copy-on-write: both ranks serve the tokens of the port's ``tp = 1``
  engine and of the reference's ``tp = 2`` engine (fp32; the two
  row-parallel sums add the partial products in another order than the
  one-device einsum, which these greedy tokens do not feel);
- each rank's pools and ``wq`` hold ``H / 2`` heads, and only rank 0
  builds a tracer;
- a run whose rank 1 reads a skewed clock (1.7x fast, 5 s ahead) ends
  without hanging and serves the same tokens: rank 0's clock decides
  admission for both.

``check_geometry`` refuses a ``tp`` that does not divide the heads, and
``tp > 1`` outside a world of that size.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_tp_worker as worker
from _torch_serving_cases import (fast_compile, jax_engine_for, np_params,
                                  port_engine_for)
from _torch_tdp_worker import flatten
from mpi_tensorflow_tpu.serving import scheduler as jax_sched
from mpi_tensorflow_torch.models import bert
from mpi_tensorflow_torch.parallel import mesh
from mpi_tensorflow_torch.serving import engine, tp
from mpi_tensorflow_torch.serving import scheduler as sched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp")
    params = np_params(3)
    np.savez(workdir / "inputs.npz", **flatten(params, "params"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for k in mesh.LAUNCH_ENV:
        env.pop(k, None)
    port = mesh.free_port()
    # output to files, not pipes: a rank blocked on a full pipe could no
    # longer reach the collective its peer waits in
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(r), str(WORLD), str(port),
         str(workdir)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        one, ref = {}, {}
        with fast_compile():
            donor = {}
            for case, spec in worker.CASES.items():
                serve, kind = spec["serve"], spec["kind"]
                one[case] = worker.serve(
                    port_engine_for(params, serve, "gather", kind=kind),
                    worker.turns(sched, case))
                if case == "skew":
                    continue
                eng = jax_engine_for(params, dict(serve, tp=2), kind=kind,
                                     donor=donor.get(kind))
                donor.setdefault(kind, eng)
                ref[case] = worker.serve(eng, worker.turns(jax_sched, case))
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, log) in enumerate(zip(rcs, logs)):
        log.seek(0)
        assert rc == 0, f"rank {r} exited {rc}:\n{log.read()[-4000:]}"
        log.close()
    ranks = [json.loads((workdir / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return one, ref, ranks


def _keyed(d):
    return {int(k): v for k, v in d.items()}


@pytest.mark.parametrize("case", ["learned", "rope", "prefix"])
def test_tp2_tokens_match_tp1_and_reference(world, case):
    one, ref, ranks = world
    for r in ranks:
        assert _keyed(r[case]["outputs"]) == one[case]["outputs"]
        assert set(r[case]["statuses"].values()) == {"ok"}
    assert ref[case]["outputs"] == one[case]["outputs"]
    assert len({t for v in one[case]["outputs"].values() for t in v}) > 3


def test_each_rank_holds_its_heads_and_rank0_traces(world):
    _, _, ranks = world
    heads = bert.BERT_TINY.heads
    for r, res in enumerate(ranks):
        for case in res.values():
            assert case["pool_heads"] == case["wq_heads"] == heads // WORLD
        assert res["learned"]["traced"] == (r == 0)


def test_prefix_cache_copies_on_write_under_tp(world):
    one, _, ranks = world
    for r in ranks:
        assert r["prefix"]["cow_copies"] >= 1
        assert r["prefix"]["hit_tokens"] == one["prefix"]["prefix"][
            "hit_tokens"] > 0


def test_skewed_clock_on_rank1_serves_the_same_tokens(world):
    one, _, ranks = world
    for r in ranks:
        assert _keyed(r["skew"]["outputs"]) == one["skew"]["outputs"]
        assert set(r["skew"]["statuses"].values()) == {"ok"}


def test_check_geometry_refuses_what_cannot_split():
    with pytest.raises(ValueError, match="must divide both heads"):
        tp.check_geometry(bert.BERT_TINY, 3)     # 4 heads
    with pytest.raises(ValueError, match="torch.distributed world of 2"):
        engine.PagedDecodeEngine(
            port_engine_for(np_params(3), worker.SERVE, "gather").model,
            engine.ServeConfig(**worker.SERVE, tp=2), device="cpu")
    tp.check_geometry(bert.BERT_TINY, 1)
