"""One rank of the 2-rank gloo world of ``tests/test_torch_serving_tp.py``.

    python tests/_torch_tp_worker.py RANK WORLD PORT WORKDIR

Imports torch, numpy and ``mpi_tensorflow_torch`` only (no JAX, no
conftest): the parent writes the reference's parameters to
``WORKDIR/inputs.npz``; this rank joins the world at
``tcp://127.0.0.1:PORT`` over gloo, on one thread, serves every case of
``CASES`` with ``tp = WORLD`` (its shard of the model), and writes what
it served to ``WORKDIR/rank<RANK>.json``: each case's outputs and
statuses, its pools' head count, and whether it built a tracer.

The ``skew`` case hands rank 1 a clock that runs 1.7x fast and 5 s
ahead; rank 0's clock decides for both ranks (``serving/tp.agree``), so
the ranks admit the same requests at the same iterations and serve the
same tokens instead of parting at a collective.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_tdp_worker import unflatten  # noqa: E402

SERVE = dict(num_blocks=24, block_size=4, max_slots=3, max_seq_len=24,
             prefill_chunk=8)
# the prefix cache: requests 1 and 2 share request 0's two full blocks;
# request 2 is those 8 tokens alone (fully cached, an exact block
# multiple: the copy-on-write trigger)
PREFIX_SERVE = dict(SERVE, prefix_cache="on")
CASES = {
    "learned": dict(serve=dict(SERVE, trace="on"), kind="learned"),
    "rope": dict(serve=SERVE, kind="rope"),
    "prefix": dict(serve=PREFIX_SERVE, kind="learned"),
    "skew": dict(serve=SERVE, kind="learned"),
}


def turns(mod, case: str) -> list:
    """The case's requests (``mod``: either package's scheduler), as the
    runs of one engine: the prefix case serves request 0 first, so its
    blocks are in the trie when the others admit."""
    rng = np.random.default_rng(5)
    if case == "prefix":
        shared = [int(t) for t in rng.integers(0, 1024, 8)]
        specs = [(shared + [int(t) for t in rng.integers(0, 1024, 4)], 5),
                 (shared + [int(t) for t in rng.integers(0, 1024, 4)], 5),
                 (shared, 5), ([int(t) for t in rng.integers(0, 1024, 8)], 4)]
        reqs = [mod.Request(i, p, n) for i, (p, n) in enumerate(specs)]
        return [reqs[:1], reqs[1:]]
    # one prompt length: one prefill bucket for the reference to compile
    return [[mod.Request(i, [int(t) for t in rng.integers(0, 1024, 8)],
                         int(rng.integers(4, 7)),
                         arrival=0.01 * i if case == "skew" else 0.0)
             for i in range(5)]]


def serve(eng, runs, **kw) -> dict:
    """Each run of ``runs`` through ``eng``: the last result, with the
    outputs and statuses of all of them."""
    outputs, statuses = {}, {}
    for reqs in runs:
        res = eng.run(reqs, **kw)
        outputs.update(res["outputs"])
        statuses.update(res["statuses"])
    return {**res, "outputs": outputs, "statuses": statuses}


def main() -> None:
    rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from mpi_tensorflow_torch.models import bert, convert, gpt
    from mpi_tensorflow_torch.parallel import mesh
    from mpi_tensorflow_torch.serving import engine, scheduler

    npz = np.load(os.path.join(workdir, "inputs.npz"))
    tree = unflatten({k: npz[k] for k in npz.files}, "params")
    mesh.initialize_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
    out = {}
    try:
        for case, spec in CASES.items():
            cfg = dataclasses.replace(bert.BERT_TINY, pos_kind=spec["kind"])
            model = gpt.CausalLm(cfg, convert.params_from_jax(tree))
            eng = engine.PagedDecodeEngine(
                model, engine.ServeConfig(kernel="cuda", tp=world,
                                          **spec["serve"]), device="cpu")
            clock = time.perf_counter
            if case == "skew" and rank == 1:
                clock = lambda: time.perf_counter() * 1.7 + 5.0  # noqa: E731
            res = serve(eng, turns(scheduler, case), time_fn=clock)
            out[case] = {
                "outputs": {str(k): v for k, v in res["outputs"].items()},
                "statuses": {str(k): v for k, v in res["statuses"].items()},
                "pool_heads": int(eng.pools[0]["k"].shape[1]),
                "wq_heads": int(eng.model.layers[0].wq.shape[1]),
                "traced": "trace" in res,
                "cow_copies": res["prefix"]["cow_copies"],
                "hit_tokens": res["prefix"]["hit_tokens"],
            }
    finally:
        mesh.shutdown()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
