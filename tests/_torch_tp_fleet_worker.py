"""One rank of the 2-rank gloo world of ``tests/test_torch_serving_arms.py``.

    python tests/_torch_tp_fleet_worker.py RANK WORLD PORT WORKDIR

Imports torch, numpy and ``mpi_tensorflow_torch`` only (no JAX, no
conftest).  This rank joins the world at ``tcp://127.0.0.1:PORT`` over
gloo, on one thread, runs the serving harness's arms for every case of
``CASES`` with ``--serve-tp WORLD`` (the fleet's replicas each hold this
rank's shard; ``serving/tp``), and writes to ``WORKDIR/rank<RANK>.json``
each case's served tokens: every fleet run's outputs, and a journaled
run's merged outputs.  The ``resume`` case relaunches ``journal`` on its
journals: rank 0 loads them and every rank resumes from its records.
``replay`` journals one engine through ``recovery.run_with_replay``'s
``journal_path``.  Rank 0 also counts the records of each case's journal
files by kind (every rank records, only rank 0 writes).
"""

from __future__ import annotations

import json
import os
import sys

import torch

BASE = ["--serve-tiny", "--device", "cpu", "--requests", "2",
        "--prompt-len", "8", "--new-tokens", "5", "--arrival-rate", "1e9"]
CASES = {
    "fault": ["--serve-replicas", "2", "--serve-fault-replica", "0",
              "--serve-fault-step", "3"],
    "journal": ["--serve-replicas", "2", "--serve-journal", "fleet.jsonl"],
    "resume": ["--serve-replicas", "2", "--serve-journal", "fleet.jsonl"],
    "route": ["--serve-prefix-cache", "on", "--serve-prefix-tokens", "8",
              "--serve-prefix-route", "on"],
    "replay": ["--serve-journal", "single.jsonl"],
}


def parse(argv):
    import argparse

    from mpi_tensorflow_torch.serving import harness

    ap = argparse.ArgumentParser()
    harness.add_serving_args(ap)
    args = ap.parse_args(argv)
    harness.check_serving_args(ap, args)
    return args


def case_args(case: str, workdir: str, tp=None) -> list:
    """The case's flags, journals under ``workdir``."""
    argv = list(BASE) + [os.path.join(workdir, a) if a.endswith(".jsonl")
                         else a for a in CASES[case]]
    return argv + (["--serve-tp", str(tp)] if tp else [])


def keyed(outputs: dict) -> dict:
    return {str(k): list(v) for k, v in outputs.items()}


def journal_records(args) -> dict:
    """Records by kind over the run's journal files (``P``, or ``P.r<i>``
    for a fleet), None without a journal."""
    if args.serve_journal is None:
        return None
    n = args.serve_replicas or 1
    paths = ([args.serve_journal] if n == 1
             else [f"{args.serve_journal}.r{i}" for i in range(n)])
    kinds = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                kind = json.loads(line)["kind"]
                kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


def main() -> None:
    rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from mpi_tensorflow_torch.parallel import mesh as meshlib
    from mpi_tensorflow_torch.serving import harness, router

    meshlib.initialize_distributed(
        "cpu", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world)
    runs = []
    run = router.ReplicaRouter.run

    def recorded(self, *a, **kw):
        res = run(self, *a, **kw)
        runs.append(keyed(res["outputs"]))
        return res

    router.ReplicaRouter.run = recorded
    out = {}
    try:
        for case in CASES:
            runs.clear()
            args = parse(case_args(case, workdir, world))
            det = harness._measure(args, torch.device("cpu"), world,
                                   args.serve_replicas or 1)
            out[case] = {
                "fleet_runs": list(runs),
                "outputs": keyed(det["outputs"]) if "outputs" in det
                else None,
                "statuses": det.get("status_counts"),
                "tokens": det["tokens"],
                "dispatches": det["forward_dispatches"],
                "route": det.get("prefix_route"),
                "fleet_faults": (det.get("replicas") or {}).get(
                    "fleet_faults"),
                "journal_records": (journal_records(args) if rank == 0
                                    else None),
            }
    finally:
        meshlib.shutdown()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
